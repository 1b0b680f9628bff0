"""CMB instrument noise and quadratic-estimator lensing noise on float64
tensors (port of hmvec_tpu/models/lensing_noise.py).

* ``white_noise_nl``, ``total_cl_tt``: the Knox instrument noise N_l =
  (DT)^2 exp(l(l+1) theta_fwhm^2 / (8 ln 2)) (muK^2, beam deconvolved)
  and theory + noise on integer l.
* ``n0_flat_sky``: the flat-sky Hu-Okamoto (2002) N0^{phiphi}(L) of the
  TT, EE and EB estimators,

      N0(L) = [ int d^2 l1 / (2 pi)^2
                f_a(l1, l2)^2 / (D_a C^tot_{l1} C^tot_{l2}) ]^{-1},

  l2 = L - l1, one Gauss-Legendre double quadrature (ln l x angle) with
  the reconstruction multipoles L as a leading dimension (the JAX package
  maps over them with ``jax.vmap``).
* the whole Hu-Okamoto family: ``n0_pair_flat_sky`` (TT, TE with its
  non-diagonal optimal weight, EE, EB, TB; grad or curl),
  ``n0_cross_flat_sky`` (HO02 eq. 17), ``n0_mv_flat_sky`` (the exact
  minimum-variance combination), ``n0_te_simple_flat_sky``.
* ``n0_tt_fullsky``: the exact full-sky TT N0 from the spherical-harmonic
  response, with ``threej000_sq`` (3j^2 through log-gamma), in chunks of
  l1 so that no temporary passes 128 MiB; ``n1_tt_flat_sky``, the N1 bias,
  one L at a time; ``n0_eb_iterative``, the iterative EB delensing fixed
  point (a host loop, as in the JAX package), with ``lensed_bb_from_ee``.

Theory spectra enter as dense integer-l arrays sampled at off-grid l by
``jnp.interp``'s arithmetic (``quadrature.linear_interp``).  kappa =
l(l+1) phi / 2, so n0_kappa = (L (L+1) / 2)^2 n0_phi.  The work runs on
the device of the first tensor argument; with only host data, on
``device`` (the card unless told otherwise).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.quadrature import linear_interp
from ..utils.weights import (call_device, leggauss_cached,
                             on_device_of_inputs)

__all__ = ["white_noise_nl", "total_cl_tt", "n0_flat_sky",
           "n0_pair_flat_sky", "n0_cross_flat_sky", "n0_mv_flat_sky",
           "n0_te_simple_flat_sky",
           "n0_minimum_variance", "n0_kappa_from_phi",
           "lensed_bb_from_ee", "n0_eb_iterative",
           "threej000_sq", "n0_tt_fullsky", "n1_tt_flat_sky"]

_F64 = torch.float64
_ARCMIN = np.pi / (180.0 * 60.0)
# elements of one (l1, l2) temporary of the full-sky N0: 2^24 = 128 MiB
_CHUNK_ELEMENTS = 2**24


def _f64(x, dev):
    return torch.as_tensor(x, dtype=_F64, device=dev)


@on_device_of_inputs
def white_noise_nl(ells, noise_uk_arcmin, beam_fwhm_arcmin=0.0):
    """Beam-deconvolved white noise in muK^2 for a map depth DT in
    muK-arcmin (sqrt(2) x the temperature depth for Q/U)."""
    dev = call_device()
    ells = _f64(ells, dev)
    dt = _f64(noise_uk_arcmin, dev) * _ARCMIN
    theta = _f64(beam_fwhm_arcmin, dev) * _ARCMIN
    bl2 = torch.exp(ells * (ells + 1.0) * theta**2 / (8.0 * np.log(2.0)))
    return dt**2 * bl2


@on_device_of_inputs
def total_cl_tt(cl_tt, noise_uk_arcmin, beam_fwhm_arcmin=0.0):
    """C_l + N_l on l = 0..lmax from a raw-C_l theory row (muK^2), with
    rows 0 and 1 zeroed: the kSZ layer's integer-l ``Cls``."""
    dev = call_device()
    cl_tt = _f64(cl_tt, dev)
    ells = torch.arange(cl_tt.shape[0], dtype=_F64, device=dev)
    tot = cl_tt + white_noise_nl(ells, noise_uk_arcmin, beam_fwhm_arcmin)
    tot[:2] = 0.0
    return tot


def _interp_cl(cl, l):
    """An integer-l spectrum at (possibly fractional) l."""
    grid = torch.arange(cl.shape[0], dtype=_F64, device=cl.device)
    return linear_interp(l, grid, cl)


def _nodes_flat_sky(lmin, lmax, n_l, n_theta, dev):
    """The Gauss-Legendre ln(l1) x angle nodes (theta in [0, pi]; the
    integrands are even in theta, the callers apply the factor 2):
    l1 (n_l, 1), cos and sin theta (1, n_theta), the weights of d^2 l1."""
    xu, wu = leggauss_cached(int(n_l))
    xt, wt = leggauss_cached(int(n_theta))
    lnl = 0.5 * (np.log(lmax) + np.log(lmin)) \
        + 0.5 * (np.log(lmax) - np.log(lmin)) * xu
    wl = 0.5 * (np.log(lmax) - np.log(lmin)) * wu
    th = 0.5 * np.pi * (xt + 1.0)
    wth = 0.5 * np.pi * wt
    l1 = _f64(np.exp(lnl), dev)[:, None]
    ct = _f64(np.cos(th), dev)[None, :]
    st = _f64(np.sin(th), dev)[None, :]
    # d^2 l = l1 dl1 dtheta, dl1 = l1 du
    wgt = _f64(wl, dev)[:, None] * _f64(wth, dev)[None, :] * l1**2
    return l1, ct, st, wgt


def _Ls(Ls, dev):
    """The reconstruction multipoles as (nL, 1, 1)."""
    return torch.atleast_1d(_f64(Ls, dev))[:, None, None]


@on_device_of_inputs
def n0_flat_sky(Ls, est, cl_grad, cl_total, cl_total2=None,
                lmin=30, lmax=None, n_l=400, n_theta=256):
    """Flat-sky quadratic-estimator N0^{phiphi}(L) for est 'TT', 'EE' or
    'EB': cl_grad the theory spectrum of the response (TT, or EE), cl_total
    the first leg's total, cl_total2 the second leg's where it differs
    (EB: the BB total), raw C_l on integer l from 0; lmin, lmax the modes
    used (lmax: len(cl_grad) - 1); n_l, n_theta the quadrature orders.
    Returns N0 at Ls, (nL,)."""
    dev = call_device()
    cl_grad = _f64(cl_grad, dev)
    cl_total = _f64(cl_total, dev)
    cl_total2 = cl_total if cl_total2 is None else _f64(cl_total2, dev)
    if lmax is None:
        lmax = cl_grad.shape[0] - 1
    lmin, lmax = float(lmin), float(lmax)
    l1, ct, st, wgt = _nodes_flat_sky(lmin, lmax, n_l, n_theta, dev)
    c1g = _interp_cl(cl_grad, l1[:, 0])[:, None]
    c1t = _interp_cl(cl_total, l1[:, 0])[:, None]

    L = _Ls(Ls, dev)                                  # (nL, 1, 1)
    l2 = torch.sqrt(torch.clamp(L**2 + l1**2 - 2.0 * L * l1 * ct,
                                min=1e-30))
    Ldotl1 = L * l1 * ct
    Ldotl2 = L**2 - Ldotl1
    c2g = _interp_cl(cl_grad, l2)
    # cos / sin of 2(phi1 - phi2) from the triangle
    cosd = (L * ct - l1) / l2
    sind = L * st / l2
    cos2d = 2.0 * cosd**2 - 1.0
    sin2d = 2.0 * sind * cosd
    if est == "TT":
        f = c1g * Ldotl1 + c2g * Ldotl2
        denom_cl2 = _interp_cl(cl_total, l2)
        D = 2.0
    elif est == "EE":
        f = (c1g * Ldotl1 + c2g * Ldotl2) * cos2d
        denom_cl2 = _interp_cl(cl_total, l2)
        D = 2.0
    elif est == "EB":
        f = c1g * Ldotl1 * sin2d
        denom_cl2 = _interp_cl(cl_total2, l2)
        D = 1.0
    else:
        raise ValueError(f"unknown estimator {est!r}; use TT/EE/EB")
    valid = (l2 >= lmin) & (l2 <= lmax)
    integrand = torch.where(valid, f**2 / (D * c1t * denom_cl2), 0.0)
    # factor 2 for theta in [0, pi] only
    integral = 2.0 * torch.sum(wgt * integrand, dim=(-2, -1)) \
        / (2.0 * np.pi) ** 2
    return 1.0 / integral


@on_device_of_inputs
def n0_kappa_from_phi(Ls, n0_phi):
    """N0^{phiphi} in convergence units, kappa = L(L+1) phi / 2."""
    dev = call_device()
    Ls = _f64(Ls, dev)
    return (Ls * (Ls + 1.0) / 2.0) ** 2 * _f64(n0_phi, dev)


@on_device_of_inputs
def n0_minimum_variance(n0s):
    """Inverse-variance combination of independent estimators, N0_mv =
    (sum_a 1/N0_a)^{-1} (exact when their covariances vanish)."""
    dev = call_device()
    n0s = [_f64(n, dev) for n in n0s]
    return 1.0 / sum(1.0 / n for n in n0s)


# ---------------------------------------------------------------------------
# The Hu-Okamoto (2002) estimator family: TT, TE, EE, EB, TB, their
# cross-covariances and the exact minimum-variance combination.  Spectra
# enter as dicts keyed 'TT'/'EE'/'BB'/'TE'.
# ---------------------------------------------------------------------------

# (leg1 field spectrum, leg2 field spectrum) of each estimator's two legs
_EST_LEGS = {"TT": ("TT", "TT"), "TE": ("TT", "EE"), "EE": ("EE", "EE"),
             "EB": ("EE", "BB"), "TB": ("TT", "BB")}
# which theory spectrum carries the lensing response f of each estimator
_EST_GRAD = {"TT": "TT", "TE": "TE", "EE": "EE", "EB": "EE", "TB": "TE"}


def _f_12(est, g1, g2, Ldotl1, Ldotl2, cos2d, sin2d):
    """The flat-sky response f_est(l1, l2); g1 / g2 the estimator's
    gradient spectrum at l1 / l2.  For the curl mode the (L.l_i) are the
    cross products (L x l_i)."""
    if est == "TT":
        return g1 * Ldotl1 + g2 * Ldotl2
    if est == "EE":
        return (g1 * Ldotl1 + g2 * Ldotl2) * cos2d
    if est == "TE":
        return g1 * cos2d * Ldotl1 + g2 * Ldotl2
    if est in ("EB", "TB"):
        return g1 * Ldotl1 * sin2d
    raise ValueError(f"unknown estimator {est!r}")


def _f_21(est, g1, g2, Ldotl1, Ldotl2, cos2d, sin2d):
    """f_est(l2, l1): the legs swapped, so sin 2(phi_1 - phi_2) flips
    sign and cos does not."""
    if est in ("TT", "EE"):
        return _f_12(est, g1, g2, Ldotl1, Ldotl2, cos2d, sin2d)
    if est == "TE":
        return g2 * cos2d * Ldotl2 + g1 * Ldotl1
    if est in ("EB", "TB"):
        return -g2 * Ldotl2 * sin2d
    raise ValueError(f"unknown estimator {est!r}")


def _tot_xy(tots, x, y):
    """A total cross-spectrum pair; TB and EB totals vanish (None)."""
    key = x + y if x <= y else y + x
    if key in ("BE", "BT", "EB", "TB"):
        return None
    return tots[key if key in tots else key[::-1]]


def _est_FF(est, grads, tots, Ldotl1, Ldotl2, cos2d, sin2d):
    """(f(l1,l2), F(l1,l2), F(l2,l1), f(l2,l1)) of one estimator, F the
    optimal weight of HO02 eqs. (14)-(16): f/(2 C C) for TT/EE,
    f/(C^aa C^bb) for EB/TB, the non-diagonal form for TE."""
    g1, g2 = grads[_EST_GRAD[est]]
    f12 = _f_12(est, g1, g2, Ldotl1, Ldotl2, cos2d, sin2d)
    f21 = _f_21(est, g1, g2, Ldotl1, Ldotl2, cos2d, sin2d)
    a, b = _EST_LEGS[est]
    ca1, ca2 = tots[a]
    cb1, cb2 = tots[b]
    if est in ("TT", "EE"):
        F12 = f12 / (2.0 * ca1 * cb2)
        F21 = F12
    elif est in ("EB", "TB"):
        F12 = f12 / (ca1 * cb2)
        F21 = f21 / (ca2 * cb1)
    else:  # TE
        cte1, cte2 = tots["TE"]
        denom = ca1 * cb2 * ca2 * cb1 - (cte1 * cte2) ** 2
        F12 = (cb1 * ca2 * f12 - cte1 * cte2 * f21) / denom
        F21 = (cb2 * ca1 * f21 - cte1 * cte2 * f12) / denom
    return f12, F12, F21, f21


def _interp_spec_pair(spec, l1col, l2mat):
    return (_interp_cl(spec, l1col[:, 0])[:, None], _interp_cl(spec, l2mat))


def _qe_family(L, ests, cls_grad, cls_total, l1, ct, st, lmin, lmax,
               mode="grad"):
    """The node-grid quantities of the N0 and cross-N0 paths, L (nL, 1,
    1): (per-estimator (f12, F12, F21, f21), totals at (l1, l2), valid
    mask).  mode='curl' takes the cross products (L x l_i) = +/- L l1
    sin(theta) for the dot products."""
    l2 = torch.sqrt(torch.clamp(L**2 + l1**2 - 2.0 * L * l1 * ct,
                                min=1e-30))
    if mode == "curl":
        Ldotl1 = L * l1 * st          # (L x l1)
        Ldotl2 = -Ldotl1              # l2 = L - l1 => L x l2 = -L x l1
    elif mode == "grad":
        Ldotl1 = L * l1 * ct
        Ldotl2 = L**2 - Ldotl1
    else:
        raise ValueError(f"unknown mode {mode!r}; use 'grad' or 'curl'")
    cosd = (L * ct - l1) / l2
    sind = L * st / l2
    cos2d = 2.0 * cosd**2 - 1.0
    sin2d = 2.0 * sind * cosd
    need_g = {_EST_GRAD[e] for e in ests}
    need_t = set()
    for e in ests:
        need_t.update(_EST_LEGS[e])
        if e == "TE":
            need_t.add("TE")
    if len(set(ests)) > 1:
        # cross terms sample every available total cross-spectrum
        need_t.update(k for k in ("TT", "EE", "BB", "TE") if k in cls_total)
    grads = {k: _interp_spec_pair(cls_grad[k], l1, l2) for k in need_g}
    tots = {k: _interp_spec_pair(cls_total[k], l1, l2) for k in need_t}
    FF = {e: _est_FF(e, grads, tots, Ldotl1, Ldotl2, cos2d, sin2d)
          for e in ests}
    valid = (l2 >= lmin) & (l2 <= lmax)
    return FF, tots, valid


def _family_setup(Ls, cls_grad, cls_total, lmin, lmax, n_l, n_theta):
    dev = call_device()
    if lmax is None:
        lmax = min(len(c) for c in cls_grad.values()) - 1
    lmin, lmax = float(lmin), float(lmax)
    nodes = _nodes_flat_sky(lmin, lmax, n_l, n_theta, dev)
    cls_grad = {k: _f64(v, dev) for k, v in cls_grad.items()}
    cls_total = {k: _f64(v, dev) for k, v in cls_total.items()}
    return dev, lmin, lmax, nodes, cls_grad, cls_total


def _integral(wgt, integrand):
    return 2.0 * torch.sum(wgt * integrand, dim=(-2, -1)) / (2.0 * np.pi) ** 2


@on_device_of_inputs
def n0_pair_flat_sky(Ls, est, cls_grad, cls_total, lmin=30, lmax=None,
                     n_l=400, n_theta=256, mode="grad"):
    """N0^{phiphi}(L) of any Hu-Okamoto estimator ('TT', 'TE', 'EE', 'EB',
    'TB'), N0 = [int d^2 l1/(2pi)^2 f F]^{-1} with the optimal weights;
    cls_grad: the theory spectra of the response ('TT', 'EE', 'TE' as
    needed), cls_total: the totals of the legs (and 'TE' for the TE
    weight).  mode='curl': the field-rotation estimator's noise."""
    dev, lmin, lmax, (l1, ct, st, wgt), cls_grad, cls_total = _family_setup(
        Ls, cls_grad, cls_total, lmin, lmax, n_l, n_theta)
    FF, _, valid = _qe_family(_Ls(Ls, dev), (est,), cls_grad, cls_total,
                              l1, ct, st, lmin, lmax, mode=mode)
    f12, F12, _, _ = FF[est]
    return 1.0 / _integral(wgt, torch.where(valid, f12 * F12, 0.0))


@on_device_of_inputs
def n0_te_simple_flat_sky(Ls, cls_grad, cls_total, lmin=30, lmax=None,
                          n_l=400, n_theta=256):
    """(response, n0) of the simple-weight TE estimator F_s(l1,l2) =
    f_TE(l1,l2) / (C^TT,tot_{l1} C^EE,tot_{l2}), normalized by its own
    response: n0 = resp^-2 int F_s [F_s C^TT C^EE + F_s(l2,l1) C^TE C^TE],
    at least the optimal TE N0."""
    dev, lmin, lmax, (l1, ct, st, wgt), cls_grad, cls_total = _family_setup(
        Ls, cls_grad, cls_total, lmin, lmax, n_l, n_theta)
    FF, tots, valid = _qe_family(_Ls(Ls, dev), ("TE",), cls_grad, cls_total,
                                 l1, ct, st, lmin, lmax)
    f12, _, _, f21 = FF["TE"]
    ca1, ca2 = tots["TT"]
    cb1, cb2 = tots["EE"]
    ce1, ce2 = tots["TE"]
    Fs12 = f12 / (ca1 * cb2)
    Fs21 = f21 / (ca2 * cb1)
    resp = _integral(wgt, torch.where(valid, Fs12 * f12, 0.0))
    var = _integral(wgt, torch.where(
        valid, Fs12 * (Fs12 * ca1 * cb2 + Fs21 * ce1 * ce2), 0.0))
    return resp, var / resp**2


@on_device_of_inputs
def n0_cross_flat_sky(Ls, est1, est2, cls_grad, cls_total, n0_1=None,
                      n0_2=None, lmin=30, lmax=None, n_l=400, n_theta=256,
                      mode="grad"):
    """The cross-covariance N^{(ab)(cd)}(L) of two estimators (HO02 eq.
    17),

        N_(ab)(cd) = N_ab N_cd int d^2 l1/(2pi)^2 F_ab(l1,l2)
                     [ F_cd(l1,l2) C^ac(l1) C^bd(l2)
                       + F_cd(l2,l1) C^ad(l1) C^bc(l2) ],

    all C totals; n0_1 / n0_2 reuse precomputed auto N0s."""
    dev, lmin, lmax, (l1, ct, st, wgt), cls_grad, cls_total = _family_setup(
        Ls, cls_grad, cls_total, lmin, lmax, n_l, n_theta)
    kw = dict(lmin=lmin, lmax=lmax, n_l=n_l, n_theta=n_theta, mode=mode)
    if n0_1 is None:
        n0_1 = n0_pair_flat_sky(Ls, est1, cls_grad, cls_total, **kw)
    if n0_2 is None:
        n0_2 = n0_pair_flat_sky(Ls, est2, cls_grad, cls_total, **kw)
    a, b = _EST_LEGS[est1][0][0], _EST_LEGS[est1][1][0]
    c, d = _EST_LEGS[est2][0][0], _EST_LEGS[est2][1][0]
    FF, tots, valid = _qe_family(_Ls(Ls, dev), (est1, est2), cls_grad,
                                 cls_total, l1, ct, st, lmin, lmax, mode=mode)
    _, F12_1, _, _ = FF[est1]
    _, F12_2, F21_2, _ = FF[est2]
    cac, cbd = _tot_xy(tots, a, c), _tot_xy(tots, b, d)
    cad, cbc = _tot_xy(tots, a, d), _tot_xy(tots, b, c)
    term = torch.zeros_like(F12_1)
    if cac is not None and cbd is not None:
        term = term + F12_2 * cac[0] * cbd[1]
    if cad is not None and cbc is not None:
        term = term + F21_2 * cad[0] * cbc[1]
    integ = _integral(wgt, torch.where(valid, F12_1 * term, 0.0))
    return _f64(n0_1, dev) * _f64(n0_2, dev) * integ


@on_device_of_inputs
def n0_mv_flat_sky(Ls, cls_grad, cls_total,
                   ests=("TT", "TE", "EE", "EB", "TB"),
                   lmin=30, lmax=None, n_l=400, n_theta=256,
                   return_matrix=False, mode="grad"):
    """The exact minimum-variance combination N_mv(L) = [1^T N(L)^{-1}
    1]^{-1}, N(L) the full estimator covariance (auto N0s on the
    diagonal, cross N0s off it); with return_matrix=True also N, (nL,
    n_est, n_est)."""
    ests = tuple(ests)
    ne = len(ests)
    dev = call_device()
    Ls = torch.atleast_1d(_f64(Ls, dev))
    kw = dict(lmin=lmin, lmax=lmax, n_l=n_l, n_theta=n_theta, mode=mode)
    autos = {e: n0_pair_flat_sky(Ls, e, cls_grad, cls_total, **kw)
             for e in ests}
    N = torch.zeros((Ls.shape[0], ne, ne), dtype=_F64, device=dev)
    for i, e1 in enumerate(ests):
        N[:, i, i] = autos[e1]
        for j in range(i + 1, ne):
            e2 = ests[j]
            # the even {TT, TE, EE} x odd {EB, TB} cross N0 vanishes
            # identically (every product holds a TB or EB total)
            if e1.count("B") % 2 != e2.count("B") % 2:
                continue
            nij = n0_cross_flat_sky(Ls, e1, e2, cls_grad, cls_total,
                                    n0_1=autos[e1], n0_2=autos[e2], **kw)
            N[:, i, j] = nij
            N[:, j, i] = nij
    ones = torch.ones((Ls.shape[0], ne, 1), dtype=_F64, device=dev)
    winv = torch.linalg.solve(N, ones)[..., 0]
    n_mv = 1.0 / winv.sum(-1)
    if return_matrix:
        return n_mv, N
    return n_mv


@on_device_of_inputs
def lensed_bb_from_ee(cl_ee, clpp, lmax_out=None, n_phi=256):
    """First-order lensing BB from EE and a (possibly residual) lensing
    potential: the T_sin2 convolution of ``lensed_cls`` with the TT/TE
    legs zeroed, exactly linear in clpp."""
    from .lensed_cls import lens_cls_flat_sky
    dev = call_device()
    cl_ee = _f64(cl_ee, dev)
    unl = torch.zeros((cl_ee.shape[0], 4), dtype=_F64, device=dev)
    unl[:, 1] = cl_ee
    return lens_cls_flat_sky(unl, _f64(clpp, dev), lmax_out=lmax_out,
                             n_phi=n_phi)[:, 2]


@on_device_of_inputs
def n0_eb_iterative(Ls, cl_ee_grad, cl_ee_total, clpp, nl_bb,
                    lmin=30, lmax=None, n_iter=8, tol=1e-3,
                    n_l=400, n_theta=256, n_phi=256, nodes=None,
                    return_info=False):
    """The iteratively delensed EB reconstruction noise N0^{phiphi}(L)
    (Smith et al. 2012 fixed point):

        rho^2(L)  = C_pp / (C_pp + N0(L))
        C_BB^res  = T_sin2[C_EE, C_pp (1 - rho^2)]
        N0        = n0_flat_sky('EB', ..., cl_total2 = C_BB^res + N_BB)

    from rho = 0, until the largest relative change of N0 at ``nodes``
    (default ~24 log-spaced over [2, lmax_pp]) is below tol.  A host loop
    whose quadratures run on the device.  Returns N0 at Ls; with
    return_info=True also {'n0_first', 'n0_nodes', 'nodes', 'rho2',
    'cl_bb_res', 'iters'} (host arrays)."""
    dev = call_device()
    host = lambda v: np.asarray(_f64(v, "cpu"))
    cl_ee_grad, cl_ee_total, clpp, nl_bb = (
        host(v) for v in (cl_ee_grad, cl_ee_total, clpp, nl_bb))
    if lmax is None:
        lmax = cl_ee_grad.shape[0] - 1
    lmax_pp = clpp.shape[0] - 1
    if nodes is None:
        nodes = np.unique(np.round(np.geomspace(2.0, lmax_pp, 24)))
    nodes = np.asarray(nodes, dtype=np.float64)
    lpp = np.arange(lmax_pp + 1, dtype=np.float64)
    nlb = np.zeros(int(lmax) + 1)
    n = min(nl_bb.shape[0], nlb.shape[0])
    nlb[:n] = nl_bb[:n]
    ee_grad, ee_total = _f64(cl_ee_grad, dev), _f64(cl_ee_total, dev)

    def n0_eval(Lq, cl_bb_tot):
        return host(n0_flat_sky(Lq, "EB", ee_grad, ee_total,
                                cl_total2=_f64(cl_bb_tot, dev), lmin=lmin,
                                lmax=lmax, n_l=n_l, n_theta=n_theta))

    def bb(cpp):
        return host(lensed_bb_from_ee(ee_grad, _f64(cpp, dev), lmax_out=lmax,
                                      n_phi=n_phi))

    cl_bb_tot = bb(clpp) + nlb
    n0_nodes = n0_eval(nodes, cl_bb_tot)
    n0_first = n0_nodes.copy()
    rho2 = np.zeros_like(lpp)
    iters = 0
    for it in range(int(n_iter)):
        n0_int = np.exp(np.interp(np.log(np.maximum(lpp, 2.0)),
                                  np.log(nodes), np.log(n0_nodes)))
        rho2 = np.where(clpp > 0.0, clpp / (clpp + n0_int), 0.0)
        cl_bb_tot = bb(clpp * (1.0 - rho2)) + nlb
        n0_new = n0_eval(nodes, cl_bb_tot)
        change = float(np.max(np.abs(n0_new / n0_nodes - 1.0)))
        n0_nodes = n0_new
        iters = it + 1
        if change < tol:
            break
    out = _f64(n0_eval(np.atleast_1d(host(Ls)), cl_bb_tot), dev)
    if return_info:
        return out, {"n0_first": n0_first, "n0_nodes": n0_nodes,
                     "nodes": nodes, "rho2": rho2,
                     "cl_bb_res": cl_bb_tot - nlb, "iters": iters}
    return out


@on_device_of_inputs
def threej000_sq(l1, l2, l3):
    """(l1 l2 l3; 0 0 0)^2 as a float64 tensor, in closed form through
    log-gamma: zero when J = l1+l2+l3 is odd or the triangle fails, else

        3j^2 = (J-2l1)! (J-2l2)! (J-2l3)! / (J+1)!
               * [ (J/2)! / ((J/2-l1)! (J/2-l2)! (J/2-l3)!) ]^2.

    exp carries the log-gamma sum's absolute rounding (~1e-11 at l ~
    5,000) into relative error."""
    dev = call_device()
    l1, l2, l3 = (_f64(v, dev) for v in (l1, l2, l3))
    J = l1 + l2 + l3
    g = J / 2.0
    even = torch.remainder(J, 2.0) == 0.0
    tri = (l3 >= torch.abs(l1 - l2)) & (l3 <= l1 + l2)
    ok = even & tri
    # the factorial arguments clamped where masked out, to keep lgamma
    # finite there
    a1 = torch.where(ok, J - 2.0 * l1, 0.0)
    a2 = torch.where(ok, J - 2.0 * l2, 0.0)
    a3 = torch.where(ok, J - 2.0 * l3, 0.0)
    b1 = torch.where(ok, g - l1, 0.0)
    b2 = torch.where(ok, g - l2, 0.0)
    b3 = torch.where(ok, g - l3, 0.0)
    gl = torch.lgamma
    ln = (gl(a1 + 1.0) + gl(a2 + 1.0) + gl(a3 + 1.0) - gl(J + 2.0)
          + 2.0 * (gl(g + 1.0) - gl(b1 + 1.0) - gl(b2 + 1.0)
                   - gl(b3 + 1.0)))
    return torch.where(ok, torch.exp(ln), 0.0)


def _n0_tt_fullsky_one(L, cl_grad, cl_total, lmin, lmax, width):
    """1/A_L of one reconstruction multipole (see n0_tt_fullsky), summed
    over chunks of l1 rows."""
    dev = cl_grad.device
    l1_all = torch.arange(float(lmin), float(lmax) + 1.0, dtype=_F64,
                          device=dev)
    j = torch.arange(float(width), dtype=_F64, device=dev)[None, :]
    LL = L * (L + 1.0)
    inv_a = torch.zeros((), dtype=_F64, device=dev)
    rows = max(1, _CHUNK_ELEMENTS // width)
    for l1 in torch.split(l1_all, rows):
        l1 = l1[:, None]                                       # (n1, 1)
        l2 = torch.abs(l1 - L) + j                             # (n1, W)
        valid = (j <= 2.0 * torch.clamp(l1, max=L)) & (l2 >= float(lmin)) \
            & (l2 <= float(lmax))
        l2c = torch.where(valid, l2, l1 + L)   # a safe in-triangle stand-in
        w2 = threej000_sq(l1, torch.full_like(l2c, L), l2c)
        # f_{l1 L l2} = pref * 3j * [ C_{l1} (L(L+1)+l1(l1+1)-l2(l2+1))
        #                           + C_{l2} (L(L+1)+l2(l2+1)-l1(l1+1)) ] / 2
        s1 = l1 * (l1 + 1.0)
        s2 = l2c * (l2c + 1.0)
        c1g = _interp_cl(cl_grad, l1[:, 0])[:, None]
        c2g = _interp_cl(cl_grad, l2c)
        bracket = 0.5 * (c1g * (LL + s1 - s2) + c2g * (LL + s2 - s1))
        pref2 = (2.0 * l1 + 1.0) * (2.0 * L + 1.0) * (2.0 * l2c + 1.0) \
            / (4.0 * math.pi)
        f2 = pref2 * w2 * bracket**2
        c1t = _interp_cl(cl_total, l1[:, 0])[:, None]
        c2t = _interp_cl(cl_total, l2c)
        inv_a = inv_a + torch.sum(torch.where(valid, f2 / (2.0 * c1t * c2t),
                                              0.0))
    return 1.0 / (inv_a / (2.0 * L + 1.0))


@on_device_of_inputs
def n0_tt_fullsky(Ls, cl_grad, cl_total, lmin=30, lmax=None):
    """The exact full-sky TT quadratic-estimator N0^{phiphi}(L),

        N0(L) = A_L,   A_L^{-1} = (1/(2L+1)) sum_{l1 l2}
                                   f^2 / (2 C^tot_{l1} C^tot_{l2}),
        f = (1/2) sqrt((2l1+1)(2L+1)(2l2+1)/4pi) (l1 L l2; 0 0 0)
            * [ C_{l1} (L(L+1)+l1(l1+1)-l2(l2+1))
              + C_{l2} (L(L+1)+l2(l2+1)-l1(l1+1)) ],

    as a masked (n_l1, width) array per L, in chunks of l1."""
    dev = call_device()
    cl_grad = _f64(cl_grad, dev)
    cl_total = _f64(cl_total, dev)
    if lmax is None:
        lmax = cl_grad.shape[0] - 1
    Ls = np.atleast_1d(np.asarray(torch.as_tensor(Ls).cpu(),
                                  dtype=np.float64))
    width = int(2 * min(int(Ls.max()), int(lmax)) + 1)
    return torch.stack([_n0_tt_fullsky_one(float(L), cl_grad, cl_total,
                                           int(lmin), int(lmax), width)
                        for L in Ls])


def _n1_tt_one(L, cl_grad, cl_total, clpp, lmin, lmax, n_l, n_theta,
               n_s, n_alpha):
    """2 x the first term's integral of the N1 derivation (see
    n1_tt_flat_sky): N1 / N0^2 at one L."""
    dev = cl_grad.device
    lmax_pp = clpp.shape[0] - 1
    t = lambda a: torch.as_tensor(a, dtype=_F64, device=dev)

    # l1: GL in ln r over [lmin, lmax] x midpoint angle over [0, 2pi)
    xu, wu = leggauss_cached(int(n_l))
    lnr = 0.5 * (np.log(lmax) + np.log(lmin)) \
        + 0.5 * (np.log(lmax) - np.log(lmin)) * xu
    wr = 0.5 * (np.log(lmax) - np.log(lmin)) * wu
    r1 = np.exp(lnr)
    t1 = (np.arange(n_theta) + 0.5) * (2.0 * np.pi / n_theta)
    w1 = (r1**2 * wr)[:, None] * (2.0 * np.pi / n_theta)   # d^2 l1 weight

    # s: GL in ln s over [2, lmax_pp] x midpoint alpha over [0, pi) x 2
    xs_, ws_ = leggauss_cached(int(n_s))
    lns = 0.5 * (np.log(lmax_pp) + np.log(2.0)) \
        + 0.5 * (np.log(lmax_pp) - np.log(2.0)) * xs_
    wss = 0.5 * (np.log(lmax_pp) - np.log(2.0)) * ws_
    rs = np.exp(lns)
    al = (np.arange(n_alpha) + 0.5) * (np.pi / n_alpha)
    w2 = 2.0 * (rs**2 * wss)[:, None] * (np.pi / n_alpha)  # d^2 s weight

    # components, broadcast (n_l, n_theta, n_s, n_alpha); L along x
    l1x = t(np.cos(t1))[None, :, None, None] * t(r1)[:, None, None, None]
    l1y = t(np.sin(t1))[None, :, None, None] * t(r1)[:, None, None, None]
    sx = t(np.cos(al))[None, None, None, :] * t(rs)[None, None, :, None]
    sy = t(np.sin(al))[None, None, None, :] * t(rs)[None, None, :, None]
    l2x, l2y = L - l1x, -l1y
    l3x, l3y = sx - l1x, sy - l1y
    l4x, l4y = -L - l3x, -l3y

    m1 = torch.sqrt(l1x**2 + l1y**2)
    m2 = torch.sqrt(l2x**2 + l2y**2)
    m3 = torch.sqrt(torch.clamp(l3x**2 + l3y**2, min=1e-30))
    m4 = torch.sqrt(torch.clamp(l4x**2 + l4y**2, min=1e-30))
    c1, c2 = _interp_cl(cl_grad, m1), _interp_cl(cl_grad, m2)
    c3, c4 = _interp_cl(cl_grad, m3), _interp_cl(cl_grad, m4)

    def fdot(ca, ax, ay, cb, bx, by):
        # f(a, b) = C_a (a+b).a + C_b (a+b).b
        kx, ky = ax + bx, ay + by
        return ca * (kx * ax + ky * ay) + cb * (kx * bx + ky * by)

    f12 = fdot(c1, l1x, l1y, c2, l2x, l2y)
    f34 = fdot(c3, l3x, l3y, c4, l4x, l4y)
    f13 = fdot(c1, l1x, l1y, c3, l3x, l3y)
    f24 = fdot(c2, l2x, l2y, c4, l4x, l4y)

    t1_ = _interp_cl(cl_total, m1)
    t2_ = _interp_cl(cl_total, m2)
    t3_ = _interp_cl(cl_total, m3)
    t4_ = _interp_cl(cl_total, m4)
    band = ((m1 >= lmin) & (m1 <= lmax) & (m2 >= lmin) & (m2 <= lmax)
            & (m3 >= lmin) & (m3 <= lmax) & (m4 >= lmin) & (m4 <= lmax))
    F12 = torch.where(band, f12 / (2.0 * t1_ * t2_), 0.0)
    F34 = torch.where(band, f34 / (2.0 * t3_ * t4_), 0.0)

    cpp_s = _interp_cl(clpp, torch.sqrt(sx**2 + sy**2))
    integrand = F12 * F34 * f13 * f24 * cpp_s
    w = t(w1)[:, :, None, None] * t(w2)[None, None]
    return 2.0 * torch.sum(w * integrand) / (2.0 * np.pi) ** 4


@on_device_of_inputs
def n1_tt_flat_sky(Ls, cl_grad, cl_total, clpp, lmin=30, lmax=None,
                   n_l=96, n_theta=64, n_s=64, n_alpha=32, n0_phi=None):
    """The flat-sky N1 bias of the TT quadratic estimator,

        N1(L) = A_L^2 int int [d^2 l1 d^2 l3 / (2pi)^4] F(l1,l2)
                F(l3,l4) [ C_pp(|l1+l3|) f(l1,l3) f(l2,l4)
                         + C_pp(|l1+l4|) f(l1,l4) f(l2,l3) ],
        l2 = L - l1,  l4 = -L - l3,

    with s = l1 + l3 on its own log-radial x angle quadrature (the
    integrand peaks at small s) and the second term folded into a factor
    2.  One (n_l, n_theta, n_s, n_alpha) integrand per L.  n0_phi: the
    per-L N0 (else ``n0_flat_sky`` TT at its default orders)."""
    dev = call_device()
    cl_grad = _f64(cl_grad, dev)
    cl_total = _f64(cl_total, dev)
    clpp = _f64(clpp, dev)
    if lmax is None:
        lmax = cl_grad.shape[0] - 1
    Ls = np.atleast_1d(np.asarray(torch.as_tensor(Ls).cpu(),
                                  dtype=np.float64))
    if n0_phi is None:
        n0_phi = n0_flat_sky(Ls, "TT", cl_grad, cl_total, lmin=lmin,
                             lmax=lmax)
    core = [_n1_tt_one(float(L), cl_grad, cl_total, clpp, float(lmin),
                       float(lmax), int(n_l), int(n_theta), int(n_s),
                       int(n_alpha)) for L in Ls]
    return _f64(n0_phi, dev) ** 2 * torch.stack(core)
