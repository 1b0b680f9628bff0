"""Halo occupation distribution (HOD) with the Behroozi stellar-mass to
halo-mass relation, on float64 tensors (port of hmvec_tpu/models/hod.py).

  * Behroozi et al. (arXiv:1001.0015, Table 2) M_halo(M*), two z regimes;
  * its inverse M*(M_halo) by sampling on a dense log grid and one
    searchsorted + lerp per redshift row (``ops.quadrature.linear_interp``,
    with ``numpy.interp``'s end behaviour);
  * <Nc> = (1/2)(1 - erf), <Ns> a power law with an exponential cutoff;
  * ngal -> log10 mthresh by fixed-count vectorized bisection
    (ops/rootfind.invert_monotone).  As in the JAX package the bisection
    passes no derivative to the threshold: the bracket ends are constants
    and ``torch.where`` only selects among them.

Redshifts and masses are tensors on one device (numpy arrays and numbers
are carried to the device of the tensor arguments).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.quadrature import linear_interp
from ..ops.rootfind import invert_monotone
from ..utils.weights import (device_of, f64, mass_weights, on_device_of_inputs,
                             tensor_or_f64)

_F64 = torch.float64


def _behroozi_core(log10mstar, a, p):
    (Mstar00, Mstara, M1, M1a, beta0, beta_a,
     gamma0, gamma_a, delta0, delta_a) = p
    log10M1 = M1 + M1a * (a - 1.0)
    log10Mstar0 = Mstar00 + Mstara * (a - 1.0)
    beta = beta0 + beta_a * (a - 1.0)
    gamma = gamma0 + gamma_a * (a - 1.0)
    delta = delta0 + delta_a * (a - 1.0)
    d = log10mstar - log10Mstar0
    return (-0.5 + log10M1 + beta * d
            + 10.0 ** (delta * d) / (1.0 + 10.0 ** (-gamma * d)))


@on_device_of_inputs
def Mhalo_stellar_core(log10mstellar, a, Mstar00, Mstara, M1, M1a,
                       beta0, beta_a, gamma0, gamma_a, delta0, delta_a):
    """log10 M_halo from log10 M* at scale factor a, with the ten Behroozi
    fit parameters passed explicitly."""
    dev = device_of(log10mstellar, a)
    return _behroozi_core(f64(log10mstellar, dev), f64(a, dev),
                          (Mstar00, Mstara, M1, M1a, beta0, beta_a,
                           gamma0, gamma_a, delta0, delta_a))


# Behroozi 1001.0015 Table 2 fit parameters (z <= 0.8 and z > 0.8 regimes)
_BEHROOZI_LOWZ = (10.72, 0.55, 12.35, 0.28, 0.44, 0.18, 1.56, 2.51, 0.57, 0.17)
_BEHROOZI_HIZ = (11.09, 0.56, 12.27, -0.84, 0.65, 0.31, 1.12, -0.53, 0.56, -0.12)


@on_device_of_inputs
def mhalo_from_mstellar(zs, log10mstellar):
    """log10 M_halo(M*).  zs: (nz,) or (nz, 1); log10mstellar:
    broadcastable to (nz, n)."""
    dev = device_of(zs, log10mstellar)
    zcol = f64(zs, dev).reshape(-1, 1)
    a = 1.0 / (1.0 + zcol)
    ms = f64(log10mstellar, dev)
    ms = ms.expand(zcol.shape[0], ms.shape[-1])
    low = _behroozi_core(ms, a, _BEHROOZI_LOWZ)
    high = _behroozi_core(ms, a, _BEHROOZI_HIZ)
    return torch.where(zcol <= 0.8, low, high)


_MSTAR_GRID = np.linspace(-18.0, 18.0, 4000)


@on_device_of_inputs
def mstellar_from_mhalo(zs, log10mhalo):
    """log10 M*(M_halo): the Behroozi relation inverted on a dense grid,
    shape (nz, n) for log10mhalo (n,) or (1, n)."""
    dev = device_of(zs, log10mhalo)
    grid = f64(_MSTAR_GRID, dev)
    mh = mhalo_from_mstellar(zs, grid[None, :])       # (nz, ngrid)
    lm = f64(log10mhalo, dev)
    mhal = lm.reshape(1, -1).expand(mh.shape[0], lm.shape[-1])
    return linear_interp(mhal, mh, grid)


def avg_nc(log10mhalo, zs, log10mstellar_thresh, sig_log_mstellar):
    """<Nc(m)>."""
    log10mstar = mstellar_from_mhalo(zs, log10mhalo)
    num = f64(log10mstellar_thresh, log10mstar.device) - log10mstar
    denom = math.sqrt(2.0) * sig_log_mstellar
    return 0.5 * (1.0 - torch.erf(num / denom))


def _default_mfunc(mthresh, Bamp, Bind):
    """10^12 B 10^((mthresh - 12) beta)."""
    return 10.0**12 * Bamp * 10.0 ** ((mthresh - 12.0) * Bind)


def avg_ns(log10mhalo, zs, log10mstellar_thresh, Nc, hod_params,
           Msat_override=None, Mcut_override=None):
    """<Ns(m)>."""
    dev = device_of(Nc, zs, log10mhalo)
    mthresh = mhalo_from_mstellar(zs, f64(log10mstellar_thresh, dev))
    Msat = (Msat_override if Msat_override is not None
            else _default_mfunc(mthresh, hod_params["hod_Bsat"],
                                hod_params["hod_betasat"]))
    Mcut = (Mcut_override if Mcut_override is not None
            else _default_mfunc(mthresh, hod_params["hod_Bcut"],
                                hod_params["hod_betacut"]))
    masses = 10.0 ** f64(log10mhalo, dev)
    return (Nc * (masses / Msat) ** hod_params["hod_alphasat"]
            * torch.exp(-Mcut / masses))


@on_device_of_inputs
def avg_nsnsm1(Nc, Ns, corr="max"):
    """<Ns(Ns-1)>.  Nc counts as zero where numpy.isclose(Nc, 0) holds with
    its default tolerances, |Nc| <= 1e-8, as in the JAX package (written
    out: torch.isclose has no batching rule under vmap)."""
    Nc, Ns = tensor_or_f64(Nc), tensor_or_f64(Ns)
    if corr == "max":
        zero = Nc.abs() <= 1e-8
        return torch.where(zero, 0.0, Ns**2 / torch.where(zero, 1.0, Nc))
    if corr == "min":
        return Ns**2
    raise ValueError(corr)


def avg_ncns(Nc, Ns, corr="max"):
    """<Nc Ns>."""
    if corr == "max":
        return Ns
    if corr == "min":
        return Ns * Nc
    raise ValueError(corr)


# hmvec-compatible aliases where the signatures match
Mstellar_halo = mstellar_from_mhalo
Mhalo_stellar = mhalo_from_mstellar
avg_Nc = avg_nc
avg_NsNsm1 = avg_nsnsm1
avg_NcNs = avg_ncns
hod_default_mfunc = _default_mfunc


@on_device_of_inputs
def avg_Ns(log10mhalo, z, log10mstellar_thresh, Nc=None,
           sig_log_mstellar=None, alphasat=None, Bsat=None, betasat=None,
           Bcut=None, betacut=None, Msat_override=None, Mcut_override=None):
    """<Ns(m)> with hmvec's flat keyword signature."""
    if Nc is None:
        Nc = avg_nc(log10mhalo, z, log10mstellar_thresh, sig_log_mstellar)
    hp = {"hod_alphasat": alphasat, "hod_Bsat": Bsat,
          "hod_betasat": betasat, "hod_Bcut": Bcut, "hod_betacut": betacut}
    return avg_ns(log10mhalo, z, log10mstellar_thresh, Nc, hp,
                  Msat_override=Msat_override, Mcut_override=Mcut_override)


@on_device_of_inputs
def avg_nc_zheng05(log10mhalo, log10mmin, siglogm):
    """Zheng et al. 2005/2007 central occupation
    <Nc> = (1/2)[1 + erf((log10 M - log10 Mmin) / sigma_logM)]."""
    return 0.5 * (1.0 + torch.erf((tensor_or_f64(log10mhalo) - log10mmin)
                                  / siglogm))


@on_device_of_inputs
def avg_ns_zheng05(masses, Nc, m0, m1, alpha):
    """Zheng-05 satellite occupation <Ns> = Nc ((M - M0) / M1')^alpha for
    M > M0, else 0 (the double where keeps the gradient finite at the
    cutoff for a non-integer alpha)."""
    masses, Nc = tensor_or_f64(masses), tensor_or_f64(Nc)
    pos = masses > m0
    frac = torch.where(pos, (masses - m0) / m1, 1.0)
    return torch.where(pos, Nc * frac**alpha, 0.0)


class HODGrid(NamedTuple):
    Nc: torch.Tensor            # (nz, nm)
    Ns: torch.Tensor            # (nz, nm)
    NsNsm1: torch.Tensor        # (nz, nm)
    NcNs: torch.Tensor          # (nz, nm)
    ngal: torch.Tensor          # (nz,)
    bg: torch.Tensor            # (nz,)
    log10mthresh: torch.Tensor  # (nz, 1)


def _finish(grid_at, thresh, nzm, bh, w, corr):
    """The HODGrid of the occupation ``grid_at(thresh)``."""
    Nc, Ns = grid_at(thresh)
    ngal_out = (nzm * (Nc + Ns)) @ w
    bg = ((nzm * (Nc + Ns) * bh) @ w) / ngal_out
    return HODGrid(Nc=Nc, Ns=Ns, NsNsm1=avg_nsnsm1(Nc, Ns, corr),
                   NcNs=avg_ncns(Nc, Ns, corr), ngal=ngal_out, bg=bg,
                   log10mthresh=thresh)


@on_device_of_inputs
def build_hod_zheng05(zs, ms, nzm, bh, hod_params, ngal=None, corr="max"):
    """Zheng-05 HOD grid on (zs, ms); if ``ngal`` (nz,) is given, solve
    log10 Mmin for it by the same fixed-count bisection as the
    Behroozi-threshold family (sigma_logM, M0, M1, alpha held fixed).

    Returns an HODGrid whose log10mthresh carries log10 Mmin.
    """
    nzm, bh = tensor_or_f64(nzm), tensor_or_f64(bh)
    dev = nzm.device
    zs, ms = f64(zs, dev), f64(ms, dev)
    w = mass_weights(ms)
    log10mhalo = torch.log10(ms)[None, :]
    masses = 10.0 ** log10mhalo
    sig = hod_params["hod_zheng_siglogm"]
    m0 = 10.0 ** f64(hod_params["hod_zheng_log10M0"], dev)
    m1 = 10.0 ** f64(hod_params["hod_zheng_log10M1"], dev)
    alpha = hod_params["hod_zheng_alpha"]

    def grid_at(log10mmin):
        Nc = avg_nc_zheng05(log10mhalo, log10mmin, sig)
        return Nc, avg_ns_zheng05(masses, Nc, m0, m1, alpha)

    if ngal is not None:
        def nfunc(log10mmin):
            Nc, Ns = grid_at(log10mmin[:, None])
            return (nzm * (Nc + Ns)) @ w

        # the bracket is in halo mass (log10 Mmin), not the Behroozi
        # family's stellar-mass threshold: clusters reach log10 M ~ 15.5
        log10mmin = invert_monotone(
            nfunc, f64(ngal, dev),
            hod_params.get("hod_zheng_bisection_lo", 9.0),
            hod_params.get("hod_zheng_bisection_hi", 16.5),
            num_iter=hod_params["hod_bisection_num_iter"],
            increasing=False)
        thresh = log10mmin[:, None]
    else:
        thresh = (f64(hod_params["hod_zheng_log10Mmin"], dev)
                  + torch.zeros((zs.shape[0], 1), dtype=_F64, device=dev))
    return _finish(grid_at, thresh, nzm, bh, w, corr)


def _nc_ns_precomp(log10mstar, masses, zs, thresh, hod_params,
                   Msat_override=None, Mcut_override=None):
    """<Nc>, <Ns> given the precomputed Behroozi inversion log10mstar =
    M*(M_halo) and masses = 10**log10mhalo on the (z, m) grid.

    The inversion depends on the mass grid alone, not on the threshold
    being solved, so the ngal bisection evaluates it once and not on each
    of its 90 rounds.  The same operations in the same order as
    avg_nc / avg_ns."""
    num = thresh - log10mstar
    denom = math.sqrt(2.0) * hod_params["hod_sig_log_mstellar"]
    Nc = 0.5 * (1.0 - torch.erf(num / denom))
    mthresh_halo = mhalo_from_mstellar(zs, thresh)
    Msat = (Msat_override if Msat_override is not None
            else _default_mfunc(mthresh_halo, hod_params["hod_Bsat"],
                                hod_params["hod_betasat"]))
    Mcut = (Mcut_override if Mcut_override is not None
            else _default_mfunc(mthresh_halo, hod_params["hod_Bcut"],
                                hod_params["hod_betacut"]))
    Ns = (Nc * (masses / Msat) ** hod_params["hod_alphasat"]
          * torch.exp(-Mcut / masses))
    return Nc, Ns


@on_device_of_inputs
def ngal_from_mthresh(log10mthresh, zs, nzm, ms, hod_params,
                      Msat_override=None, Mcut_override=None, weights=None):
    """n_gal(z) = int dm n(z, m) (Nc + Ns).  ``weights``: optional
    precomputed trapezoid weights of the mass grid."""
    nzm = tensor_or_f64(nzm)
    dev = nzm.device
    ms = f64(ms, dev)
    log10mhalo = torch.log10(ms)[None, :]
    thresh = f64(log10mthresh, dev)[:, None]
    Nc = avg_nc(log10mhalo, zs, thresh, hod_params["hod_sig_log_mstellar"])
    Ns = avg_ns(log10mhalo, zs, thresh, Nc, hod_params,
                Msat_override, Mcut_override)
    w = mass_weights(ms) if weights is None else f64(weights, dev)
    return (nzm * (Nc + Ns)) @ w


def build_hod(zs, ms, nzm, bh, hod_params, mthresh=None, ngal=None,
              corr="max", Msat_override=None, Mcut_override=None):
    """Construct the HOD grid on (zs, ms) for the mass function nzm and
    bias bh, both (nz, nm); solve ngal (nz,) -> mthresh if ngal is given,
    else take the stellar-mass thresholds mthresh (nz,)."""
    dev = nzm.device
    zs, ms = f64(zs, dev), f64(ms, dev)
    w = mass_weights(ms)
    log10mhalo = torch.log10(ms)[None, :]
    # independent of the threshold: once, outside the bisection
    log10mstar = mstellar_from_mhalo(zs, log10mhalo)
    masses = 10.0 ** log10mhalo

    def grid_at(thresh):
        return _nc_ns_precomp(log10mstar, masses, zs, thresh, hod_params,
                              Msat_override, Mcut_override)

    if ngal is not None:
        def nfunc(log10mthresh):
            Nc, Ns = grid_at(log10mthresh[:, None])
            return (nzm * (Nc + Ns)) @ w

        log10mthresh = invert_monotone(
            nfunc, f64(ngal, dev),
            hod_params["hod_bisection_search_min_log10mthresh"],
            hod_params["hod_bisection_search_max_log10mthresh"],
            num_iter=hod_params["hod_bisection_num_iter"],
            increasing=False)
        mthresh = 10.0 ** (log10mthresh * hod_params["hod_A_log10mthresh"])
    thresh = torch.log10(f64(mthresh, dev))[:, None]
    return _finish(grid_at, thresh, nzm, bh, w, corr)
