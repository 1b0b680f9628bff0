"""Real-space weak-lensing statistics on float64 tensors (port of
hmvec_tpu/models/shear.py): the curved-sky transforms

    xi_+(theta)   = sum_l (2l+1)/(4pi) [C^E_l + C^B_l] d^l_{2,2}(theta)
    xi_-(theta)   = sum_l (2l+1)/(4pi) [C^E_l - C^B_l] d^l_{2,-2}(theta)
    gamma_t(theta)= sum_l (2l+1)/(4pi) C^{gE}_l       d^l_{2,0}(theta)
    w(theta)      = sum_l (2l+1)/(4pi) C^{gg}_l       d^l_{0,0}(theta)

with d^l_{mn} the Wigner small-d matrices, their Gaussian covariance, and
the materialized d-table that the MASTER coupling matrices are built on.

Every function runs the same upward three-term recurrence in l for all
angles at once (``_step``, the JAX package's order of operations).  The
JAX package runs it as a ``lax.scan``; here it is a Python loop over l
with each step's coefficients formed on the host in float64, so a sum
over nl multipoles is about 8 nl launches of (..., ntheta) element-wise
work.  The work runs on the device of the first tensor argument; with
only host data, on ``device`` (the card unless told otherwise).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.weights import call_device, on_device_of_inputs

_F64 = torch.float64

# (d^{lmin}_{mn}(x), d^{lmin+1}_{mn}(x)) at lmin = max(|m|, |n|) as closed
# forms in x = cos(theta): the recurrence's denominator vanishes at l = 0,
# so the (0, 0) case needs both seeds
_SEEDS = {
    (0, 0): (lambda x: torch.ones_like(x),
             lambda x: x),
    (2, 2): (lambda x: ((1.0 + x) / 2.0) ** 2,
             lambda x: ((1.0 + x) / 2.0) ** 2 * (3.0 * x - 2.0)),
    (2, -2): (lambda x: ((1.0 - x) / 2.0) ** 2,
              lambda x: ((1.0 - x) / 2.0) ** 2 * (3.0 * x + 2.0)),
    (2, 0): (lambda x: math.sqrt(6.0) / 4.0 * (1.0 - x**2),
             lambda x: math.sqrt(30.0) / 4.0 * x * (1.0 - x**2)),
}

_XI_MN = {"plus": (2, 2), "minus": (2, -2), "gammat": (2, 0), "w": (0, 0)}


def _spins(mn):
    m, n = int(mn[0]), int(mn[1])
    if (m, n) not in _SEEDS:
        raise ValueError(f"unsupported (m, n) = {(m, n)}; "
                         f"available: {sorted(_SEEDS)}")
    return m, n


def _consecutive(ells):
    ells = np.asarray(ells)
    if ells.ndim != 1 or not np.all(np.diff(ells) == 1):
        raise ValueError("ells must be consecutive integers")
    return ells


def _step(m, n, dm1, d, l, x, out=None):
    """d^{l+1}_{mn}(x) from d^l and d^{l-1} (Varshalovich 4.8.1):

        d^{l+1} = [ (2l+1)(l(l+1) x - m n) d^l
                    - (l+1) sqrt((l^2-m^2)(l^2-n^2)) d^{l-1} ]
                  / [ l sqrt(((l+1)^2-m^2)((l+1)^2-n^2)) ]

    l a Python float; stable upward for |m|, |n| <= 2 at all angles."""
    fm, fn = float(m), float(n)
    num = ((2.0 * l + 1.0) * (l * (l + 1.0) * x - fm * fn) * d
           - (l + 1.0) * math.sqrt((l**2 - fm**2) * (l**2 - fn**2)) * dm1)
    den = l * math.sqrt(((l + 1.0) ** 2 - fm**2) * ((l + 1.0) ** 2 - fn**2))
    return torch.div(num, den, out=out)


def _dense_weights(ells, wls, lmin):
    """The weights of consecutive ``ells`` on the dense l range from lmin,
    (nl_total,) + wls.shape[:-1]; rows below lmin are dropped."""
    dev = wls.device
    keep = ells >= lmin
    w = torch.zeros((int(ells[-1]) + 1 - lmin,) + wls.shape[:-1],
                    dtype=_F64, device=dev)
    w[torch.as_tensor(ells[keep] - lmin, device=dev)] = \
        wls[..., torch.as_tensor(np.nonzero(keep)[0], device=dev)] \
        .movedim(-1, 0)
    return w


@on_device_of_inputs
def wigner_d_sum(ells, cls, thetas_rad, mn=(0, 0)):
    """sum_l (2l+1)/(4pi) C_l d^l_{mn}(theta) by upward recurrence.

    ells: (nl,) consecutive integers from any l0 >= 0 (rows below
    max(|m|, |n|) multiply d's that vanish and are ignored); cls (..., nl);
    thetas_rad (nt,).  Returns (..., nt)."""
    m, n = _spins(mn)
    lmin = max(abs(m), abs(n))
    ells = _consecutive(ells)
    dev = call_device()
    cls = torch.as_tensor(cls, dtype=_F64, device=dev)
    x = torch.cos(torch.as_tensor(thetas_rad, dtype=_F64, device=dev))
    wcls = cls * ((2.0 * torch.as_tensor(ells, dtype=_F64, device=dev) + 1.0)
                  / (4.0 * math.pi))
    w = _dense_weights(ells, wcls, lmin)[..., None]      # (nl, ..., 1)
    seed0, seed1 = _SEEDS[(m, n)]
    dm1, d = seed0(x), seed1(x)
    # the l = lmin term first; the recurrence starts at l = lmin + 1, whose
    # denominator is nonzero for every supported spin pair
    acc = torch.zeros(cls.shape[:-1] + x.shape, dtype=_F64, device=dev) \
        + w[0] * dm1
    for j in range(1, w.shape[0]):
        acc = acc + w[j] * d
        dm1, d = d, _step(m, n, dm1, d, float(lmin + j), x)
    return acc


@on_device_of_inputs
def wigner_d_rows(lmax, xs, mn=(0, 0)):
    """The table d^l_{mn}(x), shape (lmax+1, nx), l = 0..lmax, written row
    by row into one preallocated tensor; rows with l < max(|m|, |n|) are
    zero.  The building block of the MASTER coupling matrices
    (models/master.py)."""
    m, n = _spins(mn)
    lmin = max(abs(m), abs(n))
    lmax = int(lmax)
    x = torch.as_tensor(xs, dtype=_F64, device=call_device())
    out = torch.zeros((lmax + 1, x.shape[0]), dtype=_F64, device=x.device)
    if lmax < lmin:
        return out
    seed0, seed1 = _SEEDS[(m, n)]
    out[lmin] = seed0(x)
    if lmax > lmin:
        out[lmin + 1] = seed1(x)
    for l in range(lmin + 1, lmax):
        _step(m, n, out[l - 1], out[l], float(l), x, out=out[l + 1])
    return out


@on_device_of_inputs
def wigner_d_outer_sum(ells, wls, thetas_rad, mn1=(0, 0), mn2=None,
                       thetas2_rad=None):
    """sum_l w_l d^l_{mn1}(theta_i) d^l_{mn2}(theta'_j) -> (..., nt1, nt2):
    the real-space Gaussian-covariance kernel.  Both spin recurrences run
    side by side and the outer product is accumulated per l (the (l,
    theta) d-matrices are never stored).  wls: (..., nl) weights on
    consecutive integer ells."""
    if mn2 is None:
        mn2 = mn1
    m1, n1 = _spins(mn1)
    m2, n2 = _spins(mn2)
    ells = _consecutive(ells)
    lmin = max(abs(m1), abs(n1), abs(m2), abs(n2))
    dev = call_device()
    x1 = torch.cos(torch.as_tensor(thetas_rad, dtype=_F64, device=dev))
    x2 = x1 if thetas2_rad is None else torch.cos(
        torch.as_tensor(thetas2_rad, dtype=_F64, device=dev))
    wls = torch.as_tensor(wls, dtype=_F64, device=dev)
    w = _dense_weights(ells, wls, lmin)

    # each pair starts at its own lmin; the lower one is stepped up to the
    # shared lmin (at most 2 steps: the spin pairs differ by <= 2)
    def seeds(m, n, x):
        s0, s1 = _SEEDS[(m, n)]
        a0, a1 = s0(x), s1(x)
        for lm in range(max(abs(m), abs(n)), lmin):
            a0, a1 = a1, _step(m, n, a0, a1, float(lm + 1), x)
        return a0, a1

    a0, a1 = seeds(m1, n1, x1)
    b0, b1 = seeds(m2, n2, x2)
    # the l = lmin term pairs the seeds; then l = lmin + 1, ...
    acc = (w[0][..., None, None] * a0[:, None] * b0[None, :]
           + torch.zeros(w.shape[1:] + (x1.shape[0], x2.shape[0]),
                         dtype=_F64, device=dev))
    for j in range(1, w.shape[0]):
        l = float(lmin + j)
        acc = acc + w[j][..., None, None] * a1[:, None] * b1[None, :]
        a0, a1 = a1, _step(m1, n1, a0, a1, l, x1)
        b0, b1 = b1, _step(m2, n2, b0, b1, l, x2)
    return acc


@on_device_of_inputs
def xi_gaussian_cov(ells, cl_tot_1, cl_tot_2, cl_cross_a, cl_cross_b,
                    thetas_rad, kind1="plus", kind2="plus", fsky=1.0):
    """Gaussian covariance of two real-space two-point functions,

        Cov(xi_a(th_i), xi_b(th_j)) = sum_l (2l+1)/(16 pi^2 fsky)
            d^l_{a}(th_i) d^l_{b}(th_j)
            [C^tot_1(l) C^tot_2(l) + C^x_a(l) C^x_b(l)],

    kinds 'plus', 'minus', 'gammat', 'w'; noise already in the totals."""
    k1, k2 = _XI_MN[kind1], _XI_MN[kind2]
    dev = call_device()
    as_t = lambda v: torch.as_tensor(v, dtype=_F64, device=dev)
    ls = as_t(np.asarray(ells, dtype=np.float64))
    clsum = as_t(cl_tot_1) * as_t(cl_tot_2) + as_t(cl_cross_a) * as_t(cl_cross_b)
    wls = (2.0 * ls + 1.0) / (16.0 * math.pi**2 * fsky) * clsum
    return wigner_d_outer_sum(ells, wls, thetas_rad, mn1=k1, mn2=k2)


@on_device_of_inputs
def kappa_to_shear_cl_factor(ells):
    """C^{gamma gamma}_l / C^{kappa kappa}_l = (l+2)(l-1)/(l(l+1)), 0 at
    l = 0, 1 (those multipoles carry no shear)."""
    l = torch.as_tensor(ells, dtype=_F64, device=call_device())
    den = l * (l + 1.0)
    return torch.where(l >= 2, (l + 2.0) * (l - 1.0)
                       / torch.where(den > 0, den, 1.0), 0.0)


def _to_shear_cl(ells, cl, input_kind, dev):
    cl = torch.as_tensor(cl, dtype=_F64, device=dev)
    if input_kind == "convergence":
        return cl * kappa_to_shear_cl_factor(ells, device=dev)
    if input_kind == "shear":
        return cl
    raise ValueError(f"unknown input_kind {input_kind!r}")


@on_device_of_inputs
def xi_plus(ells, cl_e, thetas_rad, cl_b=None, input_kind="shear"):
    """xi_+(theta) from an E-mode (and optional B-mode) spectrum;
    input_kind='convergence' converts C^{kappa kappa} by the full-sky
    (l+2)(l-1)/(l(l+1))."""
    dev = call_device()
    cl = _to_shear_cl(ells, cl_e, input_kind, dev)
    if cl_b is not None:
        cl = cl + _to_shear_cl(ells, cl_b, input_kind, dev)
    return wigner_d_sum(ells, cl, thetas_rad, mn=(2, 2))


@on_device_of_inputs
def xi_minus(ells, cl_e, thetas_rad, cl_b=None, input_kind="shear"):
    """xi_-(theta); see :func:`xi_plus`."""
    dev = call_device()
    cl = _to_shear_cl(ells, cl_e, input_kind, dev)
    if cl_b is not None:
        cl = cl - _to_shear_cl(ells, cl_b, input_kind, dev)
    return wigner_d_sum(ells, cl, thetas_rad, mn=(2, -2))


@on_device_of_inputs
def gamma_t(ells, cl_cross, thetas_rad, input_kind="convergence"):
    """Mean tangential shear around the density tracer from C^{g kappa}
    (input_kind='convergence', converted by sqrt((l+2)(l-1)/(l(l+1))))
    or C^{g E} ('shear')."""
    dev = call_device()
    cl = torch.as_tensor(cl_cross, dtype=_F64, device=dev)
    if input_kind == "convergence":
        cl = cl * torch.sqrt(kappa_to_shear_cl_factor(ells, device=dev))
    elif input_kind != "shear":
        raise ValueError(f"unknown input_kind {input_kind!r}")
    return wigner_d_sum(ells, cl, thetas_rad, mn=(2, 0))
