"""Special functions on float64 tensors (port of hmvec_tpu/ops/special.py).

* ``sici_with_trig`` / ``sici``: Si(x), Ci(x) from the same Chebyshev tables
  as the JAX package (``_sici_coeffs``, generated by
  tools/gen_special_coeffs.py): one dual Clenshaw recurrence of degree 24
  with a per-element coefficient select over three domains, plus the
  asymptotic tail above x = 40.
* ``hyp2f1_growth``: 2F1(5/6, 3/2; 11/6; -y) for the Heath growth integral,
  four split-domain Chebyshev fits in w = y/(1+y) (``_hyp_coeffs``), and
  ``hyp2f1_growth_and_slope``, the same with its derivative in y.
* ``j0``, ``j1`` and ``disk_window``: Bessel J0 from the JAX package's
  Chebyshev fit below x = 8 and modulus/phase form above, J1 = -dJ0/dx as
  the derivative of those fits, and the flat-sky disk window 2 J1(x)/x.
* ``Wkr``: the top-hat window with the small-kR Taylor switch.

Every function is differentiable through autograd (reverse and forward
mode).  Clamps sit before every log and division so that the gradient of a
``torch.where`` branch that is not taken stays finite.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from ..utils.weights import on_device_of_inputs, tensor_or_f64

from . import _hyp_coeffs as _hc
from . import _sici_coeffs as _sc

_F64 = torch.float64
_EULER_GAMMA = _sc.EULER_GAMMA

# 13-term asymptotic tails: f(x) ~ (1/x) sum (-1)^n (2n)!/x^{2n},
# g(x) ~ (1/x^2) sum (-1)^n (2n+1)!/x^{2n}
_N_ASY = 13
_F_COEF = [(-1.0) ** n * math.factorial(2 * n) for n in range(_N_ASY)]
_G_COEF = [(-1.0) ** n * math.factorial(2 * n + 1) for n in range(_N_ASY)]


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
    """(ncoef, ndomain) float64 coefficient table on ``device``; row k holds
    the k-th coefficient of every domain, so ``tab[k][dom]`` is the
    per-element select of the JAX evaluator's nested ``jnp.where``."""
    mod, parts = {
        "sici_a": (_sc, ("SICI_A0", "SICI_A1", "SICI_A2")),
        "sici_b": (_sc, ("SICI_B0", "SICI_B1", "SICI_B2")),
        "hyp": (_hc, ("HYP_C0", "HYP_C1", "HYP_C2", "HYP_C3")),
    }[name]
    arr = np.stack([getattr(mod, p) for p in parts], axis=1)
    return torch.as_tensor(arr, dtype=_F64, device=device)


def _horner(coef, y):
    acc = torch.zeros_like(y)
    for c in coef[::-1]:
        acc = acc * y + c
    return acc


def sici_with_trig(x, sinx, cosx):
    """Si(x), Ci(x) for x > 0 given precomputed sin(x), cos(x).

    The NFW profile already needs sin/cos of the same arguments, so it
    shares them (profiles.nfw_uk_x).  Mirrors hmvec_tpu.ops.special.
    sici_with_trig operation for operation, so the two agree to rounding.
    """
    shape = x.shape   # 1-d view: see hyp2f1_growth
    xs = torch.clamp(x.reshape(-1), min=1e-300)
    sinx, cosx = sinx.reshape(-1), cosx.reshape(-1)

    in0 = xs <= 4.0
    in1 = (xs > 4.0) & (xs <= 10.0)
    dom = torch.where(in0, 0, torch.where(in1, 1, 2))

    # domain-mapped Chebyshev variable t in [-1, 1]
    u = torch.clamp((xs / 4.0) ** 2, max=1.0)
    t0 = 2.0 * u - 1.0
    v = 1.0 / torch.clamp(xs, min=4.0)
    lo1, hi1 = 1.0 / 10.0, 1.0 / 4.0
    lo2, hi2 = 1.0 / 40.0, 1.0 / 10.0
    t1 = (2.0 * torch.clamp(v, lo1, hi1) - (lo1 + hi1)) / (hi1 - lo1)
    t2 = (2.0 * torch.clamp(v, lo2, hi2) - (lo2 + hi2)) / (hi2 - lo2)
    t = torch.where(in0, t0, torch.where(in1, t1, t2))

    # dual Clenshaw with coefficient select (A: Si/x or x f; B: Ci-reg or x^2 g)
    tab_a = _table("sici_a", xs.device)
    tab_b = _table("sici_b", xs.device)
    a0 = torch.zeros_like(t)
    a1 = torch.zeros_like(t)
    b0 = torch.zeros_like(t)
    b1 = torch.zeros_like(t)
    t2x = 2.0 * t
    for k in range(tab_a.shape[0] - 1, -1, -1):
        a0, a1 = t2x * a0 - a1 + tab_a[k][dom], a0
        b0, b1 = t2x * b0 - b1 + tab_b[k][dom], b0
    A = a0 - t * a1
    B = b0 - t * b1

    # small-x assembly
    si_small = xs * A
    ci_small = _EULER_GAMMA + torch.log(xs) + B

    # mid-x assembly: f = A/x, g = B/x^2
    f_mid = A * v
    g_mid = B * v * v

    # asymptotic tail
    xl = torch.clamp(xs, min=40.0)
    y = 1.0 / (xl * xl)
    f_asy = _horner(_F_COEF, y) / xl
    g_asy = _horner(_G_COEF, y) * y

    tail = xs > 40.0
    f = torch.where(tail, f_asy, f_mid)
    g = torch.where(tail, g_asy, g_mid)

    si_large = math.pi / 2.0 - f * cosx - g * sinx
    ci_large = f * sinx - g * cosx

    si = torch.where(in0, si_small, si_large)
    ci = torch.where(in0, ci_small, ci_large)
    return si.reshape(shape), ci.reshape(shape)


def sici(x):
    """Si(x), Ci(x) for x > 0 (elementwise, differentiable)."""
    xs = torch.clamp(x, min=1e-300)
    return sici_with_trig(xs, torch.sin(xs), torch.cos(xs))


def _hyp_domain(y):
    """(w, dom, lo, hi, t) of the Chebyshev fits at y, on a 1-d view:
    indexing the tables with a 0-d index tensor would read it back to the
    host (a device sync per coefficient)."""
    w = torch.clamp(y / (1.0 + y), 0.0, float(_hc.HYP_W_MAX))
    his = [float(h) for h in _hc.HYP_DOM_HI]
    los = [float(v) for v in _hc.HYP_DOM_LO]
    dom = ((w > his[0]).long() + (w > his[1]).long()
           + (w > his[2]).long())
    lo_t = torch.as_tensor(los, dtype=_F64, device=w.device)[dom]
    hi_t = torch.as_tensor(his, dtype=_F64, device=w.device)[dom]
    t = (2.0 * w - (lo_t + hi_t)) / (hi_t - lo_t)
    return w, dom, lo_t, hi_t, t


def hyp2f1_growth(y):
    """2F1(5/6, 3/2; 11/6; -y) for y >= 0 (Heath growth integral).

    One Clenshaw recurrence with a four-way coefficient select over the
    w = y/(1+y) domains of tools/gen_hyp_coeffs.py; w clamps at
    HYP_W_MAX beyond y ~ 32 (omm < ~0.03 at a = 1)."""
    shape = y.shape
    _, dom, _, _, t = _hyp_domain(y.reshape(-1))
    tab = _table("hyp", t.device)
    b0 = torch.zeros_like(t)
    b1 = torch.zeros_like(t)
    t2x = 2.0 * t
    for k in range(tab.shape[0] - 1, -1, -1):
        b0, b1 = t2x * b0 - b1 + tab[k][dom], b0
    return (b0 - t * b1).reshape(shape)


def hyp2f1_growth_and_slope(y):
    """(F, dF/dy) of ``hyp2f1_growth``: the derivative of the same
    Chebyshev fit, carried through its Clenshaw recurrence beside the
    value (the derivative that autodiff of ``hyp2f1_growth`` gives, as a
    closed form that nests in any autodiff mode and in vmap).  Zero where
    w is clamped."""
    shape = y.shape
    y = y.reshape(-1)
    w, dom, lo_t, hi_t, t = _hyp_domain(y)
    tab = _table("hyp", t.device)
    b0 = torch.zeros_like(t)
    b1 = torch.zeros_like(t)
    d0 = torch.zeros_like(t)
    d1 = torch.zeros_like(t)
    t2x = 2.0 * t
    for k in range(tab.shape[0] - 1, -1, -1):
        b0, b1, d0, d1 = (t2x * b0 - b1 + tab[k][dom], b0,
                          2.0 * b0 + t2x * d0 - d1, d0)
    f = b0 - t * b1
    df_dt = d0 - b1 - t * d1
    dw_dy = torch.where(w < float(_hc.HYP_W_MAX), 1.0 / (1.0 + y) ** 2, 0.0)
    return f.reshape(shape), (df_dt * 2.0 / (hi_t - lo_t) * dw_dy).reshape(
        shape)


def _clenshaw(coef, t):
    """A Chebyshev series (numpy coefficients) at t in [-1, 1]."""
    b0 = torch.zeros_like(t)
    b1 = torch.zeros_like(t)
    for c in coef[::-1]:
        b0, b1 = 2.0 * t * b0 - b1 + float(c), b0
    return b0 - t * b1


def j0(x):
    """Bessel J0(x) for x >= 0 (|J0| error ~4e-13): the Chebyshev fit in
    (x/8)^2 for x <= 8 and the modulus/phase form beyond.  The clamps are
    ``torch.where`` selects, so the branch taken gets the whole gradient
    at the tie x = 8 (``j1`` is the derivative of this function)."""
    x = torch.abs(torch.as_tensor(x, dtype=_F64))
    inside = x <= 8.0
    u = (torch.where(inside, x, 8.0) / 8.0) ** 2
    small = _clenshaw(_sc.J0_SMALL, 2.0 * u - 1.0)
    xl = torch.where(inside, 8.0, x)
    t = 2.0 * (8.0 / xl) - 1.0
    P = _clenshaw(_sc.J0_P, t)
    Q = _clenshaw(_sc.J0_Q, t)
    ph = xl - math.pi / 4.0
    large = torch.sqrt(2.0 / (math.pi * xl)) * (P * torch.cos(ph)
                                                + Q * torch.sin(ph))
    return torch.where(inside, small, large)


def _clenshaw_and_slope(coef, t):
    """(f, df/dt) of a Chebyshev series at t: the derivative carried
    through the Clenshaw recurrence beside the value."""
    b0, b1 = torch.zeros_like(t), torch.zeros_like(t)
    d0, d1 = torch.zeros_like(t), torch.zeros_like(t)
    for c in coef[::-1]:
        b0, b1, d0, d1 = (2.0 * t * b0 - b1 + float(c), b0,
                          2.0 * b0 + 2.0 * t * d0 - d1, d0)
    return b0 - t * b1, d0 - b1 - t * d1


def j1(x):
    """Bessel J1(x) = -dJ0/dx: the derivative of ``j0``'s own fits in
    closed form (the derivative that autodiff of j0 gives, which is how
    the JAX package takes it), with the same branch at x = 8."""
    x = torch.as_tensor(x, dtype=_F64)
    ax = torch.abs(x)
    inside = ax <= 8.0
    xs = torch.where(inside, ax, 8.0)
    _, dsmall = _clenshaw_and_slope(_sc.J0_SMALL, 2.0 * (xs / 8.0) ** 2 - 1.0)
    small = dsmall * xs / 16.0            # dt/dx = 4 x / 64
    xl = torch.where(inside, 8.0, ax)
    t = 2.0 * (8.0 / xl) - 1.0
    P, dP = _clenshaw_and_slope(_sc.J0_P, t)
    Q, dQ = _clenshaw_and_slope(_sc.J0_Q, t)
    ph = xl - math.pi / 4.0
    c, s = torch.cos(ph), torch.sin(ph)
    dt = -16.0 / xl**2
    large = torch.sqrt(2.0 / (math.pi * xl)) * (
        -(P * c + Q * s) / (2.0 * xl) + dt * (dP * c + dQ * s)
        - P * s + Q * c)
    return -torch.sign(x) * torch.where(inside, small, large)


def disk_window(x, taylor_switch=1e-3):
    """Normalized flat-sky disk window W(x) = 2 J1(x)/x, W(0) = 1."""
    x = torch.as_tensor(x, dtype=_F64)
    small = torch.abs(x) < taylor_switch
    xs = torch.where(small, 1.0, x)
    return torch.where(small, 1.0 - x**2 / 8.0, 2.0 * j1(xs) / xs)


def Wkr_taylor(kR):
    xx = kR * kR
    return 1.0 - 0.1 * xx + 0.00357142857143 * xx * xx


@on_device_of_inputs
def Wkr(k, R, taylor_switch=0.01):
    """Fourier top-hat window W(kR) with small-argument Taylor switch."""
    kR = tensor_or_f64(k) * tensor_or_f64(R)
    small = kR < taylor_switch
    kRs = torch.where(small, torch.ones_like(kR), kR)  # no 0/0 in dead branch
    full = 3.0 * (torch.sin(kRs) - kRs * torch.cos(kRs)) / kRs**3
    return torch.where(small, Wkr_taylor(kR), full)
