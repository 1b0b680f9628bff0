"""Emulate the NFW kernels' arithmetic in numpy, on the CPU.

hmvec_tpu_torch/csrc/nfw_u.cuh's nfw_u<T> runs only on the card; this
repeats its arithmetic operation for operation in numpy, so that a change
to either tier's design can be held to its gates before a chip run.

--tier fast (the default): nfw_u<float> in numpy float32 (which rounds
every operation, where the card fuses multiply-adds).  At the config-1
inputs (the golden file's first cosmology, 20 z x 200 m x 1001 k) it prints:

* the share of x = k r_s (1+z) and x2 = (1+c) x in each Si/Ci domain
  (x <= 4, <= 10, <= 40, above);
* the max abs error on u against nfw_uk_plain (gate 5e-6);
* the max relative error of S1 = sum_m a u^2 and S2 = sum_m b u summed
  in float64 from the float32 u (nfw_contract's gate 2e-5).

--tier exact: nfw_u<double> in numpy float64 -- the quadrant reduction
with pi/2 split in two constants (each fused multiply-add emulated by an
exact product, Dekker's two_prod), the float64 sin/cos polynomials on
[-pi/4, pi/4], and the reciprocal as a 20-bit seed refined by two Newton
steps.  It prints the domain shares, the share of elements and of warps
(32 neighbouring k of a row) in the branch that calls log (x <= 4 < x2),
and, for config 1 and for chip_smoke.py's adversarial cases, the max abs
error on u against nfw_uk_plain and against a u assembled from
scipy.special.sici (budget 1e-12), and of sin/cos alone against numpy's.

The Si/Ci series are evaluated by Horner on the power-series
coefficients that kernels/_build.py writes, rounded to the tier's type.

    python tools/emulate_torch_nfw_fast.py [--tier exact]
"""

from __future__ import annotations

import argparse
import importlib.util
import math
import pathlib
import sys
from typing import Callable, NamedTuple

import numpy as np
from numpy.polynomial.chebyshev import cheb2poly

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32, F64 = np.float32, np.float64
EDGES = (4.0, 10.0, 40.0)
EXACT_BUDGET = 1e-12

# nfw_u.cuh Prec<double>: pi/2 = PIO2_HI + PIO2_LO to ~107 bits, and the
# fdlibm minimax polynomials of sin and cos on [-pi/4, pi/4]
TWO_OVER_PI = 0.6366197723675814
PIO2_HI = 1.5707963267948966
PIO2_LO = 6.123233995736766e-17
SIN_POLY = (-1.66666666666666324348e-01, 8.33333333332248946124e-03,
            -1.98412698298579493134e-04, 2.75573137070700676789e-06,
            -2.50507602534068634195e-08, 1.58969099521155010221e-10)
COS_POLY = (4.16666666666666019037e-02, -1.38888888888741095749e-03,
            2.48015872894767294178e-05, -2.75573143513906633035e-07,
            2.08757232129817482790e-09, -1.13596475577881948265e-11)


def _two_prod(a, b):
    """(p, e) with p = fl(a b) and p + e = a b exactly (Dekker)."""
    p = a * b
    ta, tb = 134217729.0 * a, 134217729.0 * b
    ah, bh = ta - (ta - a), tb - (tb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma(a, b, c):
    """a b + c with one rounding where the sum cancels (the reduction) and
    within an ulp elsewhere: the exact product, then c, then the
    product's tail."""
    p, e = _two_prod(np.asarray(a, F64), np.asarray(b, F64))
    return (p + c) + e


def _by_quadrant(q, sr, cr):
    sv = np.where(q & 1, cr, sr)
    cv = np.where(q & 1, sr, cr)
    return np.where(q & 2, -sv, sv), np.where((q + 1) & 2, -cv, cv)


def sincos_phase_f32(x):
    """nfw_u.cuh Prec<float>::sincos_phase: quadrant reduction in float64,
    Cephes polynomials in float32."""
    n = np.rint(x * TWO_OVER_PI)
    r = (x - n * PIO2_HI).astype(F32)
    r2 = r * r
    ps = (F32(-1.9515295891e-4) * r2 + F32(8.3321608736e-3)) * r2 \
        + F32(-1.6666654611e-1)
    pc = (F32(2.443315711809948e-5) * r2 + F32(-1.388731625493765e-3)) * r2 \
        + F32(4.166664568298827e-2)
    sr = (ps * r2) * r + r
    cr = (pc * r2 + F32(-0.5)) * r2 + F32(1.0)
    s, c = _by_quadrant(n.astype(np.int64), sr, cr)
    return s.astype(F32), c.astype(F32)


def sincos_phase_f64(x):
    """nfw_u.cuh Prec<double>::sincos_phase: n = rint(x 2/pi),
    r = fma(-n, PIO2_LO, fma(-n, PIO2_HI, x)), then the polynomials in
    z = r^2, swapped and negated by quadrant."""
    n = np.rint(x * TWO_OVER_PI)
    r = fma(-n, PIO2_LO, fma(-n, PIO2_HI, x))
    z = r * r
    ps = np.full_like(z, SIN_POLY[-1])
    for c in SIN_POLY[-2::-1]:
        ps = ps * z + c
    pc = np.full_like(z, COS_POLY[-1])
    for c in COS_POLY[-2::-1]:
        pc = pc * z + c
    sr = (z * r) * ps + r
    cr = (pc * z - 0.5) * z + 1.0
    return _by_quadrant(n.astype(np.int64), sr, cr)


def rcp_newton(x):
    """nfw_u.cuh Prec<double>::rcp: the hardware's reciprocal seed (the
    operand's and the result's low 32 bits dropped: ~20 bits) and two
    Newton steps y += y (1 - x y), each residual by a fused multiply-add."""
    hi = np.uint64(0xFFFFFFFF00000000)
    xt = (np.asarray(x, F64).view(np.uint64) & hi).view(F64)
    y = ((1.0 / xt).view(np.uint64) & hi).view(F64)
    for _ in range(2):
        e = fma(-x, y, 1.0)
        y = y * e + y
    return y


class Tier(NamedTuple):
    dtype: type
    tag: str          # the key of kernels/_build.py's NCOEF and NASY
    tiny: float
    sincos: Callable
    rcp: Callable


TIERS = {
    "fast": Tier(F32, "F32", 1e-30, sincos_phase_f32, lambda x: F32(1) / x),
    "exact": Tier(F64, "F64", 1e-300, sincos_phase_f64, rcp_newton),
}


def _series_fn(tier, lens=None):
    """series(t, d) -> (A, B) of domain d, by Horner on the power-series
    coefficients of the table cut at the domain's length (kernels/_build.py
    NCOEF, or ``lens``), rounded to the tier's type."""
    from hmvec_tpu_torch.kernels._build import NCOEF
    from hmvec_tpu_torch.ops import _sici_coeffs as sc

    lens = lens or NCOEF[tier.tag]
    coef = [[cheb2poly(np.asarray(getattr(sc, f"SICI_{ab}{d}")[:lens[d]],
                                  F64)).astype(tier.dtype)
             for d in range(3)] for ab in "AB"]

    def series(t, d):
        out = []
        for s in range(2):
            acc = np.full_like(t, coef[s][d][-1])
            for c in coef[s][d][-2::-1]:
                acc = acc * t + c
            out.append(acc)
        return out
    return series


def sici_parts(x, v, series, tier):
    """nfw_u.cuh sici_parts: (A, B) below 4, else (f, g)."""
    from hmvec_tpu_torch.kernels._build import NASY

    F = tier.dtype
    p = np.zeros_like(x)
    q = np.zeros_like(x)
    dom = np.searchsorted(np.asarray(EDGES, F), x, side="left")
    m = dom == 0
    if m.any():
        h = x[m] * F(0.25)
        p[m], q[m] = series(F(2) * (h * h) - F(1), 0)
    for d, lo, hi in ((1, 0.1, 0.25), (2, 0.025, 0.1)):
        m = dom == d
        if m.any():
            lo, hi = F(lo), F(hi)
            vv = v[m]
            cl = np.minimum(np.maximum(vv, lo), hi)
            a, b = series((F(2) * cl - (lo + hi)) * (F(1) / (hi - lo)), d)
            p[m], q[m] = a * vv, b * vv * vv
    m = dom == 3
    if m.any():
        vv = v[m]
        y = vv * vv
        na = NASY[tier.tag]
        fa = np.full_like(y, F((-1.0) ** (na - 1) * math.factorial(2 * na - 2)))
        ga = np.full_like(y, F((-1.0) ** (na - 1) * math.factorial(2 * na - 1)))
        for n in range(na - 2, -1, -1):
            fa = fa * y + F((-1.0) ** n * math.factorial(2 * n))
            ga = ga * y + F((-1.0) ** n * math.factorial(2 * n + 1))
        p[m], q[m] = fa * vv, ga * y
    return p, q


def nfw_u(ks, scales, cs, tier, lens=None):
    """u on the (row, k) grid as nfw_u<T> computes it, in the tier's
    type; ``lens`` overrides the series terms per domain."""
    from hmvec_tpu_torch.ops._sici_coeffs import EULER_GAMMA

    F = tier.dtype
    series = _series_fn(tier, lens)
    ln1pc = np.log(1.0 + cs)
    inv_mc = (1.0 / (ln1pc - cs / (1.0 + cs))).astype(F)[:, None]
    ln1pc = np.broadcast_to(ln1pc.astype(F)[:, None], (scales.size, ks.size))
    x = ks[None, :] * scales[:, None]
    x2 = ks[None, :] * ((1.0 + cs) * scales)[:, None]
    sx, cx = tier.sincos(x)
    sx2, cx2 = tier.sincos(x2)
    xt = np.maximum(x.astype(F), F(tier.tiny))
    x2t = np.maximum(x2.astype(F), F(tier.tiny))
    v1, v2 = tier.rcp(xt), tier.rcp(x2t)
    p1, q1 = sici_parts(xt, v1, series, tier)
    p2, q2 = sici_parts(x2t, v2, series, tier)
    in01, in02 = xt <= 4, x2t <= 4
    sin_cx = sx2 * cx - cx2 * sx
    ci2 = p2 * sx2 - q2 * cx2
    with np.errstate(invalid="ignore", divide="ignore"):
        ci1_series = F(EULER_GAMMA) + np.log(xt) + q1
    dci = np.where(in02, ln1pc + (q2 - q1),
                   ci2 - np.where(in01, ci1_series, p1 * sx - q1 * cx))
    dsi = np.where(
        in02, x2t * p2 - xt * p1,
        np.where(in01,
                 (F(1.5707963267948966) - p2 * cx2 - q2 * sx2) - xt * p1,
                 (p1 * cx + q1 * sx) - (p2 * cx2 + q2 * sx2)))
    return ((sx * dsi - sin_cx * v2 + cx * dci) * inv_mc).astype(F)


def nfw_u_scipy(ks, scales, cs):
    """u assembled from scipy.special.sici in float64:
    [sin x (Si x2 - Si x) - sin(c x)/x2 + cos x (Ci x2 - Ci x)] / F(c)."""
    from scipy.special import sici

    x = ks[None, :] * scales[:, None]
    c = cs[:, None]
    x2 = (1.0 + c) * x
    si1, ci1 = sici(x)
    si2, ci2 = sici(x2)
    mc = np.log(1.0 + c) - c / (1.0 + c)
    return (np.sin(x) * (si2 - si1) - np.sin(c * x) / x2
            + np.cos(x) * (ci2 - ci1)) / mc


def log_branch_share(x, x2, warp=32):
    """(share of elements, share of warps with such an element) in the
    assembly's branch x <= 4 < x2, the only one that calls log."""
    mixed = (x <= 4.0) & (x2 > 4.0)
    pad = -mixed.shape[1] % warp
    warps = np.pad(mixed, ((0, 0), (0, pad))).reshape(mixed.shape[0], -1, warp)
    return float(mixed.mean()), float(warps.any(-1).mean())


def config1_inputs():
    """(ks, scales, cs, a, b) of config 1's first golden cosmology, as
    numpy arrays; scales, cs, a, b of shape (nz, nm)."""
    from hmvec_tpu_torch import pipeline as pl

    g = np.load(ROOT / "hmvec_tpu_torch" / "data" / "pmm_config1_golden.npz")
    cosmo = dict(zip(g["param_names"].tolist(),
                     map(float, g["param_values"][0])))
    return tuple(t.numpy() for t in pl.nfw_stage_inputs(
        g["zs"], g["ks"], g["ms"], cosmo, device="cpu"))


def adversarial_cases():
    """chip_smoke.py's adversarial (name, ks, scales, cs) rows as numpy."""
    spec = importlib.util.spec_from_file_location("chip_smoke_cases",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, *arrays in mod.adversarial_rows("cpu"):
        yield (name, *(t.numpy() for t in arrays))


def exact_errors(ks, s, c):
    """Max abs errors of the exact tier's emulation on one case: u against
    nfw_uk_plain and against the scipy assembly, and sin/cos of both
    phases against numpy's."""
    import torch

    from hmvec_tpu_torch.ops import nfw_kernels as nk

    u = nfw_u(ks, s, c, TIERS["exact"])
    plain = nk.nfw_uk_plain(*map(torch.as_tensor, (ks, s, c))).numpy()
    x = ks[None, :] * s[:, None]
    x2 = ks[None, :] * ((1.0 + c) * s)[:, None]
    trig = 0.0
    for ph in (x, x2):
        sn, cn = sincos_phase_f64(ph)
        trig = max(trig, float(np.abs(sn - np.sin(ph)).max()),
                   float(np.abs(cn - np.cos(ph)).max()))
    return {"vs_plain": float(np.abs(u - plain).max()),
            "vs_scipy": float(np.abs(u - nfw_u_scipy(ks, s, c)).max()),
            "sincos": trig, "max_phase": float(x2.max())}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tier", choices=sorted(TIERS), default="fast")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from hmvec_tpu_torch.ops import nfw_kernels as nk

    torch.set_num_threads(4)
    ks, scales, cs, a, b = config1_inputs()
    s, c = scales.reshape(-1), cs.reshape(-1)
    x = ks[None, :] * s[:, None]
    x2 = x * (1.0 + c)[:, None]
    for name, v in (("x", x), ("x2", x2)):
        dom = np.searchsorted(np.asarray(EDGES), v, side="left")
        print(f"{name}: share per domain (<=4, <=10, <=40, >40) "
              f"{[float(np.mean(dom == d)) for d in range(4)]}")
    if args.tier == "exact":
        el, warps = log_branch_share(x, x2)
        print(f"log branch (x <= 4 < x2): {el!r} of the elements, in "
              f"{warps!r} of the warps")
        worst = 0.0
        for name, k_, s_, c_ in [("config1", ks, s, c), *adversarial_cases()]:
            e = exact_errors(k_, s_, c_)
            worst = max(worst, e["vs_plain"], e["vs_scipy"])
            print(f"{name} {s_.size} x {k_.size}, phases up to "
                  f"{e['max_phase']:.4g}: max abs err on u "
                  f"{e['vs_plain']!r} vs nfw_uk_plain, {e['vs_scipy']!r} vs "
                  f"scipy sici (budget {EXACT_BUDGET}); on sin/cos "
                  f"{e['sincos']!r}")
        return 0 if worst <= EXACT_BUDGET else 1
    u = nfw_u(ks, s, c, TIERS["fast"])
    ref = nk.nfw_uk_plain(*map(torch.as_tensor, (ks, s, c))).numpy()
    print(f"max abs err on u {float(np.abs(u - ref).max())!r} "
          f"(gate 5e-6)")
    ud = u.astype(np.float64).reshape(*scales.shape, -1)
    rd = ref.reshape(*scales.shape, -1)
    for name, w, p in (("S1", a, 2), ("S2", b, 1)):
        got = np.einsum("zm,zmk->zk", w, ud ** p)
        want = np.einsum("zm,zmk->zk", w, rd ** p)
        print(f"{name} max rel err "
              f"{float(np.abs(got / want - 1.0).max())!r} (gate 2e-5)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
