"""Emulate the fast tier's float32 NFW arithmetic in numpy, on the CPU.

hmvec_tpu_torch/csrc/nfw_u.cuh's nfw_u<float> runs only on the card; this
repeats its arithmetic operation for operation in numpy float32 (which
rounds every operation, where the card fuses multiply-adds), so that a
change to the float32 design can be held to the fast tier's gates before
a chip run.  At the config-1 inputs (the golden file's first cosmology,
20 z x 200 m x 1001 k) it prints:

* the share of x = k r_s (1+z) and x2 = (1+c) x in each Si/Ci domain
  (x <= 4, <= 10, <= 40, above);
* the max abs error on u against nfw_uk_plain (gate 5e-6);
* the max relative error of S1 = sum_m a u^2 and S2 = sum_m b u summed
  in float64 from the float32 u (nfw_contract's gate 2e-5).

The Si/Ci series are evaluated by Horner on the power-series
coefficients that kernels/_build.py writes, rounded to float32.

    python tools/emulate_torch_nfw_fast.py
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys

import numpy as np
from numpy.polynomial.chebyshev import cheb2poly

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = np.float32
NCOEF, NASY = 16, 7
EDGES = (4.0, 10.0, 40.0)


def _tables():
    from hmvec_tpu_torch.ops import _sici_coeffs as sc

    cheb = [[np.asarray(getattr(sc, f"SICI_{ab}{d}")[:NCOEF], np.float64)
             for d in range(3)] for ab in "AB"]
    return cheb, sc.EULER_GAMMA


def sincos_phase(x):
    """nfw_u.cuh Prec<float>::sincos_phase: quadrant reduction in float64,
    Cephes polynomials in float32."""
    n = np.rint(x * 0.6366197723675814)
    r = (x - n * 1.5707963267948966).astype(F32)
    q = n.astype(np.int64)
    r2 = r * r
    ps = (F32(-1.9515295891e-4) * r2 + F32(8.3321608736e-3)) * r2 \
        + F32(-1.6666654611e-1)
    pc = (F32(2.443315711809948e-5) * r2 + F32(-1.388731625493765e-3)) * r2 \
        + F32(4.166664568298827e-2)
    sr = (ps * r2) * r + r
    cr = (pc * r2 + F32(-0.5)) * r2 + F32(1.0)
    sv = np.where(q & 1, cr, sr)
    cv = np.where(q & 1, sr, cr)
    return (np.where(q & 2, -sv, sv).astype(F32),
            np.where((q + 1) & 2, -cv, cv).astype(F32))


def _series_fn(cheb):
    coef = [[cheb2poly(c).astype(F32) for c in row] for row in cheb]

    def series(t, d):
        out = []
        for s in range(2):
            acc = np.full_like(t, coef[s][d][-1])
            for k in range(NCOEF - 2, -1, -1):
                acc = acc * t + coef[s][d][k]
            out.append(acc)
        return out
    return series


def sici_parts(x, v, series):
    """nfw_u.cuh sici_parts: (A, B) below 4, else (f, g)."""
    p = np.zeros_like(x)
    q = np.zeros_like(x)
    dom = np.searchsorted(np.asarray(EDGES, F32), x, side="left")
    m = dom == 0
    if m.any():
        h = x[m] * F32(0.25)
        p[m], q[m] = series(F32(2) * (h * h) - F32(1), 0)
    for d, lo, hi in ((1, 0.1, 0.25), (2, 0.025, 0.1)):
        m = dom == d
        if m.any():
            lo, hi = F32(lo), F32(hi)
            vv = v[m]
            cl = np.minimum(np.maximum(vv, lo), hi)
            a, b = series((F32(2) * cl - (lo + hi)) * F32(1.0 / (hi - lo)),
                          d)
            p[m], q[m] = a * vv, b * vv * vv
    m = dom == 3
    if m.any():
        vv = v[m]
        y = vv * vv
        fa = np.full_like(y, F32((-1.0) ** (NASY - 1)
                                 * math.factorial(2 * NASY - 2)))
        ga = np.full_like(y, F32((-1.0) ** (NASY - 1)
                                 * math.factorial(2 * NASY - 1)))
        for n in range(NASY - 2, -1, -1):
            fa = fa * y + F32((-1.0) ** n * math.factorial(2 * n))
            ga = ga * y + F32((-1.0) ** n * math.factorial(2 * n + 1))
        p[m], q[m] = fa * vv, ga * y
    return p, q


def nfw_u_fast(ks, scales, cs, series, gamma):
    """u on the (row, k) grid as nfw_u<float> computes it."""
    ln1pc = np.log(1.0 + cs)
    inv_mc = (1.0 / (ln1pc - cs / (1.0 + cs))).astype(F32)[:, None]
    ln1pc = np.broadcast_to(ln1pc.astype(F32)[:, None],
                            (scales.size, ks.size))
    x = ks[None, :] * scales[:, None]
    x2 = ks[None, :] * ((1.0 + cs) * scales)[:, None]
    sx, cx = sincos_phase(x)
    sx2, cx2 = sincos_phase(x2)
    xt = np.maximum(x.astype(F32), F32(1e-30))
    x2t = np.maximum(x2.astype(F32), F32(1e-30))
    v1, v2 = F32(1) / xt, F32(1) / x2t
    p1, q1 = sici_parts(xt, v1, series)
    p2, q2 = sici_parts(x2t, v2, series)
    in01, in02 = xt <= 4, x2t <= 4
    sin_cx = sx2 * cx - cx2 * sx
    ci2 = p2 * sx2 - q2 * cx2
    with np.errstate(invalid="ignore", divide="ignore"):
        ci1_series = F32(gamma) + np.log(xt) + q1
    dci = np.where(in02, ln1pc + (q2 - q1),
                   ci2 - np.where(in01, ci1_series, p1 * sx - q1 * cx))
    dsi = np.where(
        in02, x2t * p2 - xt * p1,
        np.where(in01,
                 (F32(1.5707963267948966) - p2 * cx2 - q2 * sx2) - xt * p1,
                 (p1 * cx + q1 * sx) - (p2 * cx2 + q2 * sx2)))
    return ((sx * dsi - sin_cx * v2 + cx * dci) * inv_mc).astype(F32)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from hmvec_tpu_torch import pipeline as pl
    from hmvec_tpu_torch.ops import nfw_kernels as nk

    torch.set_num_threads(4)
    g = np.load(ROOT / "hmvec_tpu_torch" / "data" / "pmm_config1_golden.npz")
    cosmo = dict(zip(g["param_names"].tolist(),
                     map(float, g["param_values"][0])))
    ks, scales, cs, a, b = (t.numpy() for t in pl.nfw_stage_inputs(
        g["zs"], g["ks"], g["ms"], cosmo, device="cpu"))
    s, c = scales.reshape(-1), cs.reshape(-1)
    x = ks[None, :] * s[:, None]
    x2 = x * (1.0 + c)[:, None]
    for name, v in (("x", x), ("x2", x2)):
        dom = np.searchsorted(np.asarray(EDGES), v, side="left")
        print(f"{name}: share per domain (<=4, <=10, <=40, >40) "
              f"{[float(np.mean(dom == d)) for d in range(4)]}")
    cheb, gamma = _tables()
    u = nfw_u_fast(ks, s, c, _series_fn(cheb), gamma)
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
