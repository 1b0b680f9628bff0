"""Operations of one NFW u(k) evaluation, counted from the arithmetic of the
hand kernels' shared math (``hmvec::nfw_u`` of the program's
``csrc/nfw_u.cuh``) as it stood when the benchmark was defined, and frozen
here: a later kernel is read against the same work whatever implements it.

A fused multiply-add counts 2, compares and selects 0.  Counts depend on
the data only through which Si/Ci domain each argument falls in.
"""

from __future__ import annotations

import torch

# operations counted for one call of the math library's log (an estimate of
# its range reduction and polynomial)
LOG_OPS = {"f64": 30, "f32": 15}
# the per-row constants: 1 + c twice, c / (1 + c), the difference, 1 / F,
# the (1 + c) scale, and a log, in float64
ROW_OPS_F64 = 6 + LOG_OPS["f64"]
# one sin/cos pair.  float64 tier: the quadrant (an FMA and a subtraction),
# two FMAs of the two-part pi/2, r^2, five FMAs for each polynomial, r^3 and
# the FMA of sin, two FMAs of cos.  float32 tier: the FMA, the subtraction
# and one FMA in float64, then r^2, two FMAs for each polynomial and three
# operations and two FMAs to finish, in float32
SINCOS_OPS = {"f64": {"f64": 3 + 4 + 1 + 20 + 3 + 4},
              "f32": {"f64": 5, "f32": 16}}
# the reciprocal: the hardware's seed, and in float64 two Newton steps
RCP_OPS = {"f64": 1 + 8, "f32": 1}
# series terms per Si/Ci domain (x <= 4, <= 10, <= 40) and asymptotic-tail
# terms, per precision
SERIES_TERMS = {"f64": (12, 17, 15), "f32": (16, 16, 16)}
TAIL_TERMS = {"f64": 13, "f32": 7}


def _sici_ops(x, prec):
    """Operations of one Si/Ci argument x: its reciprocal, then the body of
    its domain alone (the Chebyshev variable and two Horner series below
    x = 40, the asymptotic tail above)."""
    series = [2 * 2 * (n - 1) for n in SERIES_TERMS[prec]]
    n = torch.where(x <= 4.0, (4 if prec == "f32" else 3) + series[0],
                    3 + 3 + torch.where(x <= 10.0, series[1], series[2]))
    tail = 1 + 2 * 2 * (TAIL_TERMS[prec] - 1) + 2
    return RCP_OPS[prec] + torch.where(x > 40.0, tail, n)


def ops(ks, scales, cs, prec: str) -> dict:
    """Operations of u over the (row, k) grid by type ('f64', 'f32'): the
    phases x = k s and x2 = k s (1 + c) in float64, their sin/cos, two
    Si/Ci, the assembly (a log where x <= 4 < x2), and the row constants
    once a row.  ks (nk,), scales and cs (rows,)."""
    x = ks[None, :] * scales.reshape(-1)[:, None]
    x2 = x * (1.0 + cs.reshape(-1))[:, None]
    in01, in02 = x <= 4.0, x2 <= 4.0
    assembly = 3 + torch.where(
        in02, 5, torch.where(in01, 12 + LOG_OPS[prec], 14)) + 6
    body = int((_sici_ops(x, prec) + _sici_ops(x2, prec) + assembly)
               .sum(dtype=torch.int64).item())
    n_el = x.numel()
    out = {"f64": 2 * n_el + ROW_OPS_F64 * scales.numel()}
    out[prec] = out.get(prec, 0) + body
    for t, n in SINCOS_OPS[prec].items():
        out[t] += 2 * n * n_el
    return out
