"""The table of peaks and the least time a kernel's work can take.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
outside the tensor cores; they assume the full 700 W power limit, which
the result line reports beside every roofline share).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f64": 34e12, "f32": 67e12}


def least_time_s(nbytes: int, ops: dict) -> float:
    """The larger of the bytes over the memory rate and the operations of
    each type over that type's peak."""
    t_ops = max((n / PEAK_OPS_PER_S[t] for t, n in ops.items()), default=0.0)
    return max(nbytes / HBM_BYTES_PER_S, t_ops)
