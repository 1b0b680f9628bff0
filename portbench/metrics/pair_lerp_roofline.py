"""B4b (the float32-table resample of the electron profile transform,
``pair_lerp_kernel`` or ``pair_lerp_rows_kernel``)'s share of its roofline:
the least time its work can take (portbench/work/pair_lerp.py, counted on
each call's own rows, worked out by the configuration's reference) over
its device time, on the first two traced calls.  None where it never
ran."""

import numpy as np
import torch

from portbench.work import pair_lerp
from portbench.work.roofline import least_time_s

CALLS = 2


def read(trace):
    n = min(CALLS, trace.n_calls)
    t_us = sum(trace.kernel_us(k, call=i) for k in pair_lerp.KERNELS
               for i in range(n))
    if t_us <= 0:
        return None
    ctx = trace.context
    table_bytes = 4 if ctx["config"]["options"].get("fast") is True else 8
    least = 0.0
    for theta in trace.thetas[:n]:
        rows = [ctx["reference"].transform_inputs(ctx["row"](r),
                                                  ctx["config"])
                for r in theta]
        scales = torch.as_tensor(np.stack([r["scales"] for r in rows]),
                                 dtype=torch.float64, device=ctx["device"])
        ks = torch.as_tensor(rows[0]["ks"], dtype=torch.float64,
                             device=ctx["device"])
        least += least_time_s(*pair_lerp.work(rows[0]["nkt"], table_bytes,
                                              scales, ks, rows[0]["dkt"]))
    return 100.0 * least / (t_us * 1e-6)
