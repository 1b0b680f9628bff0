"""F1 (catmull_fill_kernel)'s share of its roofline: the least time of the
fills a call makes (portbench/work/catmull_fill.py) over the kernel's
device time, on the first two traced calls.  A call fills where the
configuration thins u(k) (``uk_subsample``): the fast tier fills the
(B, nz, nm) u cube, float32 on the fast NFW tier, the fused tier its two
(B, nz) mass sums in float64, each card its share of the batch.  None
where the kernel never ran."""

import numpy as np

from portbench.work import catmull_fill
from portbench.work.roofline import least_time_s

CALLS = 2


def launches(cfg, reference, row, batch, cards):
    """(rows, nkq, nk, bytes of a y element) of each fill of one call of
    ``batch`` cosmologies, ``row`` the parameters of one of them."""
    zs, ms, ks = reference.grids(cfg)
    nkq = reference.kernel_inputs(row, cfg)["ks"].size
    if nkq == ks.size:
        return []
    opts = cfg["options"]
    per_card = [len(b) for b in np.array_split(np.arange(batch), cards)]
    if opts.get("fused_serving"):
        return [(b * zs.size, nkq, ks.size, 8) for b in per_card
                for _ in range(2)]
    y_bytes = 4 if opts.get("fast") is True else 8
    return [(b * zs.size * ms.size, nkq, ks.size, y_bytes) for b in per_card]


def read(trace):
    n = min(CALLS, trace.n_calls)
    t_us = sum(trace.kernel_us(catmull_fill.KERNEL, call=i) for i in range(n))
    if t_us <= 0:
        return None
    ctx = trace.context
    least = sum(
        least_time_s(*catmull_fill.work(*f))
        for theta in trace.thetas[:n]
        for f in launches(ctx["config"], ctx["reference"], ctx["row"](theta[0]),
                          len(theta), len(trace.devices)))
    return 100.0 * least / (t_us * 1e-6)
