"""What the kernels' roofline readers share."""

import numpy as np
import torch

from portbench.work.roofline import least_time_s

CALLS = 2


def share(trace, kernel, work):
    """100 x (least time of the kernel's work) / (its device time), summed
    over the first CALLS traced calls; None where the kernel never ran.
    ``work(ks, scales, cs)`` takes one call's inputs, the cosmologies'
    (nz, nm) rows stacked along the first axis."""
    n = min(CALLS, trace.n_calls)
    t_us = sum(trace.kernel_us(kernel, call=i) for i in range(n))
    if t_us <= 0:
        return None
    ctx = trace.context

    def on(a):
        return torch.as_tensor(a, dtype=torch.float64, device=ctx["device"])

    least = 0.0
    for theta in trace.thetas[:n]:
        rows = [ctx["reference"].kernel_inputs(ctx["row"](r), ctx["config"])
                for r in theta]
        ks = on(rows[0]["ks"])
        scales = on(np.concatenate([r["scales"] for r in rows]))
        cs = on(np.concatenate([r["cs"] for r in rows]))
        least += least_time_s(*work(ks, scales, cs))
    return 100.0 * least / (t_us * 1e-6)
