"""Device time per call of the kernels whose innermost program span is
``hmvec.power``, the hand-written kernels left out: the 1-halo and 2-halo
mass integrals of models/power.py (fast tier; the span-based twin of
power.device_ms), the mass weights and the combine (fused tier)."""

from portbench.lib import spans


def read(trace):
    return spans.kernel_ms_per_call(trace, lambda name: name == spans.POWER)
