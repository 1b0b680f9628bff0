"""Device time per call of the kernels whose innermost program span is
``hmvec.stages`` or one of its parts, the hand-written kernels left out:
the span-based twin of stages.device_ms."""

from portbench.lib import spans


def read(trace):
    return spans.kernel_ms_per_call(trace, spans.is_stages)
