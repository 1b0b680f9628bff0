"""Device time per call of the kernels whose innermost program span is
``hmvec.stages.fill``: the Catmull-Rom fill of u(k) (fast tier) or of the
two mass sums (fused tier) from the thinned k grid."""

from portbench.lib import spans


def read(trace):
    return spans.kernel_ms_per_call(trace, lambda name: name == spans.FILL)
