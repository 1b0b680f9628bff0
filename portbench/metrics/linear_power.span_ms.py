"""Device time per call of the kernels whose innermost program span is
``hmvec.stages.linear_power``: the EH98 transfer and the closed-form
growth (``hyp2f1_growth``) on the output's k grid and on sigma^2's."""

from portbench.lib import spans


def read(trace):
    return spans.kernel_ms_per_call(
        trace, lambda name: name == spans.LINEAR_POWER)
