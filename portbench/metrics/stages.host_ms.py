"""Host time per call inside the program's ``hmvec.stages`` spans (the
background through the profile, B1's launch among them), each stretch
once, summed over the cards' shares on a mesh."""

from portbench.lib import spans


def read(trace):
    ranges = spans.host_ranges(trace, lambda name: name == spans.STAGES)
    if not ranges:
        return None
    return sum(e - s for s, e in ranges) / trace.n_calls / 1e3
