"""The share of the traced window in which a card runs nothing while the
host is inside a program span ``hmvec.stages`` or one of its parts: the
idle time the stages' issue leaves, the mean over the cell's cards."""

from portbench.lib import spans


def read(trace):
    host = spans.host_ranges(trace, spans.is_stages)
    return spans.idle_under_pct(trace, lambda i: host)
