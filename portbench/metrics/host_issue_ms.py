"""Host clock from a call's entry until it returns, before anything waits
for the device: the median over the traced calls."""

import statistics


def read(trace):
    return statistics.median(trace.host_issue_ms)
