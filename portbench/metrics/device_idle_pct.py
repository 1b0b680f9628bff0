"""The share of the traced window in which no operation ran on a card,
averaged over the cell's cards."""


def read(trace):
    if trace.devices[0] is None:
        return None
    busy = sum(trace.busy_us(d) for d in trace.devices) / len(trace.devices)
    return 100.0 * (1.0 - busy / trace.window_us)
