"""Kernel launches per batched call, over every card of the cell."""


def read(trace):
    n = len(trace.kernels())
    return n / trace.n_calls if n else None
