"""CUDA runtime calls that hold the host until the card catches up
(cudaStreamSynchronize, cudaDeviceSynchronize, cudaEventSynchronize) per
call, counted inside the program's outermost ``hmvec.call`` spans: a
``.item()``, a ``float()`` of a tensor, a blocking copy, from Python or
from C++; the harness's copy of the spectra after the call is not
counted."""

from portbench.lib import spans


def read(trace):
    calls = spans.host_ranges(trace, lambda name: name == spans.CALL)
    if not calls:
        return None
    starts = sorted(op[0] for op in trace.cpu_ops
                    if op[2].startswith(spans.SYNCS))
    n = sum(1 for t in starts if any(s <= t < e for s, e in calls))
    return n / trace.n_calls
