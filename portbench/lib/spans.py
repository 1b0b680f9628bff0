"""What the per-layer readers take from the program's own spans.

``hmvec_tpu_torch`` opens named ranges on its serving path while a
profiler records (``utils/profiling.span``): ``hmvec.call`` around a
batched call, ``hmvec.stages`` around the shared stages with
``hmvec.stages.linear_power`` and ``hmvec.stages.fill`` inside,
``hmvec.power`` around the mass integrals and, on a mesh,
``hmvec.shard.issue:<i>`` around the host's issue of slot i's share.  They
reach a ``trace.Trace`` as host ranges in ``cpu_ops`` (start, end, name),
beside the CUDA runtime calls the profiler records there, each kernel's
launch among them.  A kernel belongs to the innermost span open at its
launch (``span_kernels``).  A trace of a program without the spans has
none, and every reader here then returns None.
"""

from __future__ import annotations

import collections

from .trace import _COPY, _merge

SPAN = "hmvec."

CALL = "hmvec.call"
STAGES = "hmvec.stages"
LINEAR_POWER = "hmvec.stages.linear_power"
POWER = "hmvec.power"
SHARD = "hmvec.shard.issue:"
# the CUDA runtime calls that hold the host until the card has caught up
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
# the CUDA runtime and driver calls that each launch one kernel
LAUNCHES = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx",
                      "cudaLaunchCooperativeKernel"))


def is_stages(name) -> bool:
    """``hmvec.stages`` or one of its named parts."""
    return name is not None and (name == STAGES
                                 or name.startswith(STAGES + "."))


def host_ranges(trace, keep):
    """The merged host ranges of the program spans whose name ``keep``
    accepts: what the host spent inside them, each stretch once."""
    return _merge([op[0], op[1]] for op in trace.cpu_ops
                  if op[2].startswith(SPAN) and keep(op[2]))


def overlap_us(a, b) -> float:
    """The length of the intersection of two sorted, merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_kernels(trace):
    """(innermost program span or None, kernel name, card, device time in
    us) of every kernel the traced calls ran; None without spans, or
    where a card ran another number of kernels than the host launched for
    it.

    The launches are the runtime calls in ``cpu_ops``, in the host's
    order; the spans open at a launch are a stack, as the one host thread
    opens and closes them.  A launch inside slot i's
    ``hmvec.shard.issue:<i>`` is for the cell's i-th card, any other for
    its first (one card, or the gather on a mesh).  A card runs its
    kernels in the order they were launched, so its n-th kernel is its
    n-th launch.  Only the order is read on either clock: the profiler's
    mapping of the card's clock onto the host's can drift by microseconds
    over a window, which puts a kernel near its edge outside it, so
    nothing here is cut at the window (a traced window records nothing
    but its calls)."""
    ranges = sorted((op[0], op[1], op[2]) for op in trace.cpu_ops
                    if op[2].startswith(SPAN))
    if not ranges:
        return None
    launches = sorted(op[0] for op in trace.cpu_ops if op[2] in LAUNCHES)
    of_card = collections.defaultdict(list)
    stack, j = [], 0
    for t in launches:
        while j < len(ranges) and ranges[j][0] <= t:
            while stack and stack[-1][1] <= ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        slot = next((shard_index(r[2]) for r in reversed(stack)
                     if shard_index(r[2]) is not None), 0)
        of_card[trace.devices[slot]].append(stack[-1][2] if stack else None)
    kernels = collections.defaultdict(list)
    for name, card, s, e in sorted(trace.device_ops, key=lambda k: k[2]):
        if not _COPY.match(name):
            kernels[card].append((name, e - s))
    if set(kernels) - set(of_card) or any(
            len(kernels[c]) != len(of_card[c]) for c in of_card):
        return None
    return [(sp, name, card, us) for card in of_card
            for sp, (name, us) in zip(of_card[card], kernels[card])]


def kernel_ms_per_call(trace, keep):
    """Device time per call, in ms, of the kernels (neither copies nor the
    hand-written kernels) whose innermost span ``keep`` accepts; None where
    none is."""
    hand = trace.context["hand_kernels"]
    us = [dur for sp, name, _, dur in span_kernels(trace) or ()
          if sp is not None and keep(sp)
          and not any(h in name for h in hand)]
    if not us:
        return None
    return sum(us) / trace.n_calls / 1e3


def idle_under_pct(trace, host_of):
    """The share of the window, in %, in which a card runs nothing while
    the host is inside ``host_of(i)``'s ranges (i: the card's place in
    ``trace.devices``), the mean over the cards; None without a card or
    without such ranges."""
    if trace.devices[0] is None:
        return None
    shares, seen = [], False
    for i, dev in enumerate(trace.devices):
        host = host_of(i)
        seen = seen or bool(host)
        gaps = [list(g) for g in trace.idle_gaps(dev)]
        shares.append(overlap_us(gaps, host) / trace.window_us)
    if not seen:
        return None
    return 100.0 * sum(shares) / len(shares)


def shard_index(name):
    """The slot of a ``hmvec.shard.issue:<i>`` span, or None."""
    if name.startswith(SHARD) and name[len(SHARD):].isdigit():
        return int(name[len(SHARD):])
    return None
