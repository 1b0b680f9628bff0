"""Profiling and tracing hooks (port of hmvec_tpu/utils/profiling.py).

A synchronized timer (a CUDA call returns before the card finishes, so a
host clock measures the work only up to a ``torch.cuda.synchronize()`` or
a copy to the host), a ``torch.profiler`` trace context, the
counterpart of the JAX package's ``xla_trace``, and the named spans of the
serving path that such a trace records.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def fetch_sync(tree):
    """Synchronize the cards and copy every tensor leaf of a nested
    list / tuple / dict to the host: the same structure with numpy arrays
    in place of tensors."""
    if any(isinstance(x, torch.Tensor) and x.is_cuda for x in _leaves(tree)):
        torch.cuda.synchronize()
    if isinstance(tree, dict):
        return {k: fetch_sync(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [fetch_sync(v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


@contextlib.contextmanager
def timer(label: str = "", results: dict | None = None):
    """Wall-clock a block on the host; the block must end with a
    fetch_sync (or a synchronize) for the time to cover the card's work."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = dt
    else:
        print(f"[hmvec_tpu_torch timer] {label}: {dt*1e3:.2f} ms")


def time_fn(fn, *args, iters: int = 10, warmup: int = 2):
    """Median fetch-synchronized latency of fn(*args) in seconds."""
    for _ in range(warmup):
        fetch_sync(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fetch_sync(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


@contextlib.contextmanager
def torch_trace(logdir: str):
    """A ``torch.profiler`` trace of the block (the CPU, and the card when
    there is one), written as a Chrome trace under ``logdir``; yields the
    profiler, whose ``key_averages()`` sums the time by operation."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


# what span() returns while no profiler records: one shared, empty context
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named range of the program (``hmvec.call``, ``hmvec.stages``, ...)
    for a profiler to record: ``record_function(name)`` while a profiler
    records, so the range shares the clock of the card's activity in the
    same trace; otherwise one shared empty context, at the cost of one
    check.  The ranges nest; a reader assigns each kernel to the innermost
    ``hmvec.`` range open when it was launched."""
    if torch.autograd._profiler_enabled():
        return torch.autograd.profiler.record_function(name)
    return _NO_SPAN
