"""One run of one cell: set-up, the measured (or traced) window, then the
check of the window's outputs against the configuration's reference.

Everything a cell is made of is found by name: the configuration
``portbench/configs/<config>.json`` (with its reference
``portbench/reference/<reference>.py``), the traffic
``portbench/traffic/<traffic>.json`` and each metric's reader
``portbench/metrics/<metric>.py``.  End-to-end readers take the measured
window (``Window``), per-layer readers the traced one (``trace.Trace``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import pathlib
import re
import sys
import time

import numpy as np

from . import traffic as traffic_mod
from .trace import run_traced

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# calls of the traced run's second pass, which records the program's frames
STACK_CALLS = 2
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")


def load_bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def hand_kernels() -> tuple:
    """The names of the program's hand-written kernels (the __global__
    functions of hmvec_tpu_torch/csrc)."""
    names = set()
    for src in (ROOT / "hmvec_tpu_torch" / "csrc").glob("*.cu"):
        names.update(_GLOBAL.findall(src.read_text()))
    return tuple(sorted(names))


class Window:
    """The measured window: each call's latency, the cosmologies whose
    spectra reached the host, the window's length, the set-up time and
    the peak device memory."""

    def __init__(self, latencies_ms, cosmologies, window_s, setup_s,
                 peak_bytes):
        self.latencies_ms, self.cosmologies = latencies_ms, cosmologies
        self.window_s, self.setup_s = window_s, setup_s
        self.peak_bytes = peak_bytes


class Checker:
    """Keeps, from the seed, a uniform sample of the window's rows: in
    each quarter of the batch (a card's share on four cards) a reservoir of
    ``per_quarter`` rows, each call offering one row of each quarter."""

    def __init__(self, batch: int, per_quarter: int, rng):
        if batch % 4:
            raise ValueError("the batch must split into four quarters")
        self.q, self.k, self.rng = batch // 4, per_quarter, rng
        self.kept = [[] for _ in range(4)]
        self.offered = 0

    def on_call(self, theta, host):
        for quarter, kept in enumerate(self.kept):
            row = quarter * self.q + int(self.rng.integers(self.q))
            slot = (len(kept) if self.offered < self.k
                    else int(self.rng.integers(self.offered + 1)))
            if slot < self.k:
                item = (theta[row].copy(), row_of(host, row))
                if slot == len(kept):
                    kept.append(item)
                else:
                    kept[slot] = item
        self.offered += 1

    def rows(self):
        return [item for kept in self.kept for item in kept]


def row_of(host, row):
    """One row of a call's spectra on the host, as its own array: of an
    entry that returns several spectra (a tuple of (B, ...) arrays) their
    rows stacked, (leaves, ...), as the reference's ``spectra`` gives them."""
    if isinstance(host, tuple):
        return np.stack([leaf[row] for leaf in host])
    return np.array(host[row])


# the numbers compared, in the order compare() gives them, each with its
# limit under the same key in the configuration's "check"
CHECKED = ("max_rel_err", "low_k_max_rel_err")


def limits_of(cfg: dict) -> tuple:
    return tuple(float(cfg["check"][name]) for name in CHECKED)


def compare(rows, reference, cfg, to_params):
    """For each checked row, against the reference worked out again from its
    parameters: the widest relative gap, element by element, over the whole
    output, and over its low-k band (k below the check's ``low_k_below``,
    where the spectra are the float64 stages' and the profile's float32
    error hardly reaches them)."""
    low = reference.grids(cfg)[2] < float(cfg["check"]["low_k_below"])
    errs = []
    for theta, got in rows:
        want = reference.spectra(to_params(theta), cfg)
        with np.errstate(divide="ignore", invalid="ignore"):
            gap = np.abs(got.astype(np.float64) - want) / np.abs(want)
        errs.append(tuple(float(e) if np.isfinite(e) else math.inf
                          for e in (np.max(gap), np.max(gap[..., low]))))
    return errs


def run(bench: dict, cell_name: str, *, seed: int, seconds: float,
        trace: bool, devices, t_start: float, config=None, traffic=None,
        fault=None) -> dict:
    """Run one cell; returns the result line as a dict.  ``config`` /
    ``traffic`` replace the files the cell names and ``fault`` wraps the
    system under test (the tests drive a run with them)."""
    import torch

    from .system import build

    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    cfg = config or load_json("configs", cell["config"])
    spec = traffic or load_json("traffic", cell["traffic"])
    reference = load_module("reference", cfg["reference"])
    warm_rng, call_rng, check_rng = traffic_mod.streams(seed, 3)
    on_card = torch.device(devices[0]).type == "cuda"

    # set-up: the system, its kernels, the warm-up calls at the cell's shapes
    warm = traffic_mod.Traffic(spec, warm_rng)
    batched = build(cfg, warm.names, devices)
    if fault is not None:
        batched = fault(batched)
    out = batched(warm.next_batch())
    # the spectra reach the host in reused page-locked buffers, one for each
    # tensor the call returns, as a serving loop keeps them
    several = isinstance(out, tuple)
    host_bufs = [torch.empty(o.shape, dtype=o.dtype, pin_memory=on_card)
                 for o in (out if several else (out,))]
    host_views = tuple(b.numpy() for b in host_bufs)

    def to_host(result):
        for buf, leaf in zip(host_bufs, result if several else (result,)):
            buf.copy_(leaf)
        return host_views if several else host_views[0]

    to_host(out)
    for _ in range(int(spec["warmup_calls"]) - 1):
        to_host(batched(warm.next_batch()))
    if trace:
        run_traced(batched, warm, 1, devices, lambda *_: None, None, to_host)

    if on_card:
        for d in devices:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
    # what set-up made stays: no collection in the window walks it again
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    calls = traffic_mod.Traffic(spec, call_rng)
    checker = Checker(calls.batch, int(spec["check_rows_per_quarter"]),
                      check_rng)
    if trace:
        context = {"config": cfg, "reference": reference, "row": calls.row,
                   "device": devices[0], "hand_kernels": hand_kernels()}
        tr = run_traced(batched, calls, int(spec["trace_calls"]), devices,
                        checker.on_call, context, to_host)
        tr.adopt(run_traced(batched, calls, STACK_CALLS, devices,
                            checker.on_call, context, to_host, frames=True))
        n_calls = tr.n_calls + STACK_CALLS
    else:
        latencies = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            theta = calls.next_batch()
            t_call = time.perf_counter()
            host = to_host(batched(theta))
            latencies.append((time.perf_counter() - t_call) * 1e3)
            checker.on_call(theta, host)
        window_s = time.perf_counter() - t0
        n_calls = len(latencies)
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices),
               default=0) if on_card else 0

    metrics = {}
    kind = "per_layer" if trace else "end_to_end"
    source = tr if trace else Window(latencies, n_calls * calls.batch,
                                     window_s, setup_s, peak)
    for m in bench[kind]:
        if cell_name not in m.get("workloads", [cell_name]):
            continue
        value = load_module("metrics", m["name"]).read(source)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": (torch.cuda.get_device_name(devices[0]) if on_card
                       else "cpu"),
              "count": len(devices), "memory_peak_bytes": int(peak)}
    extra = {}
    if trace:
        device["busy_s"] = (sum(tr.busy_us(d) for d in tr.devices)
                            / len(tr.devices) * 1e-6) if on_card else 0.0
        device["window_s"] = tr.window_us * 1e-6
        extra["breakdown"] = tr.breakdown()

    # the check, once the window has closed and the program's state is freed
    del batched, out, host_bufs, host_views
    if trace:
        del tr
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rows = checker.rows()
    errs = compare(rows, reference, cfg, calls.row)
    limits = limits_of(cfg)
    n_failed = sum(1 for e in errs if not all(
        v <= lim for v, lim in zip(e, limits)))
    expected = 4 * min(checker.k, n_calls)
    checks = {name: {"value": max((e[i] for e in errs), default=math.inf),
                     "limit": lim}
              for i, (name, lim) in enumerate(zip(CHECKED, limits))}
    checks["rows_checked"] = {"value": len(rows), "limit": expected}
    checks["rows_failed"] = {"value": n_failed, "limit": 0}
    correct = bool(all(checks[name]["value"] <= checks[name]["limit"]
                       for name in CHECKED)
                   and len(rows) == expected and n_failed == 0)
    result = {"correct": correct, "attempted": n_calls * calls.batch,
              "failed": n_failed, "metrics": metrics, "device": device,
              **extra, "checks": checks}
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return result
