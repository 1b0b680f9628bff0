"""PyTorch port, the spans of the serving path (utils/profiling.span): a
batched Pmm call of the fast tier (its plain version on the CPU) and of
the fused tier under ``torch.profiler`` records ``hmvec.call``,
``hmvec.stages``, ``hmvec.stages.linear_power``, ``hmvec.stages.fill`` and
``hmvec.power``, nested as the readers in portbench/lib/spans.py expect;
a sharded batch on a mesh of two CPU slots one ``hmvec.shard.issue:<i>``
a slot.  With no profiler ``span`` is one shared empty context, and the
spectra are bit-equal with the profiler on and off.  Small grids: the
whole file takes a few seconds, most of it the profiler's own start and
its parsing of the events."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hmvec_tpu_torch import pipeline as tpl
from hmvec_tpu_torch.parallel import sharding as tsh
from hmvec_tpu_torch.utils import profiling as tprof

ZS = np.linspace(0.1, 3.0, 3)
MS = np.geomspace(2e10, 1e17, 24)
KS = np.geomspace(1e-4, 100, 64)
NAMES = ("omch2", "H0")
THETA = np.array([[0.11, 64.0], [0.13, 71.0]])
# the serving options of portbench's configurations, at a small sigma^2 grid
SERVING = {"static_params": {"sigma2_numks": 64}, "uk_subsample": (0.2, 4)}
TIERS = {"fast": {"fast": True}, "fused": {"fused_serving": True}}
CALL, STAGES, POWER = "hmvec.call", "hmvec.stages", "hmvec.power"
LINEAR, FILL = "hmvec.stages.linear_power", "hmvec.stages.fill"
# (span, its enclosing program spans, innermost first) -> times a call
NESTING = {
    "fast": {(CALL, ()): 1, (STAGES, (CALL,)): 1,
             (LINEAR, (STAGES, CALL)): 1, (FILL, (STAGES, CALL)): 1,
             (POWER, (CALL,)): 1},
    # the fused tier's mass weights, then B2, the fill of both sums and
    # the combine
    "fused": {(CALL, ()): 1, (STAGES, (CALL,)): 1,
              (LINEAR, (STAGES, CALL)): 1, (POWER, (CALL,)): 2,
              (FILL, (POWER, CALL)): 2},
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _spans(prof):
    """(name, enclosing program spans innermost first) of every program
    span the profiler recorded."""
    out = []
    for ev in prof.events():
        if ev.name.startswith("hmvec."):
            chain, node = [], ev.cpu_parent
            while node is not None:
                if node.name.startswith("hmvec."):
                    chain.append(node.name)
                node = node.cpu_parent
            out.append((ev.name, tuple(chain)))
    return out


def _profiled(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, prof


def _batched(tier):
    fn = tpl.make_pmm_fn(ZS, KS, MS, device="cpu", **SERVING, **TIERS[tier])
    return tpl.make_batched_fn(fn, NAMES, out_dtype=torch.float32)


def test_span_without_a_profiler_is_one_shared_empty_context():
    assert not torch.autograd._profiler_enabled()
    assert tprof.span("hmvec.call") is tprof.span("hmvec.power") \
        is tprof._NO_SPAN
    with tprof.span("hmvec.call") as entered:
        assert entered is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tprof.span("hmvec.call") is not tprof._NO_SPAN
        with tprof.span("hmvec.call"):
            torch.ones(4).sum()
    assert [ev.name for ev in prof.events()
            if ev.name.startswith("hmvec.")] == ["hmvec.call"]


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_a_batched_call_records_its_spans_nested(tier):
    """One call of each tier: every span of the table, as often and nested
    as it says, and the spectra bit-equal with the profiler off."""
    batched = _batched(tier)
    off = batched(THETA)
    on, prof = _profiled(batched, THETA)
    got = {}
    for key in _spans(prof):
        got[key] = got.get(key, 0) + 1
    assert got == NESTING[tier]
    assert on.dtype == torch.float32 and torch.equal(on, off)


def test_a_sharded_batch_opens_one_issue_span_a_slot():
    """Two CPU slots: one hmvec.shard.issue:<i> a slot inside the sharded
    call's hmvec.call, each around that slot's own batched call; the rows
    bit-equal with the profiler off."""
    fn = tpl.make_pmm_fn(ZS, KS, MS, device="cpu", fast=True, **SERVING)
    batched = tsh.make_sharded_batched_fn(
        fn, NAMES, tsh.make_mesh(devices=["cpu"] * 2))
    off = batched(THETA)
    on, prof = _profiled(batched, THETA)
    spans = _spans(prof)
    issue = sorted(name for name, chain in spans
                   if name.startswith("hmvec.shard.issue:"))
    assert issue == ["hmvec.shard.issue:0", "hmvec.shard.issue:1"]
    assert all(chain == (CALL,) for name, chain in spans
               if name.startswith("hmvec.shard.issue:"))
    inner = sorted(chain[0] for name, chain in spans
                   if name == CALL and chain)
    assert inner == issue
    assert sum(1 for name, chain in spans if name == STAGES) == 2
    assert torch.equal(on, off)
