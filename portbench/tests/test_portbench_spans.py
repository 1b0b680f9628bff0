"""The readers of the program's spans (portbench/lib/spans.py and the
metrics that use it), each on a hand-built ``trace.Trace`` with a known
answer: the spans reach the trace as nested host ranges, the
innermost-span attribution of kernels by their launches (a fill nested in
the stages and in the mass integrals, a card's share on a mesh), idle time
under a span on two cards, syncs inside and outside ``hmvec.call``, the
wait for the other cards' issue; the seven readers that were there before
return the same with and without the spans in the trace; ``adopt`` leaves
the attribution as it was; and every new reader returns None on a trace of
a program without spans.
"""

import numpy as np
import pytest

from portbench.lib import harness, spans
from portbench.lib.trace import Trace, run_traced
from hmvec_tpu_torch.utils.profiling import span

NEW = ("call.host_syncs", "stages.host_ms", "stages.span_ms",
       "linear_power.span_ms", "power.span_ms",
       "stages.idle_pct", "shard.wait_other_pct")
OLD = ("device_idle_pct", "launches_per_call", "host_issue_ms",
       "stages.device_ms", "power.device_ms", "nfw_uk_roofline",
       "nfw_contract_roofline")
HAND = ("nfw_uk_kernel", "nfw_contract_kernel")


def read(name, trace):
    return harness.load_module("metrics", name).read(trace)


class _Reference:
    """kernel_inputs of a stand-in reference: a 3 x 4 (z, m) grid."""

    @staticmethod
    def kernel_inputs(row, cfg):
        return {"ks": np.geomspace(1e-3, 10.0, 16),
                "scales": np.full((3, 4), 0.05 * row["s"]),
                "cs": np.full((3, 4), 5.0)}


def _trace(cpu_ops=(), device_ops=(), devices=(0,), n_calls=2,
           window=(0.0, 100.0), launched=()):
    step = (window[1] - window[0]) / n_calls
    calls = [(window[0] + i * step, window[0] + (i + 1) * step)
             for i in range(n_calls)]
    context = {"hand_kernels": HAND, "config": {}, "reference": _Reference,
               "row": lambda r: {"s": float(r[0])}, "device": "cpu"}
    return Trace(window, calls, list(devices), list(device_ops),
                 list(launched), [list(op) for op in cpu_ops],
                 [10.0] * n_calls, [np.ones((2, 1))] * n_calls, context)


# ---- the spans in a profiled window ----------------------------------------

class _Traffic:
    @staticmethod
    def next_batch():
        return np.ones((2, 1))


def _served(theta):
    """A stand-in batched call that opens the program's spans as the
    serving path does."""
    with span("hmvec.call"):
        with span("hmvec.stages"):
            with span("hmvec.stages.fill"):
                pass
        with span("hmvec.power"):
            pass
    return theta


def test_the_spans_reach_the_trace_as_nested_host_ranges():
    """A profiled window on the CPU: each call's spans are in ``cpu_ops``,
    each inside its parent, all inside the call."""
    import torch

    tr = run_traced(lambda t: _served(torch.as_tensor(t)), _Traffic, 2,
                    ["cpu"], lambda *_: None, {}, lambda out: out.numpy())
    got = sorted((op[0], op[1], op[2]) for op in tr.cpu_ops
                 if op[2].startswith(spans.SPAN))
    assert [g[2] for g in got] == 2 * ["hmvec.call", "hmvec.stages",
                                       "hmvec.stages.fill", "hmvec.power"]
    for i in (0, 4):
        call, stages, fill, power = got[i:i + 4]
        assert call[0] <= stages[0] <= fill[0] <= fill[1] <= stages[1]
        assert stages[1] <= power[0] <= power[1] <= call[1]
    assert spans.host_ranges(tr, lambda name: name == spans.CALL)


# ---- innermost-span attribution --------------------------------------------

SPANS = [(1.0, 45.0, "hmvec.call", None),
         (2.0, 30.0, "hmvec.stages", None),
         (3.0, 8.0, "hmvec.stages.linear_power", None),
         (20.0, 25.0, "hmvec.stages.fill", None),
         (31.0, 44.0, "hmvec.power", None),
         (35.0, 38.0, "hmvec.stages.fill", None)]
# (launch time, innermost span, kernel, device time): one call's launches
LAUNCHED = [(1.5, "hmvec.call", "elementwise_kernel", 10.0),
            (2.5, "hmvec.stages", "elementwise_kernel", 1000.0),
            (4.0, "hmvec.stages.linear_power", "elementwise_kernel", 200.0),
            (10.0, "hmvec.stages", "void nfw_uk_kernel<float>", 50.0),
            (21.0, "hmvec.stages.fill", "index_elementwise_kernel", 500.0),
            (32.0, "hmvec.power", "reduce_kernel", 300.0),
            (36.0, "hmvec.stages.fill", "index_elementwise_kernel", 60.0),
            (40.0, "hmvec.power", "nfw_contract_kernel", 90.0),
            (46.0, None, "elementwise_kernel", 5.0)]


def _launches(launched, card=0, lag=0.5):
    """The launches as the runtime calls in ``cpu_ops``, and their kernels
    as ``device_ops``, each starting ``lag`` after its launch (and running
    on past the others: only its start orders it); one copy with no launch
    beside them."""
    cpu = [(t, t + 0.2, "cudaLaunchKernel", None) for t, *_ in launched]
    dev = [(name, card, t + lag, t + lag + us)
           for t, _, name, us in launched]
    dev.append(("Memcpy HtoD (Pageable -> Device)", card, 0.1, 0.9))
    return cpu, dev


def test_each_kernel_belongs_to_the_innermost_span_at_its_launch():
    cpu, dev = _launches(LAUNCHED)
    got = spans.span_kernels(_trace(cpu_ops=SPANS + cpu, device_ops=dev))
    assert got == [(sp, name, 0, pytest.approx(us))
                   for _, sp, name, us in LAUNCHED]


@pytest.mark.parametrize("name, want_ms", [
    ("stages.span_ms", (1000 + 200 + 500 + 60) / 2 / 1e3),
    ("linear_power.span_ms", 200 / 2 / 1e3),
    ("power.span_ms", 300 / 2 / 1e3),
])
def test_kernel_time_by_innermost_span(name, want_ms):
    """Two calls; the fill inside the mass integrals counts in the stages;
    the hand kernels, the copy and kernels of other spans count in none."""
    cpu, dev = _launches(LAUNCHED)
    assert read(name, _trace(cpu_ops=SPANS + cpu, device_ops=dev)) == \
        pytest.approx(want_ms, rel=1e-9)


def test_a_mesh_gives_each_card_its_slots_launches():
    """Slot 0 issues [0, 20], slot 1 [20, 40] (each a call with its
    stages), then the gather on the first card; the cards run late and
    overlap, so only each card's own order tells its kernels apart."""
    cpu = [(0.0, 50.0, "hmvec.call", None),
           (0.0, 20.0, "hmvec.shard.issue:0", None),
           (1.0, 19.0, "hmvec.call", None),
           (2.0, 10.0, "hmvec.stages", None),
           (20.0, 40.0, "hmvec.shard.issue:1", None),
           (21.0, 39.0, "hmvec.call", None),
           (22.0, 30.0, "hmvec.stages", None),
           (31.0, 38.0, "hmvec.power", None)]
    cpu += [(t, t + 0.1, "cudaLaunchKernel", None)
            for t in (3.0, 12.0, 23.0, 32.0, 45.0)]
    dev = [("a", 3, 30.0, 31.0), ("b", 3, 60.0, 61.0),
           ("c", 7, 25.0, 26.0), ("d", 7, 50.0, 51.0),
           ("cat", 3, 70.0, 71.0)]
    got = sorted(spans.span_kernels(
        _trace(cpu_ops=cpu, device_ops=dev, devices=(3, 7))),
        key=lambda k: k[1])
    assert got == [("hmvec.stages", "a", 3, 1.0), ("hmvec.call", "b", 3, 1.0),
                   ("hmvec.stages", "c", 7, 1.0),
                   ("hmvec.call", "cat", 3, 1.0),
                   ("hmvec.power", "d", 7, 1.0)]


def test_the_order_and_not_the_window_matches_kernels_to_launches():
    """The card's clock drifts against the host's over the window: the
    last kernels read as starting after its end, one as starting before
    its launch; each still belongs to the span of its launch."""
    cpu, dev = _launches(LAUNCHED)
    dev = [(n, c, s + 60.0, e + 60.0) if s > 30.0 else (n, c, s - 1.0, e)
           for n, c, s, e in dev]
    tr = _trace(cpu_ops=SPANS + cpu, device_ops=dev, window=(0.0, 80.0))
    assert [k[:3] for k in spans.span_kernels(tr)] == \
        [(sp, name, 0) for _, sp, name, _ in LAUNCHED]
    assert read("power.span_ms", tr) == pytest.approx(300 / 2 / 1e3)


def test_kernels_that_do_not_match_their_launches_read_nothing():
    """A card with a kernel the host never launched: no attribution."""
    cpu, dev = _launches(LAUNCHED)
    dev.append(("elementwise_kernel", 0, 47.0, 48.0))
    tr = _trace(cpu_ops=SPANS + cpu, device_ops=dev)
    assert spans.span_kernels(tr) is None
    assert read("stages.span_ms", tr) is None


# ---- host time and idle time under spans -----------------------------------

CPU_OPS = [
    (0.0, 48.0, "hmvec.call", None),
    (10.0, 60.0, "hmvec.stages", None),
    (20.0, 30.0, "hmvec.stages.fill", None),
    (12.0, 18.0, "aten::mul", "models/transfer.py(52): transfer_eh98"),
    (70.0, 90.0, "hmvec.stages", None),
]


def test_stages_host_ms_counts_each_stretch_once():
    """[10, 60] and [70, 90] with a nested fill: 70 us over two calls."""
    assert read("stages.host_ms", _trace(cpu_ops=CPU_OPS)) == \
        pytest.approx(70.0 / 2 / 1e3)


def test_idle_under_the_stages_on_two_cards():
    """Card 0 busy [0, 40], card 1 [50, 100]; the host in the stages [10,
    60] and [70, 90] (the fill inside): card 0 idles under them 20 + 20
    us, card 1 40 us, of a 100 us window: the mean 40%."""
    device_ops = [("k", 0, 0.0, 40.0), ("k", 1, 50.0, 100.0)]
    tr = _trace(cpu_ops=CPU_OPS, device_ops=device_ops, devices=(0, 1))
    assert read("stages.idle_pct", tr) == pytest.approx(40.0)


def test_a_run_without_a_card_reads_no_idle_share():
    tr = _trace(cpu_ops=CPU_OPS, devices=(None,))
    assert read("stages.idle_pct", tr) is None


# ---- host syncs ------------------------------------------------------------

def test_syncs_inside_the_outermost_call_only():
    """The sharded call [0, 50] holds a slot's call [10, 20]: four syncs
    inside (the one in the nested call counted once), a launch that is no
    sync, and the harness's copy after the call, not counted; two calls."""
    cpu_ops = [(0.0, 50.0, "hmvec.call", None),
               (10.0, 20.0, "hmvec.call", None),
               (5.0, 6.0, "cudaStreamSynchronize", None),
               (15.0, 16.0, "cudaStreamSynchronize", None),
               (30.0, 31.0, "cudaLaunchKernel", None),
               (44.0, 45.0, "cudaDeviceSynchronize", None),
               (47.0, 48.0, "cudaEventSynchronize", None),
               (60.0, 61.0, "cudaStreamSynchronize", None)]
    assert read("call.host_syncs", _trace(cpu_ops=cpu_ops)) == 2.0


# ---- the wait for the other cards' issue -----------------------------------

def test_shard_wait_for_the_other_slots_issue():
    """Slot 0 issues [0, 30], slot 1 [30, 60]; card 0 busy [5, 50], card 1
    [35, 90].  Card 0 idles in slot 1's issue [50, 60]: 10 us; card 1 in
    slot 0's [0, 30]: 30 us (its own issue [30, 35] not counted); of a
    100 us window: the mean 20%."""
    cpu_ops = [(0.0, 30.0, "hmvec.shard.issue:0", None),
               (30.0, 60.0, "hmvec.shard.issue:1", None)]
    device_ops = [("k", 0, 5.0, 50.0), ("k", 1, 35.0, 90.0)]
    tr = _trace(cpu_ops=cpu_ops, device_ops=device_ops, devices=(0, 1))
    assert read("shard.wait_other_pct", tr) == pytest.approx(20.0)


# ---- what was there before -------------------------------------------------

def _both():
    """One trace without the program's spans and the same with them."""
    device_ops = [("void nfw_uk_kernel<float>", 0, 1.0, 3.0),
                  ("nfw_contract_kernel", 0, 4.0, 6.0),
                  ("elementwise_kernel", 0, 10.0, 30.0),
                  ("Memcpy DtoH (Device -> Pinned)", 0, 40.0, 45.0),
                  ("void nfw_uk_kernel<float>", 0, 51.0, 53.0),
                  ("elementwise_kernel", 0, 60.0, 95.0)]
    launched = [(("models/power.py(232): power_total",), "reduce_kernel",
                 12.0),
                (("models/transfer.py(52): transfer_eh98",),
                 "elementwise_kernel", 20.0)]
    aten = [(10.0, 11.0, "aten::mul", "models/power.py(232): power_total"),
            (12.0, 13.0, "cudaStreamSynchronize", None)]
    aten += [(t, t + 0.1, "cudaLaunchKernel", None)
             for t in (0.5, 3.5, 9.0, 50.0, 59.0)]
    plain = _trace(cpu_ops=aten, device_ops=device_ops, launched=launched)
    spanned = _trace(cpu_ops=aten + CPU_OPS, device_ops=device_ops,
                     launched=launched)
    return plain, spanned


@pytest.mark.parametrize("name", OLD)
def test_the_readers_that_were_there_read_the_same_with_spans(name):
    plain, spanned = _both()
    value = read(name, plain)
    assert value is not None and read(name, spanned) == value


def test_adopt_leaves_the_attribution_as_it_was():
    """``adopt`` names the first pass's operations by the frames pass and
    takes its kernels' frames; the launches, spans and kernels it leaves,
    and with them each kernel's span."""
    cpu, dev = _launches(LAUNCHED)
    first = _trace(cpu_ops=SPANS + cpu, device_ops=dev)
    want = spans.span_kernels(first)
    framed = _trace(cpu_ops=[(1.0, 2.0, "aten::mul", "pipeline.py(1): f")],
                    launched=[(("models/power.py(1): g",), "k", 4.0)])
    first.adopt(framed)
    assert first.launched == framed.launched
    assert spans.span_kernels(first) == want and want is not None


@pytest.mark.parametrize("name", NEW)
def test_the_new_readers_read_nothing_without_spans(name):
    """A trace of a program from before the spans:
    every new reader returns None, and none raises."""
    plain, _ = _both()
    plain.devices = [0, 1]
    assert read(name, plain) is None
