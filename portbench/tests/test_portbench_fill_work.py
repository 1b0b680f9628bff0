"""The work count of the Catmull-Rom fill F1 against a count by hand, the
fills each cell makes a call, and its roofline reader on a stand-in
trace."""

import types

import numpy as np
import pytest

from portbench.lib import harness
from portbench.lib import traffic as traffic_mod
from portbench.reference import halo_pmm
from portbench.work import catmull_fill, roofline

READER = harness.load_module("metrics", "catmull_fill_roofline")


def test_catmull_fill_work_by_hand():
    # 3 rows of 5 float32 read once, the 4 x 7 int32 and float64 taps,
    # 3 x 7 float64 written once; a multiply and an add per tap and output
    assert catmull_fill.work(3, 5, 7, 4) == (
        4 * 15 + (4 + 8) * 28 + 8 * 21, {"f64": 2 * 4 * 21})


def test_the_kernel_is_a_hand_kernel_of_the_program():
    assert catmull_fill.KERNEL in harness.hand_kernels()


def _cell(name):
    bench = harness.load_bench()
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    cfg = harness.load_json("configs", cell["config"])
    spec = harness.load_json("traffic", cell["traffic"])
    calls = traffic_mod.Traffic(spec, traffic_mod.streams(3, 1)[0])
    return cell, cfg, calls


@pytest.mark.parametrize("name, fills", [
    ("pmm_fast.b128", [(128 * 20 * 200, 589, 1001, 4)]),
    ("pmm_fused.b512", [(512 * 20, 589, 1001, 8)] * 2),
    ("pmm_fast.b512.mesh4", [(128 * 20 * 200, 589, 1001, 4)] * 4)])
def test_each_cell_fills_its_thinned_grid(name, fills):
    cell, cfg, calls = _cell(name)
    theta = calls.next_batch()
    got = READER.launches(cfg, halo_pmm, calls.row(theta[0]), len(theta),
                          cell["chips"])
    assert got == fills


def test_the_fast_cube_bound():
    # 1.21 GB of float32 read, 4.10 GB of float64 written: ~1.584 ms
    t = roofline.least_time_s(*catmull_fill.work(512000, 589, 1001, 4))
    assert t == pytest.approx(1.584e-3, rel=1e-3)


def test_reader_reads_nothing_without_the_kernel_and_a_share_with_it():
    cell, cfg, calls = _cell("pmm_fast.b128")
    thetas = [calls.next_batch() for _ in range(3)]
    ctx = {"config": cfg, "reference": halo_pmm, "row": calls.row}

    def trace(us_per_call):
        return types.SimpleNamespace(
            n_calls=3, thetas=thetas, devices=[0], context=ctx,
            kernel_us=lambda name, call=None: (
                us_per_call if name == catmull_fill.KERNEL else 0.0))

    assert READER.read(trace(0.0)) is None
    least = roofline.least_time_s(*catmull_fill.work(512000, 589, 1001, 4))
    assert READER.read(trace(2 * least * 1e6)) == pytest.approx(50.0)
    assert np.isfinite(READER.read(trace(1.0)))
