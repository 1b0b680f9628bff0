"""The electron cell and what the harness needed for it: an entry that
returns several spectra.  The reference against the program's plain
float64 path on the CPU at a small grid, and the NFW and resample inputs it
works out against the program's; a run driven end to end on the CPU (the
look for a card skipped) as it is and with one leaf (Pee or Pme) broken
underneath; the two controls; a single tensor's rows kept as they were;
B4b's frozen work count and its roofline reader."""

import types

import numpy as np
import pytest
import torch

import chip_smoke
from hmvec_tpu_torch import pipeline
from portbench import control
from portbench.lib import harness
from portbench.lib import traffic as traffic_mod
from portbench.lib.system import build
from portbench.reference import halo_electron
from portbench.tests._small import small
from portbench.work import pair_lerp, roofline

CELL = "electron_fast.b16"
SEED = 2**33 + 12345
LIMIT = float(small(CELL)[2]["check"]["max_rel_err"])
READER = harness.load_module("metrics", "pair_lerp_roofline")


def _first_batch(spec):
    calls = traffic_mod.Traffic(spec, traffic_mod.streams(11, 1)[0])
    return calls, calls.next_batch()


def test_reference_matches_the_plain_program():
    """make_electron_fn(fast=False) on CPU tensors: float64 throughout, the
    resample by its plain version."""
    _, _, cfg, spec = small(CELL, batch=4)
    cfg["options"]["fast"] = False
    cfg["out_dtype"] = "float64"
    calls, theta = _first_batch(spec)
    pee, pme = build(cfg, calls.names, ["cpu"])(theta)
    for i, row in enumerate(theta):
        want = halo_electron.spectra(calls.row(row), cfg)
        got = np.stack([pee[i].numpy(), pme[i].numpy()])
        assert want.shape == got.shape == (2, 3, 64)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


def test_the_kernels_inputs_match_the_program():
    _, _, cfg, spec = small(CELL)
    calls, theta = _first_batch(spec)
    row = calls.row(theta[0])
    zs, ms, ks = halo_electron.grids(cfg)
    pks, scales, cs, _, _ = pipeline.nfw_stage_inputs(zs, ks, ms, row,
                                                      device="cpu")
    nfw = halo_electron.kernel_inputs(row, cfg)
    np.testing.assert_array_equal(nfw["ks"], pks.numpy())
    np.testing.assert_allclose(nfw["scales"], scales.numpy(), rtol=1e-12)
    np.testing.assert_allclose(nfw["cs"], cs.numpy(), rtol=1e-12)
    opts = cfg["options"]
    u, scales, eks, dkt = pipeline.electron_stage_inputs(
        zs, ks, ms, row, device="cpu", nxs=opts["nxs"], xmax=opts["xmax"],
        fast=True)
    tr = halo_electron.transform_inputs(row, cfg)
    assert u.dtype == torch.float32 and tr["nkt"] == u.shape[-1]
    np.testing.assert_allclose(tr["scales"], scales.numpy(), rtol=1e-12)
    np.testing.assert_array_equal(tr["ks"], eks.numpy())
    assert tr["dkt"] == pytest.approx(dkt, rel=1e-15)


def _run(fault=None):
    bench, _, cfg, spec = small(CELL)
    return harness.run(bench, CELL, seed=SEED, seconds=1.5, trace=False,
                       devices=["cpu"], t_start=0.0, config=cfg,
                       traffic=spec, fault=fault)


def test_a_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["checks"]["rows_checked"]["value"] >= 4
    assert list(out)[-1] == "checks"


def _on_leaf(leaf, change):
    """A fault in one leaf: ``change(new, previous)`` replaces the leaf-th
    spectrum of each call's answers."""
    def wrap(batched):
        last = []

        def call(theta):
            out = list(batched(theta))
            prev = last[0] if last else out[leaf]
            last[:] = [out[leaf]]
            out[leaf] = change(out[leaf], prev)
            return tuple(out)
        return call
    return wrap


def stale(new, prev):
    """The leaf of the previous call (its state unchanged)."""
    return prev


def half_batch(new, prev):
    """Half of the batch left out: its rows are the mean of the rest."""
    half = new[: len(new) // 2]
    return torch.cat([half, half.mean(dim=0, keepdim=True).expand_as(half)])


def altered(new, prev):
    """One answer of every row altered by ten times the check's limit."""
    out = new.clone()
    out[:, 0, -1] *= 1.0 + 10 * LIMIT
    return out


@pytest.mark.parametrize("leaf", [0, 1])
@pytest.mark.parametrize("change", [stale, half_batch, altered])
def test_a_fault_in_one_leaf_is_not_correct(leaf, change):
    out = _run(fault=_on_leaf(leaf, change))
    assert not out["correct"], out["checks"]
    assert out["failed"] > 0


def test_the_controls_fail():
    """The precision control fails the whole output's limit; the stage
    control (what is stated in float64 in float32) the low-k band's."""
    bench, _, cfg, spec = small(CELL)
    errs, cfg = control.control_errors(bench, CELL, SEED, 20, config=cfg,
                                       traffic=spec)
    assert len(errs) == 16 and np.all(np.isfinite(errs))
    assert min(e[0] for e in errs) > float(cfg["check"]["max_rel_err"])
    errs, cfg = control.control_errors(bench, CELL, SEED, 20, config=cfg,
                                       traffic=spec, kind="stages")
    assert (max(e[1] for e in errs)
            > float(cfg["check"]["low_k_max_rel_err"]))


def test_a_row_of_one_tensor_is_kept_as_it_was_and_of_several_stacked():
    a = np.arange(24.0, dtype=np.float32).reshape(4, 2, 3)
    got = harness.row_of(a, 2)
    np.testing.assert_array_equal(got, a[2])
    assert got.shape == (2, 3) and not np.shares_memory(got, a)
    both = harness.row_of((a, 10 * a), 1)
    np.testing.assert_array_equal(both, np.stack([a[1], 10 * a[1]]))


def test_the_kernels_are_hand_kernels_of_the_program():
    assert set(pair_lerp.KERNELS) <= set(harness.hand_kernels())


def test_pair_lerp_work_matches_chip_smoke():
    """On a 3 x 4 table of 9 entries: targets below the grid, inside it and
    past its end."""
    scales = torch.tensor([[0.5, 1.0, 2.0, 3.5], [0.1, 7.0, 1.5, 0.8],
                           [4.0, 0.3, 2.2, 9.0]], dtype=torch.float64)
    ks = torch.tensor([0.05, 0.4, 1.0, 1.7, 3.3], dtype=torch.float64)
    for dtype in (torch.float32, torch.float64):
        u = torch.zeros(3, 4, 9, dtype=dtype)
        want = chip_smoke.pair_lerp_work(u, scales, ks, 0.7)
        got = pair_lerp.work(9, u.element_size(), scales, ks, 0.7)
        assert got == want


def test_reader_reads_nothing_without_the_kernel_and_a_share_with_it():
    _, _, cfg, spec = small(CELL, batch=4)
    calls = traffic_mod.Traffic(spec, traffic_mod.streams(3, 1)[0])
    thetas = [calls.next_batch() for _ in range(3)]
    ctx = {"config": cfg, "reference": halo_electron, "row": calls.row,
           "device": "cpu"}

    def trace(us_per_call, name=pair_lerp.KERNELS[0]):
        return types.SimpleNamespace(
            n_calls=3, thetas=thetas, devices=[0], context=ctx,
            kernel_us=lambda k, call=None: us_per_call if k == name else 0.0)

    assert READER.read(trace(0.0)) is None
    least = 0.0
    for theta in thetas[:2]:
        rows = [halo_electron.transform_inputs(calls.row(r), cfg)
                for r in theta]
        least += roofline.least_time_s(*pair_lerp.work(
            rows[0]["nkt"], 4,
            torch.as_tensor(np.stack([r["scales"] for r in rows])),
            torch.as_tensor(rows[0]["ks"]), rows[0]["dkt"]))
    for name in pair_lerp.KERNELS:
        assert READER.read(trace(least * 1e6 / 2, name)) == pytest.approx(100.0)
