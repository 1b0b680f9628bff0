"""The check that decides ``correct``, shown to fail: a run driven end to
end on the CPU at a small size (the look for a card skipped), once as it
is and once with the timed path broken underneath in each way a serving
cell can be broken, and the control (the reference one precision below,
in the program's place)."""

import numpy as np
import pytest
import torch

from portbench import control
from portbench.lib import harness
from portbench.tests._small import small

SEED = 2**33 + 12345


def _run(cell, fault=None, slots=1):
    bench, _, cfg, spec = small(cell)
    return harness.run(bench, cell, seed=SEED, seconds=1.5, trace=False,
                       devices=["cpu"] * slots, t_start=0.0, config=cfg,
                       traffic=spec, fault=fault)


def stale(batched):
    """A call that returns the previous call's answers (state unchanged)."""
    last = []

    def call(theta):
        out = batched(theta)
        if last:
            out, last[0] = last[0], out
        else:
            last.append(out)
        return out
    return call


def half_batch(batched):
    """Half of the batch left out: its rows are the mean of the rest."""
    def call(theta):
        half = batched(theta[: len(theta) // 2])
        mean = half.mean(dim=0, keepdim=True).expand_as(half)
        return torch.cat([half, mean])
    return call


def altered(batched):
    """One answer of every row altered where it is produced, by ten times
    the check's limit."""
    def call(theta):
        out = batched(theta).clone()
        out[:, 0, -1] *= 1.0 + 10 * LIMIT
        return out
    return call


def no_exchange(batched):
    """The gather between cards left out: every card's share holds the
    first card's rows."""
    def call(theta):
        out = batched(theta)
        q = len(theta) // 4
        return out[:q].repeat(4, 1, 1)
    return call


LIMIT = float(small("pmm_fast.b128")[2]["check"]["max_rel_err"])


@pytest.mark.parametrize("cell, slots", [("pmm_fast.b128", 1),
                                         ("pmm_fused.b512", 1),
                                         ("pmm_fast.b512.mesh4", 4)])
def test_a_sound_run_is_correct(cell, slots):
    out = _run(cell, slots=slots)
    assert out["correct"], out["checks"]
    # the float32 cast of the spectra, the plain versions otherwise exact
    assert out["checks"]["max_rel_err"]["value"] < 1e-7
    assert out["checks"]["low_k_max_rel_err"]["value"] < 1e-7
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell, slots, fault", [
    ("pmm_fast.b128", 1, stale), ("pmm_fast.b128", 1, half_batch),
    ("pmm_fast.b128", 1, altered), ("pmm_fused.b512", 1, stale),
    ("pmm_fused.b512", 1, half_batch), ("pmm_fused.b512", 1, altered),
    ("pmm_fast.b512.mesh4", 4, no_exchange),
    ("pmm_fast.b512.mesh4", 4, half_batch),
    ("pmm_fast.b512.mesh4", 4, altered)])
def test_a_broken_run_is_not_correct(cell, slots, fault):
    out = _run(cell, fault=fault, slots=slots)
    assert not out["correct"], out["checks"]
    assert out["failed"] > 0


@pytest.mark.parametrize("cell", ["pmm_fast.b128", "pmm_fused.b512",
                                  "pmm_fast.b512.mesh4"])
def test_the_control_is_not_correct(cell):
    bench, _, cfg, spec = small(cell)
    errs, cfg = control.control_errors(bench, cell, SEED, 20, config=cfg,
                                       traffic=spec)
    assert len(errs) == 16
    assert min(e[0] for e in errs) > float(cfg["check"]["max_rel_err"])
    assert np.all(np.isfinite(errs))


@pytest.mark.parametrize("cell", ["pmm_fast.b128", "pmm_fused.b512",
                                  "pmm_fast.b512.mesh4"])
def test_the_stage_control_fails_the_low_k_band(cell):
    """The stages and mass integrals in float32 (u(k) as stated) pass the
    whole-output limit and fail the low-k band's."""
    bench, _, cfg, spec = small(cell)
    errs, cfg = control.control_errors(bench, cell, SEED, 20, config=cfg,
                                       traffic=spec, kind="stages")
    assert max(e[0] for e in errs) <= float(cfg["check"]["max_rel_err"])
    assert (max(e[1] for e in errs)
            > float(cfg["check"]["low_k_max_rel_err"]))
