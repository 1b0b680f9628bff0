"""The reference against the program on the CPU at a small grid: both
configurations, serving options included, through ``make_batched_fn`` on
cosmologies of the traffic's ranges.  On CPU tensors the program runs its
kernels' float64 plain versions, so the two agree to rounding."""

import numpy as np
import pytest
import torch

from portbench.lib import harness
from portbench.lib import traffic as traffic_mod
from portbench.lib.system import build
from portbench.reference import halo_pmm
from portbench.tests._small import small


@pytest.mark.parametrize("cell", ["pmm_fast.b128", "pmm_fused.b512"])
def test_reference_matches_the_program(cell):
    _, _, cfg, spec = small(cell, batch=4)
    cfg["out_dtype"] = "float64"
    calls = traffic_mod.Traffic(spec, traffic_mod.streams(11, 1)[0])
    theta = calls.next_batch()
    got = build(cfg, calls.names, ["cpu"])(theta).numpy()
    for row, out in zip(theta, got):
        want = halo_pmm.spectra(calls.row(row), cfg)
        assert want.shape == out.shape
        np.testing.assert_allclose(out, want, rtol=1e-11, atol=0)


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; import portbench.reference.halo_pmm; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=harness.ROOT)
    tops = eval(out.stdout)
    assert "hmvec_tpu_torch" not in tops and "torch" not in tops
    assert "hmvec_tpu" not in tops and "jax" not in tops


def test_bfloat16_rounding():
    a = np.array([1.0, 1.0 + 2**-8, 1.0 + 2**-7, 3.14159265, -2.5e-10],
                 np.float32)
    got = halo_pmm.to_bfloat16(a)
    want = torch.tensor(a).to(torch.bfloat16).to(torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


def test_control_is_one_precision_below():
    _, _, cfg, spec = small("pmm_fast.b128")
    calls = traffic_mod.Traffic(spec, traffic_mod.streams(3, 1)[0])
    theta = calls.row(calls.next_batch()[0])
    ref = halo_pmm.spectra(theta, cfg)
    ctl = halo_pmm.control(theta, cfg)
    assert ctl.dtype == np.float32
    err = np.max(np.abs(ctl - ref) / ref)
    assert 1e-4 < err < 1e-1
