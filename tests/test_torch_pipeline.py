"""PyTorch port, the config-1 Pmm pipeline end to end against the JAX
package on the CPU, and against the golden file that the JAX package
wrote at config 1's full width (tools/gen_torch_golden.py)."""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hmvec_tpu import pipeline as jpipe
from hmvec_tpu_torch import pipeline as tpipe

ZS = np.linspace(0.1, 2.0, 4)            # tests/test_pipeline.py's grid
MS = np.geomspace(2e10, 1e17, 64)
KS = np.geomspace(1e-4, 100, 128)
BENCH = {"omch2": 0.1198, "ombh2": 0.02225, "H0": 67.3, "ns": 0.9645,
         "As": 2.2e-9, "w0": -1.0, "wa": 0.0, "mnu": 0.0, "omk": 0.0,
         "pivot_scalar": 0.05}
GOLDEN = (pathlib.Path(tpipe.__file__).parent / "data"
          / "pmm_config1_golden.npz")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jax_pmm():
    fn = jpipe.make_pmm_fn(ZS, KS, MS, fast=False, growth="closed")
    return np.asarray(fn({k: jnp.asarray(v) for k, v in BENCH.items()}))


def _rel(got, want):
    return float(np.max(np.abs(got / want - 1.0)))


@pytest.mark.parametrize("fast", [False, True, "exact"],
                         ids=["plain", "fast", "exact"])
def test_pmm_matches_jax(jax_pmm, fast):
    """Both sides float64 with the same algorithm: <= 1e-10 relative.  On
    the CPU the kernel tiers run the plain version, so all three agree."""
    fn = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu", fast=fast)
    out = fn(BENCH)
    assert out.dtype == torch.float64 and out.shape == (ZS.size, KS.size)
    assert _rel(out.numpy(), jax_pmm) <= 1e-10


def test_pmm_growth_auto_and_overrides(jax_pmm):
    fn = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu", growth="auto")
    assert _rel(fn({k: np.float64(v) for k, v in BENCH.items()}).numpy(),
                jax_pmm) <= 1e-10
    # an empty override dict is the defaults, which differ from BENCH only
    # in names that are equal -- the same spectrum
    assert _rel(fn({}).numpy(), jax_pmm) <= 1e-10


def test_fused_matches_jax_interpret():
    """fused_serving=True vs the JAX fused pipeline with its contraction
    kernel in Pallas interpret mode (float32 sums): <= 1e-5 relative, the
    gate of tests/test_fast_sampling.py on the same 3 z x 80 m x 160 k."""
    zs = np.linspace(0.1, 3.0, 3)
    ms = np.geomspace(2e10, 1e17, 80)
    ks = np.geomspace(1e-4, 100, 160)
    old = jpipe._FUSED_INTERPRET
    jpipe._FUSED_INTERPRET = True
    try:
        jfn = jpipe.make_pmm_fn(zs, ks, ms, growth="closed",
                                fused_serving=True)
        want = np.asarray(jfn({"omch2": jnp.asarray(0.1198)}))
    finally:
        jpipe._FUSED_INTERPRET = old
    tfn = tpipe.make_pmm_fn(zs, ks, ms, device="cpu", fused_serving=True)
    got = tfn({"omch2": 0.1198}).numpy()
    assert _rel(got, want) <= 1e-5
    # and the port's fused path is the plain path to float64 rounding
    plain = tpipe.make_pmm_fn(zs, ks, ms, device="cpu")({"omch2": 0.1198})
    assert _rel(got, plain.numpy()) <= 1e-10


def test_uk_subsample_matches_jax():
    """The thinned-k NFW stage with Catmull-Rom fill-in: <= 1e-10."""
    zs = np.linspace(0.1, 3.0, 3)
    ms = np.geomspace(2e10, 1e17, 24)
    ks = np.geomspace(1e-4, 100, 301)
    jfn = jpipe.make_pmm_fn(zs, ks, ms, growth="closed",
                            uk_subsample=(0.2, 4))
    tfn = tpipe.make_pmm_fn(zs, ks, ms, device="cpu", uk_subsample=(0.2, 4))
    assert _rel(tfn({}).numpy(), np.asarray(jfn({}))) <= 1e-10


def test_config1_full_width_matches_golden():
    """The port at config 1's full width (20 z x 200 m x 1001 k) on the CPU
    against the JAX package's golden Pmm: <= 1e-10 relative for the bench
    cosmology."""
    g = np.load(GOLDEN)
    fn = tpipe.make_pmm_fn(g["zs"], g["ks"], g["ms"], device="cpu")
    ov = dict(zip(g["param_names"].tolist(), g["param_values"][0]))
    out = fn(ov).numpy()
    assert out.shape == (20, 1001)
    assert _rel(out, g["pmm"][0]) <= 1e-10


def test_golden_cosmologies_at_reduced_k():
    """The other two golden cosmologies, on every 4th k (the full width
    is covered by the bench cosmology above; this keeps the file fast)."""
    g = np.load(GOLDEN)
    fn = tpipe.make_pmm_fn(g["zs"], g["ks"][::4], g["ms"], device="cpu")
    for i in (1, 2):
        ov = dict(zip(g["param_names"].tolist(), g["param_values"][i]))
        assert _rel(fn(ov).numpy(), g["pmm"][i][:, ::4]) <= 1e-10


def test_growth_mode_resolution():
    gm = tpipe._growth_mode_from
    assert gm({}, "auto") == "closed"
    assert gm({"w0": torch.tensor(-1.0, dtype=torch.float64)}, "auto") == \
        "closed"
    assert gm({"w0": torch.tensor(-0.9, dtype=torch.float64)}, "auto") == "ode"
    assert gm({"wa": torch.tensor(0.0, dtype=torch.float64,
                                  requires_grad=True)}, "auto") == "ode"
    assert gm({"w0": -0.9}, "closed") == "closed"
    # a w0/wa cosmology gets the integrated growth, not the LCDM answer
    fn = tpipe.make_pmm_fn(ZS[:2], KS[::16], MS[::8], device="cpu")
    jfn = jpipe.make_pmm_fn(ZS[:2], KS[::16], MS[::8], fast=False)
    out = fn({"w0": -0.9}).numpy()
    assert _rel(out, np.asarray(jfn({"w0": jnp.asarray(-0.9)}))) <= 1e-10
    assert _rel(out, fn({}).numpy()) > 1e-3


def test_unsupported_options_raise():
    with pytest.raises(NotImplementedError):
        tpipe.make_pmm_fn(ZS, KS, MS, device="cpu",
                          mass_function="tinker2010")({})
    with pytest.raises(ValueError):
        tpipe.make_pmm_fn(ZS, KS, MS, device="cpu", fast="f16")
    with pytest.raises(TypeError):
        tpipe.make_pmm_fn(ZS, KS, MS)        # the device is required


def test_cuda_device_without_card_raises():
    """make_pmm_fn(device='cuda') never falls back to the CPU."""
    if torch.cuda.is_available():
        fn = tpipe.make_pmm_fn(ZS, KS, MS, device="cuda")
        assert fn({}).is_cuda
    else:
        with pytest.raises(RuntimeError):
            tpipe.make_pmm_fn(ZS, KS, MS, device="cuda")
