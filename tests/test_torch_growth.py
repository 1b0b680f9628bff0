"""PyTorch port, the integrated w0/wa growth (background.growth_table,
growth_eval, mode="ode") against the JAX package on the CPU in float64,
and the pipelines and Jacobians that run on it.

Both sides integrate the same fixed-step RK4; the port re-associates it
into per-step 2x2 propagators and a running product, so the two agree to
rounding: the gates are 1e-10 relative on the table, its evaluation and the
spectra, 1e-8 on the Jacobians."""

import collections
import pathlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from _torch_jax import jacobian_columns, jax_jvp, jvp_value
from hmvec_tpu import pipeline as jpipe
from hmvec_tpu.models import background as jbg
from hmvec_tpu.params import merge_params as jmerge
from hmvec_tpu_torch import pipeline as tpipe
from hmvec_tpu_torch.models import background as tbg
from hmvec_tpu_torch.params import merge_params as tmerge

W0WA = {"lcdm": (-1.0, 0.0), "w0": (-0.9, 0.0), "w0wa": (-1.1, 0.3)}
ZS = np.linspace(0.1, 2.0, 3)
MS = np.geomspace(2e10, 1e17, 16)
KS = np.geomspace(1e-4, 100, 32)
P0 = {"omch2": 0.1198, "w0": -1.0, "wa": 0.0}
NAMES = ("omch2", "w0", "wa")
PMM_PATHS = {"plain": {}, "exact": {"fast": "exact"}, "fast": {"fast": True},
             "fused": {"fused_serving": True}}
NXS, XMAX = 256, 10
# the electron tests' grid
ZS_E, KS_E, MS_E = (np.array([0.5, 2.0]), np.geomspace(1e-3, 10, 24),
                    np.geomspace(1e11, 1e16, 12))
GOLDEN_W = (pathlib.Path(tpipe.__file__).parent / "data"
            / "pmm_config1_w0wa_golden.npz")


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.max(np.abs(got / np.asarray(want) - 1.0)))


def _backgrounds(cosmo):
    w0, wa = W0WA[cosmo]
    return (tbg.background(tmerge({"w0": w0, "wa": wa}), "cpu"),
            jbg.background(jmerge({"w0": w0, "wa": wa})))


def _overrides(cosmo):
    w0, wa = W0WA[cosmo]
    return {"w0": w0, "wa": wa}


@pytest.mark.parametrize("cosmo", list(W0WA))
def test_growth_table_matches_jax(cosmo):
    t, j = _backgrounds(cosmo)
    tt, jt = tbg.growth_table(t), jbg.growth_table(j)
    assert tt.d.shape == tt.dp.shape == (385,)
    assert tt.lna0 == float(jt.lna0) and tt.h == float(jt.h)
    assert _rel(tt.d, jt.d) <= 1e-10
    assert _rel(tt.dp, jt.dp) <= 1e-10


@pytest.mark.parametrize("cosmo", list(W0WA))
def test_growth_eval_matches_jax(cosmo):
    """(D, f) on a in [5e-5, 1]: below the table (a < 1e-4), on nodes,
    between them, and at a = 1."""
    t, j = _backgrounds(cosmo)
    rng = np.random.default_rng(4)
    a = np.concatenate([np.geomspace(5e-5, 1.0, 41),
                        np.exp(rng.uniform(np.log(5e-5), 0.0, 60))])
    assert (a < 1e-4).sum() >= 3
    td, tf = tbg.growth_eval(tbg.growth_table(t), torch.as_tensor(a))
    jd, jf = jbg.growth_eval(jbg.growth_table(j), jnp.asarray(a))
    assert _rel(td, jd) <= 1e-10
    assert _rel(tf, jf) <= 1e-10


@pytest.mark.parametrize("norm", ["anorm", "z0norm"])
def test_d_growth_ode_at_lcdm_matches_closed(norm):
    """The integrated growth reproduces the Heath closed form at LCDM:
    <= 1e-7 relative, the JAX package's own gate (tests/test_background.py)."""
    t, j = _backgrounds("lcdm")
    a = torch.as_tensor(1.0 / (1.0 + np.linspace(0.0, 5.0, 23)))
    ode = tbg.d_growth(t, a, norm=norm, mode="ode")
    assert _rel(ode, tbg.d_growth(t, a, norm=norm, mode="closed")) <= 1e-7
    assert _rel(ode, jbg.d_growth(j, jnp.asarray(a.numpy()), norm=norm,
                                  mode="ode")) <= 1e-10
    with pytest.raises(ValueError):
        tbg.d_growth(t, a, mode="heath")


def test_growth_mode_for():
    assert tbg.growth_mode_for({}) == "closed"
    assert tbg.growth_mode_for({"w0": -1.0, "wa": 0.0}) == "closed"
    assert tbg.growth_mode_for({"w0": -0.9}) == "ode"
    assert tbg.growth_mode_for({"wa": 0.1}) == "ode"


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_growth_table_op_count():
    """One growth_table is a few hundred tensor operations (each a launch
    on a card), not the tens of thousands of a stepped scalar RK4."""
    t, _ = _backgrounds("w0wa")
    with _OpCounter() as ops:
        tbg.growth_table(t)
    n_ops = sum(ops.counts.values())
    assert 0 < n_ops < 2500, n_ops
    assert n_ops < 400, n_ops          # the design: ~9 scan rounds
    # and neither the table nor its evaluation reads a tensor back to the
    # host (on a card each read is a synchronisation), also for a 0-d a
    with _OpCounter() as ops:
        tbg.d_growth(t, torch.tensor([0.3, 1.0], dtype=torch.float64),
                     mode="ode")
    assert not [k for k in ops.counts if "_local_scalar_dense" in k]


@pytest.mark.parametrize("make", ["pmm", "pmm_fused", "electron"])
def test_one_growth_table_per_call(monkeypatch, make):
    """A pipeline call builds the table once and hands it to both linear
    spectra; an LCDM call builds none."""
    built = []
    real = tbg.growth_table
    monkeypatch.setattr(tbg, "growth_table",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    if make == "electron":
        fn = tpipe.make_electron_fn(ZS, KS[::4], MS[::2], nxs=64, xmax=10,
                                    device="cpu")
    else:
        fn = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu",
                               fused_serving=make == "pmm_fused")
    fn(_overrides("lcdm"))
    assert built == []
    fn(_overrides("w0wa"))
    assert built == [1]


@pytest.fixture(scope="module")
def jax_pmm_jvp():
    """JAX's make_pmm_fn (plain, growth 'auto') as jvp over NAMES, one
    compile: Pmm at each (w0, wa) of W0WA and the Jacobian at P0."""
    return jax_jvp(jpipe.make_pmm_fn(ZS, KS, MS, fast=False, jit=False),
                   NAMES)


@pytest.fixture(scope="module")
def jax_pmm(jax_pmm_jvp):
    return {c: np.asarray(jvp_value(jax_pmm_jvp, [P0["omch2"], *W0WA[c]]))
            for c in W0WA}


@pytest.mark.parametrize("cosmo", ["w0", "w0wa"])
@pytest.mark.parametrize("path", list(PMM_PATHS))
def test_pmm_w0wa_matches_jax(jax_pmm, path, cosmo):
    """Every NFW path of make_pmm_fn under growth='auto' with w0/wa
    overrides (on the CPU the kernel tiers run their plain versions)."""
    fn = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu", **PMM_PATHS[path])
    out = fn(_overrides(cosmo))
    assert out.dtype == torch.float64 and out.shape == (ZS.size, KS.size)
    assert _rel(out, jax_pmm[cosmo]) <= 1e-10


def test_pmm_ode_forced_at_lcdm(jax_pmm):
    """growth='ode' at LCDM is JAX's growth='ode' to rounding and the
    closed form to the integration's 1e-7; w0 = -0.9 moves the spectrum."""
    fn = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu", growth="ode")
    out = fn({})
    assert _rel(out, jax_pmm["lcdm"]) <= 1e-10
    closed = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu", growth="closed")({})
    assert _rel(out, closed.numpy()) <= 1e-7
    assert _rel(out, jax_pmm["w0"]) > 1e-3


@pytest.mark.parametrize("fast, gate", [(False, 1e-10), (True, 1e-5)],
                         ids=["plain", "fast"])
def test_electron_w0wa_matches_jax(jax_electron_jvp, fast, gate):
    """Pee and Pme with w0/wa overrides: <= 1e-10 with float64 sampling,
    <= 1e-5 with the float32 sampling of fast=True (the tiers' gates of
    tests/test_torch_electron.py)."""
    ov = _overrides("w0wa")
    want = jvp_value(jax_electron_jvp, [P0["omch2"], *W0WA["w0wa"]])
    fn = tpipe.make_electron_fn(ZS_E, KS_E, MS_E, nxs=NXS, xmax=XMAX,
                                device="cpu", fast=fast)
    for got, w in zip(fn(ov), want):
        assert got.shape == (ZS_E.size, KS_E.size)
        assert _rel(got, w) <= gate


def test_nfw_stage_inputs_take_w0wa():
    """The kernels' inputs at a w0/wa cosmology: finite, and the mass
    weights move with the growth."""
    base = tpipe.nfw_stage_inputs(ZS, KS, MS, {}, device="cpu")
    moved = tpipe.nfw_stage_inputs(ZS, KS, MS, _overrides("w0"),
                                   device="cpu")
    for t in moved:
        assert bool(torch.isfinite(t).all())
    assert _rel(moved[3], base[3].numpy()) > 1e-4


@pytest.fixture(scope="module")
def torch_jac():
    fn = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu")
    return tpipe.fisher_jacobian(fn, P0, NAMES, device="cpu").numpy()


def test_fisher_jacobian_w0wa_matches_jax(torch_jac, jax_pmm_jvp):
    """Forward mode over (omch2, w0, wa) at the LCDM fiducial: a
    differentiated w0/wa resolves to the integrated growth, whose w0 and wa
    columns are not zero (the closed form's are)."""
    want, = jacobian_columns(jax_pmm_jvp, [P0[k] for k in NAMES], 3)
    assert torch_jac.shape == want.shape == (ZS.size, KS.size, 3)
    assert np.all(np.isfinite(torch_jac))
    for col in range(3):
        assert np.min(np.abs(torch_jac[..., col])) > 0.0
        assert _rel(torch_jac[..., col], want[..., col]) <= 1e-8


@pytest.mark.parametrize("kw", [{"fast": "exact"}, {"fused_serving": True}],
                         ids=["exact", "fused"])
def test_kernel_paths_differentiate_w0wa_like_plain(torch_jac, kw):
    fn = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu", **kw)
    jac = tpipe.fisher_jacobian(fn, P0, NAMES, device="cpu").numpy()
    assert _rel(jac, torch_jac) <= 1e-10


@pytest.mark.parametrize("name", ["w0", "wa"])
def test_reverse_gradient_in_w0wa_matches_forward(torch_jac, name):
    """d sum(Pmm) / d w0 (wa) by reverse mode equals the forward column."""
    fn = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu")
    v = torch.tensor(P0[name], dtype=torch.float64, requires_grad=True)
    g, = torch.autograd.grad(fn({**P0, name: v}).sum(), v)
    want = torch_jac[..., NAMES.index(name)].sum()
    assert float(g) != 0.0
    assert abs(float(g) / want - 1.0) <= 1e-10


@pytest.fixture(scope="module")
def jax_electron_jvp():
    """JAX's make_electron_fn (growth 'auto') as jvp over NAMES on the
    electron grid, one compile."""
    return jax_jvp(jpipe.make_electron_fn(ZS_E, KS_E, MS_E, nxs=NXS,
                                           xmax=XMAX, jit=False), NAMES)


def test_electron_fisher_jacobian_w0_matches_jax(jax_electron_jvp):
    names = ("omch2", "w0")
    p0 = {"omch2": 0.1198, "w0": -1.0}
    want = jacobian_columns(jax_electron_jvp, [P0[k] for k in NAMES], 2)
    fn = tpipe.make_electron_fn(ZS_E, KS_E, MS_E, nxs=NXS, xmax=XMAX,
                                device="cpu")
    got = tpipe.fisher_jacobian(fn, p0, names, device="cpu")
    for g, w in zip(got, want):
        assert np.min(np.abs(g.numpy()[..., 1])) > 0.0
        assert _rel(g, w) <= 1e-8


@pytest.mark.parametrize("i", [0, 1, 2])
def test_config1_w0wa_golden_at_reduced_k(i):
    """growth='ode' at config 1's z and m grids on every 8th k against the
    golden Pmm that the JAX package wrote at full width (each k is
    computed independently, so thinning k changes no value)."""
    g = np.load(GOLDEN_W)
    fn = tpipe.make_pmm_fn(g["zs"], g["ks"][::8], g["ms"], device="cpu",
                           growth="ode")
    ov = dict(zip(g["param_names"].tolist(), g["param_values"][i]))
    assert _rel(fn(ov), g["pmm"][i][:, ::8]) <= 1e-10


def test_config1_w0wa_golden_jacobian_at_reduced_k():
    """fisher_jacobian over (omch2, w0, wa) on every 16th k against the
    golden Jacobian, element by element."""
    g = np.load(GOLDEN_W)
    names = tuple(g["jac_names"].tolist())
    assert names == NAMES
    fn = tpipe.make_pmm_fn(g["zs"], g["ks"][::16], g["ms"], device="cpu")
    p0 = dict(zip(g["param_names"].tolist(), map(float, g["param_values"][2])))
    jac = tpipe.fisher_jacobian(fn, p0, names, device="cpu")
    assert _rel(jac, g["jac_pmm"][:, ::16]) <= 1e-8
