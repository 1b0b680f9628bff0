"""PyTorch port, the multi-device layer: parallel/sharding.py and
fit_emulator(mesh=) on a mesh of 8 CPU slots, against the JAX package's own
sharded functions on its 8 virtual CPU devices (tests/conftest.py), at the
JAX tests' sizes: the mass-sharded Pmm (tests/test_pipeline.py's grid, and
under a w0/wa override) 1e-10, the data-parallel batch
(tests/_sharded_suite.py) 1e-11 and its refusal, the galaxy x electron
spectra and the matter bispectrum with the quadratic-bias term 1e-9.  The
mass-sharded Pmm is compiled here; the references that compile slowly come
from hmvec_tpu_torch/data/sharding_cpu_golden.npz (tools/gen_torch_golden.py
--config sharding, the same JAX functions on the same 8 devices): the
batch, galaxy x electron and bispectrum, two Fisher steps of JAX's
make_fisher_step_fn (1e-8), JAX's bin-sharded kSZ survey (1e-10, with and
without per-bin bias; its own test is slow), and the unsharded Boltzmann
solve and projection at _sharded_suite.py's tiny grid (JAX's sharded ones
are never compiled: they crash its compilation cache).  On that grid a 1e-15 change of the
initial state moves the states by ~2e-4 of a component's largest value
(the tight-coupling era's amplification, ROADMAP C4), so the port is held
to JAX there within that measured spread, and the sharded solve and
projection to the port's unsharded ones bit for bit.  The sharded emulator
fit against the unsharded one at tests/test_emulator.py's size and gates.

The card test (``-m gpu``) launches every kernel on each slot of a mesh of
the card repeated, and of every visible card, and checks that the
caller's current device is unchanged after each launch:

    python -m pytest --noconftest -m gpu tests/test_torch_sharding.py
"""

import pathlib

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from hmvec_tpu.parallel import sharding as jsh
    from _torch_jax import Prefetch
except ImportError:    # a machine with the card and no JAX: the tests
    jnp = None         # marked gpu need none of it (run them with -m gpu)

from hmvec_tpu_torch import pipeline as tpl
from hmvec_tpu_torch.models import background as tbg
from hmvec_tpu_torch.models import boltzlite as tbl
from hmvec_tpu_torch.models import emulator as tem
from hmvec_tpu_torch.models import recomb as trec
from hmvec_tpu_torch.params import merge_params
from hmvec_tpu_torch.parallel import sharding as tsh

GOLDEN = (pathlib.Path(__file__).resolve().parents[1] / "hmvec_tpu_torch"
          / "data" / "sharding_cpu_golden.npz")
# tests/test_pipeline.py's grid
ZS = np.linspace(0.1, 2.0, 4)
MS = np.geomspace(2e10, 1e17, 64)
KS = np.geomspace(1e-4, 100, 128)
# tests/_sharded_suite.py's
ZS_S = np.linspace(0.2, 1.4, 3)
MS_S = np.geomspace(1e11, 1e16, 64)
KS_S = np.geomspace(1e-3, 10, 60)
NGAL = np.full(3, 1e-4)
NXS, XMAX = 512, 15.0
KQ = np.geomspace(5e-3, 2.0, 10)
BATCH = dict(zs=np.linspace(0.1, 2.0, 3), ks=np.geomspace(1e-3, 10, 64),
             ms=np.geomspace(2e10, 1e17, 32))
THETA = np.column_stack([np.linspace(0.11, 0.13, 8),
                         np.linspace(2.0e-9, 2.4e-9, 8)])
W0WA = {"w0": -0.9, "wa": 0.2}
# tests/test_ksz_survey_fused.py's sharded survey
SURVEY_CFG = dict(num_kL_bins=6, num_kS_bins=7, num_mu_bins=6,
                  ms=np.geomspace(1e10, 1e16, 24), nxs=128, xmax=10)
BOLTZ_GRID = dict(n_a=200, n_b_outer=80, n_b_inner=2, n_c_outer=60,
                  n_c_inner=3)
T = torch.as_tensor


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    # ROADMAP C14: a thread's first MKL vector-math call once came out at
    # low accuracy; each one is made here, on both threads, and discarded
    x = torch.linspace(0.1, 10.0, 1 << 14, dtype=torch.float64)
    for f in (torch.sin, torch.cos, torch.exp, torch.log, torch.sqrt,
              torch.log1p):
        f(x)
    yield
    torch.set_num_threads(old)


def _mesh(axis_name="m"):
    return tsh.make_mesh(devices=["cpu"] * 8, axis_name=axis_name)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got / want - 1.0)))


def _jax_references():
    """The JAX package's sharded Pmm on its 8 virtual devices, under one
    jax.jit each (the other sharded references compile more slowly and
    come from the golden file)."""
    mesh = jsh.make_mesh(8)
    ov_w = {k: jnp.asarray(v) for k, v in W0WA.items()}
    return {
        "pmm": lambda: jax.jit(jsh.make_sharded_pmm_fn(ZS, KS, MS, mesh))(
            {}),
        "pmm_ode": lambda: jax.jit(jsh.make_sharded_pmm_fn(
            ZS_S, KS_S, MS_S, mesh))(ov_w),
    }


@pytest.fixture(autouse=True, scope="module")
def jax_ref():
    """The JAX references, computed by worker threads from the module's
    start (their compiles overlap each other and the torch side, so the
    tests that read them come last)."""
    if jnp is None:
        yield {}
        return
    pool = Prefetch(workers=2)
    futures = {k: pool.submit(lambda f=f: jax.tree_util.tree_map(
        np.asarray, f())) for k, f in _jax_references().items()}
    yield futures
    pool.close()


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


# ---- the mesh ---------------------------------------------------------------

def test_make_mesh_takes_the_cards_and_refuses_without_one(monkeypatch):
    mesh = _mesh("k")
    assert mesh.size == 8 and mesh.axis_names == ("k",)
    assert mesh.distinct() == (torch.device("cpu"),)
    x = T(np.arange(24.0).reshape(3, 8))
    parts = mesh.shard(x, axis=1)
    assert [tuple(p.shape) for p in parts] == [(3, 1)] * 8
    assert torch.equal(mesh.all_gather(parts, axis=1), x)
    assert torch.equal(mesh.psum(parts), x.sum(dim=1, keepdim=True))
    with pytest.raises(ValueError, match="mesh size 8 must divide"):
        mesh.shard(x)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tsh.make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tsh.make_mesh().devices == (torch.device("cuda", 0),
                                       torch.device("cuda", 1))
    with pytest.raises(ValueError, match="3 slots on 2 visible cards"):
        tsh.make_mesh(3)


# ---- without a JAX compile: the golden file's references and the port's own

def test_fisher_step_matches_jax(golden):
    """Two steps of make_fisher_step_fn against the JAX package's on the
    same data (its model at the fiducial): theta and loss 1e-8, and the
    loss descends."""
    step, model = tsh.make_fisher_step_fn(
        ZS, KS, MS, np.geomspace(30, 1000, 8), _mesh(), lr=1e-3)
    data = model(T([1.0, 1.0], dtype=torch.float64))
    assert _rel(data, golden["fisher_data"]) <= 1e-10
    theta1, loss0 = step(T([1.04, 1.08], dtype=torch.float64),
                         golden["fisher_data"])
    theta2, loss1 = step(theta1, golden["fisher_data"])
    assert _rel(theta1, golden["fisher_theta1"]) <= 1e-8
    assert _rel(theta2, golden["fisher_theta2"]) <= 1e-8
    assert _rel(loss0, golden["fisher_loss0"]) <= 1e-8
    assert _rel(loss1, golden["fisher_loss1"]) <= 1e-8
    assert np.isfinite(float(loss0)) and float(loss1) <= float(loss0)


def test_sharded_batch_refuses_an_indivisible_batch():
    fn = tpl.make_pmm_fn(np.linspace(0.1, 1.0, 2), np.geomspace(1e-3, 1, 8),
                         np.geomspace(1e11, 1e15, 8), device="cpu")
    bf = tsh.make_sharded_batched_fn(fn, ("omch2",), _mesh())
    with pytest.raises(ValueError, match="mesh size 8 must divide"):
        bf(np.full((4, 1), 0.12))
    with pytest.raises(ValueError, match="no replica"):
        tsh.make_sharded_batched_fn(lambda ov: fn(ov), ("omch2",),
                                    _mesh())


def test_sharded_survey_matches_jax(golden):
    """Eight bins over eight slots: JAX's sharded survey (golden) and the
    port's one-device survey, 1e-10, with and without per-bin bias."""
    args = (np.linspace(0.3, 1.0, 8), np.linspace(5.0, 12.0, 8),
            np.full(8, 1e-4), 1e-5 * np.ones(10000))
    bs = np.linspace(1.5, 2.5, 8)
    sharded = tsh.make_sharded_ksz_survey_fn(8, _mesh(), **SURVEY_CFG)
    single = tpl.make_ksz_survey_fn(8, device="cpu", **SURVEY_CFG)
    got = sharded({}, *args)
    for g, w, s in zip(got, (golden["survey_total"], golden["survey_snrs"],
                             golden["survey_bgals"]), single({}, *args)):
        assert _rel(g, w) <= 1e-10 and _rel(g, s) <= 1e-10
    _, snrs_b, _ = sharded({}, *args, bs=bs)
    assert _rel(snrs_b, golden["survey_snrs_bs"]) <= 1e-10
    assert _rel(snrs_b, single({}, *args, bs=bs)[1]) <= 1e-10
    assert not np.allclose(_np(snrs_b), _np(got[1]))


# ---- the Boltzmann hierarchy over k and its projection over l -------------

def test_sharded_boltzlite_matches_unsharded_and_jax(golden, monkeypatch):
    """_sharded_suite.py's tiny grid: ks padded 10 -> 16 over 8 slots,
    ls 5 -> 8.  Sharded == unsharded bit for bit (states, x grid,
    zeta_unit, C_l); against the JAX package's unsharded solve within the
    spread that a 1e-15 relative change of the initial state gives on
    this grid."""
    bg = tbg.background(merge_params({}), "cpu")
    ctx = tbl.make_ctx(bg, trec.recombination(bg, n=4096))
    ks = np.geomspace(2e-4, 0.02, 10)
    ls = np.array([4, 9, 20, 40, 70])
    ks_fine = np.linspace(2e-4, 0.95 * 0.02, 300)
    mesh = _mesh("k")
    sol = tbl.solve_perturbations(ctx, ks, **BOLTZ_GRID)
    sol_s = tsh.sharded_solve_perturbations(ctx, ks, mesh, **BOLTZ_GRID)
    assert torch.equal(sol_s.states, sol.states)
    assert torch.equal(sol_s.xs, sol.xs) and torch.equal(sol_s.ks, sol.ks)
    assert torch.equal(sol_s.zeta_unit, sol.zeta_unit)
    src = tbl.compute_sources(ctx, sol)
    cl = tbl.cls_from_sources(src, bg, ls, ks_fine)
    cl_s = tsh.sharded_cls_from_sources(src, bg, ls, ks_fine, mesh)
    for key in ("tt", "ee", "te"):
        assert torch.equal(cl_s[key], cl[key]), key

    # the conditioning of this grid, measured: the same solve from an
    # initial state changed by 1e-15 relative
    start = tbl._initial_state
    bump = 1.0 + 1e-15 * T(np.random.default_rng(3).standard_normal(
        (ks.size + 1, sol.states.shape[-1])))
    monkeypatch.setattr(tbl, "_initial_state",
                        lambda *a: start(*a) * bump)
    sol_b = tbl.solve_perturbations(ctx, ks, **BOLTZ_GRID)
    monkeypatch.undo()
    cl_b = tbl.cls_from_sources(tbl.compute_sources(ctx, sol_b), bg, ls,
                                ks_fine)
    want = golden["boltz_states"]
    scale = np.max(np.abs(want), axis=(0, 1), keepdims=True)
    spread = np.max(np.abs(_np(sol_b.states) - _np(sol.states)) / scale)
    assert 1e-6 < spread < 1e-2, spread
    assert np.max(np.abs(_np(sol_s.states) - want) / scale) <= spread
    assert np.array_equal(_np(sol_s.xs), golden["boltz_xs"])
    for key in ("tt", "ee", "te"):
        cl_spread = _rel(cl_b[key], cl[key])
        assert _rel(cl_s[key], golden[f"boltz_cl_{key}"]) <= cl_spread, key
    assert _rel(sol_s.zeta_unit, golden["boltz_zeta_unit"]) \
        <= _rel(sol_b.zeta_unit, sol.zeta_unit)


# ---- the data-parallel emulator fit ---------------------------------------

def _smooth(theta):
    """tests/test_emulator.py's smooth positive family, on tensors."""
    xg = torch.linspace(0.0, 1.0, 32, dtype=theta.dtype,
                        device=theta.device)
    return torch.exp(theta[1] * xg) * (1.0 + theta[0] * torch.sin(3.0 * xg)) \
        + 2.0


def test_sharded_fit_matches_single_device():
    """tests/test_emulator.py's sharded-vs-unsharded fit: final loss 1e-3
    (atol 1e-7), predictions 2e-3; n_train truncated to the mesh."""
    lo, hi = np.array([0.5, -1.0]), np.array([2.0, 1.0])
    kw = dict(n_train=256, n_val=32, widths=(32, 32), steps=300,
              learning_rate=5e-3, seed=5, key=1, device="cpu")
    em0, info0 = tem.fit_emulator(_smooth, lo, hi, **kw)
    em1, info1 = tem.fit_emulator(_smooth, lo, hi, mesh=_mesh(), **kw)
    np.testing.assert_allclose(info1["losses"][-1], info0["losses"][-1],
                               rtol=1e-3, atol=1e-7)
    thetas = tem.sample_params(lo, hi, 16, seed=11)
    with torch.no_grad():
        np.testing.assert_allclose(_np(em1(thetas)), _np(em0(thetas)),
                                   rtol=2e-3)
    _, info2 = tem.fit_emulator(_smooth, lo, hi, mesh=_mesh(),
                                **{**kw, "n_train": 20, "steps": 2})
    assert info2["losses"].shape == (2,)


# ---- against the JAX package's sharded functions (compiled from the
# module's start) ----------------------------------------------------------

@pytest.mark.parametrize("which", ["pmm", "pmm_ode"])
def test_sharded_pmm_matches_jax(which, jax_ref):
    """test_pipeline.py's grid, and _sharded_suite.py's under a w0/wa
    override (the integrated growth on the replicated stages): against
    JAX's sharded Pmm and the port's unsharded make_pmm_fn, 1e-10."""
    zs, ks, ms, ov = ((ZS, KS, MS, {}) if which == "pmm"
                      else (ZS_S, KS_S, MS_S, W0WA))
    got = tsh.make_sharded_pmm_fn(zs, ks, ms, _mesh())(ov)
    assert _rel(got, jax_ref[which].result()) <= 1e-10
    assert _rel(got, tpl.make_pmm_fn(zs, ks, ms, device="cpu")(ov)) <= 1e-10


def test_sharded_galaxy_electron_matches_jax(golden):
    """Pgg, Pge, Pee with the NFW and Battaglia transforms sharded:
    against JAX's sharded function 1e-9."""
    got = tsh.make_sharded_galaxy_electron_fn(ZS_S, KS_S, MS_S, NGAL,
                                              _mesh(), nxs=NXS, xmax=XMAX)({})
    for g, key in zip(got, ("pgg", "pge", "pee")):
        assert _rel(g, golden[key]) <= 1e-9, key


def test_sharded_bispectrum_matches_jax(golden):
    got = tsh.make_sharded_matter_bispectrum_fn(
        ZS_S, KS_S, MS_S, KQ, 1.3 * KQ, 1.8 * KQ, _mesh(),
        include_b2=True)({})
    assert _rel(got, golden["bispectrum"]) <= 1e-9


def test_sharded_batch_matches_jax(golden):
    """Eight cosmologies over eight slots: JAX's sharded batch 1e-11, the
    port's one-device make_batched_fn row by row 1e-12."""
    fn = tpl.make_pmm_fn(BATCH["zs"], BATCH["ks"], BATCH["ms"], device="cpu")
    got = tsh.make_sharded_batched_fn(fn, ("omch2", "As"), _mesh())(THETA)
    assert _rel(got, golden["batch"]) <= 1e-11
    assert _rel(got, tpl.make_batched_fn(fn, ("omch2", "As"))(THETA)) \
        <= 1e-12


# ---- on the card ------------------------------------------------------------

@pytest.mark.gpu
def test_kernel_launches_keep_the_current_device():
    """Every kernel launched on each slot of a 2-slot mesh of cuda:0 and,
    where it exists, on cuda:1, with the caller's current device left as
    it was after each launch; a sharded batch through both NFW tiers and
    the fused tier on the mesh of every visible card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hmvec_tpu_torch.ops import nfw_kernels as nk
    from hmvec_tpu_torch.ops import resample_kernels as rk

    torch.cuda.set_device(0)
    devices = ["cuda:0", "cuda:0"] + (["cuda:1"]
                                      if torch.cuda.device_count() > 1
                                      else [])
    rng = np.random.default_rng(0)
    for dev in tsh.make_mesh(devices=devices).devices:
        def t(a, dtype=torch.float64, dev=dev):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        ks, s_, c_ = (t(np.geomspace(1e-3, 10, 64)),
                      t(rng.uniform(0.01, 1.0, 40)),
                      t(rng.uniform(2.0, 10.0, 40)))
        u = t(rng.standard_normal((40, 129)))
        calls = {
            "nfw_uk_fast": lambda: nk.nfw_uk_fast(ks, s_, c_),
            "nfw_uk_exact": lambda: nk.nfw_uk_exact(ks, s_, c_),
            "nfw_contract": lambda: nk.nfw_contract(
                ks, s_.reshape(4, 10), c_.reshape(4, 10),
                s_.reshape(4, 10), c_.reshape(4, 10)),
            "pair_lerp_f64": lambda: rk.pair_lerp_f64(u, s_, ks, 0.5),
            "pair_lerp_f32": lambda: rk.pair_lerp_f32(
                u.to(torch.float32), s_, ks, 0.5),
        }
        bg = tbg.background(merge_params({}), dev)
        ctx = tbl.make_ctx(bg, trec.recombination(bg, n=1024))
        calls["hierarchy_rk4 and recomb_rk4"] = lambda: \
            tbl.solve_perturbations(ctx, [1e-3, 1e-2], n_a=60, n_b_outer=20,
                                    n_b_inner=2, n_c_outer=20, n_c_inner=2)
        for name, call in calls.items():
            out = call()
            torch.cuda.synchronize()
            assert torch.cuda.current_device() == 0, (name, dev)
            leaves = out if isinstance(out, tuple) else (out,)
            assert all(x.device == dev for x in leaves
                       if isinstance(x, torch.Tensor)), (name, dev)
    mesh = tsh.make_mesh()
    for kw in ({"fast": True}, {"fast": "exact"}, {"fused_serving": True}):
        fn = tpl.make_pmm_fn(BATCH["zs"], BATCH["ks"], BATCH["ms"],
                             device="cuda:0", **kw)
        theta = np.tile(THETA, (mesh.size, 1))
        got = tsh.make_sharded_batched_fn(fn, ("omch2", "As"), mesh)(theta)
        assert torch.cuda.current_device() == 0
        want = tpl.make_batched_fn(fn, ("omch2", "As"))(theta)
        assert _rel(got.cpu(), want.cpu()) <= 1e-12, kw
