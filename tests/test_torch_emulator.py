"""PyTorch port, the emulator, the stage checkpoints and the profiling
hooks: models/emulator.py, utils/checkpoint.py and utils/profiling.py
against the JAX package on the CPU.  The emulator: the Sobol' sample bit
for bit; a float64 fit of 30 steps from the JAX package's own initial net
(its ``_init_net``, handed to ``fit_emulator(init_net=)``) on the same
standardized arrays, whose losses, predictions and Jacobian match the JAX
fit's at 1e-10; an emulator that the JAX package saved, loaded by the
port at 1e-12 (float64, element by element) and 1e-6 (float32, of each
row's largest value: the float32 MLP's rounding is on the scale of its
output); ``log_y`` and a training set smaller than the ``mesh``
refused (the sharded fit itself: tests/test_torch_sharding.py).  The
checkpoints: JAX -> port and port -> JAX, get_power at 1e-10, on the JAX
suite's shared HaloModel shape (3 z, 80 m, 64 k), and a restore of a
second cosmology's checkpoint giving that cosmology's spectra bit for
bit.  The JAX side of each comparison runs under one
``jax.jit`` (the fit is the JAX package's own, one scan).

The card test (``-m gpu``) fits, restores and fetches on the card against
the same calls on CPU tensors:

    python -m pytest --noconftest -m gpu tests/test_torch_emulator.py
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from hmvec_tpu.models import emulator as jem
    from hmvec_tpu.utils import checkpoint as jck
    from _torch_jax import Prefetch, jax_halo_model_of
except ImportError:    # a machine with the card and no JAX: the tests
    jnp = None         # marked gpu need none of it (run them with -m gpu)

import hmvec_tpu_torch
from hmvec_tpu_torch import pipeline as tpl
from hmvec_tpu_torch.models import emulator as tem
from hmvec_tpu_torch.models import halo_model as thm
from hmvec_tpu_torch.parallel.sharding import make_mesh
from hmvec_tpu_torch.utils import checkpoint as tck
from hmvec_tpu_torch.utils import profiling as tprof

LO = np.array([0.5, -1.0])
HI = np.array([2.0, 1.0])
XG = np.linspace(0.0, 1.0, 32)
FIT = dict(n_train=64, n_val=16, widths=(16, 16), steps=30,
           learning_rate=5e-3, log_y=True, seed=3)
ZS = np.array([0.3, 0.65, 1.0])    # the JAX suite's shared shape
MS = np.geomspace(2e10, 1e16, 80)
KS = np.geomspace(1e-3, 30.0, 64)
PARAMS_B = {"As": 2.0e-9, "ns": 0.95}
GATE = 1e-10
T = torch.as_tensor


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    # ROADMAP C14: a thread's first MKL vector-math call once came out at
    # low accuracy; each one is made here, on both threads, and discarded
    x = torch.linspace(0.1, 10.0, 1 << 14, dtype=torch.float64)
    for f in (torch.sin, torch.cos, torch.exp, torch.log, torch.sqrt,
              torch.tanh):
        f(x)
    yield
    torch.set_num_threads(old)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got / want - 1.0)))


def _row_max(got, want):
    """Max abs difference along the last axis over the row's largest
    |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)
                        / np.max(np.abs(want), -1, keepdims=True)))


def _smooth_t(theta):
    """The JAX suite's smooth positive 2-parameter family over 32 outputs
    (tests/test_emulator.py), on tensors."""
    xg = torch.as_tensor(XG, dtype=theta.dtype, device=theta.device)
    return torch.exp(theta[1] * xg) * (1.0 + theta[0] * torch.sin(3.0 * xg)) \
        + 2.0


def _smooth_j(theta):
    xg = jnp.asarray(XG)
    return jnp.exp(theta[1] * xg) * (1.0 + theta[0] * jnp.sin(3.0 * xg)) \
        + 2.0


# ---- the emulator -------------------------------------------------------------

def test_sample_params_is_the_jax_draw():
    for lo, hi, n, seed in ((LO, HI, 64, 1), (LO, HI, 100, 7),
                            ([0.10, 0.020, 0.92], [0.14, 0.024, 1.00], 320,
                             0)):
        got = tem.sample_params(lo, hi, n, seed=seed)
        assert np.array_equal(got, jem.sample_params(lo, hi, n, seed=seed))
    with pytest.raises(ValueError, match="shape"):
        tem.sample_params([0.0], [1.0, 2.0], 4)


def _jax_fit():
    return jem.fit_emulator(_smooth_j, LO, HI, dtype=jnp.float64, key=0,
                            **FIT)


@pytest.fixture(autouse=True, scope="module")
def _jax_refs():
    """The JAX package's fit (a scan of ~2.5 s of compile), run by a worker
    thread from the module's start, beside the torch side
    (``_torch_jax.Prefetch``)."""
    if jnp is None:      # the card test needs no JAX
        yield None
        return
    pre = Prefetch(1)
    yield {"fit": pre.submit(_jax_fit)}
    pre.close()


@pytest.fixture(scope="module")
def fits(_jax_refs):
    """The JAX package's float64 fit (key 0) and the port's from the same
    initial net; thetas of the fit's held-out rows."""
    j_em, j_info = _jax_refs["fit"].result()
    sizes = j_info["sizes"]
    init = jem._init_net(jax.random.PRNGKey(0), sizes, jnp.float64)
    init = {k: [np.asarray(a) for a in v] for k, v in init.items()}
    t_em, t_info = tem.fit_emulator(_smooth_t, LO, HI, dtype=torch.float64,
                                    init_net=init, device="cpu", **FIT)
    thetas = tem.sample_params(LO, HI, 12, seed=11)
    return j_em, j_info, t_em, t_info, thetas


def test_float64_fit_matches_jax(fits):
    """Losses, held-out errors, predictions (batched and single) and the
    Jacobian of the fitted surrogate."""
    j_em, j_info, t_em, t_info, thetas = fits
    assert t_info["sizes"] == j_info["sizes"] == (2, 16, 16, 32)
    assert t_info["losses"].dtype == np.float64
    assert _rel(t_info["losses"], j_info["losses"]) <= GATE
    for k in ("val_max_rel", "val_rms_rel"):
        assert abs(t_info[k] / j_info[k] - 1.0) <= 1e-8, k
    want = jax.jit(lambda th: (j_em(th), j_em(th[0]),
                               jax.jacfwd(j_em)(th[0])))(jnp.asarray(thetas))
    got = t_em(thetas)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert _rel(got, want[0]) <= GATE
    assert _rel(t_em(thetas[0]), want[1]) <= GATE
    jac = torch.func.jacfwd(t_em)(T(thetas[0]))
    assert jac.shape == (32, 2)
    assert float(np.max(np.abs(_np(jac) - np.asarray(want[2])))
                 / np.max(np.abs(np.asarray(want[2])))) <= GATE


def _jax_emulator(dtype, seed):
    """A JAX Emulator from its _init_net (random standardization), as its
    save_emulator writes it."""
    rng = np.random.default_rng(seed)
    net = jem._init_net(jax.random.PRNGKey(seed), (2, 24, 24, 32), dtype)
    net["b"] = [jnp.asarray(rng.standard_normal(b.shape) * 0.1, dtype)
                for b in net["b"]]
    return jem.Emulator(net, jnp.asarray(rng.uniform(0.5, 1.5, 2)),
                        jnp.asarray(rng.uniform(0.2, 0.5, 2)),
                        jnp.asarray(rng.standard_normal(32)),
                        jnp.asarray(rng.uniform(0.1, 1.0, 32)),
                        log_y=seed % 2 == 1)


def test_a_jax_saved_emulator_loads_into_the_port(tmp_path):
    thetas = tem.sample_params(LO, HI, 9, seed=2)
    ems = {jnp.float64: _jax_emulator(jnp.float64, 3),
           jnp.float32: _jax_emulator(jnp.float32, 4)}
    want = jax.jit(lambda th: [em(th) for em in ems.values()])(
        jnp.asarray(thetas))
    for (dtype, em), w, (gate, err) in zip(ems.items(), want,
                                           ((1e-12, _rel), (1e-6, _row_max))):
        path = tmp_path / f"em_{np.dtype(dtype).name}.npz"
        jem.save_emulator(em, path)
        got = tem.load_emulator(path, device="cpu")
        assert got.net.W[0].dtype == getattr(torch, np.dtype(dtype).name)
        assert got.log_y == em.log_y
        assert err(got(thetas), w) <= gate, dtype
        # and back: the port's file is the JAX package's layout
        path2 = tmp_path / "again.npz"
        tem.save_emulator(got, path2)
        back = jem.load_emulator(path2)
        for a, b in zip(back.net["W"] + back.net["b"],
                        em.net["W"] + em.net["b"]):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_an_emulator_from_the_jax_layout_and_its_refusals():
    em = _jax_emulator(jnp.float64, 5)
    net = {k: [np.asarray(a) for a in v] for k, v in em.net.items()}
    t = tem.Emulator(net, *(np.asarray(x) for x in (em.x_mu, em.x_sd,
                                                    em.y_mu, em.y_sd)),
                     log_y=em.log_y, device="cpu")
    assert [w.shape for w in t.net["W"]] == [w.shape for w in net["W"]]
    x = np.array([1.1, 0.2])
    assert _rel(t(x), jax.jit(em)(jnp.asarray(x))) <= 1e-12
    net_t = {k: [T(np.array(a)) for a in v] for k, v in net.items()}
    assert _rel(tem._net_apply(net_t, T(x[None, :])),
                jax.jit(jem._net_apply)(em.net, jnp.asarray(x[None, :]))) \
        <= 1e-12
    with pytest.raises(ValueError, match="smaller than the mesh"):
        tem.fit_emulator(_smooth_t, LO, HI, n_train=4, mesh=make_mesh(
            devices=["cpu"] * 8), device="cpu")
    with pytest.raises(ValueError, match="positive"):
        tem.fit_emulator(lambda th: _smooth_t(th) - 3.0, LO, HI, n_train=8,
                         n_val=0, steps=1, log_y=True, device="cpu")
    with pytest.raises(ValueError, match="layer sizes"):
        tem.fit_emulator(_smooth_t, LO, HI, n_train=8, n_val=0, steps=1,
                         widths=(8,), init_net=net, device="cpu")


def test_pipeline_target_flattens_as_jax_and_batches():
    """Leaves in jax.tree_util's order (dict keys sorted); a vmapped
    make_pmm_fn target equals its single calls (each row a cosmology of
    the training set), and fit_emulator trains on it with the losses'
    dtype and the MLP on fn's device."""
    def fn(ov):
        return {"z": torch.stack([ov["b"], ov["a"]]), "a": (ov["a"] * 2,),
                "m": None}
    target = tem.pipeline_target(fn, ("a", "b"), base={"c": 1.0})
    got = target(T([3.0, 5.0]))
    want = jax.tree_util.tree_leaves({"z": np.array([5.0, 3.0]),
                                      "a": (np.array(6.0),), "m": None})
    assert np.array_equal(_np(got), np.concatenate(
        [np.ravel(w) for w in want]))
    pmm = tpl.make_pmm_fn(ZS[:2], KS[::4], MS[::8], device="cpu")
    target = tem.pipeline_target(pmm, ("omch2", "ns"))
    assert target.device == torch.device("cpu")
    th = T(tem.sample_params([0.11, 0.94], [0.13, 0.98], 3, seed=1))
    batch = torch.func.vmap(target)(th)
    for i in range(3):
        assert _rel(batch[i], target(th[i])) <= 1e-12
    em, info = tem.fit_emulator(target, [0.11, 0.94], [0.13, 0.98],
                                n_train=6, n_val=2, widths=(8,), steps=3,
                                log_y=True, chunk=4)
    assert info["losses"].dtype == np.float32 and info["losses"].size == 3
    assert em.device == torch.device("cpu")
    assert np.isfinite(info["val_max_rel"])


# ---- checkpoints ----------------------------------------------------------------

def _build(device, params=None):
    hm = thm.HaloModel(ZS, KS, ms=MS, params=params, device=device)
    hm.add_battaglia_profile("e", family="AGN", nxs=500, xmax=12)
    hm.add_hod("g", ngal=np.full(ZS.size, 1e-4))
    return hm


SPECTRA = (("nfw", None), ("g", None), ("e", "g"), ("e", None))


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A checkpoint that the JAX package writes (of a JAX instance at the
    second cosmology) restores into the port, and a port checkpoint into
    the JAX class: get_power of either at 1e-10 of the other's."""
    b = _build("cpu", PARAMS_B)
    jh = jax_halo_model_of(b, PARAMS_B)
    path = str(tmp_path / "jax.npz")
    jck.save_halo_model(jh, path)
    th = tck.restore_halo_model(thm.HaloModel(ZS, KS, ms=MS, device="cpu",
                                              params=PARAMS_B), path)
    assert th.Pzk.dtype == torch.float64 and set(th.hods) == {"g"}

    src = _build("cpu")
    path = str(tmp_path / "port.npz")
    tck.save_halo_model(src, path)
    assert tck.load_stages(path)["uk__e"].shape == (3, 80, 64)
    jh2 = jck.restore_halo_model(jax_halo_model_of(
        thm.HaloModel(ZS, KS, ms=MS, device="cpu")), path)
    want = jax.jit(lambda: [jh.get_power(*n) for n in SPECTRA]
                   + [jh2.get_power(*n) for n in SPECTRA])()
    for names, w in zip(SPECTRA, want[:len(SPECTRA)]):
        assert _rel(th.get_power(*names), w) <= GATE, names
    for names, w in zip(SPECTRA, want[len(SPECTRA):]):
        assert _rel(src.get_power(*names), w) <= GATE, names


def test_a_restore_leaves_nothing_stale(tmp_path):
    """A second cosmology's checkpoint restored into a built instance
    gives that cosmology's spectra bit for bit; grids that differ are
    refused."""
    a = _build("cpu")
    b = _build("cpu", PARAMS_B)
    before = a.get_power("g")
    path = str(tmp_path / "b.npz")
    tck.save_halo_model(b, path)
    tck.restore_halo_model(a, path)
    for names in SPECTRA:
        assert torch.equal(a.get_power(*names), b.get_power(*names)), names
    assert not torch.equal(a.get_power("g"), before)
    stages = tck.load_stages(path, device="cpu")
    assert all(isinstance(v, torch.Tensor) for v in stages.values())
    other = thm.HaloModel(ZS, KS[:-1], ms=MS, device="cpu")
    with pytest.raises(ValueError, match="'ks' does not match"):
        tck.restore_halo_model(other, path)


# ---- profiling -------------------------------------------------------------------

def test_profiling_hooks_on_the_cpu(tmp_path):
    tree = {"a": T([1.0, 2.0]), "b": [T(3.0), 4.0], "c": (T([[5.0]]),)}
    out = tprof.fetch_sync(tree)
    assert isinstance(out["a"], np.ndarray) and isinstance(out["c"], tuple)
    assert np.array_equal(out["c"][0], [[5.0]]) and float(out["b"][1]) == 4.0
    results = {}
    with tprof.timer("x", results):
        tprof.fetch_sync(torch.ones(3) * 2)
    assert results["x"] > 0.0
    assert tprof.time_fn(lambda x: x * 2, T([1.0]), iters=3, warmup=1) > 0.0
    with tprof.torch_trace(str(tmp_path)) as prof:
        torch.ones(64).sin().sum()
    assert any(e.key for e in prof.key_averages())
    assert list(tmp_path.iterdir())


# ---- on the card -----------------------------------------------------------------

@pytest.mark.gpu
def test_emulator_checkpoint_and_fetch_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kw = dict(FIT, steps=10, dtype=torch.float64, key=0)
    gen = torch.Generator().manual_seed(0)
    init = tem._init_net(gen, (2, 16, 16, 32), torch.float64, "cpu")
    init = {k: [a.numpy() for a in v] for k, v in init.items()}
    em_c, info_c = tem.fit_emulator(_smooth_t, LO, HI, init_net=init,
                                    device="cpu", **kw)
    em_g, info_g = tem.fit_emulator(_smooth_t, LO, HI, init_net=init, **kw)
    assert em_g.device.type == "cuda"
    assert all(p.is_cuda for p in em_g.parameters())
    assert _rel(info_g["losses"], info_c["losses"]) <= GATE
    th = tem.sample_params(LO, HI, 5, seed=4)
    assert _rel(em_g(th).cpu(), em_c(th)) <= GATE
    em_path = str(tmp_path / "em.npz")
    tem.save_emulator(em_g, em_path)
    assert _rel(tem.load_emulator(em_path)(th).cpu(), em_c(th)) <= GATE
    cpu = _build("cpu")
    path = str(tmp_path / "hm.npz")
    tck.save_halo_model(cpu, path)
    gpu = tck.restore_halo_model(thm.HaloModel(ZS, KS, ms=MS), path)
    for names in SPECTRA:
        got = gpu.get_power(*names)
        assert got.is_cuda and _rel(got.cpu(), cpu.get_power(*names)) \
            <= GATE, names
    out = tprof.fetch_sync({"p": got, "l": [got[0]]})
    assert isinstance(out["p"], np.ndarray)
    assert hmvec_tpu_torch.load_emulator(em_path).device.type == "cuda"
