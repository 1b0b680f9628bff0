"""PyTorch port, config 3: every function of models/hod.py, the HOD tracer
of models/power.py, ``rootfind.vectorized_bisection_search`` and
``pipeline.make_hod_fn`` against the JAX package on the CPU, with inputs
made by numpy from a seed.  Both sides are float64 with the same
algorithm: 1e-10 relative unless a test says otherwise."""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from _torch_jax import jacobian_columns, jax_jvp, jvp_value
    from hmvec_tpu import pipeline as jpipe
    from hmvec_tpu.models import hod as jhod
    from hmvec_tpu.models import power as jpwr
    from hmvec_tpu.ops import rootfind as jroot
    from hmvec_tpu.params import default_params as jdefaults
except ImportError:    # a machine with the card and no JAX: the tests
    jnp = None         # marked gpu need none of it (run them with -m gpu)

from hmvec_tpu_torch import pipeline as tpipe
from hmvec_tpu_torch.models import hod as thod
from hmvec_tpu_torch.models import power as tpwr
from hmvec_tpu_torch.ops import rootfind as troot
from hmvec_tpu_torch.params import default_params

ZS = np.linspace(0.1, 3.0, 3)            # both Behroozi regimes (z <> 0.8)
MS = np.geomspace(2e10, 1e17, 24)
KS = np.geomspace(1e-4, 100, 64)
NGAL = np.full(ZS.size, 1e-4)
PARAMS = {"omch2": 0.117, "As": 2.1e-9, "H0": 68.5}
HP = {k: v for k, v in default_params.items() if k.startswith("hod_")}
LOG10M = np.log10(MS)[None, :]
THRESH = np.array([10.2, 10.5, 10.9])[:, None]
T = torch.as_tensor


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) / np.asarray(want) - 1.0)))


def _close(got, want, rtol=1e-10, atol=0.0):
    """Arrays that may hold exact zeros: relative where want is not 0."""
    got, want = np.asarray(got), np.asarray(want)
    return got.shape == want.shape and bool(
        np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))


@pytest.fixture(scope="module")
def mass_function():
    """The Sheth-Tormen (nz, nm) mass function and bias of the port's own
    stages at PARAMS, as numpy arrays (a made-up n(m) can put the solved
    threshold where n_gal(threshold) is too steep to compare at 1e-10)."""
    from hmvec_tpu_torch.models.linear_power import EHEngine
    from hmvec_tpu_torch.params import merge_params, to_torch_params

    p = merge_params()
    grids = tpipe._Grids(ZS, KS, MS, p, None, torch.device("cpu"))
    _, _, nzm, bh, _, _, _ = tpipe._stages(
        {**p, **to_torch_params(PARAMS, "cpu")}, grids, "sheth-torman",
        "vir", "medium", EHEngine(), profile="inputs")
    return nzm.numpy(), bh.numpy()


def test_public_names_of_the_jax_module_exist():
    public = [n for n in dir(jhod) if not n.startswith("_")
              and getattr(getattr(jhod, n), "__module__", "") == jhod.__name__]
    assert len(public) >= 20
    assert [n for n in public if not hasattr(thod, n)] == []
    assert thod.avg_Nc is thod.avg_nc and thod.Mstellar_halo is \
        thod.mstellar_from_mhalo and thod.hod_default_mfunc is \
        thod._default_mfunc


def test_behroozi_relation_matches_jax():
    lms = np.linspace(8.0, 12.5, 30)
    got = thod.mhalo_from_mstellar(T(ZS), T(lms)[None, :])
    assert got.shape == (ZS.size, lms.size)
    assert _rel(got, jhod.mhalo_from_mstellar(ZS, lms[None, :])) <= 1e-13
    # a column of thresholds, one per z; numpy inputs are taken as well
    assert _rel(thod.mhalo_from_mstellar(ZS, THRESH, device="cpu"),
                jhod.mhalo_from_mstellar(ZS, THRESH)) <= 1e-13
    a = 1.0 / (1.0 + ZS)[:, None]
    assert _rel(thod.Mhalo_stellar_core(T(lms)[None, :], T(a),
                                        *thod._BEHROOZI_HIZ),
                jhod.Mhalo_stellar_core(lms[None, :], a,
                                        *jhod._BEHROOZI_HIZ)) <= 1e-13


def test_grid_inversion_matches_jax():
    """mstellar_from_mhalo: one batched searchsorted + lerp against the JAX
    package's vmap of jnp.interp over z, with points below and above the
    sampled range (flat ends)."""
    lm = np.concatenate([[-40.0, 3.0], np.log10(MS), [19.0, 1e5]])
    got = thod.mstellar_from_mhalo(T(ZS), T(lm)[None, :])
    want = np.asarray(jhod.mstellar_from_mhalo(ZS, lm[None, :]))
    assert got.shape == (ZS.size, lm.size) and _close(got, want, 1e-12)
    assert got[0, 0] == -18.0 and got[0, -1] == 18.0
    # the inverse of the forward relation on the grid's interior
    back = thod.mhalo_from_mstellar(T(ZS), got[:, 2:-2])
    assert _rel(back, np.broadcast_to(lm[2:-2], back.shape)) <= 1e-5


def test_interp_rows_is_numpy_interp():
    rng = np.random.default_rng(2)
    xp = np.sort(rng.uniform(-3.0, 3.0, (4, 50)), axis=1)
    xp[1, 10] = xp[1, 11]                     # a zero-width interval
    fp = np.sort(rng.uniform(0.0, 10.0, 50))
    x = rng.uniform(-4.0, 4.0, (4, 33))
    x[2, :3] = xp[2, [0, 17, -1]]             # on the nodes
    got = thod.linear_interp(T(x), T(xp), T(fp))
    want = np.stack([np.interp(x[i], xp[i], fp) for i in range(4)])
    assert _close(got, want, 1e-13, 1e-13)


def test_occupations_match_jax():
    sig = HP["hod_sig_log_mstellar"]

    def jax_side():
        # the JAX side in one compiled program (op by op its first call
        # compiles each operation on its own, which takes seconds)
        jNc = jhod.avg_nc(LOG10M, ZS, THRESH, sig)
        jNs = jhod.avg_ns(LOG10M, ZS, THRESH, jNc, HP)
        return (jNc, jNs,
                jhod.avg_ns(LOG10M, ZS, THRESH, jNc, HP,
                            Msat_override=3e13, Mcut_override=1e12),
                jhod._default_mfunc(THRESH, 9.04, 0.74),
                [(jhod.avg_nsnsm1(jNc, jNs, corr),
                  jhod.avg_ncns(jNc, jNs, corr)) for corr in ("max", "min")])

    jNc, jNs, jover, jmfunc, jpairs = jax.jit(jax_side)()
    Nc = thod.avg_nc(T(LOG10M), T(ZS), T(THRESH), sig)
    assert Nc.shape == (ZS.size, MS.size)
    assert _close(Nc, jNc, 1e-10, 1e-300)
    Ns = thod.avg_ns(T(LOG10M), T(ZS), T(THRESH), Nc, HP)
    assert _close(Ns, jNs, 1e-10, 1e-300)
    over = thod.avg_ns(T(LOG10M), T(ZS), T(THRESH), Nc, HP,
                       Msat_override=3e13, Mcut_override=1e12)
    assert _close(over, jover, 1e-10, 1e-300)
    flat = thod.avg_Ns(T(LOG10M), T(ZS), T(THRESH), sig_log_mstellar=sig,
                       alphasat=HP["hod_alphasat"], Bsat=HP["hod_Bsat"],
                       betasat=HP["hod_betasat"], Bcut=HP["hod_Bcut"],
                       betacut=HP["hod_betacut"])
    assert torch.equal(flat, Ns)
    assert _rel(thod._default_mfunc(T(THRESH), 9.04, 0.74), jmfunc) <= 1e-13
    for corr, (jnsnsm1, jncns) in zip(("max", "min"), jpairs):
        assert _close(thod.avg_nsnsm1(Nc, Ns, corr), jnsnsm1, 1e-10, 1e-300)
        assert _close(thod.avg_ncns(Nc, Ns, corr), jncns, 1e-10, 1e-300)
    with pytest.raises(ValueError):
        thod.avg_nsnsm1(Nc, Ns, "mean")
    with pytest.raises(ValueError):
        thod.avg_ncns(Nc, Ns, "mean")


def test_nsnsm1_zero_tolerance_is_numpy_isclose():
    """Nc within 1e-8 of zero counts as zero (numpy.isclose's defaults,
    which the JAX package uses): <Ns(Ns-1)> is 0 there, Ns^2 / Nc above."""
    Nc = np.array([0.0, 5e-9, 1e-8, 1.0000001e-8, 2e-8, 0.5])
    Ns = np.full(6, 3.0)
    got = thod.avg_nsnsm1(T(Nc), T(Ns))
    assert _close(got, jhod.avg_nsnsm1(jnp.asarray(Nc), jnp.asarray(Ns)),
                  1e-14)
    assert got[:3].tolist() == [0.0, 0.0, 0.0] and bool((got[3:] > 0).all())


def test_zheng05_forms_match_jax():
    lm = np.linspace(10.0, 15.5, 23)
    Nc = thod.avg_nc_zheng05(T(lm), 12.0, 0.2)
    jNc = jhod.avg_nc_zheng05(lm, 12.0, 0.2)
    assert _close(Nc, jNc, 1e-10, 1e-300)
    Ns = thod.avg_ns_zheng05(T(10.0 ** lm), Nc, 10.0 ** 11.7, 1e13, 1.1)
    assert _close(Ns, jhod.avg_ns_zheng05(10.0 ** lm, jNc, 10.0 ** 11.7, 1e13,
                                          1.1), 1e-10, 1e-300)
    assert bool((Ns[10.0 ** lm <= 10.0 ** 11.7] == 0).all())


def _grid_close(got, want, rtol=1e-10):
    """Field by field.  <Nc> = (1 - erf) / 2 cancels to an absolute 1e-16
    in its tail, so each field gets an absolute 1e-14 of its largest
    value beside the relative tolerance."""
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        assert _close(getattr(got, name), w, rtol,
                      1e-14 * np.abs(w).max()), name


def test_build_hod_matches_jax(mass_function):
    nzm, bh = mass_function
    # the JAX side in one compiled program
    want, want_ngal, want_min = jax.jit(lambda: [
        jhod.build_hod(ZS, MS, jnp.asarray(nzm), jnp.asarray(bh), HP,
                       mthresh=10.0 ** THRESH[:, 0]),
        jhod.build_hod(ZS, MS, jnp.asarray(nzm), jnp.asarray(bh), HP,
                       ngal=jnp.asarray(NGAL)),
        jhod.build_hod(ZS, MS, jnp.asarray(nzm), jnp.asarray(bh), HP,
                       ngal=jnp.asarray(NGAL), corr="min",
                       Mcut_override=2e12)])()
    # from thresholds
    got = thod.build_hod(T(ZS), T(MS), T(nzm), T(bh), HP,
                         mthresh=T(10.0 ** THRESH[:, 0]))
    _grid_close(got, want)
    assert isinstance(got, thod.HODGrid) and got.log10mthresh.shape == (3, 1)
    # the ngal -> mthresh bisection: the same 90 halvings on both sides
    got = thod.build_hod(T(ZS), T(MS), T(nzm), T(bh), HP, ngal=T(NGAL))
    _grid_close(got, want_ngal)
    assert _rel(got.ngal, NGAL) <= 1e-9          # the solve found its target
    got_min = thod.build_hod(T(ZS), T(MS), T(nzm), T(bh), HP, ngal=T(NGAL),
                             corr="min", Mcut_override=2e12)
    _grid_close(got_min, want_min)


def test_ngal_from_mthresh_matches_jax(mass_function):
    nzm, _ = mass_function
    got = thod.ngal_from_mthresh(T(THRESH[:, 0]), T(ZS), T(nzm), T(MS), HP)
    want = jhod.ngal_from_mthresh(THRESH[:, 0], ZS, jnp.asarray(nzm), MS, HP)
    assert got.shape == (ZS.size,) and _rel(got, want) <= 1e-10
    from hmvec_tpu_torch.utils.weights import trapz_weights
    again = thod.ngal_from_mthresh(T(THRESH[:, 0]), T(ZS), T(nzm), T(MS), HP,
                                   weights=trapz_weights(MS))
    assert _rel(again, want) <= 1e-10
    # the hoisted form inside build_hod is the same operations
    lmstar = thod.mstellar_from_mhalo(T(ZS), T(LOG10M))
    Nc, Ns = thod._nc_ns_precomp(lmstar, 10.0 ** T(LOG10M), T(ZS), T(THRESH),
                                 HP)
    jNc, jNs = jhod._nc_ns_precomp(jhod.mstellar_from_mhalo(ZS, LOG10M),
                                   10.0 ** LOG10M, ZS, THRESH, HP)
    assert _close(Nc, jNc, 1e-10, 1e-300) and _close(Ns, jNs, 1e-10, 1e-300)
    assert torch.equal(Nc, thod.avg_nc(T(LOG10M), T(ZS), T(THRESH),
                                       HP["hod_sig_log_mstellar"]))


def test_build_hod_zheng05_matches_jax(mass_function):
    nzm, bh = mass_function
    hp = {k: v for k, v in default_params.items() if k.startswith("hod_")}
    assert hp == {k: v for k, v in jdefaults.items() if k.startswith("hod_")}
    for kw in ({}, {"ngal": NGAL}, {"ngal": NGAL, "corr": "min"}):
        tkw = {k: T(v) if k == "ngal" else v for k, v in kw.items()}
        jkw = {k: jnp.asarray(v) if k == "ngal" else v for k, v in kw.items()}
        got = thod.build_hod_zheng05(T(ZS), T(MS), T(nzm), T(bh), hp, **tkw)
        want = jhod.build_hod_zheng05(ZS, MS, jnp.asarray(nzm),
                                      jnp.asarray(bh), hp, **jkw)
        _grid_close(got, want)


def test_vectorized_bisection_search_matches_jax():
    x = np.array([0.3, 2.0, 7.5])
    for mono, f_t, f_j in (
            ("increasing", lambda y: y**3 + y, lambda y: y**3 + y),
            ("decreasing", lambda y: 10.0 * torch.exp(-y),
             lambda y: 10.0 * jnp.exp(-y))):
        got = troot.vectorized_bisection_search(T(x), f_t, (0.0, 5.0), mono)
        want = jroot.vectorized_bisection_search(jnp.asarray(x), f_j,
                                                 (0.0, 5.0), mono)
        assert _rel(got, want) <= 1e-14
    assert _rel(f_t(got), x) <= 1e-12


def test_hod_tracer_terms_match_jax(mass_function):
    nzm, bh = mass_function
    rng = np.random.default_rng(8)
    us = rng.uniform(0.1, 1.0, (ZS.size, MS.size, KS.size))
    uc = rng.uniform(0.5, 1.0, us.shape)
    pzk = rng.uniform(1.0, 1e4, (ZS.size, KS.size))
    grid = thod.build_hod(T(ZS), T(MS), T(nzm), T(bh), HP, ngal=T(NGAL))
    for with_uc in (False, True):
        tg = tpwr.HODTracer(*grid[:6], us=T(us),
                            uc=T(uc) if with_uc else None)
        jg = jpwr.HODTracer(*(jnp.asarray(t.numpy()) for t in grid[:6]),
                            us=jnp.asarray(us),
                            uc=jnp.asarray(uc) if with_uc else None)
        tm, jm = tpwr.MatterTracer(uk=T(us)), jpwr.MatterTracer(
            uk=jnp.asarray(us))
        assert _close(tpwr._hod_term(tg), jpwr._hod_term(jg), 1e-13)
        assert _close(tpwr._hod_term(tg, lowklim=True),
                      jpwr._hod_term(jg, lowklim=True), 1e-13)
        assert _close(tpwr._hod_square_term(tg), jpwr._hod_square_term(jg),
                      1e-13)
        assert _close(tpwr.one_halo_square_term(tg, tm, T(MS), 4e10),
                      jpwr.one_halo_square_term(jg, jm, MS, 4e10), 1e-13)
        for t1, t2, j1, j2 in ((tg, tg, jg, jg), (tg, tm, jg, jm),
                               (tm, tg, jm, jg)):
            got = tpwr.power_total(t1, t2, T(nzm), T(bh), T(MS), T(KS),
                                   T(pzk), 4e10)
            want = jpwr.power_total(j1, j2, jnp.asarray(nzm), jnp.asarray(bh),
                                    MS, KS, jnp.asarray(pzk), 4e10)
            assert _rel(got, want) <= 1e-10
    with pytest.raises(TypeError, match="HODTracer"):
        tpwr.power_1halo(object(), tm, T(nzm), T(MS), T(KS), 4e10)


@pytest.fixture(scope="module")
def jax_hod_at():
    """JAX's make_hod_fn over the parameters of PARAMS, one compile:
    (Pgg, Pgm) and their Jacobian over the first n parameters at the
    defaults with the given overrides."""
    fn = jpipe.make_hod_fn(ZS, KS, MS, NGAL, jit=False, growth="closed")
    jvp = jax_jvp(fn, tuple(PARAMS))

    def at(overrides, n=0):
        theta = [{**jdefaults, **overrides}[k] for k in PARAMS]
        return ([np.asarray(o) for o in jvp_value(jvp, theta)],
                jacobian_columns(jvp, theta, n) if n else None)

    return at


@pytest.fixture(scope="module")
def jax_hod(jax_hod_at):
    """JAX's (Pgg, Pgm) at PARAMS and their Jacobian over (omch2, As)
    at the fiducial cosmology."""
    return (jax_hod_at(PARAMS)[0],
            jax_hod_at({"omch2": 0.1198, "As": 2.2e-9}, 2)[1])


@pytest.mark.parametrize("fast", [False, True, "exact"],
                         ids=["plain", "fast", "exact"])
def test_hod_fn_matches_jax(jax_hod, fast):
    fn = tpipe.make_hod_fn(ZS, KS, MS, NGAL, device="cpu", fast=fast)
    pgg, pgm = fn(PARAMS)
    for got, want in zip((pgg, pgm), jax_hod[0]):
        assert got.shape == (ZS.size, KS.size) and got.dtype == torch.float64
        assert bool((got > 0).all()) and _rel(got, want) <= 1e-10


def test_hod_fn_hod_parameters_and_options():
    fn = tpipe.make_hod_fn(ZS, KS, MS, NGAL, device="cpu")
    ov = {**PARAMS, "hod_alphasat": 1.1, "hod_sig_log_mstellar": 0.25}
    want = jpipe.make_hod_fn(ZS, KS, MS, NGAL, growth="closed")(
        {k: jnp.asarray(v) for k, v in ov.items()})
    for got, w in zip(fn(ov), want):
        assert _rel(got, w) <= 1e-10
    assert _rel(fn(ov)[0], fn(PARAMS)[0]) > 1e-3
    with pytest.raises(ValueError):
        tpipe.make_hod_fn(ZS, KS, MS, NGAL, device="cpu", fast="f16")
    with pytest.raises(TypeError):
        tpipe.make_hod_fn(ZS, KS, MS, NGAL)             # device is required


def test_hod_fn_jacobian_matches_jax(jax_hod):
    """d (Pgg, Pgm) / d (omch2, As), forward mode, against
    hmvec_tpu.pipeline.fisher_jacobian: 1e-6.  As in the JAX package no
    derivative passes through the bisection's bracket: the threshold is a
    constant of the differentiation."""
    fn = tpipe.make_hod_fn(ZS, KS, MS, NGAL, device="cpu")
    jac = tpipe.fisher_jacobian(fn, {"omch2": 0.1198, "As": 2.2e-9},
                                ("omch2", "As"), device="cpu")
    for got, want in zip(jac, jax_hod[1]):
        assert got.shape == want.shape and _rel(got, want) <= 1e-6


def test_hod_threshold_carries_no_derivative(mass_function):
    nzm, bh = mass_function
    scale = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    grid = thod.build_hod(T(ZS), T(MS), T(nzm) * scale, T(bh), HP,
                          ngal=T(NGAL))
    assert not grid.log10mthresh.requires_grad
    assert grid.ngal.requires_grad
    fn = tpipe.make_hod_fn(ZS, KS, MS, NGAL, device="cpu", fast=True)
    om = torch.tensor(0.12, dtype=torch.float64, requires_grad=True)
    fn({"omch2": om})[0].sum().backward()
    assert bool(torch.isfinite(om.grad)) and om.grad != 0


def test_hod_fn_batched_at_two(jax_hod_at):
    """Each row of a B = 2 batch against the port's single call (1e-12)
    and the JAX package's (1e-10)."""
    fn = tpipe.make_hod_fn(ZS, KS, MS, NGAL, device="cpu")
    theta = np.array([[0.11, 2.0e-9], [0.13, 2.4e-9]])
    out = tpipe.make_batched_fn(fn, ("omch2", "As"))(theta)
    for o in out:
        assert o.shape == (2, ZS.size, KS.size)
    for i, (om, As) in enumerate(theta):
        ov = {"omch2": om, "As": As}
        for o, s, w in zip(out, fn(ov), jax_hod_at(ov)[0]):
            assert _rel(o[i], s) <= 1e-12 and _rel(o[i], w) <= 1e-10


@pytest.mark.gpu
def test_hod_fn_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cpu = tpipe.make_hod_fn(ZS, KS, MS, NGAL, device="cpu")(PARAMS)
    for fast, gate in ((False, 1e-10), (True, 1e-5)):
        fn = tpipe.make_hod_fn(ZS, KS, MS, NGAL, device="cuda", fast=fast)
        for got, want in zip(fn(PARAMS), cpu):
            assert got.is_cuda and _rel(got.cpu(), want) <= gate
