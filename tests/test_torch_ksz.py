"""PyTorch port, config 5 (kSZ): the free functions of models/ksz.py,
``background.growth_rate_f``, ``pipeline.make_ksz_snr_fn`` (with its
Jacobian) and ``pipeline.make_ksz_survey_fn`` against the JAX package on
the CPU, at the sizes of the JAX package's own kSZ tests
(tests/test_ksz_fused.py), with inputs made by numpy from a seed; and a
kSZ batch against its single calls.  Both sides are float64 with the same
algorithm.

The card test (``-m gpu``) holds the resample kernel at the bench kSZ
shape against its plain version, bit for bit:

    python -m pytest --noconftest -m gpu tests/test_torch_ksz.py
"""

import math
import warnings

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from hmvec_tpu import pipeline as jpipe
    from hmvec_tpu.models import background as jbg
    from hmvec_tpu.models import ksz as jksz
    from hmvec_tpu.params import merge_params as jmerge
    from _torch_jax import jacobian_columns, jax_jvp, jvp_value
except ImportError:    # a machine with the card and no JAX: the tests
    jnp = None         # marked gpu need none of it (run them with -m gpu)

from hmvec_tpu_torch import pipeline as tpipe
from hmvec_tpu_torch.models import background as tbg
from hmvec_tpu_torch.models import ksz as tksz
from hmvec_tpu_torch.ops import resample_kernels as rk
from hmvec_tpu_torch.params import merge_params

MS = np.geomspace(1e10, 1e16, 32)
CFG = dict(num_kL_bins=8, num_kS_bins=9, num_mu_bins=6, nxs=256, xmax=10,
           ms=MS)
CLS = 1e-5 * np.ones(10000)
NAMES = ("omch2", "As")
THETA0 = (0.1198, 2.2e-9)
# tests/test_ksz_survey_fused.py's bins
ZC, VOLS, NGALS = (np.array([0.45, 0.7]), np.array([8.0, 12.0]),
                   np.array([1.2e-4, 8e-5]))
RNG = np.random.default_rng(17)
T = torch.as_tensor
F64 = torch.float64


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got / want - 1.0)))


def _ov(theta):
    return dict(zip(NAMES, theta))


@pytest.fixture(scope="module")
def snr_fn():
    return tpipe.make_ksz_snr_fn(0.55, 10.0, 1e-4, device="cpu", **CFG)


@pytest.fixture(scope="module")
def jax_snr_and_jacobian():
    """JAX's (snr, Nvv, vrec) at THETA0 and d snr / d (omch2, As), from
    one compile."""
    fn = jpipe.make_ksz_snr_fn(0.55, 10.0, 1e-4, jit=False, **CFG)
    jvp = jax_jvp(lambda ov: fn(ov, CLS), NAMES)
    return ([np.asarray(o) for o in jvp_value(jvp, THETA0)],
            jacobian_columns(jvp, THETA0, len(NAMES))[0])


# ---- the free functions -----------------------------------------------

def test_scalar_helpers_match_jax():
    assert tksz.defaults == jksz.defaults
    assert tksz.constants == jksz.constants
    assert tksz.chi is tksz.chi_ion
    for vol in (0.5, 10.0, 123.0):
        assert tksz.get_kmin(vol) == jksz.get_kmin(vol)
    ngal = RNG.uniform(1e-5, 1e-3, 5)
    assert _rel(tksz.Ngg(T(ngal)), jksz.Ngg(jnp.asarray(ngal))) <= 1e-15
    for Yp, NHe in ((0.24, 0), (0.2478, 1), (0.25, 2)):
        assert abs(tksz.chi_ion(Yp, NHe) / jksz.chi_ion(Yp, NHe) - 1) <= 1e-15
        assert abs(tksz.ne0_shaw(0.0224, Yp, NHe)
                   / jksz.ne0_shaw(0.0224, Yp, NHe) - 1) <= 1e-15
    zs = np.array([0.1, 0.55, 2.0])
    p = {**merge_params(), "T_CMB": 2.7e6}
    for kw in ({}, {"gasfrac": 0.8, "xe": 0.9, "tau": 0.05}):
        got = tksz.ksz_radial_function(T(zs), 0.0224, 0.25, params=p, **kw)
        want = jksz.ksz_radial_function(jnp.asarray(zs), 0.0224, 0.25,
                                        params=p, **kw)
        assert _rel(got, want) <= 1e-12
    x = T([1.0, math.inf, -math.inf, math.nan, -2.0])
    assert tksz._sanitize(x).tolist() == [1.0, 0.0, 0.0, 0.0, -2.0]


def test_interpolated_cls_matches_jax_past_lmax():
    """The integer lookup: zero below l = 2, truncation, and inf for l
    beyond lmax."""
    cls = RNG.uniform(1e-6, 1e-4, 3000)
    kss = np.concatenate([[1e-6, 1e-4], np.geomspace(1e-3, 0.5, 40)])
    for chistar in (1500.0, 5999.0, 12000.0):
        got = tksz.get_interpolated_cls(T(cls), chistar, T(kss))
        want = np.asarray(jksz.get_interpolated_cls(jnp.asarray(cls),
                                                    chistar,
                                                    jnp.asarray(kss)))
        np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 0.0 and bool(torch.isinf(got[-1]))


def test_nvv_and_pge_err_match_jax():
    """Nvv_core_integral (plain, errs, robust_term) and pge_err_core on
    Cls that run out inside the kS grid, and finite gradients there."""
    cls = RNG.uniform(1e-6, 1e-4, 1500)
    kss = np.geomspace(0.1, 10.0, 9)
    mu = np.linspace(-1.0, 1.0, 6)
    kL = np.geomspace(1e-3, 0.1, 8)
    pge = RNG.uniform(50.0, 500.0, 9)
    pgg = RNG.uniform(1e3, 1e4, 9)
    chistar, fstar = 1450.0, 3.1
    t = dict(chi_star=chistar, Fstar=fstar, mu=T(mu), kL=T(kL), kSs=T(kss),
             Cls=T(cls))
    j = dict(chi_star=chistar, Fstar=fstar, mu=jnp.asarray(mu),
             kL=jnp.asarray(kL), kSs=jnp.asarray(kss), Cls=jnp.asarray(cls))
    ell = chistar * kss
    assert (ell > cls.size - 1).any() and (ell <= cls.size - 1).any()
    edges = np.array([0.1, 0.5, 2.0, 10.0])

    @jax.jit
    def jax_side(pge, pgg, kss, edges, cls):
        jj = {**j, "kSs": kss, "Cls": cls}
        return (jksz.Nvv_core_integral(Pge=pge, Pgg_tot=pgg, **jj),
                jksz.Nvv_core_integral(Pge=pge, Pgg_tot=pgg, errs=True,
                                       **jj)[0],
                jksz.Nvv_core_integral(Pge=pge, Pgg_tot=pgg,
                                       Pgg_photo_tot=2.0 * pgg,
                                       robust_term=True, **jj),
                jksz.pge_err_core(3.2, 0.05, chistar, 10.0, kss, edges, pgg,
                                  cls))

    want, want_e, want_r, want_p = jax_side(*map(jnp.asarray, (
        pge, pgg, kss, edges, cls)))
    got = tksz.Nvv_core_integral(Pge=T(pge), Pgg_tot=T(pgg), **t)
    assert _rel(got, want) <= 1e-12
    got_e = tksz.Nvv_core_integral(Pge=T(pge), Pgg_tot=T(pgg), errs=True,
                                   **t)
    assert _rel(got_e[0], want_e) <= 1e-12
    got_r = tksz.Nvv_core_integral(Pge=T(pge), Pgg_tot=T(pgg),
                                   Pgg_photo_tot=T(2.0 * pgg),
                                   robust_term=True, **t)
    assert _rel(got_r, want_r) <= 1e-12
    # the inf Cls entries are masked out of the division: finite gradients
    pge_t = T(pge).clone().requires_grad_(True)
    pgg_t = T(pgg).clone().requires_grad_(True)
    tksz.Nvv_core_integral(Pge=pge_t, Pgg_tot=pgg_t, **t).sum().backward()
    assert bool(torch.isfinite(pge_t.grad).all())
    assert bool(torch.isfinite(pgg_t.grad).all())
    assert bool((pge_t.grad[ell > cls.size - 1] == 0).all())
    got = tksz.pge_err_core(3.2, 0.05, chistar, 10.0, T(kss), T(edges),
                            T(pgg), T(cls))
    # the last bin lies past lmax: inf on both sides
    np.testing.assert_allclose(got.numpy(), np.asarray(want_p), rtol=1e-12)
    assert math.isinf(got[-1]) and bool(torch.isfinite(got[:-1]).all())


GROWTH_ZS = np.array([0.05, 0.45, 0.7, 1.6, 3.0])
GROWTH_THETA = np.array([0.127, 2.3e-9])


@pytest.fixture(scope="module")
def jax_growth_rate():
    """JAX's f(z) and d f / d omch2 at GROWTH_THETA in both modes, from
    one compile (f does not depend on As)."""
    def f(theta, mode):
        bg = jbg.background({**jmerge(), **_ov(theta)})
        return jbg.growth_rate_f(bg, jnp.asarray(GROWTH_ZS), mode=mode)

    out = jax.jit(lambda t: {m: jax.jvp(lambda x: f(x, m), (t,),
                                        (jnp.asarray([1.0, 0.0]),))
                             for m in ("closed", "ode")})(
        jnp.asarray(GROWTH_THETA))
    return {m: tuple(np.asarray(a) for a in v) for m, v in out.items()}


@pytest.mark.parametrize("mode", ("closed", "ode"))
def test_growth_rate_f_matches_jax(jax_growth_rate, mode):
    """f(z) and d f / d omch2, forward and reverse mode, against JAX's
    autodiff (closed) and growth_eval (ode); d f / d As is zero; and the
    closed form against ode at LCDM (the JAX package's 1e-6,
    tests/test_background.py)."""
    zs = GROWTH_ZS

    def tf(theta):
        bg = tbg.background({**merge_params(), **_ov(theta)}, "cpu")
        return tbg.growth_rate_f(bg, T(zs), mode=mode)

    f_j, want = jax_growth_rate[mode]
    theta = T(GROWTH_THETA)
    assert _rel(tf(theta), f_j) <= 1e-12
    fwd = torch.autograd.functional.jacobian(tf, theta, vectorize=True,
                                             strategy="forward-mode")
    rev = torch.autograd.functional.jacobian(tf, theta)
    assert _rel(fwd[:, 0], want) <= 1e-12
    assert _rel(rev[:, 0], want) <= 1e-12
    assert bool((fwd[:, 1] == 0).all()) and bool((rev[:, 1] == 0).all())
    bg = tbg.background(merge_params(), "cpu")
    other = "ode" if mode == "closed" else "closed"
    table = tbg.growth_table(bg)
    assert _rel(tbg.growth_rate_f(bg, T(zs), mode=mode, table=table),
                tbg.growth_rate_f(bg, T(zs), mode=other).numpy()) <= 1e-6


def test_linspace_matches_jax():
    """The survey's kL grid, exp(linspace(log kmin, log kL_max, n)) with a
    tensor kmin, written as jax.numpy.linspace writes it."""
    for vol in (4.0, 8.0, 12.0, 16.0):
        kmin = math.pi / (vol * 1e9) ** (1.0 / 3.0)
        for n in (8, 100):
            want = np.asarray(jnp.linspace(jnp.log(jnp.asarray(kmin)),
                                           np.log(0.1), n))
            got = tpipe._linspace(torch.log(T(kmin, dtype=F64)),
                                  math.log(0.1), n)
            assert np.max(np.abs(got.numpy() - want)) <= 1e-14 * np.max(
                np.abs(want))
            assert got[-1] == math.log(0.1)


# ---- the pipelines -------------------------------------------------------

def test_snr_fn_matches_jax(snr_fn, jax_snr_and_jacobian):
    """(snr, Nvv, vrec) at the JAX package's test size: 1e-10."""
    want, _ = jax_snr_and_jacobian
    got = snr_fn(_ov(THETA0), CLS)
    assert snr_fn.device == torch.device("cpu")
    assert got[0].shape == () and got[1].shape == (6, 8)
    for g, w in zip(got, want):
        assert g.dtype == F64 and _rel(g, w) <= 1e-10


def test_snr_jacobian_matches_jax(snr_fn, jax_snr_and_jacobian):
    """d snr / d (omch2, As) by fisher_jacobian (forward mode) and by
    reverse mode against JAX's: 1e-6 (both bisections pass no derivative
    in either package, so a finite difference is no reference)."""
    _, want = jax_snr_and_jacobian
    got = tpipe.fisher_jacobian(lambda ov: snr_fn(ov, CLS)[0],
                                _ov(THETA0), NAMES, device="cpu")
    assert _rel(got, want) <= 1e-6
    om = torch.tensor(THETA0[0], dtype=F64, requires_grad=True)
    snr_fn({"omch2": om, "As": THETA0[1]}, CLS)[0].backward()
    assert abs(float(om.grad) / float(want[0]) - 1.0) <= 1e-6


def test_survey_matches_jax_and_single_bins(snr_fn):
    """Two bins: (total, per-bin snr, bgal) against JAX at 1e-10, each bin
    against the port's own make_ksz_snr_fn at 1e-10, with a bias override
    on one bin, and no vmap fallback."""
    fn = tpipe.make_ksz_survey_fn(2, device="cpu", **CFG)
    jfn = jpipe.make_ksz_survey_fn(2, **CFG)
    bs = np.array([1.7, -1.0])
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*batching rule.*")
        got = fn({}, ZC, VOLS, NGALS, CLS)
        got_bs = fn({}, ZC, VOLS, NGALS, CLS, bs=bs)
    # bs=None is the sentinel -1 on every bin (one JAX compile for both)
    for g, w in zip(got, jfn({}, ZC, VOLS, NGALS, CLS, bs=-np.ones(2))):
        assert _rel(g, w) <= 1e-10
    for g, w in zip(got_bs, jfn({}, ZC, VOLS, NGALS, CLS, bs=bs)):
        assert _rel(g, w) <= 1e-10
    assert got_bs[1][1] == got[1][1] and got_bs[1][0] != got[1][0]
    for i in range(2):
        one = tpipe.make_ksz_snr_fn(ZC[i], VOLS[i], NGALS[i], device="cpu",
                                    **CFG)
        assert _rel(got[1][i], one({}, CLS)[0]) <= 1e-10
    assert fn.device == torch.device("cpu")


def test_batched_snr_matches_single_calls(snr_fn):
    """A B = 2 batch over (omch2, As) through bind_args, row by row
    against single calls: 1e-12."""
    theta = np.column_stack([RNG.uniform(0.11, 0.13, 2),
                             RNG.uniform(2.0e-9, 2.4e-9, 2)])
    one = tpipe.bind_args(snr_fn, CLS)
    assert one.device == snr_fn.device
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*batching rule.*")
        out = tpipe.make_batched_fn(one, NAMES)(theta)
    for i, row in enumerate(theta):
        for o, s in zip(out, snr_fn(_ov(row), CLS)):
            assert _rel(o[i], s) <= 1e-12


@pytest.mark.gpu
def test_resample_kernel_at_the_ksz_shape_on_card():
    """pair_lerp_f64 at the bench kSZ shape (500 rows x 2,049 kt -> 101 k)
    and the survey's (4 x 500 rows x 1,025 kt), against its plain version
    bit for bit, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    ks = T(np.geomspace(0.1, 10.0, 101)).to(dev)
    for shape, nxs in (((1, 500), 4096), ((4, 500), 2048)):
        u = T(RNG.standard_normal((*shape, nxs // 2 + 1))).to(dev)
        scales = T(RNG.uniform(0.003, 3.0, shape)).to(dev)
        dkt = 2.0 * math.pi / 20.0 * nxs / (nxs - 1)
        n0 = rk.pair_lerp_f64.launches
        got = rk.pair_lerp_f64(u, scales, ks, dkt)
        torch.cuda.synchronize()
        assert got.is_cuda and rk.pair_lerp_f64.launches == n0 + 1
        assert torch.equal(got, rk.pair_lerp_plain(u, scales, ks, dkt))
