"""PyTorch port, the exact (non-Limber) C_ell group: the rest of
ops/fftlog.py (the multi-l transform, the log-sampled profile transform,
projected_correlation) and models/nonlimber.py, with the five Cosmology
methods on them, against the JAX package on the CPU at small sizes
(384-point chi grids, ells <= 30), with inputs made by numpy from a seed.
The JAX side of each test runs under one ``jax.jit``.  Both sides are
float64 (complex128 FFTs) with the same algorithm: 1e-10, element by
element relative (``_close``: relative to the row's largest value only
along a row that changes sign or holds exact zeros).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hmvec_tpu import params as jpar
from hmvec_tpu.models import background as jbg
from hmvec_tpu.models import cosmology as jcos
from hmvec_tpu.models import nonlimber as jnl
from hmvec_tpu.ops import fftlog as jfft
from _torch_jax import Prefetch

import hmvec_tpu_torch
from hmvec_tpu_torch import params as tpar
from hmvec_tpu_torch.models import background as tbg
from hmvec_tpu_torch.models import cosmology as tcos
from hmvec_tpu_torch.models import nonlimber as tnl
from hmvec_tpu_torch.ops import fftlog as tfft

RNG = np.random.default_rng(71)
PARAMS = {"omch2": 0.1198, "As": 2.2e-9, "H0": 67.5}
CHIS = jnl.chi_loggrid(n=384)
ELLS = np.array([2, 3, 5, 8, 12, 18, 30])
GZS = np.linspace(0.15, 1.3, 48)
GDNDZ = np.exp(-0.5 * ((GZS - 0.6) / 0.18) ** 2) + 0.05 * RNG.uniform(size=48)
KS = np.geomspace(1e-4, 30.0, 240)
PK0 = 2.2e4 * (KS / 0.02) / (1.0 + (KS / 0.02) ** 2.6)
ZS_NL = np.linspace(0.05, 2.0, 24)
T = torch.as_tensor
GATE = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want):
    """Max error of got against want along the last axis, row by row:
    relative, element by element, on a row that keeps one sign and holds
    no zero; relative to the row's largest |want| on a row that changes
    sign or holds exact zeros (an all-zero row: the largest |got|)."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    err = np.abs(got - want)
    one_sign = np.all(want > 0.0, -1) | np.all(want < 0.0, -1)
    row_max = np.max(np.abs(want), -1)
    scale = np.where(one_sign[..., None], np.abs(want),
                     np.where(row_max > 0.0, row_max, 1.0)[..., None])
    return float(np.max(err / scale))


def _fft_err(got, want, ks):
    """Max error of a raw FFTLog transform F(k) on its grid ks, taken on
    k^{3/2} F (the irfft's own output, before the exact elementwise
    k^{-3/2}) relative to the row's largest value: an FFT's rounding is
    set by the row's scale, and the k^{-3/2} lifts it at the low-k end
    (element by element, the 1e-13-level ends of a row carry it)."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    dress = np.asarray(ks) ** 1.5
    got, want = got * dress, want * dress
    row_max = np.max(np.abs(want), -1, keepdims=True)
    return float(np.max(np.abs(got - want) / row_max))


FFT_GATE = 1e-13


def _jit(fn, *args):
    """fn(*args) as one compiled JAX program, the arrays of args its
    inputs; what the JAX package forms on the host from a grid it made
    (np.asarray of a jnp grid) is evaluated while tracing."""
    def body(*a):
        with jax.ensure_compile_time_eval():
            return fn(*a)
    return jax.jit(body)(*args)


def _backgrounds(params=PARAMS):
    return (jbg.background(jpar.merge_params(params)),
            tbg.background(tpar.merge_params(params), "cpu"))


# ---- ops/fftlog.py ---------------------------------------------------------

def test_sphbessel_multi_matches_jax():
    """The multi-l transform in complex128 on both sides: at the default
    offset (the first ell's) and at a shared ell = 0 offset."""
    xs = np.geomspace(1e-3, 1e3, 256)
    fx = (np.exp(-((np.log(xs) - RNG.uniform(-1.0, 1.0, (3, 1))) ** 2))
          * RNG.uniform(0.5, 2.0, (3, 1)))
    ells = (0, 1, 2, 5, 12)
    lnkr = jfft.fftlog_lnkr(xs, mu=0.5)
    want = jax.jit(lambda f: [jfft.fftlog_sphbessel_multi(f, xs, ells),
                              jfft.fftlog_sphbessel_multi(f, xs, ells[2:],
                                                          lnkr=lnkr)])(fx)
    got = [tfft.fftlog_sphbessel_multi(T(fx), xs, ells),
           tfft.fftlog_sphbessel_multi(T(fx), xs, ells[2:], lnkr=lnkr)]
    for (gk, gF), (wk, wF) in zip(got, want):
        assert _close(gk, wk) <= 1e-15
        assert gF.shape == (3, len(wF[0]), xs.size)
        assert _fft_err(gF, wF, wk) <= FFT_GATE


def test_profile_transform_matches_jax():
    """The log-sampled profile transform, with a profile on x alone and
    one per (z, m) row, mass-normalized and not, on target ks that run
    off both ends of the reciprocal grid."""
    zs = np.array([0.3, 1.2])
    cmaxs = RNG.uniform(3.0, 9.0, (2, 5))
    rss = RNG.uniform(0.02, 0.4, (2, 5))
    amp = RNG.uniform(0.5, 2.0, (2, 5, 1))
    ks_out = np.geomspace(1e-3, 1e5, 90)

    def nfw(x, lib):
        return 1.0 / (x * (1.0 + x) ** 2)

    def gas(x, lib, amp=amp):
        return lib.asarray(amp) / (1.0 + x[None, None, :] ** 2) ** 2

    want = _jit(lambda c, r: [
        jfft.fftlog_profile_transform(lambda x: nfw(x, jnp), c, r,
                                      zs, ks_out, n=512)[1],
        jfft.fftlog_profile_transform(lambda x: gas(x, jnp), c, r,
                                      zs, ks_out, n=512,
                                      do_mass_norm=False)[1]], cmaxs, rss)
    got = [tfft.fftlog_profile_transform(lambda x: nfw(x, torch), T(cmaxs),
                                         T(rss), T(zs), ks_out, n=512)[1],
           tfft.fftlog_profile_transform(
               lambda x: gas(x, torch, T(amp)), cmaxs, rss, zs, ks_out,
               n=512, do_mass_norm=False, device="cpu")[1]]
    for gv, wv in zip(got, want):
        assert _close(gv, wv) <= GATE


def test_projected_correlation_matches_jax():
    ks = np.geomspace(1e-4, 1e2, 512)
    pk = np.stack([2e4 * (ks / 0.02) / (1.0 + (ks / 0.02) ** e)
                   for e in (2.4, 2.9)])
    wR, wp = _jit(lambda p: jfft.projected_correlation(ks, p, n_t=96), pk)
    gR, gp = tfft.projected_correlation(ks, T(pk), n_t=96)
    assert _close(gR, wR) <= 1e-15
    assert _close(gp, wp) <= GATE
    assert hmvec_tpu_torch.projected_correlation is \
        tfft.projected_correlation


# ---- models/nonlimber.py, piece by piece ------------------------------------

def test_grid_and_recurrence_pieces_match_jax():
    np.testing.assert_array_equal(tnl.chi_loggrid(), jnl.chi_loggrid())
    for n, frac in ((384, 0.03), (97, 0.2), (5, 0.0)):
        np.testing.assert_array_equal(tnl._edge_taper(n, frac),
                                      jnl._edge_taper(n, frac))
    for l in (0, 1, 2, 7, 200):
        assert tnl._jpp_coeffs(l) == jnl._jpp_coeffs(l)
    phi = RNG.uniform(0.5, 1.5, (2, CHIS.size)) * np.exp(
        -0.5 * ((np.log(CHIS) - 7.5) / 0.6) ** 2)
    ells = (0, 1, 2, 5, 11)
    want = jax.jit(lambda p: [
        jnl.bessel_deltas(p, CHIS, ells),
        jnl.bessel_deltas_j2pp(p, CHIS, ells),
        jnl.bessel_deltas_over_x2(p, CHIS, ells[2:], taper_frac=0.1)])(phi)
    got = [tnl.bessel_deltas(T(phi), CHIS, ells),
           tnl.bessel_deltas_j2pp(T(phi), CHIS, ells),
           tnl.bessel_deltas_over_x2(T(phi), CHIS, ells[2:],
                                     taper_frac=0.1)]
    for (gk, gd), (wk, wd) in zip(got, want):
        assert _close(gk, wk) <= 1e-15
        assert _fft_err(gd, wd, wk) <= FFT_GATE
    with pytest.raises(ValueError, match="ells >= 2"):
        tnl.bessel_deltas_over_x2(T(phi), CHIS, (1, 2))


@pytest.mark.parametrize("growth_mode", ["closed", "ode"])
def test_kernels_match_jax(growth_mode):
    """D(z)/D(0), the galaxy kernel (biased and with f), the lensing
    kernel (one source plane and a source distribution), ln P on the
    FFTLog grid beyond both ends of the table, and C_l from deltas."""
    jb, tb = _backgrounds({**PARAMS, "w0": -0.9} if growth_mode == "ode"
                          else PARAMS)
    zg = np.linspace(0.0, 4.0, 33)
    ksg = np.geomspace(1e-6, 1e3, 150)
    d1 = RNG.standard_normal((3, ksg.size)) * np.exp(-(np.log(ksg) ** 2) / 20)
    d2 = RNG.standard_normal((3, ksg.size)) * np.exp(-(np.log(ksg) ** 2) / 20)

    def jax_side():
        tab = jbg.growth_table(jb) if growth_mode == "ode" else None
        return [jnl._growth_ratio(jb, jnp.asarray(zg), growth_mode, tab),
                jnl.galaxy_kernel(jb, CHIS, GZS, GDNDZ, 1.7, growth_mode,
                                  tab),
                jnl.galaxy_kernel(jb, CHIS, GZS, GDNDZ, 1.7, growth_mode,
                                  tab, with_growth_rate=True),
                jnl.lensing_kernel(jb, CHIS, zs=1.1, growth_mode=growth_mode,
                                   table=tab),
                jnl.lensing_kernel(jb, CHIS, zs=GZS, dndz=GDNDZ,
                                   growth_mode=growth_mode, table=tab),
                jnl._lnp_on_grid(ksg, KS, PK0),
                jnl.cl_from_deltas(ksg, d1, d2, KS, PK0)]

    want = jax.jit(jax_side)()
    tab = tbg.growth_table(tb) if growth_mode == "ode" else None
    got = [tnl._growth_ratio(tb, zg, growth_mode, tab),
           tnl.galaxy_kernel(tb, CHIS, GZS, GDNDZ, 1.7, growth_mode, tab),
           tnl.galaxy_kernel(tb, CHIS, GZS, GDNDZ, 1.7, growth_mode, tab,
                             with_growth_rate=True),
           tnl.lensing_kernel(tb, CHIS, zs=1.1, growth_mode=growth_mode,
                              table=tab),
           tnl.lensing_kernel(tb, CHIS, zs=GZS, dndz=GDNDZ,
                              growth_mode=growth_mode, table=tab),
           tnl._lnp_on_grid(T(ksg), T(KS), T(PK0)),
           tnl.cl_from_deltas(ksg, T(d1), T(d2), KS, T(PK0))]
    for i, (gv, wv) in enumerate(zip(got, want)):
        assert _close(gv, wv) <= GATE, (i, _close(gv, wv))


# ---- the spectra -------------------------------------------------------------

SPECTRA = {
    "gg": lambda m, bg, **k: m.C_gg_exact(bg, ELLS, KS, PK0, GZS, GDNDZ,
                                          bias=1.6, chis=CHIS, **k),
    "gg_rsd_smag": lambda m, bg, **k: m.C_gg_exact(
        bg, ELLS, KS, PK0, GZS, GDNDZ, bias=1.6, rsd=True, smag=0.35,
        chis=CHIS, **k),
    "gg_smag_szs": lambda m, bg, **k: m.C_gg_exact(
        bg, ELLS, KS, PK0, GZS, GDNDZ, smag=0.2, szs=GZS + 0.05, chis=CHIS,
        **k),
    "kg": lambda m, bg, **k: m.C_kg_exact(bg, ELLS, KS, PK0, GZS, GDNDZ,
                                          bias=1.3, lzs=1.4, chis=CHIS, **k),
    "kg_rsd": lambda m, bg, **k: m.C_kg_exact(
        bg, ELLS, KS, PK0, GZS, GDNDZ, lzs=GZS, ldndz=GDNDZ, rsd=True,
        chis=CHIS, **k),
    "kk": lambda m, bg, **k: m.C_kk_exact(bg, ELLS, KS, PK0, lzs1=1.1,
                                          chis=CHIS, **k),
    "kk_cross": lambda m, bg, **k: m.C_kk_exact(
        bg, ELLS, KS, PK0, lzs1=GZS, ldndz1=GDNDZ, lzs2=2.0, chis=CHIS, **k),
}


@pytest.mark.parametrize("name,growth_mode", [
    *((n, "closed") for n in SPECTRA),
    ("gg_rsd_smag", "ode"), ("kg_rsd", "ode"), ("kk_cross", "ode")])
def test_exact_spectra_match_jax(name, growth_mode):
    jb, tb = _backgrounds()
    fn = SPECTRA[name]
    want = jax.jit(lambda: fn(jnl, jb, growth_mode=growth_mode))()
    got = fn(tnl, tb, growth_mode=growth_mode)
    assert got.shape == (ELLS.size,)
    assert _close(got, want) <= GATE


def _pzk_nl():
    """A nonlinear-looking P(z, k) on (ZS_NL, KS): the linear shape grown
    by D^2 and boosted at high k."""
    D = 1.0 / (1.0 + ZS_NL)
    boost = 1.0 + (KS / 0.3) ** 1.5
    return (D[:, None] ** 2 * PK0[None, :] * boost[None, :]
            * RNG.uniform(0.95, 1.05, (ZS_NL.size, KS.size)))


PZK_NL = _pzk_nl()


@pytest.mark.parametrize("which", ["gg", "gg_rsd", "kk_cross"])
def test_hybrid_spectra_match_jax(which):
    jb, tb = _backgrounds()

    def run(m, bg, pzk):
        if which == "gg":
            return m.C_gg_hybrid(bg, ELLS, KS, PK0, ZS_NL, pzk, GZS, GDNDZ,
                                 bias=1.5, chis=CHIS)
        if which == "gg_rsd":
            return m.C_gg_hybrid(bg, ELLS, KS, PK0, ZS_NL, pzk, GZS, GDNDZ,
                                 bias=1.5, rsd=True, smag=0.3, chis=CHIS,
                                 growth_mode="ode")
        return m.C_kk_hybrid(bg, ELLS, KS, PK0, ZS_NL, pzk, lzs1=GZS,
                             ldndz1=GDNDZ, lzs2=1.8, chis=CHIS)

    want = jax.jit(lambda p: run(jnl, jb, p))(PZK_NL)
    assert _close(run(tnl, tb, T(PZK_NL)), want) <= GATE


# ---- the Cosmology methods -----------------------------------------------------

METHODS_PARAMS = {**PARAMS, "w0": -0.92}


def _method_calls(c, p):
    """The five Cosmology methods of test_cosmology_methods_match_jax."""
    return [c.C_gg_exact(ELLS, KS, PK0, GZS, GDNDZ, bias=1.4, rsd=True,
                         chis=CHIS),
            c.C_gg_exact(ELLS, KS, PK0, GZS, GDNDZ, chis=CHIS,
                         growth_mode="closed"),
            c.C_kg_exact(ELLS, KS, PK0, GZS, GDNDZ, lzs=1.2, chis=CHIS),
            c.C_kk_exact(ELLS, KS, PK0, lzs1=1.2, chis=CHIS),
            c.C_gg_hybrid(ELLS, KS, PK0, ZS_NL, p, GZS, GDNDZ, bias=1.4,
                          chis=CHIS),
            c.C_kk_hybrid(ELLS, KS, PK0, ZS_NL, p, lzs1=1.2, lzs2=1.2,
                          chis=CHIS)]


def _jax_methods():
    jc = jcos.Cosmology(METHODS_PARAMS)
    return jc.growth_mode, jax.jit(lambda p: _method_calls(jc, p))(PZK_NL)


def _jax_gradient():
    """C_gg_exact (RSD, magnification) and C_kk_exact and their forward
    derivative in omch2, by the JAX package's free functions."""
    def jax_fn(x):
        bg = jbg.background(jpar.merge_params({**PARAMS, "omch2": x}))
        return (jnl.C_gg_exact(bg, ELLS, KS, PK0, GZS, GDNDZ, bias=1.6,
                               rsd=True, smag=0.3, chis=CHIS),
                jnl.C_kk_exact(bg, ELLS, KS, PK0, lzs1=1.1, chis=CHIS))

    return jax.jit(lambda x: jax.jvp(jax_fn, (x,), (1.0,)))(
        jnp.asarray(PARAMS["omch2"]))


@pytest.fixture(autouse=True, scope="module")
def _jax_refs():
    """The JAX sides of the two Cosmology-level tests (~15 s of compile),
    computed by two worker threads from the module's start, beside each
    other and the file's other tests (``_torch_jax.Prefetch``)."""
    pre = Prefetch()
    yield {"methods": pre.submit(_jax_methods),
           "gradient": pre.submit(_jax_gradient)}
    pre.close()


def test_cosmology_methods_match_jax(_jax_refs):
    """The five methods through both classes; under w0 the instance's
    integrated growth is the exact spectra's default, and a call may still
    pick the closed form."""
    tc = tcos.Cosmology(METHODS_PARAMS, device="cpu")
    got = _method_calls(tc, T(PZK_NL))
    mode, want = _jax_refs["methods"].result()
    assert tc.growth_mode == mode == "ode"
    for i, (gv, wv) in enumerate(zip(got, want)):
        assert _close(gv, wv) <= GATE, (i, _close(gv, wv))
    assert not hasattr(tcos.Cosmology.C_gg_exact, "deferred_group")


def test_exact_gradient_matches_jax_jvp(_jax_refs):
    """d/d(omch2) of C_gg_exact (with RSD and magnification) and of
    C_kk_exact, through the background (distances, z(chi), growth),
    against JAX's forward mode."""
    x0 = PARAMS["omch2"]
    (wg, wk), (dg, dk) = _jax_refs["gradient"].result()
    x = torch.tensor(x0, dtype=torch.float64, requires_grad=True)
    tb = tbg.background(tpar.to_torch_params(
        {**tpar.merge_params(PARAMS), "omch2": x}, "cpu"), "cpu")
    gg = tnl.C_gg_exact(tb, ELLS, KS, PK0, GZS, GDNDZ, bias=1.6, rsd=True,
                        smag=0.3, chis=CHIS)
    kk = tnl.C_kk_exact(tb, ELLS, KS, PK0, lzs1=1.1, chis=CHIS)
    assert _close(gg, wg) <= GATE and _close(kk, wk) <= GATE
    jac = [torch.autograd.grad(v, x, retain_graph=True)[0]
           for v in (*gg, *kk)]
    got = torch.stack(jac).reshape(2, ELLS.size)
    assert _close(got, np.stack([dg, dk])) <= 1e-8
