"""PyTorch port, CMB lensing: models/lensed_cls.py (the first-order
convolution), models/lensed_cf.py (the resummed correlation-function
method), models/lensing_noise.py (instrument noise, the Hu-Okamoto N0
family, the full-sky TT N0, N1, iterative EB delensing) and the
tabulated paths of ``Cosmology.get_cmb_cls`` / ``cmb_lensing_kk_exact``,
against the JAX package on the CPU at small sizes (lmax 800, quadrature
orders 64, N1 at orders 16 / 16 / 16 / 8, lensed_cf at lmax 400 with
1,024 thetas), with inputs made by numpy from a seed.  The JAX side runs
under ``jax.jit`` where the function allows it (the host-side spline,
iteration and per-L loops of the JAX package run as they are).  Both
sides are float64 with the same algorithm: 1e-10 element by element
(``_close``); lensed_cf's outputs 1e-10 of each spectrum's largest value
(its J2-J6 come from an upward recurrence with absolute error at the
~1e-13 level of the seeds); ``n0_tt_fullsky`` 1e-9 (its 3j^2 go through
log-gamma); ``n0_eb_iterative`` stops after as many iterations as JAX."""

import numpy as np
import pytest
import torch

import jax
from hmvec_tpu.models import cosmology as jcos
from hmvec_tpu.models import lensed_cf as jlf
from hmvec_tpu.models import lensed_cls as jlc
from hmvec_tpu.models import lensing_noise as jln

from hmvec_tpu_torch.models import cosmology as tcos
from hmvec_tpu_torch.models import lensed_cf as tlf
from hmvec_tpu_torch.models import lensed_cls as tlc
from hmvec_tpu_torch.models import lensing_noise as tln

RNG = np.random.default_rng(97)
T = torch.as_tensor
GATE = 1e-10
GATE_FULLSKY = 1e-9
LMAX = 800
ORDERS = dict(n_l=64, n_theta=64)
# lmax given: the JAX family reads it off the spectra on the host otherwise
FAMILY = dict(lmin=30, lmax=LMAX, **ORDERS)
LS = np.unique(np.geomspace(20, 600, 8).astype(int)).astype(float)
FIXTURE = "tests/fixtures/camb_table_fixture.npz"


def _synthetic_cls():
    """Smooth CMB-like TT/EE/TE (the recipe of tests/test_lensing_noise.py,
    with a TE made the same way) and a C_phiphi ~ L^-4 beyond L ~ 60, a
    few percent of noise from the seed on each."""
    l = np.arange(LMAX + 1, dtype=np.float64)
    ls = np.maximum(l, 1.0)
    wig = lambda: 1.0 + 0.02 * RNG.uniform(size=l.size)
    dl_tt = 2500.0 * np.exp(-((l / 1800.0) ** 2)) \
        * (1.0 + 0.25 * np.sin(l / 48.0)) + 20.0
    dl_ee = 40.0 * np.exp(-((l / 1500.0) ** 2)) \
        * (1.0 + 0.4 * np.sin(l / 48.0 + 1.0)) + 0.5
    dl_te = 100.0 * np.exp(-((l / 1500.0) ** 2)) * np.sin(l / 60.0 + 0.3)
    cls = [2.0 * np.pi * d * wig() / (ls * (ls + 1.0))
           for d in (dl_tt, dl_ee, dl_te)]
    clpp = 2e-9 / ((ls / 60.0) ** 4 + (ls / 60.0) ** 2) * wig()
    for c in (*cls, clpp):
        c[:2] = 0.0
    return (*cls, clpp)


CL_TT, CL_EE, CL_TE, CLPP = _synthetic_cls()
ELLS = np.arange(LMAX + 1, dtype=np.float64)
NL_T = np.asarray(jln.white_noise_nl(ELLS, 10.0, 1.4))
NL_P = np.asarray(jln.white_noise_nl(ELLS, 10.0 * np.sqrt(2.0), 1.4))
GRAD = {"TT": CL_TT, "EE": CL_EE, "TE": CL_TE}
TOTAL = {"TT": CL_TT + NL_T, "EE": CL_EE + NL_P, "BB": NL_P.copy(),
         "TE": CL_TE}
UNLENSED = np.stack([CL_TT, CL_EE, np.zeros_like(CL_TT), CL_TE], -1)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    # the first transcendental calls of the process, on both threads
    torch.lgamma(torch.linspace(1.0, 9.0, 4096, dtype=torch.float64))
    torch.sin(torch.linspace(0.0, 9.0, 4096, dtype=torch.float64))
    yield
    torch.set_num_threads(old)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want):
    """Max error of got against want along the last axis, row by row:
    relative, element by element, on a row that keeps one sign and holds
    no zero; relative to the row's largest |want| on a row that changes
    sign or holds exact zeros (an all-zero row: absolute)."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    err = np.abs(got - want)
    one_sign = np.all(want > 0.0, -1) | np.all(want < 0.0, -1)
    row_max = np.max(np.abs(want), -1)
    scale = np.where(one_sign[..., None], np.abs(want),
                     np.where(row_max > 0.0, row_max, 1.0)[..., None])
    return float(np.max(err / scale))


def _rowmax(got, want):
    """Max error along the last axis relative to the row's largest
    |want|."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.max(np.abs(want), -1, keepdims=True)
    return float(np.max(np.abs(got - want) / np.where(scale > 0, scale, 1)))


def _t(d):
    return {k: T(v) for k, v in d.items()}


# ---- lensed spectra ------------------------------------------------------------

def test_lens_cls_flat_sky_matches_jax():
    """The first-order convolution (the JAX side maps over the nodes and
    splines on the host) and lensed_bb_from_ee; spectra as rows."""
    want = jlc.lens_cls_flat_sky(UNLENSED, CLPP, lmax_out=600, n_phi=64)
    got = tlc.lens_cls_flat_sky(T(UNLENSED), T(CLPP), lmax_out=600, n_phi=64)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert _close(got.T[:, 2:], want.T[:, 2:]) <= GATE
    assert not got[:2].any()
    bb = tln.lensed_bb_from_ee(T(CL_EE), T(CLPP), lmax_out=600, n_phi=64)
    assert _close(bb[2:], jln.lensed_bb_from_ee(CL_EE, CLPP, lmax_out=600,
                                                n_phi=64)[2:]) <= GATE
    assert np.array_equal(tlc.default_l_nodes(600),
                          jlc.default_l_nodes(600))


def test_lens_cls_flat_sky_resummed_matches_jax():
    """The resummed correlation-function method at lmax 400 (1,024
    thetas), and its displacement correlations."""
    unl, cpp = UNLENSED[:401], CLPP[:401]
    want = jax.jit(lambda u, c: jlf.lens_cls_flat_sky_resummed(
        u, c, lmax_out=300, n_theta=1024))(unl, cpp)
    got = tlf.lens_cls_flat_sky_resummed(T(unl), T(cpp), lmax_out=300,
                                         n_theta=1024)
    assert _rowmax(got.T, np.asarray(want).T) <= GATE
    th = np.geomspace(1e-4, 0.5, 40)
    want_d = jax.jit(jlf.displacement_correlations)(cpp, th)
    got_d = tlf.displacement_correlations(T(cpp), T(th))
    for g, w in zip(got_d, want_d):
        assert _rowmax(g, w) <= GATE


def test_jn_even_upto6_matches_jax():
    """J0-J6 on the series branch, the recurrence and the modulus-phase
    side of x = 8, relative to each function's largest value.  At x = 0.2,
    the first point of the upward recurrence, J6 carries the seeds' ulp
    differences amplified by prod_k 2k/x ~ 1.2e7 in either package
    (measured 2.9e-10 of the row's largest value; J0-J4 at most 6,000
    times): J6 is held to 1e-9 there."""
    x = np.concatenate([[0.0, 0.1, 0.19999, 0.2, 7.999, 8.0, 8.001],
                        RNG.uniform(0.0, 400.0, 200)])
    want = jax.jit(jlf._jn_even_upto6)(x)
    got = tlf._jn_even_upto6(T(x))
    for n, g, w in zip((0, 2, 4, 6), got, want):
        assert _rowmax(g, w) <= (GATE if n < 6 else 1e-9), n


# ---- lensing noise -------------------------------------------------------------

def test_noise_spectra_match_jax():
    want = (jln.white_noise_nl(ELLS, 10.0, 1.4),
            jln.total_cl_tt(CL_TT, 7.0, 2.0),
            jln.n0_kappa_from_phi(LS, LS**-3.0),
            jln.n0_minimum_variance([LS**-3.0, 2.0 * LS**-2.5]))
    got = (tln.white_noise_nl(T(ELLS), 10.0, 1.4),
           tln.total_cl_tt(T(CL_TT), 7.0, 2.0),
           tln.n0_kappa_from_phi(T(LS), T(LS**-3.0)),
           tln.n0_minimum_variance([T(LS**-3.0), T(2.0 * LS**-2.5)]))
    for g, w in zip(got, want):
        assert _close(g, w) <= GATE


@pytest.mark.parametrize("est", ["TT", "EE", "EB"])
def test_n0_flat_sky_matches_jax(est):
    grad = CL_TT if est == "TT" else CL_EE
    tot = TOTAL["TT"] if est == "TT" else TOTAL["EE"]
    tot2 = TOTAL["BB"] if est == "EB" else tot
    want = jax.jit(lambda g, a, b: jln.n0_flat_sky(
        LS, est, g, a, b, lmin=30, lmax=LMAX, **ORDERS))(grad, tot, tot2)
    got = tln.n0_flat_sky(LS, est, T(grad), T(tot), T(tot2), lmin=30,
                          lmax=LMAX, **ORDERS)
    assert _close(got, want) <= GATE


@pytest.mark.parametrize("mode", ["grad", "curl"])
@pytest.mark.parametrize("est", ["TT", "TE", "EE", "EB", "TB"])
def test_n0_pair_flat_sky_matches_jax(est, mode):
    want = jax.jit(lambda g, t: jln.n0_pair_flat_sky(
        LS, est, g, t, mode=mode, **FAMILY))(GRAD, TOTAL)
    got = tln.n0_pair_flat_sky(LS, est, _t(GRAD), _t(TOTAL), mode=mode,
                               **FAMILY)
    assert _close(got, want) <= GATE


def test_n0_cross_mv_and_te_simple_match_jax():
    def run(mod, g, t, Ls):
        n_mv, N = mod.n0_mv_flat_sky(Ls, g, t, return_matrix=True, **FAMILY)
        return (mod.n0_cross_flat_sky(Ls, "TT", "TE", g, t, **FAMILY),
                mod.n0_cross_flat_sky(Ls, "EB", "TB", g, t, mode="curl",
                                      **FAMILY),
                n_mv, N.reshape(N.shape[0], -1),
                *mod.n0_te_simple_flat_sky(Ls, g, t, **FAMILY))

    want = jax.jit(lambda g, t, Ls: run(jln, g, t, Ls))(GRAD, TOTAL, LS)
    got = run(tln, _t(GRAD), _t(TOTAL), T(LS))
    for i, (g, w) in enumerate(zip(got, want)):
        assert _close(g, w) <= GATE, i


def test_n0_tt_fullsky_matches_jax():
    """At L = 20, 300 and 600 to lmax 800 (one chunk of l1 rows each)."""
    Ls = np.array([20.0, 300.0, 600.0])
    want = jln.n0_tt_fullsky(Ls, CL_TT, TOTAL["TT"], lmin=30, lmax=LMAX)
    got = tln.n0_tt_fullsky(T(Ls), T(CL_TT), T(TOTAL["TT"]), lmin=30,
                            lmax=LMAX)
    assert _close(got, want) <= GATE_FULLSKY


def test_n0_tt_fullsky_chunks_sum_the_same(monkeypatch):
    """Cut into chunks of 97 l1 rows, the sum over l1 agrees with one
    chunk to float64's rounding."""
    Ls = T([300.0])
    whole = tln.n0_tt_fullsky(Ls, T(CL_TT), T(TOTAL["TT"]), lmax=LMAX)
    monkeypatch.setattr(tln, "_CHUNK_ELEMENTS", 97 * 601)
    cut = tln.n0_tt_fullsky(Ls, T(CL_TT), T(TOTAL["TT"]), lmax=LMAX)
    assert _close(cut, whole) <= 1e-13


def test_n1_tt_flat_sky_matches_jax():
    orders = dict(n_l=16, n_theta=16, n_s=16, n_alpha=8)
    want = jln.n1_tt_flat_sky(LS[[0, 4, 7]], CL_TT, TOTAL["TT"], CLPP,
                              lmin=30, lmax=LMAX, **orders)
    got = tln.n1_tt_flat_sky(T(LS[[0, 4, 7]]), T(CL_TT), T(TOTAL["TT"]),
                             T(CLPP), lmin=30, lmax=LMAX, **orders)
    assert _close(got, want) <= GATE


@pytest.mark.parametrize("tol,n_iter", [(2e-2, 8), (1e-9, 3)])
def test_n0_eb_iterative_matches_jax(tol, n_iter):
    """The host loop stops after as many iterations as JAX's, by its tol
    test (first case) or at n_iter (second), and every output agrees."""
    kw = dict(lmin=30, lmax=600, tol=tol, n_iter=n_iter, n_phi=64,
              return_info=True, **ORDERS)
    want, winfo = jln.n0_eb_iterative(LS, CL_EE, TOTAL["EE"], CLPP, NL_P,
                                      **kw)
    got, ginfo = tln.n0_eb_iterative(T(LS), T(CL_EE), T(TOTAL["EE"]),
                                     T(CLPP), T(NL_P), **kw)
    assert ginfo["iters"] == winfo["iters"]
    assert (ginfo["iters"] < n_iter) if tol > 1e-3 else \
        (ginfo["iters"] == n_iter)
    assert _close(got, want) <= GATE
    for key in ("n0_first", "n0_nodes", "nodes"):
        assert _close(ginfo[key], winfo[key]) <= GATE, key
    assert _close(ginfo["cl_bb_res"][2:], winfo["cl_bb_res"][2:]) <= GATE
    assert _rowmax(ginfo["rho2"], winfo["rho2"]) <= GATE


# ---- tabulated CMB spectra -----------------------------------------------------

@pytest.mark.parametrize("lmax", [500, 800])
def test_get_cmb_cls_from_a_table_matches_jax(lmax):
    """The CAMB fixture (lmax 600): cut at 500, NaN-padded to 800; the
    exact C_kk's 2 pi / 4 conversion."""
    table = dict(np.load(FIXTURE))
    jc = jcos.Cosmology(cls_table=table)
    tc = tcos.Cosmology(cls_table=table, device="cpu")
    want, got = jc.get_cmb_cls(lmax=lmax), tc.get_cmb_cls(lmax=lmax)
    assert set(got) == set(want) == {"total", "unlensed_scalar",
                                     "lens_potential"}
    for key, w in want.items():
        g = _np(got[key])
        assert got[key].device.type == "cpu" and g.shape == w.shape
        assert np.array_equal(np.isnan(g), np.isnan(w))
        assert np.array_equal(g[~np.isnan(g)], w[~np.isnan(w)])
    (we, wk), (ge, gk) = jc.cmb_lensing_kk_exact(lmax), \
        tc.cmb_lensing_kk_exact(lmax)
    assert np.array_equal(_np(ge), we)
    assert np.array_equal(np.isnan(_np(gk)), np.isnan(wk))
    assert np.array_equal(_np(gk)[~np.isnan(wk)], wk[~np.isnan(wk)])


def test_get_cmb_cls_without_a_table_refuses():
    """Without a table: the JAX package's refusal, and approx=True (the
    boltzlite solver) names the Boltzmann group still to be ported."""
    tc = tcos.Cosmology(device="cpu")
    with pytest.raises(NotImplementedError, match="cls_table"):
        tc.get_cmb_cls(lmax=300)
    with pytest.raises(NotImplementedError, match="boltz group"):
        tc.get_cmb_cls(lmax=300, approx=True)
    with pytest.raises(NotImplementedError, match="lensing potential"):
        tc.cmb_lensing_kk_exact(300)
