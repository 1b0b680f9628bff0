"""PyTorch port, weak lensing: models/shear.py (the Wigner-d recurrence in
its three forms, xi_+/xi_-, gamma_t and their Gaussian covariance),
models/ia.py (NLA alignments and magnification, with the six Cosmology
methods), models/master.py (pseudo-C_ell coupling, binning, decoupling and
the NKA covariance) and the package root's ``threej000_sq``, against the
JAX package on the CPU at small sizes, with inputs made by numpy from a
seed.  The JAX side of each test runs under one ``jax.jit``.  Both sides
are float64 with the same algorithm: 1e-10 element by element (``_close``:
relative to the row's largest value only along a row that changes sign
or holds zeros); the Wigner sums 1e-10 of their row's largest value;
``threej000_sq`` 1e-9 (its log-gamma sums reach ~4e4, whose absolute
rounding exp turns into relative error)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import hmvec_tpu
from hmvec_tpu import params as jpar
from hmvec_tpu.models import background as jbg
from hmvec_tpu.models import cosmology as jcos
from hmvec_tpu.models import ia as jia
from hmvec_tpu.models import master as jmst
from hmvec_tpu.models import shear as jsh

import hmvec_tpu_torch
from hmvec_tpu_torch import params as tpar
from hmvec_tpu_torch.models import background as tbg
from hmvec_tpu_torch.models import cosmology as tcos
from hmvec_tpu_torch.models import ia as tia
from hmvec_tpu_torch.models import lensing_noise as tln
from hmvec_tpu_torch.models import master as tmst
from hmvec_tpu_torch.models import shear as tsh
from hmvec_tpu_torch.utils import weights as tw

RNG = np.random.default_rng(83)
PARAMS = {"omch2": 0.1198, "As": 2.2e-9, "H0": 67.5}
PARAMS_W = {**PARAMS, "w0": -0.9, "wa": 0.2}
T = torch.as_tensor
GATE = 1e-10
GATE_3J = 1e-9
# the IA inputs of tests/test_ia.py
ZS = np.linspace(0.05, 2.0, 12)
KS = np.geomspace(1e-3, 10.0, 80)
GZS = np.linspace(0.1, 1.8, 36)
DNDZ1 = np.exp(-0.5 * ((GZS - 0.6) / 0.15) ** 2)
DNDZ2 = np.exp(-0.5 * ((GZS - 1.1) / 0.2) ** 2)
ELLS_IA = np.array([40.0, 100.0, 300.0, 900.0])
IA = dict(A_ia=0.9, eta_ia=-0.7, z0=0.62)
PZK = (2.0e4 * (KS / 0.02) / (1.0 + (KS / 0.02) ** 2.6))[None, :] \
    * np.exp(-0.4 * ZS)[:, None] * (1.0 + 0.1 * RNG.uniform(size=(12, 80)))
# shear: consecutive ells and a smooth spectrum
ELLS = np.arange(2, 161)
CL_E = 1e-9 * (ELLS / 100.0) ** -1.2 * (1.0 + 0.2 * np.sin(ELLS / 9.0))
CL_B = 0.05 * CL_E * RNG.uniform(size=ELLS.size)
THETAS = np.geomspace(2e-3, 0.2, 9)
SPINS = [(0, 0), (2, 2), (2, -2), (2, 0)]
LMAX_M = 24


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


def _jit(fn, *args):
    return jax.jit(fn)(*args)


def _backgrounds(params):
    return (jbg.background(jpar.merge_params(params)),
            tbg.background(tpar.merge_params(params), "cpu"))


# ---- the repairs -------------------------------------------------------------

def test_root_threej000_sq_is_lensing_noises():
    """The package root's threej000_sq is lensing_noise's, as in the JAX
    root, and agrees with it on arrays of triangles (valid, odd and
    outside the triangle) up to l = 3,000."""
    assert hmvec_tpu_torch.threej000_sq is tln.threej000_sq
    l1 = RNG.integers(0, 3001, 4000)
    l2 = RNG.integers(0, 3001, 4000)
    l3 = np.abs(l1 - l2) + RNG.integers(0, 60, 4000)
    l1[:3], l2[:3], l3[:3] = [2, 10, 7], [3, 10, 3], [5, 21, 3]
    want = np.asarray(_jit(hmvec_tpu.threej000_sq, l1, l2, l3))
    got = hmvec_tpu_torch.threej000_sq(l1, l2, l3, device="cpu")
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    ok = want != 0.0
    assert ok.sum() > 1000 and (~ok).sum() > 100
    assert np.array_equal(_np(got) != 0.0, ok)
    assert _close(got[T(ok)], want[ok]) <= GATE_3J
    assert abs(float(got[0]) - 10.0 / 231.0) <= 1e-14


def test_free_functions_resolve_the_card_for_host_data():
    """A free function given only host data runs on ``device``, the card
    by default; a tensor argument's own device wins."""
    probe = tw.on_device_of_inputs(lambda *args: tw.call_device())
    assert probe(ELLS, CL_E) == torch.device("cuda")
    assert probe(ELLS, CL_E, device="cpu") == torch.device("cpu")
    assert probe(ELLS, T(CL_E)) == torch.device("cpu")
    assert probe(ELLS, {"e": [CL_E, T(CL_E)]}, device="cuda") \
        == torch.device("cpu")
    out = tsh.wigner_d_sum(ELLS, CL_E, THETAS, (2, 2), device="cpu")
    assert out.device.type == "cpu"
    assert tsh.wigner_d_sum(ELLS, T(CL_E), THETAS, (2, 2)).device.type \
        == "cpu"
    if torch.cuda.is_available():
        assert tsh.wigner_d_sum(ELLS, CL_E, THETAS).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            tsh.wigner_d_sum(ELLS, CL_E, THETAS, (2, 2))


# ---- models/shear.py -----------------------------------------------------------

@pytest.mark.parametrize("mn", SPINS)
def test_wigner_d_rows_match_jax(mn):
    xs = np.concatenate([[-1.0, 1.0], RNG.uniform(-1.0, 1.0, 30)])
    want = _jit(lambda x: jsh.wigner_d_rows(60, x, mn), xs)
    got = tsh.wigner_d_rows(60, T(xs), mn)
    assert _rowmax(got.T, np.asarray(want).T) <= GATE
    assert tsh.wigner_d_rows(1, T(xs), (2, 2)).abs().max() == 0.0


@pytest.mark.parametrize("mn1,mn2", [((0, 0), (0, 0)), ((2, 2), (2, -2)),
                                     ((2, 0), (0, 0)), ((0, 0), (2, 2))])
def test_wigner_d_outer_sum_matches_jax(mn1, mn2):
    th2 = THETAS[::2] * 1.3
    wls = np.stack([CL_E, CL_B]) * (2 * ELLS + 1.0)
    want = _jit(lambda w: jsh.wigner_d_outer_sum(ELLS, w, THETAS, mn1, mn2,
                                                 th2), wls)
    got = tsh.wigner_d_outer_sum(ELLS, T(wls), THETAS, mn1, mn2, th2)
    assert _rowmax(got, want) <= GATE


def test_xi_and_gamma_t_match_jax():
    def run(mod, e, b, l6):
        return (mod.xi_plus(ELLS, e, THETAS),
                mod.xi_plus(ELLS, e, THETAS, cl_b=b),
                mod.xi_minus(ELLS, e, THETAS, cl_b=b),
                mod.xi_plus(ELLS, e, THETAS, input_kind="convergence"),
                mod.xi_minus(ELLS, e, THETAS, input_kind="convergence"),
                mod.gamma_t(ELLS, e, THETAS),
                mod.gamma_t(ELLS, e, THETAS, input_kind="shear"),
                mod.kappa_to_shear_cl_factor(l6))
    l6 = np.arange(6.0)
    want = _jit(lambda e, b, l: run(jsh, e, b, l), CL_E, CL_B, l6)
    got = run(tsh, T(CL_E), T(CL_B), T(l6))
    for g, w in zip(got[:-1], want[:-1]):
        assert _rowmax(g, w) <= GATE
    assert _close(got[-1], want[-1]) <= 1e-15


@pytest.mark.parametrize("kinds", [("plus", "plus"), ("plus", "minus"),
                                   ("gammat", "w")])
def test_xi_gaussian_cov_matches_jax(kinds):
    tot = CL_E + 1e-10
    args = (tot, tot * 1.1, CL_E, CL_B + CL_E)
    want = _jit(lambda *a: jsh.xi_gaussian_cov(ELLS, *a, THETAS, *kinds,
                                               fsky=0.3), *args)
    got = tsh.xi_gaussian_cov(ELLS, *(T(a) for a in args), THETAS, *kinds,
                              fsky=0.3)
    assert _rowmax(got, want) <= GATE


# ---- models/ia.py --------------------------------------------------------------

def _ia_calls(mod, bg, pzk, growth):
    g = dict(growth_mode=growth)
    return {
        "nla_amplitude": mod.nla_amplitude(bg, GZS, **IA, **g),
        "ia_window": mod.ia_window(bg, GZS, DNDZ1, **IA, **g),
        "magnification_window": mod.magnification_window(bg, GZS, GZS,
                                                         DNDZ2, 0.7),
        "C_II": mod.C_II(bg, ELLS_IA, ZS, KS, pzk, GZS, DNDZ1, DNDZ2, **IA,
                         **g),
        "C_II auto": mod.C_II(bg, ELLS_IA, ZS, KS, pzk, GZS, DNDZ1, **IA,
                              **g),
        "C_kI": mod.C_kI(bg, ELLS_IA, ZS, KS, pzk, GZS, DNDZ2, lzs=1100.0,
                         **IA, **g),
        "C_gI": mod.C_gI(bg, ELLS_IA, ZS, KS, pzk, GZS, DNDZ1, DNDZ2, **IA,
                         **g),
        **{f"shear {k}": v for k, v in mod.shear_cls_with_ia(
            bg, ELLS_IA, ZS, KS, pzk, GZS, DNDZ1, DNDZ2, **IA, **g).items()},
        **{f"shear auto {k}": v for k, v in mod.shear_cls_with_ia(
            bg, ELLS_IA, ZS, KS, pzk, GZS, DNDZ1, **IA, **g).items()},
        **{f"gg_mag {k}": v for k, v in mod.C_gg_mag(
            bg, ELLS_IA, ZS, KS, 1.3 * pzk, 1.1 * pzk, pzk, GZS, DNDZ1, 0.6,
            gdndz2=DNDZ2, s_mag2=0.2).items()},
        **{f"kg_mag {k}": v for k, v in mod.C_kg_mag(
            bg, ELLS_IA, ZS, KS, 1.1 * pzk, pzk, GZS, DNDZ1, 0.6,
            lzs=1100.0).items()},
    }


@pytest.mark.parametrize("growth", ["closed", "ode"])
def test_ia_functions_match_jax(growth):
    params = PARAMS if growth == "closed" else PARAMS_W
    jbgd, tbgd = _backgrounds(params)
    want = _jit(lambda p: _ia_calls(jia, jbgd, p, growth), PZK)
    got = _ia_calls(tia, tbgd, T(PZK), growth)
    assert set(got) == set(want)
    for key, w in want.items():
        assert _close(got[key], w) <= GATE, key


@pytest.mark.parametrize("params", [PARAMS, PARAMS_W],
                         ids=["closed", "w0wa"])
def test_cosmology_ia_methods_match_jax(params):
    """The six methods, growth_mode defaulted from the instance (the
    w0/wa instance runs the integrated growth)."""
    jc = jcos.Cosmology(params)
    tc = tcos.Cosmology(params, device="cpu")
    assert tc.growth_mode == jc.growth_mode

    def calls(c, pzk):
        return (c.C_II(ELLS_IA, ZS, KS, pzk, GZS, DNDZ1, **IA),
                c.C_kI(ELLS_IA, ZS, KS, pzk, GZS, DNDZ1, lzs=1100.0, **IA),
                c.C_gI(ELLS_IA, ZS, KS, pzk, GZS, DNDZ2, DNDZ1, **IA),
                c.shear_cls_with_ia(ELLS_IA, ZS, KS, pzk, GZS, DNDZ1,
                                    **IA)["total"],
                c.C_gg_mag(ELLS_IA, ZS, KS, pzk, pzk, pzk, GZS, DNDZ1,
                           0.6)["total"],
                c.C_kg_mag(ELLS_IA, ZS, KS, pzk, pzk, GZS, DNDZ1, 0.6,
                           lzs=1100.0)["total"])

    want = _jit(lambda p: calls(jc, p), PZK)
    got = calls(tc, T(PZK))
    for g, w in zip(got, want):
        assert _close(g, w) <= GATE


# ---- models/master.py ----------------------------------------------------------

def _mask():
    return jmst.cap_mask_cl(2 * LMAX_M, np.deg2rad(40.0))


def test_cap_mask_and_mask_correlation_match_jax():
    xs = RNG.uniform(-1.0, 1.0, 20)
    wl = np.array(_mask())
    want_xi = _jit(jmst.mask_correlation, wl, xs)
    got_wl = tmst.cap_mask_cl(2 * LMAX_M, np.deg2rad(40.0), device="cpu")
    assert _close(got_wl, wl) <= GATE
    assert _rowmax(tmst.mask_correlation(got_wl, xs), want_xi) <= GATE


@pytest.mark.parametrize("spins", [(0, 0), (0, 2), (2, 2)])
def test_coupling_matrix_matches_jax(spins):
    wl = np.array(_mask())
    want = _jit(lambda w: jmst.coupling_matrix(LMAX_M, w, spins), wl)
    got = tmst.coupling_matrix(LMAX_M, T(wl), spins)
    if spins == (2, 2):
        assert set(got) == set(want) == {"++", "--"}
        pairs = [(got[k], want[k]) for k in ("++", "--")]
    else:
        pairs = [(got, want)]
    for g, w in pairs:
        assert g.shape == (LMAX_M + 1, LMAX_M + 1)
        assert _rowmax(g, w) <= GATE


def test_master_chain_matches_jax():
    """Couple, bin and decouple (spin 0 and the spin-2 pair), the NKA
    covariance and its decoupled form, coupling_kernel_xi."""
    wl = np.array(_mask())
    ells = np.arange(LMAX_M + 1.0)
    cl = 1e-6 / (ells + 5.0) ** 1.5 * (1.0 + 0.1 * RNG.uniform(size=ells.size))
    bb = 0.1 * cl
    edges = np.array([2, 6, 10, 15, 20, LMAX_M + 1])
    weights = 1.0 + ells

    def chain(mod, w, c, b, weights):
        m00 = mod.coupling_matrix(LMAX_M, w, (0, 0))
        m22 = mod.coupling_matrix(LMAX_M, w, (2, 2))
        pseudo = mod.couple_cls(m00, c)
        pe, pb = mod.couple_cls(m22, (c, b))
        cov = mod.gaussian_covariance_nka(LMAX_M, w, c, c, c, 1.2 * c)
        B, P = mod.bin_operator(LMAX_M, edges, weights)
        return (pseudo, pe, pb,
                mod.decouple_bandpowers(m00, pseudo, LMAX_M, edges),
                *mod.decouple_bandpowers(m22, (pe, pb), LMAX_M, edges,
                                         weights),
                cov, mod.decoupled_covariance(m00, cov, LMAX_M, edges),
                mod.coupling_kernel_xi(LMAX_M, w), B, P)

    want = _jit(lambda w, c, b: chain(jmst, w, c, b, weights), wl, cl, bb)
    got = chain(tmst, T(wl), T(cl), T(bb), T(weights))
    for i, (g, w) in enumerate(zip(got, want)):
        assert _close(g, w) <= GATE, i
