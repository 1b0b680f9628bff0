"""PyTorch port, the projected-field kSZ^2 group: every function of
models/projfield.py against the JAX package on the CPU, on a small
HaloModel at the JAX suite's shared shape (3 z, 80 m, 64 k; the electron
profile at nxs 500, an HOD, the fast NFW profile), with inputs made by
numpy from a seed.  The JAX instance holds the torch instance's tables
(linear power, n(z, m), b(z, m), u(k), the HOD grids;
``_torch_jax.jax_halo_model_of``), so the test holds what this group adds
(the tables are held against the JAX class by
tests/test_torch_halo_model.py); every JAX call runs under one
``jax.jit``.  Both sides are float64 with the same
algorithm: 1e-10, element by element relative (``_close``); the fast NFW
leg 1e-5.

The card test (``-m gpu``) holds the group on the card against the CPU:

    python -m pytest --noconftest -m gpu tests/test_torch_projfield.py
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from hmvec_tpu.models import projfield as jpf
    from _torch_jax import jax_halo_model_of
except ImportError:    # a machine with the card and no JAX: the tests
    jnp = None         # marked gpu need none of it (run them with -m gpu)

import hmvec_tpu_torch
from hmvec_tpu_torch.models import halo_model as thm
from hmvec_tpu_torch.models import projfield as tpf
from hmvec_tpu_torch.ops import nfw_kernels as nk
from hmvec_tpu_torch.ops import resample_kernels as rk

ZS = np.array([0.3, 0.65, 1.0])    # the JAX suite's shared shape
MS = np.geomspace(2e10, 1e16, 80)
KS = np.geomspace(1e-3, 30.0, 64)
RNG = np.random.default_rng(97)
GATE = 1e-10
FAST_GATE = 1e-5
# the filter of examples/projected_field_ksz2.py on l = 2..4,000
FGRID = np.arange(2.0, 4001.0)
CL_TT = 2.0 * np.pi * 2500.0 / (FGRID * (FGRID + 1.0) ** 2) \
    * np.exp(-((FGRID / 3500.0) ** 2))
NL_T = 2e-5 * np.exp(FGRID * (FGRID + 1.0) * 1.6e-7)
FVALS = np.exp(-0.5 * (FGRID * 1.4 * np.pi / 10800.0 / 2.355) ** 2) \
    / (CL_TT + NL_T)
CL_TT_INT = np.concatenate([[0.0, 0.0], CL_TT])        # on l = 0..4,000
CL_XG = np.concatenate([[0.0, 0.0], 1e-7 / (FGRID + 20.0) ** 1.5
                        * (1.0 + 0.1 * RNG.standard_normal(FGRID.size))])
ELLS = np.array([100.0, 400.0, 900.0])
NODES = dict(n_radial=16, n_angle=8)
DNDZ = np.exp(-0.5 * ((ZS - 0.6) / 0.25) ** 2)
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


def _close(got, want):
    """Max error of got against want along the last axis, row by row:
    relative, element by element, on a row that keeps one sign and holds
    no zero; relative to the row's largest |want| on a row that changes
    sign or holds exact zeros."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    one_sign = np.all(want > 0.0, -1) | np.all(want < 0.0, -1)
    row_max = np.max(np.abs(want), -1)
    scale = np.where(one_sign[..., None], np.abs(want),
                     np.where(row_max > 0.0, row_max, 1.0)[..., None])
    return float(np.max(np.abs(got - want) / scale))


def _build(device):
    hm = thm.HaloModel(ZS, KS, ms=MS, device=device)
    hm.add_battaglia_profile("e", family="AGN", nxs=500, xmax=12)
    hm.add_hod("g", ngal=np.full(ZS.size, 1e-4))
    hm.add_nfw_profile("nfw_fast", fast=True)
    return hm


@pytest.fixture(scope="module")
def th():
    return _build("cpu")


@pytest.fixture(scope="module")
def jh(th):
    """The JAX class on the same grids, holding the torch instance's
    tables."""
    return jax_halo_model_of(th)


def _b_smooth(m):
    """A closed-form test bispectrum (l1, l2, l3) -> b in module m's array
    library: positive, smooth, not symmetric in its legs."""
    def b(l1, l2, l3):
        return (1.0 + l1 / 300.0) / (1.0 + (l2 / 700.0) ** 2) \
            * (1.0 + 1e-3 * l3) ** -1.5
    return b


def _f_callable(l):
    return (l / 1000.0) * (1.0 + (l / 1500.0) ** 4) ** -1


def _calls(m, hm, cpu, port=True):
    """Every function of the group in module m on the instance hm (cpu:
    the keyword a free function of the port needs for host data); with
    ``port``, also the calls that the test holds against others of the
    port (chunked output ells, the fast NFW leg), which the JAX side need
    not compile."""
    table = (FGRID, FVALS)
    l1 = RNG_L[0]
    snr_in = (ELLS, np.array([1e-9, 2e-9, 1.5e-9]),
              np.array([2e-6, 3e-6, 4e-6]), np.array([1e-4, 8e-5, 5e-5]))
    out = {
        "filter": m.filter_from_table(FGRID, FVALS, **cpu)(l1),
        "fbc_table": m.filtered_bispectrum_cl(
            ELLS, table, _b_smooth(m), 2.0, 4000.0, **NODES, **cpu),
        "fbc_callable": m.filtered_bispectrum_cl(
            np.array([0.0, 250.0, 700.0, 1400.0]), _f_callable,
            _b_smooth(m), 30.0, 5000.0, n_radial=40, n_angle=12, **cpu),
        "b_lens": m.bispectrum_ttg_lensing(CL_TT_INT, CL_XG, **cpu)(
            *RNG_L),
        "t2_lensing": m.cl_t2_lensing(ELLS, table, CL_TT_INT, CL_XG, 2.0,
                                      4000.0, **cpu),
        "t2_t2": m.cl_t2_t2_gaussian(ELLS, table, CL_TT_INT + 2e-5, 2.0,
                                     4000.0, **cpu),
        "snr": m.ksz2_snr(*snr_in, 0.4, **cpu),
        "snr_dl": m.ksz2_snr(*snr_in, 0.3, delta_ell=np.array(
            [100.0, 300.0, 500.0]), **cpu),
        "vrms2": m.vrms2_linear(hm),
        "vrms2_grid": m.vrms2_linear(hm, zs=ZS[:2],
                                     kLs=np.geomspace(1e-3, 1.0, 50)),
        "windows": m.ksz_t_windows(hm)[:2],
        "windows_g": m.ksz_t_windows(hm, gdndz=DNDZ, xe=0.9, tau=0.05,
                                     gasfrac=0.8,
                                     vrms2=np.array([1e-6, 2e-6, 3e-6]))[:2],
        "ksz2_g": m.cl_ksz2_galaxy(hm, ELLS, table, gdndz=DNDZ, **NODES),
    }
    # the rest on one vrms2 (the default's, held above), so that the JAX
    # side compiles the linear-theory integral once
    vr = out["vrms2"]
    out["hybrid_2h"] = m.hybrid_bispectrum_ttg(hm, *RNG_L, gdndz=DNDZ,
                                               terms="2h", vrms2=vr)
    out["ksz2_k"] = m.cl_ksz2_kappa(hm, ELLS, table, vrms2=vr, **NODES)
    if port:
        out["fbc_chunk"] = m.filtered_bispectrum_cl(
            ELLS, table, _b_smooth(m), 2.0, 4000.0, ell_chunk=2, **NODES,
            **cpu)
        out["ksz2_g_chunk"] = m.cl_ksz2_galaxy(hm, ELLS, table, gdndz=DNDZ,
                                               ell_chunk=2, **NODES)
        out["ksz2_k_fast"] = m.cl_ksz2_kappa(hm, ELLS, table, vrms2=vr,
                                             name_matter="nfw_fast", **NODES)
    return out


# seeded triangles (l1, l2, l3) for the bispectrum factories
RNG_L = tuple(RNG.uniform(50.0, 3000.0, 24) for _ in range(3))


@pytest.fixture(scope="module")
def jax_calls(jh):
    """The JAX side, one compiled program; the chunked calls are held to
    the JAX whole ones, the fast NFW leg to the JAX analytic NFW's."""
    out = jax.jit(lambda: _calls(jpf, jh, {}, port=False))()
    out["fbc_chunk"] = out["fbc_table"]
    out["ksz2_g_chunk"] = out["ksz2_g"]
    out["ksz2_k_fast"] = out["ksz2_k"]
    return out


def test_every_function_matches_jax(th, jax_calls):
    got = _calls(tpf, th, {"device": "cpu"})
    assert sorted(got) == sorted(jax_calls)
    for key, g in got.items():
        gs = g if isinstance(g, tuple) else (g,)
        ws = jax_calls[key] if isinstance(jax_calls[key], tuple) \
            else (jax_calls[key],)
        gate = FAST_GATE if key.endswith("_fast") else GATE
        for i, (a, b) in enumerate(zip(gs, ws)):
            assert a.device.type == "cpu", key
            e = _close(a, b)
            assert e <= gate, (key, i, e)


def test_refusals_match_jax(th):
    with pytest.raises(ValueError, match=">= 2 redshifts"):
        tpf.ksz_t_windows(th, zs=np.array([0.5]))
    with pytest.raises(ValueError, match="lmin/lmax are required"):
        tpf.cl_ksz2_galaxy(th, ELLS, _f_callable)
    with pytest.raises(ValueError, match="lmin/lmax are required"):
        tpf.cl_ksz2_kappa(th, ELLS, _f_callable, lmin=30.0)


def test_free_functions_run_on_the_card_for_host_data(th):
    """The free functions take the package's device rule: the card for
    host data alone (on a machine without one, making the first tensor
    fails), a tensor argument's device otherwise; a HaloModel's functions
    run on its device."""
    calls = (lambda: tpf.filtered_bispectrum_cl(
                 ELLS, (FGRID, FVALS), _b_smooth(tpf), 2.0, 4000.0,
                 **NODES),
             lambda: tpf.cl_t2_t2_gaussian(ELLS, (FGRID, FVALS),
                                           CL_TT_INT, 2.0, 4000.0),
             lambda: tpf.ksz2_snr(ELLS, ELLS, ELLS, ELLS, 0.4)[1])
    for call in calls:
        if torch.cuda.is_available():
            assert call().is_cuda
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                call()
    got = tpf.ksz2_snr(T(ELLS), ELLS, ELLS, ELLS, 0.4)[1]
    assert got.device.type == "cpu"
    assert tpf.vrms2_linear(th).device.type == "cpu"


# ---- on the card -----------------------------------------------------------------

@pytest.mark.gpu
def test_projfield_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cpu = _build("cpu")
    before = (nk.nfw_uk_fast.launches, rk.pair_lerp_f64.launches)
    gpu = _build("cuda")
    assert (nk.nfw_uk_fast.launches - before[0],
            rk.pair_lerp_f64.launches - before[1]) == (1, 1)
    before = (nk.nfw_uk_fast.launches, rk.pair_lerp_f64.launches)
    got = _calls(tpf, gpu, {})
    want = _calls(tpf, cpu, {"device": "cpu"})
    assert (nk.nfw_uk_fast.launches, rk.pair_lerp_f64.launches) == before
    for key, g in got.items():
        gs = g if isinstance(g, tuple) else (g,)
        ws = want[key] if isinstance(want[key], tuple) else (want[key],)
        gate = FAST_GATE if key.endswith("_fast") else GATE
        for a, b in zip(gs, ws):
            assert a.is_cuda and _close(a, b) <= gate, key
    assert hmvec_tpu_torch.ksz2_snr(ELLS, ELLS, ELLS, ELLS, 0.4)[1].is_cuda
