"""PyTorch port, the covariance group: models/cluster_counts.py,
models/cov.py (with shear.wigner_d_sum), models/bispectrum.py and
models/pairwise.py (with rsd.mean_pairwise_velocity and the j_l FFTLog
transform), and the 11 HaloModel methods on them, against the JAX package
on the CPU at 6 z x 48 m x 48 k, with inputs made by numpy from a seed.
The JAX side of each test runs under one ``jax.jit``, fed with the torch
instance's own grids (n(z, m), b(z, m), u(k), P), so the test holds what
this group adds; the instance's inputs are held against the JAX class by
tests/test_torch_halo_model.py.  Both sides are float64 with the same
algorithm: 1e-10, element by element relative (``_close``: relative to
the row's largest value only along a row that changes sign or holds
exact zeros; a joint counts x C_ell matrix block by block, ``_joint``).

The card test (``-m gpu``) holds this file's build on the card against the
CPU:

    python -m pytest --noconftest -m gpu tests/test_torch_cov_bispectrum.py
"""

import math

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from hmvec_tpu.models import bispectrum as jbsp
    from hmvec_tpu.models import cluster_counts as jcc
    from hmvec_tpu.models import cov as jcov
    from hmvec_tpu.models import halo_model as jhm
    from hmvec_tpu.models import pairwise as jpw
    from hmvec_tpu.models import power as jpwr
    from hmvec_tpu.models import rsd as jrsd
    from hmvec_tpu.models import shear as jshear
    from hmvec_tpu.ops import fftlog as jfft
    from hmvec_tpu.utils.weights import trapz_weights as jtrapz
except ImportError:    # a machine with the card and no JAX: the tests
    jnp = None         # marked gpu need none of it (run them with -m gpu)

from hmvec_tpu_torch.models import background as tbg
from hmvec_tpu_torch.models import bispectrum as tbsp
from hmvec_tpu_torch.models import cluster_counts as tcc
from hmvec_tpu_torch.models import cov as tcov
from hmvec_tpu_torch.models import halo_model as thm
from hmvec_tpu_torch.models import pairwise as tpw
from hmvec_tpu_torch.models import rsd as trsd
from hmvec_tpu_torch.models import shear as tshear
from hmvec_tpu_torch.ops import fftlog as tfft
from hmvec_tpu_torch.ops import nfw_kernels as nk
from hmvec_tpu_torch.ops import resample_kernels as rk

ZS = np.array([0.2, 0.5, 0.8, 1.1, 1.5, 2.0])
MS = np.geomspace(2e10, 1e17, 48)
KS = np.geomspace(1e-4, 100.0, 48)
PARAMS = {"omch2": 0.1198, "As": 2.2e-9}
NGAL = np.full(ZS.size, 1e-4)
RNG = np.random.default_rng(59)
ELLS = np.geomspace(30.0, 3000.0, 12)
Z_EDGES = np.array([0.2, 0.6, 1.0, 1.4])
# the JAX package's own test scaling (tests/test_cluster_counts.py)
SCALING = dict(lnYstar=np.log(2.4e-4), alpha=1.79, beta=2.0 / 3.0,
               Mpivot=6e14, sigma_lnY=0.25)
Q_EDGES = np.array([5.0, 6.0, 8.0, np.inf])
# Z_EDGES with the background bins that joint_counts_cl_cov pads it with
FULL_EDGES = np.array([0.2, 0.6, 1.0, 1.4, 1.7, 2.0])
T = torch.as_tensor
GATE = 1e-10
FAST_GATE = 1e-5

# the methods this group brought out of HaloModel.DEFERRED
PORTED = ("get_mean_compton_y", "get_tau_aperture", "get_bispectrum",
          "get_angular_bispectrum", "cluster_counts_obs",
          "cluster_counts_q_bins", "cluster_counts_covariance",
          "joint_counts_cl_cov", "get_cl_cov_t1h", "get_cl_cov_ssc",
          "get_pk_covariance")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got / want - 1.0)))


def _to_max(got, want):
    """Max abs difference over the largest |want| (for an all-zero want,
    the largest |got|)."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    return err / scale if scale > 0.0 else err


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


def _joint(got, want, nb):
    """``_close`` on each block of a joint (counts, C_ell) covariance with
    ``nb`` count bins: the counts block, the counts x C_ell block (a row per
    count bin; its transpose, the other off-diagonal block, likewise) and
    the C_ell block, each on its own scale."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return max(_close(got[:nb, :nb], want[:nb, :nb]),
               _close(got[:nb, nb:], want[:nb, nb:]),
               _close(got[nb:, :nb].T, want[nb:, :nb].T),
               _close(got[nb:, nb:], want[nb:, nb:]))


def _build(device):
    hm = thm.HaloModel(ZS, KS, ms=MS, params=PARAMS, device=device)
    hm.add_nfw_profile("nfw_fast", fast=True)
    hm.add_battaglia_profile("e", family="AGN", nxs=1024)
    hm.add_battaglia_pres_profile("y", nxs=1024)
    hm.add_hod("g", ngal=NGAL)
    hm.add_cib_tracer("cib545", 545.0)
    hm.add_cib_tracer("cib217", 217.0)
    return hm


@pytest.fixture(scope="module")
def hm():
    return _build("cpu")


@pytest.fixture(scope="module")
def g(hm):
    """The instance's grids as numpy arrays for the JAX side."""
    m200, r200, rhocritz = hm._m200critz()
    return {"nzm": _np(hm.nzm), "bh": _np(hm.bh), "pzk": _np(hm.Pzk),
            "sigma2": _np(hm.sigma2), "rho0": float(hm.rho_matter_z(0.0)),
            "hzs": _np(hm.h_of_z(hm.zs)),
            "chis": _np(hm.comoving_radial_distance(hm.zs)),
            "ez": _np(tbg.e_of_z(hm.bg, hm.zs)),
            "dA": _np(hm.angular_diameter_distance(hm.zs)),
            "rvir": _np(hm.rvir(hm.ms[None, :], hm.zs[:, None])),
            "m200": _np(m200), "r200": _np(r200), "rhocritz": _np(rhocritz),
            "omb": hm.p["ombh2"] / hm.h**2, "omm": hm.omm0}


def _jtracers(hm, names):
    """The JAX package's tracers of the instance's tracers, one object per
    name (the same-halo moments dispatch on identity), as inputs of
    ``_jit``."""
    out = {}
    for n in names:
        t = hm._tracer(n)
        cls = getattr(jpwr, type(t).__name__)
        out[n] = cls(*[None if v is None else _np(v) for v in t])
    return out


def _jit(fn, *args, host_grids=True):
    """fn(*args) as one compiled JAX program with the arrays of args as its
    inputs.  With ``host_grids``, what the JAX package forms on the host
    from a static grid (np.asarray of a jnp grid, then trapezoid weights)
    is evaluated while tracing, one operation at a time."""
    def body(*a):
        if not host_grids:
            return fn(*a)
        with jax.ensure_compile_time_eval():
            return fn(*a)
    return jax.jit(body)(*args)


# ---- the refusal list --------------------------------------------------------

def test_the_group_leaves_only_rsd_deferred():
    """This group's methods answer; the last one that was left
    (get_galaxy_rsd_multipoles, tests/test_torch_rsd.py) answers too."""
    assert thm.DEFERRED == {}
    assert not hasattr(thm.HaloModel.get_galaxy_rsd_multipoles,
                       "deferred_group")
    for meth in PORTED:
        assert callable(getattr(jhm.HaloModel, meth)), meth
        assert not hasattr(getattr(thm.HaloModel, meth), "deferred_group")


# ---- cluster_counts ------------------------------------------------------------

def test_cluster_counts_functions_match_jax(hm, g):
    zs, ms = ZS, MS
    nzm, chis, hzs, ez = g["nzm"], g["chis"], g["hzs"], g["ez"]
    x = np.concatenate([[0.0, 1e-7, -3e-7], RNG.uniform(-5.0, 5.0, 9)])
    P_rows = np.abs(RNG.standard_normal((3, KS.size))) + 0.1
    K = np.geomspace(3e-5, 300.0, 40)
    N = RNG.uniform(1.0, 50.0, 3)
    bN = RNG.uniform(2.0, 80.0, 3)
    s2 = np.abs(RNG.standard_normal((3, 3))) * 1e-4

    def jax_side(g, P_rows):
        nzm, chis, hzs, ez = g["nzm"], g["chis"], g["hzs"], g["ez"]
        return [
            jcc.ln_ybar(ms, ez, 1.0, 1.8, 0.6, 5e14),
            jcc.completeness(ms, ez, 5.0, 1e-4, **SCALING),
            jcc.completeness(ms, ez, 5.0, 1e-4 * (1.0 + zs), sigma_meas_ln=0.1,
                             **SCALING),
            jcc.completeness(ms, ez, jnp.inf, 1e-4, **SCALING),
            jcc.completeness(ms, ez, 4.0, 1e-4),
            *jcc.dndz_detected(zs, ms, nzm, chis, hzs, ez, 5.0, 1e-4,
                               fsky=0.4, **SCALING),
            jcc.counts_q_bins(zs, ms, nzm, chis, hzs, ez, Q_EDGES, 1e-4,
                              fsky=0.4, **SCALING),
            jcc.counts_q_bins(zs, ms, nzm, chis, hzs, ez, Q_EDGES, 1e-4,
                              fsky=0.4, z_edges=Z_EDGES, **SCALING),
            jcc.mass_limit(zs, ez, 5.0, 1e-4, **SCALING),
            jcc._sinc(jnp.asarray(x)),
            jcc._interp_loglog_rows(KS, P_rows, jnp.asarray(K)),
            jcc.counts_covariance(N, bN, s2)]

    want = _jit(jax_side, g, P_rows, host_grids=False)
    nzm_t, ms_t, ez_t = hm.nzm, hm.ms, T(ez)
    got = [
        tcc.ln_ybar(ms_t, ez_t, 1.0, 1.8, 0.6, 5e14),
        tcc.completeness(ms_t, ez_t, 5.0, 1e-4, **SCALING),
        tcc.completeness(MS, ez_t, 5.0, 1e-4 * (1.0 + zs), sigma_meas_ln=0.1,
                         **SCALING),
        tcc.completeness(ms_t, ez_t, math.inf, 1e-4, **SCALING),
        tcc.completeness(ms_t, ez_t, 4.0, 1e-4),
        *tcc.dndz_detected(zs, ms_t, nzm_t, chis, hzs, ez_t, 5.0, 1e-4,
                           fsky=0.4, **SCALING),
        tcc.counts_q_bins(zs, MS, nzm_t, chis, hzs, ez_t, Q_EDGES, 1e-4,
                          fsky=0.4, **SCALING),
        tcc.counts_q_bins(T(zs), ms_t, nzm_t, chis, hzs, ez_t, Q_EDGES, 1e-4,
                          fsky=0.4, z_edges=Z_EDGES, **SCALING),
        tcc.mass_limit(zs, ez_t, 5.0, 1e-4, **SCALING),
        tcc._sinc(T(x)),
        tcc._interp_loglog_rows(KS, T(P_rows), T(K)),
        tcc.counts_covariance(T(N), T(bN), T(s2))]
    assert len(got) == len(want)
    for i, (gv, wv) in enumerate(zip(got, want)):
        assert _close(gv, wv) <= GATE, (i, _close(gv, wv))


@pytest.fixture(scope="module")
def jax_counts(hm, g):
    """The JAX class's cluster-count methods, written with the JAX
    package's free functions on this instance's grids: obs, q bins (with
    and without z bins), the count covariance by mmin and by (q,
    sigma_noise), and the joint counts x C_yy covariance padded and not,
    in one compiled program."""
    zs, ms = ZS, MS
    ks_lin = np.geomspace(1e-4, 5.0, 400)
    wm = jtrapz(MS)
    d = dict(g, P_yy=_np(hm.get_power("y")),
             plin=_np(hm.P_lin_slow(ks_lin, hm.zs)))

    def edges_of(pad):
        """The JAX class's count bins, with its background pads."""
        lo = hi = np.empty(0)
        if pad:
            width = np.median(np.diff(Z_EDGES))
            n_lo = min(16, max(1, int(np.ceil((Z_EDGES[0] - zs[0])
                                              / width))))
            n_hi = min(16, max(1, int(np.ceil((zs[-1] - Z_EDGES[-1])
                                              / width))))
            lo = np.linspace(zs[0], Z_EDGES[0], n_lo + 1)[:-1] \
                if Z_EDGES[0] - zs[0] > 1e-10 else np.empty(0)
            hi = np.linspace(Z_EDGES[-1], zs[-1], n_hi + 1)[1:]
        return lo.size, np.concatenate([lo, Z_EDGES, hi])

    # window_sigma2 makes its weights on the host from its own grids: its
    # program evaluates them while tracing, the rest is compiled whole
    n_lo, full = edges_of(True)
    assert n_lo == 0 and np.allclose(full, FULL_EDGES, rtol=0, atol=1e-15)
    s2_of = dict(zip(("z", "full"), _jit(lambda d: [
        jcc.window_sigma2(e, zs, d["chis"], ks_lin, d["plin"], 0.4)
        for e in (Z_EDGES, full)], d)))

    def jax_side(d, s2_of):
        nzm, bh = d["nzm"], d["bh"]
        chis, hzs, ez = d["chis"], d["hzs"], d["ez"]

        def sigma2(edges, fsky):
            assert fsky == 0.4
            return s2_of["z" if edges.size == Z_EDGES.size else "full"]

        def parts(edges, mmin=None, q=None, sn=None, fsky=1.0):
            dvdz = fsky * 4.0 * jnp.pi * chis**2 / hzs
            if q is not None:
                sel = jcc.completeness(ms, ez, q, sn, **SCALING)
            else:
                sel = jnp.broadcast_to((ms >= mmin)[None, :], nzm.shape)
            dndz = dvdz * ((nzm * sel) @ wm)
            dbndz = dvdz * ((nzm * bh * sel) @ wm)

            def zbin(f):
                rows = []
                for lo, hi in zip(edges[:-1], edges[1:]):
                    m = (zs >= lo) & (zs < hi)
                    rows.append(f[m] @ jtrapz(zs[m]) if m.sum() > 1
                                else jnp.zeros(()))
                return jnp.stack(rows)

            return zbin(dndz), zbin(dbndz), sigma2(edges, fsky)

        def joint(pad):
            """Z_EDGES with its pads, or FULL_EDGES (the same bins, every
            one observed) without."""
            n_lo, full = edges_of(True)
            nb = (Z_EDGES if pad else full).size - 1
            N, bN, s2 = parts(full, mmin=2e14, fsky=0.4)
            row = np.zeros(full.size - 1)
            row[n_lo:n_lo + nb] = 1.0
            N, bN = N * row, bN * row
            ones = jnp.ones(zs.size)
            r_bl = jcov.cl_ssc_response_binned(ELLS, full, zs, KS, d["P_yy"],
                                               ones, ones, hzs, chis)
            cov = jcov.joint_counts_cl_cov(N, bN, s2, r_bl)
            keep = np.concatenate([np.arange(n_lo, n_lo + nb),
                                   np.arange(full.size - 1, cov.shape[0])])
            return N[n_lo:n_lo + nb], cov[np.ix_(keep, keep)]

        N1, bN1, s21 = parts(Z_EDGES, mmin=2e14, fsky=0.4)
        N2, bN2, s22 = parts(Z_EDGES, q=5.0, sn=1e-4, fsky=0.4)
        return {
            "obs": jcc.dndz_detected(zs, ms, nzm, chis, hzs, ez, 5.0, 1e-4,
                                     fsky=0.4, **SCALING),
            "q_bins": jcc.counts_q_bins(zs, ms, nzm, chis, hzs, ez, Q_EDGES,
                                        1e-4, fsky=0.4, **SCALING),
            "q_bins_z": jcc.counts_q_bins(zs, ms, nzm, chis, hzs, ez,
                                          Q_EDGES, 1e-4, fsky=0.4,
                                          z_edges=Z_EDGES, **SCALING),
            "cov_mmin": (N1, jcc.counts_covariance(N1, bN1, s21)),
            "cov_q": (N2, jcc.counts_covariance(N2, bN2, s22)),
            "parts_q": (N2, bN2, s22),
            "joint_pad": joint(True), "joint": joint(False)}

    return _jit(jax_side, d, s2_of, host_grids=False)


def test_cluster_count_methods_match_jax(hm, jax_counts):
    got = {
        "obs": hm.cluster_counts_obs(5.0, 1e-4, fsky=0.4, **SCALING),
        "q_bins": hm.cluster_counts_q_bins(Q_EDGES, 1e-4, fsky=0.4,
                                           **SCALING),
        "q_bins_z": hm.cluster_counts_q_bins(Q_EDGES, 1e-4, fsky=0.4,
                                             z_edges=Z_EDGES, **SCALING),
        "cov_mmin": hm.cluster_counts_covariance(Z_EDGES, mmin=2e14,
                                                 fsky=0.4),
        "cov_q": hm.cluster_counts_covariance(Z_EDGES, q=5.0,
                                              sigma_noise=1e-4, fsky=0.4,
                                              **SCALING),
        "parts_q": hm._counts_cov_parts(Z_EDGES, q=5.0, sigma_noise=1e-4,
                                        fsky=0.4, **SCALING),
        "joint_pad": hm.joint_counts_cl_cov(Z_EDGES, ELLS, "y", mmin=2e14,
                                            fsky=0.4),
        "joint": hm.joint_counts_cl_cov(FULL_EDGES, ELLS, "y", mmin=2e14,
                                        fsky=0.4, pad_background=False)}
    nb, nf = Z_EDGES.size - 1, FULL_EDGES.size - 1
    for key, gv in got.items():
        wv = jax_counts[key]
        gv = gv if isinstance(gv, tuple) else (gv,)
        wv = wv if isinstance(wv, tuple) else (wv,)
        for a, b in zip(gv, wv):
            e = (_joint(a, b, nb if key == "joint_pad" else nf)
                 if key.startswith("joint") and a.ndim == 2 else _close(a, b))
            assert e <= GATE, (key, e)
    # the pads are background modes: the C_ell block and the counts x C_ell
    # block of Z_EDGES padded are those of the padded bins all observed
    pad, full = got["joint_pad"][1], got["joint"][1]
    assert pad.shape == (nb + ELLS.size,) * 2
    assert _close(pad[nb:, nb:], full[nf:, nf:]) <= 1e-14
    assert _close(pad[:nb, nb:], full[:nb, nf:]) <= 1e-14
    without = hm.joint_counts_cl_cov(Z_EDGES, ELLS, "y", mmin=2e14, fsky=0.4,
                                     pad_background=False)[1]
    assert float((pad[nb:, nb:] - without[nb:, nb:]).abs().max()) > 0.0
    with pytest.raises(ValueError, match="beyond the zs grid"):
        hm.joint_counts_cl_cov([0.1, 0.5], ELLS, "y", mmin=2e14)
    with pytest.raises(ValueError, match="mmin"):
        hm.cluster_counts_covariance(Z_EDGES)


def test_window_sigma2_matches_jax(hm, g, jax_counts):
    """The background-mode covariance between the count bins' windows:
    against JAX on the class's (z, k) power table (the count covariance's
    own), symmetric and positive definite; one P(k) row serves every bin
    as the same row repeated at every z does."""
    ks_lin = np.geomspace(1e-4, 5.0, 400)
    plin = hm.P_lin_slow(ks_lin, hm.zs)
    got = tcc.window_sigma2(Z_EDGES, ZS, g["chis"], ks_lin, plin, 0.4)
    assert _close(got, jax_counts["parts_q"][2]) <= GATE
    assert torch.allclose(got, got.T, rtol=1e-14, atol=0.0)
    assert bool((torch.linalg.eigvalsh(got) > 0.0).all())
    one = tcc.window_sigma2(Z_EDGES, ZS, g["chis"], ks_lin, plin[:1], 0.1)
    rows = tcc.window_sigma2(Z_EDGES, ZS, g["chis"], ks_lin,
                             plin[:1].expand(ZS.size, -1), 0.1)
    assert _close(one, rows) <= 1e-14


def test_q_bin_gradients_match_jax(hm, g):
    """d(sum of the (z, q) counts) / d(alpha, sigma_lnY) with an infinite
    top edge: finite and equal to jax.grad's."""
    sc = {k: v for k, v in SCALING.items() if k not in ("alpha",
                                                         "sigma_lnY")}

    def jfn(g, alpha, sig):
        return jcc.counts_q_bins(ZS, MS, g["nzm"], g["chis"], g["hzs"],
                                 g["ez"], Q_EDGES, 1e-4, fsky=0.4,
                                 z_edges=Z_EDGES, alpha=alpha,
                                 sigma_lnY=sig, **sc).sum()

    want = _jit(jax.grad(jfn, argnums=(1, 2)), g, 1.79, 0.25,
                host_grids=False)
    a = torch.tensor(1.79, dtype=torch.float64, requires_grad=True)
    s = torch.tensor(0.25, dtype=torch.float64, requires_grad=True)
    hm.cluster_counts_q_bins(Q_EDGES, 1e-4, fsky=0.4, z_edges=Z_EDGES,
                             alpha=a, sigma_lnY=s, **sc).sum().backward()
    for gv, wv in zip((a.grad, s.grad), want):
        assert torch.isfinite(gv) and _rel(gv, wv) <= GATE


# ---- cov -----------------------------------------------------------------------

def test_cov_free_functions_match_jax(hm, g):
    ells = np.arange(2, 402)
    cls = np.abs(RNG.standard_normal((2, ells.size))) * 1e-9 \
        / (1.0 + ells / 100.0) ** 2
    edges = np.array([2.0, 30.0, 90.0, 200.0, 401.0])
    thetas = np.geomspace(1e-3, 2.0, 8)
    P = _np(hm.get_power("y"))
    pk = _np(hm.get_power("nfw"))
    ks_lin = np.geomspace(1e-4, 1.0, 512)
    plin = _np(hm.P_lin(ks_lin, hm.zs))
    uk = _np(hm.uk_profiles["nfw"])
    nzm = g["nzm"]
    Wz = RNG.uniform(0.5, 2.0, (4, ZS.size))
    lke = np.log((ELLS[:, None] + 0.5) / g["chis"][None, :])
    tz = RNG.standard_normal((ZS.size, KS.size, KS.size))
    t12 = RNG.uniform(0.1, 1.0, (ZS.size, MS.size, KS.size))
    t34 = RNG.uniform(0.1, 1.0, (ZS.size, MS.size, KS.size))
    zedges = np.array([0.2, 0.45, 0.8, 1.3, 2.0])
    bN = RNG.uniform(2.0, 80.0, 4)
    s2 = np.abs(RNG.standard_normal((4, 4))) * 1e-4
    gc = np.diag(RNG.uniform(1e-20, 2e-20, ELLS.size))

    d = dict(P=P, pk=pk, plin=plin, uk=uk, Wz=Wz, tz=tz, t12=t12, t34=t34,
             lke=lke, cls=cls, bN=bN, s2=s2, gc=gc)

    def unpack(d):
        return (d[k] for k in ("P", "pk", "plin", "uk", "Wz", "tz", "t12",
                               "t34", "lke", "cls", "bN", "s2", "gc"))

    def host_side(g, d):
        """What makes its weights on the host from a grid it was given
        (jnp.asarray, then np.asarray): compiled with those evaluated while
        tracing."""
        P, pk, plin, uk, Wz, tz, t12, t34, lke, cls, bN, s2, gc = unpack(d)
        nzm = g["nzm"]
        trt = jcov.trispectrum_1h_terms(nzm, MS, t12, t34)
        sb2 = jcov.sigma_b2_disk(0.4, g["chis"], ks_lin, plin)
        return {
            "tri": jcov.trispectrum_1h(nzm, MS, g["rho0"], uk),
            "tri2": jcov.trispectrum_1h(nzm, MS, g["rho0"], uk, uk**1.5),
            "trt": trt,
            "t1h": jcov.cl_cov_t1h(ELLS, ZS, KS, trt, Wz[0], Wz[1],
                                   g["hzs"], g["chis"], 0.4),
            "t1h34": jcov.cl_cov_t1h(ELLS, ZS, KS, trt, Wz[0], Wz[1],
                                     g["hzs"], g["chis"], 0.4, Wz3s=Wz[2],
                                     Wz4s=Wz[3]),
            "sb2": sb2,
            "ssc": jcov.cl_cov_ssc(ELLS, ZS, KS, P, Wz[0], Wz[1], g["hzs"],
                                   g["chis"], sb2),
            "ssc_r": jcov.cl_cov_ssc(ELLS, ZS, KS, P, Wz[0], Wz[1],
                                     g["hzs"], g["chis"], sb2,
                                     resp_zk=P * 2.5),
            "sbt": jcov.sigma_b2_tophat(1e10, ks_lin, plin)}

    def jax_side(g, d, h):
        P, pk, plin, uk, Wz, tz, t12, t34, lke, cls, bN, s2, gc = unpack(d)
        r_bl = jcov.cl_ssc_response_binned(ELLS, zedges, ZS, KS, P, Wz[0],
                                           Wz[1], g["hzs"], g["chis"])
        gcov = jcov.GaussianCov(edges)
        gcov.add_cls("a", "b", ells, cls[0], ells, cls[1])
        gcov.add_cls("a", "a", ells, cls[1])
        resp = jcov.pk_response_ssc(KS, pk)
        return [
            jcov.bin_annuli(ells, cls[0], edges),
            jcov.bin_annuli(ells + 0.5, cls[1], edges),
            gcov.get_cov("a", "b", "a", "b", 0.4),
            gcov.get_cov("a", "a", "b", "a", 0.4),
            jcov.knox_cov(cls[0, :4], cls[1, :4], cls[0, 4:8], cls[1, 4:8],
                          np.arange(4) + 10.0, 5.0, 0.3),
            jcov.pk_cov_gaussian(KS, pk, 1e10),
            jcov.pk_cov_gaussian(KS, pk, 1e10, dks=KS * 0.1),
            h["tri"], h["tri2"], h["trt"],
            jax.vmap(lambda Tz, lkz: jcov._interp2_loglog(
                Tz, jnp.log(KS), lkz, lkz), in_axes=(0, 1))(tz, lke),
            h["t1h"], h["t1h34"], h["sb2"], h["ssc"], h["ssc_r"],
            r_bl,
            jcov.cov_counts_cl_ssc(bN, s2, r_bl),
            jcov.cov_cl_cl_ssc_binned(r_bl, s2),
            jcov.cov_cl_cl_ssc_binned(r_bl, s2, r_bl * 1.5),
            jcov.joint_counts_cl_cov(bN * 0.3, bN, s2, r_bl),
            jcov.joint_counts_cl_cov(bN * 0.3, bN, s2, r_bl, gc),
            resp, h["sbt"], jcov.pk_cov_ssc(resp, h["sbt"])]

    want = _jit(jax_side, g, d, _jit(host_side, g, d), host_grids=False)
    tri_t = tcov.trispectrum_1h(hm.nzm, hm.ms, hm.rho_matter_z(0.0), T(uk))
    trt_t = tcov.trispectrum_1h_terms(hm.nzm, MS, T(t12), T(t34))
    r_bl_t = tcov.cl_ssc_response_binned(ELLS, zedges, ZS, KS, T(P), Wz[0],
                                         Wz[1], g["hzs"], g["chis"])
    sb2_t = tcov.sigma_b2_disk(0.4, g["chis"], ks_lin, T(plin))
    gcov = tcov.GaussianCov(edges, device="cpu")
    gcov.add_cls("a", "b", ells, cls[0], ells, cls[1])
    gcov.add_cls("a", "a", ells, T(cls[1]))
    resp_t = tcov.pk_response_ssc(KS, T(pk))
    sbt_t = tcov.sigma_b2_tophat(1e10, ks_lin, T(plin))
    bN_t, s2_t = T(bN), T(s2)
    got = [
        tcov.bin_annuli(ells, T(cls[0]), edges),
        tcov.bin_annuli(ells + 0.5, T(cls[1]), edges),
        gcov.get_cov("a", "b", "a", "b", 0.4),
        gcov.get_cov("a", "a", "b", "a", 0.4),
        tcov.knox_cov(T(cls[0, :4]), T(cls[1, :4]), T(cls[0, 4:8]),
                      T(cls[1, 4:8]), np.arange(4) + 10.0, 5.0, 0.3),
        tcov.pk_cov_gaussian(KS, T(pk), 1e10),
        tcov.pk_cov_gaussian(KS, T(pk), 1e10, dks=KS * 0.1),
        tri_t, tcov.trispectrum_1h(hm.nzm, MS, hm.rho_matter_z(0.0), T(uk),
                                   T(uk) ** 1.5),
        trt_t,
        tcov._interp2_loglog(T(tz), T(np.log(KS)), T(lke)),
        tcov.cl_cov_t1h(ELLS, ZS, KS, trt_t, Wz[0], Wz[1], g["hzs"],
                        g["chis"], 0.4),
        tcov.cl_cov_t1h(ELLS, T(ZS), KS, trt_t, Wz[0], Wz[1], g["hzs"],
                        g["chis"], 0.4, Wz3s=Wz[2], Wz4s=Wz[3]),
        sb2_t,
        tcov.cl_cov_ssc(ELLS, ZS, KS, T(P), Wz[0], Wz[1], g["hzs"],
                        g["chis"], sb2_t),
        tcov.cl_cov_ssc(ELLS, ZS, KS, T(P), Wz[0], Wz[1], g["hzs"],
                        g["chis"], sb2_t, resp_zk=T(P) * 2.5),
        r_bl_t,
        tcov.cov_counts_cl_ssc(bN_t, s2_t, r_bl_t),
        tcov.cov_cl_cl_ssc_binned(r_bl_t, s2_t),
        tcov.cov_cl_cl_ssc_binned(r_bl_t, s2_t, r_bl_t * 1.5),
        tcov.joint_counts_cl_cov(bN_t * 0.3, bN_t, s2_t, r_bl_t),
        tcov.joint_counts_cl_cov(bN_t * 0.3, bN_t, s2_t, r_bl_t, gc),
        resp_t, sbt_t, tcov.pk_cov_ssc(resp_t, sbt_t)]
    assert len(got) == len(want)
    for i, (gv, wv) in enumerate(zip(got, want)):
        # the two joint matrices (bN's 4 count bins) block by block
        e = _joint(gv, wv, bN.size) if i in (20, 21) else _close(gv, wv)
        assert e <= GATE, (i, e)
    assert tcov.shot_noise(3.0) == jcov.shot_noise(3.0)
    assert tcov.lensing_shape_noise(3.0, 0.26) == jcov.lensing_shape_noise(
        3.0, 0.26)
    acls = {"a_b": 1.0, "c_c": 2.0}
    for x, y in (("a", "b"), ("b", "a"), ("c", "c"), ("a", "c")):
        assert tcov.get_avail_cls(acls, x, y) == jcov.get_avail_cls(acls, x, y)
    # the overlap weights are host numpy in both packages
    np.testing.assert_array_equal(
        tcov._bin_overlap_weights([0.25, 0.61, 1.9], ZS),
        jcov._bin_overlap_weights([0.25, 0.61, 1.9], ZS))
    with pytest.raises(ValueError, match="already registered"):
        gcov.add_cls("b", "a", ells, cls[0])


@pytest.mark.parametrize("mn", [(0, 0), (2, 2), (2, -2), (2, 0)])
def test_wigner_sums_match_jax(mn):
    """wigner_d_sum for each spin pair from l = 0 (rows below max(|m|,
    |n|) ignored) on a (2, nl) batch, and angular_correlation (the (0, 0)
    sum) from l = 2."""
    ells = np.arange(0, 300)
    cls = RNG.standard_normal((2, ells.size)) / (1.0 + ells) ** 2
    thetas = np.geomspace(1e-3, 3.0, 9)
    want = _jit(lambda c: (jshear.wigner_d_sum(ells, c, thetas, mn),
                           jcov.angular_correlation(ells[2:], c[0, 2:],
                                                    thetas)), cls,
                host_grids=False)
    got = (tshear.wigner_d_sum(ells, T(cls), thetas, mn),
           tcov.angular_correlation(ells[2:], T(cls[0, 2:]), thetas))
    for gv, wv in zip(got, want):
        assert _close(gv, wv) <= GATE, _close(gv, wv)
    with pytest.raises(ValueError, match="consecutive"):
        tshear.wigner_d_sum(ells[::2], T(cls[:, ::2]), thetas, mn)


@pytest.fixture(scope="module")
def jax_cov_methods(hm, g):
    """The JAX class's covariance methods written with the JAX package's
    free functions on this instance's grids, in one compiled program."""
    ks_lin = np.geomspace(1e-4, 1.0, 512)
    ones = np.ones(ZS.size)
    Wg = RNG.uniform(0.5, 2.0, ZS.size)
    d = {"tr": _jtracers(hm, ("y", "g", "nfw")),
         "P_yy": _np(hm.get_power("y")), "P_mm": _np(hm.get_power("nfw")),
         "plin": _np(hm.P_lin(ks_lin, hm.zs))}

    def jax_side(g, d):
        tr, P_yy, P_mm, plin = d["tr"], d["P_yy"], d["P_mm"], d["plin"]
        nzm = g["nzm"]
        sq = lambda a, b: jpwr.one_halo_square_term(a, b, MS, g["rho0"])
        t_yy, t_gg = sq(tr["y"], tr["y"]), sq(tr["g"], tr["g"])
        proj = lambda t, W3=None, W4=None, W1=ones, W2=ones: jcov.cl_cov_t1h(
            ELLS, ZS, KS, t, W1, W2, g["hzs"], g["chis"], 0.4, Wz3s=W3,
            Wz4s=W4)
        sb2 = jcov.sigma_b2_disk(0.4, g["chis"], ks_lin, plin)
        V = 10.0 * 1e9
        resp = jcov.pk_response_ssc(KS, P_mm)
        gauss = jcov.pk_cov_gaussian(KS, P_mm, V)
        t1h = jcov.trispectrum_1h(nzm, MS, g["rho0"], tr["nfw"].uk) / V
        ssc = jcov.pk_cov_ssc(resp, jcov.sigma_b2_tophat(V, ks_lin, plin))
        return {
            "t1h_yy": proj(jcov.trispectrum_1h_terms(nzm, MS, t_yy, t_yy)),
            "t1h_yy_gg": proj(jcov.trispectrum_1h_terms(nzm, MS, t_yy, t_gg),
                              W3=Wg, W4=Wg),
            "t1h_yg": proj(jcov.trispectrum_1h_terms(
                nzm, MS, sq(tr["y"], tr["g"]), sq(tr["y"], tr["g"])),
                W2=Wg),
            "ssc_yy": jcov.cl_cov_ssc(ELLS, ZS, KS, P_yy, ones, ones,
                                      g["hzs"], g["chis"], sb2),
            "pk": {"gauss": gauss, "t1h": t1h, "ssc": ssc,
                   "total": gauss + t1h + ssc}}

    return _jit(jax_side, g, d), Wg


def test_covariance_methods_match_jax(hm, jax_cov_methods):
    want, Wg = jax_cov_methods
    got = {
        "t1h_yy": hm.get_cl_cov_t1h(ELLS, "y", fsky=0.4),
        "t1h_yy_gg": hm.get_cl_cov_t1h(ELLS, "y", fsky=0.4, name3="g",
                                       name4="g", Wz3s=Wg, Wz4s=Wg),
        "t1h_yg": hm.get_cl_cov_t1h(ELLS, "y", "g", Wz2s=Wg, fsky=0.4),
        "ssc_yy": hm.get_cl_cov_ssc(ELLS, "y", fsky=0.4)}
    for key, gv in got.items():
        assert _rel(gv, want[key]) <= GATE, key
    pk = hm.get_pk_covariance(10.0, "nfw")
    for key, wv in want["pk"].items():
        assert _close(pk[key], wv) <= GATE, (key, _close(pk[key], wv))
        diag = np.diagonal(np.asarray(wv), axis1=1, axis2=2)
        assert _rel(torch.diagonal(pk[key], dim1=1, dim2=2), diag) <= GATE


# ---- bispectrum ----------------------------------------------------------------

# tracer triples (matter's are the class test's): one HOD sample (the
# factorial moments); two CIB frequencies (one population); an HOD pair
# with pressure (a shared pair and a distinct leg); three distinct
# tracers.  The same-halo terms (1h, 2h) of each; the 3h and total terms,
# which share the legs, of the last two
TRIPLES = (("g", "g", "g"), ("cib545", "cib217", "cib545"), ("g", "y", "g"),
           ("nfw", "y", "g"))


@pytest.fixture(scope="module")
def legs():
    """Non-equilateral triangles: k1 shared across z, k2 = 1.3 k1, k3 per z
    (inside |k1 - k2| <= k3 <= k1 + k2)."""
    k1 = np.geomspace(2e-3, 20.0, 7)
    k2 = 1.3 * k1
    k3 = k1[None, :] * RNG.uniform(0.5, 2.2, (ZS.size, k1.size))
    return k1, k2, k3


def test_bispectrum_functions_match_jax(hm, g, legs):
    k1, k2, k3 = legs
    names = {n for t in TRIPLES for n in t} | {"nfw"}
    b2h = _np(tbsp.b2_sheth_torman(hm.sigma2, hm.p))
    b_in = (None, 1.0 + ZS, None)
    F = RNG.standard_normal((ZS.size, KS.size))
    kq = np.exp(RNG.uniform(np.log(5e-5), np.log(200.0), (ZS.size, 9)))

    d = {"tr": _jtracers(hm, names), "b2h": b2h, "F": F}

    def jax_side(g, d):
        tr, b2h, F = d["tr"], d["b2h"], d["F"]
        out = [jbsp.mu12_from_closure(k1, k2, k3[0]),
               jbsp.f2_kernel(k1, k1, k1), jbsp.f2_kernel(k1, k2, k3[1]),
               jbsp.tree_bispectrum(k1, k2, k3[2], k1, k2, k3[2]),
               jbsp.b2_sheth_torman(g["sigma2"], hm.p),
               jbsp._normalize_kq(k1, ZS.size), jbsp._normalize_kq(3.0, 6),
               jbsp._interp_zk(KS, F, kq),
               jbsp._interp_zmk(KS, tr["nfw"].uk, kq)]
        for t in TRIPLES:
            ts = [tr[n] for n in t]
            args = (g["nzm"], g["bh"], MS, KS, g["pzk"], g["rho0"], k1, k2,
                    k3)
            out += [jbsp.bispectrum_1halo(*ts, g["nzm"], MS, KS, g["rho0"],
                                          k1, k2, k3, 0.01),
                    jbsp.bispectrum_2halo(*ts, *args, b_in)]
            if t in TRIPLES[3:]:
                out += [jbsp.bispectrum_3halo(*ts, *args, b2h=b2h),
                        jbsp.bispectrum_total(*ts, *args, 0.0, b_in, b2h)]
        w = (None, 0.7 + ZS, None)
        out.append(jbsp.projected_bispectrum(
            ELLS, 2 * ELLS, 2.5 * ELLS, ZS, g["hzs"], g["chis"], *w,
            lambda a, b, c: jbsp.bispectrum_total(
                tr["y"], tr["y"], tr["g"], g["nzm"], g["bh"], MS, KS,
                g["pzk"], g["rho0"], a, b, c)))
        return out

    want = _jit(jax_side, g, d, host_grids=False)
    zs_t = hm.zs
    got = [tbsp.mu12_from_closure(T(k1), T(k2), T(k3[0])),
           tbsp.f2_kernel(T(k1), T(k1), T(k1)),
           tbsp.f2_kernel(T(k1), T(k2), T(k3[1])),
           tbsp.tree_bispectrum(*[T(x) for x in (k1, k2, k3[2])] * 2),
           tbsp.b2_sheth_torman(hm.sigma2, hm.p),
           tbsp._normalize_kq(k1, ZS.size, "cpu"),
           tbsp._normalize_kq(3.0, 6, "cpu"),
           tbsp._interp_zk(hm.ks, T(F), T(kq)),
           tbsp._interp_zmk(hm.ks, hm.uk_profiles["nfw"], T(kq))]
    for t in TRIPLES:
        ts = [hm._tracer(t[0])]
        for i in (1, 2):
            ts.append(next((ts[j] for j in range(i) if t[j] == t[i]),
                           None) or hm._tracer(t[i]))
        args = (hm.nzm, hm.bh, hm.ms, KS, hm.Pzk, hm.rho_matter_z(0.0), k1,
                k2, k3)
        got += [tbsp.bispectrum_1halo(*ts, hm.nzm, hm.ms, hm.ks,
                                      hm.rho_matter_z(0.0), k1, k2, k3,
                                      0.01),
                tbsp.bispectrum_2halo(*ts, *args, b_in)]
        if t in TRIPLES[3:]:
            got += [tbsp.bispectrum_3halo(*ts, *args, b2h=T(b2h)),
                    tbsp.bispectrum_total(*ts, *args, 0.0, b_in, T(b2h))]
    tr = {n: hm._tracer(n) for n in ("y", "g")}
    got.append(tbsp.projected_bispectrum(
        ELLS, 2 * ELLS, 2.5 * ELLS, zs_t, hm.h_of_z(zs_t),
        hm.comoving_radial_distance(zs_t), None, 0.7 + ZS, None,
        lambda a, b, c: tbsp.bispectrum_total(
            tr["y"], tr["y"], tr["g"], hm.nzm, hm.bh, hm.ms, hm.ks, hm.Pzk,
            hm.rho_matter_z(0.0), a, b, c)))
    assert len(got) == len(want)
    for i, (gv, wv) in enumerate(zip(got, want)):
        assert _close(gv, wv) <= GATE, (i, _close(gv, wv))
    # the HOD triple's factorial moments differ from the product of terms
    hod = hm._tracer("g")
    same = tbsp.bispectrum_1halo(hod, hod, hod, hm.nzm, hm.ms, hm.ks,
                                 hm.rho_matter_z(0.0), k1, k2, k3)
    apart = tbsp.bispectrum_1halo(hod, hm._tracer("g"), hm._tracer("g"),
                                  hm.nzm, hm.ms, hm.ks, hm.rho_matter_z(0.0),
                                  k1, k2, k3)
    assert float((same - apart).abs().max()) > 0.0


@pytest.fixture(scope="module")
def jax_bispectrum_methods(hm, g):
    """The JAX class's get_bispectrum / get_angular_bispectrum on this
    instance's grids: the equilateral sweep on ks for each term and for
    'g' with the second-order bias, the fast NFW profile, a CIB
    cross-frequency triple, the angular y bispectrum."""
    tr = _jtracers(hm, ("nfw", "g", "y", "cib545", "cib217"))

    def jax_side(g, tr):
        b2h = jbsp.b2_sheth_torman(g["sigma2"], hm.p)
        a = (g["nzm"], g["bh"], MS, KS, g["pzk"], g["rho0"])

        def total(t1, t2, t3, k1, k2, k3, b2=None):
            return jbsp.bispectrum_total(t1, t2, t3, *a, k1, k2, k3,
                                         hm.p["kstar_damping"], (None,) * 3,
                                         b2)

        n, y = tr["nfw"], tr["y"]
        return {
            "1h": jbsp.bispectrum_1halo(n, n, n, g["nzm"], MS, KS, g["rho0"],
                                        KS, KS, KS, hm.p["kstar_damping"]),
            "2h": jbsp.bispectrum_2halo(n, n, n, *a, KS, KS, KS),
            "3h": jbsp.bispectrum_3halo(n, n, n, *a, KS, KS, KS),
            "total": total(n, n, n, KS, KS, KS),
            "g_b2": total(*(tr["g"],) * 3, KS, KS, KS, b2h),
            "cib": total(tr["cib545"], tr["cib217"], tr["cib217"], KS,
                         2 * KS, 2.5 * KS),
            "ang_y": jbsp.projected_bispectrum(
                ELLS, ELLS, ELLS, ZS, g["hzs"], g["chis"], None, None, None,
                lambda k1, k2, k3: total(y, y, y, k1, k2, k3))}

    return _jit(jax_side, g, tr, host_grids=False)


def test_bispectrum_methods_match_jax(hm, jax_bispectrum_methods):
    want = jax_bispectrum_methods
    got = {t: hm.get_bispectrum(terms=t) for t in ("1h", "2h", "3h",
                                                   "total")}
    got["g_b2"] = hm.get_bispectrum(name="g", include_b2=True)
    got["cib"] = hm.get_bispectrum(KS, 2 * KS, 2.5 * KS, "cib545", "cib217",
                                   "cib217")
    got["ang_y"] = hm.get_angular_bispectrum(ELLS, name="y")
    for key, gv in got.items():
        assert _rel(gv, want[key]) <= GATE, key
    # the fast NFW profile: the same function of its u, within its tier
    assert _rel(hm.get_bispectrum(name="nfw_fast"), want["total"]) \
        <= FAST_GATE, _rel(hm.get_bispectrum(name="nfw_fast"), want["total"])
    with pytest.raises(ValueError, match="terms"):
        hm.get_bispectrum(terms="4h")


# ---- pairwise ------------------------------------------------------------------

@pytest.fixture(scope="module")
def pw_inputs(hm, g):
    fit = hm._battaglia_params(("battaglia_gas_gamma",), "AGN", None)
    pfit = hm._battaglia_params(("battaglia_pres_gamma",
                                 "battaglia_pres_alpha"), "pres", None)
    ks = np.geomspace(1e-4, 1e2, 256)
    pk = _np(hm.P_lin(ks, ZS[2:3])[0])
    return fit, pfit, ks, pk


def test_pairwise_functions_match_jax(hm, g, pw_inputs):
    fit, pfit, ks, pk = pw_inputs
    r = np.concatenate([[0.3, 0.3 + 1e-12, 0.3 - 1e-12],
                        RNG.uniform(0.01, 3.0, 20)])
    cmax_gas = g["rvir"] / (g["r200"] / 2.0)
    cmax_y = g["rvir"] / g["r200"]
    R_z = 0.25 * (1.0 + ZS)
    r_edges = np.linspace(20.0, 150.0, 9)
    fx = np.exp(-ks) * ks ** 0.5

    def host_side(pk):
        """v12 reads its FFTLog grid back on the host: compiled with it
        evaluated while tracing."""
        rs, T_r = jpw.pairwise_ksz_signal(ks, pk, 0.7, 80.0, 1.6, 2e-4)
        _, xi = jfft.correlation_function(ks, pk)
        return (rs, T_r, xi,
                jrsd.mean_pairwise_velocity(ks, pk, 0.7, 80.0, b=1.3))

    def jax_side(g, pk, r, h):
        gas = lambda R, n: jpw.tau_aperture_battaglia(
            ZS, g["m200"], g["r200"], cmax_gas, g["rhocritz"], g["omb"],
            g["omm"], R, fit["battaglia_gas_gamma"], fit, n_x=n)
        rs, T_r, xi, v12 = h
        return [jpw.aperture_shell_fraction(r, 0.3),
                gas(0.5, 256), gas(R_z, 64),
                jpw.electron_count_total_battaglia(
                    ZS, g["m200"], g["r200"], cmax_gas, g["rhocritz"],
                    g["omb"], g["omm"], fit["battaglia_gas_gamma"], fit,
                    n_x=128),
                jpw.compton_y_k0_battaglia(
                    ZS, g["m200"], g["r200"], cmax_y,
                    g["rhocritz"], g["omb"], g["omm"],
                    pfit["battaglia_pres_alpha"],
                    pfit["battaglia_pres_gamma"], pfit, g["hzs"], n_x=128),
                rs, T_r, *jpw.pairwise_ksz_errors(r_edges, rs, xi, T_r, 1e-4,
                                                  10.0, 2.0, bg=1.6),
                *v12, jfft.fftlog_sphbessel_jl(fx, ks, 1)[1],
                jfft.fftlog_sphbessel_jl(fx, ks, 2,
                                         lnkr=jfft.fftlog_lnkr(ks))[1]]

    want = _jit(jax_side, g, pk, r, _jit(host_side, pk), host_grids=False)
    m200, r200, rhocritz = hm._m200critz()
    cmax_t = T(cmax_gas)
    gas = lambda R, n: tpw.tau_aperture_battaglia(
        ZS, m200, r200, cmax_t, rhocritz, g["omb"], g["omm"], R,
        fit["battaglia_gas_gamma"], fit, n_x=n)
    rs, T_r = tpw.pairwise_ksz_signal(ks, T(pk), 0.7, 80.0, 1.6, 2e-4)
    _, xi = tfft.correlation_function(ks, T(pk))
    got = [tpw.aperture_shell_fraction(T(r), 0.3), gas(0.5, 256),
           gas(R_z, 64),
           tpw.electron_count_total_battaglia(
               ZS, m200, r200, cmax_t, rhocritz, g["omb"], g["omm"],
               fit["battaglia_gas_gamma"], fit, n_x=128),
           tpw.compton_y_k0_battaglia(
               ZS, m200, r200, T(g["rvir"]) / r200, rhocritz, g["omb"],
               g["omm"], pfit["battaglia_pres_alpha"],
               pfit["battaglia_pres_gamma"], pfit, hm.h_of_z(hm.zs),
               n_x=128),
           rs, T_r, *tpw.pairwise_ksz_errors(r_edges, rs, xi, T_r, 1e-4,
                                             10.0, 2.0, bg=1.6),
           *trsd.mean_pairwise_velocity(ks, T(pk), 0.7, 80.0, b=1.3),
           tfft.fftlog_sphbessel_jl(T(fx), ks, 1)[1],
           tfft.fftlog_sphbessel_jl(T(fx), ks, 2,
                                    lnkr=tfft.fftlog_lnkr(ks))[1]]
    assert len(got) == len(want)
    for i, (gv, wv) in enumerate(zip(got, want)):
        # the two j_l transforms (the last two) fall over nine decades: an
        # FFT's rounding is on the scale of its largest output
        e = _to_max(gv, wv) if i >= len(got) - 2 else _close(gv, wv)
        assert e <= GATE, (i, e)
    assert tfft.fftlog_lnkr(ks, 1.5) == jfft.fftlog_lnkr(ks, 1.5)


@pytest.fixture(scope="module")
def jax_pairwise_methods(hm, g, pw_inputs):
    """get_mean_compton_y, get_tau_aperture (theta and R_ap) and
    get_pairwise_ksz_snr as the JAX class computes them, on this
    instance's grids; with jax.grad of sum tau over theta_arcmin."""
    fit, pfit, _, _ = pw_inputs
    ks = np.geomspace(1e-4, 1e2, 512)
    iz = 2
    pk = _np(hm.P_lin(ks, ZS[iz:iz + 1])[0])
    f = float(hm.get_growth_rate_f(ZS[iz:iz + 1])[0])
    aH = float(hm.h_of_z(ZS[iz:iz + 1])[0]) * jpw._C_KM_S / (1.0 + ZS[iz])
    h = hm.hods["g"]
    hod = {k: _np(h[k]) for k in ("Nc", "Ns", "ngal", "bg")}
    wm, wz = jtrapz(MS), jtrapz(ZS)
    r_edges = np.linspace(20.0, 150.0, 9)

    def jax_side(g):
        def tau(theta=None, R_ap=None):
            if R_ap is None:
                R_ap = (theta * np.pi / (180.0 * 60.0)) * g["dA"]
            return jpw.tau_aperture_battaglia(
                ZS, g["m200"], g["r200"], g["rvir"] / (g["r200"] / 2.0),
                g["rhocritz"], g["omb"], g["omm"], R_ap,
                fit["battaglia_gas_gamma"], fit)

        uy0 = jpw.compton_y_k0_battaglia(
            ZS, g["m200"], g["r200"], g["rvir"] / g["r200"], g["rhocritz"],
            g["omb"], g["omm"], pfit["battaglia_pres_alpha"],
            pfit["battaglia_pres_gamma"], pfit, g["hzs"])
        tau_zm = tau(1.6)
        tau_bar = ((g["nzm"] * (hod["Nc"] + hod["Ns"]) * tau_zm) @ wm
                   / hod["ngal"])[iz]
        return {"y": ((g["nzm"] * uy0) @ wm) @ wz, "tau": tau_zm,
                "tau_R": tau(R_ap=0.4), "tau_bar": tau_bar,
                "grad": jax.grad(lambda th: tau(th).sum())(1.6)}

    def snr_side(pk, tau_bar):
        """get_pairwise_ksz_snr after tau_bar: v12 reads its FFTLog grid
        back on the host, so this program evaluates it while tracing."""
        rs, T_r = jpw.pairwise_ksz_signal(ks, pk, f, aH, hod["bg"][iz],
                                          tau_bar)
        _, xi = jfft.correlation_function(ks, pk)
        return jpw.pairwise_ksz_errors(r_edges, rs, xi, T_r, 1e-4, 10.0, 2.0,
                                       bg=hod["bg"][iz])

    want = _jit(jax_side, g, host_grids=False)
    want["snr"] = _jit(snr_side, pk, want["tau_bar"])
    return want, r_edges, iz


def test_pairwise_methods_match_jax(hm, jax_pairwise_methods):
    want, r_edges, iz = jax_pairwise_methods
    assert _rel(hm.get_mean_compton_y(), want["y"]) <= GATE
    assert _rel(hm.get_tau_aperture(theta_arcmin=1.6), want["tau"]) <= GATE
    assert _rel(hm.get_tau_aperture(R_ap=0.4), want["tau_R"]) <= GATE
    got = tpw.get_pairwise_ksz_snr(hm, iz, 1e-4, 10.0, 2.0, r_edges,
                                   theta_arcmin=1.6)
    assert _rel(got["tau_bar"], want["tau_bar"]) <= GATE
    for key, wv in zip(("r_centers", "T_bins", "sigma_bins", "snr"),
                       want["snr"]):
        assert _rel(got[key], wv) <= GATE, key
    with pytest.raises(ValueError, match="exactly one"):
        hm.get_tau_aperture()


def test_tau_aperture_gradient_matches_jax(hm, jax_pairwise_methods):
    """d(sum tau_bar)/d(theta_arcmin), with halos both larger and smaller
    than the aperture (the zero-width outer panel): finite and equal to
    jax.grad's."""
    want = jax_pairwise_methods[0]["grad"]
    theta = torch.tensor(1.6, dtype=torch.float64, requires_grad=True)
    hm.get_tau_aperture(theta_arcmin=theta).sum().backward()
    assert torch.isfinite(theta.grad)
    assert _rel(theta.grad, want) <= GATE


# ---- on the card -----------------------------------------------------------------

@pytest.mark.gpu
def test_cov_bispectrum_on_the_card_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cpu = _build("cpu")
    before = (nk.nfw_uk_fast.launches, rk.pair_lerp_f64.launches)
    gpu = _build("cuda")
    assert (nk.nfw_uk_fast.launches - before[0],
            rk.pair_lerp_f64.launches - before[1]) == (1, 2)
    calls = (
        ("t1h", lambda h: h.get_cl_cov_t1h(ELLS, "y", fsky=0.4), GATE),
        ("ssc", lambda h: h.get_cl_cov_ssc(ELLS, "y", fsky=0.4), GATE),
        ("pk", lambda h: h.get_pk_covariance(10.0, "nfw_fast")["total"],
         FAST_GATE),
        ("counts", lambda h: h.cluster_counts_covariance(
            Z_EDGES, q=5.0, sigma_noise=1e-4, **SCALING)[1], GATE),
        ("joint", lambda h: h.joint_counts_cl_cov(
            Z_EDGES, ELLS, "y", mmin=2e14, fsky=0.3)[1], GATE),
        ("b", lambda h: h.get_bispectrum(name="g", include_b2=True), GATE),
        ("b_ang", lambda h: h.get_angular_bispectrum(ELLS, name="y"), GATE),
        ("y", lambda h: h.get_mean_compton_y(), GATE),
        ("tau", lambda h: h.get_tau_aperture(theta_arcmin=1.6), GATE))
    before = (nk.nfw_uk_fast.launches, rk.pair_lerp_f64.launches)
    for what, fn, gate in calls:
        got, want = fn(gpu), fn(cpu)
        e = (_joint(got, want, Z_EDGES.size - 1) if what == "joint"
             else _close(got, want))
        assert got.is_cuda and e <= gate, (what, e)
    assert (nk.nfw_uk_fast.launches, rk.pair_lerp_f64.launches) == before
