"""PyTorch port, the first extension group: models/distances_ext.py
(conformal time, recombination, BAO, theta100, CMB lensing by Limber),
models/cib.py with power.CIBTracer and its terms, models/hi.py,
models/cluster_lensing.py, and the class methods on them, against the JAX
package on the CPU at 3 z x 48 m x 48 k, L up to 200 and 8 theta, with
inputs made by numpy from a seed.  The JAX side of each test runs under
one ``jax.jit``, fed with the torch instance's own grids (n(z, m), b(z, m),
u(k)), so the test holds what this group adds; the class's inputs are
held against the JAX class by tests/test_torch_halo_model.py.  Both sides
are float64 with the same algorithm: 1e-10 relative unless a test says
otherwise (H0 from theta100: 1e-12).

The card test (``-m gpu``) holds the extensions build of chip_smoke.py, at
this file's size, on the card against the CPU:

    python -m pytest --noconftest -m gpu tests/test_torch_extensions.py
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from hmvec_tpu.models import background as jbg
    from hmvec_tpu.models import cib as jcib
    from hmvec_tpu.models import cluster_lensing as jcl
    from hmvec_tpu.models import cosmology as jcos
    from hmvec_tpu.models import distances_ext as jdx
    from hmvec_tpu.models import halo_model as jhm
    from hmvec_tpu.models import hi as jhi
    from hmvec_tpu.models import limber as jlimb
    from hmvec_tpu.models import power as jpwr
    from hmvec_tpu.params import merge_params as jmerge
except ImportError:    # a machine with the card and no JAX: the tests
    jnp = None         # marked gpu need none of it (run them with -m gpu)

from hmvec_tpu_torch.models import cib as tcib
from hmvec_tpu_torch.models import cluster_lensing as tcl
from hmvec_tpu_torch.models import cosmology as tcos
from hmvec_tpu_torch.models import distances_ext as tdx
from hmvec_tpu_torch.models import halo_model as thm
from hmvec_tpu_torch.models import hi as thi
from hmvec_tpu_torch.models import power as tpwr
from hmvec_tpu_torch.ops import nfw_kernels as nk
from hmvec_tpu_torch.ops import resample_kernels as rk

ZS = np.array([0.3, 1.0, 2.0])
MS = np.geomspace(2e10, 1e17, 48)
KS = np.geomspace(1e-4, 100.0, 48)
PARAMS = {"omch2": 0.1198, "As": 2.2e-9, "mnu": 0.06}
RNG = np.random.default_rng(53)
ELLS = np.geomspace(100.0, 3000.0, 16)
THETAS = np.geomspace(1e-4, 1e-2, 8)
HI_OVERRIDE = {"hi_alpha": 0.3, "hi_Mmin": 1e12}
T = torch.as_tensor
GATE = 1e-10
FAST_GATE = 1e-5

# the methods that the first two groups of ROADMAP A9 brought, and the
# refusal lists that stay, by group
PORTED = {
    "Cosmology": ("conformal_time", "get_tau_star", "z_of_tau",
                  "get_bao_rs_dV", "cmb_lensing_limber"),
    "HaloModel": ("add_cib_tracer", "get_cib_mean_emissivity",
                  "get_cib_mean_intensity", "get_cib_cls", "add_hi_tracer",
                  "get_omega_hi", "get_hi_bias", "get_p21",
                  "sigma_1h_profiles", "kappa_1h_profiles",
                  "kappa_2h_profiles"),
}
STILL_DEFERRED = {
    # the exact C_ell, one-loop and redshift-space methods are held by
    # tests/test_torch_nonlimber.py and tests/test_torch_rsd.py; the ia
    # methods by tests/test_torch_lensing.py, the CMB ones by
    # tests/test_torch_cmb_lensing.py
    "Cosmology": set(),
    # the covariance group's 11 methods are held by
    # tests/test_torch_cov_bispectrum.py (PORTED there)
    "HaloModel": set(),
}


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
    """Max abs difference over the largest |want| (for sign-changing
    results)."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _extensions(hm, fast_name="nfw_fast"):
    """The tracers of this group on a HaloModel: the fast NFW profile; a
    scattered profile under two CIB frequencies (one <u^2> tensor); a
    third frequency on the analytic NFW; the Battaglia pressure profile;
    HI on the analytic and on the fast profile."""
    hm.add_nfw_profile(fast_name, fast=True)
    hm.add_nfw_profile("sc", conc_scatter=0.3)
    hm.add_cib_tracer("cib545", 545.0, satellite_profile="sc")
    hm.add_cib_tracer("cib217", 217.0, satellite_profile="sc")
    hm.add_cib_tracer("cib353", 353.0, param_override={"cib_beta": 1.6})
    hm.add_cib_tracer("cibf", 545.0, satellite_profile=fast_name)
    hm.add_battaglia_pres_profile("y", nxs=1024)
    hm.add_hi_tracer("hi")
    hm.add_hi_tracer("hi2", profile_name=fast_name,
                     param_override=HI_OVERRIDE)
    return hm


@pytest.fixture(scope="module")
def hm():
    return _extensions(thm.HaloModel(ZS, KS, ms=MS, params=PARAMS,
                                     device="cpu"))


def _grids(hm):
    """The instance's grids as numpy arrays for the JAX side."""
    return {"nzm": _np(hm.nzm), "bh": _np(hm.bh), "pzk": _np(hm.Pzk),
            "rho0": float(hm.rho_matter_z(0.0)),
            "hzs": _np(hm.h_of_z(hm.zs)),
            "chis": _np(hm.comoving_radial_distance(hm.zs)),
            "kstar": hm.p["kstar_damping"]}


def _jcib(hm, name, cache):
    """The JAX CIBTracer of one of the instance's tracers; tracers on one
    profile share one <u^2> array, as the JAX class hands them out."""
    t = hm.cib_tracers[name]
    us2 = None
    if t.us2 is not None:
        us2 = cache.setdefault(id(t.us2), jnp.asarray(_np(t.us2)))
    return jpwr.CIBTracer(fc=jnp.asarray(_np(t.fc)), fs=jnp.asarray(_np(t.fs)),
                          us=jnp.asarray(_np(t.us)), us2=us2)


# ---- the refusal lists and the public names ---------------------------------

def test_refusal_lists_keep_every_other_group():
    """The 16 methods of this slice answer; every other group's methods
    are still refused; both lists name only methods of the JAX classes."""
    for name, (tcls, jcls, table) in {
            "Cosmology": (tcos.Cosmology, jcos.Cosmology, tcos.DEFERRED),
            "HaloModel": (thm.HaloModel, jhm.HaloModel, thm.DEFERRED)}.items():
        assert set(table) == STILL_DEFERRED[name]
        for meth in (*PORTED[name], *table):
            assert callable(getattr(jcls, meth)), meth
        for meth in PORTED[name]:
            assert not hasattr(getattr(tcls, meth), "deferred_group"), meth
    assert not hasattr(tcos, "NONLINEAR_GROUP")


def test_cib_tracers_share_their_profile(hm):
    """Two frequencies on one scattered profile hold the profile's own
    <u^2> tensor (the same-halo pair term tests that identity), and its
    <u>; a tracer on an unscattered profile holds none."""
    t1, t2 = hm.cib_tracers["cib545"], hm.cib_tracers["cib217"]
    assert t1.us2 is t2.us2 is hm.uk2_profiles["sc"]
    assert t1.us is t2.us is hm.uk_profiles["sc"]
    assert hm.cib_tracers["cib353"].us2 is None
    with pytest.raises(ValueError, match="already exists"):
        hm.add_cib_tracer("cib545", 545.0)
    with pytest.raises(ValueError, match="already exists"):
        hm.add_hi_tracer("hi")
    with pytest.raises(ValueError, match="Unknown override"):
        hm.add_hi_tracer("hi3", param_override={"hi_bogus": 1.0})


# ---- distances_ext -------------------------------------------------------------

def test_distances_ext_match_jax():
    zq = np.concatenate([[0.0, 3e-6], RNG.uniform(0.01, 5.0, 6)])
    taus = RNG.uniform(300.0, 14000.0, 5)
    bgj = jbg.background(jmerge(PARAMS))
    want = jax.jit(lambda: [
        jdx.conformal_time(bgj, jnp.asarray(zq)), jdx.conformal_age(bgj),
        jdx.z_star_hu_sugiyama(bgj), jdx.tau_star(bgj),
        jdx.z_of_tau(bgj, jnp.asarray(taus)), jdx.rs_drag_eh(bgj),
        jdx.get_bao_rs_dV(bgj, jnp.asarray(zq[2:])),
        jdx.theta_star_approx(bgj)])()
    ct = tcos.Cosmology(PARAMS, device="cpu")
    bg = ct.bg
    got = [tdx.conformal_time(bg, zq), tdx.conformal_age(bg),
           tdx.z_star_hu_sugiyama(bg), tdx.tau_star(bg),
           tdx.z_of_tau(bg, taus), tdx.rs_drag_eh(bg),
           tdx.get_bao_rs_dV(bg, zq[2:]), tdx.theta_star_approx(bg)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= GATE, i
    # the class methods: the conformal age below z = 1e-5, a 0-d tensor
    # for one redshift
    eta = ct.conformal_time(zq)
    assert torch.equal(eta[:2], tdx.conformal_age(bg).expand(2))
    assert torch.equal(eta[2:], tdx.conformal_time(bg, zq[2:]))
    assert ct.conformal_time(1.5).shape == ()
    assert torch.equal(ct.get_tau_star(), got[3])
    assert torch.equal(ct.z_of_tau(taus), got[4])
    assert torch.equal(ct.get_bao_rs_dV(zq[2:]), got[6])
    assert tdx.CSPEED_KMS == jdx.CSPEED_KMS


def test_theta100_matches_jax():
    """H0 from 100 theta_s, on the host, within 1e-12 of JAX's; the
    class's constructor takes it."""
    p = jmerge(PARAMS)
    for theta in (1.03, 1.041):
        want = jdx.solve_h0_from_theta100(p, theta)
        got = tdx.solve_h0_from_theta100(p, theta)
        assert isinstance(got, float)
        assert abs(got / want - 1.0) <= 1e-12
    ct = tcos.Cosmology({**PARAMS, "theta100": 1.041}, device="cpu")
    assert ct.p["H0"] == got and ct.h == got / 100.0
    assert float(ct.bg.H0) == got


@pytest.fixture(scope="module")
def jax_cmb_lensing():
    """JAX's C_L^kk on the linear and on the nonlinear power, in one
    compiled program."""
    cj = jcos.Cosmology(PARAMS, halofit="takahashi")
    return jax.jit(lambda: {nl: cj.cmb_lensing_limber(200, nl)
                            for nl in (False, True)})()


@pytest.mark.parametrize("nonlinear", [False, True])
def test_cmb_lensing_limber_matches_jax(jax_cmb_lensing, nonlinear):
    """C_L^kk for L = 2..200, on the linear power and on halofit's
    (takahashi) nonlinear power."""
    ct = tcos.Cosmology(PARAMS, halofit="takahashi", device="cpu")
    ls_j, cl_j = jax_cmb_lensing[nonlinear]
    ls_t, cl_t = ct.cmb_lensing_limber(200, nonlinear=nonlinear)
    np.testing.assert_array_equal(_np(ls_t), np.asarray(ls_j))
    assert _rel(cl_t, cl_j) <= GATE


# ---- CIB ---------------------------------------------------------------------

def test_cib_functions_match_jax(hm):
    g = _grids(hm)
    nus = (217.0, 545.0, 3000.0)       # 3000 GHz: the power-law branch
    p = {**jcib.default_cib_params, "cib_nsub": 48}
    trac = hm.cib_tracers["cib545"]
    us = _np(trac.us)
    want = jax.jit(lambda: {
        "sed": [jcib.sed_graybody(nu, jnp.asarray(ZS), p) for nu in nus],
        "sig": jcib.sigma_lum_mass(jnp.asarray(MS), p),
        "lum": jcib.cib_luminosity(jnp.asarray(MS), jnp.asarray(ZS), 545.0,
                                   p),
        "sat": jcib.cib_satellite_luminosity(MS, jnp.asarray(ZS), 545.0, p),
        "tracer": jcib.build_cib_tracer(MS, jnp.asarray(ZS), 545.0,
                                        jnp.asarray(us))[:2],
        "jbar": jcib.mean_emissivity(jnp.asarray(g["nzm"]), MS,
                                     jpwr.CIBTracer(*map(jnp.asarray, (
                                         _np(trac.fc), _np(trac.fs), us)))),
        "inu": jcib.mean_intensity(ZS, jnp.asarray(g["hzs"]),
                                   jnp.asarray(g["nzm"]), MS,
                                   jpwr.CIBTracer(*map(jnp.asarray, (
                                       _np(trac.fc), _np(trac.fs), us))))})()
    zs = T(ZS)
    got = {
        "sed": [tcib.sed_graybody(nu, zs, p) for nu in nus],
        "sig": tcib.sigma_lum_mass(T(MS), p),
        "lum": tcib.cib_luminosity(MS, zs, 545.0, p),
        "sat": tcib.cib_satellite_luminosity(MS, zs, 545.0, p),
        "tracer": (trac.fc, trac.fs),
        "jbar": hm.get_cib_mean_emissivity("cib545"),
        "inu": hm.get_cib_mean_intensity("cib545"),
    }
    assert tcib._sed_transition_x(1.75, 1.7) == jcib._sed_transition_x(1.75,
                                                                      1.7)
    assert tcib._HK_GHZ == jcib._HK_GHZ
    assert tcib.default_cib_params == jcib.default_cib_params
    for key in got:
        pairs = (zip(got[key], want[key])
                 if isinstance(got[key], (list, tuple))
                 else [(got[key], want[key])])
        for gv, wv in pairs:
            assert _rel(gv, wv) <= GATE, key
    # cib_nsub = 48 above; the class's tracer at the default 64
    assert _rel(tcib.cib_satellite_luminosity(
        MS, zs, 545.0, tcib.default_cib_params) / (4.0 * np.pi),
        _np(trac.fs)) <= 1e-14


def test_cib_spectra_match_jax(hm):
    """get_power of CIB pairs: two frequencies on one scattered profile
    (the same-halo pair term takes <u^2>), on distinct profiles, on the
    fast NFW profile, and with y and matter; the 2-halo CIB leg with fNL;
    get_cib_cls."""
    g = _grids(hm)
    pairs = (("cib545", "cib545"), ("cib545", "cib217"),
             ("cib545", "cib353"), ("cib217", "cibf"), ("cib545", "y"),
             ("nfw", "cib353"))
    cache = {}
    jt = {n: _jcib(hm, n, cache) for n in ("cib545", "cib217", "cib353",
                                           "cibf")}
    jt["y"] = jpwr.PressureTracer(pk=jnp.asarray(_np(hm.pk_profiles["y"])))
    jt["nfw"] = jpwr.MatterTracer(uk=jnp.asarray(_np(hm.uk_profiles["nfw"])))
    alpha = _np(hm.alpha_fnl(hm.zs, hm.ks))
    nzm, bh, pzk = (jnp.asarray(g[k]) for k in ("nzm", "bh", "pzk"))

    def jax_side():
        out = [jpwr.power_total(jt[a], jt[b], nzm, bh, MS, KS, pzk,
                                g["rho0"], g["kstar"]) for a, b in pairs]
        out.append(jpwr.power_2halo(jt["cib545"], jt["cib217"], nzm, bh, MS,
                                    pzk, g["rho0"], fnl=20.0,
                                    alpha_zk=jnp.asarray(alpha)))
        p = out[1]
        W = (1.0 / (1.0 + jnp.asarray(ZS))) / jnp.asarray(g["hzs"])
        out.append(jlimb.limber_integral(ELLS, ZS, KS, p, ZS, W, W,
                                         jnp.asarray(g["hzs"]),
                                         jnp.asarray(g["chis"])))
        return out

    want = jax.jit(jax_side)()
    got = [hm.get_power(a, b) for a, b in pairs]
    got.append(hm.get_power_2halo("cib545", "cib217", fnl=20.0))
    got.append(hm.get_cib_cls(ELLS, "cib545", "cib217"))
    for i, (gv, wv) in enumerate(zip(got, want)):
        assert _rel(gv, wv) <= GATE, i
    # the pair term of one scattered profile differs from the product of
    # its means (Jensen)
    t1, t2 = hm.cib_tracers["cib545"], hm.cib_tracers["cib217"]
    sq = tpwr._cib_square_term(t1, t2)
    apart = tpwr._cib_square_term(t1, t2._replace(us2=t2.us2.clone()))
    assert float((sq - apart).abs().max()) > 0.0


# ---- HI ------------------------------------------------------------------------

def test_hi_matches_jax(hm):
    g = _grids(hm)
    rc0 = float(hm.rho_critical_z(0.0))
    nzm, bh = jnp.asarray(g["nzm"]), jnp.asarray(g["bh"])
    us = {n: jnp.asarray(_np(hm.uk_profiles[n])) for n in ("nfw", "nfw_fast")}
    pk_y = jnp.asarray(_np(hm.pk_profiles["y"]))
    p2 = {**thi.default_hi_params, **HI_OVERRIDE}

    def jax_side():
        t1, rho1 = jhi.build_hi_tracer(MS, nzm, us["nfw"])
        t2, _ = jhi.build_hi_tracer(MS, nzm, us["nfw_fast"], p2)
        om1 = jhi.omega_hi(nzm, MS, rc0)
        om2 = jhi.omega_hi(nzm, MS, rc0, p2)
        tb1 = jhi.mean_brightness_temp_mk(ZS, jbg.e_of_z(
            jbg.background(jmerge(PARAMS)), jnp.asarray(ZS)), om1, hm.h)
        tb2 = jhi.mean_brightness_temp_mk(ZS, jbg.e_of_z(
            jbg.background(jmerge(PARAMS)), jnp.asarray(ZS)), om2, hm.h)
        y = jpwr.PressureTracer(pk=pk_y)
        pw = lambda a, b: jpwr.power_total(a, b, nzm, bh, MS, KS,
                                           jnp.asarray(g["pzk"]), g["rho0"],
                                           g["kstar"])
        return [jhi.m_hi(jnp.asarray(MS)), jhi.m_hi(jnp.asarray(MS), p2),
                rho1, t1.fs, t2.fs, om1, om2, jhi.hi_bias(nzm, bh, MS),
                jhi.hi_bias(nzm, bh, MS, p2),
                (tb1**2)[:, None] * pw(t1, t1),
                (tb1 * tb2)[:, None] * pw(t1, t2), pw(t1, y)]

    want = jax.jit(jax_side)()
    ms = hm.ms
    got = [thi.m_hi(ms), thi.m_hi(ms, p2), thi.rho_hi(hm.nzm, ms),
           hm.cib_tracers["hi"].fs, hm.cib_tracers["hi2"].fs,
           hm.get_omega_hi("hi"), hm.get_omega_hi("hi2"),
           hm.get_hi_bias("hi"), hm.get_hi_bias("hi2"), hm.get_p21("hi"),
           hm.get_p21("hi", "hi2"), hm.get_power("hi", "y")]
    for i, (gv, wv) in enumerate(zip(got, want)):
        assert _rel(gv, wv) <= GATE, i
    assert not bool(hm.cib_tracers["hi"].fc.any())
    # no name: the defaults, or the override given
    assert torch.equal(hm.get_omega_hi(), hm.get_omega_hi("hi"))
    assert torch.equal(hm.get_omega_hi(param_override=HI_OVERRIDE),
                       hm.get_omega_hi("hi2"))


# ---- cluster lensing -----------------------------------------------------------

def test_cluster_lensing_matches_jax(hm):
    """sigma_nfw, the 1-halo Sigma (mean and critical density, at z and at
    0; miscentered) and kappa at M = 3e14 Msun, and the 2-halo kappa with
    the bias of each z row at M."""
    bgj = jbg.background(jmerge(PARAMS))
    # x = R / rs away from 1; the band around 1 is the next test's
    x = np.concatenate([[1.0, 1.0 - 1e-10, 1.0 + 1e-10],
                        RNG.uniform(0.01, 0.98, 10),
                        RNG.uniform(1.02, 5.0, 10)])
    R, rs, rho = x * 0.3, 0.3, 2e15
    bh_m = _np(hm.bh)
    kw_sets = ({}, {"rho": "critical", "rho_at_z": False},
               {"sig_theta": 2e-4})

    def jax_side():
        bh_at = jax.vmap(lambda row: jnp.interp(3e14, MS, row))(
            jnp.asarray(bh_m))
        out = [jcl.sigma_nfw(jnp.asarray(R), rs, rho)]
        out += [jcl.sigma_1h_profiles(bgj, jnp.asarray(ZS), THETAS, 3e14,
                                      4.0, **kw) for kw in kw_sets]
        out.append(jcl.kappa_1h_profiles(bgj, jnp.asarray(ZS), THETAS, 3e14,
                                         4.0, 1100.0))
        out.append(jcl.kappa_2h_profiles(bgj, jnp.asarray(ZS), KS,
                                         jnp.asarray(_np(hm.Pzk)), bh_at,
                                         THETAS, 1100.0))
        return out

    want = jax.jit(jax_side)()
    got = [tcl.sigma_nfw(T(R), rs, rho)]
    got += [hm.sigma_1h_profiles(THETAS, 3e14, 4.0, **kw) for kw in kw_sets]
    got.append(hm.kappa_1h_profiles(THETAS, 3e14, 4.0, 1100.0))
    got.append(hm.kappa_2h_profiles(THETAS, 3e14, 1100.0))
    for i, (gv, wv) in enumerate(zip(got, want)):
        err = _to_max(gv, wv) if i == len(got) - 1 else _rel(gv, wv)
        assert err <= GATE, i


def test_sigma_nfw_near_the_scale_radius():
    """Within 1e-2 of x = R / rs = 1 the closed form (1 - F) / (x^2 - 1)
    cancels: both packages lose digits there (1.6e-8 of the exact value at
    |x - 1| = 1e-8), and an ulp of atanh or atan moves the result by that
    much, so the two are held to the exact value (mpmath, 50 digits), the
    port no further from it than twice JAX's error, and not to each
    other."""
    mpmath = pytest.importorskip("mpmath")
    mpmath.mp.dps = 50

    def exact(v):
        v = mpmath.mpf(float(v))
        s = mpmath.sqrt(abs(1 - v * v))
        F = mpmath.atanh(s) / s if v < 1 else mpmath.atan(s) / s
        return float(2 * mpmath.mpf(0.3) * mpmath.mpf(2e15) * (1 - F)
                     / (v * v - 1))

    x = np.concatenate([1.0 + np.geomspace(1e-8, 1e-2, 30),
                        1.0 - np.geomspace(1e-8, 1e-2, 30)])
    want = np.array([exact(v) for v in x * 0.3 / 0.3])
    e_jax = np.abs(np.asarray(jax.jit(lambda: jcl.sigma_nfw(
        jnp.asarray(x * 0.3), 0.3, 2e15))()) / want - 1.0)
    e_port = np.abs(_np(tcl.sigma_nfw(T(x * 0.3), 0.3, 2e15)) / want - 1.0)
    assert e_jax.max() < 1e-7
    assert np.all(e_port <= 2.0 * e_jax + 1e-14)


# ---- on the card -----------------------------------------------------------------

@pytest.mark.gpu
def test_extensions_on_the_card_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def build(device):
        hm = thm.HaloModel(ZS, KS, ms=MS, params=PARAMS, halofit="mead",
                           device=device)
        hm.add_nfw_profile("nfw_fast", fast=True)
        hm.add_cib_tracer("cib545", 545.0, satellite_profile="nfw_fast")
        hm.add_cib_tracer("cib217", 217.0, satellite_profile="nfw_fast")
        hm.add_battaglia_pres_profile("y")
        hm.add_hi_tracer("hi", profile_name="nfw_fast")
        return hm

    cpu = build("cpu")
    before = (nk.nfw_uk_fast.launches, rk.pair_lerp_f64.launches)
    gpu = build("cuda")
    assert (nk.nfw_uk_fast.launches - before[0],
            rk.pair_lerp_f64.launches - before[1]) == (1, 1)
    for what, fn, gate in (
            ("nPzk", lambda h: h.nPzk, GATE),
            ("mead2020", lambda h: h.P_mm_nonlinear(KS, ZS, "mead2020"),
             GATE),
            ("takahashi", lambda h: h.P_mm_nonlinear(KS, ZS, "takahashi"),
             GATE),
            ("cls", lambda h: h.get_cib_cls(ELLS, "cib545", "cib217"),
             FAST_GATE),
            ("cib x y", lambda h: h.get_power("cib545", "y"), FAST_GATE),
            ("p21", lambda h: h.get_p21("hi"), FAST_GATE),
            ("kappa_1h", lambda h: h.kappa_1h_profiles(THETAS, 3e14, 4.0,
                                                      1100.0), GATE),
            ("cmb", lambda h: h.cmb_lensing_limber(200)[1], GATE)):
        got = fn(gpu)
        assert got.is_cuda and _rel(got, fn(cpu)) <= gate, what
