"""PyTorch port, the class API, part 1: the free functions that the class
API needs (ops/quadrature, ops/special, ops/fftlog.correlation_function,
ops/sine_transform.uk_fft / uk_brute_force,
background.redshift_at_comoving_radial_distance), every ported method of
``Cosmology`` with its constructor options, against the JAX package on the
CPU with inputs made by numpy from a seed; and the parity of the port's
public names and class methods with the JAX package's.  Both sides are
float64 with the same algorithm: 1e-10 relative unless a test says
otherwise.  The JAX side of each test runs under one ``jax.jit`` (the
instance is built outside it): the same functions in one program, which
compiles in a fraction of the time of their operations one by one."""

import ast
import inspect
import pathlib

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    import hmvec_tpu
    from hmvec_tpu.models import background as jbg
    from hmvec_tpu.models import cosmology as jcos
    from hmvec_tpu.models import halo_model as jhm
    from hmvec_tpu.models import ksz as jksz
    from hmvec_tpu.ops import fftlog as jfftlog
    from hmvec_tpu.ops import quadrature as jquad
    from hmvec_tpu.ops import sine_transform as jst
    from hmvec_tpu.ops import special as jspecial
except ImportError:    # a machine with the card and no JAX
    jnp = None

import hmvec_tpu_torch
from hmvec_tpu_torch.models import background as tbg
from hmvec_tpu_torch.models import cosmology as tcos
from hmvec_tpu_torch.models import halo_model as thm
from hmvec_tpu_torch.models import ksz as tksz
from hmvec_tpu_torch.ops import fftlog as tfftlog
from hmvec_tpu_torch.ops import quadrature as tquad
from hmvec_tpu_torch.ops import sine_transform as tst
from hmvec_tpu_torch.ops import special as tspecial

RNG = np.random.default_rng(29)
PARAMS = {"omch2": 0.117, "As": 2.1e-9, "H0": 68.5, "mnu": 0.06}
ZS = np.sort(RNG.uniform(0.05, 3.0, 5))
KS = np.geomspace(1e-4, 50.0, 40)
T = torch.as_tensor

# the public names of hmvec_tpu/__init__.py that the port does not have
# yet, by the group of ROADMAP A9 that brings them, and the ones it will
# not have (A10)
NOT_PORTED = {
    "boltz": ("BoltzEngine", "rs_drag_integral"),
    "emulator": ("Emulator", "fit_emulator", "pipeline_target",
                 "save_emulator", "load_emulator", "sample_params"),
    "projfield/flatsky": ("flatsky", "filtered_bispectrum_cl",
                          "cl_ksz2_galaxy", "hybrid_bispectrum_ttg",
                          "vrms2_linear", "cl_t2_lensing",
                          "bispectrum_ttg_lensing", "cl_t2_t2_gaussian",
                          "ksz2_snr", "cl_ksz2_kappa"),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got / want - 1.0)))


def _jit(fn):
    """fn() evaluated by the JAX package in one compiled program."""
    return jax.jit(fn)()


def _abs_to_max(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ---- the public names ------------------------------------------------------

def _jax_root_names():
    """The public names that hmvec_tpu/__init__.py imports or assigns."""
    src = pathlib.Path(hmvec_tpu.__file__).read_text()
    names = set()
    for node in ast.parse(src).body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return sorted(n for n in names if not n.startswith("_"))


def test_every_public_name_is_ported_or_listed():
    listed = {n for names in NOT_PORTED.values() for n in names}
    names = _jax_root_names()
    missing = [n for n in names
               if not hasattr(hmvec_tpu_torch, n) and n not in listed]
    assert not missing, f"neither ported nor listed: {missing}"
    stale = [n for n in listed if hasattr(hmvec_tpu_torch, n)]
    assert not stale, f"ported, so no longer to be listed: {stale}"
    assert listed <= set(names)
    assert hmvec_tpu_torch.bias is hmvec_tpu_torch.bias_tinker


def _public_methods(cls):
    return sorted(n for n, v in inspect.getmembers(cls)
                  if not n.startswith("_") and callable(v))


@pytest.mark.parametrize("name", ["Cosmology", "HaloModel", "kSZ"])
def test_every_public_method_is_ported_or_deferred(name):
    jcls = {"Cosmology": jcos.Cosmology, "HaloModel": jhm.HaloModel,
            "kSZ": jksz.kSZ}[name]
    tcls = getattr(hmvec_tpu_torch, name)
    deferred = {**tcos.DEFERRED, **thm.DEFERRED}
    for meth in _public_methods(jcls):
        assert hasattr(tcls, meth), f"{name}.{meth} is missing"
        group = getattr(getattr(tcls, meth), "deferred_group", None)
        assert group == deferred.get(meth), meth


def test_deferred_methods_raise_naming_their_group():
    """No method is deferred any more; the one path still refused,
    get_cmb_cls(approx=True) without a table, names its group (the
    Boltzmann solver of ROADMAP A9)."""
    hm = thm.HaloModel(ZS[:2], KS[:8], ms=np.geomspace(1e11, 1e15, 6),
                       device="cpu")
    assert tcos.DEFERRED == {} and thm.DEFERRED == {}
    with pytest.raises(NotImplementedError, match="boltz group"):
        hm.get_cmb_cls(lmax=100, approx=True)


def test_the_classes_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        tcos.Cosmology()
    with pytest.raises(RuntimeError, match="cuda"):
        tksz.get_survey_volume(0.3, 0.6, 0.1)


# ---- free functions ----------------------------------------------------------

def test_quadrature_matches_jax():
    x = np.sort(RNG.uniform(0.0, 3.0, 17))
    y = RNG.standard_normal((3, 17))
    y2 = RNG.standard_normal((17, 4))
    want = _jit(lambda: (jquad.trapz_traced(jnp.asarray(y), jnp.asarray(x)),
                         jquad.simpson(jnp.asarray(y), x),
                         jquad.simpson(jnp.asarray(y2), x, axis=0)))
    got = (tquad.trapz_traced(T(y), T(x)), tquad.simpson(T(y), x),
           tquad.simpson(T(y2), x, axis=0))
    for g, w in zip(got, want):
        assert _abs_to_max(g, w) <= 1e-14


def test_linear_interp_is_jnp_interp():
    xp = np.sort(RNG.uniform(0.0, 1.0, 12))
    xp[5] = xp[4]                           # a repeated node
    fp = RNG.standard_normal(12)
    # outside both ends, on every node (the last one too), in between
    x = np.concatenate([[-0.5, xp[0] - 1e-3, 1.5], xp,
                        RNG.uniform(xp[0], xp[-1], 40)])
    ends = ((None, None), (0.0, 0.0), (-3.0, 7.0))
    want = _jit(lambda: [jnp.interp(x, xp, fp, left=lo, right=hi)
                         for lo, hi in ends]
                + [jquad.interp(xp, fp, False, -1.0)(x)])
    outside = (x < xp[0]) | (x > xp[-1])
    # the same interval and end value everywhere: equal to an ulp or two
    # (XLA may fuse the lerp into one multiply-add), exactly equal outside
    for (lo, hi), w in zip(ends, want):
        got = _np(tquad.linear_interp(T(x), T(xp), T(fp), left=lo, right=hi))
        np.testing.assert_allclose(got, np.asarray(w), rtol=0, atol=1e-15)
        np.testing.assert_array_equal(got[outside], np.asarray(w)[outside])
    f = tquad.interp(xp, fp, fill_value=-1.0)
    np.testing.assert_allclose(_np(f(x)), np.asarray(want[-1]), rtol=0,
                               atol=1e-15)
    with pytest.raises(NotImplementedError):
        tquad.interp(xp, fp, bounds_error=True)


def test_bessel_and_disk_window_match_jax():
    x = np.concatenate([[0.0, 1e-4, 8.0], RNG.uniform(0.0, 40.0, 60)])
    xd = np.concatenate([[0.0, 5e-4], x[1:]])
    want = _jit(lambda: (jspecial.j0(x), jspecial.j1(x),
                         jspecial.disk_window(xd)))
    got = (tspecial.j0(T(x)), tspecial.j1(T(x)), tspecial.disk_window(T(xd)))
    for g, w in zip(got, want):
        assert _abs_to_max(g, w) <= 1e-12


def test_correlation_function_matches_jax():
    ks = np.geomspace(1e-4, 1e2, 256)
    pk = np.stack([1e4 * ks / (1.0 + (ks / 0.02) ** 2.6) * a
                   for a in (1.0, 0.5)])
    rs_t, xi_t = tfftlog.correlation_function(ks, T(pk))
    rs_j, xi_j = _jit(lambda: jfftlog.correlation_function(ks,
                                                           jnp.asarray(pk)))
    assert _rel(rs_t, rs_j) <= 1e-14
    assert _abs_to_max(xi_t, xi_j) <= 1e-12


def test_uk_validators_match_jax():
    rvir = np.array([1.5, 2.5])
    r = np.linspace(0.01, 5.0, 300)
    rho = 1.0 / r / (1.0 + r) ** 2
    ks = np.geomspace(0.1, 20.0, 15)

    def nfw(rr):
        return 1.0 / rr / (1.0 + rr) ** 2

    kts_j, uk_j, bf_j = _jit(lambda: (
        *jst.uk_fft(nfw, jnp.asarray(rvir), dr=0.01, rmax=10.0),
        jst.uk_brute_force(r, rho, 2.0, ks)))
    kts_t, uk_t = tst.uk_fft(nfw, T(rvir), dr=0.01, rmax=10.0)
    assert _rel(kts_t[1:], np.asarray(kts_j)[1:]) <= 1e-14
    assert _abs_to_max(uk_t, uk_j) <= 1e-10
    assert _abs_to_max(tst.uk_brute_force(T(r), T(rho), 2.0, T(ks)),
                       bf_j) <= 1e-12


@pytest.mark.parametrize("extra", [{}, {"omk": 0.05}, {"w0": -0.9, "wa": 0.2}])
def test_redshift_at_comoving_radial_distance_matches_jax(extra):
    ov = {**PARAMS, **extra}
    cj = jcos.Cosmology(ov)
    ct = tcos.Cosmology(ov, device="cpu")
    chi = RNG.uniform(10.0, 6000.0, (2, 7))
    want = _jit(lambda: cj.redshift_at_comoving_radial_distance(
        jnp.asarray(chi)))
    got = ct.redshift_at_comoving_radial_distance(chi)
    assert _rel(got, want) <= 1e-12
    # the Newton step carries the implicit derivative dz/dchi = 1/chi'(z)
    c0 = T(chi[0], dtype=torch.float64).requires_grad_()
    z = tbg.redshift_at_comoving_radial_distance(ct.bg, c0)
    (g,) = torch.autograd.grad(z.sum(), c0)
    assert _rel(g, _np(tbg.h_of_z(ct.bg, z.detach()))) <= 1e-10


# ---- the Cosmology class -----------------------------------------------------

@pytest.fixture(scope="module")
def cosmos():
    """JAX and torch Cosmology at PARAMS, closed and integrated growth."""
    return {g: (jcos.Cosmology(PARAMS, growth=g),
                tcos.Cosmology(PARAMS, growth=g, device="cpu"))
            for g in ("closed", "ode")}


def test_host_scalars_match_jax(cosmos):
    cj, ct = cosmos["closed"]
    for key in ("h", "omm0", "omk0", "oml0", "ombh2", "as8", "YHe"):
        assert isinstance(getattr(ct, key), float)
        assert getattr(ct, key) == getattr(cj, key), key
    assert ct.growth_mode == cj.growth_mode == "closed"
    assert tcos.Cosmology({"w0": -0.9}, device="cpu").growth_mode == "ode"


BACKGROUND = ("hubble_parameter", "h_of_z", "comoving_radial_distance",
              "angular_diameter_distance", "rho_critical_z", "rho_matter_z",
              "omz", "get_growth_rate_f")


def _background(c, zs, zl, zh):
    return ([getattr(c, m)(zs) for m in BACKGROUND]
            + [c.angular_diameter_distance(zl, zh),
               c.sigma_crit(0.3, zh), c.get_Omega_nu()])


def test_background_methods_match_jax(cosmos):
    cj, ct = cosmos["closed"]
    want = _jit(lambda: _background(cj, jnp.asarray(ZS), jnp.asarray(ZS[:2]),
                                    jnp.asarray(ZS[2:4])))
    got = _background(ct, ZS, ZS[:2], ZS[2:4])
    for name, g, w in zip(BACKGROUND + ("D_A(z1, z2)", "sigma_crit",
                                        "Omega_nu"), got, want):
        assert _rel(g, w) <= 1e-12, name


def _growth(c, a, zs, ks, growth):
    if growth == "ode":
        # the methods whose arithmetic the growth mode changes (each
        # integrates its own table, a 384-step scan to compile in JAX)
        return [c.D_growth(a, type="z0norm"), c.get_growth_rate_f(zs)]
    return ([c.D_growth_approx(a), c.D_growth(a, type="anorm"),
             c.D_growth(a, type="z0norm"), c.D_growth(a, exact=True),
             c.D_growth_exact_arbitrary_norm(a), c.get_growth_rate_f(zs),
             c.alpha_fnl(zs, ks), c.bias_fnl(2.0, 5.0, 0.8, ks)])


@pytest.mark.parametrize("growth", ["closed", "ode"])
def test_growth_methods_match_jax(cosmos, growth):
    cj, ct = cosmos[growth]
    a, ks = 1.0 / (1.0 + ZS), KS[::5]
    want = _jit(lambda: _growth(cj, jnp.asarray(a), jnp.asarray(ZS),
                                jnp.asarray(ks), growth))
    for g, w in zip(_growth(ct, a, ZS, ks, growth), want):
        assert _rel(g, w) <= 1e-10


R_SIGMA = np.geomspace(0.5, 20.0, 6)


def _linear(c, ks, zs, growth):
    if growth == "ode":
        return [c.P_lin(ks, zs)]     # the same engine call, another growth
    out = [c.Tk(ks, kind) for kind in ("eisenhu_osc", "eisenhu")]
    out += [c.P_lin_approx(ks, zs, kind) for kind in ("eisenhu_osc",
                                                       "eisenhu")]
    out += [c.P_lin(ks, zs), c.P_lin_slow(ks, zs), c.P_mm_linear(zs, ks),
            c.get_sigma2_R(R_SIGMA, zs[:2], numks=2000),
            c.get_sigma8(zs[:2])]
    out += [c.get_pk_interpolator(ZS, 10.0, var=var).P(zs[:3], ks[:3],
                                                       grid=False)
            for var in ("total", "cb", "weyl")]
    return out


@pytest.mark.parametrize("growth", ["closed", "ode"])
def test_linear_power_methods_match_jax(cosmos, growth):
    cj, ct = cosmos[growth]
    want = _jit(lambda: _linear(cj, jnp.asarray(KS), jnp.asarray(ZS),
                                growth))
    for i, (g, w) in enumerate(zip(_linear(ct, KS, ZS, growth), want)):
        assert _rel(g, w) <= 1e-10, i
    _, zarr, karr = ct.get_pk_interpolator(ZS, 10.0, return_z_k=True)
    _, zj2, kj2 = cj.get_pk_interpolator(ZS, 10.0, return_z_k=True)
    np.testing.assert_array_equal(zarr, zj2)
    np.testing.assert_array_equal(karr, kj2)


def test_limber_methods_match_jax(cosmos):
    cj, ct = cosmos["closed"]
    zs = np.linspace(0.05, 3.0, 12)
    ks = np.geomspace(1e-4, 50.0, 30)
    ells = np.geomspace(30.0, 2000.0, 7)
    P = np.exp(RNG.uniform(0.0, 1.0, (zs.size, ks.size))) \
        * (1e4 * ks / (1.0 + (ks / 0.02) ** 2.6))[None, :]
    gzs = np.linspace(0.1, 2.0, 9)
    gdndz = np.exp(-((gzs - 0.8) / 0.3) ** 2)
    calls = (("C_kk", (), {"lzs1": 1100.0, "lzs2": 1100.0}),
             ("C_kg", (gzs,), {"gdndz": gdndz, "lzs": 1100.0}),
             ("C_gg", (gzs,), {"gdndz": gdndz}),
             ("C_gy", (gzs,), {"gdndz": gdndz}),
             ("C_ky", (), {"lzs1": 1100.0}),
             ("C_yy", (), {}))

    def limber(c, p, f):
        out = [c.lensing_window(zs, 1100.0)]
        out += [getattr(c, m)(ells, zs, ks, p, *a, **kw)
                for m, a, kw in calls]
        return out + [c.total_matter_power_spectrum(p, 0.9 * p, 0.8 * p),
                      c.total_matter_galaxy_power_spectrum(p, 0.9 * p)]

    want = _jit(lambda: limber(cj, jnp.asarray(P), jnp.asarray))
    got = limber(ct, T(P), T)
    names = ("lensing_window",) + tuple(m for m, _, _ in calls) + (
        "total_matter_power_spectrum", "total_matter_galaxy_power_spectrum")
    for name, g, w in zip(names, got, want):
        assert _rel(g, w) <= 1e-10, name


@pytest.mark.parametrize("key, value", [("sigma8", 0.79), ("S8", 0.81)])
def test_amplitude_rescale_matches_jax(cosmos, key, value):
    """sigma8 / S8 rescale As as the JAX constructor does: by the ratio of
    the requested amplitude to sigma8 at z = 0 from the default sigma^2
    grid (JAX's get_sigma2_R at 8/h Mpc, under one jit)."""
    cj, _ = cosmos["closed"]
    s8 = float(np.sqrt(_jit(lambda: cj.get_sigma2_R(
        jnp.asarray([8.0 / cj.h]), jnp.asarray([0.0])))[0, 0]))
    target = value if key == "sigma8" else value / np.sqrt(cj.omm0 / 0.3)
    as_want = PARAMS["As"] * (target / s8) ** 2
    ct = tcos.Cosmology({**PARAMS, key: value}, device="cpu")
    assert abs(ct.p["As"] / as_want - 1.0) <= 1e-12
    assert float(ct.get_sigma8([0.0], numks=10000, kmax=2000.0)[0]) \
        == pytest.approx(target, rel=1e-12)


def test_tabulated_engine_matches_jax():
    zt = np.linspace(0.0, 3.5, 8)
    kt = np.geomspace(1e-5, 100.0, 50)
    base = 2e4 * kt / (1.0 + (kt / 0.02) ** 2.6)
    pt = base[None, :] / (1.0 + zt[:, None]) ** 2
    pnl = pt * (1.0 + (kt / 0.5) ** 1.5)[None, :]
    table = (zt, kt, pt, pnl)
    cj = jcos.Cosmology(PARAMS, engine="camb", pk_table=table)
    ct = tcos.Cosmology(PARAMS, engine="camb", pk_table=table, device="cpu")

    def tabulated(c, ks, zs):
        return [c.P_lin(ks, zs), c.P_lin_slow(ks, zs), c.P_mm_linear(zs, ks),
                c.P_mm_nonlinear(ks, zs)]

    want = _jit(lambda: tabulated(cj, jnp.asarray(KS), jnp.asarray(ZS)))
    for g, w in zip(tabulated(ct, KS, ZS), want):
        assert _rel(g, w) <= 1e-10


def test_free_class_helpers_match_jax():
    a = RNG.uniform(0.2, 1.0, 5)
    assert _rel(tcos.a2z(a), jcos.a2z(a)) <= 1e-15
    assert tcos.get_eds_model(0.16, 70.0) == jcos.get_eds_model(0.16, 70.0)
    assert tksz.get_survey_volume(0.3, 0.9, 0.4, PARAMS, device="cpu") \
        == pytest.approx(jksz.get_survey_volume(0.3, 0.9, 0.4, PARAMS),
                         rel=1e-12)
