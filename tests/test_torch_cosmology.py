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
    from _torch_jax import Prefetch
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
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(x):
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


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
    f = tquad.interp(xp, fp, fill_value=-1.0, device="cpu")
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
    assert _rel(tcos.a2z(a, device="cpu"), jcos.a2z(a)) <= 1e-15
    assert tcos.get_eds_model(0.16, 70.0) == jcos.get_eds_model(0.16, 70.0)
    assert tksz.get_survey_volume(0.3, 0.9, 0.4, PARAMS, device="cpu") \
        == pytest.approx(jksz.get_survey_volume(0.3, 0.9, 0.4, PARAMS),
                         rel=1e-12)


# ---- the free functions on host data ---------------------------------------

def _host_inputs():
    """{name: args} of every free function of the package root that makes
    tensors of what it is given, on small numpy inputs that both packages
    take (the integral grids of spt/tns cut to a few dozen nodes)."""
    from hmvec_tpu_torch.params import battaglia_defaults, default_params

    rng = np.random.default_rng(31)
    ks = np.geomspace(1e-3, 10.0, 64)
    pk = 1e4 * ks / (1.0 + (ks / 0.02) ** 2.5)
    zs = np.array([0.2, 0.5, 1.0])
    ms = np.geomspace(1e12, 1e15, 8)
    ells = np.arange(2.0, 40.0)
    cls = 1e-9 / (ells + 10.0) ** 1.5
    x = np.geomspace(0.01, 5.0, 20)
    chis = np.array([800.0, 1500.0, 2500.0])
    nzm = rng.uniform(0.5, 1.5, (3, 8)) * 1e-15
    uk = rng.uniform(0.2, 1.0, (3, 8, 64))
    nu = np.linspace(0.5, 3.0, 5)
    gas = (np.array([1e14, 3e14]), 0.3, 0.049, 0.31, 1.3e11)
    q = {"n_q": 48, "n_x": 24}
    loop = {**q, "n_q13": 48}
    ab = {"A": {(1, 1): pk, (2, 1): pk * 0.5}, "B": {(2, 1): pk * 0.2}}
    mus = np.linspace(-1.0, 1.0, 5)
    lms = np.linspace(12.0, 14.0, 4)
    hp = dict(default_params)
    model = lambda k, mu: 1e4 * k / (1.0 + (k / 0.02) ** 2.5) * (1 + mu**2)
    fl = np.arange(2.0, 601.0)
    fv = 1.0 / (1.0 + (fl / 300.0) ** 2)
    cl_int = np.concatenate([[0.0, 0.0], 1e-9 / (fl + 10.0) ** 1.5])
    few = {"n_radial": 8, "n_angle": 6}
    bessel = (rng.uniform(0.5, 1.5, 32), np.geomspace(100.0, 3000.0, 32),
              np.array([10, 20]))
    return {
        "Fcon": (np.array([5.0, 7.0]),),
        "rho_einasto_x": (x,), "rho_nfw": (x, 1.0, 0.3),
        "rhoscale_nfw": (ms, np.ones(8), 5.0 * np.ones(8)),
        "P_e": (x[:, None], *gas), "P_e_generic": (x[:, None], *gas),
        "P_e_generic_x": (x[:, None], gas[0], np.array([1.0, 1.2]),
                          *gas[1:]),
        "rho_gas": (x[:, None], *gas), "rho_gas_generic": (x[:, None], *gas),
        "rho_gas_generic_x": (x[:, None], *gas),
        "concentration_bhattacharya": (rng.uniform(0.5, 4.0, (3, 8)),
                                       np.array([1.0, 0.8, 0.6]), "vir"),
        "Mhalo_stellar": (zs, np.linspace(10.0, 11.0, 4)[None, :]),
        "Mstellar_halo": (zs, lms),
        "Mhalo_stellar_core": (np.linspace(10.0, 11.0, 4), 0.5,
                               10.72, 0.55, 12.35, 0.28, 0.44, 0.18, 1.56,
                               2.51, 0.57, 0.17),
        "avg_Ns": (lms[None, :], zs[:, None], np.full((3, 1), 10.5), None,
                   0.2, 1.0, 1.0, 1.0, 1.0, 1.0),
        "avg_NsNsm1": (np.array([0.0, 0.5, 1.0]), np.array([0.1, 0.2, 2.0])),
        "avg_nc_zheng05": (lms, 12.5, 0.2),
        "avg_ns_zheng05": (ms, np.full(8, 0.9), 1e12, 1e13, 1.0),
        "build_hod_zheng05": (zs, ms, nzm, np.ones((3, 8)), hp),
        "ngal_from_mthresh": (np.full(3, 10.5), zs, nzm, ms, hp),
        "NlnMsub": (np.geomspace(1e10, 1e13, 5), ms),
        "bias": (nu,), "bias_tinker": (nu,), "simple_f_nu": (nu,),
        "f_nu": (nu, zs[:1]),
        "mdelta_from_mdelta": (ms, rng.uniform(4.0, 8.0, (3, 8)),
                               np.array([200.0, 210.0, 220.0]),
                               np.array([500.0, 510.0, 520.0])),
        "mdelta_from_mdelta_unvectorized": (ms, 5.0 * np.ones(8), 200.0,
                                            500.0),
        "a2z": (np.array([0.5, 0.8]),),
        "Wkr": (ks, 8.0), "interp": (ks, pk),
        "analytic_fft_integral": (ks,),
        "fft_integral": (x, np.exp(-x**2 / 2)),
        "uk_brute_force": (x, 1.0 / x, 3.0, ks[:5]),
        "uk_fft": (lambda r: 1.0 / r, np.array([1.0, 2.0]), 0.01, 5.0),
        "generic_profile_fft": (lambda x: 1.0 / (x * (1.0 + x) ** 2),
                                rng.uniform(3.0, 6.0, (3, 8)),
                                rng.uniform(0.05, 0.3, (3, 8)), zs, ks,
                                20.0, 256),
        "invert_monotone": (lambda y: y**2, np.array([1.0, 4.0]), 0.0, 10.0),
        "vectorized_bisection_search": (np.array([1.0, 4.0]),
                                        lambda y: y**2, (0.0, 10.0)),
        "ksz_radial_function": (0.5, 0.022, 0.24),
        "get_interpolated_cls": (np.full(2000, 1e-5), 100.0, ks),
        "Nvv_core_integral": (3000.0, 1.0, np.linspace(0.1, 1.0, 5),
                              np.geomspace(1e-3, 0.1, 4), ks[:40],
                              np.full(2000, 1e-5), pk[:40], 2 * pk[:40]),
        "pge_err_core": (2.0, 0.1, 300.0, 1.0, ks[:40],
                         np.geomspace(1e-3, 0.5, 5), 2 * pk[:40],
                         np.full(2000, 1e-5)),
        "sed_graybody": (545.0, zs, dict(hmvec_tpu_torch.default_cib_params)),
        "cib_luminosity": (ms, zs, 545.0,
                           dict(hmvec_tpu_torch.default_cib_params)),
        "bin_annuli": (ells, cls, np.array([2.0, 10.0, 30.0])),
        "knox_cov": (cls, cls, cls, cls, ells, np.ones_like(ells), 0.5),
        "pk_cov_gaussian": (ks, pk, 1e9), "pk_cov_ssc": (pk[:6], 1e-5),
        "pk_response_ssc": (ks, pk),
        "sigma_b2_tophat": (1e9, ks, pk),
        "sigma_b2_disk": (0.1, chis[:2], ks, np.stack([pk, pk])),
        "trispectrum_1h": (nzm, ms, 1e11, uk),
        "trispectrum_1h_terms": (nzm, ms, uk, uk),
        "cl_cov_t1h": (ells[:5], zs, ks, rng.uniform(0.5, 1.5, (3, 64, 64)),
                       np.ones(3), np.ones(3), np.ones(3), chis),
        "limber_integral": (ells, zs, ks, np.stack([pk] * 3), zs,
                            np.ones(3), np.ones(3), np.ones(3), chis),
        "projected_bispectrum": (ells[:4], ells[:4], ells[:4], zs, np.ones(3),
                                 chis, np.ones(3), np.ones(3), np.ones(3),
                                 lambda a, b, c: a * b * c),
        "bessel_deltas": bessel, "bessel_deltas_j2pp": bessel,
        "bessel_deltas_over_x2": bessel,
        "exclusion_correction": (ks, np.stack([pk] * 3),
                                 np.array([1.0, 1.5, 2.0])),
        "correlation_function": (ks, pk), "projected_correlation": (ks, pk),
        "correlation_multipoles": (ks, {0: pk, 2: pk * 0.5}),
        "mean_pairwise_velocity": (ks, pk, 0.6, 70.0),
        "pairwise_ksz_signal": (ks, pk, 0.6, 70.0, 1.5, 1e-4),
        "pairwise_ksz_errors": (np.linspace(10.0, 100.0, 5),
                                np.linspace(1.0, 200.0, 50),
                                np.full(50, 0.1), np.ones(50), 1e-4, 1.0,
                                1.0),
        "tau_aperture_battaglia": (zs, np.full((3, 8), 1e14),
                                   np.ones((3, 8)), np.full((3, 8), 3.0),
                                   np.full(3, 1e11), 0.049, 0.31, 1.0, -0.2,
                                   dict(battaglia_defaults["AGN"]), 32),
        "kaiser_pk_mu": (ks, mus, pk, 1.5, 0.6),
        "rsd_multipoles": (ks, pk, 1.5, 0.6),
        "scoccimarro_pk_mu": (ks, mus, pk, pk * 0.9, pk * 0.8, 1.5, 0.6),
        "scoccimarro_multipoles": (ks, pk, pk * 0.9, pk * 0.8, 1.5, 0.6),
        "sigma_v_lin": (ks, pk),
        # above k = 1/Mpc, where the A/B kernels do not cancel
        "tns_ab_integrals": ((ks[-12:-8], ks, pk), q),
        "tns_power": ((ks[-12:-8], ks, pk), q),
        "tns_a_term": (ks, mus[:3], 0.6, ab),
        "tns_b_term": (ks, mus[:3], 0.6, ab),
        "tns_multipoles": (ks, pk, pk, pk, 1.5, 0.6, ab),
        "tns_pk_mu": (ks, mus[:3], pk, pk, pk, 1.5, 0.6, ab),
        "tns_pk_mu_points": (ks[:4], mus[:4], ks, pk, pk, pk, 1.5, 0.6, ab),
        "p13": ((ks[10:14], ks, pk), {"n_q": 48}),
        "p13_dt": ((ks[10:14], ks, pk), {"n_q": 48}),
        "p13_tt": ((ks[10:14], ks, pk), {"n_q": 48}),
        "p22": ((ks[10:14], ks, pk), q),
        "p22_velocity": ((ks[10:14], ks, pk), q),
        "p1loop": ((ks[10:14], ks, pk), loop),
        "pk_velocity_1loop": ((ks[10:14], ks, pk), loop),
        "pt_bias_integrals": ((ks[10:14], ks, pk), q),
        "pgg_1loop": ((ks[10:14], ks, pk, 1.5, 0.1), loop),
        "pgm_1loop": ((ks[10:14], ks, pk, 1.5, 0.1), loop),
        "p1loop_ir": ((ks[10:14], ks, pk, pk, 100.0), loop),
        "ap_shift": (ks, np.linspace(0.0, 1.0, 4), 1.02, 0.98),
        "ap_multipoles": ((ks, model, 1.02, 0.97), {"n_mu": 8}),
        "multipole_covariance": ((ks, model, 3e-4, 1e9), {"n_mu": 8}),
        "multipole_snr": ({0: pk, 2: pk * 0.5},
                          np.repeat(np.eye(2)[:, :, None], 64, 2), (0, 2)),
        "window_convolve_multipoles": (ks, {0: pk, 2: pk * 0.5},
                                       np.geomspace(1.0, 1000.0, 64),
                                       {0: np.ones(64), 2: np.zeros(64)}),
        "couple_cls": (np.eye(5) + 0.1, np.ones(5)),
        "decouple_bandpowers": (np.eye(11) + 0.01, np.ones(11), 10,
                                np.array([2, 5, 10])),
        "decoupled_covariance": (np.eye(11) + 0.01, np.eye(11), 10,
                                 np.array([2, 5, 10])),
        # models/projfield.py: a filter table, a closed-form bispectrum
        # that either array library evaluates, integer-l spectra
        "filtered_bispectrum_cl": ((np.array([100.0, 400.0]), (fl, fv),
                                    _b_test, 2.0, 600.0), few),
        "bispectrum_ttg_lensing": (cl_int, 0.1 * cl_int),
        "cl_t2_lensing": ((np.array([100.0, 400.0]), (fl, fv), cl_int,
                           0.1 * cl_int, 2.0, 600.0), few),
        "cl_t2_t2_gaussian": ((np.array([100.0, 400.0]), (fl, fv),
                               cl_int + 1e-5, 2.0, 600.0), few),
        "ksz2_snr": (ells[:4], cls[:4], 10.0 * cls[:4], 0.1 * cls[:4] + 1e-9,
                     0.4),
    }


def _b_test(l1, l2, l3):
    return (1.0 + l1 / 300.0) / (1.0 + (l2 / 700.0) ** 2) * l3 ** 0.5


HOST = _host_inputs()


def _lensing_host_inputs():
    """{name: args} of the root's weak-lensing, MASTER and CMB-lensing
    functions (and angular_correlation) on small numpy inputs: l up to
    ~200, quadratures of a few dozen nodes."""
    rng = np.random.default_rng(41)
    ells = np.arange(2, 60)
    cls = 1e-9 * (ells / 30.0) ** -1.2
    th = np.array([0.004, 0.03, 0.2])
    mask = 1.0 / (1.0 + np.arange(25.0)) ** 2
    lmax = 200
    l = np.arange(lmax + 1.0)
    ls = np.maximum(l, 1.0)
    cl_tt = 2e3 * 2.0 * np.pi / (ls * (ls + 1.0)) * np.exp(-(l / 900) ** 2)
    cl_ee, cl_te = 0.02 * cl_tt, 0.1 * cl_tt
    clpp = 2e-9 / ((ls / 60.0) ** 4 + (ls / 60.0) ** 2)
    for c in (cl_tt, cl_ee, cl_te, clpp):
        c[:2] = 0.0
    nl = 1e-5 * np.exp(l * (l + 1.0) * 1e-7)
    grad = {"TT": cl_tt, "EE": cl_ee, "TE": cl_te}
    total = {"TT": cl_tt + nl, "EE": cl_ee + 2 * nl, "BB": 2 * nl,
             "TE": cl_te}
    unl = np.stack([cl_tt, cl_ee, np.zeros_like(cl_tt), cl_te], -1)
    Ls = np.array([40.0, 120.0])
    o = {"lmin": 30, "lmax": lmax, "n_l": 24, "n_theta": 24}
    return {
        "angular_correlation": (ells, cls, th),
        "wigner_d_sum": (ells, cls, th, (2, 2)),
        "wigner_d_outer_sum": (ells, cls, th, (2, 2), (2, -2)),
        "xi_gaussian_cov": (ells, cls, cls, 0.5 * cls, 0.5 * cls, th,
                            "plus", "minus", 0.4),
        "kappa_to_shear_cl_factor": (np.arange(0.0, 10.0),),
        "xi_plus": (ells, cls, th, 0.1 * cls, "convergence"),
        "xi_minus": (ells, cls, th, 0.1 * cls),
        "gamma_t": (ells, cls, th),
        "bin_operator": (30, np.array([2, 10, 20, 31]),
                         rng.uniform(1.0, 2.0, 31)),
        "cap_mask_cl": (30, 0.3),
        "coupling_matrix": (12, mask, (2, 2)),
        "gaussian_covariance_nka": (12, mask, *(rng.uniform(1.0, 2.0, 13)
                                                for _ in range(4))),
        "lens_cls_flat_sky": ((unl, clpp), {"lmax_out": 150, "n_phi": 32}),
        "lens_cls_flat_sky_resummed": ((unl, clpp), {"lmax_out": 150,
                                                     "n_theta": 256}),
        "white_noise_nl": (l, 10.0, 1.4),
        "total_cl_tt": (cl_tt, 10.0, 1.4),
        "threej000_sq": (np.array([2, 10, 7]), np.array([3, 10, 3]),
                         np.array([5, 21, 3])),
        "n0_flat_sky": ((Ls, "EB", cl_ee, total["EE"], total["BB"]), o),
        "n0_kappa_from_phi": (Ls, np.array([1e-7, 3e-7])),
        "n0_minimum_variance": ([np.array([1e-7, 3e-7]),
                                 np.array([2e-7, 1e-7])],),
        "n0_pair_flat_sky": ((Ls, "TE", grad, total), o),
        "n0_cross_flat_sky": ((Ls, "TT", "EE", grad, total), o),
        "n0_mv_flat_sky": ((Ls, grad, total), {**o, "ests": ("TT", "EE")}),
        "lensed_bb_from_ee": ((cl_ee, clpp), {"lmax_out": 150, "n_phi": 32}),
        "n0_eb_iterative": ((Ls, cl_ee, total["EE"], clpp, 2 * nl),
                            {**o, "n_iter": 2, "n_phi": 32}),
        "n0_tt_fullsky": ((Ls, cl_tt, total["TT"]), {"lmin": 30,
                                                      "lmax": 120}),
        "n1_tt_flat_sky": ((Ls, cl_tt, total["TT"], clpp),
                           {"lmin": 30, "lmax": lmax, "n_l": 8,
                            "n_theta": 8, "n_s": 8, "n_alpha": 4}),
    }


LENSING_HOST = _lensing_host_inputs()
# the TNS A/B integrals: their kernels cancel catastrophically, so any two
# evaluation orders differ by more than 1e-10 (tests/test_torch_rsd.py
# holds them against the JAX package within its own spread); on host data
# they are held to the same call on CPU tensors, bit for bit
TNS_AB = ("tns_ab_integrals", "tns_power")


def _split_call(entry):
    return entry if (len(entry) == 2 and isinstance(entry[1], dict)
                     and isinstance(entry[0], tuple)) else (entry, {})


def _host_leaves(out):
    """The arrays of a result (a function's values at three points, in
    each of its arguments), depth first."""
    if callable(out) and not isinstance(out, (torch.Tensor, np.ndarray)):
        n_args = len(inspect.signature(out).parameters)
        return _host_leaves(out(*[np.array([0.01, 0.1, 1.0])] * n_args))
    if isinstance(out, dict):   # in key order, as jax.tree_util's
        return [a for k in sorted(out) for a in _host_leaves(out[k])]
    if isinstance(out, (list, tuple)):
        return [a for v in out for a in _host_leaves(v)]
    return [out]


# the JAX functions of HOST that read an input on the host (so run op by
# op); the rest run in one compiled program
JAX_EAGER = ("bispectrum_ttg_lensing", "cl_cov_t1h",
             "exclusion_correction", "interp",
             "mean_pairwise_velocity", "pairwise_ksz_signal",
             "projected_correlation", "sigma_b2_disk", "sigma_b2_tophat",
             "trispectrum_1h", "trispectrum_1h_terms",
             "window_convolve_multipoles")


def _jax_host():
    """{name: leaves} of the JAX package's function of every entry of
    HOST on its inputs (those of JAX_EAGER op by op, the rest in one
    jax.jit with the inputs as constants: one compile, not ninety)."""
    def call(name):
        args, kw = _split_call(HOST[name])
        return getattr(hmvec_tpu, name)(*args, **kw)

    compiled = [n for n in sorted(HOST) if n not in JAX_EAGER + TNS_AB]
    out = jax.jit(lambda: {n: call(n) for n in compiled})()
    out.update({n: call(n) for n in JAX_EAGER})
    return {n: _host_leaves(v) for n, v in out.items()}


@pytest.fixture(autouse=True, scope="module")
def _jax_refs():
    """The host-data sweep's JAX references (one program of ~10 s of
    compile), computed by a worker thread from the module's start, beside
    the file's other tests (``_torch_jax.Prefetch``)."""
    if jnp is None:      # the card tests need no JAX
        yield None
        return
    pre = Prefetch(1)
    yield {"host": pre.submit(_jax_host)}
    pre.close()


@pytest.fixture(scope="module")
def jax_host(_jax_refs):
    return _jax_refs["host"].result()


def test_every_function_that_makes_tensors_takes_host_data():
    """The root's functions that choose their device by
    on_device_of_inputs are exactly those held below, and every free
    function of the package that takes a ``device`` takes it from that
    one rule (the rest of the root compute in the array library they are
    given, numpy in and numpy out, as the JAX package's do, or take a
    class instance or a background that carries its device; the kSZ
    forecasts and the pipelines build a model on their ``device``)."""
    wrapped = {n for n in dir(hmvec_tpu_torch)
               if hasattr(getattr(hmvec_tpu_torch, n), "__wrapped__")}
    assert wrapped == set(HOST) | set(LENSING_HOST)
    assert not set(HOST) & set(LENSING_HOST)
    for name in wrapped:
        fn = getattr(hmvec_tpu_torch, name)
        assert "device" not in inspect.signature(fn.__wrapped__).parameters
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", sorted(HOST))
def test_free_function_runs_on_the_card_for_host_data(name, jax_host):
    """Given host data alone, a free function of the root runs on the
    card (on a machine without one, making its first tensor fails), and on
    the CPU when told so, where it matches the JAX function on the same
    inputs: 1e-10 of each output's largest value (4.4e-13 at most,
    pt_bias_integrals' Pb22; most agree to a few ulps), or, for the TNS
    A/B integrals, the same call on CPU tensors bit for bit."""
    args, kw = _split_call(HOST[name])
    fn = getattr(hmvec_tpu_torch, name)
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in _host_leaves(fn(*args, **kw))
                   if isinstance(t, torch.Tensor))
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            fn(*args, **kw)
    got = _host_leaves(fn(*args, device="cpu", **kw))
    if name in TNS_AB:
        want = _host_leaves(fn(*(T(a) for a in args), **kw))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    else:
        want = jax_host[name]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            assert g.device.type == "cpu"
        g, w = _np(g).astype(float), np.asarray(w, dtype=float)
        assert g.shape == w.shape
        finite = np.isfinite(w)
        assert np.array_equal(np.isfinite(g), finite)
        np.testing.assert_array_equal(g[~finite], w[~finite])
        scale = np.max(np.abs(w[finite]), initial=0.0)
        assert np.max(np.abs(g[finite] - w[finite]), initial=0.0) \
            <= 1e-10 * scale


def _tensors(a, device=None):
    """a with every numpy array in it, through lists, tuples and dict
    values, as a tensor on ``device``."""
    if isinstance(a, np.ndarray):
        return torch.as_tensor(a, device=device)
    if isinstance(a, dict):
        return {k: _tensors(v, device) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(_tensors(v, device) for v in a)
    return a


@pytest.mark.parametrize("name", sorted(LENSING_HOST))
def test_lensing_function_runs_on_the_card_for_host_data(name):
    """The weak-lensing, MASTER and CMB-lensing functions of the root by
    the same rule: given host data alone, the card (on a machine without
    one, making the first tensor fails); with device="cpu", the CPU, where
    each output equals the same call on CPU tensors bit for bit (that call
    is held against the JAX package in tests/test_torch_lensing.py and
    tests/test_torch_cmb_lensing.py; cap_mask_cl and bin_operator's
    scalars make no tensor, and the call is the same)."""
    args, kw = _split_call(LENSING_HOST[name])
    fn = getattr(hmvec_tpu_torch, name)
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in _host_leaves(fn(*args, **kw))
                   if isinstance(t, torch.Tensor))
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            fn(*args, **kw)
    got = _host_leaves(fn(*args, device="cpu", **kw))
    want = _host_leaves(fn(*_tensors(args), device="cpu",
                           **_tensors(kw)))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(HOST) + sorted(LENSING_HOST))
def test_free_function_on_the_card_matches_its_cpu_call(name):
    """On the card: given host data alone, every function above returns
    its tensors on the card, and they agree with the same call on the CPU
    (device="cpu"; held above against the JAX package) to 1e-10 of each
    output's largest value; the TNS A/B integrals, whose kernels cancel
    catastrophically, equal the same call on CUDA tensors bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = _split_call({**HOST, **LENSING_HOST}[name])
    fn = getattr(hmvec_tpu_torch, name)
    got = _host_leaves(fn(*args, **kw))
    assert all(g.is_cuda for g in got if isinstance(g, torch.Tensor))
    if name in TNS_AB:
        want = _host_leaves(fn(*_tensors(args, "cuda"), **kw))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        return
    want = _host_leaves(fn(*args, device="cpu", **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g).astype(float), _np(w).astype(float)
        assert g.shape == w.shape
        finite = np.isfinite(w)
        assert np.array_equal(np.isfinite(g), finite)
        np.testing.assert_array_equal(g[~finite], w[~finite])
        scale = np.max(np.abs(w[finite]), initial=0.0)
        assert np.max(np.abs(g[finite] - w[finite]), initial=0.0) \
            <= 1e-10 * scale


def test_fftlog_profile_transform_runs_on_the_card_for_host_data():
    """ops.fftlog.fftlog_profile_transform (outside the root) by the same
    rule: the card for host data, the CPU when told, where it matches the
    JAX function on the same inputs (1e-10 of each row's largest value)."""
    rng = np.random.default_rng(37)
    args = (lambda x: 1.0 / (x * (1.0 + x) ** 2),
            rng.uniform(3.0, 9.0, (2, 4)), rng.uniform(0.02, 0.4, (2, 4)),
            np.array([0.3, 1.2]), np.geomspace(1e-3, 1e3, 40))
    if torch.cuda.is_available():
        assert tfftlog.fftlog_profile_transform(*args, n=256)[1].is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            tfftlog.fftlog_profile_transform(*args, n=256)
    got = tfftlog.fftlog_profile_transform(*args, n=256, device="cpu")[1]
    assert got.device.type == "cpu"
    rho, cmaxs, rss, zs, ks = args

    def jax_side(c, r):
        # the JAX function reads its own x grid on the host
        with jax.ensure_compile_time_eval():
            return jfftlog.fftlog_profile_transform(rho, c, r, zs, ks,
                                                    n=256)[1]

    want = jax.jit(jax_side)(cmaxs, rss)
    assert _abs_to_max(got, want) <= 1e-10
