"""PyTorch port, config 4: the distance functions of models/background.py,
every function of models/limber.py and ``pipeline.make_lensing_cls_fn``
against the JAX package on the CPU, with inputs made by numpy from a
seed.  Both sides are float64 with the same algorithm: 1e-10 relative
unless a test says otherwise."""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from _torch_jax import jacobian_columns, jax_jvp, jvp_value
    from hmvec_tpu import pipeline as jpipe
    from hmvec_tpu.models import background as jbg
    from hmvec_tpu.models import limber as jlimb
    from hmvec_tpu.params import merge_params as jmerge
except ImportError:    # a machine with the card and no JAX: the tests
    jnp = None         # marked gpu need none of it (run them with -m gpu)

from hmvec_tpu_torch import pipeline as tpipe
from hmvec_tpu_torch.models import background as tbg
from hmvec_tpu_torch.models import limber as tlimb
from hmvec_tpu_torch.ops.quadrature import trapz
from hmvec_tpu_torch.params import merge_params, to_torch_params

ZS = np.linspace(0.1, 3.0, 3)
MS = np.geomspace(2e10, 1e17, 24)
KS = np.geomspace(1e-4, 100, 64)
ELLS = np.geomspace(30, 3000, 12)
PARAMS = {"omch2": 0.117, "As": 2.1e-9, "H0": 68.5, "mnu": 0.06}
# flat, open and closed, LCDM and w0/wa
BACKGROUNDS = {"flat": {}, "open": {"omk": 0.05}, "closed": {"omk": -0.04},
               "w0wa": {"w0": -0.9, "wa": 0.2}}


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) / np.asarray(want) - 1.0)))


def _backgrounds(extra):
    ov = {**PARAMS, **extra}
    return (jbg.background(jmerge(ov)),
            tbg.background({**merge_params(), **to_torch_params(ov, "cpu")},
                           "cpu"))


@pytest.fixture(scope="module")
def table():
    """A smooth positive P(z, k) table and galaxy / source distributions,
    from a seed."""
    rng = np.random.default_rng(11)
    zs = np.linspace(0.05, 2.5, 9)
    ks = np.geomspace(1e-3, 30.0, 40)
    pzk = (1e4 * np.exp(-0.5 * np.log(ks / 0.02)[None, :] ** 2 / 4.0)
           / (1.0 + zs)[:, None] ** 2 * rng.uniform(0.9, 1.1, (9, 40)))
    gzs = np.linspace(0.2, 1.4, 7)
    return {"zs": zs, "ks": ks, "pzk": pzk, "gzs": gzs,
            "gdndz": rng.uniform(0.5, 2.0, 7),
            "szs": np.linspace(0.3, 2.4, 8),
            "sdndz": rng.uniform(0.2, 1.0, 8)}


@pytest.mark.parametrize("name", list(BACKGROUNDS))
def test_distances_match_jax(name):
    jb, tb = _backgrounds(BACKGROUNDS[name])
    z = np.array([0.0, 0.3, 1.0, 2.5, 1100.0])
    tz = torch.as_tensor(z)
    chi = tbg.comoving_radial_distance(tb, tz)
    want = np.asarray(jbg.comoving_radial_distance(jb, z))
    assert chi[0] == 0.0 and _rel(chi[1:], want[1:]) <= 1e-12
    # a Python number and an (n, m) grid
    assert _rel(tbg.comoving_radial_distance(tb, 1.0), want[2]) <= 1e-12
    assert tbg.comoving_radial_distance(tb, tz[1:].reshape(2, 2)).shape == \
        (2, 2)
    assert _rel(tbg._curvature_comoving(tb, chi[1:]),
                jbg._curvature_comoving(jb, want[1:])) <= 1e-12
    assert _rel(tbg.angular_diameter_distance(tb, tz[1:]),
                jbg.angular_diameter_distance(jb, z[1:])) <= 1e-12
    assert _rel(tbg.angular_diameter_distance(tb, 0.4, tz[2:]),
                jbg.angular_diameter_distance(jb, 0.4, z[2:])) <= 1e-12
    assert _rel(tbg.sigma_crit(tb, tz[1:3], 2.0),
                jbg.sigma_crit(jb, z[1:3], 2.0)) <= 1e-12


def test_distance_derivative_matches_jax():
    """d chi(z) / d H0 through autograd against jax.grad."""
    ov = {**PARAMS}
    h0 = torch.tensor(PARAMS["H0"], dtype=torch.float64, requires_grad=True)
    tb = tbg.background({**merge_params(), **to_torch_params(ov, "cpu"),
                         "H0": h0}, "cpu")
    tbg.comoving_radial_distance(tb, 1.5).backward()
    want = jax.grad(lambda h: jbg.comoving_radial_distance(
        jbg.background(jmerge({**ov, "H0": h})), 1.5))(PARAMS["H0"])
    assert _rel(h0.grad, want) <= 1e-10


def test_trapz_on_a_tensor_grid_is_trapz_traced():
    from hmvec_tpu.ops.quadrature import trapz_traced

    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(0.0, 3.0, 17))
    y = rng.standard_normal((4, 17))
    got = trapz(torch.as_tensor(y), torch.as_tensor(x))
    assert _rel(got, trapz_traced(jnp.asarray(y), jnp.asarray(x))) <= 1e-13
    assert _rel(got, trapz(torch.as_tensor(y), x)) <= 1e-12   # numpy grid
    got0 = trapz(torch.as_tensor(y.T.copy()), torch.as_tensor(x), dim=0)
    assert torch.allclose(got0, got, rtol=1e-14)


@pytest.mark.parametrize("name", ["flat", "open"])
def test_lensing_window_matches_jax(table, name):
    jb, tb = _backgrounds(BACKGROUNDS[name])
    ezs = np.linspace(0.05, 2.6, 14)
    # a delta-function source inside the grid (zero beyond it), the CMB,
    # and a source distribution
    for zsrc in (1.3, 1100.0):
        got = tlimb.lensing_window(tb, ezs, zsrc)
        want = np.asarray(jlimb.lensing_window(jb, ezs, zsrc))
        assert np.array_equal(got.numpy() == 0.0, want == 0.0)
        nz = want != 0.0
        assert _rel(got.numpy()[nz], want[nz]) <= 1e-10
    got = tlimb.lensing_window(tb, ezs, table["szs"], table["sdndz"])
    want = np.asarray(jlimb.lensing_window(jb, ezs, table["szs"],
                                           table["sdndz"]))
    nz = want != 0.0
    assert np.array_equal(got.numpy() == 0.0, want == 0.0)
    assert _rel(got.numpy()[nz], want[nz]) <= 1e-10


def test_interp_pzk_at_curve_matches_jax(table):
    rng = np.random.default_rng(4)
    t = torch.as_tensor
    # points inside, on the nodes and outside the table in z and in k
    zev = np.concatenate([table["zs"][[0, 3, -1]], [0.01, 0.77, 1.9, 2.9]])
    kev = np.exp(rng.uniform(np.log(3e-4), np.log(90.0), (11, zev.size)))
    kev[0, :3] = table["ks"][[0, 5, -1]]
    got = tlimb.interp_pzk_at_curve(t(table["zs"]), t(table["ks"]),
                                    t(table["pzk"]), t(zev), t(kev))
    want = jlimb.interp_pzk_at_curve(table["zs"], table["ks"],
                                     jnp.asarray(table["pzk"]),
                                     jnp.asarray(zev), jnp.asarray(kev))
    assert got.shape == (11, zev.size) and _rel(got, want) <= 1e-12
    # a one-redshift table
    got = tlimb.interp_pzk_at_curve(t(table["zs"][:1]), t(table["ks"]),
                                    t(table["pzk"][:1]), t(zev), t(kev))
    want = jlimb.interp_pzk_at_curve(table["zs"][:1], table["ks"],
                                     jnp.asarray(table["pzk"][:1]),
                                     jnp.asarray(zev), jnp.asarray(kev))
    assert _rel(got, want) <= 1e-12


def test_limber_integral_matches_jax(table):
    rng = np.random.default_rng(6)
    t = torch.as_tensor
    gzs = table["gzs"]
    w1, w2 = rng.uniform(0.1, 1.0, (2, gzs.size))
    hzs = rng.uniform(2e-4, 6e-4, gzs.size)
    chis = np.linspace(800.0, 4000.0, gzs.size)
    got = tlimb.limber_integral(ELLS, table["zs"], table["ks"],
                                t(table["pzk"]), gzs, t(w1), t(w2), t(hzs),
                                t(chis))
    want = jlimb.limber_integral(ELLS, table["zs"], table["ks"],
                                 jnp.asarray(table["pzk"]), gzs, w1, w2, hzs,
                                 chis)
    assert got.shape == (ELLS.size,) and _rel(got, want) <= 1e-12
    # scalar windows and a single redshift
    got = tlimb.limber_integral(ELLS, table["zs"], table["ks"],
                                t(table["pzk"]), gzs[2], 1.0, t(w2[2]),
                                t(hzs[2]), t(chis[2]))
    want = jlimb.limber_integral(ELLS, table["zs"], table["ks"],
                                 jnp.asarray(table["pzk"]), gzs[2], 1.0,
                                 w2[2], hzs[2], chis[2])
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("name", ["flat", "closed"])
def test_every_c_ell_matches_jax(table, name):
    jb, tb = _backgrounds(BACKGROUNDS[name])
    zs, ks, gzs, gdndz = (table[k] for k in ("zs", "ks", "gzs", "gdndz"))
    pt, pj = torch.as_tensor(table["pzk"]), jnp.asarray(table["pzk"])
    cases = {
        "C_kk cmb": (("C_kk", (zs, ks)), dict(lzs1=1100.0, lzs2=1100.0)),
        "C_kk dndz x delta": (("C_kk", (zs, ks)),
                              dict(lzs1=table["szs"], ldndz1=table["sdndz"],
                                   lzs2=2.0)),
        "C_kg dndz": (("C_kg", (zs, ks)),
                      dict(gzs=gzs, gdndz=gdndz, lzs=1100.0)),
        "C_kg one z": (("C_kg", (zs, ks)), dict(gzs=0.8, lzs=1100.0)),
        "C_gg dndz": (("C_gg", (zs, ks)), dict(gzs=gzs, gdndz=gdndz)),
        "C_gg bin": (("C_gg", (zs, ks)), dict(gzs=0.8, zmin=0.7, zmax=0.9)),
        "C_gy dndz": (("C_gy", (zs, ks)), dict(gzs=gzs, gdndz=gdndz)),
        "C_gy bin": (("C_gy", (zs, ks)), dict(gzs=0.8, zmin=0.7, zmax=0.9)),
        "C_ky": (("C_ky", (zs, ks)), dict(lzs1=1100.0)),
        "C_yy": (("C_yy", (zs, ks)), {}),
    }

    def each(mod, b, pzk):
        # the galaxy redshifts are the argument after the table
        for (fname, grids), kw in cases.values():
            kw = dict(kw)
            gz = (kw.pop("gzs"),) if "gzs" in kw else ()
            yield getattr(mod, fname)(b, ELLS, *grids, pzk, *gz, **kw)

    # the JAX side compiled once (op by op it costs seconds per case)
    wants = jax.jit(lambda p: list(each(jlimb, jb, p)))(pj)
    for what, got, want in zip(cases, each(tlimb, tb, pt), wants):
        assert got.shape == (ELLS.size,), what
        assert _rel(got, want) <= 1e-10, what
    # a precomputed window is taken as it is
    win = tlimb.lensing_window(tb, zs, 1100.0)
    assert torch.equal(
        tlimb.C_kk(tb, ELLS, zs, ks, pt, lwindow1=win, lwindow2=win),
        tlimb.C_kk(tb, ELLS, zs, ks, pt, lzs1=1100.0, lzs2=1100.0))


@pytest.fixture(scope="module")
def jax_cls_at():
    """JAX's make_lensing_cls_fn over the parameters of PARAMS, one
    compile: (C_kk, Pmm) and their Jacobian over the first n parameters
    at the defaults with the given overrides."""
    fn = jpipe.make_lensing_cls_fn(ZS, KS, MS, ELLS, jit=False,
                                   growth="closed")
    jvp = jax_jvp(fn, tuple(PARAMS))

    def at(overrides, n=0):
        theta = [jmerge(overrides)[k] for k in PARAMS]
        return ([np.asarray(o) for o in jvp_value(jvp, theta)],
                jacobian_columns(jvp, theta, n) if n else None)

    return at


@pytest.fixture(scope="module")
def jax_cls(jax_cls_at):
    """JAX's (C_kk, Pmm) at PARAMS and their Jacobian over (omch2, As)
    at the fiducial cosmology."""
    return (jax_cls_at(PARAMS)[0],
            jax_cls_at({"omch2": 0.1198, "As": 2.2e-9}, 2)[1])


@pytest.mark.parametrize("fast", [False, True, "exact"],
                         ids=["plain", "fast", "exact"])
def test_lensing_cls_matches_jax(jax_cls, fast):
    fn = tpipe.make_lensing_cls_fn(ZS, KS, MS, ELLS, device="cpu", fast=fast)
    ckk, pmm = fn(PARAMS)
    assert ckk.shape == (ELLS.size,) and pmm.shape == (ZS.size, KS.size)
    assert ckk.dtype == torch.float64 and bool((ckk > 0).all())
    assert _rel(ckk, jax_cls[0][0]) <= 1e-10
    assert _rel(pmm, jax_cls[0][1]) <= 1e-10


def test_lensing_cls_source_redshift_and_options(jax_cls):
    near = tpipe.make_lensing_cls_fn(ZS, KS, MS, ELLS, 2.0, device="cpu")
    want = jpipe.make_lensing_cls_fn(ZS, KS, MS, ELLS, zsource=2.0,
                                     growth="closed")(
        {k: jnp.asarray(v) for k, v in PARAMS.items()})
    ckk, _ = near(PARAMS)
    assert _rel(ckk, want[0]) <= 1e-10
    assert _rel(ckk, jax_cls[0][0]) > 0.1       # not the CMB's
    with pytest.raises(ValueError):
        tpipe.make_lensing_cls_fn(ZS, KS, MS, ELLS, device="cpu", fast="f16")
    with pytest.raises(TypeError):
        tpipe.make_lensing_cls_fn(ZS, KS, MS, ELLS)     # device is required


def test_lensing_cls_jacobian_matches_jax(jax_cls):
    """d (C_kk, Pmm) / d (omch2, As), forward mode, against
    hmvec_tpu.pipeline.fisher_jacobian: 1e-6."""
    fn = tpipe.make_lensing_cls_fn(ZS, KS, MS, ELLS, device="cpu")
    jac = tpipe.fisher_jacobian(fn, {"omch2": 0.1198, "As": 2.2e-9},
                                ("omch2", "As"), device="cpu")
    for got, want in zip(jac, jax_cls[1]):
        assert got.shape == want.shape
        assert _rel(got, want) <= 1e-6


def test_lensing_cls_reverse_mode():
    fn = tpipe.make_lensing_cls_fn(ZS, KS, MS, ELLS, device="cpu", fast=True)
    om = torch.tensor(0.12, dtype=torch.float64, requires_grad=True)
    fn({"omch2": om})[0].sum().backward()
    assert bool(torch.isfinite(om.grad)) and om.grad != 0


def test_lensing_cls_batched_at_two(jax_cls_at):
    """Each row of a B = 2 batch over (omch2, H0) against the port's
    single call (1e-12) and the JAX package's (1e-10)."""
    fn = tpipe.make_lensing_cls_fn(ZS, KS, MS, ELLS, device="cpu")
    theta = np.array([[0.11, 66.0], [0.13, 71.0]])
    ckk, pmm = tpipe.make_batched_fn(fn, ("omch2", "H0"))(theta)
    assert ckk.shape == (2, ELLS.size) and pmm.shape == (2, ZS.size, KS.size)
    for i, (om, h0) in enumerate(theta):
        ov = {"omch2": om, "H0": h0}
        single, want = fn(ov), jax_cls_at(ov)[0]
        for o, s, w in zip((ckk, pmm), single, want):
            assert _rel(o[i], s) <= 1e-12 and _rel(o[i], w) <= 1e-10


@pytest.mark.gpu
def test_lensing_cls_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cpu = tpipe.make_lensing_cls_fn(ZS, KS, MS, ELLS, device="cpu")(PARAMS)
    for fast, gate in ((False, 1e-10), (True, 1e-5)):
        fn = tpipe.make_lensing_cls_fn(ZS, KS, MS, ELLS, device="cuda",
                                       fast=fast)
        for got, want in zip(fn(PARAMS), cpu):
            assert got.is_cuda and _rel(got.cpu(), want) <= gate
