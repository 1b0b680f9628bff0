"""PyTorch port, the class API, part 2: every ported function of
models/profiles.py and models/power.py that the class API added, every
ported method of ``HaloModel`` -- the README example (Battaglia gas and
pressure profiles, an HOD, the fast NFW tier), all four forms of
``add_nfw_profile``, Einasto, both HOD families, fNL, halo exclusion and
the constructor's options -- and the class ``kSZ`` at three redshifts with
the two kSZ auto spectra on it, against the JAX package on the CPU at the
``--smoke`` sizes of bench.py (3 z, 24 m, 64 k), with inputs made by numpy
from a seed.  Every instance has those shapes, so that JAX compiles its
operations once; the auto spectra run under one ``jax.jit`` each.  Both sides are float64 with the same algorithm: 1e-10
relative unless a test says otherwise.  The fast tier runs the plain
version on the CPU and is held to its gate, 1e-5 on the spectrum.

The card test (``-m gpu``) holds the README example on the card, with its
two kernels, against the CPU:

    python -m pytest --noconftest -m gpu tests/test_torch_halo_model.py
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from hmvec_tpu.models import halo_model as jhm
    from hmvec_tpu.models import ksz as jksz
    from hmvec_tpu.models import power as jpwr
    from hmvec_tpu.models import profiles as jprof
    from _torch_jax import Prefetch
except ImportError:    # a machine with the card and no JAX: the tests
    jnp = None         # marked gpu need none of it (run them with -m gpu)

from hmvec_tpu_torch.models import halo_model as thm
from hmvec_tpu_torch.models import ksz as tksz
from hmvec_tpu_torch.models import power as tpwr
from hmvec_tpu_torch.models import profiles as tprof
from hmvec_tpu_torch.ops import nfw_kernels as nk
from hmvec_tpu_torch.ops import resample_kernels as rk

ZS = np.linspace(0.1, 3.0, 3)
MS = np.geomspace(2e10, 1e17, 24)
KS = np.geomspace(1e-4, 100, 64)
NGAL = np.full(ZS.size, 1e-4)
PARAMS = {"omch2": 0.1198, "As": 2.2e-9}
NXS = 512            # the Battaglia transforms (default 5000)
NXS_NFW = NXS        # the numeric NFW and Einasto (default 40000): one
                     # sample grid, so JAX compiles its transform once
RNG = np.random.default_rng(41)
T = torch.as_tensor
FAST_GATE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _jit(fn):
    """fn() by the JAX package in one compiled program: op by op its
    first call compiles each operation on its own, which takes seconds."""
    return jax.jit(fn)()


def _rel(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got / want - 1.0)))


def _to_max(got, want):
    """Max abs difference over the largest |want|: for profiles u(k),
    which are exactly 0 above the sample grid's Nyquist k."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _readme(hm, **kw):
    """The README's example, with the further profiles the tests hold:
    the Battaglia gas and pressure profiles, both HOD families, the
    numeric NFW and Einasto transforms and concentration scatter."""
    hm.add_battaglia_profile("e", family="AGN", nxs=NXS)
    hm.add_battaglia_pres_profile("y", nxs=NXS)
    hm.add_hod("g", ngal=NGAL)
    hm.add_hod("gz", ngal=NGAL, family="zheng05")
    hm.add_hod("gc", mthresh=np.full(ZS.size, 10.0 ** 10.5),
               central_profile_name="nfw", corr="min")
    hm.add_nfw_profile("num", numeric=True, nxs=NXS_NFW, xmax=100)
    hm.add_einasto_profile("ein", alpha=0.2, nxs=NXS_NFW, xmax=100)
    hm.add_nfw_profile("sc", conc_scatter=0.3)
    hm.add_hod("gsc", ngal=NGAL, satellite_profile_name="sc")
    return hm


def _profile_functions(prof, x, m200, r200, asarray):
    """The free functions of models/profiles.py on one set of inputs
    (``nfw_uk_scatter`` is held through ``add_nfw_profile(conc_scatter=)``,
    both of its moments, in test_methods_match_jax)."""
    z, rhoc = 0.4, 2.0e11
    args = (m200, z, 0.049, 0.31, rhoc)
    sig2 = asarray(PROFILE_SIG2)
    return ([prof.rho_nfw_x(x, 2.0), prof.rho_einasto_x(x, 0.2, 3.0),
             prof.rho_nfw(x, 2.0, 0.3), prof.rhoscale_nfw(m200, r200, 5.0),
             prof.Fcon(m200 / 1e13),
             prof.battaglia_gas_fit(m200, z, 4000.0, 0.29, -0.66),
             prof.rho_gas_generic_x(x, *args, rho0_A0=3000.0),
             prof.rho_gas_generic(x, *args, family="SH"),
             prof.rho_gas(x, *args),
             prof.P_e_generic_x(x, m200, r200, z, 0.049, 0.31, rhoc,
                                xc_A0=0.5),
             prof.P_e_generic(x, *args), prof.P_e(x, *args, alpha=1.1)]
            + [prof.concentration_bhattacharya(sig2, asarray(PROFILE_D), md)
               for md in ("vir", "mean", "200c")])


# the module's draws in their order: B1 and TAU (the fnl and method
# tests), then the profile functions' sigma^2
B1 = RNG.uniform(1.0, 3.0, ZS.size)
TAU = RNG.uniform(0.5, 2.0, (ZS.size, MS.size))
PROFILE_SIG2 = RNG.uniform(0.2, 5.0, (3, 6))
PROFILE_D = np.array([1.0, 0.8, 0.5])


def test_profile_free_functions_match_jax():
    x = np.geomspace(1e-3, 20.0, 50)
    m200 = np.geomspace(1e12, 1e15, 4)[:, None]
    r200 = np.asarray(tprof.R_from_M(T(m200), 2.0e11, 200))
    got = _profile_functions(tprof, T(x), T(m200), T(r200), T)
    want = _jit(lambda: _profile_functions(jprof, jnp.asarray(x),
                                           jnp.asarray(m200),
                                           jnp.asarray(r200), jnp.asarray))
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= 1e-12, i
    # the float32 samples of the pressure profile: float64 shape, rounded
    x32 = T(x).float()
    p32 = tprof.P_e_generic_x(x32, T(m200), T(r200), 0.4, 0.049, 0.31, 2.0e11)
    assert p32.dtype == torch.float32
    want32 = _jit(lambda: jprof.P_e_generic_x(
        jnp.asarray(x.astype(np.float32).astype(np.float64)),
        jnp.asarray(m200), jnp.asarray(r200), 0.4, 0.049, 0.31, 2.0e11))
    assert _rel(p32.double(), want32) <= 1e-7


def test_power_free_functions_match_jax():
    P = np.exp(RNG.uniform(0.0, 1.0, (3, 64))) * 1e3
    r = np.array([1.0, 2.0, 3.5])
    Pt = T(P)
    ks = jnp.asarray(KS)     # concrete: the JAX function reads it on the host
    want = _jit(lambda: (
        jpwr.total_matter_power_spectrum(0.12, 0.022, jnp.asarray(P),
                                         0.9 * jnp.asarray(P),
                                         0.7 * jnp.asarray(P)),
        jpwr.total_matter_galaxy_power_spectrum(0.12, 0.022, jnp.asarray(P),
                                                0.9 * jnp.asarray(P)),
        jpwr.exclusion_correction(ks, jnp.asarray(P), jnp.asarray(r))))
    assert _rel(tpwr.total_matter_power_spectrum(0.12, 0.022, Pt, 0.9 * Pt,
                                                 0.7 * Pt), want[0]) <= 1e-14
    assert _rel(tpwr.total_matter_galaxy_power_spectrum(0.12, 0.022, Pt,
                                                        0.9 * Pt),
                want[1]) <= 1e-14
    assert _to_max(tpwr.exclusion_correction(KS, Pt, T(r)), want[2]) <= 1e-10
    with pytest.raises(ValueError):
        tpwr.exclusion_correction(np.linspace(0.1, 1.0, 64), Pt, 1.0)


# the kSZ class at the file's redshifts and masses, with its kS and kL
# grids on one 64-point range (the auto spectra need kS == kL)
KSZ_VOL = 8.0
KSZ_KMAX = 20.0
AUTO_ELLS = np.array([300.0, 1000.0, 3000.0])
BGS = np.array([1.4, 1.7, 2.3])
CLS = 1e-5 * np.ones(10000)


def _ksz_kw():
    return dict(kL_max=KSZ_KMAX, num_kL_bins=KS.size,
                kS_min=tksz.get_kmin(KSZ_VOL), kS_max=KSZ_KMAX,
                num_kS_bins=KS.size, num_mu_bins=6, ms=MS,
                params={**PARAMS, "hod_bisection_search_min_log10mthresh": 1},
                electron_profile_nxs=NXS, b1=BGS, b2=BGS)


def _ksz_args():
    return ZS, np.full(ZS.size, KSZ_VOL), NGAL * 3.0


@pytest.fixture(scope="module")
def ksz_pair(_jax_refs):
    mine = tksz.kSZ(*_ksz_args(), device="cpu", **_ksz_kw())
    return _jax_refs["ksz"].result(), mine


def test_ksz_class_at_three_redshifts_matches_jax(ksz_pair):
    j, t = ksz_pair
    for attr in ("sPggs", "sPges", "sPggtot", "vrec", "Pmms", "fs", "adotf",
                 "d2vs", "kstars", "chistars", "bgs", "kLs", "kS", "mu"):
        assert _rel(getattr(t, attr), getattr(j, attr)) <= 1e-10, attr
    edges = np.geomspace(0.01, 10.0, 5)

    def per_bin(k):
        return [(k.Nvv(zi, CLS), k.Pge_err(zi, edges, CLS), k.lPvv(zi),
                 k.lPgv(zi, BGS[zi]), k.ksz_radial_function(zi))
                for zi in range(ZS.size)]

    for got, want in zip(per_bin(t), _jit(lambda: per_bin(j))):
        assert _rel(got[0], want[0]) <= 1e-10
        # a band beyond the kS grid has no modes: its error is inf in both
        np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]),
                                   rtol=1e-10)
        assert _rel(got[2], want[2]) <= 1e-10
        assert _rel(got[3], want[3]) <= 1e-10
        assert _rel(got[4], want[4]) <= 1e-12


@pytest.mark.parametrize("template", [False, True])
def test_auto_squeezed_matches_jax(ksz_pair, template):
    j, t = ksz_pair
    _, cl_t, spec_t = tksz.get_ksz_auto_squeezed(
        AUTO_ELLS, KSZ_VOL, ZS, 3e-4, BGS, pksz_in=t, template=template,
        device="cpu")
    cl_j, spec_j = jax.jit(lambda: jksz.get_ksz_auto_squeezed(
        AUTO_ELLS, KSZ_VOL, ZS, 3e-4, BGS, pksz_in=j,
        template=template)[1:])()
    assert cl_t.shape == (AUTO_ELLS.size,) and _rel(cl_t, cl_j) <= 1e-10
    assert set(spec_t) == set(spec_j)
    for key in spec_j:
        assert _rel(spec_t[key], spec_j[key]) <= 1e-10, key


def test_auto_signal_mafry_matches_jax(ksz_pair):
    j, t = ksz_pair
    _, cl_t = tksz.get_ksz_auto_signal_mafry(AUTO_ELLS, KSZ_VOL, ZS, 3e-4,
                                             1.5, pksz_in=t, device="cpu")
    cl_j = jax.jit(lambda: jksz.get_ksz_auto_signal_mafry(
        AUTO_ELLS, KSZ_VOL, ZS, 3e-4, 1.5, pksz_in=j)[1])()
    assert cl_t.shape == (AUTO_ELLS.size,) and _rel(cl_t, cl_j) <= 1e-10


MODEL_OPTIONS = (("main", {}),
                 ("tinker", {"mass_function": "tinker", "tinker_delta": "auto",
                             "concmode": "bhattacharya"}),
                 ("mean", {"mdef": "mean", "accuracy": "low",
                           "nfw_numeric": True}))


def _model_kw(key, kw):
    params = {**PARAMS, "nfw_integral_numxs": NXS_NFW} if key == "mean" \
        else PARAMS
    return {**kw, "params": params}


def _build(hm, key):
    """'main' with every profile of the README example and more; the
    others with an HOD and the Battaglia gas profile."""
    if key == "main":
        return _readme(hm)
    hm.add_hod("g", ngal=NGAL)
    hm.add_battaglia_profile("e", nxs=NXS)
    return hm


def _jax_models():
    return {key: _build(jhm.HaloModel(ZS, KS, ms=MS, **_model_kw(key, kw)),
                        key) for key, kw in MODEL_OPTIONS}


@pytest.fixture(autouse=True, scope="module")
def _jax_refs():
    """The JAX instances of the file, built op by op (each operation
    compiles on first use: most of the file's time), by two worker
    threads from the module's start, beside the torch side
    (``_torch_jax.Prefetch``); the tests that only read them wait for
    them."""
    if jnp is None:      # the card tests need no JAX
        yield None
        return
    pre = Prefetch()
    yield {"models": pre.submit(_jax_models),
           "ksz": pre.submit(lambda: jksz.kSZ(*_ksz_args(), **_ksz_kw()))}
    pre.close()


@pytest.fixture(scope="module")
def models(_jax_refs):
    """(JAX, torch) HaloModel pairs: 'main' at PARAMS with every profile;
    'tinker' with the Tinker mass function at the mdef's own overdensity
    and the Bhattacharya concentration; 'mean' with mdef='mean', the
    low-accuracy linear power and the numeric NFW as its 'nfw'."""
    mine = {}
    for key, kw in MODEL_OPTIONS:
        mine[key] = _build(thm.HaloModel(ZS, KS, ms=MS, device="cpu",
                                         **_model_kw(key, kw)), key)
    mine["main"].add_nfw_profile("nfw_fast", fast=True)
    jax_models = _jax_refs["models"].result()
    return {key: (jax_models[key], mine[key]) for key in mine}


SPECTRA = [("nfw", None), ("e", "e"), ("y", "y"), ("g", None),
           ("g", "e"), ("g", "y"), ("e", "y"), ("gz", None), ("gz", "g"),
           ("gc", None), ("gc", "nfw"), ("num", None), ("ein", None),
           ("ein", "num"), ("sc", None), ("sc", "nfw"), ("gsc", None)]


SPECTRUM_METHODS = ("get_power_1halo", "get_power_2halo", "get_power")


@pytest.fixture(scope="module")
def jax_spectra(models):
    """Every spectrum of SPECTRA by each method of the JAX instance, in
    one compiled program (the instance is built outside it)."""
    j, _ = models["main"]
    keys = [(n1, n2, m) for n1, n2 in SPECTRA for m in SPECTRUM_METHODS]
    return dict(zip(keys, _jit(lambda: [getattr(j, m)(n1, n2)
                                        for n1, n2, m in keys])))


@pytest.mark.parametrize("name, name2", SPECTRA)
def test_spectra_match_jax(models, jax_spectra, name, name2):
    _, t = models["main"]
    for meth in SPECTRUM_METHODS:
        got = getattr(t, meth)(name, name2)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        assert _rel(got, jax_spectra[name, name2, meth]) <= 1e-10, meth


@pytest.mark.parametrize("key", ["tinker", "mean"])
def test_constructor_options_match_jax(models, key):
    j, t = models[key]
    pairs = (("nfw", None), ("g", "e"), ("g", None))
    wants = _jit(lambda: [j.get_power(n1, n2) for n1, n2 in pairs]
                 + [j.concentration()])
    for (name, name2), want in zip(pairs, wants):
        assert _rel(t.get_power(name, name2), want) <= 1e-10
    assert _rel(t.nzm, j.nzm) <= 1e-10 and _rel(t.bh, j.bh) <= 1e-10
    assert _rel(t.Pzk, j.Pzk) <= 1e-10
    assert _rel(t.concentration(), wants[-1]) <= 1e-10
    want = j._tinker_delta_grid()
    got = t._tinker_delta_grid()
    assert (got == want) if isinstance(want, float) else \
        _rel(got, want) <= 1e-12


def test_fast_nfw_profile_is_held_to_its_gate(models):
    """On the CPU the fast tier's wrapper runs the plain version: the
    profile and Pmm from it are within the fast gate of JAX's analytic
    'nfw' (and the profile is the port's own analytic one)."""
    j, t = models["main"]
    before = nk.nfw_uk_fast.launches
    _, uk = t.add_nfw_profile("nfw_fast2", fast=True)
    assert nk.nfw_uk_fast.launches == before   # no launch on the CPU
    assert uk.dtype == torch.float64
    assert float((uk - t.uk_profiles["nfw"]).abs().max()) <= 1e-13
    want_m, want_g = _jit(lambda: (j.get_power("nfw"),
                                   j.get_power("g", "nfw")))
    assert _rel(t.get_power("nfw_fast"), want_m) <= FAST_GATE
    assert _rel(t.get_power("g", "nfw_fast"), want_g) <= FAST_GATE


FNL = (None, 20.0)
EXCLUSION = (None, "auto", 1.5)
FNL_PAIRS = (("nfw", None), ("g", None), ("g", "e"), ("y", "g"))


def _compiled(exclusion, name):
    """Whether the JAX side of a (fnl, exclusion) case runs compiled: the
    pressure cross under exclusion runs op by op, as the port does, since
    the FFTLog of its 2-halo term, which changes sign, differs between
    JAX's compiled and op-by-op runs at ~4e-9 of its largest value (the
    port follows the op-by-op run to ~1e-12)."""
    return exclusion is None or name != "y"


@pytest.fixture(scope="module")
def jax_fnl_exclusion(models):
    """The JAX spectra of every (fnl, exclusion) case and a 2-halo term
    with given biases, in one compiled program where _compiled allows."""
    j, _ = models["main"]
    keys = [(f, e, n1, n2) for f in FNL for e in EXCLUSION
            for n1, n2 in FNL_PAIRS]
    jit_keys = [k for k in keys if _compiled(k[1], k[2])]
    wants = _jit(lambda: [j.get_power(n1, n2, fnl=f, exclusion=e, deltac=1.5)
                          for f, e, n1, n2 in jit_keys]
                 + [j.get_power_2halo("g", "e", b1_in=jnp.asarray(B1),
                                      b2_in=1.1)])
    out = dict(zip(jit_keys, wants))
    out.update({(f, e, n1, n2): j.get_power(n1, n2, fnl=f, exclusion=e,
                                            deltac=1.5)
                for f, e, n1, n2 in keys if (f, e, n1, n2) not in out})
    return out, wants[-1]


@pytest.mark.parametrize("fnl", FNL)
@pytest.mark.parametrize("exclusion", EXCLUSION)
def test_fnl_and_exclusion_match_jax(models, jax_fnl_exclusion, fnl,
                                     exclusion):
    _, t = models["main"]
    wants, want_b = jax_fnl_exclusion
    for name, name2 in FNL_PAIRS:
        kw = {"fnl": fnl, "exclusion": exclusion, "deltac": 1.5}
        got, want = (t.get_power(name, name2, **kw),
                     wants[fnl, exclusion, name, name2])
        assert _rel(got, want) <= 1e-10
    assert _rel(t.get_power_2halo("g", "e", b1_in=B1, b2_in=1.1),
                want_b) <= 1e-10
    with pytest.raises(ValueError):
        t.get_power("nfw", exclusion="near")


COUNTS = ((1e13, 1.0, None), (1e12, 0.4, 1e15))
HODS = ("g", "gz", "gc", "gsc")


def _methods(m, zs, ms, tau):
    """The HaloModel methods of test_methods_match_jax, in one list."""
    out = [m.deltav(zs), m.rvir(ms[None, :], zs[:, None]), m.R_of_m(ms),
           m.get_sigma2(), m.concentration("duffy"),
           m.concentration("bhattacharya"), *m._m200critz()]
    for name in HODS:
        h = m.hods[name]
        out += [m.get_ngal(h["Nc"], h["Ns"]),
                m.get_bg(h["Nc"], h["Ns"], h["ngal"])]
    out += [m.get_tau_mean_hod("g", tau), m.exclusion_radius()]
    for mmin, fsky, mmax in COUNTS:
        out += list(m.cluster_counts(mmin, fsky, mmax))
    return out


def test_methods_match_jax(models):
    j, t = models["main"]
    wants = _jit(lambda: _methods(j, jnp.asarray(ZS), jnp.asarray(MS),
                                  jnp.asarray(TAU)))
    for i, (got, want) in enumerate(zip(_methods(t, t.zs, t.ms, T(TAU)),
                                        wants)):
        assert _rel(got, want) <= 1e-10, i
    assert _rel(t.get_nzm(), j.get_nzm()) <= 1e-10
    assert _rel(t.get_bh(), j.get_bh()) <= 1e-10
    with pytest.raises(NotImplementedError):
        t.concentration("prada")
    for name in HODS:
        hj, ht = j.hods[name], t.hods[name]
        for key in ("Nc", "Ns", "NsNsm1", "NcNs", "ngal", "bg",
                    "log10mthresh"):
            if key in ("Nc", "Ns", "NsNsm1", "NcNs"):
                np.testing.assert_allclose(_np(ht[key]), np.asarray(hj[key]),
                                           rtol=1e-10, atol=1e-300)
            else:
                assert _rel(ht[key], hj[key]) <= 1e-10, (name, key)
    for name in ("e", "num", "ein", "sc"):
        assert _to_max(t.uk_profiles[name], j.uk_profiles[name]) <= 1e-12
    assert _to_max(t.pk_profiles["y"], j.pk_profiles["y"]) <= 1e-12
    assert _to_max(t.uk2_profiles["sc"], j.uk2_profiles["sc"]) <= 1e-12


def test_profile_options_match_jax(models):
    j, t = models["main"]
    over = {"rho0_A0": 3500.0, "battaglia_gas_gamma": -0.25, "junk": 1.0}
    for m in (j, t):
        m.add_battaglia_profile("e2", family="SH", param_override=over,
                                nxs=NXS, xmax=15, ignore_existing=True)
        m.add_battaglia_pres_profile("y2", param_override={"P0_A0": 17.0},
                                     nxs=NXS, xmax=15, ignore_existing=True)
        m.add_hod("g2", ngal=NGAL * 2, ignore_existing=True,
                  param_override={"hod_alphasat": 1.1})
    assert _to_max(t.uk_profiles["e2"], j.uk_profiles["e2"]) <= 1e-12
    assert _to_max(t.pk_profiles["y2"], j.pk_profiles["y2"]) <= 1e-12
    assert _rel(t.get_power("g2", "e2"),
                _jit(lambda: j.get_power("g2", "e2"))) <= 1e-10
    with pytest.raises(ValueError):
        t.add_hod("g3", ngal=NGAL, param_override={"junk": 1.0})
    with pytest.raises(ValueError):
        t.add_hod("g3", ngal=NGAL, family="tinker")
    with pytest.raises(ValueError):
        t.add_nfw_profile("x", fast=True, conc_scatter=0.2)
    with pytest.raises(ValueError, match="reserved"):
        t.add_battaglia_profile("nfw", ignore_existing=True)
    with pytest.raises(ValueError, match="already exists"):
        t.add_battaglia_pres_profile("y")
    with pytest.raises(ValueError, match="satellite"):
        t.add_hod("g4", ngal=NGAL, satellite_profile_name="none")


@pytest.mark.gpu
def test_readme_example_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def build(device):
        hm = thm.HaloModel(ZS, KS, ms=MS, params=PARAMS, device=device)
        hm.add_battaglia_profile("e", family="AGN", nxs=NXS)
        hm.add_battaglia_pres_profile("y", nxs=NXS)
        hm.add_hod("g", ngal=NGAL)
        hm.add_nfw_profile("nfw_fast", fast=True)
        return hm

    cpu = build("cpu")
    before = (nk.nfw_uk_fast.launches, rk.pair_lerp_f64.launches)
    gpu = build("cuda")
    assert (nk.nfw_uk_fast.launches - before[0],
            rk.pair_lerp_f64.launches - before[1]) == (1, 2)
    for name, name2, gate in (("nfw", None, 1e-10), ("g", None, 1e-10),
                              ("g", "e", 1e-10), ("y", "y", 1e-10),
                              ("nfw_fast", None, FAST_GATE)):
        got = gpu.get_power(name, name2)
        assert got.is_cuda and _rel(got, cpu.get_power(name, name2)) <= gate
