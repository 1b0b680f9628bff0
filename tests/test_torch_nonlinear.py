"""PyTorch port, nonlinear matter power: models/halofit.py (takahashi,
original, bird, peacock, casarini), models/hmcode.py (HMcode 2015, 2016,
2020 and 2020_feedback, with massive neutrinos' cold branch and the
integrated w0/wa growth), background.growth_dolag_ratio, and their
dispatch in the class API (``halofit=``, ``P_mm_nonlinear``,
``get_pk_interpolator(nonlinear=True)``), against the JAX package on the
CPU at 2 z x 40 k with inputs made by numpy from a seed.  Both sides are
float64 with the same algorithm: 1e-10 relative unless a test says
otherwise.

The JAX side of the halofit tests runs under one ``jax.jit`` per
instance.  Every HMcode reference comes from a fresh process
(tests/_torch_hmcode_ref.py, started with the first test of this file and
read by the last ones): XLA:CPU crashes natively on HMcode programs in a
process that holds many compiled programs (tests/_isolation.py).
"""

import numpy as np
import pytest
import torch

import _torch_hmcode_ref as ref

try:
    import jax
    import jax.numpy as jnp
    from hmvec_tpu.models import background as jbg
    from hmvec_tpu.models import cosmology as jcos
    from hmvec_tpu.models import halofit as jhf
    from hmvec_tpu.models import hmcode as jhmc
    from hmvec_tpu.params import merge_params as jmerge
    from _torch_jax import JaxSubprocess
except ImportError:    # a machine with the card and no JAX
    jnp = None

from hmvec_tpu_torch.models import background as tbg
from hmvec_tpu_torch.models import cosmology as tcos
from hmvec_tpu_torch.models import halo_model as thm
from hmvec_tpu_torch.models import halofit as thf
from hmvec_tpu_torch.models import hmcode as thmc
from hmvec_tpu_torch.params import merge_params as tmerge

ZS, KS, PARAMS, ODE = ref.ZS, ref.KS, ref.PARAMS, ref.ODE
HALOFIT = ("takahashi", "original", "bird", "peacock", "casarini")
RNG = np.random.default_rng(23)
T = torch.as_tensor
GATE = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True, scope="module")
def hmcode_ref(tmp_path_factory):
    """The HMcode references: the subprocess starts with the first test
    of the file; the first call waits for it and loads its npz."""
    out = tmp_path_factory.mktemp("hmcode") / "ref.npz"
    job = JaxSubprocess("_torch_hmcode_ref.py", out).start()
    refs = {}

    def get():
        if not refs:
            job.wait()
            with np.load(out) as f:
                refs.update({k: f[k] for k in f.files})
        return refs

    yield get
    job.kill()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got / want - 1.0)))


@pytest.fixture(scope="module")
def cosmos():
    """(JAX, torch) Cosmology pairs: 'nu' (massive neutrinos, closed-form
    growth) and 'ode' (w0/wa, the integrated growth)."""
    return {key: (jcos.Cosmology(p), tcos.Cosmology(p, device="cpu"))
            for key, p in (("nu", PARAMS), ("ode", ODE))}


# ---- background.growth_dolag_ratio -----------------------------------------

def test_growth_dolag_ratio_matches_jax():
    overs = ({"w0": -0.9, "wa": 0.2}, {"w0": -1.1, "wa": -0.3, "omk": 0.02})
    want = jax.jit(lambda: [jbg.growth_dolag_ratio(jbg.background(
        jmerge(ov))) for ov in overs])()
    for ov, w in zip(overs, want):
        got = tbg.growth_dolag_ratio(tbg.background(tmerge(ov), "cpu"))
        assert abs(float(got) / float(w) - 1.0) <= GATE
    # exactly 1 at (w0, wa) = (-1, 0): the two solves are the same
    assert float(tbg.growth_dolag_ratio(tbg.background(tmerge(), "cpu"))) \
        == 1.0


# ---- models/halofit.py -------------------------------------------------------

def test_halofit_moments_and_coefficients_match_jax():
    kg = thf._KG
    d2 = (2e4 * kg / (1.0 + (kg / 0.02) ** 2.6) * kg**3 / (2.0 * np.pi**2)
          * np.exp(RNG.uniform(-0.1, 0.1, (3, kg.size))))
    R = RNG.uniform(0.5, 10.0, 3)
    n, C = RNG.uniform(-2.5, -1.0, 3), RNG.uniform(0.0, 1.0, 3)
    omz, omde_w, omde = (RNG.uniform(0.3, 0.9, 3), RNG.uniform(-0.1, 0.1, 3),
                         RNG.uniform(0.1, 0.7, 3))
    want = jax.jit(lambda: [jhf._moments(jnp.asarray(d2), jnp.asarray(R))]
                   + [f(*map(jnp.asarray, (n, C, omz, omde_w, omde)))
                      for f in jhf._COEFFS.values()])()
    got = ([thf._moments(T(d2), T(R))]
           + [f(*map(T, (n, C, omz, omde_w, omde)))
              for f in thf._COEFFS.values()])
    assert list(thf._COEFFS) == list(jhf._COEFFS)
    assert thf._FNU_QL == jhf._FNU_QL
    np.testing.assert_array_equal(thf._KG, jhf._KG)
    np.testing.assert_array_equal(thf._LNW, jhf._LNW)
    for g, w in zip(got, want):
        for gi, wi in zip(g, w):
            np.testing.assert_allclose(_np(gi), np.asarray(wi), rtol=1e-12,
                                       atol=0)


@pytest.mark.parametrize("key", ["nu", "ode"])
def test_halofit_versions_match_jax(cosmos, key):
    """Every halofit version through ``P_mm_nonlinear``: with massive
    neutrinos (the f_nu terms of each branch) and under w0/wa (where
    casarini differs from takahashi); with casarini's w_eff."""
    cj, ct = cosmos[key]
    want = jax.jit(lambda: [cj.P_mm_nonlinear(KS, ZS, v) for v in HALOFIT]
                   + [jhf.casarini_weff(cj.bg, jnp.asarray(ZS))])()
    for v, w in zip(HALOFIT, want):
        assert _rel(ct.P_mm_nonlinear(KS, ZS, v), w) <= GATE, v
    assert _rel(thf.casarini_weff(ct.bg, ZS), want[-1]) <= 1e-12


def test_halofit_refuses_what_jax_refuses(cosmos):
    """An unknown version, and a Smith-branch version with massive
    neutrinos and no omm0, raise the JAX package's errors (JAX's while it
    traces, under jax.jit)."""
    _, ct = cosmos["nu"]
    omz = ct.omz(ZS)
    messages = []
    for call in (
            lambda **kw: jax.jit(lambda: jhf.halofit_nonlinear(
                lambda kq: jnp.ones((2, kq.size)), ZS, KS,
                jnp.asarray(_np(omz)), jnp.zeros(2), **kw))(),
            lambda **kw: thf.halofit_nonlinear(
                lambda kq: ct.P_lin(kq, ZS), T(ZS), T(KS), omz,
                torch.zeros(2), **kw)):
        with pytest.raises(ValueError) as e1:
            call(version="smith")
        with pytest.raises(ValueError) as e2:
            call(version="bird", fnu=0.1)
        messages.append((str(e1.value), str(e2.value)))
    assert messages[0] == messages[1]


# ---- the class dispatch ----------------------------------------------------

def test_nonlinear_dispatch_and_aliases(cosmos):
    """The version strings, their aliases and the ``default_halofit``
    parameter pick the same spectra; ``HaloModel(halofit=...).nPzk`` and
    ``get_pk_interpolator(nonlinear=True)`` are ``P_mm_nonlinear``; an
    unknown version raises the JAX class's error."""
    _, ct = cosmos["nu"]
    orig = ct.P_mm_nonlinear(KS, ZS, "original")
    for alias in ("smith", "smith03"):
        assert torch.equal(ct.P_mm_nonlinear(KS, ZS, alias), orig)
    mead = ct.P_mm_nonlinear(KS, ZS, "mead")
    for alias in ("hmcode", "mead2016", None, True):
        assert torch.equal(ct.P_mm_nonlinear(KS, ZS, alias), mead)
    ctk = tcos.Cosmology({**PARAMS, "default_halofit": "takahashi"},
                         device="cpu")
    assert torch.equal(ctk.P_mm_nonlinear(KS, ZS, None),
                       ct.P_mm_nonlinear(KS, ZS, "takahashi"))
    hm = thm.HaloModel(ZS, KS, params=PARAMS, halofit="bird", skip_nfw=True,
                       device="cpu")
    assert torch.equal(hm.nPzk, ct.P_mm_nonlinear(KS, ZS, "bird"))
    pk = hm.get_pk_interpolator(ZS, 20.0, var="total", nonlinear=True)
    assert torch.equal(pk.P(ZS, KS), hm.nPzk)
    weyl = hm.get_pk_interpolator(ZS, 20.0, var="weyl", nonlinear=True)
    h0i = float(hm.bg.H0) / 299792.458
    pref = (1.5 * hm.omm0 * h0i**2 * (1.0 + ZS))[:, None] ** 2
    assert _rel(weyl.P(ZS, KS), pref * _np(hm.nPzk) / KS[None, :] ** 4) \
        <= 1e-14
    cj, _ = cosmos["nu"]
    with pytest.raises(ValueError) as ej:
        cj.P_mm_nonlinear(KS, ZS, "bogus")
    with pytest.raises(ValueError) as et:
        ct.P_mm_nonlinear(KS, ZS, "bogus")
    assert str(et.value) == str(ej.value)


# ---- models/hmcode.py (JAX side from the subprocess) -------------------------

def test_hmcode_statics_equal_jax():
    for name in ("_KG", "_LNKW", "_MS", "_LNMW", "_FM_J", "_FM_T"):
        np.testing.assert_array_equal(getattr(thmc, name),
                                      getattr(jhmc, name))
    assert thmc._ST_A == jhmc._ST_A
    np.testing.assert_array_equal(thmc._dewiggle_matrix(), jhmc._DW_S)
    with pytest.raises(ValueError, match="hmcode version"):
        thmc.hmcode_nonlinear(None, T(ZS), T(KS), None, None, None,
                              version="2017")
    bg = tbg.background(tmerge(PARAMS), "cpu")
    pg = torch.ones(2, thmc._KG.size)
    with pytest.raises(ValueError, match="plin_ref_g"):
        thmc.hmcode_nonlinear(bg, T(ZS), T(KS), pg, torch.ones(2, KS.size),
                              T(0.8), version="2020")


def test_hmcode_small_functions_match_jax(hmcode_ref):
    want = hmcode_ref()
    u = ref.unit_inputs()
    d2 = T(u["delta2"])
    got = {"xwprime": thmc._xwprime(T(u["x"])),
           "st_gnu": thmc._st_gnu(T(u["nu"])),
           "sigma_v2_0": thmc._sigma_v2(d2, 0.0),
           "sigma_v2_100": thmc._sigma_v2(d2, 146.0)}
    for key in ("tophat1", "tophat2"):
        R = T(u["R1"] if key == "tophat1" else u["R2"])
        got[f"{key}_0"], got[f"{key}_1"] = thmc._tophat_moments(d2, R)
    for key, g in got.items():
        np.testing.assert_allclose(_np(g), want[key], rtol=1e-12, atol=1e-15,
                                   err_msg=key)


@pytest.mark.parametrize("key", list(ref.CASES))
def test_hmcode_matches_jax(hmcode_ref, key):
    """Each HMcode version (massive neutrinos: the cold branch; w0/wa: the
    integrated growth and the Dolag factor), A_bary and log T_AGN, against
    JAX's ``hmcode_power``; the class's version strings give the same."""
    params, version, kw = ref.CASES[key]
    ct = tcos.Cosmology(params, device="cpu")
    got = thmc.hmcode_power(ct, ZS, KS, **kw)
    assert _rel(got, hmcode_ref()[key]) <= GATE
    if version is not None:
        assert torch.equal(ct.P_mm_nonlinear(KS, ZS, version), got)
    if key == "mead":
        hm = thm.HaloModel(ZS, KS, params=params, halofit="mead",
                           skip_nfw=True, device="cpu")
        assert torch.equal(hm.nPzk, got)


def test_hmcode_ode_builds_one_growth_table(monkeypatch):
    """Under growth="ode" the formation-redshift bisection reads the
    call's table: an HMcode call builds two growth tables whatever its
    number of steps -- its own and sigma_8's (``get_sigma2_R``)."""
    ct = tcos.Cosmology(ODE, device="cpu")
    built = []
    real = tbg.growth_table
    monkeypatch.setattr(tbg, "growth_table",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    thmc.hmcode_power(ct, ZS, KS)
    assert len(built) == 2
