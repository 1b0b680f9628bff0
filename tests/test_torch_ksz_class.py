"""PyTorch port, the class API, part 3: the class ``kSZ`` of one redshift
bin with and without photo-z scatter, its methods, and the kSZ functions
of one bin (``Nvv``, ``get_ksz_snr``, ``get_ksz_template_signal_snapshot``,
the survey helpers and ``get_ksz_snr_survey`` on both of its paths),
against the JAX package on the CPU at the sizes of the JAX package's own
kSZ tests (tests/test_ksz_fused.py), with inputs made by numpy from a seed;
and the class against the port's own pipeline at the JAX package's
class-vs-fused gate, 1e-12.  Every kSZ instance here has the same shapes,
so that JAX compiles its operations once.  Both sides are float64 with the
same algorithm: 1e-10 relative unless a test says otherwise.  The kSZ
class at three redshifts and the two kSZ auto spectra are in
tests/test_torch_halo_model.py, on that file's grids."""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from hmvec_tpu.models import ksz as jksz
    from _torch_jax import Prefetch
except ImportError:    # a machine with the card and no JAX
    jnp = None

from hmvec_tpu_torch import pipeline as tpipe
from hmvec_tpu_torch.models import ksz as tksz

MS = np.geomspace(1e10, 1e16, 32)
CFG = dict(num_kL_bins=8, num_kS_bins=9, num_mu_bins=6, ms=MS,
           electron_profile_nxs=256, electron_profile_xmax=10)
CLS = 1e-5 * np.ones(10000)
SIGZ = 0.03
# two survey bins of a smooth dN/dz
SURVEY_ZS = np.linspace(0.2, 1.2, 60)
SURVEY_DNDZ = np.exp(-((SURVEY_ZS - 0.6) / 0.3) ** 2)
SURVEY = dict(zedges=np.array([0.3, 0.6, 0.9]), fsky=0.4, Ngals=2e7)
RNG = np.random.default_rng(53)
T = torch.as_tensor


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


# the template and survey tests' JAX calls
TEMPLATE_ELLS = np.concatenate([[10.0], np.geomspace(300.0, 9000.0, 6),
                                [1e6]])
TEMPLATE_KW = dict(fparams={"omch2": 0.12},
                   params={"omch2": 0.115, "rho0_A0": 3800.0})
SURVEY_KW = dict(CFG, zs=SURVEY_ZS, dndz=SURVEY_DNDZ, Cls=CLS, **SURVEY)
BS = np.array([1.3, 1.7])


def _jax_snr():
    return {key: jksz.get_ksz_snr(10.0, 0.55, 1e-4, CLS, sigz=sigz, **CFG)
            for key, sigz in (("spec", None), ("photo", SIGZ))}


def _jax_template_and_survey():
    return {"template": jksz.get_ksz_template_signal_snapshot(
                TEMPLATE_ELLS, 10.0, 0.55, 1e-4, 1.6, **TEMPLATE_KW, **CFG),
            "bins": jksz._survey_bins(SURVEY_ZS, SURVEY_DNDZ,
                                      SURVEY["zedges"], SURVEY["fsky"],
                                      SURVEY["Ngals"], None),
            "survey": jksz.get_ksz_snr_survey(nfw_numeric=False,
                                              **SURVEY_KW),
            "survey_photo": jksz.get_ksz_snr_survey(sigz=SIGZ, bs=BS,
                                                    **SURVEY_KW)}


@pytest.fixture(autouse=True, scope="module")
def _jax_refs():
    """The file's JAX kSZ references (the JAX class runs op by op, and
    each operation compiles on first use: ~25 s), computed by two worker
    threads from the module's start, beside each other and the torch
    side (``_torch_jax.Prefetch``); the N_vv test's, which patches the
    module defaults, stays in its test."""
    pre = Prefetch()
    yield {"snr": pre.submit(_jax_snr),
           "rest": pre.submit(_jax_template_and_survey)}
    pre.close()


@pytest.fixture(scope="module")
def snr_pairs(_jax_refs):
    """get_ksz_snr of JAX and the port, without and with photo-z."""
    mine = {key: tksz.get_ksz_snr(10.0, 0.55, 1e-4, CLS, sigz=sigz,
                                  device="cpu", **CFG)
            for key, sigz in (("spec", None), ("photo", SIGZ))}
    jax_side = _jax_refs["snr"].result()
    return {key: (jax_side[key], mine[key]) for key in mine}


@pytest.mark.parametrize("key", ["spec", "photo"])
def test_get_ksz_snr_matches_jax(snr_pairs, key):
    (snr_j, kj), (snr_t, kt) = snr_pairs[key]
    assert snr_t.dim() == 0 and _rel(snr_t, snr_j) <= 1e-10
    assert _rel(kt.Nvv(0, CLS), kj.Nvv(0, CLS)) <= 1e-10
    for attr in ("sPggs", "sPges", "sPggtot", "vrec", "Pmms", "fs", "adotf",
                 "d2vs", "kstars", "chistars", "bgs", "kLs", "krs",
                 "Hphotozs"):
        assert _rel(getattr(kt, attr), getattr(kj, attr)) <= 1e-10, attr
    edges = np.geomspace(0.1, 10.0, 4)
    assert _rel(kt.Pge_err(0, edges, CLS), kj.Pge_err(0, edges, CLS)) <= 1e-10
    assert _rel(kt.lPvv(0, 1.2, 0.9), kj.lPvv(0, 1.2, 0.9)) <= 1e-10
    assert _rel(kt.lPgg(0, 1.5, 1.5), kj.lPgg(0, 1.5, 1.5)) <= 1e-10
    assert _rel(kt.lPgv(0, 1.5), kj.lPgv(0, 1.5)) <= 1e-10
    assert _rel(kt.ksz_radial_function(0, gasfrac=0.8, tau=0.05),
                kj.ksz_radial_function(0, gasfrac=0.8, tau=0.05)) <= 1e-12
    if key == "photo":
        assert _rel(kt.Wphoto(0), kj.Wphoto(0)) <= 1e-12
        assert _rel(kt.Wphoto_all(), kj.Wphoto_all()) <= 1e-12
        assert kt.sPggs.shape == (1, 6, 8, 9)


def test_class_matches_the_ported_pipeline(snr_pairs):
    """The JAX package's own class-vs-fused gate: snr and N_vv of the class
    within 1e-12 of ``make_ksz_snr_fn`` (tests/test_ksz_fused.py)."""
    _, (snr_t, kt) = snr_pairs["spec"]
    fn = tpipe.make_ksz_snr_fn(0.55, 10.0, 1e-4, device="cpu", ms=MS,
                               num_kL_bins=8, num_kS_bins=9, num_mu_bins=6,
                               nxs=256, xmax=10)
    snr, nvv, vrec = fn({}, CLS)
    assert abs(float(snr) / float(snr_t) - 1.0) <= 1e-12
    assert _rel(nvv, kt.Nvv(0, CLS)) <= 1e-12
    assert _rel(vrec, kt.vrec) <= 1e-12


def test_nvv_function_matches_jax(monkeypatch, _jax_refs):
    """Nvv takes no mass grid: both packages' default grid is set to MS,
    and the electron sampling comes through the parameters (after the
    worker threads' JAX calls, which read the same module defaults)."""
    for task in _jax_refs.values():
        task.result()
    for mod in (jksz, tksz):
        monkeypatch.setitem(mod.defaults, "min_mass", MS[0])
        monkeypatch.setitem(mod.defaults, "max_mass", MS[-1])
        monkeypatch.setitem(mod.defaults, "num_mass", MS.size)
    params = {"electron_density_profile_integral_numxs": 256,
              "electron_density_profile_integral_xmax": 10}
    kw = dict(num_kL_bins=8, num_kS_bins=9, num_mu_bins=6, params=params)
    got = tksz.Nvv(0.6, 8.0, 2e-4, CLS, device="cpu", **kw)
    want = jksz.Nvv(0.6, 8.0, 2e-4, CLS, **kw)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-10


def test_template_signal_snapshot_matches_jax(_jax_refs):
    """The kSZ template x CMB at a fiducial and a shifted cosmology; the
    ells reach beyond the kS grid on both sides (left = right = 0)."""
    got = tksz.get_ksz_template_signal_snapshot(
        TEMPLATE_ELLS, 10.0, 0.55, 1e-4, 1.6, device="cpu", **TEMPLATE_KW,
        **CFG)
    want = _jax_refs["rest"].result()["template"]
    cl_t, cl_j = _np(got[0]), np.asarray(want[0])
    assert cl_t[0] == cl_j[0] == 0.0 and cl_t[-1] == cl_j[-1] == 0.0
    assert _rel(cl_t[1:-1], cl_j[1:-1]) <= 1e-10


def test_survey_bins_match_jax(_jax_refs):
    got = tksz._survey_bins(SURVEY_ZS, SURVEY_DNDZ, SURVEY["zedges"],
                            SURVEY["fsky"], SURVEY["Ngals"], None,
                            device="cpu")
    want = _jax_refs["rest"].result()["bins"]
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-12


def test_snr_survey_paths_match_jax(_jax_refs):
    """Both paths of get_ksz_snr_survey: without photo-z the port runs the
    survey pipeline, and nfw_numeric (an option of the class alone) takes
    it bin by bin, as the JAX package does; each is held against JAX's
    per-bin path at 1e-10 and the two against each other.  With photo-z
    both run bin by bin."""
    kw = SURVEY_KW
    want = _jax_refs["rest"].result()["survey"]
    fused = tksz.get_ksz_snr_survey(device="cpu", **kw)
    per_bin = tksz.get_ksz_snr_survey(device="cpu", nfw_numeric=False, **kw)
    for got in (fused, per_bin):
        for g, w in zip(got[:5], want[:5]):
            assert _rel(g, w) <= 1e-10
        assert abs(got[5] / want[5] - 1.0) <= 1e-10
    assert abs(fused[5] / per_bin[5] - 1.0) <= 1e-12
    bs = BS
    photo_t = tksz.get_ksz_snr_survey(device="cpu", sigz=SIGZ, bs=bs, **kw)
    photo_j = _jax_refs["rest"].result()["survey_photo"]
    for g, w in zip(photo_t[3:5], photo_j[3:5]):
        assert _rel(g, w) <= 1e-10
    with pytest.raises(ValueError):
        tksz.get_ksz_snr_survey(device="cpu", bs=bs[:1], **kw)
