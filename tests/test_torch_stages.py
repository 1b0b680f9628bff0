"""PyTorch port, the config-1 stages one by one against the JAX package:
background, transfer, linear power, sigma^2, mass function and bias,
concentration, r_vir, NFW u(k) and the 1h+2h assembly, each at <= 1e-12
relative in float64 on a 3 z x 24 m x 64 k grid (both sides run the same
algorithm in float64; the tolerance covers summation order only)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hmvec_tpu.models import background as jbg
from hmvec_tpu.models import linear_power as jlp
from hmvec_tpu.models import mass_function as jmf
from hmvec_tpu.models import power as jpw
from hmvec_tpu.models import profiles as jprof
from hmvec_tpu.models import transfer as jtr
from hmvec_tpu.params import merge_params as jmerge
from hmvec_tpu_torch.models import background as tbg
from hmvec_tpu_torch.models import linear_power as tlp
from hmvec_tpu_torch.models import mass_function as tmf
from hmvec_tpu_torch.models import power as tpw
from hmvec_tpu_torch.models import profiles as tprof
from hmvec_tpu_torch.models import transfer as ttr
from hmvec_tpu_torch.params import merge_params as tmerge

RTOL = 1e-12
ZS = np.linspace(0.1, 3.0, 3)
MS = np.geomspace(2e10, 1e17, 24)
KS = np.geomspace(1e-4, 100.0, 64)
COSMOS = {"fiducial": {}, "mnu": {"mnu": 0.1, "omch2": 0.115}}


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _close(got, want, rtol=RTOL, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


class _Side:
    """One framework's view of the stages, evaluated lazily."""

    def __init__(self, cosmo, torch_side):
        self.t = torch_side
        self.p = (tmerge if torch_side else jmerge)(COSMOS[cosmo])
        if torch_side:
            self.bg = tbg.background(self.p, "cpu")
            self.zs, self.ms, self.ks = _t(ZS), _t(MS), _t(KS)
            self.mods = (tbg, tlp, tmf, tprof, tpw, ttr)
        else:
            self.bg = jbg.background(self.p)
            self.zs, self.ms, self.ks = (jnp.asarray(ZS), jnp.asarray(MS),
                                         jnp.asarray(KS))
            self.mods = (jbg, jlp, jmf, jprof, jpw, jtr)

    @functools.cached_property
    def stages(self):
        bgm, lpm, mfm, prm, pwm, _ = self.mods
        bg, p, zs, ms, ks = self.bg, self.p, self.zs, self.ms, self.ks
        out = {}
        pzk = lpm.plin_approx(bg, zs, ks)
        ks_s2 = lpm.sigma2_k_grid(p)
        spzk = lpm.plin_approx(bg, zs, (_t if self.t else jnp.asarray)(ks_s2))
        rho_m0 = bgm.rho_matter_z(bg, 0.0)
        R = mfm.R_from_M(ms, rho_m0, delta=1.0)
        sigma2 = lpm.sigma2_R(bg, R, zs, spzk, ks_s2, p["Wkr_taylor_switch"])
        nzm, bh = mfm.mass_function_grid(sigma2, zs, ms, rho_m0,
                                         "sheth-torman", p)
        cs = prm.concentration_duffy(ms, zs, "vir", p, p["H0"] / 100.0)
        rvir = prm.rvir_grid(ms, zs, "vir", bgm.rho_critical_z(bg, zs),
                             bgm.rho_matter_z(bg, zs), bgm.omz(bg, zs))
        uk = prm.nfw_uk_analytic(ks, zs, cs, rvir / cs)
        tr = pwm.MatterTracer(uk=uk)
        out.update(pzk=pzk, sigma2=sigma2, nzm=nzm, bh=bh, cs=cs, rvir=rvir,
                   uk=uk,
                   ptot=pwm.power_total(tr, tr, nzm, bh, ms, ks, pzk, rho_m0,
                                        p["kstar_damping"]))
        return out


_CACHE = {}


def _pair(cosmo):
    if cosmo not in _CACHE:
        _CACHE[cosmo] = (_Side(cosmo, True), _Side(cosmo, False))
    return _CACHE[cosmo]


@pytest.mark.parametrize("cosmo", list(COSMOS))
def test_background(cosmo):
    t, j = _pair(cosmo)
    for field in ("omm0", "oml0", "omr0", "omnu0"):
        _close(getattr(t.bg, field), getattr(j.bg, field))
    zz = np.linspace(0.0, 5.0, 11)
    for name in ("e_of_z", "h_of_z", "rho_critical_z", "rho_matter_z", "omz"):
        _close(getattr(tbg, name)(t.bg, _t(zz)),
               getattr(jbg, name)(j.bg, jnp.asarray(zz)))
    a = 1.0 / (1.0 + zz)
    for norm in ("anorm", "z0norm"):
        _close(tbg.d_growth(t.bg, _t(a), norm=norm),
               jbg.d_growth(j.bg, jnp.asarray(a), norm=norm))


@pytest.mark.parametrize("kind", ["eisenhu_osc", "eisenhu"])
def test_transfer(kind):
    t, j = _pair("fiducial")
    k = np.geomspace(1e-5, 2000.0, 500)
    _close(ttr.transfer_eh98(t.bg, _t(k), kind),
           jtr.transfer_eh98(j.bg, jnp.asarray(k), kind))


@pytest.mark.parametrize("component", ["total", "cb"])
def test_eh99_neutrino_ratio(component):
    t, j = _pair("mnu")
    d = np.array([0.3, 0.6, 0.9])
    _close(ttr.eh99_neutrino_ratio(t.bg, t.ks, _t(d), component),
           jtr.eh99_neutrino_ratio(j.bg, j.ks, jnp.asarray(d), component))


@pytest.mark.parametrize("cosmo", list(COSMOS))
@pytest.mark.parametrize("stage", ["pzk", "sigma2", "nzm", "bh", "cs",
                                   "rvir", "uk", "ptot"])
def test_stage_matches_jax(cosmo, stage):
    t, j = _pair(cosmo)
    got, want = t.stages[stage], j.stages[stage]
    if stage == "nzm":
        # n(z, m) carries exp(-a deltac^2 / 2 sigma^2): in the far tail
        # (n ~ 1e-260, exponent ~ 600) the ~1e-15 summation-order
        # difference of the sigma^2 matmul grows 600-fold, so the check
        # is relative on ln n, where it is not amplified
        _close(torch.log(got), np.log(np.asarray(want)))
    elif stage == "uk":
        # u is a sum of O(1) terms; where it oscillates through small
        # values (~1e-4) the relative check gets an absolute floor of 1e-14
        _close(got, want, atol=1e-14)
    else:
        _close(got, want)


def test_engine_tiers_and_as8():
    t, j = _pair("fiducial")
    for acc in ("low", "medium"):
        _close(tlp.EHEngine().plin(t.bg, t.zs, t.ks, accuracy=acc),
               jlp.EHEngine().plin(j.bg, j.zs, j.ks, accuracy=acc))
    _close(tlp.EHEngine().pzk_grid(t.bg, t.zs, t.ks),
           jlp.EHEngine().pzk_grid(j.bg, j.zs, j.ks))


def test_unported_modes_raise():
    t, j = _pair("fiducial")
    # the integrated growth answers where it used to be refused
    _close(tbg.d_growth(t.bg, _t([0.5]), mode="ode"),
           jbg.d_growth(j.bg, jnp.asarray([0.5]), mode="ode"), rtol=1e-10)
    # so do the Tinker modes (held against JAX in
    # tests/test_torch_mass_function.py); an unknown mode raises, as in JAX
    s2 = torch.full((3, 24), 0.5, dtype=torch.float64)
    nzm, bh = tmf.mass_function_grid(s2, t.zs, t.ms, 1.0, "tinker", t.p)
    assert nzm.shape == bh.shape == (3, 24)
    assert bool(torch.isfinite(nzm).all() and torch.isfinite(bh).all())
    with pytest.raises(NotImplementedError):
        tmf.mass_function_grid(s2, t.zs, t.ms, 1.0, "tinker2010", t.p)
