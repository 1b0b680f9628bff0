"""The user-facing HaloModel class on float64 tensors (port of
hmvec_tpu/models/halo_model.py).

A plain class over the staged functions of the port, with the JAX class's
method names and signatures: the linear power, the mass function and its
bias on the instance's (zs, ms) grid, the registered profiles u(k | z, m)
and HOD samples, and their 1-halo / 2-halo spectra.  Profiles go through
the same kernels as the pipelines on the card: every numeric profile
(``add_nfw_profile(numeric=True)``, Einasto, the Battaglia gas and
pressure profiles) through ``generic_profile_fft`` and its float64
resample kernel, ``add_nfw_profile(fast=True)`` through the fast-tier NFW
kernel (``ops.nfw_kernels.nfw_uk_fast``).  The CIB and HI tracers ride on
a registered profile (so on that kernel when the profile is the fast
one); the cluster-lensing profiles are closed forms on the instance's
background.  The host keeps numpy copies of the grids (``zs_np``,
``ks_np``, ``ms_np``) for the static quadrature weights.

Covariances (``models/cov.py``), cluster counts through a Y-M relation
(``models/cluster_counts.py``), bispectra (``models/bispectrum.py``) and
the pairwise-kSZ ingredients (``models/pairwise.py``) run on the
registered profiles and launch no kernel of their own, as do the
redshift-space multipoles of an HOD tracer
(``get_galaxy_rsd_multipoles``, on models/spt.py and models/tns.py).
``DEFERRED`` is empty: every method of the JAX class is ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.nfw_kernels import nfw_uk_fast
from ..ops.quadrature import linear_interp
from ..ops.sine_transform import generic_profile_fft
from ..params import battaglia_defaults, scoped_override
from ..utils.weights import trapz_weights
from . import background as bgmod
from . import bispectrum as bsp
from . import cib as cibm
from . import cluster_counts as ccm
from . import cluster_lensing as clm
from . import cov as covm
from . import hi as him
from . import mass_function as mfm
from . import pairwise as pwm
from . import power as pwr
from . import profiles as prof
from .cosmology import Cosmology
from .hod import build_hod, build_hod_zheng05
from .mass_conversion import mdelta_from_mdelta

_F64 = torch.float64


def _require(ok: bool, message: str):
    """The JAX class's argument checks, as errors that -O keeps."""
    if not ok:
        raise ValueError(message)


def _numeric_params(p):
    return {k: v for k, v in p.items() if isinstance(v, (int, float))}


_HOD_PARAM_KEYS = [
    "hod_sig_log_mstellar", "hod_bisection_search_min_log10mthresh",
    "hod_bisection_search_max_log10mthresh", "hod_bisection_num_iter",
    "hod_alphasat", "hod_Bsat", "hod_betasat", "hod_Bcut", "hod_betacut",
    "hod_A_log10mthresh", "hod_Msat_override", "hod_Mcut_override",
    "hod_zheng_log10Mmin", "hod_zheng_siglogm", "hod_zheng_log10M0",
    "hod_zheng_log10M1", "hod_zheng_alpha",
]

# HaloModel methods whose module is still in A9, by group
DEFERRED = {}

# the y-units of the pressure profile: Thomson cross-section [m^2],
# electron mass [Msun] and c [m/s]
_SIGMA_T = 6.6524587321e-29
_M_ELECTRON_MSUN = 9.1093837015e-31 / 1.989e30
_C_SI = 299792458.0


class HaloModel(Cosmology):
    def __init__(self, zs, ks, ms=None, params=None,
                 mass_function="sheth-torman", halofit=None, mdef="vir",
                 nfw_numeric=False, skip_nfw=False, accuracy="medium",
                 engine="eh", pk_table=None, cls_table=None,
                 concmode="duffy", tinker_delta=None, engine_opts=None,
                 device="cuda"):
        super().__init__(params=params, halofit=halofit, engine=engine,
                         accuracy=accuracy, pk_table=pk_table,
                         cls_table=cls_table, engine_opts=engine_opts,
                         device=device)
        self.zs_np = np.asarray(zs, dtype=np.float64)
        self.ks_np = np.asarray(ks, dtype=np.float64)
        self.zs = self._t(self.zs_np)
        self.ks = self._t(self.ks_np)
        self.mdef = mdef
        self.mode = mass_function
        self.concmode = concmode
        # Tinker overdensity: None -> 200; a number -> that Delta wrt the
        # mean matter density; "auto" -> the mdef's own overdensity
        self.tinker_delta = tinker_delta
        self.hods: dict = {}
        self.uk_profiles: dict = {}
        self.uk2_profiles: dict = {}   # <u^2> for c-scatter profiles
        self.pk_profiles: dict = {}
        self.cib_tracers: dict = {}    # CIB and HI tracers
        self._hi_params: dict = {}

        if accuracy == "low":
            self.Pzk = self.P_lin_approx(self.ks, self.zs)
        else:
            self.Pzk = self._get_matter_power(self.zs, self.ks,
                                              nonlinear=False)
        if halofit is not None:
            self.nPzk = self._get_matter_power(self.zs, self.ks,
                                               nonlinear=True)
        if ms is not None:
            self.init_mass_function(ms)
        if not skip_nfw:
            self.add_nfw_profile("nfw", numeric=nfw_numeric)

    # ---- virial definitions ----
    def deltav(self, z):
        return mfm.deltav_bryan_norman(self.omz(z))

    def rvir(self, m, z):
        if self.mdef == "vir":
            return mfm.R_from_M(m, self.rho_critical_z(z), self.deltav(z))
        if self.mdef == "mean":
            return mfm.R_from_M(m, self.rho_matter_z(z), 200.0)
        raise ValueError(self.mdef)

    def R_of_m(self, ms):
        return mfm.R_from_M(self._t(ms), self.rho_matter_z(0.0), delta=1.0)

    # ---- mass function ----
    def get_sigma2(self):
        return self.get_sigma2_R(self.R_of_m(self.ms), self.zs)

    def _tinker_delta_grid(self):
        """The ctor's ``tinker_delta`` as the overdensity (wrt the mean
        matter density) of the Tinker mass function."""
        td = self.tinker_delta
        if td is None:
            return 200.0
        if isinstance(td, str):
            if td != "auto":
                raise ValueError(f"tinker_delta: {td!r}")
            if self.mdef == "vir":
                # Bryan-Norman Delta_v is wrt critical; the Tinker tables
                # are wrt mean
                return self.deltav(self.zs) / self.omz(self.zs)
            return 200.0
        return td

    def init_mass_function(self, ms):
        self.ms_np = np.asarray(ms, dtype=np.float64)
        self.ms = self._t(self.ms_np)
        self.sigma2 = self.get_sigma2()
        self.nzm, self.bh = mfm.mass_function_grid(
            self.sigma2, self.zs, self.ms, self.rho_matter_z(0.0), self.mode,
            _numeric_params(self.p), self._tinker_delta_grid())

    def get_nzm(self):
        return self.nzm

    def get_bh(self):
        return self.bh

    def concentration(self, mode=None):
        """c(z, m): 'duffy' or 'bhattacharya'; the ctor's ``concmode`` by
        default."""
        if mode is None:
            mode = self.concmode
        if mode == "duffy":
            return prof.concentration_duffy(self.ms, self.zs, self.mdef,
                                            self.p, self.h)
        if mode == "bhattacharya":
            d = self.D_growth(1.0 / (1.0 + self.zs), type="z0norm")
            return prof.concentration_bhattacharya(self.sigma2, d, self.mdef)
        raise NotImplementedError(mode)

    def _mass_weights(self, x=None):
        """Trapezoid weights of the mass grid (or of the numpy grid x)."""
        return self._t(trapz_weights(self.ms_np if x is None else x))

    # ---- profiles ----
    def _nfw_scales(self):
        cs = self.concentration()
        rvirs = self.rvir(self.ms[None, :], self.zs[:, None])
        return cs, rvirs

    def add_nfw_profile(self, name, numeric=False, nxs=None, xmax=None,
                        ignore_existing=False, fast=False,
                        conc_scatter=None):
        """NFW u(k | z, m): analytic (Si/Ci); ``numeric=True`` by the sine
        transform; ``fast=True`` by the fast-tier CUDA kernel (float32 u,
        within 5e-6 of the analytic form; on CPU tensors the plain
        version); ``conc_scatter`` = sigma_lnc registers <u> and <u^2>
        under lognormal concentration scatter (analytic only)."""
        if not ignore_existing:
            _require(name not in self.uk_profiles,
                     "Profile name already exists.")
        if nxs is None:
            nxs = self.p["nfw_integral_numxs"]
        if xmax is None:
            xmax = self.p["nfw_integral_xmax"]
        cs, rvirs = self._nfw_scales()
        rss = rvirs / cs
        if conc_scatter is not None:
            if numeric or fast:
                raise ValueError("conc_scatter supports the analytic path")
            uk, uk2 = prof.nfw_uk_scatter(self.ks, self.zs, cs, rvirs,
                                          conc_scatter)
            self.uk_profiles[name] = uk
            self.uk2_profiles[name] = uk2
            return self.ks, uk
        if numeric:
            _, uk = generic_profile_fft(
                lambda x: prof.rho_nfw_x(x, rhoscale=1.0)[None, None, :],
                cs, rss, self.zs, self.ks, xmax, int(nxs))
        elif fast:
            nz, nm = cs.shape
            scales = (rss * (1.0 + self.zs)[:, None]).reshape(-1)
            uk = nfw_uk_fast(self.ks, scales, cs.reshape(-1).contiguous())
            uk = uk.reshape(nz, nm, -1).to(self.Pzk.dtype)
        else:
            uk = prof.nfw_uk_analytic(self.ks, self.zs, cs, rss)
        self.uk_profiles[name] = uk
        self.uk2_profiles.pop(name, None)  # re-registration drops scatter
        return self.ks, uk

    def add_einasto_profile(self, name, alpha=0.18, nxs=None, xmax=None,
                            ignore_existing=False):
        """Einasto u(k | z, m) by the sine transform, with the numeric NFW
        path's conventions (r_s = r_vir / c, truncation at r_vir, mass
        norm)."""
        if not ignore_existing:
            _require(name not in self.uk_profiles,
                     "Profile name already exists.")
        if nxs is None:
            nxs = self.p["nfw_integral_numxs"]
        if xmax is None:
            xmax = self.p["nfw_integral_xmax"]
        cs, rvirs = self._nfw_scales()
        _, uk = generic_profile_fft(
            lambda x: prof.rho_einasto_x(x, alpha=alpha)[None, None, :],
            cs, rvirs / cs, self.zs, self.ks, xmax, int(nxs))
        self.uk_profiles[name] = uk
        self.uk2_profiles.pop(name, None)
        return self.ks, uk

    def _m200critz(self):
        """self.ms as M200 wrt rho_crit(z), with R200 and rho_crit(z)."""
        rhocritz = self.rho_critical_z(self.zs)
        if self.mdef == "vir":
            delta_rhos1 = rhocritz * self.deltav(self.zs)
        else:
            delta_rhos1 = self.rho_matter_z(self.zs) * 200.0
        cs = self.concentration()
        m200 = mdelta_from_mdelta(self.ms, cs, delta_rhos1, 200.0 * rhocritz)
        r200 = mfm.R_from_M(m200, rhocritz[:, None], delta=200.0)
        return m200, r200, rhocritz

    def _battaglia_params(self, keys, family, param_override):
        pparams = {k: self.p[k] for k in keys}
        pparams.update(battaglia_defaults[family])
        return scoped_override(
            pparams, param_override,
            set(pparams) | set(battaglia_defaults[family]), strict=False)

    def add_battaglia_profile(self, name, family=None, param_override=None,
                              nxs=None, xmax=None, ignore_existing=False):
        """Battaglia 2016 gas density profile -> u(k | z, m)."""
        if not ignore_existing:
            _require(name not in self.uk_profiles,
                     "Profile name already exists.")
        _require(name != "nfw", "Name nfw is reserved.")
        if nxs is None:
            nxs = self.p["electron_density_profile_integral_numxs"]
        if xmax is None:
            xmax = self.p["electron_density_profile_integral_xmax"]
        if family is None:
            family = self.p["battaglia_gas_family"]
        pparams = self._battaglia_params(("battaglia_gas_gamma",), family,
                                         param_override)
        m200, r200, rhocritz = self._m200critz()
        rvirs = self.rvir(self.ms[None, :], self.zs[:, None])
        omb = self.p["ombh2"] / self.h**2

        def rhofunc(xs):
            return prof.rho_gas_x(
                xs[None, None, :], m200[..., None], self.zs[:, None, None],
                omb, self.omm0, rhocritz[:, None, None],
                pparams["battaglia_gas_gamma"], pparams)

        rgs = r200 / 2.0  # x = r / (R200/2)
        _, uk = generic_profile_fft(rhofunc, rvirs / rgs, rgs, self.zs,
                                    self.ks, xmax, int(nxs))
        self.uk_profiles[name] = uk
        self.uk2_profiles.pop(name, None)
        return self.ks, uk

    def add_battaglia_pres_profile(self, name, family=None,
                                   param_override=None, nxs=None, xmax=None,
                                   ignore_existing=False):
        """Battaglia pressure profile -> y-weighted p(k | z, m)."""
        if not ignore_existing:
            _require(name not in self.pk_profiles,
                     "Profile name already exists.")
        _require(name != "nfw", "Name nfw is reserved.")
        if nxs is None:
            nxs = self.p["electron_pressure_profile_integral_numxs"]
        if xmax is None:
            xmax = self.p["electron_pressure_profile_integral_xmax"]
        if family is None:
            family = self.p["battaglia_pres_family"]
        pparams = self._battaglia_params(
            ("battaglia_pres_gamma", "battaglia_pres_alpha"), family,
            param_override)
        m200, r200, rhocritz = self._m200critz()
        rvirs = self.rvir(self.ms[None, :], self.zs[:, None])
        omb = self.p["ombh2"] / self.h**2

        def presfunc(xs):
            return prof.pressure_x(
                xs[None, None, :], m200[..., None], r200[..., None],
                self.zs[:, None, None], omb, self.omm0,
                rhocritz[:, None, None], pparams["battaglia_pres_alpha"],
                pparams["battaglia_pres_gamma"], pparams)

        _, pk = generic_profile_fft(presfunc, rvirs / r200, r200, self.zs,
                                    self.ks, xmax, int(nxs),
                                    do_mass_norm=False)
        unit = (4.0 * math.pi * (_SIGMA_T / (_M_ELECTRON_MSUN * _C_SI**2))
                * (r200**3 * ((1.0 + self.zs) ** 2
                              / self.h_of_z(self.zs))[..., None])[..., None])
        self.pk_profiles[name] = pk * unit
        return self.ks, self.pk_profiles[name]

    def get_mean_compton_y(self, family=None, param_override=None,
                           n_x=512):
        """Sky-averaged Compton-y monopole <y> = int dz int dm n u_y(z, m,
        k -> 0), with the exact k -> 0 limit of the pressure profile
        (``pairwise.compton_y_k0_battaglia``; the registered profile
        flat-extrapolates below its grid and would be ~5% low), on this
        instance's (z, m) grid."""
        if family is None:
            family = self.p["battaglia_pres_family"]
        pparams = self._battaglia_params(
            ("battaglia_pres_gamma", "battaglia_pres_alpha"), family,
            param_override)
        m200, r200, rhocritz = self._m200critz()
        rvirs = self.rvir(self.ms[None, :], self.zs[:, None])
        omb = self.p["ombh2"] / self.h**2
        uy0 = pwm.compton_y_k0_battaglia(
            self.zs, m200, r200, rvirs / r200, rhocritz, omb, self.omm0,
            pparams["battaglia_pres_alpha"], pparams["battaglia_pres_gamma"],
            pparams, self.h_of_z(self.zs), n_x=n_x)
        return ((self.nzm * uy0) @ self._mass_weights()) \
            @ self._t(trapz_weights(self.zs_np))

    def get_tau_aperture(self, R_ap=None, theta_arcmin=None, family=None,
                         param_override=None, n_x=256):
        """Mean aperture Thomson optical depth tau_bar(z, m) of the
        Battaglia gas profile inside a disk of physical radius ``R_ap``
        [Mpc] (scalar or per z) or angular radius ``theta_arcmin`` (R_ap =
        theta d_A(z)): ``pairwise.tau_aperture_battaglia``."""
        if (R_ap is None) == (theta_arcmin is None):
            raise ValueError("pass exactly one of R_ap / theta_arcmin")
        if family is None:
            family = self.p["battaglia_gas_family"]
        pparams = self._battaglia_params(("battaglia_gas_gamma",), family,
                                         param_override)
        m200, r200, rhocritz = self._m200critz()
        rvirs = self.rvir(self.ms[None, :], self.zs[:, None])
        if R_ap is None:
            dA = self.angular_diameter_distance(self.zs)
            R_ap = (theta_arcmin * np.pi / (180.0 * 60.0)) * dA
        omb = self.p["ombh2"] / self.h**2
        # truncated at r = rvir, like the registered profile
        return pwm.tau_aperture_battaglia(
            self.zs, m200, r200, rvirs / (r200 / 2.0), rhocritz, omb,
            self.omm0, self._t(R_ap), pparams["battaglia_gas_gamma"],
            pparams, n_x=n_x)

    def get_tau_mean_hod(self, hod_name, tau_zm):
        """HOD-weighted sample mean of a per-halo quantity q(z, m):
        int dm n (Nc + Ns) q / ngal."""
        h = self.hods[hod_name]
        num = (self.nzm * (h["Nc"] + h["Ns"]) * self._t(tau_zm)) \
            @ self._mass_weights()
        return num / h["ngal"]

    # ---- HOD ----
    def add_hod(self, name, mthresh=None, ngal=None, corr="max",
                satellite_profile_name="nfw", central_profile_name=None,
                ignore_existing=False, param_override=None,
                family="leauthaud"):
        """family: 'leauthaud' (the Behroozi stellar-mass threshold HOD)
        or 'zheng05' (the five-parameter Zheng et al 2005 HOD; ``ngal``
        solves log10 Mmin, ``mthresh`` is ignored)."""
        if not ignore_existing:
            _require(name not in self.uk_profiles,
                     "HOD name already used by profile.")
            _require(name not in self.hods,
                     "HOD with that name already exists.")
        _require(satellite_profile_name in self.uk_profiles,
                 f"Unknown satellite profile {satellite_profile_name!r}")
        if central_profile_name is not None:
            _require(central_profile_name in self.uk_profiles,
                     f"Unknown central profile {central_profile_name!r}")
        hp = {k: self.p[k] for k in _HOD_PARAM_KEYS if k in self.p}
        hp = scoped_override(hp, param_override, set(_HOD_PARAM_KEYS),
                             strict=True)
        if family == "zheng05":
            grid = build_hod_zheng05(self.zs, self.ms, self.nzm, self.bh,
                                     hp, ngal=ngal, corr=corr)
        elif family == "leauthaud":
            grid = build_hod(self.zs, self.ms, self.nzm, self.bh, hp,
                             mthresh=mthresh, ngal=ngal, corr=corr,
                             Msat_override=hp.get("hod_Msat_override"),
                             Mcut_override=hp.get("hod_Mcut_override"))
        else:
            raise ValueError(f"HOD family {family!r}: supported are "
                             "'leauthaud' (reference) and 'zheng05'")
        self.hods[name] = {
            "Nc": grid.Nc, "Ns": grid.Ns, "NsNsm1": grid.NsNsm1,
            "NcNs": grid.NcNs, "ngal": grid.ngal, "bg": grid.bg,
            "satellite_profile": satellite_profile_name,
            "central_profile": central_profile_name,
            "log10mthresh": grid.log10mthresh,
        }
        return self.hods[name]

    def get_bg(self, Nc, Ns, ngal):
        return ((self.nzm * (Nc + Ns) * self.bh) @ self._mass_weights()) / ngal

    def get_ngal(self, Nc, Ns):
        return (self.nzm * (Nc + Ns)) @ self._mass_weights()

    # ---- tracer resolution ----
    def _tracer(self, name):
        if name in self.hods:
            h = self.hods[name]
            uc = (None if h["central_profile"] is None
                  else self.uk_profiles[h["central_profile"]])
            return pwr.HODTracer(
                Nc=h["Nc"], Ns=h["Ns"], NsNsm1=h["NsNsm1"], NcNs=h["NcNs"],
                ngal=h["ngal"], bg=h["bg"],
                us=self.uk_profiles[h["satellite_profile"]], uc=uc,
                us2=self.uk2_profiles.get(h["satellite_profile"]))
        if name in self.uk_profiles:
            return pwr.MatterTracer(uk=self.uk_profiles[name],
                                    uk2=self.uk2_profiles.get(name))
        if name in self.pk_profiles:
            return pwr.PressureTracer(pk=self.pk_profiles[name])
        if name in self.cib_tracers:
            return self.cib_tracers[name]
        raise ValueError(f"Unknown tracer {name!r}")

    # ---- CIB (models/cib.py, Shang et al 2012 forms) ----
    def add_cib_tracer(self, name, nu_ghz, param_override=None,
                       satellite_profile="nfw", ignore_existing=False):
        """An emissivity-weighted CIB tracer at an observed frequency
        [GHz]: satellites on the named registered profile (its <u^2> too,
        the same tensor for every frequency), centrals at the halo
        center.  ``get_power(name, other)`` then gives every pairing and
        ``get_cib_cls`` its C_ell."""
        if not ignore_existing:
            _require(name not in self.cib_tracers,
                     "Tracer name already exists.")
        us = self.uk_profiles[satellite_profile]
        self.cib_tracers[name] = cibm.build_cib_tracer(
            self.ms_np, self.zs, nu_ghz, us, params=param_override,
            us2=self.uk2_profiles.get(satellite_profile))
        return self.cib_tracers[name]

    def get_cib_mean_emissivity(self, name):
        return cibm.mean_emissivity(self.nzm, self.ms, self.cib_tracers[name])

    def get_cib_mean_intensity(self, name):
        return cibm.mean_intensity(self.zs, self.h_of_z(self.zs), self.nzm,
                                   self.ms, self.cib_tracers[name])

    def get_cib_cls(self, ells, name1, name2=None):
        """C_ell of two tracers of this instance (CIB anisotropies in L0^2
        units): C = int dchi a^2 P_jj'(k = (l + 1/2) / chi) / chi^2, by
        ``limber.limber_integral`` with W = a / H."""
        from .limber import limber_integral
        P = self.get_power(name1, name2)
        hzs = self.h_of_z(self.zs)
        chis = self.comoving_radial_distance(self.zs)
        W = (1.0 / (1.0 + self.zs)) / hzs   # limber multiplies by hzs once
        return limber_integral(ells, self.zs, self.ks, P, self.zs,
                               W, W, hzs, chis)

    # ---- HI / 21 cm (models/hi.py, VN18 M_HI form) ----
    def add_hi_tracer(self, name, profile_name="nfw", param_override=None,
                      ignore_existing=False):
        """A density-normalized HI tracer: M_HI(M) inside the named
        registered profile.  ``get_power(name, other)`` gives P_HIHI and
        every cross; ``get_p21`` the brightness-temperature power."""
        if not ignore_existing:
            _require(name not in self.cib_tracers,
                     "Tracer name already exists.")
        _require(profile_name in self.uk_profiles,
                 f"Unknown profile {profile_name!r}")
        p = scoped_override(dict(him.default_hi_params), param_override,
                            set(him.default_hi_params), strict=True)
        tr, _ = him.build_hi_tracer(
            self.ms, self.nzm, self.uk_profiles[profile_name], p,
            us2=self.uk2_profiles.get(profile_name))
        self.cib_tracers[name] = tr
        self._hi_params[name] = p
        return tr

    def _hi_params_of(self, name, param_override):
        return (self._hi_params.get(name)
                if name is not None and self._hi_params else param_override)

    def get_omega_hi(self, name=None, param_override=None):
        """Omega_HI(z) = int dm n M_HI / rho_crit(0)."""
        return him.omega_hi(self.nzm, self.ms, self.rho_critical_z(0.0),
                            self._hi_params_of(name, param_override))

    def get_hi_bias(self, name=None, param_override=None):
        return him.hi_bias(self.nzm, self.bh, self.ms,
                           self._hi_params_of(name, param_override))

    def get_p21(self, name, name2=None):
        """21 cm brightness-temperature power P_21(k, z) [mK^2 Mpc^3]:
        Tb(z)^2 (Tb1 Tb2 for two HI tracers) times the HI power."""
        ez = bgmod.e_of_z(self.bg, self.zs)
        tb1 = him.mean_brightness_temp_mk(self.zs, ez,
                                          self.get_omega_hi(name), self.h)
        tb2 = tb1
        if name2 is not None and name2 != name:
            tb2 = him.mean_brightness_temp_mk(
                self.zs, ez, self.get_omega_hi(name2), self.h)
        return (tb1 * tb2)[:, None] * self.get_power(name, name2)

    def get_galaxy_rsd_multipoles(self, hod_name, ks=None, model="tns",
                                  **kw):
        """Redshift-space multipoles of a registered HOD tracer: its
        linear bias b_g(z) from the HOD mass integral, f(z) from the
        growth rate, the PT ingredients by ``get_rsd_multipoles`` (model
        'kaiser', 'scoccimarro' or 'tns'); ks defaults to the model grid.
        Returns {ell: (nz, nk)}."""
        bg = self.hods[hod_name]["bg"]
        ks = self.ks if ks is None else ks
        return self.get_rsd_multipoles(self.zs, ks, b=bg, model=model, **kw)

    # ---- spectra ----
    def get_power_1halo(self, name="nfw", name2=None):
        t1 = self._tracer(name)
        t2 = t1 if name2 in (None, name) else self._tracer(name2)
        return pwr.power_1halo(t1, t2, self.nzm, self.ms, self.ks,
                               self.rho_matter_z(0.0),
                               self.p["kstar_damping"])

    def exclusion_radius(self):
        """Bias-weighted mean comoving exclusion radius (nz,) [Mpc]:
        (1+z) int n b (2 r_vir) dm / int n b dm."""
        rvirs = self.rvir(self.ms[None, :], self.zs[:, None])
        w = self.nzm * self.bh
        tw = self._mass_weights(np.log(self.ms_np))[None, :]
        num = torch.sum(tw * w * self.ms[None, :] * 2.0 * rvirs, dim=-1)
        den = torch.sum(tw * w * self.ms[None, :], dim=-1)
        return (1.0 + self.zs) * num / den

    def get_power_2halo(self, name="nfw", name2=None, verbose=False,
                        b1_in=None, b2_in=None, fnl=None, deltac=1.42,
                        exclusion=None):
        """2-halo spectrum; ``fnl`` threads the scale-dependent bias
        through each leg; ``exclusion`` ('auto', a radius in Mpc or an
        (nz,) array) adds the sharp halo-exclusion correction."""
        del verbose
        t1 = self._tracer(name)
        t2 = t1 if name2 in (None, name) else self._tracer(name2)
        alpha_zk = (self.alpha_fnl(self.zs, self.ks)
                    if fnl is not None else None)
        p2h = pwr.power_2halo(t1, t2, self.nzm, self.bh, self.ms, self.Pzk,
                              self.rho_matter_z(0.0), b1_in, b2_in,
                              fnl=fnl, alpha_zk=alpha_zk, deltac=deltac)
        if exclusion is not None:
            if isinstance(exclusion, str):
                if exclusion != "auto":
                    raise ValueError(
                        f"exclusion: unknown option {exclusion!r} "
                        "(use 'auto', a radius in Mpc, or an (nz,) array)")
                r_excl = self.exclusion_radius()
            else:
                r_excl = exclusion
            p2h = p2h + pwr.exclusion_correction(self.ks_np, p2h, r_excl)
        return p2h

    def get_power(self, name="nfw", name2=None, verbose=False, b1=None,
                  b2=None, fnl=None, deltac=1.42, exclusion=None):
        return (self.get_power_1halo(name, name2)
                + self.get_power_2halo(name, name2, verbose, b1, b2,
                                       fnl=fnl, deltac=deltac,
                                       exclusion=exclusion))

    # ---- bispectra (models/bispectrum.py) ----
    def _b2_grid(self, include_b2):
        """The second-order halo bias of the 3-halo term: the peak-
        background split of the Sheth-Tormen multiplicity (an approximation
        under the Tinker modes)."""
        if not include_b2:
            return None
        return bsp.b2_sheth_torman(self.sigma2, self.p)

    def get_bispectrum(self, k1=None, k2=None, k3=None, name="nfw",
                       name2=None, name3=None, terms="total",
                       b1_in=(None, None, None), include_b2=False):
        """B(z; k1, k2, k3) of a registered tracer triple; each leg a
        scalar, an (nq,) array shared across z (k1 = k2 = k3 = ks: the
        equilateral sweep) or (nz, nq) per z.  ``terms``: '1h', '2h', '3h'
        or 'total'."""
        # one tracer object per repeated name: the same-halo moments
        # dispatch on identity
        t1 = self._tracer(name)
        t2 = t1 if name2 in (None, name) else self._tracer(name2)
        t3 = (t1 if name3 in (None, name)
              else (t2 if name3 == name2 else self._tracer(name3)))
        if k1 is None:
            k1 = self.ks
        if k2 is None:
            k2 = k1
        if k3 is None:
            k3 = k1
        rho = self.rho_matter_z(0.0)
        kd = self.p["kstar_damping"]
        if terms == "1h":
            return bsp.bispectrum_1halo(t1, t2, t3, self.nzm, self.ms,
                                        self.ks, rho, k1, k2, k3, kd)
        if terms == "2h":
            return bsp.bispectrum_2halo(t1, t2, t3, self.nzm, self.bh,
                                        self.ms, self.ks, self.Pzk, rho,
                                        k1, k2, k3, b1_in)
        if terms == "3h":
            return bsp.bispectrum_3halo(t1, t2, t3, self.nzm, self.bh,
                                        self.ms, self.ks, self.Pzk, rho,
                                        k1, k2, k3, b1_in,
                                        self._b2_grid(include_b2))
        if terms == "total":
            return bsp.bispectrum_total(t1, t2, t3, self.nzm, self.bh,
                                        self.ms, self.ks, self.Pzk, rho,
                                        k1, k2, k3, kd, b1_in,
                                        self._b2_grid(include_b2))
        raise ValueError(f"Unknown bispectrum terms {terms!r}")

    def get_angular_bispectrum(self, ells1, ells2=None, ells3=None,
                               name="nfw", name2=None, name3=None,
                               Wz1s=None, Wz2s=None, Wz3s=None,
                               terms="total", include_b2=False):
        """Flat-sky Limber reduced bispectrum b(l1, l2, l3) of the tracer
        triple with limber_integral's window convention (None is unity, the
        tSZ-y case); the ell triplets broadcast to one shape."""
        if ells2 is None:
            ells2 = ells1
        if ells3 is None:
            ells3 = ells1
        chis = self.comoving_radial_distance(self.zs)
        hzs = self.h_of_z(self.zs)

        def B_fn(kq1, kq2, kq3):
            return self.get_bispectrum(kq1, kq2, kq3, name, name2, name3,
                                       terms=terms, include_b2=include_b2)

        return bsp.projected_bispectrum(ells1, ells2, ells3, self.zs, hzs,
                                        chis, Wz1s, Wz2s, Wz3s, B_fn)

    def cluster_counts(self, mmin, fsky=1.0, mmax=None):
        """(dN/dz, N_total) of halos above ``mmin`` (and below ``mmax``)
        over the sky fraction ``fsky``: fsky 4 pi chi^2 / H int n dm,
        trapezoid on this instance's grids."""
        w = self._mass_weights()
        mask = self.ms >= mmin
        if mmax is not None:
            mask = mask & (self.ms <= mmax)
        n_of_z = (self.nzm * torch.where(mask, w, 0.0)[None, :]).sum(dim=-1)
        chi = self.comoving_radial_distance(self.zs)
        dvdz = 4.0 * math.pi * chi**2 / self.h_of_z(self.zs)
        dndz = fsky * dvdz * n_of_z
        return dndz, dndz @ self._t(trapz_weights(self.zs_np))

    # ---- cluster counts through a Y-M relation (models/cluster_counts.py) ----
    def _count_grids(self):
        chis = self.comoving_radial_distance(self.zs)
        return chis, self.h_of_z(self.zs), bgmod.e_of_z(self.bg, self.zs)

    def cluster_counts_obs(self, q, sigma_noise, fsky=1.0, **scaling):
        """(dN/dz, N_total) of clusters detected above SNR ``q`` through
        the lognormal Y-M relation; ``sigma_noise`` sigma_N(z) in the
        relation's Y units, ``scaling`` its parameters
        (lnYstar/alpha/beta/Mpivot/sigma_lnY/sigma_meas_ln)."""
        chis, hzs, ez = self._count_grids()
        return ccm.dndz_detected(self.zs_np, self.ms, self.nzm, chis, hzs,
                                 ez, q, sigma_noise, fsky=fsky, **scaling)

    def cluster_counts_q_bins(self, q_edges, sigma_noise, fsky=1.0,
                              z_edges=None, **scaling):
        """Expected counts per (z, SNR) bin (``counts_q_bins``)."""
        chis, hzs, ez = self._count_grids()
        return ccm.counts_q_bins(self.zs_np, self.ms, self.nzm, chis, hzs,
                                 ez, q_edges, sigma_noise, fsky=fsky,
                                 z_edges=z_edges, **scaling)

    def cluster_counts_covariance(self, z_edges, mmin=None, fsky=1.0,
                                  q=None, sigma_noise=None, ks_lin=None,
                                  **scaling):
        """(N_i, Cov_ij) of counts in the redshift bins ``z_edges``:
        Poisson plus sample variance, delta_ij N_i + <bN>_i <bN>_j
        sigma^2_ij, the selection a sharp ``mmin`` or the completeness of
        (``q``, ``sigma_noise``)."""
        N_i, bN_i, s2 = self._counts_cov_parts(
            z_edges, mmin=mmin, fsky=fsky, q=q, sigma_noise=sigma_noise,
            ks_lin=ks_lin, **scaling)
        return N_i, ccm.counts_covariance(N_i, bN_i, s2)

    def _counts_cov_parts(self, z_edges, mmin=None, fsky=1.0, q=None,
                          sigma_noise=None, ks_lin=None, **scaling):
        """(N_i, <bN>_i, sigma^2_ij) of the binned count covariance."""
        z_edges = np.asarray(z_edges, dtype=float)
        zs = self.zs_np
        chis, hzs, ez = self._count_grids()
        dvdz = fsky * 4.0 * math.pi * chis**2 / hzs
        wm = self._mass_weights()
        if q is not None:
            sel = ccm.completeness(self.ms, ez, q, sigma_noise, **scaling)
        else:
            if mmin is None:
                raise ValueError("pass mmin or (q, sigma_noise)")
            sel = (self.ms >= mmin)[None, :].expand(self.nzm.shape)
        dndz = dvdz * ((self.nzm * sel) @ wm)
        dbndz = dvdz * ((self.nzm * self.bh * sel) @ wm)

        def zbin_trapz(f):
            rows = []
            for lo, hi in zip(z_edges[:-1], z_edges[1:]):
                idx = np.nonzero((zs >= lo) & (zs < hi))[0]
                if idx.size > 1:
                    rows.append(f[self._t(idx).long()]
                                @ self._t(trapz_weights(zs[idx])))
                else:
                    rows.append(torch.zeros((), dtype=_F64,
                                            device=self.device))
            return torch.stack(rows)

        if ks_lin is None:
            ks_lin = np.geomspace(1e-4, 5.0, 400)
        plin = self.P_lin_slow(ks_lin, self.zs)
        s2 = ccm.window_sigma2(z_edges, self.zs, chis, ks_lin, plin, fsky)
        return zbin_trapz(dndz), zbin_trapz(dbndz), s2

    # ---- covariances (models/cov.py) ----
    def _windows(self, *ws):
        ones = torch.ones_like(self.zs)
        return [ones if w is None else self._t(w) for w in ws]

    def joint_counts_cl_cov(self, z_edges, ells, name1, name2=None,
                            Wz1s=None, Wz2s=None, mmin=None, fsky=1.0,
                            q=None, sigma_noise=None, ks_lin=None,
                            cov_cl_gauss=None, pad_background=True,
                            **scaling):
        """(N_i, Cov) of binned cluster counts and the C_ell of a tracer
        pair, (nbin + nl) square: the counts block, Cov(N_i, C_l) and the
        binned-window C_ell super-sample block (+ ``cov_cl_gauss``), all
        on the background mode of the count bins (``cov.py``).  With
        ``pad_background`` (the default) zero-count background bins tile
        the rest of the zs grid, at most 16 on each side, so that modes
        outside [z_edges[0], z_edges[-1]] stay in the C_ell blocks.
        z_edges must lie inside the zs grid."""
        z_edges = np.asarray(z_edges, dtype=float)
        zs_np = self.zs_np
        if (z_edges[0] < zs_np[0] - 1e-12
                or z_edges[-1] > zs_np[-1] + 1e-12):
            raise ValueError(
                f"z_edges [{z_edges[0]}, {z_edges[-1]}] extend beyond the "
                f"zs grid [{zs_np[0]}, {zs_np[-1]}]; background-mode "
                "windows outside the grid cannot be represented")
        nb = z_edges.size - 1
        lo_pads = hi_pads = np.empty(0)
        if pad_background:
            width = np.median(np.diff(z_edges))

            def _pads(a, b):
                if b - a <= 1e-10:
                    return np.empty(0)
                n = min(16, max(1, int(np.ceil((b - a) / width))))
                return (np.linspace(a, b, n + 1)[:-1] if a < z_edges[0]
                        else np.linspace(a, b, n + 1)[1:])

            lo_pads = _pads(zs_np[0], z_edges[0])
            hi_pads = _pads(z_edges[-1], zs_np[-1])
        edges_full = np.concatenate([lo_pads, z_edges, hi_pads])
        n_lo = lo_pads.size
        N_f, bN_f, s2 = self._counts_cov_parts(
            edges_full, mmin=mmin, fsky=fsky, q=q, sigma_noise=sigma_noise,
            ks_lin=ks_lin, **scaling)
        # pad bins are pure background modes: no observed counts there
        count_row = np.zeros(edges_full.size - 1)
        count_row[n_lo:n_lo + nb] = 1.0
        N_f = N_f * self._t(count_row)
        bN_f = bN_f * self._t(count_row)
        P = self.get_power(name1, name2)
        hzs = self.h_of_z(self.zs)
        chis = self.comoving_radial_distance(self.zs)
        W1, W2 = self._windows(Wz1s, Wz2s)
        r_bl = covm.cl_ssc_response_binned(ells, edges_full, self.zs_np,
                                           self.ks, P, W1, W2, hzs, chis)
        cov_full = covm.joint_counts_cl_cov(N_f, bN_f, s2, r_bl,
                                            cov_cl_gauss=cov_cl_gauss)
        keep = self._t(np.concatenate([
            np.arange(n_lo, n_lo + nb),
            np.arange(edges_full.size - 1, cov_full.shape[0])])).long()
        return (N_f[n_lo:n_lo + nb],
                cov_full.index_select(0, keep).index_select(1, keep))

    def get_cl_cov_t1h(self, ells, name1, name2=None, Wz1s=None, Wz2s=None,
                       fsky=1.0, name3=None, name4=None, Wz3s=None,
                       Wz4s=None):
        """Connected (1-halo trispectrum) covariance Cov(C^12_l, C^34_l')
        with limber_integral's window conventions (W defaults to 1, the
        C_yy case); names 3/4 default to 1/2, and given they make the
        cross-covariance of two spectra (e.g. Cov(C_yy, C_gg))."""
        def tracer_pair(na, nb):
            ta = self._tracer(na)
            tb = ta if nb in (None, na) else self._tracer(nb)
            return pwr.one_halo_square_term(ta, tb, self.ms,
                                            self.rho_matter_z(0.0))

        term12 = tracer_pair(name1, name2)
        if name3 is None and name4 is None:
            term34 = term12
        else:
            term34 = tracer_pair(name3 if name3 is not None else name1,
                                 name4 if name4 is not None else name2)
        t_zkk = covm.trispectrum_1h_terms(self.nzm, self.ms, term12, term34)
        hzs = self.h_of_z(self.zs)
        chis = self.comoving_radial_distance(self.zs)
        W1, W2 = self._windows(Wz1s, Wz2s)
        return covm.cl_cov_t1h(ells, self.zs_np, self.ks, t_zkk, W1, W2,
                               hzs, chis, fsky, Wz3s=Wz3s, Wz4s=Wz4s)

    def get_cl_cov_ssc(self, ells, name1, name2=None, Wz1s=None, Wz2s=None,
                       fsky=1.0):
        """Super-sample covariance of the C_ell of a tracer pair (the flat-
        sky disk of fsky; the linear response of this instance's 1h + 2h
        P for the pair)."""
        P = self.get_power(name1, name2)
        hzs = self.h_of_z(self.zs)
        chis = self.comoving_radial_distance(self.zs)
        ks_lin = np.geomspace(1e-4, 1.0, 512)
        sb2 = covm.sigma_b2_disk(fsky, chis, ks_lin,
                                 self.P_lin(ks_lin, self.zs))
        W1, W2 = self._windows(Wz1s, Wz2s)
        return covm.cl_cov_ssc(ells, self.zs_np, self.ks, P, W1, W2, hzs,
                               chis, sb2)

    def get_pk_covariance(self, volume_gpc3, name="nfw", pk_tot=None,
                          dks=None):
        """Matter P(k) covariance per z in a volume [Gpc^3]: a dict of
        'gauss', 't1h', 'ssc' (each (nz, nk, nk)) and their sum 'total'.
        ``pk_tot`` replaces the spectrum of the Gaussian term (e.g. with
        shot noise); by default this model's 1h + 2h P(k) of ``name``."""
        V = volume_gpc3 * 1e9  # Mpc^3
        if pk_tot is None:
            pk_tot = self.get_power(name)
        pk_tot = self._t(pk_tot)
        uk = self.uk_profiles[name]
        gauss = covm.pk_cov_gaussian(self.ks, pk_tot, V, dks=dks)
        t1h = covm.trispectrum_1h(self.nzm, self.ms, self.rho_matter_z(0.0),
                                  uk) / V
        resp = covm.pk_response_ssc(self.ks, pk_tot)
        # the survey window peaks near k ~ 1/R, below the usual grids
        ks_lin = np.geomspace(1e-4, 1.0, 512)
        sb2 = covm.sigma_b2_tophat(V, ks_lin, self.P_lin(ks_lin, self.zs))
        ssc = covm.pk_cov_ssc(resp, sb2)
        return {"gauss": gauss, "t1h": t1h, "ssc": ssc,
                "total": gauss + t1h + ssc}

    # ---- cluster lensing (models/cluster_lensing.py) ----
    def sigma_1h_profiles(self, thetas, Ms, concs, sig_theta=None, delta=200,
                          rho="mean", rho_at_z=True):
        return clm.sigma_1h_profiles(self.bg, self.zs, thetas, Ms, concs,
                                     sig_theta=sig_theta, delta=delta,
                                     rho=rho, rho_at_z=rho_at_z)

    def kappa_1h_profiles(self, thetas, Ms, concs, zsource, sig_theta=None,
                          delta=200, rho="mean", rho_at_z=True):
        return clm.kappa_1h_profiles(self.bg, self.zs, thetas, Ms, concs,
                                     zsource, sig_theta=sig_theta,
                                     delta=delta, rho=rho, rho_at_z=rho_at_z)

    def kappa_2h_profiles(self, thetas, Ms, zsource, lmin=100, lmax=10000):
        """2-halo kappa(theta) per z, (ntheta, nz), with the halo bias of
        each z row interpolated at the cluster mass M (a scalar)."""
        bh_at_m = linear_interp(self._t(Ms).reshape(()), self.ms, self.bh)
        return clm.kappa_2h_profiles(self.bg, self.zs, self.ks, self.Pzk,
                                     bh_at_m, thetas, zsource, lmin, lmax)

