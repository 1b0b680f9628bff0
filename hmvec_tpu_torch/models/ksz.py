"""kSZ velocity-reconstruction forecasting on float64 tensors (port of
hmvec_tpu/models/ksz.py).

The linear matter power at k < 0.1/Mpc drives the large-scale Pgv/Pvv/Pgg;
the halo model at k > 0.1/Mpc the small-scale Pge/Pgg.  ``Nvv_core_integral``
is the velocity reconstruction noise N_vv(mu, kL), one trapezoid over the
small-scale kS grid.

The class ``kSZ`` (a ``HaloModel`` with the electron profile, the HOD and
the large-scale grids of one or more redshift bins) and the forecasts on
it (``get_ksz_snr``, ``Nvv``, the template cross and the two kSZ auto
spectra, ``get_ksz_snr_survey``) run on the instance's device, the card
unless ``device="cpu"`` is given.  The pipelines (``make_ksz_snr_fn``,
``make_ksz_survey_fn``) compute the same forecast as one function of the
parameters; ``get_ksz_snr_survey`` dispatches to the survey pipeline
where it can.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.quadrature import linear_interp, trapz, trapz_traced
from ..params import default_params, merge_params
from ..utils.weights import on_device_of_inputs, tensor_or_f64
from . import background as bgmod
from .cosmology import Cosmology
from .halo_model import HaloModel
from .mass_function import _tensor

defaults = {"min_mass": 1e6, "max_mass": 1e16, "num_mass": 1000}
constants = {
    "thompson_SI": 6.6524e-29,
    "meter_to_megaparsec": 3.241e-23,
    "G_SI": 6.674e-11,
    "mProton_SI": 1.673e-27,
    "H100_SI": 3.241e-18,
}


def Ngg(ngal_mpc3):
    """Galaxy shot noise 1 / n_gal."""
    return 1.0 / ngal_mpc3


def get_kmin(volume_gpc3):
    """The box's fundamental mode pi / V^(1/3), V in Mpc^3 (numpy)."""
    vol_mpc3 = volume_gpc3 * 1e9
    return np.pi / vol_mpc3 ** (1.0 / 3.0)


def chi_ion(Yp, NHe=0):
    """Ionization fraction factor."""
    return (1.0 - Yp * (1.0 - NHe / 4.0)) / (1.0 - Yp / 2.0)


# reference-named alias
chi = chi_ion


def ne0_shaw(ombh2, Yp, NHe=0, me=1.14, gasfrac=0.9):
    """Mean electron density today in 1/m^3 (Shaw et al., 1109.0553 eq. 3)."""
    omgh2 = gasfrac * ombh2
    mu_e = 1.14
    fact = 3.0 * constants["H100_SI"] ** 2 / (
        constants["mProton_SI"] * 8.0 * np.pi * constants["G_SI"])
    return chi_ion(Yp, NHe) * omgh2 * fact / mu_e


@on_device_of_inputs
def ksz_radial_function(z, ombh2, Yp, gasfrac=0.9, xe=1, tau=0, params=None):
    """K(z) = T_CMB sigma_T n_e0 x_e exp(-tau) (1+z)^2 (1810.13423 eq. 4).

    Differentiable in (ombh2, Yp): only the physical constants are folded
    on the host.  ``z`` is a tensor (or an array, taken to the CPU)."""
    if params is None:
        params = default_params
    T_CMB_muk = params["T_CMB"]
    # the constant part of ne0_shaw (everything but chi(Yp) ombh2)
    ne0_const = (0.9 / 1.14) * 3.0 * constants["H100_SI"] ** 2 / (
        constants["mProton_SI"] * 8.0 * np.pi * constants["G_SI"])
    pref_const = (constants["thompson_SI"] / constants["meter_to_megaparsec"]
                  * ne0_const * (gasfrac / 0.9))
    ne0_param = chi_ion(Yp) * ombh2
    pref = T_CMB_muk * pref_const * ne0_param
    return pref * (1.0 + _tensor(z)) ** 2 * xe * math.exp(-tau)


def _sanitize(x):
    """Zero out the non-finite entries."""
    return torch.where(torch.isfinite(x), x, 0.0)


@on_device_of_inputs
def get_interpolated_cls(Cls, chistar, kss):
    """C_tot(l = chistar k) by integer lookup: l truncated to an integer,
    zero below l = 2, inf beyond lmax."""
    kss = _tensor(kss)
    Cls = _tensor(Cls, kss.device)
    n = Cls.shape[0]
    ls = torch.arange(n, device=Cls.device)
    Cls = torch.where(ls < 2, 0.0, Cls)
    ell = chistar * kss
    # gather through a 1-d index: a 0-d index tensor would be read back to
    # the host
    idx = torch.clamp(ell.to(torch.int32), 0, n - 1)
    vals = Cls[idx.reshape(-1).long()].reshape(idx.shape)
    return torch.where(ell <= n - 1, vals, math.inf)


@on_device_of_inputs
def Nvv_core_integral(chi_star, Fstar, mu, kL, kSs, Cls, Pge, Pgg_tot,
                      Pgg_photo_tot=None, errs=False, robust_term=False,
                      photo=True):
    """Velocity reconstruction noise N_vv(mu, kL), shape (nmu, nkL).

    Pge and Pgg_tot are (nkS,) or broadcast as (..., nkS); the kS integral
    is one trapezoid on the kSs grid."""
    if robust_term and photo:
        photo = False
    Pge, Pgg_tot = tensor_or_f64(Pge), tensor_or_f64(Pgg_tot)
    if Pgg_photo_tot is not None:
        Pgg_photo_tot = tensor_or_f64(Pgg_photo_tot)

    if errs:
        ret_Pge = Pge
        Pge = 1.0

    kSs = _tensor(kSs)
    mu = _tensor(mu, kSs.device)
    kL = _tensor(kL, kSs.device)
    amu = mu[:, None] + 0.0 * kL[None, :]
    prefact = amu ** (-2.0) * 2.0 * math.pi * chi_star**2 / Fstar**2

    # double where: the inf (beyond lmax) Cls entries are masked out of the
    # division itself, not just the result, so that gradients stay finite
    Clkstot = get_interpolated_cls(Cls, chi_star, kSs)
    finite = torch.isfinite(Clkstot) & (Clkstot > 0)
    Cl_safe = torch.where(finite, Clkstot, 1.0)
    integrand = torch.where(finite, kSs * Pge**2 / (Pgg_tot * Cl_safe), 0.0)
    integrand = _sanitize(integrand)
    if robust_term:
        if Pgg_photo_tot is None:
            raise ValueError("robust_term needs Pgg_photo_tot")
        integrand = _sanitize(integrand * (Pgg_photo_tot / Pgg_tot))

    integral = trapz(integrand, kSs)
    Nvv = prefact / integral
    if errs:
        return Nvv, ret_Pge
    return Nvv


@on_device_of_inputs
def pge_err_core(pgv_int, kstar, chistar, volume_gpc3, kss, ks_bin_edges,
                 pggtot, Cls):
    """Bandpower errors on Pge, one per bin of ``ks_bin_edges``: the
    trapezoid segments of each bin, masked per (bin, segment)."""
    volume = volume_gpc3 * 1e9
    kss = _tensor(kss)
    pggtot = tensor_or_f64(pggtot)
    cltot = get_interpolated_cls(Cls, chistar, kss)
    integrand = _sanitize(kss / (pggtot * cltot))
    edges = _tensor(ks_bin_edges, kss.device)
    sel = (kss[None, :] > edges[:-1, None]) & (kss[None, :] <= edges[1:, None])
    dx = torch.diff(kss)
    pair = sel[:, 1:] & sel[:, :-1]
    seg = (integrand[1:] + integrand[:-1])[None, :] / 2.0 * dx[None, :] * pair
    ints = seg.sum(dim=-1)
    return (volume * kstar**2 / 12.0 / math.pi**3 / chistar**2
            * pgv_int * ints) ** (-0.5)


def get_survey_volume(zmin, zmax, fsky, params=None, device="cuda"):
    """The survey's overlap volume in Gpc^3 (a Python float)."""
    c = Cosmology(params=params, accuracy="low", device=device)
    chimin = c.comoving_radial_distance(zmin)
    chimax = c.comoving_radial_distance(zmax)
    return float(fsky * (4.0 / 3.0) * np.pi * (chimax**3 - chimin**3) / 1e9)


class kSZ(HaloModel):
    """The kSZ forecast of a set of redshift bins: the halo model of the
    bins on the small-scale kS grid, with the Battaglia electron profile
    and the HOD, and the large-scale grids (mu, kL) with the linear power
    and growth rate.  ``sigz``: the photo-z scatter sigma_z (1+z), which
    damps the galaxy legs by W(mu, kL) and gives the small-scale spectra
    the shape (nz, nmu, nkL, nkS)."""

    def __init__(self, zs, volumes_gpc3, ngals_mpc3,
                 kL_max=0.1, num_kL_bins=100, kS_min=0.1, kS_max=10.0,
                 num_kS_bins=101, num_mu_bins=102, ms=None, params=None,
                 mass_function="sheth-torman", halofit=None, mdef="vir",
                 nfw_numeric=False, skip_nfw=False,
                 electron_profile_name="e", electron_profile_family="AGN",
                 skip_electron_profile=False,
                 electron_profile_param_override=None,
                 electron_profile_nxs=None, electron_profile_xmax=None,
                 skip_hod=False, hod_name="g", hod_corr="max",
                 hod_param_override=None, mthreshs_override=None,
                 verbose=False, b1=None, b2=None, sigz=None, engine="eh",
                 pk_table=None, device="cuda"):
        del verbose
        if ms is None:
            ms = np.geomspace(defaults["min_mass"], defaults["max_mass"],
                              defaults["num_mass"])
        zs = np.atleast_1d(np.asarray(zs, dtype=np.float64))
        volumes_gpc3 = np.atleast_1d(np.asarray(volumes_gpc3,
                                                dtype=np.float64))
        ngals_mpc3 = np.atleast_1d(np.asarray(ngals_mpc3, dtype=np.float64))
        if not zs.size == volumes_gpc3.size == ngals_mpc3.size:
            raise ValueError("zs, volumes_gpc3 and ngals_mpc3 need one "
                             "entry per redshift bin")

        ks = np.geomspace(kS_min, kS_max, num_kS_bins)
        super().__init__(zs, ks, ms=ms, params=params,
                         mass_function=mass_function, halofit=halofit,
                         mdef=mdef, nfw_numeric=nfw_numeric,
                         skip_nfw=skip_nfw, engine=engine, pk_table=pk_table,
                         device=device)
        self.mu = self._t(np.linspace(-1.0, 1.0, num_mu_bins))
        self.kS = self.ks
        if not skip_electron_profile:
            self.add_battaglia_profile(
                name=electron_profile_name, family=electron_profile_family,
                param_override=electron_profile_param_override,
                nxs=electron_profile_nxs, xmax=electron_profile_xmax)
        if not skip_hod:
            self.add_hod(hod_name, mthresh=mthreshs_override,
                         ngal=(None if mthreshs_override is not None
                               else ngals_mpc3),
                         corr=hod_corr, satellite_profile_name="nfw",
                         central_profile_name=None,
                         param_override=hod_param_override)

        self.sigz = sigz
        self.sigma_z_func = lambda z: sigz * (1.0 + np.asarray(z))
        self.Hphotozs = self.h_of_z(self.zs)

        # the long-wavelength grids, with one k_min for every bin
        self.kLs = self._t(np.geomspace(get_kmin(np.max(volumes_gpc3)),
                                        kL_max, num_kL_bins))
        self.krs = self.mu[:, None] * self.kLs[None, :]
        self.Vs = volumes_gpc3
        self.ngals_mpc3 = ngals_mpc3

        # the small-scale halo-model spectra
        if not skip_hod:
            sPgg = self.get_power(hod_name, name2=hod_name, b1=b1, b2=b1)
            sPge = self.get_power(hod_name, name2=electron_profile_name,
                                  b1=b1)
            if sigz is not None:
                W = self.Wphoto_all()            # (nz, nmu, nkL)
                self.sPggs = sPgg[:, None, None, :] * W[..., None] ** 2
                self.sPges = sPge[:, None, None, :] * W[..., None]
            else:
                self.sPggs = sPgg
                self.sPges = sPge

        # the linear P(kL, z) and the growth rate
        p = self.P_lin_slow(self.kLs, self.zs)                # (nz, nkL)
        growth = self.get_growth_rate_f(self.zs)              # (nz,)
        a = 1.0 / (1.0 + self.zs)
        H = self.h_of_z(self.zs)
        self.Pmms = p[:, None, :].expand(zs.size, self.mu.shape[0],
                                         self.kLs.shape[0])
        self.fs = growth
        self.adotf = growth * a * H
        self.d2vs = (growth * a * H)[:, None] / self.kLs[None, :]
        self.kstars = ksz_radial_function(self.zs, self.ombh2, self.YHe,
                                          params=self.p)
        self.chistars = self.comoving_radial_distance(self.zs)
        if not skip_hod:
            self.bgs = self.hods[hod_name]["bg"]
            # the velocity-reconstruction integral per bin
            nggs = Ngg(self._t(ngals_mpc3))
            flPgg = self.Pmms[:, 0, :] * self.bgs[:, None] ** 2 + nggs[:, None]
            flPgv = self.Pmms[:, 0, :] * self.bgs[:, None] * self.d2vs
            integrand = _sanitize(self.kLs[None, :] ** 2 * flPgv**2 / flPgg)
            self.vrec = trapz_traced(integrand, self.kLs)
            if sigz is not None:
                self.sPggtot = self.sPggs + nggs[:, None, None, None]
            else:
                self.sPggtot = self.sPggs + nggs[:, None]
            self.sPge = self.sPges

    # ---- long-wavelength spectra ----
    def Wphoto(self, zindex):
        """Photo-z damping W(mu, kL) = exp(-sigz^2 kr^2 / 2 H^2) of one bin."""
        sig = float(self.sigma_z_func(self.zs_np[zindex]))
        H = self.Hphotozs[zindex]
        return torch.exp(-sig**2 * self.krs**2 / 2.0 / H**2)

    def Wphoto_all(self):
        sig = self._t(self.sigma_z_func(self.zs_np))          # (nz,)
        return torch.exp(-(sig[:, None, None] ** 2) * self.krs[None] ** 2
                         / 2.0 / self.Hphotozs[:, None, None] ** 2)

    def lPvv(self, zindex, bv1=1, bv2=1):
        """(f a H / kL)^2 Pmm(kL), shape (nmu, nkL)."""
        return (self.d2vs[zindex][None, :] ** 2 * self.Pmms[zindex]
                * bv1 * bv2)

    def lPgg(self, zindex, bg1, bg2):
        Pgg = self.Pmms[zindex] * bg1 * bg2
        if self.sigz is not None:
            Pgg = Pgg[..., None] * self.Wphoto(zindex)[..., None] ** 2
        return Pgg

    def lPgv(self, zindex, bg, bv=1):
        Pgv = self.Pmms[zindex] * bg * bv * self.d2vs[zindex][None, :]
        if self.sigz is not None:
            Pgv = Pgv[..., None] * self.Wphoto(zindex)[..., None]
        return Pgv

    def ksz_radial_function(self, zindex, gasfrac=0.9, xe=1, tau=0,
                            params=None):
        return ksz_radial_function(self.zs[zindex], self.ombh2, self.YHe,
                                   gasfrac=gasfrac, xe=xe, tau=tau,
                                   params=params or self.p)

    def Nvv(self, zindex, Cls):
        """N_vv(mu, kL) of one bin."""
        return Nvv_core_integral(self.chistars[zindex], self.kstars[zindex],
                                 self.mu, self.kLs, self.kS,
                                 self._t(Cls), self.sPge[zindex],
                                 self.sPggtot[zindex])

    def Pge_err(self, zindex, ks_bin_edges, Cls):
        """Pge bandpower errors of one bin."""
        pggtot = self.sPggtot[zindex]
        if self.sigz is not None:
            pggtot = pggtot[0, 0]
        return pge_err_core(self.vrec[zindex], self.kstars[zindex],
                            self.chistars[zindex], self.Vs[zindex], self.kS,
                            ks_bin_edges, pggtot, self._t(Cls))


def Nvv(z, vol_gpc3, ngals_mpc3, Cl_total, sigz=None, kL_max=0.1,
        num_kL_bins=100, kS_min=0.1, kS_max=10.0, num_kS_bins=101,
        num_mu_bins=102, params=None, device="cuda"):
    """(mus, kLs, N_vv) of one bin."""
    hksz = kSZ([z], [vol_gpc3], [ngals_mpc3], kL_max=kL_max,
               num_kL_bins=num_kL_bins, kS_min=kS_min, kS_max=kS_max,
               num_kS_bins=num_kS_bins, num_mu_bins=num_mu_bins,
               sigz=sigz, params=params, device=device)
    return hksz.mu, hksz.kLs, hksz.Nvv(0, Cl_total)


def get_ksz_snr(volume_gpc3, z, ngal_mpc3, Cls, bg=None, params=None,
                kL_max=0.1, num_kL_bins=100, kS_min=0.1, kS_max=10.0,
                num_kS_bins=101, num_mu_bins=102, ms=None,
                mass_function="sheth-torman", mdef="vir", nfw_numeric=False,
                electron_profile_family="AGN", electron_profile_nxs=None,
                electron_profile_xmax=None, sigz=None, device="cuda"):
    """(snr, kSZ instance): the total kSZ velocity SNR of one bin."""
    fksz = kSZ([z], [volume_gpc3], [ngal_mpc3], kL_max=kL_max,
               num_kL_bins=num_kL_bins, kS_min=kS_min, kS_max=kS_max,
               num_kS_bins=num_kS_bins, num_mu_bins=num_mu_bins, ms=ms,
               params=params, mass_function=mass_function, mdef=mdef,
               nfw_numeric=nfw_numeric,
               electron_profile_family=electron_profile_family,
               electron_profile_nxs=electron_profile_nxs,
               electron_profile_xmax=electron_profile_xmax, sigz=sigz,
               device=device)
    V = volume_gpc3 * 1e9
    ngg = Ngg(ngal_mpc3)
    nvv = fksz.Nvv(0, Cls)
    if bg is None:
        bg = fksz.bgs[0]
    lPgg = fksz.lPgg(0, bg1=bg, bg2=bg)
    lPgv = fksz.lPgv(0, bg=bg)
    if sigz is not None:
        lPgg = lPgg[..., 0]
        lPgv = lPgv[..., 0]
    ltPgg = lPgg + ngg
    kls = fksz.kLs
    integrand = _sanitize(kls[None, :] ** 2 * lPgv**2 / ltPgg / nvv)
    result = trapz_traced(integrand, kls)
    snr2 = trapz_traced(result, fksz.mu) / (2.0 * math.pi) ** 2
    return torch.sqrt(V * snr2), fksz


def get_ksz_template_signal_snapshot(ells, volume_gpc3, z, ngal_mpc3, bg,
                                     fparams=None, params=None,
                                     device="cuda", **ksz_kwargs):
    """(C_ell^(That T), fiducial kSZ, true kSZ): the cross of the kSZ
    template with the CMB, for the fiducial ``fparams`` and the true
    ``params`` (the fiducial when None)."""
    fksz = kSZ([z], [volume_gpc3], [ngal_mpc3], params=fparams,
               electron_profile_param_override=fparams, device=device,
               **ksz_kwargs)
    pksz = (kSZ([z], [volume_gpc3], [ngal_mpc3], params=params,
                electron_profile_param_override=params, device=device,
                **ksz_kwargs)
            if params is not None else fksz)

    ngg = Ngg(ngal_mpc3)
    fsPgg = fksz.sPggs[0] + ngg
    fsPge = fksz.sPges[0]
    psPge = pksz.sPges[0] if params is not None else fsPge

    chistar = pksz.comoving_radial_distance(z)
    ratio = _sanitize(fsPge * psPge / fsPgg)
    Pks = linear_interp(fksz._t(ells) / chistar, fksz.kS, ratio,
                        left=0.0, right=0.0)

    fF = fksz.ksz_radial_function(0)
    pF = pksz.ksz_radial_function(0) if params is not None else fF
    V = volume_gpc3 * 1e9
    pref = fF * pF * V ** (1.0 / 3.0) / 6.0 / math.pi**2 / chistar**2

    flPgg = fksz.lPgg(0, bg1=bg, bg2=bg)[0, :] + ngg
    flPgv = fksz.lPgv(0, bg=bg)[0, :]
    plPgv = pksz.lPgv(0, bg=bg)[0, :] if params is not None else flPgv
    kls = fksz.kLs
    integrand = _sanitize(kls**2 * flPgv * plPgv / flPgg)
    vrec = trapz_traced(integrand, kls)
    return pref * Pks * vrec, fksz, pksz


def _geomspace(start, stop, num: int):
    """num log-spaced points from start to stop (tensors of one shape
    (...,)): (..., num), with both ends exact."""
    t = torch.linspace(0.0, 1.0, num, dtype=torch.float64,
                       device=start.device)
    ls, le = torch.log(start)[..., None], torch.log(stop)[..., None]
    out = torch.exp(ls + (le - ls) * t)
    return torch.cat([start[..., None], out[..., 1:-1], stop[..., None]
                      .expand_as(start[..., None])], dim=-1)


def _limber_cl(pksz, zs, ks, P_zk, ells, weight):
    """The kSZ auto C_ell by the Limber-like chi integral of both auto
    paths: for each ell, 100 log-spaced chi from ell/30 to chi(z_max),
    P_zk (nz, nk) read bilinearly in (z, ln k) at (z(chi), ell/chi), zero
    outside the k grid, times weight(chi, z(chi))."""
    ells = pksz._t(np.atleast_1d(ells))
    nz, nk = zs.shape[0], ks.shape[0]
    chi_max = pksz.comoving_radial_distance(zs[-1])
    chi_int = _geomspace(ells / 30.0, chi_max.expand_as(ells), 100)
    k_int = ells[:, None] / chi_int
    z_int = bgmod.redshift_at_comoving_radial_distance(pksz.bg, chi_int)
    if nz > 1:
        iz = torch.clamp(torch.searchsorted(zs, z_int.contiguous()) - 1,
                         0, nz - 2)
        tz = torch.clamp((z_int - zs[iz]) / (zs[iz + 1] - zs[iz]), 0.0, 1.0)
        Pz = (P_zk[iz] * (1 - tz)[..., None]
              + P_zk[iz + 1] * tz[..., None])          # (nl, nchi, nk)
    else:
        Pz = P_zk[0].expand(*chi_int.shape, nk)
    lks = torch.log(ks)
    lke = torch.log(k_int)
    ik = torch.clamp(torch.searchsorted(lks, lke.contiguous()) - 1,
                     0, nk - 2)
    tk = (lke - lks[ik]) / (lks[ik + 1] - lks[ik])
    pv = (torch.gather(Pz, -1, ik[..., None])[..., 0] * (1 - tk)
          + torch.gather(Pz, -1, (ik + 1)[..., None])[..., 0] * tk)
    pv = torch.where((k_int < ks[0]) | (k_int > ks[-1]), 0.0, pv)
    return trapz_traced(pv * weight(chi_int, z_int), chi_int)


def _ksz_kfact(pksz):
    """(sigma_T n_e0 / Mpc)^2 T_CMB^2 in uK^2 of the auto spectra."""
    ne0 = ne0_shaw(pksz.ombh2, pksz.YHe)
    kfact = (constants["thompson_SI"] * ne0
             / constants["meter_to_megaparsec"]) ** 2
    return kfact * float(pksz.p["T_CMB"]) ** 2


def get_ksz_auto_squeezed(ells, volume_gpc3, zs, ngals_mpc3, bgs,
                          params=None, k_max=100.0, num_k_bins=200,
                          num_mu_bins=102, ms=None,
                          mass_function="sheth-torman", mdef="vir",
                          nfw_numeric=False, electron_profile_family="AGN",
                          electron_profile_nxs=None,
                          electron_profile_xmax=None, pksz_in=None,
                          template=False, ngals_mpc3_for_v=None,
                          device="cuda"):
    """(pksz, cl, spec_dict): the CMB kSZ auto power in the Ma & Fry
    squeezed limit, cl in uK^2, by the chi integral of every ell at
    once."""
    spec_dict = {}
    zs = np.sort(np.atleast_1d(np.asarray(zs, dtype=np.float64)))
    volumes = volume_gpc3 * np.ones_like(zs)
    if ngals_mpc3_for_v is None:
        ngals_mpc3_for_v = ngals_mpc3
    p = merge_params(params)
    p["hod_bisection_search_min_log10mthresh"] = 1

    if pksz_in is not None:
        pksz = pksz_in
    else:
        pksz = kSZ(zs, volumes, np.asarray(ngals_mpc3) * np.ones_like(zs),
                   kL_max=k_max, num_kL_bins=num_k_bins,
                   kS_min=get_kmin(volume_gpc3), kS_max=k_max,
                   num_kS_bins=num_k_bins, num_mu_bins=num_mu_bins, ms=ms,
                   params=p, mass_function=mass_function, mdef=mdef,
                   nfw_numeric=nfw_numeric,
                   electron_profile_family=electron_profile_family,
                   electron_profile_nxs=electron_profile_nxs,
                   electron_profile_xmax=electron_profile_xmax,
                   skip_hod=not template, b1=bgs, b2=bgs, device=device)

    ks = pksz.kS
    spec_dict["ks"] = ks
    kls = pksz.kLs
    nz = zs.size

    if not template:
        sPee = pksz.get_power("e", name2="e")                # (nz, nk)
        lPvv = torch.stack([pksz.lPvv(zi)[0, :] for zi in range(nz)])
        spec_dict["sPee"] = sPee
        spec_dict["lPvv"] = lPvv
        vint = trapz_traced(_sanitize(kls[None, :] ** 2 * lPvv), kls)
        Pqr = sPee * vint[:, None] / (6.0 * math.pi**2)      # (nz, nk)
    else:
        ngals = np.atleast_1d(np.asarray(ngals_mpc3)) * np.ones_like(zs)
        ngals_v = (np.atleast_1d(np.asarray(ngals_mpc3_for_v))
                   * np.ones_like(zs))
        sPgg_e = pksz.sPggs + (1.0 / pksz._t(ngals))[:, None]
        sPgg_v = pksz.sPggs + (1.0 / pksz._t(ngals_v))[:, None]
        sPge = pksz.sPges
        lPgv = torch.stack([pksz.lPgv(zi, bg=bgs[zi])[0, :]
                            for zi in range(nz)])
        lPgg = (torch.stack([pksz.lPgg(zi, bgs[zi], bgs[zi])[0, :]
                             for zi in range(nz)])
                + (1.0 / pksz._t(ngals_v))[:, None])
        spec_dict.update(sPgg=sPgg_e, sPge=sPge, lPgv=lPgv, lPgg=lPgg)
        # Pgv^2 / sPgg_v on the kL grid, which is the kS grid here
        vint = trapz_traced(_sanitize(kls[None, :] ** 2 * lPgv**2 / sPgg_v),
                            kls)
        Pqr = _sanitize(sPge**2 / sPgg_e) * vint[:, None] / (6.0 * math.pi**2)

    kfact = _ksz_kfact(pksz)
    cl = _limber_cl(pksz, pksz.zs, ks, Pqr, ells,
                    lambda chi, z: (1.0 + z) ** 4 / chi**2 * kfact)
    return pksz, cl, spec_dict


def get_ksz_auto_signal_mafry(ells, volume_gpc3, zs, ngal_mpc3, bg,
                              params=None, k_max=100.0, num_k_bins=200,
                              num_mu_bins=102, ms=None,
                              mass_function="sheth-torman", mdef="vir",
                              nfw_numeric=False,
                              electron_profile_family="AGN",
                              electron_profile_nxs=None,
                              electron_profile_xmax=None, pksz_in=None,
                              device="cuda"):
    """(pksz, cl): the CMB kSZ auto power by the full Smith et al (B28)
    P_q_perp double integral on the (z, k, k', mu') mesh, cl in uK^2."""
    del bg
    zs = np.sort(np.atleast_1d(np.asarray(zs, dtype=np.float64)))
    volumes = volume_gpc3 * np.ones_like(zs)
    ngals = ngal_mpc3 * np.ones_like(zs)

    if pksz_in is not None:
        pksz = pksz_in
    else:
        pksz = kSZ(zs, volumes, ngals, kL_max=k_max, num_kL_bins=num_k_bins,
                   kS_min=get_kmin(volume_gpc3), kS_max=k_max,
                   num_kS_bins=num_k_bins, num_mu_bins=num_mu_bins, ms=ms,
                   params=params, mass_function=mass_function, mdef=mdef,
                   nfw_numeric=nfw_numeric,
                   electron_profile_family=electron_profile_family,
                   electron_profile_nxs=electron_profile_nxs,
                   electron_profile_xmax=electron_profile_xmax,
                   skip_hod=True, device=device)

    ks = pksz.kS                      # (nk,)
    mus = pksz.mu                     # (nmu,)
    nk = ks.shape[0]
    sPee = pksz.get_power("e", name2="e")       # (nz, nk)
    Pmm = pksz.Pmms[:, 0, :]                    # (nz, nkL), kL grid == ks
    lks = torch.log(ks)

    def interp_k(rows, kq):
        """log-k linear interpolation of the (nz, nk) rows at kq (...),
        zero outside the k grid: (nz, ...)."""
        lkq = torch.log(torch.clamp(kq, min=1e-300))
        ik = torch.clamp(torch.searchsorted(lks, lkq.reshape(-1)) - 1,
                         0, nk - 2).reshape(kq.shape)
        t = (lkq - lks[ik]) / (lks[ik + 1] - lks[ik])
        v = rows[:, ik] * (1 - t) + rows[:, ik + 1] * t
        return torch.where((kq < ks[0]) | (kq > ks[-1]), 0.0, v)

    k = ks[:, None, None]             # the output k (nk, 1, 1)
    kp = ks[None, :, None]            # k' (1, nk, 1)
    mu_m = mus[None, None, :]         # mu' (1, 1, nmu)
    frac = (k * (k - 2.0 * kp * mu_m) * (1.0 - mu_m**2)
            / (kp**2 * (kp**2 + k**2 - 2.0 * k * kp * mu_m)))
    kmkp = torch.sqrt(kp**2 + k**2 - 2.0 * k * kp * mu_m)
    igr = (kp**2 * frac * interp_k(Pmm, (kp + 0.0 * mu_m)
                                   .expand(nk, nk, -1))
           * interp_k(sPee, kmkp))                     # (nz, nk, nk', nmu)
    igr = torch.where(torch.isfinite(igr), igr, 0.0)
    inner = trapz_traced(igr.movedim(2, -1), ks)       # (nz, nk, nmu)
    outer = trapz_traced(inner, mus)                   # (nz, nk)
    Pqperp = pksz.adotf[:, None] ** 2 * (2.0 * math.pi) ** (-2) * outer

    kfact = _ksz_kfact(pksz)
    cl = _limber_cl(pksz, pksz.zs, ks, Pqperp, ells,
                    lambda chi, z: 0.5 / (chi**2 / (1.0 + z) ** 4) * kfact)
    return pksz, cl


def _survey_bins(zs, dndz, zedges, fsky, Ngals, params, device="cuda"):
    """Bin geometry on the host: volumes, number densities and centers,
    with the volumes from this package's own background."""
    c = Cosmology(params=params, accuracy="low", device=device)
    zs = np.asarray(zs)
    dndz = np.asarray(dndz)
    tdndz = np.trapezoid(dndz, zs)
    vols_gpc3, ngals_mpc3, zcents = [], [], []
    for zmin, zmax in zip(zedges[:-1], zedges[1:]):
        zcent = (zmax + zmin) / 2.0
        chimin = float(c.comoving_radial_distance(zmin))
        chimax = float(c.comoving_radial_distance(zmax))
        vol = fsky * (4.0 / 3.0) * np.pi * (chimax**3 - chimin**3) / 1e9
        sel = np.logical_and(zs > zmin, zs <= zmax)
        fracz = np.trapezoid(dndz[sel], zs[sel]) / tdndz
        vols_gpc3.append(vol)
        ngals_mpc3.append(Ngals * fracz / (vol * 1e9))
        zcents.append(zcent)
    return vols_gpc3, ngals_mpc3, zcents


def get_ksz_snr_survey(zs, dndz, zedges, Cls, fsky, Ngals, bs=None,
                       sigz=None, params=None, device="cuda", **ksz_kwargs):
    """(vols_gpc3, ngals_mpc3, zcents, bgs, snrs, total snr) of a survey.

    Without photo-z scatter it runs the survey pipeline
    (``pipeline.make_ksz_survey_fn``: every bin in one vmapped call);
    with ``sigz``, or with a class-only option (such as nfw_numeric), it
    runs ``get_ksz_snr`` bin by bin.  Extra keywords take the class's
    names (ms, num_kS_bins, electron_profile_nxs, ...)."""
    nbins = len(zedges) - 1
    if bs is not None and len(bs) != nbins:
        raise ValueError("bs must have one bias per bin")
    vols_gpc3, ngals_mpc3, zcents = _survey_bins(zs, dndz, zedges, fsky,
                                                 Ngals, params, device)

    use_fused = sigz is None
    if use_fused:
        import inspect
        from ..pipeline import make_ksz_survey_fn
        p = merge_params(params)
        fused_kw = dict(ksz_kwargs)
        fused_kw["nxs"] = fused_kw.pop(
            "electron_profile_nxs",
            p["electron_density_profile_integral_numxs"])
        fused_kw["xmax"] = fused_kw.pop(
            "electron_profile_xmax",
            p["electron_density_profile_integral_xmax"])
        if "electron_profile_family" in fused_kw:
            fused_kw["family"] = fused_kw.pop("electron_profile_family")
        # the class-only options exist only on the per-bin path; device is
        # given to either path, so it is no reason to leave this one
        accepted = set(inspect.signature(make_ksz_survey_fn).parameters)
        use_fused = not (set(fused_kw) - accepted)

    if use_fused:
        fn = make_ksz_survey_fn(nbins, device=device, **fused_kw)
        tot, snrs, bgals = fn(params, np.asarray(zcents),
                              np.asarray(vols_gpc3), np.asarray(ngals_mpc3),
                              np.asarray(Cls, dtype=np.float64),
                              bs=None if bs is None else np.asarray(bs))
        snrs = snrs.cpu().numpy()
        return (vols_gpc3, ngals_mpc3, zcents,
                [float(b) for b in bgals.cpu().numpy()], snrs, float(tot))

    snrs, bgs = [], []
    for i in range(nbins):
        snr, fksz = get_ksz_snr(vols_gpc3[i], zcents[i], ngals_mpc3[i], Cls,
                                bs[i] if bs is not None else None,
                                params=params, sigz=sigz, device=device,
                                **ksz_kwargs)
        bgs.append(float(fksz.bgs[0]))
        snrs.append(float(snr))
    snrs = np.asarray(snrs)
    return vols_gpc3, ngals_mpc3, zcents, bgs, snrs, float(
        np.sqrt(np.sum(snrs**2)))
