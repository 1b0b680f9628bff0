"""kSZ velocity-reconstruction forecasting on float64 tensors: the free
functions of the pipelines (port of the first part of
hmvec_tpu/models/ksz.py).

The linear matter power at k < 0.1/Mpc drives the large-scale Pgv/Pvv/Pgg;
the halo model at k > 0.1/Mpc the small-scale Pge/Pgg.  ``Nvv_core_integral``
is the velocity reconstruction noise N_vv(mu, kL), one trapezoid over the
small-scale kS grid.

Not ported yet: ``get_survey_volume`` and the class ``kSZ`` with its
``get_ksz_*`` methods, which stand on the class API (Cosmology, HaloModel).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.quadrature import trapz
from ..params import default_params
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


def Nvv_core_integral(chi_star, Fstar, mu, kL, kSs, Cls, Pge, Pgg_tot,
                      Pgg_photo_tot=None, errs=False, robust_term=False,
                      photo=True):
    """Velocity reconstruction noise N_vv(mu, kL), shape (nmu, nkL).

    Pge and Pgg_tot are (nkS,) or broadcast as (..., nkS); the kS integral
    is one trapezoid on the kSs grid."""
    if robust_term and photo:
        photo = False

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


def pge_err_core(pgv_int, kstar, chistar, volume_gpc3, kss, ks_bin_edges,
                 pggtot, Cls):
    """Bandpower errors on Pge, one per bin of ``ks_bin_edges``: the
    trapezoid segments of each bin, masked per (bin, segment)."""
    volume = volume_gpc3 * 1e9
    kss = _tensor(kss)
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
