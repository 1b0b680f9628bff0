"""Cluster weak-lensing profiles on float64 tensors (port of
hmvec_tpu/models/cluster_lensing.py): the NFW surface density Sigma(R)
(Wright & Brainerd 2000), its miscentered average, kappa_1h, and the
2-halo kappa(theta) by a J0 Hankel sum over ell = k chi.
"""

from __future__ import annotations

import math

import torch

from ..ops.quadrature import trapz_traced
from ..ops.special import j0
from ..utils.weights import f64, leggauss_cached
from . import background as bgmod
from .mass_function import R_from_M
from .profiles import fcon


def sigma_nfw(R, rs, rhoscale):
    """NFW projected surface mass density Sigma(R), branchless in
    x = R / rs.  R: projected radius (Mpc), rs: scale radius, rhoscale:
    NFW density amplitude (Msun/Mpc^3)."""
    x = R / rs
    eps = 1e-9
    x = torch.where(torch.abs(x - 1.0) < eps, 1.0 + eps, x)
    lo = x < 1.0
    s = torch.where(lo, torch.sqrt(torch.abs(1.0 - x**2)),
                    torch.sqrt(torch.abs(x**2 - 1.0)))
    F = torch.where(lo, torch.atanh(torch.clamp(s, max=1.0 - 1e-15)) / s,
                    torch.atan(s) / s)
    f = (1.0 - F) / (x**2 - 1.0)
    return 2.0 * rs * rhoscale * f


def _gauss_legendre(n, device=None):
    """Gauss-Legendre nodes and weights on [-1, 1] as float64 tensors."""
    x, w = leggauss_cached(n)     # read-only arrays: copied
    return f64(x.copy(), device), f64(w.copy(), device)


def sigma_nfw_miscentered(R, rs, rhoscale, sig_off, n_off: int = 64,
                          n_ang: int = 128, off_max_sigmas: float = 5.0):
    """Miscentered NFW Sigma(R) under Rayleigh-distributed centering
    offsets (Johnston et al 2007):

        Sigma_off(R) = int dRoff P(Roff) <Sigma(|R - Roff|)>_angle,
        P(Roff) = Roff / sig^2 exp(-Roff^2 / 2 sig^2),

    both integrals fixed Gauss-Legendre sums (offsets on (0, 5 sig], angles
    on [0, pi]).  R: (..., ntheta); rs, rhoscale: broadcastable; sig_off:
    (...,) in R's units."""
    dev = R.device
    xo, wo = _gauss_legendre(n_off, dev)
    xa, wa = _gauss_legendre(n_ang, dev)
    sig = f64(sig_off, dev)[..., None]
    roff = (xo + 1.0) / 2.0 * off_max_sigmas * sig[..., None]   # (...,1,no)
    wroff = wo * off_max_sigmas * sig[..., None] / 2.0
    prayl = roff / sig[..., None] ** 2 * torch.exp(
        -(roff**2) / (2.0 * sig[..., None] ** 2))
    ang = (xa + 1.0) / 2.0 * math.pi                             # (na,)
    wang = wa / 2.0                                              # sums to 1
    Rb = R[..., None, None]                                      # (...,nt,1,1)
    ro = roff[..., None]                                         # (...,1,no,1)
    arg = torch.sqrt(torch.clamp(
        Rb**2 + ro**2 - 2.0 * Rb * ro * torch.cos(ang), min=1e-30))
    sig_c = sigma_nfw(arg, rs[..., None, None], rhoscale[..., None, None])
    sig_ang = (sig_c * wang).sum(-1)                             # (...,nt,no)
    return (sig_ang * prayl * wroff).sum(-1)


def sigma_1h_profiles(bg, zs, thetas, Ms, concs, sig_theta=None, delta=200,
                      rho="mean", rho_at_z=True, n_off: int = 64,
                      n_ang: int = 128):
    """1-halo Sigma(theta) per z, (nz, ntheta).  ``sig_theta``: the
    Gaussian miscentering scale in radians, turned into a physical offset
    by the angular-diameter distance."""
    dev = bg.H0.device
    zs = f64(zs, dev)
    Ms = f64(Ms, dev)
    concs = f64(concs, dev)
    chis = bgmod.angular_diameter_distance(bg, zs)
    rbins = chis[:, None] * f64(thetas, dev)[None, :]
    rhofunc = (bgmod.rho_critical_z if rho == "critical"
               else bgmod.rho_matter_z)
    rhoz = zs if rho_at_z else zs * 0.0
    Rdeltas = R_from_M(Ms, rhofunc(bg, rhoz), delta=delta)
    rs = Rdeltas / concs
    rhocrits = bgmod.rho_critical_z(bg, zs)
    delta_c = Ms / 4.0 / math.pi / rs**3 / rhocrits / fcon(concs)
    if sig_theta is None:
        return sigma_nfw(rbins, rs[:, None], delta_c[:, None])
    offsets = chis * sig_theta                                 # (nz,)
    return sigma_nfw_miscentered(rbins, rs[:, None], delta_c[:, None],
                                 offsets, n_off=n_off, n_ang=n_ang)


def kappa_1h_profiles(bg, zs, thetas, Ms, concs, zsource, **kw):
    """kappa_1h = Sigma / Sigma_crit, (nz, ntheta)."""
    sigma = sigma_1h_profiles(bg, zs, thetas, Ms, concs, **kw)
    sigmac = bgmod.sigma_crit(bg, f64(zs, bg.H0.device),
                              f64(zsource, bg.H0.device))
    return sigma / sigmac[:, None]


def kappa_2h_profiles(bg, zs, ks, Pzk, bh_of_m, thetas, zsource,
                      lmin=100, lmax=10000):
    """2-halo kappa(theta) per z, (ntheta, nz): a J0 Hankel sum over
    ell = k chi, the trapezoid over the ells inside (lmin, lmax) of each z,
    as one (ntheta, nz, nk) computation.  bh_of_m: (nz,) halo bias at the
    cluster mass."""
    dev = bg.H0.device
    zs = f64(zs, dev)
    sigmac = bgmod.sigma_crit(bg, zs, f64(zsource, dev))
    rhomz = bgmod.rho_matter_z(bg, zs)
    chis = bgmod.comoving_radial_distance(bg, zs)
    DAz = bgmod.angular_diameter_distance(bg, zs)
    ells = f64(ks, dev)[None, :] * chis[:, None]        # (nz, nk)
    mask = (ells > lmin) & (ells < lmax)
    thetas = f64(thetas, dev)[:, None, None]
    integrand = (rhomz[:, None] * bh_of_m[:, None] * Pzk
                 / (1.0 + zs[:, None]) ** 3 / sigmac[:, None]
                 / DAz[:, None] ** 2 * j0(ells * thetas) * ells
                 / (2.0 * math.pi))
    integrand = torch.where(mask, integrand, 0.0)
    return trapz_traced(integrand, ells)
