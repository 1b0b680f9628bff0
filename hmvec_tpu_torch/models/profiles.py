"""Halo profiles on float64 tensors (port of hmvec_tpu/models/profiles.py):
the Duffy and Bhattacharya concentrations, r_vir, the NFW and Einasto
densities, the analytic NFW u(k) with and without lognormal concentration
scatter, and the Battaglia 2016 gas density and electron pressure with the
reference-signature free functions.  The JAX package's ``_*_f32``
polynomial forms replace the TPU's float32 exp/log and are not ported.

``nfw_uk_x`` is also the plain PyTorch version of the CUDA NFW kernels
(ops/nfw_kernels.py), which compute the same function.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.special import sici_with_trig
from ..utils.weights import on_device_of_inputs, tensor_or_f64
from .mass_function import R_from_M, deltav_bryan_norman


def duffy_concentration(m, z, A, alpha, beta, h):
    """Duffy et al 2008 c(m, z)."""
    return A * (h * m / 2.0e12) ** alpha * (1.0 + z) ** beta


def concentration_duffy(ms, zs, mdef, params, h):
    """c(z, m) grid, shape (nz, nm), for the 'vir' or 'mean' mass definition."""
    key = {"mean": ("duffy_A_mean", "duffy_alpha_mean", "duffy_beta_mean"),
           "vir": ("duffy_A_vir", "duffy_alpha_vir", "duffy_beta_vir")}[mdef]
    A, alpha, beta = (params[key[0]], params[key[1]], params[key[2]])
    return duffy_concentration(ms[None, :], zs[:, None], A, alpha, beta, h)


# Bhattacharya et al 2013 c = A D(z)^B nu^C, D normalized to D(0) = 1
_BHATTACHARYA_COEFFS = {
    "vir": (7.7, 0.90, -0.29),
    "mean": (9.0, 1.15, -0.29),
    "200c": (5.9, 0.54, -0.35),
}


@on_device_of_inputs
def concentration_bhattacharya(sigma2, d_z0norm, mdef, deltac=1.686):
    """Bhattacharya+13 c(z, m) from sigma^2 (nz, nm) and D(z)/D(0) (nz,)."""
    A, B, C = _BHATTACHARYA_COEFFS[mdef]
    sigma2 = tensor_or_f64(sigma2)
    nu = deltac / torch.sqrt(sigma2)
    d = torch.as_tensor(d_z0norm, dtype=torch.float64, device=sigma2.device)
    return A * d[:, None] ** B * nu**C


@on_device_of_inputs
def fcon(c):
    """F(c) = ln(1+c) - c/(1+c)."""
    if not isinstance(c, torch.Tensor):
        c = torch.as_tensor(c, dtype=torch.float64)
    return torch.log(1.0 + c) - c / (1.0 + c)


def rho_nfw_x(x, rhoscale=1.0):
    return rhoscale / x / (1.0 + x) ** 2


@on_device_of_inputs
def rho_einasto_x(x, alpha=0.18, rhoscale=1.0):
    """Einasto rho(x) / rho_s = exp(-(2/alpha)(x^alpha - 1)), x = r / r_s."""
    x = torch.as_tensor(x, dtype=torch.float64)
    return rhoscale * torch.exp(-(2.0 / alpha) * (x**alpha - 1.0))


@on_device_of_inputs
def rho_nfw(r, rhoscale, rs):
    """NFW density at radius r."""
    return rho_nfw_x(torch.as_tensor(r, dtype=torch.float64) / rs, rhoscale)


@on_device_of_inputs
def rhoscale_nfw(mdelta, rdelta, cdelta):
    mdelta, rdelta, cdelta = map(tensor_or_f64, (mdelta, rdelta, cdelta))
    rs = rdelta / cdelta
    return mdelta / (4.0 * math.pi * rs**3) / fcon(cdelta)


def rvir_grid(ms, zs, mdef, rhocritz, rhomz, omz):
    """r_vir(z, m) for 'vir' / 'mean'.  ms: (nm,), z-arrays: (nz,)."""
    del zs
    ms = ms[None, :]
    if mdef == "vir":
        return R_from_M(ms, rhocritz[:, None], deltav_bryan_norman(omz)[:, None])
    if mdef == "mean":
        return R_from_M(ms, rhomz[:, None], 200.0)
    raise ValueError(mdef)


def nfw_uk_x(x, cs):
    """Truncated-NFW u as a function of x = k r_s (comoving) and c:

        u = [sin x (Si((1+c)x) - Si(x)) - sin(cx)/((1+c)x)
             + cos x (Ci((1+c)x) - Ci(x))] / F(c).

    One sincos at x and one at (1+c)x, shared with the Si/Ci auxiliaries;
    sin(cx) comes from the angle-difference identity."""
    x2 = (1.0 + cs) * x
    sx, cx = torch.sin(x), torch.cos(x)
    sx2, cx2 = torch.sin(x2), torch.cos(x2)
    si, ci = sici_with_trig(x, sx, cx)
    sic, cic = sici_with_trig(x2, sx2, cx2)
    sin_cx = sx2 * cx - cx2 * sx  # sin(cx) = sin((1+c)x - x)
    mc = fcon(cs)
    return (sx * (sic - si) - sin_cx / x2 + cx * (cic - ci)) / mc


def nfw_uk_analytic(ks, zs, cs, rss):
    """Normalized NFW u(k | z, m), shape (nz, nm, nk), with
    x = k r_s (1+z): the (1+z) turns the physical scale radius comoving.

    ks: (nk,), zs: (nz,), cs and rss: (nz, nm)."""
    x = ks[None, None, :] * rss[..., None] * (1.0 + zs)[:, None, None]
    return nfw_uk_x(x, cs[..., None])


def nfw_uk_scatter(ks, zs, cs, rvirs, sigma_lnc, n_nodes=9):
    """(<u>, <u^2>) of the NFW profile under lognormal concentration
    scatter sigma_lnc at fixed mass and r_vir, by n_nodes-point
    Gauss-Hermite quadrature in ln c (r_s,i = r_vir / c_i)."""
    xs_n, ws_n = np.polynomial.hermite.hermgauss(int(n_nodes))
    ws_n = ws_n / np.sqrt(np.pi)
    sig = torch.as_tensor(sigma_lnc, dtype=torch.float64, device=cs.device)
    um, u2 = 0.0, 0.0
    for xi, wi in zip(xs_n, ws_n):
        ci = cs * torch.exp(np.sqrt(2.0) * xi * sig)
        ui = nfw_uk_analytic(ks, zs, ci, rvirs / ci)
        um = um + wi * ui
        u2 = u2 + wi * ui * ui
    return um, u2


def battaglia_fit(m200critz, z, A0, alpham, alphaz):
    """Battaglia mass/redshift power-law fit parameter."""
    return A0 * (m200critz / 1.0e14) ** alpham * (1.0 + z) ** alphaz


def rho_gas_x(x, m200critz, z, omb, omm, rhocritz, gamma, fit_params):
    """Battaglia 2016 gas density profile in x = r / (R200/2), with the
    sign flip on the second gamma (a typo of the paper) that the reference
    carries.

    The powers with (z, m)-dependent exponents are exp(e ln x), with ln x
    taken once on the sample axis.  The result has x's dtype.  For float32
    samples the exponent is formed and exponentiated in float64 and only
    the samples are rounded to float32: a float32 exponent of magnitude up
    to ~80 would cost ~1e-5 relative.  (The JAX package's float32 branch
    replaces the TPU's inaccurate float32 exp/log with polynomials; the
    card's float64 needs none of that.)
    """
    rho0 = battaglia_fit(m200critz, z, fit_params["rho0_A0"],
                         fit_params["rho0_alpham"], fit_params["rho0_alphaz"])
    alpha = battaglia_fit(m200critz, z, fit_params["alpha_A0"],
                          fit_params["alpha_alpham"], fit_params["alpha_alphaz"])
    beta = battaglia_fit(m200critz, z, fit_params["beta_A0"],
                         fit_params["beta_alpham"], fit_params["beta_alphaz"])
    pref = (omb / omm) * rhocritz * rho0
    expo = -(beta + gamma) / alpha
    if x.dtype == torch.float32:
        lnx = torch.log(x.to(torch.float64))
        g = gamma * lnx + expo * torch.log1p(torch.exp(alpha * lnx))
        return (pref * torch.exp(g)).to(torch.float32)
    lnx = torch.log(x)
    xgamma = torch.exp(gamma * lnx)
    xalpha = torch.exp(alpha * lnx)
    outer = torch.exp(expo * torch.log1p(xalpha))
    return pref * xgamma * outer


def pressure_x(x, m200critz, r200critz, z, omb, omm, rhocritz,
               alpha, gamma, fit_params,
               parsec_m=3.08567758e16, msun_kg=1.989e30, G_SI=6.67430e-11):
    """Battaglia 2016 electron pressure profile P_e(x), x = r / R200, with
    the XH = 0.76 electron fraction; G_SI is CODATA's, as the reference's
    profile takes it.  The result has x's dtype; for float32 samples the
    shape is formed in float64 and rounded once, as in ``rho_gas_x``."""
    P0 = battaglia_fit(m200critz, z, fit_params["P0_A0"],
                       fit_params["P0_alpham"], fit_params["P0_alphaz"])
    xc = battaglia_fit(m200critz, z, fit_params["xc_A0"],
                       fit_params["xc_alpham"], fit_params["xc_alphaz"])
    beta = battaglia_fit(m200critz, z, fit_params["beta_A0"],
                         fit_params["beta_alpham"], fit_params["beta_alphaz"])
    XH = 0.76
    eFrac = 2.0 * (XH + 1.0) / (5.0 * XH + 3.0)
    G_newt = G_SI / (parsec_m * 1e6) ** 3 * msun_kg
    pref = (eFrac * (omb / omm) * 200.0 * m200critz * G_newt * rhocritz
            / (2.0 * r200critz) * P0)
    x = torch.as_tensor(x)
    lnxxc = torch.log(x.to(torch.float64)) - torch.log(xc)
    shape = torch.exp(gamma * lnxxc
                      - beta * torch.log1p(torch.exp(alpha * lnxxc)))
    return (pref * shape).to(x.dtype)


# reference-signature free functions: fit parameters default from
# battaglia_defaults[family] and are overridden by keyword
Fcon = fcon
battaglia_gas_fit = battaglia_fit


def _gas_fit_params(family, over):
    from ..params import battaglia_defaults
    fp = dict(battaglia_defaults[family])
    fp.update({k: v for k, v in over.items() if v is not None})
    return fp


@on_device_of_inputs
def rho_gas_generic_x(x, m200critz, z, omb, omm, rhocritz, gamma=-0.2,
                      family="AGN", **fit_kwargs):
    """Battaglia-16 gas density at x = 2r / R200c."""
    x, m200critz, z, rhocritz = map(tensor_or_f64, (x, m200critz, z,
                                                    rhocritz))
    return rho_gas_x(x, m200critz, z, omb, omm, rhocritz, gamma,
                     _gas_fit_params(family, fit_kwargs))


@on_device_of_inputs
def rho_gas_generic(r, m200critz, z, omb, omm, rhocritz, gamma=-0.2,
                    family="AGN", **fit_kwargs):
    """Battaglia-16 gas density at physical r."""
    R200 = R_from_M(m200critz, rhocritz, delta=200)
    return rho_gas_generic_x(2.0 * r / R200, m200critz, z, omb, omm,
                             rhocritz, gamma, family, **fit_kwargs)


@on_device_of_inputs
def rho_gas(r, m200critz, z, omb, omm, rhocritz, gamma=-0.2,
            profile="AGN"):
    """AGN / SH Battaglia-16 gas density rho(r)."""
    return rho_gas_generic(r, m200critz, z, omb, omm, rhocritz, gamma,
                           family=profile)


@on_device_of_inputs
def P_e_generic_x(x, m200critz, R200critz, z, omb, omm, rhocritz,
                  alpha=1.0, gamma=-0.3, family="pres", **fit_kwargs):
    """Battaglia-16 electron pressure at x = r / R200c."""
    x, m200critz, R200critz, z, rhocritz = map(
        tensor_or_f64, (x, m200critz, R200critz, z, rhocritz))
    return pressure_x(x, m200critz, R200critz, z, omb, omm, rhocritz,
                      alpha, gamma, _gas_fit_params(family, fit_kwargs))


@on_device_of_inputs
def P_e_generic(r, m200critz, z, omb, omm, rhocritz, alpha=1.0,
                gamma=-0.3, family="pres", **fit_kwargs):
    """Battaglia-16 electron pressure at physical r."""
    R200 = R_from_M(m200critz, rhocritz, delta=200)
    return P_e_generic_x(r / R200, m200critz, R200, z, omb, omm, rhocritz,
                         alpha, gamma, family, **fit_kwargs)


@on_device_of_inputs
def P_e(r, m200critz, z, omb, omm, rhocritz, alpha=1.0, gamma=-0.3,
        profile="pres"):
    """Battaglia-16 electron pressure P_e(r)."""
    return P_e_generic(r, m200critz, z, omb, omm, rhocritz, alpha, gamma,
                       family=profile)
