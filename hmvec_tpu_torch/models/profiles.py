"""Halo profiles on float64 tensors: Duffy concentration, r_vir, the
analytic NFW u(k) and the Battaglia gas density (port of
hmvec_tpu/models/profiles.py; the pressure profile is not ported yet).

``nfw_uk_x`` is also the plain PyTorch version of the CUDA NFW kernels
(ops/nfw_kernels.py), which compute the same function.
"""

from __future__ import annotations

import torch

from ..ops.special import sici_with_trig
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


def fcon(c):
    """F(c) = ln(1+c) - c/(1+c)."""
    return torch.log(1.0 + c) - c / (1.0 + c)


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
