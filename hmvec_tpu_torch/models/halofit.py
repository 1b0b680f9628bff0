"""Halofit nonlinear matter power on float64 tensors (port of
hmvec_tpu/models/halofit.py): the CAMB ``halofit_version`` family
'takahashi', 'original' (Smith et al 2003), 'bird', 'peacock' and
'casarini' ('mead*' is models/hmcode.py).

The nonlinear scale is a 60-step bisection of the Gaussian-window variance
sigma^2(R) = 1 in ln R; the spectral moments (sigma^2, n_eff, curvature)
are weighted reductions on a static ln-k grid of 1,536 points.  Casarini's
equivalent constant w per redshift is a second 60-step bisection on a
1,024-point grid.  Both run a fixed count of ``torch.where`` steps on the
device, with no host read.  The fitted coefficients are the JAX package's
(its docstring gives their sources).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.weights import on_device, trapz_weights
from . import background as bgmod

# static ln-k grid for the Gaussian-window spectral moments
_KG = np.geomspace(1e-4, 1e3, 1536)
_LNW = trapz_weights(np.log(_KG))


def _grid_on(device):
    """(_KG, _LNW) as float64 tensors on ``device``."""
    return on_device("halofit", device, lambda: (_KG, _LNW))


def _moments(delta2_lin_g, R):
    """sigma^2_G(R) and its first two ln R derivatives (closed forms).

    delta2_lin_g: (nz, nkg) dimensionless linear power on the static grid;
    R: (nz,).  Returns (sig2, dlns_dlnR, d2lns_dlnR2), each (nz,)."""
    kg, w = _grid_on(delta2_lin_g.device)
    x2 = (kg[None, :] * R[:, None]) ** 2
    e = torch.exp(-x2)
    s2 = (delta2_lin_g * e) @ w
    d1 = (delta2_lin_g * e * (-2.0 * x2)) @ w
    d2 = (delta2_lin_g * e * (4.0 * x2**2 - 4.0 * x2)) @ w
    dln1 = d1 / s2
    dln2 = d2 / s2 - dln1**2
    return s2, dln1, dln2


def _coeffs_takahashi(n, C, omz, omde_w, omde):
    """Takahashi 2012 Eqs (A6-A13)."""
    del omde
    log10_an = (1.5222 + 2.8553 * n + 2.3706 * n**2 + 0.9903 * n**3
                + 0.2250 * n**4 - 0.6038 * C + 0.1749 * omde_w)
    log10_bn = (-0.5642 + 0.5864 * n + 0.5716 * n**2 - 1.5474 * C
                + 0.2279 * omde_w)
    log10_cn = 0.3698 + 2.0404 * n + 0.8161 * n**2 + 0.5869 * C
    gamma_n = 0.1971 - 0.0843 * n + 0.8460 * C
    alpha_n = torch.abs(6.0835 + 1.3373 * n - 0.1959 * n**2 - 5.5274 * C)
    beta_n = (2.0379 - 0.7354 * n + 0.3157 * n**2 + 1.2490 * n**3
              + 0.3980 * n**4 - 0.1682 * C)
    mu_n = torch.zeros_like(n)
    nu_n = 10.0 ** (5.2105 + 3.6902 * n)
    f1 = omz**-0.0307
    f2 = omz**-0.0585
    f3 = omz**0.0743
    return (10.0**log10_an, 10.0**log10_bn, 10.0**log10_cn, gamma_n,
            alpha_n, beta_n, mu_n, nu_n, f1, f2, f3)


def _coeffs_original(n, C, omz, omde_w, omde):
    """Smith et al 2003 App C (C9-C16), with the CAMB-style blend of the
    flat-Lambda and open f_i(Omega) fits by the dark-energy share
    frac = Omega_de / (1 - Omega_m)."""
    del omde_w
    an = 10.0 ** (1.4861 + 1.8369 * n + 1.6762 * n**2 + 0.7940 * n**3
                  + 0.1670 * n**4 - 0.6206 * C)
    bn = 10.0 ** (0.9463 + 0.9466 * n + 0.3084 * n**2 - 0.9400 * C)
    cn = 10.0 ** (-0.2807 + 0.6669 * n + 0.3214 * n**2 - 0.0793 * C)
    gamma_n = 0.8649 + 0.2989 * n + 0.1631 * C
    alpha_n = 1.3884 + 0.3700 * n - 0.1452 * n**2
    beta_n = 0.8291 + 0.9854 * n + 0.3401 * n**2
    mu_n = 10.0 ** (-3.5442 + 0.1908 * n)
    nu_n = 10.0 ** (0.9589 + 1.2857 * n)
    frac = omde / torch.clamp(1.0 - omz, min=1e-8)
    f1 = frac * omz**-0.0307 + (1.0 - frac) * omz**-0.0732
    f2 = frac * omz**-0.0585 + (1.0 - frac) * omz**-0.1423
    f3 = frac * omz**0.0743 + (1.0 - frac) * omz**0.0725
    return an, bn, cn, gamma_n, alpha_n, beta_n, mu_n, nu_n, f1, f2, f3


def _coeffs_bird(n, C, omz, omde_w, omde):
    """Bird et al 2012 (App A): the Smith-2003 fit with the refitted
    gamma_n of their Eq (A3); the massive-neutrino terms are applied in
    ``halofit_nonlinear``."""
    (an, bn, cn, gamma_n, alpha_n, beta_n, mu_n, nu_n,
     f1, f2, f3) = _coeffs_original(n, C, omz, omde_w, omde)
    gamma_n = gamma_n + (0.3159 - 0.0765 * n - 0.8350 * C)
    return an, bn, cn, gamma_n, alpha_n, beta_n, mu_n, nu_n, f1, f2, f3


_COEFFS = {"takahashi": _coeffs_takahashi, "original": _coeffs_original,
           "bird": _coeffs_bird, "peacock": _coeffs_original}

# quasi-linear massive-neutrino boost coefficient (CAMB convention):
# plin -> plin (1 + c f_nu k_h^2 / (1 + 1.5 k_h^2)) inside the quasi-linear
# term only; the whole Smith-2003 branch carries the Bird value
_FNU_QL = {"takahashi": 26.3, "bird": 47.48, "original": 47.48,
           "peacock": 47.48}


def halofit_nonlinear(plin_fn, zs, ks, omz, omde_w, num_iter: int = 60,
                      version: str = "takahashi", omde=None,
                      fnu=0.0, omm0=None, h: float = 1.0):
    """Nonlinear P(k, z) (nz, nk) from a callable plin_fn(ks) -> (nz, nk).

    omz: Omega_m(z) (nz,); omde_w: Omega_de(z) (1 + w) (nz,); omde:
    Omega_de(z) (nz,), which 'original' needs (1 - omz when None); fnu:
    Omega_nu / Omega_m today; omm0: total Omega_m today (the Smith
    branch's one-halo neutrino factor); h: H0/100 (the neutrino and
    Peacock factors are fits in k [h/Mpc], ks is in 1/Mpc)."""
    if version not in _COEFFS:
        raise ValueError(
            f"halofit version {version!r}: supported here are "
            f"{sorted(_COEFFS)} + 'casarini' via halofit_power "
            f"(plus 'mead'/'mead2015'/'mead2020'/'mead2020_feedback' "
            f"via models/hmcode.py)")
    zs = torch.atleast_1d(zs)
    kg, _ = _grid_on(zs.device)

    plin_g = plin_fn(kg)                                # (nz, nkg)
    delta2_g = plin_g * kg[None, :] ** 3 / (2.0 * math.pi**2)

    # sigma^2_G(R) = 1 by bisection in ln R (sigma^2 decreases with R)
    lo = torch.full((zs.numel(),), math.log(1e-4), dtype=torch.float64,
                    device=zs.device)
    hi = torch.full_like(lo, math.log(1e3))
    for _ in range(num_iter):
        mid = (lo + hi) / 2.0
        s2, _, _ = _moments(delta2_g, torch.exp(mid))
        go_right = s2 > 1.0
        lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid)
    Rsig = torch.exp((lo + hi) / 2.0)
    ksig = 1.0 / Rsig

    _, dln1, dln2 = _moments(delta2_g, Rsig)
    neff = -3.0 - dln1
    C = -dln2

    if omde is None:
        omde = 1.0 - omz
    (an, bn, cn, gamma_n, alpha_n, beta_n, mu_n, nu_n,
     f1, f2, f3) = _COEFFS[version](neff, C, omz, omde_w, omde)

    kh = ks / h
    if version == "takahashi":
        beta_n = beta_n + fnu * (1.081 + 0.395 * neff**2)
    else:
        beta_n = beta_n + fnu * (-6.4868 + 1.4373 * neff**2)

    plin = plin_fn(ks)                                  # (nz, nk)
    delta2_lin = plin * ks[None, :] ** 3 / (2.0 * math.pi**2)
    y = ks[None, :] / ksig[:, None]
    fy = y / 4.0 + y**2 / 8.0

    def c1(v):
        return v[:, None]

    d2_ql = delta2_lin
    if version in _FNU_QL:
        d2_ql = delta2_lin * (1.0 + fnu * _FNU_QL[version] * kh[None, :]**2
                              / (1.0 + 1.5 * kh[None, :]**2))
    delta2_q = (delta2_lin * ((1.0 + d2_ql) ** c1(beta_n)
                              / (1.0 + c1(alpha_n) * d2_ql))
                * torch.exp(-fy))
    delta2_hp = (c1(an) * y ** (3.0 * c1(f1))
                 / (1.0 + c1(bn) * y ** c1(f2)
                    + (c1(cn) * c1(f3) * y) ** (3.0 - c1(gamma_n))))
    delta2_h = delta2_hp / (1.0 + c1(mu_n) / y + c1(nu_n) / y**2)
    if version == "takahashi":
        delta2_h = delta2_h * (1.0 + 0.977 * fnu)
    elif omm0 is not None:
        delta2_h = delta2_h * (1.0 + fnu * (0.977 - 18.015 * (omm0 - 0.3)))
    elif not (isinstance(fnu, (int, float)) and fnu == 0.0):
        raise ValueError(
            "halofit Smith-branch versions need omm0 (total Omega_m "
            "today) for the massive-neutrino one-halo factor when "
            "fnu != 0; pass omm0= (halofit_power does this "
            "automatically)")

    delta2_nl = delta2_q + delta2_h
    pnl = delta2_nl * (2.0 * math.pi**2) / ks[None, :] ** 3

    if version == "peacock":
        # nonlinear excess scaled by (1 + 2y^2)/(1 + y^2), y = k_h/10
        yp = (kh / 10.0)[None, :]
        pnl = plin + (pnl - plin) * (1.0 + 2.0 * yp**2) / (1.0 + yp**2)
    return pnl


def casarini_weff(bg, zs, z_dec: float = 1100.0, nq: int = 1024,
                  num_iter: int = 60):
    """Equivalent constant w per redshift (Casarini et al PKequal): the
    constant-w model, with the same densities, whose comoving distance
    from z to decoupling matches the (w0, wa) model's.  Both distances
    share one trapezoid grid of nq points in ln(1+z'); the match is a
    fixed-count bisection in w on [-10, -0.01].  Exactly w0 when wa = 0.
    Returns (nz,)."""
    from ..pipeline import _linspace

    zs = torch.atleast_1d(torch.as_tensor(zs, dtype=torch.float64,
                                          device=bg.H0.device))
    dev = zs.device
    t = _linspace(torch.zeros((), dtype=torch.float64, device=dev),
                  torch.ones((), dtype=torch.float64, device=dev), nq)
    la0 = torch.log1p(zs)[:, None]                      # (nz, 1)
    dla = math.log(1.0 + z_dec) - la0                   # (nz, 1)
    la = la0 + dla * t[None, :]                         # (nz, nq)
    zp1 = torch.exp(la)
    ends = torch.ones(nq, dtype=torch.float64, device=dev)
    ends[0] = ends[-1] = 0.5
    wq = ends[None, :] * (dla / (nq - 1.0))             # (nz, nq)
    base = (bg.omr0 * zp1**4 + (bg.omm0 + bg.omnu0) * zp1**3
            + bg.omk0 * zp1**2)
    de_dyn = bg.oml0 * zp1 ** (3.0 * (1.0 + bg.w0 + bg.wa)) * torch.exp(
        -3.0 * bg.wa * (1.0 - 1.0 / zp1))
    target = torch.sum(wq * zp1 / torch.sqrt(base + de_dyn), dim=1)

    def dist(w):                                        # w: (nz,)
        de = bg.oml0 * zp1 ** (3.0 * (1.0 + w[:, None]))
        return torch.sum(wq * zp1 / torch.sqrt(base + de), dim=1)

    # the distance decreases with w
    lo = torch.full((zs.numel(),), -10.0, dtype=torch.float64, device=dev)
    hi = torch.full_like(lo, -0.01)
    for _ in range(num_iter):
        mid = (lo + hi) / 2.0
        too_neg = dist(mid) > target
        lo, hi = torch.where(too_neg, mid, lo), torch.where(too_neg, hi, mid)
    return (lo + hi) / 2.0


def halofit_power(cosmo, zs, ks, version: str = "takahashi"):
    """Nonlinear P(k, z) for a Cosmology instance (the engine-free path of
    ``HaloModel(halofit=...)``).  Versions: 'takahashi', 'original',
    'bird', 'peacock', 'casarini'.  Under ``growth="ode"`` both linear
    power calls read one growth table."""
    bg = cosmo.bg
    zs = torch.atleast_1d(cosmo._t(zs))
    ks = cosmo._t(ks)
    gm = cosmo.growth_mode
    gtab = bgmod.growth_table(bg) if gm == "ode" else None

    def plin_fn(kq):
        kw = {} if gtab is None else {"growth_table": gtab}
        return cosmo.engine.plin(bg, zs, kq, accuracy=cosmo.accuracy,
                                 growth_mode=gm, **kw)

    omz = bgmod.omz(bg, zs)
    # Omega_de(z) (1 + w(z)) with the w0-wa parametrization
    e2 = bgmod.e_of_z(bg, zs) ** 2
    zp1 = 1.0 + zs
    de = zp1 ** (3.0 * (1.0 + bg.w0 + bg.wa)) * torch.exp(
        -3.0 * bg.wa * (1.0 - 1.0 / zp1))
    omde = bg.oml0 * de / e2
    if version == "casarini":
        # takahashi in the per-z equivalent constant-w model: only the
        # (1 + w) factor of the fitted coefficients changes
        wz = casarini_weff(bg, zs)
        version = "takahashi"
    else:
        wz = bg.w0 + bg.wa * (1.0 - 1.0 / zp1)
    omm0_tot = bg.omm0 + bg.omnu0
    fnu = bg.omnu0 / omm0_tot
    return halofit_nonlinear(plin_fn, zs, ks, omz, omde * (1.0 + wz),
                             version=version, omde=omde, fnu=fnu,
                             omm0=omm0_tot, h=bg.H0 / 100.0)
