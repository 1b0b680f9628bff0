"""Redshift-space distortions and pairwise velocities in linear theory on
float64 tensors (port of hmvec_tpu/models/rsd.py): the Kaiser anisotropic
power with Finger-of-God damping and its Legendre multipoles by fixed
Gauss-Legendre quadrature over mu, the correlation multipoles xi_ell(s)
by FFTLog, the linear velocity dispersion, the Scoccimarro-2004 spectrum
and its multipoles, and the mean pairwise velocity v12(r).

The tensor among the inputs (the power spectrum) decides the device; the
mu nodes and weights go there once per node count.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.fftlog import correlation_function, fftlog_lnkr, fftlog_sphbessel_jl
from ..ops.quadrature import trapz_traced
from ..utils.weights import (f64, leggauss_cached, on_device,
                             on_device_of_inputs)

_F64 = torch.float64


def _mu_nodes(n_mu, dev):
    """Gauss-Legendre nodes and weights on [-1, 1], on ``dev`` once."""
    return on_device(f"rsd_leggauss:{int(n_mu)}", dev,
                     lambda: leggauss_cached(n_mu))


def _fog(kmu, sigma_v, fog):
    x2 = (kmu * sigma_v) ** 2
    if fog == "gaussian":
        return torch.exp(-x2)
    if fog == "lorentzian":
        return 1.0 / (1.0 + x2 / 2.0)
    raise ValueError(fog)


@on_device_of_inputs
def kaiser_pk_mu(ks, mus, pk, b, f, sigma_v=0.0, fog="gaussian"):
    """P_s(k, mu) = (b + f mu^2)^2 P(k) D_FoG(k mu sigma_v), with D_FoG
    'gaussian' exp(-x^2) or 'lorentzian' 1/(1 + x^2/2).

    ks (nk,), mus (nmu,), pk (..., nk); b, f, sigma_v scalars or
    (...)-shaped.  Returns (..., nmu, nk)."""
    pk = torch.as_tensor(pk, dtype=_F64)
    dev = pk.device
    ks, mus = f64(ks, dev), f64(mus, dev)
    pk = pk[..., None, :]
    b = f64(b, dev)[..., None, None]
    f = f64(f, dev)[..., None, None]
    sigma_v = f64(sigma_v, dev)[..., None, None]
    kmu = ks[None, :] * mus[:, None]
    kaiser = (b + f * mus[:, None] ** 2) ** 2
    x2 = (kmu * sigma_v) ** 2
    if fog == "gaussian":
        damp = torch.exp(-x2)
    elif fog == "lorentzian":
        damp = 1.0 / (1.0 + x2 / 2.0)
    else:
        raise ValueError(fog)
    return kaiser * damp * pk


def _legendre(ell, x):
    if ell == 0:
        return torch.ones_like(x)
    if ell == 2:
        return 0.5 * (3.0 * x**2 - 1.0)
    if ell == 4:
        return (35.0 * x**4 - 30.0 * x**2 + 3.0) / 8.0
    raise ValueError(ell)


def _project(ps, mus, w, ells):
    """{ell: (2 ell + 1)/2 sum_mu w L_ell(mu) P_s(..., mu, k)}."""
    out = {}
    for ell in ells:
        wl = w * _legendre(ell, mus) * (2.0 * ell + 1.0) / 2.0
        out[ell] = torch.einsum("m,...mk->...k", wl, ps)
    return out


@on_device_of_inputs
def rsd_multipoles(ks, pk, b, f, sigma_v=0.0, ells=(0, 2, 4),
                   fog="gaussian", n_mu=32):
    """Legendre multipoles P_ell(k) = (2ell+1)/2 int_-1^1 P_s L_ell dmu of
    the Kaiser spectrum by n_mu-node Gauss-Legendre (exact at
    sigma_v = 0).  Returns {ell: (..., nk)}."""
    pk = torch.as_tensor(pk, dtype=_F64)
    mus, w = _mu_nodes(n_mu, pk.device)
    ps = kaiser_pk_mu(ks, mus, pk, b, f, sigma_v, fog)   # (..., nmu, nk)
    return _project(ps, mus, w, ells)


def kaiser_multipole_factors(b, f):
    """The closed-form no-FoG Kaiser prefactors (P_ell = factor P),
    ell = 0, 2, 4."""
    return {0: b**2 + 2.0 * b * f / 3.0 + f**2 / 5.0,
            2: 4.0 * b * f / 3.0 + 4.0 * f**2 / 7.0,
            4: 8.0 * f**2 / 35.0}


@on_device_of_inputs
def correlation_multipoles(ks, pk_ells):
    """xi_ell(s) = (i^ell / 2 pi^2) int dk k^2 P_ell(k) j_ell(ks) by
    FFTLog, for even ells, from {ell: (..., nk)} on the log-uniform numpy
    grid ks.  Every ell lands on the ell = 0 transform's grid (its
    low-ringing offset is forced on all).  Returns (ss, {ell: xi_ell})."""
    ks = np.asarray(ks, dtype=np.float64)
    lnkr0 = fftlog_lnkr(ks, mu=0.5)
    out = {}
    ss = None
    for ell, pl in pk_ells.items():
        assert ell % 2 == 0, "even multipoles only"
        ss, F = fftlog_sphbessel_jl(torch.as_tensor(pl, dtype=_F64), ks, ell,
                                    lnkr=lnkr0)
        out[ell] = (-1.0) ** (ell // 2) * F / (2.0 * math.pi**2)
    return ss, out


@on_device_of_inputs
def sigma_v_lin(ks_tab, pk_tab):
    """Linear 1-D velocity dispersion in displacement units [Mpc],
    sigma_v^2 = (1/6 pi^2) int dq P_lin(q), by the trapezoid on the
    caller's table."""
    pk_tab = torch.as_tensor(pk_tab, dtype=_F64)
    ks_tab = f64(ks_tab, pk_tab.device)
    return torch.sqrt(trapz_traced(pk_tab, ks_tab) / (6.0 * math.pi**2))


@on_device_of_inputs
def scoccimarro_pk_mu(ks, mus, p_dd, p_dt, p_tt, b, f, sigma_v=0.0,
                      fog="gaussian"):
    """P_s(k, mu) = D_FoG(k mu sigma_v)
    [b^2 P_dd + 2 b f mu^2 P_dt + f^2 mu^4 P_tt] (Scoccimarro 2004 eq. 71
    with a FoG factor); ks (nk,), mus (nmu,), p_* (..., nk).  Returns
    (..., nmu, nk)."""
    p_dd = torch.as_tensor(p_dd, dtype=_F64)
    dev = p_dd.device
    ks, mus = f64(ks, dev), f64(mus, dev)
    p_dd = p_dd[..., None, :]
    p_dt = f64(p_dt, dev)[..., None, :]
    p_tt = f64(p_tt, dev)[..., None, :]
    b = f64(b, dev)[..., None, None]
    f = f64(f, dev)[..., None, None]
    sigma_v = f64(sigma_v, dev)[..., None, None]
    mu = mus[:, None]
    kmu = ks[None, :] * mu
    core = (b**2 * p_dd + 2.0 * b * f * mu**2 * p_dt
            + f**2 * mu**4 * p_tt)
    return _fog(kmu, sigma_v, fog) * core


@on_device_of_inputs
def scoccimarro_multipoles(ks, p_dd, p_dt, p_tt, b, f, sigma_v=0.0,
                           ells=(0, 2, 4), fog="gaussian", n_mu=32):
    """Legendre multipoles of ``scoccimarro_pk_mu`` (Gauss-Legendre over
    mu).  Returns {ell: (..., nk)}."""
    p_dd = torch.as_tensor(p_dd, dtype=_F64)
    mus, w = _mu_nodes(n_mu, p_dd.device)
    ps = scoccimarro_pk_mu(ks, mus, p_dd, p_dt, p_tt, b, f, sigma_v, fog)
    return _project(ps, mus, w, ells)


@on_device_of_inputs
def mean_pairwise_velocity(ks, pk, f, aH, b=1.0):
    """Mean pairwise (infall) velocity of tracers of linear bias b,

        v12(r) = -(2/3) f (aH) r b xibar(r) / (1 + b^2 xi(r)),

    with xibar(r) = (3 / (2 pi^2 r)) int dk k P(k) j1(kr) by the j1 FFTLog
    transform of P / k on the j0 transform's grid.  ks (nk,) a log-uniform
    numpy grid, pk (nk,) the matter power as a tensor; aH = a H(z) in
    km/s/Mpc gives v12 in km/s.  Returns (rs [comoving Mpc], v12)."""
    ks = np.asarray(ks, dtype=np.float64)
    pk = torch.as_tensor(pk, dtype=torch.float64)
    rs, xi = correlation_function(ks, pk)
    _, F1 = fftlog_sphbessel_jl(pk / torch.as_tensor(ks, device=pk.device),
                                ks, 1, lnkr=fftlog_lnkr(ks, mu=0.5))
    xibar = 3.0 * F1 / (2.0 * math.pi**2) / rs
    v12 = -(2.0 / 3.0) * f * aH * rs * b * xibar / (1.0 + b**2 * xi)
    return rs, v12
