"""Cosmic infrared background (CIB) halo model on float64 tensors (port of
hmvec_tpu/models/cib.py): the Shang et al 2012 forms,

    L_(1+z)nu(M, z) = L0 Phi(z) Sigma(M) Theta((1+z) nu, T_d(z)),

with Phi = (1+z)^delta, a log-normal luminosity-mass relation Sigma(M), and
a graybody SED Theta continued by a nu^-gamma power law above its
transition frequency (T_d = T0 (1+z)^alpha).  Centrals sit at the halo
center; satellites follow a registered profile u(k), with their
luminosity from the Tinker & Wetzel 2010 subhalo mass function.  The
tracer (``power.CIBTracer``) goes through the same 1-halo / 2-halo
assembly as every other tracer.  The normalization L0 is a free
parameter (1 by default): outputs are in L0 units.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.weights import (f64, host, mass_weights, on_device_of_inputs,
                             tensor_or_f64, trapz_weights)
from .mass_function import n_ln_m_sub
from .power import CIBTracer

# h/k_B in K/GHz
_HK_GHZ = 6.62607015e-34 / 1.380649e-23 * 1e9

default_cib_params = {
    "cib_alpha": 0.36,        # T_d(z) = T0 (1+z)^alpha
    "cib_T0": 24.4,           # K
    "cib_beta": 1.75,         # graybody emissivity index
    "cib_gamma": 1.7,         # high-frequency power-law index
    "cib_delta": 3.6,         # Phi(z) = (1+z)^delta
    "cib_log10meff": 12.6,    # peak of the L-M relation [Msun]
    "cib_var": 0.5,           # sigma^2_{L/M} (log10-mass variance)
    "cib_L0": 1.0,            # free overall normalization
    "cib_msub_min": 1e10,     # subhalo integration floor [Msun]
    "cib_nsub": 64,           # subhalo log-grid points
}


def _sed_transition_x(beta, gamma):
    """x* = h nu0 / (k T), where the graybody's log-slope is -gamma:
    x e^x / (e^x - 1) = 3 + beta + gamma by 40 Newton steps on the host."""
    target = 3.0 + beta + gamma
    x = float(target)
    for _ in range(40):
        ex = np.exp(-x)
        f = x / (1.0 - ex) - target
        # d/dx [x/(1-e^-x)] = (1 - e^-x - x e^-x)/(1-e^-x)^2
        df = (1.0 - ex - x * ex) / (1.0 - ex) ** 2
        x -= f / df
    return x


@on_device_of_inputs
def sed_graybody(nu_ghz, zs, params):
    """Theta(nu, z), (nz,): nu^beta B_nu(T_d) below nu0(z), its
    (nu / nu0)^-gamma continuation above, at the rest-frame (1+z) nu of
    the observed frequency nu_ghz; zs a float64 tensor or array."""
    zs = tensor_or_f64(zs)
    beta = params["cib_beta"]
    gamma = params["cib_gamma"]
    td = params["cib_T0"] * (1.0 + zs) ** params["cib_alpha"]
    xstar = _sed_transition_x(beta, gamma)
    nu_rest = nu_ghz * (1.0 + zs)                       # GHz
    x = _HK_GHZ * nu_rest / td
    grey = nu_rest ** (beta + 3.0) / torch.expm1(x)
    nu0 = xstar * td / _HK_GHZ
    grey0 = nu0 ** (beta + 3.0) / math.expm1(xstar)
    plaw = grey0 * (nu_rest / nu0) ** (-gamma)
    return torch.where(x < xstar, grey, plaw)


def sigma_lum_mass(ms, params):
    """Log-normal L-M relation Sigma(M) = M exp(-(log10 M - log10 Meff)^2
    / (2 sigma^2)) / sqrt(2 pi sigma^2) (Shang+12 eq 23)."""
    var = params["cib_var"]
    arg = (torch.log10(ms) - params["cib_log10meff"]) ** 2 / (2.0 * var)
    return ms / math.sqrt(2.0 * math.pi * var) * torch.exp(-arg)


@on_device_of_inputs
def cib_luminosity(ms, zs, nu_ghz, params):
    """L_(1+z)nu(M, z) on the (nz, nm) grid, in L0 units; ms and zs on one
    device (ms may be a host array)."""
    zs = torch.as_tensor(zs, dtype=torch.float64)
    ms = f64(ms, zs.device)
    phi = (1.0 + zs) ** params["cib_delta"]
    theta = sed_graybody(nu_ghz, zs, params)
    return (params["cib_L0"] * (phi * theta)[:, None]
            * sigma_lum_mass(ms, params)[None, :])


def cib_satellite_luminosity(ms, zs, nu_ghz, params):
    """L_sat(M, z) = int dln m_s N(ln m_s | M) L(m_s, z), (nz, nm), on a
    static log grid of subhalo masses from ``cib_msub_min`` to max(ms),
    which is read from the host copy of the grid."""
    zs = torch.as_tensor(zs, dtype=torch.float64)
    dev = zs.device
    ms_h = host(ms)
    msub = np.geomspace(params["cib_msub_min"], ms_h.max(),
                        int(params["cib_nsub"]))
    w = f64(trapz_weights(np.log(msub)), dev)
    nsub = n_ln_m_sub(f64(msub, dev), f64(ms_h, dev))  # (nsub, nm)
    lsub = cib_luminosity(msub, zs, nu_ghz, params)      # (nz, nsub)
    return torch.einsum("s,sm,zs->zm", w, nsub, lsub)


def build_cib_tracer(ms, zs, nu_ghz, us, params=None, us2=None):
    """The CIBTracer (fc, fs, us, us2) at one observed frequency [GHz].
    ``us`` and ``us2`` are held as given, so every frequency built on one
    registered profile shares its <u^2> tensor (the same-halo pair term
    tests that identity)."""
    p = dict(default_cib_params)
    if params:
        p.update({k: v for k, v in params.items() if k in default_cib_params})
    fc = cib_luminosity(ms, zs, nu_ghz, p) / (4.0 * math.pi)
    fs = cib_satellite_luminosity(ms, zs, nu_ghz, p) / (4.0 * math.pi)
    return CIBTracer(fc=fc, fs=fs, us=us, us2=us2)


def mean_emissivity(nzm, ms, tracer):
    """jbar_nu(z) = int dm n(z, m) (fc + fs)  [L0 / Mpc^3 / sr]."""
    w = mass_weights(f64(ms, nzm.device))
    return torch.sum(nzm * (tracer.fc + tracer.fs) * w[None, :], dim=-1)


def mean_intensity(zs, hzs, nzm, ms, tracer):
    """I_nu = int dchi a jbar = int dz a jbar / H  [L0 / Mpc^2 / sr]."""
    jbar = mean_emissivity(nzm, ms, tracer)
    zs = f64(zs, nzm.device)
    a = 1.0 / (1.0 + zs)
    return (a * jbar / hzs) @ mass_weights(zs)
