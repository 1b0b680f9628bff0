"""21 cm / neutral-hydrogen (HI) halo model on float64 tensors (port of
hmvec_tpu/models/hi.py):

    M_HI(M, z) = M0 (M / Mmin)^alpha exp(-(Mmin / M)^beta_cut),

the Villaescusa-Navarro et al 2018 (eq. 13) form, with the HI inside halos
on any registered profile u(k).  The density-normalized tracer
f(M) = M_HI / rho_HI is a ``power.CIBTracer`` with fc = 0, so every
spectrum with it comes from the common 1-halo / 2-halo assembly.

    Omega_HI(z) = int dm n(m, z) M_HI(m, z) / rho_crit(0),
    Tb(z)       = 188 mK h Omega_HI(z) (1+z)^2 / E(z),
    P_21(k, z)  = Tb(z)^2 P_HIHI(k, z)    [mK^2 Mpc^3].
"""

from __future__ import annotations

import torch

from .power import CIBTracer, mass_weights

default_hi_params = {
    "hi_alpha": 0.24,          # M_HI slope
    "hi_M0": 4.3e10 / 0.6774,  # Msun (4.3e10 h^-1 at the VN18 h)
    "hi_Mmin": 2.0e12 / 0.6774,  # Msun
    "hi_cutoff_exp": 0.35,     # exp(-(Mmin/M)^beta)
}


def m_hi(ms, params=None):
    """M_HI(M) [Msun] (VN18 eq. 13 form); ms a float64 tensor."""
    p = dict(default_hi_params)
    if params:
        p.update({k: v for k, v in params.items() if k in p})
    return (p["hi_M0"] * (ms / p["hi_Mmin"]) ** p["hi_alpha"]
            * torch.exp(-((p["hi_Mmin"] / ms) ** p["hi_cutoff_exp"])))


def rho_hi(nzm, ms, params=None):
    """Comoving HI density rho_HI(z) = int dm n M_HI  [Msun/Mpc^3]."""
    return (nzm * m_hi(ms, params)[None, :]) @ mass_weights(ms)


def build_hi_tracer(ms, nzm, us, params=None, us2=None):
    """(tracer, rho_HI): the density-normalized HI tracer fs = M_HI /
    rho_HI, fc = 0 (all HI follows the profile ``us``)."""
    mh = m_hi(ms, params)
    rho = rho_hi(nzm, ms, params)
    fs = mh[None, :] / rho[:, None]
    return CIBTracer(fc=torch.zeros_like(fs), fs=fs, us=us, us2=us2), rho


def omega_hi(nzm, ms, rho_crit0, params=None):
    """Omega_HI(z) = rho_HI(z) / rho_crit(z = 0)."""
    return rho_hi(nzm, ms, params) / rho_crit0


def hi_bias(nzm, bh, ms, params=None):
    """HI-weighted linear bias b_HI(z) = int n b M_HI / rho_HI."""
    num = (nzm * bh * m_hi(ms, params)[None, :]) @ mass_weights(ms)
    return num / rho_hi(nzm, ms, params)


def mean_brightness_temp_mk(zs, ez, om_hi, h):
    """Post-reionization mean 21 cm brightness temperature [mK]
    (Bull et al 2015 eq. 1): Tb = 188 h Omega_HI (1+z)^2 / E(z)."""
    return 188.0 * h * om_hi * (1.0 + zs) ** 2 / ez
