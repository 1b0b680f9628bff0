"""HMcode nonlinear matter power on float64 tensors (port of
hmvec_tpu/models/hmcode.py): Mead et al 2015 with the 2016 updates (the
reference's default 'mead'), the 2015 parameter set, HMcode-2020 and its
baryonic-feedback response.

HMcode is a halo model with fitted modifications (virial overdensity,
collapse threshold, halo bloating, Bullock concentrations with a
formation-redshift solve, one-halo and two-halo damping, quasi-linear
smoothing; the JAX module's docstring gives every formula and its source).
Here it is plain tensor code on one device:

  * the spectral moments are weighted reductions on a static ln-k grid of
    1,536 points; the 2020 dewiggle is one (1,536 x 1,536) smoothing
    matrix, built once on the host;
  * neff comes from a 60-step bisection of sigma(R) = 1, the formation
    redshift from a 60-step bisection on (nz, 256) masses that evaluates
    the growth in every step -- under ``growth="ode"`` by ``growth_eval``
    on the call's one growth table;
  * the one-halo term evaluates the plain NFW u(k) (``profiles.nfw_uk_x``)
    on an (nz, 256, nk) cube, as the JAX package does (no TPU kernel
    there).

Massive neutrinos follow Mead 2016 sec. 4: the sigma machinery runs on the
cold (cb) spectrum, the one-halo term carries (1 - f_nu)^2, and the
collapse thresholds carry their f_nu factors.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import gamma as _scipy_gamma

from ..ops.special import Wkr
from ..utils.weights import on_device, trapz_weights
from . import background as bgmod
from .profiles import nfw_uk_x

# static ln-k grid for the spectral moments (variance, displacement)
_KG = np.geomspace(1e-4, 1e3, 1536)
_LNKW = trapz_weights(np.log(_KG))

# width in ln k of the Gaussian smoothing of the HMcode-2020 dewiggle
_DW_SIGMA = 0.25


def _dewiggle_matrix():
    """The row-normalized Gaussian-in-ln k smoothing matrix on _KG."""
    lnk = np.log(_KG)
    d = lnk[None, :] - lnk[:, None]
    S = np.exp(-0.5 * (d / _DW_SIGMA) ** 2)
    S /= S.sum(axis=1, keepdims=True)
    return S


# internal halo-mass grid (Msun, no h)
_MS = np.geomspace(1e6, 1e18, 256)
_LNMW = trapz_weights(np.log(_MS))

# sigma(f M) for the Bullock formation-redshift condition (f = 0.01): the
# mass grid is uniform in ln M, so ln sigma at ln M + ln f is a constant
# fractional index shift -- static gather indices and one lerp weight,
# left unclamped (linear extrapolation below the grid)
_FM_LNF = np.log(0.01)
_FM_SHIFT = _FM_LNF / np.log(_MS[1] / _MS[0])
_FM_J = np.clip(np.arange(_MS.size) + int(np.floor(_FM_SHIFT)),
                0, _MS.size - 2)
_FM_T = np.arange(_MS.size) + _FM_SHIFT - _FM_J

# Sheth-Tormen g(nu), HMcode convention (Mead 2015 eq. 15-16), normalized
# so that int_0^inf g(nu) dnu = 1
_ST_Q = 0.707
_ST_P = 0.3
_ST_A = float(np.sqrt(2.0 * _ST_Q)
              / (np.sqrt(np.pi) + 2.0 ** -_ST_P * _scipy_gamma(0.5 - _ST_P)))


def _statics(device):
    """(kg, ln k weights, ms, ln M weights, _FM_T, _FM_J) on ``device``."""
    return on_device("hmcode", device,
                     lambda: (_KG, _LNKW, _MS, _LNMW, _FM_T, _FM_J))


def _dewiggle_on(device):
    """The dewiggle matrix on ``device``, built on the host at first use."""
    return on_device("hmcode_dewiggle", device,
                     lambda: (_dewiggle_matrix(),))[0]


def _st_gnu(nu):
    qnu2 = _ST_Q * nu**2
    return _ST_A * (1.0 + qnu2 ** -_ST_P) * torch.exp(-qnu2 / 2.0)


def _xwprime(x, switch=0.05):
    """x dW/dx for the top-hat window, 3 sin x / x - 3 W(x); the Taylor
    form -x^2/5 + x^4/70 below the switch."""
    xs = torch.where(x == 0, 1.0, x)
    big = 3.0 * torch.sin(xs) / xs - 3.0 * Wkr(x, 1.0)
    small = -(x**2) / 5.0 + x**4 / 70.0
    return torch.where(x < switch, small, big)


def _tophat_moments(delta2_g, R):
    """(sigma^2(R), dln sigma^2 / dln R) for top-hat smoothing.

    delta2_g: (nz, nkg) dimensionless linear power on _KG; R broadcastable
    to (nz, ...).  Contractions over k by the static trapz-in-ln k
    weights."""
    kg, w = _statics(delta2_g.device)[:2]
    x = kg * R[..., None]                         # (nz, ..., nkg)
    W = Wkr(x, 1.0)
    d2 = delta2_g[:, None, :] if x.dim() == 3 else delta2_g
    s2 = (d2 * W**2) @ w
    d1 = (d2 * 2.0 * W * _xwprime(x)) @ w         # dsigma^2 / dlnR
    return s2, d1 / s2


def _sigma_v2(delta2_g, R):
    """1-D displacement variance sigma_v^2(R) = (1/3) int dlnk D2(k) / k^2
    W^2(kR) (Mead 2015 eq. 22); R a scalar (0: unfiltered)."""
    kg, w = _statics(delta2_g.device)[:2]
    W2 = Wkr(kg * R, 1.0) ** 2
    return (delta2_g * (W2 / kg**2)) @ w / 3.0


def hmcode_nonlinear(bg, zs, ks, plin_g, plin, sigma8_0, A_bary=3.13,
                     num_iter: int = 60, growth_mode: str = "closed",
                     version: str = "2016", plin_ref_g=None,
                     plin_sig_g=None, logT_AGN=7.8, growth_table=None):
    """HMcode nonlinear P(k, z) (nz, nk) from precomputed linear power.

    bg: BackgroundParams; zs (nz,), ks (nk,); plin_g (nz, nkg): linear P on
    the static _KG grid; plin (nz, nk) on ks; sigma8_0: sigma_8(z = 0).
    growth_mode 'closed' (2F1) or 'ode' (any w0/wa), which reads
    ``growth_table`` (built here when None) in every growth evaluation,
    the formation-redshift bisection's included.  version: '2016' (the
    reference's 'mead'), '2015', '2020' or '2020_feedback'; the 2020
    family needs plin_ref_g, the EH98 zero-baryon template on _KG.
    plin_sig_g: the cold (cb) power on _KG for the sigma machinery
    (plin_g when None)."""
    if version not in ("2015", "2016", "2020", "2020_feedback"):
        raise ValueError(f"hmcode version {version!r}: supported are "
                         "'2015', '2016', '2020', '2020_feedback' (the "
                         "class API maps 'mead'/'mead2015'/'mead2020'/"
                         "'mead2020_feedback' onto these)")
    v2020 = version in ("2020", "2020_feedback")
    zs = torch.atleast_1d(zs)
    dev = zs.device
    kg, _, ms, lnmw, fm_t, fm_j = _statics(dev)
    f64 = lambda v: torch.as_tensor(v, dtype=torch.float64, device=dev)
    h = bg.H0 / 100.0
    if plin_sig_g is None:
        plin_sig_g = plin_g
    delta2_g = plin_sig_g * kg[None, :] ** 3 / (2.0 * math.pi**2)

    if growth_mode == "ode" and growth_table is None:
        growth_table = bgmod.growth_table(bg)

    def growth_z0norm(a_eval):
        return bgmod.d_growth(bg, a_eval, norm="z0norm", mode=growth_mode,
                              table=growth_table)

    # --- fitted background quantities ---------------------------------
    a = 1.0 / (1.0 + zs)
    gz = growth_z0norm(a)                                # g(0) = 1
    omz = bgmod.omz(bg, zs)
    sigma8_z = sigma8_0 * gz
    fnu = bg.omnu0 / (bg.omm0 + bg.omnu0)
    if version == "2015":                                # Mead15 table 2
        dc = 1.59 + 0.0314 * torch.log(sigma8_z)
        eta = 0.603 - 0.3 * sigma8_z
        Dv = 418.0 * omz ** -0.352
    elif v2020:
        # physical spherical collapse (NS97 / BN98), mean-density Dv
        dc = (3.0 / 20.0) * (12.0 * math.pi) ** (2.0 / 3.0) * (
            1.0 + 0.012299 * torch.log10(omz))
        xbn = omz - 1.0
        Dv = (18.0 * math.pi**2 + 82.0 * xbn - 39.0 * xbn**2) / omz
        eta = 0.1281 * sigma8_z ** -0.3644
    else:                                                # Mead16 table 1
        dc = ((1.59 + 0.0314 * torch.log(sigma8_z))
              * (1.0 + 0.0123 * torch.log10(omz)))
        eta = (0.98 - 0.12 * A_bary) - 0.3 * sigma8_z
        Dv = 418.0 * omz ** -0.352
    if version != "2015":
        # Mead-2016 sec. 4 massive-neutrino corrections (no-ops at m_nu = 0)
        dc = dc * (1.0 + 0.262 * fnu)
        Dv = Dv * (1.0 + 0.916 * fnu)

    sv2 = _sigma_v2(delta2_g, 0.0)                       # (nz,)
    sv = torch.sqrt(sv2)
    if version == "2015":
        fdamp = torch.clamp(0.188 * sigma8_z ** 4.29, 1e-3, 0.99)
        kstar = 0.584 / sv
    elif v2020:
        fdamp = torch.clamp(0.2696 * sigma8_z ** 0.9403, 1e-3, 0.99)
        kstar = 0.05618 * sigma8_z ** -1.013 * h         # table 2, h/Mpc
    else:
        sv100 = torch.sqrt(_sigma_v2(delta2_g, 100.0 / h))  # 100 Mpc/h
        fdamp = torch.clamp(0.0095 * (sv100 * h) ** 1.37, 1e-3, 0.99)
        kstar = 0.584 / sv

    # --- neff at the nonlinear scale (top-hat sigma = 1) ---------------
    lo = torch.full((zs.numel(),), math.log(1e-4), dtype=torch.float64,
                    device=dev)
    hi = torch.full_like(lo, math.log(1e3))
    for _ in range(num_iter):
        mid = (lo + hi) / 2.0
        s2, _ = _tophat_moments(delta2_g, torch.exp(mid))
        go_right = s2 > 1.0          # sigma^2 decreases with R
        lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid)
    _, dlns2_nl = _tophat_moments(delta2_g, torch.exp((lo + hi) / 2.0))
    neff = -3.0 - dlns2_nl
    if version == "2015":
        alpha = 2.93 * 1.77**neff
    elif v2020:
        alpha = 1.875 * 1.603**neff
    else:
        alpha = 3.24 * 1.85**neff

    # --- halo ingredients on the internal mass grid --------------------
    rho_m0 = bgmod.rho_matter_z(bg, 0.0)                 # comoving
    rl = (3.0 * ms / (4.0 * math.pi * rho_m0)) ** (1.0 / 3.0)
    sigma2_m, dlns2_m = _tophat_moments(
        delta2_g, rl[None, :] + torch.zeros((zs.numel(), 1),
                                            dtype=torch.float64, device=dev))
    sig = torch.sqrt(sigma2_m)                           # (nz, nm)
    nu = dc[:, None] / sig
    # dnu/dlnM = -(nu/6) dln sigma^2/dln R  (dlnR/dlnM = 1/3)
    dnu_dlnm = -(nu / 6.0) * dlns2_m

    # Bullock formation redshift (Mead 2015 eq. 20-21, f = 0.01):
    # g(z_f) sigma(f M, 0) = dc(z)
    sig0 = sig / gz[:, None]                             # sigma(M, z = 0)
    lnsig0 = torch.log(sig0)
    t = fm_t[None, :]
    sig0_fm = torch.exp(lnsig0[:, fm_j] * (1.0 - t) + lnsig0[:, fm_j + 1] * t)
    rhs = dc[:, None] / sig0_fm                          # target g(z_f)

    zlo = torch.zeros_like(rhs)
    zhi = torch.full_like(rhs, 100.0)
    for _ in range(num_iter):
        zmid = (zlo + zhi) / 2.0
        deeper = growth_z0norm(1.0 / (1.0 + zmid)) > rhs  # g decreases in z
        zlo, zhi = (torch.where(deeper, zmid, zlo),
                    torch.where(deeper, zhi, zmid))
    zf = (zlo + zhi) / 2.0
    # Dolag-2004 dark-energy correction to the concentrations (power 1.5
    # in 2015/2016, 1 in 2020); exactly 1 at LCDM, engaged with the ODE
    # growth
    dolag_fac = 1.0
    if growth_mode == "ode":
        dolag_fac = bgmod.growth_dolag_ratio(bg) ** (1.0 if v2020 else 1.5)

    # comoving virial radius from the fitted Dv (mean-density definition)
    rv = rl[None, :] / Dv[:, None] ** (1.0 / 3.0)
    w_int = (lnmw[None, :] * _st_gnu(nu) * dnu_dlnm
             * ms[None, :] / rho_m0)                     # (nz, nm)

    def one_halo_d2(c_amp, window=None):
        """Damped one-halo Delta^2 for a concentration amplitude (scalar or
        (nz, 1)) and an optional (wmod, fstar) gas/star window
        modification (Mead 2021 sec. 5)."""
        c_amp = f64(c_amp)
        c = c_amp * (1.0 + zf) / (1.0 + zs[:, None])
        c = torch.maximum(c, c_amp)  # z_f < z collapses to c = amp
        c = c * dolag_fac
        rs = rv / c
        x = ((nu ** eta[:, None])[..., None]
             * ks[None, None, :] * rs[..., None])
        u = nfw_uk_x(x, c[..., None])                    # (nz, nm, nk)
        if window is not None:
            wmod, fstar = window
            u = wmod[..., None] * u + fstar[..., None]
        p1h = torch.sum(w_int[..., None] * u * u, dim=1)  # (nz, nk)
        if version != "2015":
            # halos hold only the cold matter (no-op at m_nu = 0)
            p1h = p1h * (1.0 - fnu) ** 2
        d2 = p1h * ks[None, :] ** 3 / (2.0 * math.pi**2)
        ky = ks[None, :] / kstar[:, None]
        if version == "2015":
            return d2 * -torch.expm1(-(ky**2))
        return d2 * ky**4 / (1.0 + ky**4)

    # gravity-only one-halo term (A_bary is ignored in the 2020 family)
    d2_1h = one_halo_d2(5.196 if v2020 else A_bary)

    # --- two-halo term (damped linear) ----------------------------------
    if v2020:
        if plin_ref_g is None:
            raise ValueError(f"hmcode version {version!r} needs "
                             "plin_ref_g (EH98 zero-baryon template on "
                             "the _KG grid) for the dewiggle")
        from ..ops.quadrature import linear_interp

        lnr = torch.log(plin_g / plin_ref_g)             # (nz, nkg)
        p_sm_g = plin_ref_g * torch.exp(lnr @ _dewiggle_on(dev).T)
        wig_damp = torch.exp(-(kg**2)[None, :] * sv2[:, None])
        p_dw_g = p_sm_g + (plin_g - p_sm_g) * wig_damp
        # the (smooth in ln k) dewiggle ratio, carried to the target ks
        lnrat_g = torch.log(p_dw_g / plin_g)
        rat_t = linear_interp(torch.log(ks), torch.log(kg), lnrat_g)
        d2_dw = (plin * torch.exp(rat_t) * ks[None, :] ** 3
                 / (2.0 * math.pi**2))
        kd = 0.05699 * sigma8_z ** -1.089 * h            # table 2, h/Mpc
        ynd = (ks[None, :] / kd[:, None]) ** 2.853
        d2_2h = d2_dw * (1.0 - fdamp[:, None] * ynd / (1.0 + ynd))
    else:
        d2_lin = plin * ks[None, :] ** 3 / (2.0 * math.pi**2)
        f = fdamp[:, None]
        d2_2h = d2_lin * (1.0 - f * torch.tanh(ks[None, :] * sv[:, None]
                                               / torch.sqrt(f)) ** 2)

    # --- quasi-linear smoothing ------------------------------------------
    al = alpha[:, None]
    d2 = (d2_2h**al + d2_1h**al) ** (1.0 / al)

    if version == "2020_feedback":
        # Mead 2021 sec. 5 feedback response: the ratio of a hydro and a
        # gravity-only halo-model evaluation (Table 5), fractions of the
        # cold matter
        theta_agn = f64(logT_AGN) - 7.8
        c_hyd = ((3.13 - 0.496 * theta_agn)
                 * 10.0 ** (zs[:, None] * (-0.0485 - 0.0371 * theta_agn)))
        fbar = bg.ombh2 / (bg.ombh2 + bg.omch2)
        mb = (10.0 ** (13.87 + 1.81 * theta_agn) / h
              * 10.0 ** (zs[:, None] * (-0.108 + 0.195 * theta_agn)))
        fstar = torch.minimum(
            (2.01 - 0.30 * theta_agn) * 1e-2
            * 10.0 ** (zs * (0.409 + 0.0224 * theta_agn)), fbar)[:, None]
        mrat2 = (ms[None, :] / mb) ** 2                  # (nz, nm)
        fgas = (fbar - fstar) * mrat2 / (1.0 + mrat2)
        wmod = (1.0 - fbar) + fgas                       # f_c + f_g(M)
        d2_1h_hyd = one_halo_d2(c_hyd, (wmod, fstar))
        c_grv = 3.44 * 10.0 ** (zs[:, None] * -0.0671)
        d2_1h_grv = one_halo_d2(c_grv)
        d2 = d2 * ((d2_2h**al + d2_1h_hyd**al)
                   / (d2_2h**al + d2_1h_grv**al)) ** (1.0 / al)

    return d2 * (2.0 * math.pi**2) / ks[None, :] ** 3


def hmcode_power(cosmo, zs, ks, A_bary=None, version: str = "2016",
                 logT_AGN=None):
    """Nonlinear P(k, z) by HMcode for a Cosmology instance (the
    ``HaloModel(halofit='mead')`` path; version '2015' serves 'mead2015').

    A_bary: the Bullock concentration amplitude, the baryonic-feedback
    knob (default params['hmcode_A'], 3.13); logT_AGN: log10(T_AGN/K) of
    version '2020_feedback' (default params['hmcode_logT_AGN'], 7.8).
    Every linear power of the call, and every growth evaluation under
    ``growth="ode"``, reads one growth table."""
    from .linear_power import _mnu_maybe_active, plin_approx

    bg = cosmo.bg
    zs = torch.atleast_1d(cosmo._t(zs))
    ks = cosmo._t(ks)
    dev = zs.device
    kg = _statics(dev)[0]
    if A_bary is None:
        A_bary = cosmo.p.get("hmcode_A", 3.13)
    if logT_AGN is None:
        logT_AGN = cosmo.p.get("hmcode_logT_AGN", 7.8)
    gm = cosmo.growth_mode
    gtab = bgmod.growth_table(bg) if gm == "ode" else None
    tab = {} if gtab is None else {"growth_table": gtab}

    def plin_fn(zq, kq, **kw):
        return cosmo.engine.plin(bg, zq, kq, accuracy=cosmo.accuracy,
                                 growth_mode=gm, **tab, **kw)

    plin_g = plin_fn(zs, kg)
    plin = plin_fn(zs, ks)
    sigma8_0 = torch.sqrt(cosmo.get_sigma2_R(8.0 / (bg.H0 / 100.0),
                                             [0.0])[0, 0])
    plin_sig_g = None
    if (_mnu_maybe_active(bg.omnu0) and version != "2015"
            and cosmo.engine.name == "eh"):
        # the cold (cb) spectrum drives the sigma/nu machinery; sigma8_0
        # rescaled by the cb / total variance ratio on the shared grid
        plin_sig_g = plin_fn(zs, kg, component="cb")
        z0 = cosmo._t([0.0])
        d2_tot0 = plin_fn(z0, kg) * kg[None, :] ** 3 / (2.0 * math.pi**2)
        d2_cb0 = (plin_fn(z0, kg, component="cb") * kg[None, :] ** 3
                  / (2.0 * math.pi**2))
        r8 = (8.0 / (bg.H0 / 100.0)).reshape(1)
        s2_tot, _ = _tophat_moments(d2_tot0, r8)
        s2_cb, _ = _tophat_moments(d2_cb0, r8)
        sigma8_0 = sigma8_0 * torch.sqrt(s2_cb[0] / s2_tot[0])
    plin_ref_g = None
    if version in ("2020", "2020_feedback"):
        # EH98 zero-baryon dewiggle template
        plin_ref_g = plin_approx(bg, zs, kg, kind="eisenhu", growth_mode=gm,
                                 growth_table=gtab)
    return hmcode_nonlinear(
        bg, zs, ks, plin_g, plin, sigma8_0,
        torch.as_tensor(A_bary, dtype=torch.float64, device=dev),
        growth_mode=gm, version=version, plin_ref_g=plin_ref_g,
        plin_sig_g=plin_sig_g,
        logT_AGN=torch.as_tensor(logT_AGN, dtype=torch.float64, device=dev),
        growth_table=gtab)
