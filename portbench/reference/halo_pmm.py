"""Plain NumPy/SciPy reference of the halo-model matter power spectrum that
the configurations ``pmm_fast_serving`` and ``pmm_fused_serving`` serve.

Written from the published formulas, in the structure of hmvec's
``cosmology.py`` / ``hmvec.py`` (adapted from the JAX package's float64
twin, ``hmvec_tpu/twin/core.py`` and ``halo.py``, with every import of that
package replaced by local code).  It imports nothing of the program.

One cosmology ``theta`` (a dict of the parameters the traffic varies) and
a configuration (``portbench/configs/<name>.json``: its grids, options and
fixed parameters) give Pmm(z, k) = P_1h + P_2h, shape (nz, nk):

* background: flat LCDM with radiation, rho_crit(z) = H(z)^2 3/(8 pi G);
* growth: the closed form D(a) = sqrt(1 + x^3) 2F1(5/6, 3/2; 11/6; -x^3) a,
  x = (Omega_L / Omega_m)^(1/3) a (Heath 1977), scipy's hyp2f1;
* linear power: Eisenstein & Hu 1998 with baryon oscillations;
* sigma^2(R, z) by composite Simpson (scipy's semantics, Cartwright's
  end correction) on the configuration's log-spaced k grid, the top-hat
  window with its Taylor series below kR = Wkr_taylor_switch;
* Sheth-Tormen n(z, m) (d ln sigma^-1 / d ln m by numpy's gradient) and
  bias;
* Duffy et al. 2008 virial concentration, r_vir from Bryan & Norman's
  Delta_v, the truncated NFW u(k) from scipy's sici;
* the serving options: u(k) (fast tier) or the two mass sums (fused tier)
  evaluated on every ``every``-th k below ``ksplit`` and filled in by a
  Catmull-Rom cubic in ln k, tangents by centred finite differences,
  one-sided in the first and last interval;
* P_1h = int dm n (m/rho)^2 u^2 (1 - exp(-(k/k*)^2)),
  P_2h = P_lin (int dm n b (m/rho) u + 1 - int dm n b (m/rho))^2, both by
  the trapezoid rule over m.

``spectra`` in float64 is the reference.  ``control`` is the same
arithmetic one precision below what the configuration states: the
stages and mass integrals, stated in float64, in float32, and u(k), stated
in float32, rounded to bfloat16.  ``control_stages`` lowers only the
stages and mass integrals to float32.
"""

from __future__ import annotations

import numpy as np
from scipy.special import hyp2f1, sici

CSPEED_KMS = 299792.458
# rho_crit = H_kms^2 * 3 (km/s/Mpc -> 1/s)^2 / (8 pi G) in Msun/Mpc^3
_HZ_TO_SI = 3.241e-20
_G_SI = 6.67259e-11
_RHO_SI_TO_MSUN_MPC3 = 1.477543e37
RHO_CRIT_FACTOR = (3.0 * _HZ_TO_SI**2 / (8.0 * np.pi * _G_SI)
                   * _RHO_SI_TO_MSUN_MPC3)
T27_SQ = (2.726 / 2.7) ** 2   # hmvec's Tk hardcodes 2.726 K


def grid(spec: dict) -> np.ndarray:
    """A configuration's grid: {"space": "linear"|"log", start, stop, num}."""
    make = {"linear": np.linspace, "log": np.geomspace}[spec["space"]]
    return make(spec["start"], spec["stop"], spec["num"])


def grids(cfg: dict):
    g = cfg["grids"]
    return grid(g["zs"]), grid(g["ms"]), grid(g["ks"])


def simpson_weights(x):
    """w with w @ f == scipy.integrate.simpson(f, x=x) (scipy >= 1.11):
    panels of two intervals from the left, and for an odd number of
    intervals Cartwright's correction over the last three points."""
    n = x.size
    w = np.zeros_like(x)
    h = np.diff(x)
    for i in range(0, n - 2, 2):
        h0, h1 = h[i], h[i + 1]
        s = (h0 + h1) / 6.0
        w[i] += s * (2.0 - h1 / h0)
        w[i + 1] += s * (h0 + h1) ** 2 / (h0 * h1)
        w[i + 2] += s * (2.0 - h0 / h1)
    if (n - 1) % 2:
        h0, h1 = h[-2], h[-1]
        w[-1] += (2 * h1**2 + 3 * h0 * h1) / (6 * (h0 + h1))
        w[-2] += (h1**2 + 3 * h0 * h1) / (6 * h0)
        w[-3] -= h1**3 / (6 * h0 * (h0 + h1))
    return w


def trapezoid_weights(x):
    w = np.zeros_like(x)
    half = np.diff(x) / 2.0
    w[:-1] += half
    w[1:] += half
    return w


def thinned_k(ks, ksplit, every):
    """Indices of the k kept by the serving option: every ``every``-th k
    below ``ksplit`` and the last one below it, and every k above."""
    low = np.nonzero(ks < ksplit)[0]
    return np.unique(np.concatenate([low[::every], low[-1:],
                                     np.nonzero(ks >= ksplit)[0]]))


def catmull_rom(x_src, y_src, x_dst):
    """The cubic Hermite interpolant through (x_src, y_src[..., :]) with
    tangents (y[i+1] - y[i-1]) / (x[i+1] - x[i-1]), one-sided at the two
    ends, evaluated at x_dst."""
    n = x_src.size
    i = np.clip(np.searchsorted(x_src, x_dst, side="right") - 1, 0, n - 2)
    x0, x1 = x_src[i], x_src[i + 1]
    h = x1 - x0
    t = (x_dst - x0) / h
    lo, hi = np.maximum(i - 1, 0), np.minimum(i + 2, n - 1)
    y0, y1 = y_src[..., i], y_src[..., i + 1]
    m0 = (y1 - y_src[..., lo]) / (x1 - x_src[lo])
    m1 = (y_src[..., hi] - y0) / (x_src[hi] - x0)
    t2, t3 = t * t, t * t * t
    return ((2 * t3 - 3 * t2 + 1) * y0 + (t3 - 2 * t2 + t) * h * m0
            + (-2 * t3 + 3 * t2) * y1 + (t3 - t2) * h * m1)


class Background:
    """The background of one cosmology in precision ``dtype``."""

    def __init__(self, theta: dict, fixed: dict, dtype):
        f = lambda v: np.asarray(v, dtype=dtype)[()]
        self.f = f
        self.H0 = f(theta["H0"])
        self.h = self.H0 / f(100.0)
        self.omch2, self.ombh2 = f(theta["omch2"]), f(theta["ombh2"])
        self.ns, self.As = f(theta["ns"]), f(theta["As"])
        self.omm0 = (self.omch2 + self.ombh2) / self.h**2
        self.omk0 = f(fixed["omk"])
        self.oml0 = f(1.0) - self.omm0 - self.omk0
        self.omr0 = (f(2.47282e-5) * (f(1.0) + f(0.2271) * f(fixed["nnu"]))
                     / self.h**2)
        self.omnu0 = f(fixed["mnu"]) / f(93.14) / self.h**2
        if fixed["mnu"] != 0.0 or fixed["w0"] != -1.0 or fixed["wa"] != 0.0:
            raise ValueError("the reference covers flat LCDM with massless "
                             "neutrinos only")

    def e2(self, z):
        zp1 = 1.0 + z
        return (self.omr0 * zp1**4 + (self.omm0 + self.omnu0) * zp1**3
                + self.omk0 * zp1**2 + self.oml0)

    def rho_crit(self, z):
        return self.H0**2 * self.e2(z) * self.f(RHO_CRIT_FACTOR)

    def rho_m(self, z):
        return self.rho_crit(0.0) * self.omm0 * (1.0 + z) ** 3

    def growth(self, a):
        """D(a) -> a in matter domination."""
        x3 = ((self.oml0 / self.omm0) ** (1.0 / 3.0) * a) ** 3
        return np.sqrt(1.0 + x3) * hyp2f1(5.0 / 6.0, 1.5, 11.0 / 6.0,
                                          -x3).astype(x3.dtype) * a

    def transfer(self, ks):
        """EH98 with baryon oscillations; ks in 1/Mpc."""
        h, w_b = self.h, self.ombh2
        w_m = self.omch2 + self.ombh2
        k = ks / h
        k_eq = 7.46e-2 * w_m / T27_SQ / h
        z_eq = 2.50e4 * w_m / T27_SQ**2
        b1 = 0.313 * w_m**-0.419 * (1.0 + 0.607 * w_m**0.674)
        b2 = 0.238 * w_m**0.223
        z_d = (1291.0 * w_m**0.251 / (1.0 + 0.659 * w_m**0.828)
               * (1.0 + b1 * w_b**b2))
        r_d = 31.5 * w_b / T27_SQ**2 * (1.0e3 / z_d)
        r_eq = 31.5 * w_b / T27_SQ**2 * (1.0e3 / z_eq)
        sh_d = (2.0 / (3.0 * k_eq) * np.sqrt(6.0 / r_eq)
                * np.log((np.sqrt(1.0 + r_d) + np.sqrt(r_eq + r_d))
                         / (1.0 + np.sqrt(r_eq))))
        k_silk = (1.6 * w_b**0.52 * w_m**0.73
                  * (1.0 + (10.4 * w_m) ** -0.95) / h)
        fb, fc = w_b / w_m, self.omch2 / w_m
        a1 = (46.9 * w_m) ** 0.670 * (1.0 + (32.1 * w_m) ** -0.532)
        a2 = (12.0 * w_m) ** 0.424 * (1.0 + (45.0 * w_m) ** -0.582)
        alpha_c = a1**-fb * a2 ** (-(fb**3))
        bc1 = 0.944 / (1.0 + (458.0 * w_m) ** -0.708)
        bc2 = (0.395 * w_m) ** -0.0266
        beta_c = 1.0 / (1.0 + bc1 * (fc**bc2 - 1.0))

        def t_tilde(alpha, beta):
            q = k / (13.41 * k_eq)
            L = np.log(np.e + 1.8 * beta * q)
            C = 14.2 / alpha + 386.0 / (1.0 + 69.9 * q**1.08)
            return L / (L + C * q * q)

        f = 1.0 / (1.0 + (k * sh_d / 5.4) ** 4)
        tc = f * t_tilde(1.0, beta_c) + (1.0 - f) * t_tilde(alpha_c, beta_c)
        y = (1.0 + z_eq) / (1.0 + z_d)
        x = np.sqrt(1.0 + y)
        g_eh = y * (-6.0 * x + (2.0 + 3.0 * y) * np.log((x + 1.0) / (x - 1.0)))
        alpha_b = 2.07 * k_eq * sh_d * (1.0 + r_d) ** -0.75 * g_eh
        beta_node = 8.41 * w_m**0.435
        tilde_s = sh_d / (1.0 + (beta_node / (k * sh_d)) ** 3) ** (1.0 / 3.0)
        beta_b = 0.5 + fb + (3.0 - 2.0 * fb) * np.sqrt((17.2 * w_m) ** 2 + 1.0)
        tb = (t_tilde(1.0, 1.0) / (1.0 + (k * sh_d / 5.2) ** 2)
              + alpha_b / (1.0 + (beta_b / (k * sh_d)) ** 3)
              * np.exp(-((k / k_silk) ** 1.4))) * np.sinc(k * tilde_s / np.pi)
        return fb * tb + fc * tc

    def plin(self, zs, ks, pivot):
        """Linear P(z, k) in Mpc^3, shape (nz, nk)."""
        d = self.growth(1.0 / (1.0 + zs))
        omh2 = (self.omch2 + self.ombh2) * 100.0**2 + self.omnu0 * self.H0**2
        pref = (self.As * self.f(8.0 * np.pi**2 * CSPEED_KMS**4 / 25.0)
                / omh2**2)
        kfac = (ks / pivot) ** (self.ns - 1.0) * ks
        return (pref * kfac[None, :] * d[:, None] ** 2
                * self.transfer(ks)[None, :] ** 2)


def nfw_u(ks, scales, cs):
    """Truncated NFW u(k) on (rows, k): x = k r_s (1 + z)."""
    x = ks[None, :] * scales[:, None]
    c = cs[:, None]
    si, ci = sici(x)
    sic, cic = sici((1.0 + c) * x)
    mc = np.log(1.0 + c) - c / (1.0 + c)
    return (np.sin(x) * (sic - si) - np.sin(c * x) / ((1.0 + c) * x)
            + np.cos(x) * (cic - ci)) / mc


def nfw_rows(bg, zs, ms, fixed):
    """(scales, cs) on (nz, nm): Duffy et al. 2008's virial c(z, m) and
    r_s (1 + z), r_s = r_vir / c, r_vir for Bryan & Norman's Delta_v."""
    cs = (bg.f(fixed["duffy_A_vir"])
          * (bg.h * ms[None, :] / 2.0e12) ** bg.f(fixed["duffy_alpha_vir"])
          * (1.0 + zs[:, None]) ** bg.f(fixed["duffy_beta_vir"]))
    rho_c = bg.rho_crit(zs)
    xv = bg.rho_m(zs) / rho_c - 1.0
    delta_v = 18.0 * np.pi**2 + 82.0 * xv - 39.0 * xv**2
    rvir = (3.0 * ms[None, :] / (4.0 * np.pi) / delta_v[:, None]
            / rho_c[:, None]) ** (1.0 / 3.0)
    return rvir / cs * (1.0 + zs[:, None]), cs


def halo_inputs(theta: dict, cfg: dict, dtype=np.float64):
    """The stages before the profile for one cosmology:
    (zs, ks, ms, pzk, nzm, bh, rho_m0, scales, cs), the last two the NFW
    inputs r_s (1 + z) and c on (nz, nm)."""
    fixed = cfg["fixed_params"]
    opts = cfg["options"]
    if opts["mass_function"] != "sheth-torman" or opts["mdef"] != "vir":
        raise ValueError("the reference covers Sheth-Tormen and mdef 'vir'")
    f = lambda v: np.asarray(v, dtype=dtype)
    zs, ms, ks = (f(a) for a in grids(cfg))
    bg = Background(theta, fixed, dtype)
    pivot = bg.f(fixed["pivot_scalar"])
    pzk = bg.plin(zs, ks, pivot)

    # sigma^2(z, m) on the configuration's k grid
    # the configuration's build-time overrides over its fixed parameters
    numks = {**fixed, **opts.get("static_params", {})}["sigma2_numks"]
    ks2 = np.geomspace(fixed["sigma2_kmin"], fixed["sigma2_kmax"], numks)
    kw = f(simpson_weights(ks2) * ks2**2 / (2.0 * np.pi**2))
    ks2 = f(ks2)
    rho_m0 = bg.rho_m(bg.f(0.0))
    R = (3.0 * ms / (4.0 * np.pi) / rho_m0) ** (1.0 / 3.0)
    kR = ks2[None, :] * R[:, None]
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        win = 3.0 * (np.sin(kR) - kR * np.cos(kR)) / kR**3
    kR2 = kR * kR
    taylor = 1.0 - 0.1 * kR2 + f(0.00357142857143) * kR2 * kR2
    win = np.where(kR < bg.f(fixed["Wkr_taylor_switch"]), taylor, win)
    sigma2 = (bg.plin(zs, ks2, pivot) * kw[None, :]) @ (win * win).T

    # Sheth-Tormen
    A, a, p = (bg.f(fixed[k]) for k in ("st_A", "st_a", "st_p"))
    dc = bg.f(fixed["st_deltac"])
    nu_f = (A * np.sqrt(2.0 * a / np.pi) * (1.0 + (sigma2 / a / dc**2) ** p)
            * (dc / np.sqrt(sigma2)) * np.exp(-a * dc**2 / 2.0 / sigma2))
    dln = np.gradient(-0.5 * np.log(sigma2), np.log(ms), axis=-1)
    nzm = rho_m0 * nu_f * dln / ms[None, :] ** 2
    bh = (1.0 + (a * dc**2 / sigma2 - 1.0) / dc
          + (2.0 * p / dc) / (1.0 + (a * dc**2 / sigma2) ** p))

    scales, cs = nfw_rows(bg, zs, ms, fixed)
    return zs, ks, ms, pzk, nzm, bh, rho_m0, scales, cs


def _thinned(ks, cfg):
    sub = cfg["options"].get("uk_subsample")
    if sub is None:
        return np.arange(ks.size)
    return thinned_k(np.asarray(ks, np.float64), *sub)


def _mass_sums(ms, nzm, bh, rho_m0):
    """The mass-integral weights a = w n (m/rho)^2, b = w n b_h (m/rho) on
    (nz, nm), w the trapezoid weights, and c_z = sum_m b."""
    w = trapezoid_weights(ms)
    mfac = ms / rho_m0
    a_zm = w[None, :] * nzm * mfac[None, :] ** 2
    b_zm = w[None, :] * nzm * bh * mfac[None, :]
    return a_zm, b_zm, b_zm.sum(axis=1)


def kernel_inputs(theta: dict, cfg: dict) -> dict:
    """What the NFW kernels are given for one cosmology, worked out here:
    ks (the thinned k grid), and scales = r_s (1 + z) and cs on (nz, nm)."""
    zs, ms, ks = grids(cfg)
    bg = Background(theta, cfg["fixed_params"], np.float64)
    scales, cs = nfw_rows(bg, zs, ms, cfg["fixed_params"])
    return {"ks": ks[_thinned(ks, cfg)], "scales": scales, "cs": cs}


def spectra(theta: dict, cfg: dict, dtype=np.float64, profile=nfw_u
            ) -> np.ndarray:
    """Pmm(z, k), shape (nz, nk), of one cosmology under configuration
    ``cfg``, in precision ``dtype``; ``profile`` computes u(k) on
    (rows, k) from (ks, scales, cs)."""
    zs, ks, ms, pzk, nzm, bh, rho_m0, scales, cs = halo_inputs(theta, cfg,
                                                               dtype)
    nz, nm = cs.shape
    keep = _thinned(ks, cfg)
    kq = ks[keep]
    u = profile(kq, scales.reshape(-1), cs.reshape(-1)).reshape(nz, nm, -1)
    a_zm, b_zm, c_z = _mass_sums(ms, nzm, bh, rho_m0)
    fill = (lambda y: y) if keep.size == ks.size else (
        lambda y: catmull_rom(np.log(kq), y, np.log(ks)))
    if cfg["options"].get("fused_serving"):
        # the fused tier sums on the thinned grid, then fills the sums
        s1 = fill(np.einsum("zm,zmk->zk", a_zm, u * u))
        s2 = fill(np.einsum("zm,zmk->zk", b_zm, u))
    else:
        u = fill(u)
        s1 = np.einsum("zm,zmk->zk", a_zm, u * u)
        s2 = np.einsum("zm,zmk->zk", b_zm, u)
    kstar = ks.dtype.type(cfg["fixed_params"]["kstar_damping"])
    damping = 1.0 - np.exp(-((ks / kstar) ** 2))
    e = s2 + 1.0 - c_z[:, None]
    return s1 * damping[None, :] + pzk * e * e


def to_bfloat16(a):
    """a rounded to the nearest bfloat16 (ties to even), kept as float32."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    return bits.astype(np.uint32).view(np.float32)


def control_stages(theta: dict, cfg: dict) -> np.ndarray:
    """The control of the float64 part alone: the stages and mass integrals
    in float32, u(k) in the float32 it is stated in."""
    return spectra(theta, cfg, np.float32)


def control(theta: dict, cfg: dict) -> np.ndarray:
    """The control: the reference one precision below the configuration's
    (stages and sums in float32, u(k) in bfloat16)."""
    return spectra(theta, cfg, np.float32,
                   profile=lambda *args: to_bfloat16(nfw_u(*args)))
