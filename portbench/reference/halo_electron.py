"""Plain NumPy/SciPy reference of the halo-model electron spectra that the
configuration ``electron_fast_serving`` serves: the electron auto spectrum
Pee(z, k) and its cross with matter Pme(z, k), stacked (2, nz, nk).

Written from the published formulas, in the structure of hmvec's
``HaloModel.add_battaglia_profile("electron")`` and ``get_power``; it
imports nothing of the program.  The background, linear power, sigma^2,
Sheth-Tormen n(z, m) and bias, Duffy's virial concentration with r_vir and
the truncated NFW u(k) of the matter leg come from ``halo_pmm``; this file
adds the electron profile:

* M200c from the virial mass by the NFW mass-definition conversion: solve
  M1 / F(c1) = M2 / F(c2), c2 = c1 ((M2 / M1)(Delta_v / 200))^(1/3),
  F(c) = ln(1 + c) - c / (1 + c), by bisection on ln M2 over
  ln M1 -+ 10 (90 halvings: the bracket shrinks below float64 resolution);
* Battaglia et al. 2016's gas density on x = r / (R200 / 2):
  rho(x) = (Omega_b / Omega_m) rho_crit(z) rho0 x^gamma
  (1 + x^alpha)^(-(beta + gamma) / alpha), each of rho0, alpha, beta
  A0 (M200 / 1e14)^alpham (1 + z)^alphaz, the exponent's sign on gamma as
  hmvec writes it; truncated at c = r_vir / (R200 / 2);
* the sine transform on hmvec's sample grid: xs = linspace(0, xmax,
  nxs + 1)[1:], u(kt_i) = -Im rfft(rho x)_i step / kt_i / M with
  step = (xs[-1] - xs[0]) / nxs (hmvec's own step, not xmax / nxs),
  kt_i = 2 pi i / (nxs step), M the trapezoid integral of rho x^2;
* u(kt) read at kt = k r_g (1 + z), r_g = R200 / 2, by linear
  interpolation on the uniform kt grid: flat at u(kt_1) below it, zero
  above its last point;
* Pee = int n (m/rho)^2 u_e^2 (1 - exp(-(k/k*)^2))
  + P_lin (int n b (m/rho) u_e + 1 - int n b (m/rho))^2, Pme the same with
  one u_e and one u_nfw, the integrals by the trapezoid rule over m.

``spectra`` in float64 is the reference.  ``control`` is the same
arithmetic one precision below what the configuration states: the stages,
the profile's exponent, its mass norm and the mass integrals (stated in
float64) in float32, and the profile samples, their transform, the u(kt)
table and the matter leg's u(k) (stated in float32) rounded to bfloat16.
``control_stages`` lowers only what is stated in float64 to float32.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.halo_pmm import (Background, _mass_sums, grids,
                                          halo_inputs, kernel_inputs,
                                          nfw_rows, nfw_u, to_bfloat16)

__all__ = ["grids", "kernel_inputs", "transform_inputs", "spectra",
           "control", "control_stages"]


def fcon(c):
    return np.log(1.0 + c) - c / (1.0 + c)


def m200_from_mvir(ms, cs, delta_v, n_iter=90, log_bracket=10.0):
    """M200c (nz, nm) of the virial masses ms (nm,) with concentrations
    cs (nz, nm) and Bryan & Norman's Delta_v (nz,), both overdensities
    with respect to the critical density."""
    m1 = np.broadcast_to(ms, cs.shape)
    ln_m1 = np.log(m1)
    ratio = (delta_v / 200.0)[:, None]
    target = m1 / fcon(cs)

    def excess(ln_m2):
        c2 = cs * (np.exp(ln_m2 - ln_m1) * ratio) ** (1.0 / 3.0)
        return target - np.exp(ln_m2) / fcon(c2)

    lo, hi = ln_m1 - log_bracket, ln_m1 + log_bracket
    for _ in range(n_iter):
        mid = (lo + hi) / 2.0
        right = excess(mid) > 0.0
        lo, hi = np.where(right, mid, lo), np.where(right, hi, mid)
    return np.exp((lo + hi) / 2.0)


def sample_grid(xmax, nxs):
    """(xs, step, dkt, kt) of hmvec's sample grid; kt[0] = 1, never read."""
    xs = np.linspace(0.0, xmax, nxs + 1)[1:]
    step = (xs[-1] - xs[0]) / nxs
    dkt = 2.0 * np.pi / (nxs * step)
    kt = np.arange(nxs // 2 + 1, dtype=np.float64) * dkt
    kt[0] = 1.0
    return xs, step, dkt, kt


def gas_rows(theta: dict, cfg: dict, dtype=np.float64):
    """The electron profile's rows for one cosmology: (r_g (1 + z),
    c = r_vir / r_g, M200, rho_crit(z), Omega_b / Omega_m), the first three
    on (nz, nm)."""
    fixed = cfg["fixed_params"]
    zs, ms, _ = (np.asarray(a, dtype=dtype) for a in grids(cfg))
    bg = Background(theta, fixed, dtype)
    rho_c = bg.rho_crit(zs)
    xv = bg.rho_m(zs) / rho_c - 1.0
    delta_v = 18.0 * np.pi**2 + 82.0 * xv - 39.0 * xv**2
    nfw_scales, cs = nfw_rows(bg, zs, ms, fixed)
    rvir = nfw_scales / (1.0 + zs[:, None]) * cs
    m200 = m200_from_mvir(ms, cs, delta_v)
    r200 = (3.0 * m200 / (4.0 * np.pi) / 200.0 / rho_c[:, None]) ** (1.0 / 3.0)
    rg = r200 / 2.0
    omb = bg.ombh2 / bg.h**2
    return rg * (1.0 + zs[:, None]), rvir / rg, m200, rho_c, omb / bg.omm0


def transform_inputs(theta: dict, cfg: dict) -> dict:
    """What the resample kernel is given for one cosmology, worked out here:
    the rows' scales r_g (1 + z) (nz, nm), the kt grid's step dkt and
    length nkt, and the targets ks."""
    opts = cfg["options"]
    _, _, dkt, kt = sample_grid(float(opts["xmax"]), int(opts["nxs"]))
    scales = gas_rows(theta, cfg)[0]
    return {"scales": scales, "dkt": dkt, "nkt": kt.size,
            "ks": grids(cfg)[2]}


def battaglia_rho(x, m200, z, rho_c, omb_omm, cfg, dtype):
    """Battaglia 2016's gas density, of the configuration's fit family, on
    x (nx,) for the rows (nm,) of one redshift z: (nm, nx)."""
    fixed = cfg["fixed_params"]
    fit = fixed["battaglia_gas_fit"][cfg["options"]["family"]]

    def par(name):
        return (dtype(fit[f"{name}_A0"])
                * (m200 / dtype(1.0e14)) ** dtype(fit[f"{name}_alpham"])
                * (1.0 + z) ** dtype(fit[f"{name}_alphaz"]))

    gamma = dtype(fixed["battaglia_gas_gamma"])
    rho0, alpha, beta = par("rho0"), par("alpha"), par("beta")
    lnx = np.log(x)[None, :]
    shape = (gamma * lnx - ((beta + gamma) / alpha)[:, None]
             * np.log1p(np.exp(alpha[:, None] * lnx)))
    return (omb_omm * rho_c * rho0)[:, None] * np.exp(shape)


def electron_uk(theta: dict, cfg: dict, dtype=np.float64, low=None):
    """u_e(z, m, k) (nz, nm, nk) of one cosmology: the profile sampled,
    masked at c, sine-transformed, divided by kt and its mass, and read at
    k r_g (1 + z).  ``low`` rounds the samples, their transform and the
    table (the control's bfloat16)."""
    opts = cfg["options"]
    rnd = (lambda a: a) if low is None else low
    xs64, step, dkt, kt = sample_grid(float(opts["xmax"]), int(opts["nxs"]))
    scales, cmax, m200, rho_c, omb_omm = gas_rows(theta, cfg, dtype)
    zs = grids(cfg)[0].astype(dtype)
    ks = grids(cfg)[2].astype(dtype)
    xs, kt, nkt = xs64.astype(dtype), kt.astype(dtype), kt.size
    out = np.empty(cmax.shape + ks.shape, dtype)
    for iz in range(zs.size):
        inside = xs64[None, :] <= cmax[iz][:, None]
        rho = rnd(np.where(inside, battaglia_rho(
            xs, m200[iz], zs[iz], rho_c[iz], omb_omm, cfg, dtype), 0.0)
            .astype(dtype))
        prof = rho * xs**2
        mass = ((prof[:, 1:] + prof[:, :-1]) * np.diff(xs) / 2.0).sum(-1)
        ukt = rnd((-np.fft.rfft(rnd(rho * xs)).imag * step).astype(dtype))
        table = rnd((ukt / kt).astype(dtype))
        p = ks[None, :] * scales[iz][:, None] / dtype(dkt)
        i0f = np.clip(np.floor(p), 1, nkt - 2)
        frac = p - i0f
        i0 = i0f.astype(np.int64)
        u0 = np.take_along_axis(table, i0, -1)
        u1 = np.take_along_axis(table, i0 + 1, -1)
        val = np.where(p < 1.0, table[:, 1:2], u0 + frac * (u1 - u0))
        out[iz] = np.where(p > nkt - 1.0, 0.0, val) / mass[:, None]
    return out


def spectra(theta: dict, cfg: dict, dtype=np.float64, low=None
            ) -> np.ndarray:
    """(Pee, Pme) stacked, shape (2, nz, nk), of one cosmology under
    configuration ``cfg``, in precision ``dtype``; ``low`` rounds the
    float32 parts of the profiles (the control's bfloat16)."""
    zs, ks, ms, pzk, nzm, bh, rho_m0, scales, cs = halo_inputs(theta, cfg,
                                                               dtype)
    nz, nm = cs.shape
    u_m = nfw_u(ks, scales.reshape(-1), cs.reshape(-1)).reshape(nz, nm, -1)
    if low is not None:
        u_m = low(u_m)
    u_e = electron_uk(theta, cfg, dtype, low)
    a_zm, b_zm, c_z = _mass_sums(ms, nzm, bh, rho_m0)
    kstar = ks.dtype.type(cfg["fixed_params"]["kstar_damping"])
    damping = (1.0 - np.exp(-((ks / kstar) ** 2)))[None, :]
    e_e = np.einsum("zm,zmk->zk", b_zm, u_e) + 1.0 - c_z[:, None]
    e_m = np.einsum("zm,zmk->zk", b_zm, u_m) + 1.0 - c_z[:, None]
    pee = np.einsum("zm,zmk->zk", a_zm, u_e * u_e) * damping + pzk * e_e**2
    pme = np.einsum("zm,zmk->zk", a_zm, u_m * u_e) * damping + pzk * e_m * e_e
    return np.stack([pee, pme])


def control_stages(theta: dict, cfg: dict) -> np.ndarray:
    """The control of the float64 part alone: the stages, the profile's
    exponent and mass norm and the mass integrals in float32; the samples,
    their transform, the table and u_nfw in the float32 they are stated
    in."""
    return spectra(theta, cfg, np.float32)


def control(theta: dict, cfg: dict) -> np.ndarray:
    """The control: the reference one precision below the configuration's
    (float32 for what is stated in float64, bfloat16 for what is stated in
    float32)."""
    return spectra(theta, cfg, np.float32, low=to_bfloat16)
