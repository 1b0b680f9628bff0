"""SZ cluster counts through an observable-mass relation, and their
covariance, on float64 tensors (port of hmvec_tpu/models/cluster_counts.py).

A lognormal Y-M relation with intrinsic scatter,

    ln Ybar(M, z) = ln Y* + alpha ln(M / Mpivot) + beta ln E(z),

and a detection threshold q sigma_N(z) give the completeness

    chi(M, z) = 1/2 erfc([ln(q sigma_N) - ln Ybar] / (sqrt(2) sigma)),

and the detected counts dN/dz = fsky 4 pi chi^2 / H int dm n chi(M, z).
An SNR bin [q_i, q_i+1) takes the difference of two survival functions.
The binned count covariance is Poisson plus sample variance, with the
background mode's covariance between the redshift bins' survey windows
(``window_sigma2``, Hu & Kravtsov 2003, Lima & Hu 2004).

Every mass and redshift reduction is a trapezoid on the grids: the
weights are made on the host from numpy grids, or on the device from
tensor grids (``utils.weights.grid_weights``, the same arithmetic).  The scaling
parameters and sigma_N may be tensors that carry gradients; an infinite q
edge gives survival 0 with a zero gradient (a double ``where``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.quadrature import lerp_index, linear_interp
from ..ops.special import disk_window
from ..utils.weights import (device_of, f64, grid_weights, host,
                             on_device, trapz_weights)

_F64 = torch.float64

# Planck 2013 XX baseline values (Eq. 7, Table 1); every one may be given
DEFAULT_SCALING = {
    "lnYstar": np.log(1e-4),
    "alpha": 1.79,
    "beta": 2.0 / 3.0,
    "Mpivot": 6e14,
    "sigma_lnY": 0.127 * np.log(10.0),
}


def _scaling(lnYstar, alpha, beta, Mpivot, sigma_lnY=0.0):
    d = DEFAULT_SCALING
    return (d["lnYstar"] if lnYstar is None else lnYstar,
            d["alpha"] if alpha is None else alpha,
            d["beta"] if beta is None else beta,
            d["Mpivot"] if Mpivot is None else Mpivot,
            d["sigma_lnY"] if sigma_lnY is None else sigma_lnY)


def ln_ybar(ms, ez, lnYstar, alpha, beta, Mpivot):
    """ln Ybar(M, z) on the (z, m) grid; ``ez`` is E(z) = H(z) / H0."""
    dev = device_of(ez, ms)
    lms = torch.log(f64(ms, dev) / Mpivot)[None, :]
    return lnYstar + alpha * lms + beta * torch.log(f64(ez, dev))[:, None]


def completeness(ms, ez, q, sigma_noise, lnYstar=None, alpha=None, beta=None,
                 Mpivot=None, sigma_lnY=None, sigma_meas_ln=0.0):
    """Detection probability chi(M, z) above SNR ``q``, (nz, nm) in [0, 1].

    ``sigma_noise``: the survey noise sigma_N(z) in Y units, a scalar or
    (nz,); ``sigma_meas_ln``: an extra lognormal measurement scatter, in
    quadrature with ``sigma_lnY``."""
    lnYstar, alpha, beta, Mpivot, sigma_lnY = _scaling(
        lnYstar, alpha, beta, Mpivot, sigma_lnY)
    dev = device_of(ez, ms, sigma_noise, alpha, sigma_lnY)
    lnyb = ln_ybar(ms, ez, lnYstar, alpha, beta, Mpivot)
    sig = torch.sqrt(f64(sigma_lnY, dev) ** 2 + f64(sigma_meas_ln, dev) ** 2)
    lim = torch.log(q * torch.atleast_1d(f64(sigma_noise, dev)))[..., None]
    # an infinite threshold gives survival 0 and a zero gradient: the
    # plain path would chain d/dsigma erfc((inf - lnyb) / sigma) into NaN
    finite = torch.isfinite(lim)
    lim_safe = torch.where(finite, lim, 0.0)
    surv = 0.5 * torch.special.erfc((lim_safe - lnyb)
                                    / (math.sqrt(2.0) * sig))
    return torch.where(finite, surv, 0.0)


def _dvdz(chis, hzs, dev):
    return 4.0 * math.pi * f64(chis, dev) ** 2 / f64(hzs, dev)


def dndz_detected(zs, ms, nzm, chis, hzs, ez, q, sigma_noise, fsky=1.0,
                  **scaling):
    """(dN/dz, N_total) of detected clusters; ``nzm`` (nz, nm) the mass
    function, ``chis``/``hzs`` chi and H(z) [1/Mpc] on ``zs``, ``ez`` =
    E(z).  The sharp-threshold limit recovers HaloModel.cluster_counts
    with mmin = M_lim(z)."""
    dev = nzm.device
    comp = completeness(ms, ez, q, sigma_noise, **scaling)
    n_of_z = (nzm * comp) @ grid_weights(ms, dev)
    dndz = fsky * _dvdz(chis, hzs, dev) * n_of_z
    return dndz, dndz @ grid_weights(zs, dev)


def counts_q_bins(zs, ms, nzm, chis, hzs, ez, q_edges, sigma_noise,
                  fsky=1.0, z_edges=None, **scaling):
    """Expected counts per (z, SNR) bin: ``q_edges`` (nq+1,), the last may
    be inf; without ``z_edges`` the (nz, nq) dN/dz grid, with them the
    (nzbin, nq) counts, each bin a trapezoid over the grid points it holds
    (a bin with fewer than two gives zeros)."""
    dev = nzm.device
    wm = grid_weights(ms, dev)
    dvdz = _dvdz(chis, hzs, dev)
    # (nq+1, nz, nm) survival stack -> (nq, nz, nm) bin probabilities
    S = torch.stack([completeness(ms, ez, float(q), sigma_noise, **scaling)
                     for q in np.asarray(q_edges, dtype=np.float64)])
    Pbin = S[:-1] - S[1:]
    dndz_q = fsky * dvdz[None, :] * ((nzm[None] * Pbin) @ wm)
    dndz_q = dndz_q.movedim(0, -1)                           # (nz, nq)
    if z_edges is None:
        return dndz_q
    zs = host(zs)
    z_edges = np.asarray(z_edges, dtype=np.float64)
    rows = []
    for lo, hi in zip(z_edges[:-1], z_edges[1:]):
        idx = np.nonzero((zs >= lo) & (zs < hi))[0]
        if idx.size > 1:
            sel = dndz_q.index_select(0, torch.as_tensor(idx, device=dev))
            rows.append(sel.movedim(0, -1) @ f64(trapz_weights(zs[idx]), dev))
        else:
            rows.append(torch.zeros(dndz_q.shape[1], dtype=_F64, device=dev))
    return torch.stack(rows)                                 # (nzbin, nq)


def mass_limit(zs, ez, q, sigma_noise, lnYstar=None, alpha=None, beta=None,
               Mpivot=None, **_ignored):
    """The sharp-threshold detection mass M_lim(z), Ybar(M_lim, z) =
    q sigma_N: the sigma -> 0 limit of the completeness is a step there."""
    del zs
    lnYstar, alpha, beta, Mpivot, _ = _scaling(lnYstar, alpha, beta, Mpivot)
    dev = device_of(ez, sigma_noise)
    lim = torch.log(q * torch.atleast_1d(f64(sigma_noise, dev)))
    lnm = (lim - lnYstar - beta * torch.log(f64(ez, dev))) / alpha
    return Mpivot * torch.exp(lnm)


# ---- sample variance -------------------------------------------------------

def _sinc(x):
    """sin(x) / x with a Taylor guard at the origin."""
    small = torch.abs(x) < 1e-6
    xs = torch.where(small, 1.0, x)
    return torch.where(small, 1.0 - x**2 / 6.0, torch.sin(xs) / xs)


def _interp_loglog_rows(ks, P_rows, K):
    """Each row of P_rows (nb, nk) at the shared queries K (nq,), linear in
    (ln k, ln P), flat-clipped at the ends; P guarded at 1e-300."""
    dev = P_rows.device
    lks = torch.log(f64(ks, dev))
    lnP = torch.log(torch.clamp(P_rows, min=1e-300))
    i, t = lerp_index(lks, torch.log(K))
    p0 = lnP[:, i]
    p1 = lnP[:, i + 1]
    return torch.exp(p0 + t[None, :] * (p1 - p0))


def _window_grids(n_kr, kr_max, n_kperp, kperp_max, dev):
    """The radial (linear) and transverse (log) wavenumber grids of
    window_sigma2 with their trapezoid weights, on ``dev`` once."""
    def make():
        kr = np.linspace(0.0, kr_max, n_kr)
        kp = np.geomspace(1e-5, kperp_max, n_kperp)
        return kr, trapz_weights(kr), kp, trapz_weights(kp)
    return on_device(f"window_sigma2:{n_kr}:{kr_max}:{n_kperp}:{kperp_max}",
                     dev, make)


def window_sigma2(zedges, zs, chis, ks_lin, plin, fsky,
                  n_kr=2048, kr_max=0.3, n_kperp=257, kperp_max=2.0):
    """Covariance sigma^2_ij of the volume-averaged background density
    between redshift-bin survey windows (the sample-variance kernel of the
    counts):

      sigma^2_ij = 2 int_0^inf dk_r/(2pi) cos(k_r (c_i - c_j))
                       sinc(k_r D_i/2) sinc(k_r D_j/2)
                   int dk_perp k_perp/(2pi) W_d(k_perp R_i) W_d(k_perp R_j)
                       sqrt(P_i P_j)(sqrt(k_r^2 + k_perp^2))

    for a radial top-hat over each bin's [chi_i^-, chi_i^+] (center c_i,
    width D_i) times the survey disk W_d = 2 J1(x)/x of angular radius
    arccos(1 - 2 fsky) at the bin center (R_i = c_i theta_s), P_i the
    linear power (nz, nk) on ``ks_lin`` lerped to the bin-center redshift.
    cos(k_r (c_i - c_j)) splits by the angle-difference identity, so the
    result is A W A^T + B W B^T: two (nb, n_kr n_kperp) weighted matmuls,
    no loop over bin pairs."""
    zedges = np.asarray(zedges, dtype=np.float64)
    plin = torch.atleast_2d(plin)
    dev = plin.device
    zs_t = f64(zs, dev)
    chi_e = linear_interp(f64(zedges, dev), zs_t, f64(chis, dev))
    c = 0.5 * (chi_e[1:] + chi_e[:-1])                     # (nb,) centers
    D = chi_e[1:] - chi_e[:-1]                             # (nb,) widths
    zc = f64(0.5 * (zedges[1:] + zedges[:-1]), dev)
    nb = zc.numel()
    if plin.shape[0] > 1:
        iz, tz = lerp_index(zs_t, zc)
        P_b = plin[iz] * (1.0 - tz)[:, None] + plin[iz + 1] * tz[:, None]
    else:
        P_b = plin[0][None, :].expand(nb, plin.shape[1])
    theta_s = float(np.arccos(1.0 - 2.0 * float(fsky)))
    R = c * theta_s                                        # (nb,)
    kr, wkr, kp, wkp = _window_grids(n_kr, kr_max, n_kperp, kperp_max, dev)
    K = torch.sqrt(kr[:, None] ** 2 + kp[None, :] ** 2)    # (nkr, nkp)
    Q = torch.sqrt(_interp_loglog_rows(ks_lin, P_b, K.reshape(-1)))
    Q = Q.reshape((nb,) + K.shape)                         # (nb, nkr, nkp)
    rad = _sinc(kr[None, :] * D[:, None] / 2.0)            # (nb, nkr)
    disk = disk_window(kp[None, :] * R[:, None])           # (nb, nkp)
    base = rad[:, :, None] * disk[:, None, :] * Q
    phase = kr[None, :, None] * c[:, None, None]
    Af = (base * torch.cos(phase)).reshape(nb, -1)
    Bf = (base * torch.sin(phase)).reshape(nb, -1)
    # 2x: the even-in-k_r integrand folded onto k_r >= 0
    wf = (2.0 * wkr[:, None] * (wkp * kp)[None, :]
          / (2.0 * math.pi) ** 2).reshape(-1)
    return (Af * wf[None, :]) @ Af.T + (Bf * wf[None, :]) @ Bf.T


def counts_covariance(N_i, bN_i, sigma2_ij):
    """Binned count covariance, Poisson plus sample variance:
    Cov_ij = delta_ij N_i + <bN>_i <bN>_j sigma^2_ij."""
    return torch.diag(N_i) + bN_i[:, None] * bN_i[None, :] * sigma2_ij
