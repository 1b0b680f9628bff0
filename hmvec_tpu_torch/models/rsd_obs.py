"""Observational redshift-space effects and forecasting on float64 tensors
(port of hmvec_tpu/models/rsd_obs.py): the TNS spectrum at pointwise
(k, mu), Alcock-Paczynski distortions of the multipoles, their Gaussian
covariance, the survey-window convolution and the detection SNR.

AP: with alpha_par = H_fid/H_true and alpha_perp = D_A_true/D_A_fid,

    k_true  = k_obs * sqrt[(mu_obs/a_par)^2 + (1-mu_obs^2)/a_perp^2],
    mu_true = (mu_obs/a_par) / sqrt[...],
    P_obs(k_obs, mu_obs) = P_s(k_true, mu_true) / (a_par a_perp^2).

Covariance (Gaussian mode counting, thin shells):

    Cov[P_l(k), P_l'(k)] = (2l+1)(2l'+1) * 2/N_k *
        int_0^1 dmu L_l L_l' [P_s(k,mu) + 1/nbar]^2,
    N_k = V k^2 dk / (2 pi^2).
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from ..ops.quadrature import linear_interp
from ..utils.weights import (call_device, device_of, f64, leggauss_cached,
                             on_device, on_device_of_inputs)
from .rsd import _fog, _legendre, _mu_nodes

_F64 = torch.float64


def _interp_rows(ks, table, kpts):
    """Linear-in-ln-k interpolation of a (nk,) table at kpts (any shape),
    flat beyond the ends."""
    dev = kpts.device
    return linear_interp(torch.log(kpts), torch.log(f64(ks, dev)),
                         f64(table, dev))


@on_device_of_inputs
def tns_pk_mu_points(kpts, mupts, ks, p_dd, p_dt, p_tt, b, f, ab,
                     sigma_v=0.0, fog="gaussian"):
    """TNS P_s at pointwise (k, mu) pairs of a common shape, the
    k-tabulated ingredients (p_dd/p_dt/p_tt on ks, ab from
    ``tns.tns_ab_integrals``) interpolated linearly in ln k: the AP
    evaluation primitive."""
    dev = torch.as_tensor(p_dd).device
    kpts = f64(kpts, dev)
    mu = f64(mupts, dev)
    pdd = _interp_rows(ks, p_dd, kpts)
    pdt = _interp_rows(ks, p_dt, kpts)
    ptt = _interp_rows(ks, p_tt, kpts)
    beta = f / b
    A = 0.0
    for (m, n), I in ab["A"].items():
        A = A + mu**m * beta**n * _interp_rows(ks, I, kpts)
    B = 0.0
    for (m, n), I in ab["B"].items():
        B = B + mu**m * beta**n * _interp_rows(ks, I, kpts)
    core = (b**2 * pdd + 2.0 * b * f * mu**2 * pdt + f**2 * mu**4 * ptt
            + b**3 * (mu * beta) * A + b**4 * (mu * beta) ** 2 * B)
    return _fog(kpts * mu, sigma_v, fog) * core


@on_device_of_inputs
def ap_shift(ks_obs, mus_obs, alpha_par, alpha_perp):
    """Observed -> true (k, mu) on the (nmu, nk) outer grid."""
    dev = device_of(ks_obs, mus_obs, alpha_par, alpha_perp)
    k = f64(ks_obs, dev)[None, :]
    mu = f64(mus_obs, dev)[:, None]
    fac = torch.sqrt((mu / alpha_par) ** 2 + (1.0 - mu**2) / alpha_perp**2)
    return k * fac, (mu / alpha_par) / fac


@on_device_of_inputs
def ap_multipoles(ks_obs, pk_mu_points_fn, alpha_par=1.0,
                  alpha_perp=1.0, ells=(0, 2, 4), n_mu=32):
    """Observed multipoles under AP distortion,

        P_l^obs(k') = (2l+1)/2 int dmu' L_l(mu')
                      P_s(k(k',mu'), mu(k',mu')) / (a_par a_perp^2),

    with pk_mu_points_fn(kpts, mupts) the true-coordinate model at points
    (e.g. a closure over ``tns_pk_mu_points``).  The work runs on the
    device of ks_obs or of a tensor alpha, else on ``device`` (the card
    unless the caller asks for the CPU)."""
    device = call_device()
    mus, w = _mu_nodes(n_mu, device)
    kt, mut = ap_shift(f64(ks_obs, device), mus, alpha_par, alpha_perp)
    ps = pk_mu_points_fn(kt, mut) / (alpha_par * alpha_perp**2)
    out = {}
    for ell in ells:
        wl = w * _legendre(ell, mus) * (2.0 * ell + 1.0) / 2.0
        out[ell] = torch.einsum("m,mk->k", wl, ps)
    return out


@on_device_of_inputs
def multipole_covariance(ks, pk_mu_points_fn, nbar, volume, dk=None,
                         ells=(0, 2, 4), n_mu=64):
    """Gaussian covariance of the multipoles in thin k-shells,
    (nl, nl, nk) in the order of ``ells``: ks the shell centers, dk their
    widths (default: from the ks' log midpoints), nbar the tracer density
    [1/Mpc^3], volume [Mpc^3].  The work runs on the device of ks or dk,
    else on ``device`` (the card unless the caller asks for the CPU)."""
    ks = f64(ks, call_device())
    device = ks.device
    if dk is None:
        lnk = torch.log(ks)
        edges = torch.cat([
            (lnk[0] - 0.5 * (lnk[1] - lnk[0]))[None],
            0.5 * (lnk[1:] + lnk[:-1]),
            (lnk[-1] + 0.5 * (lnk[-1] - lnk[-2]))[None]])
        dk = torch.exp(edges[1:]) - torch.exp(edges[:-1])
    Nk = volume * ks**2 * f64(dk, device) / (2.0 * math.pi**2)
    # GL nodes mapped to [0, 1] (the integrand is mu-even)
    mus, w = on_device(f"rsd_obs_half:{int(n_mu)}", device, lambda: (
        0.5 * (leggauss_cached(n_mu)[0] + 1.0),
        0.5 * leggauss_cached(n_mu)[1]))
    kgrid = ks[None, :].expand(mus.shape[0], ks.shape[0])
    mugrid = mus[:, None].expand(kgrid.shape)
    ptot = pk_mu_points_fn(kgrid, mugrid) + 1.0 / nbar      # (nmu, nk)
    legs = torch.stack([_legendre(ell, mus) for ell in ells])  # (nl,nmu)
    integ = torch.einsum("am,bm,m,mk->abk", legs, legs, w, ptot**2)
    pref = f64([(2 * ell + 1) for ell in ells], device)
    return (pref[:, None, None] * pref[None, :, None]
            * 2.0 / Nk[None, None, :] * integ)


def threej000_sq(l1, l2, l3):
    """Exact (l1 l2 l3; 0 0 0)^2 Wigner-3j square as a Fraction (Racah's
    closed form; zero unless the triangle holds and l1+l2+l3 is even)."""
    from math import factorial
    L = l1 + l2 + l3
    if L % 2 or abs(l1 - l2) > l3 or l3 > l1 + l2:
        return Fraction(0)
    g = L // 2
    num = (factorial(L - 2 * l1) * factorial(L - 2 * l2)
           * factorial(L - 2 * l3))
    pre = Fraction(num, factorial(L + 1))
    w = Fraction(factorial(g), factorial(g - l1) * factorial(g - l2)
                 * factorial(g - l3))
    return pre * w * w


def window_coupling(ells_out=(0, 2, 4), ells_in=(0, 2, 4),
                    ells_win=(0, 2, 4, 6, 8)):
    """The plane-parallel window mixing coefficients
    C[l, l1, l2] = (2l+1) (l l1 l2; 0 0 0)^2 (Wilson et al. 2017 eqs
    2.18-2.20), as a numpy array (n_out, n_in, n_win)."""
    C = np.zeros((len(ells_out), len(ells_in), len(ells_win)))
    for a, l in enumerate(ells_out):
        for b, l1 in enumerate(ells_in):
            for c, l2 in enumerate(ells_win):
                C[a, b, c] = float((2 * l + 1) * threej000_sq(l, l1, l2))
    return C


@on_device_of_inputs
def window_convolve_multipoles(ks, pk_ells, ss_win, q_ells,
                               ells_out=(0, 2, 4), ks_out=None):
    """Survey-window convolution of power-spectrum multipoles with a
    global line of sight:

        P_l(k) --FFTLog--> xi_l(s) --mix with Q_l2(s)--> xi_hat_l(s)
               --FFTLog--> P_hat_l(k)

    pk_ells {l: (nk,)} on the log-uniform numpy grid ks; the window
    multipoles q_ells {l: (ns,)} on ss_win, interpolated onto the FFTLog
    s grid (the first value to the left, zero to the right).  Returns
    {l: (nk,)} on ks_out (default: ks)."""
    from ..ops.fftlog import fftlog_lnkr, fftlog_sphbessel_jl
    from .rsd import correlation_multipoles
    ks = np.asarray(ks, dtype=np.float64)
    ks_out = ks if ks_out is None else np.asarray(ks_out, dtype=np.float64)
    ells_in = tuple(sorted(pk_ells))
    ells_win = tuple(sorted(q_ells))
    ss, xi = correlation_multipoles(ks, pk_ells)
    dev = ss.device
    lnss = torch.log(ss)
    Q = {}
    for l2 in ells_win:
        q = f64(q_ells[l2], dev)
        Q[l2] = linear_interp(lnss, torch.log(f64(ss_win, dev)), q,
                              left=q[0], right=0.0)
    C = window_coupling(ells_out, ells_in, ells_win)
    ss_np = ss.cpu().numpy()
    lnkr0 = fftlog_lnkr(ss_np, mu=0.5)
    out = {}
    for a, l in enumerate(ells_out):
        xihat = 0.0
        for b, l1 in enumerate(ells_in):
            for c, l2 in enumerate(ells_win):
                if C[a, b, c] != 0.0:
                    xihat = xihat + C[a, b, c] * xi[l1] * Q[l2]
        kk, F = fftlog_sphbessel_jl(xihat, ss_np, l, lnkr=lnkr0)
        # P_l(k) = 4 pi (-i)^l int xi_l j_l(ks) s^2 ds, l even
        Pl = 4.0 * math.pi * (-1.0) ** (l // 2) * F
        out[l] = linear_interp(torch.log(f64(ks_out, dev)), torch.log(kk), Pl)
    return out


@on_device_of_inputs
def multipole_snr(mp, cov, ells=(0, 2, 4)):
    """Total detection SNR of the multipoles against a covariance
    block-diagonal in k: sqrt(sum_k P_l(k) C^-1_{ll'}(k) P_l'(k))."""
    P = torch.stack([torch.as_tensor(mp[ell], dtype=_F64) for ell in ells])
    C = torch.movedim(f64(cov, P.device), -1, 0)          # (nk, nl, nl)
    Pk = torch.movedim(P, -1, 0)                          # (nk, nl)
    sol = torch.linalg.solve(C, Pk[..., None])[..., 0]
    return torch.sqrt(torch.sum(Pk * sol))
