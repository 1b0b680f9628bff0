"""Lensed CMB spectra resummed in the displacement variance: the flat-sky
correlation-function method on float64 tensors (port of
hmvec_tpu/models/lensed_cf.py).

For a correlation function with an e^{i n phi_l} angular factor (n = 0: T
and xi_+; n = 2: the TE cross; n = 4: xi_-), Gaussian displacements give

    xi~_n(th) = int l dl/2pi C_l e^{-l^2 sigma^2(th)/2}
                [ J_n(l th) + (l^2 C_gl,2(th)/4)
                              (J_{n-2}(l th) + J_{n+2}(l th)) ],

with sigma^2(th) = sum_l l^3 C_l^pp/2pi (1 - J_0(l th)) and C_gl,2(th) =
sum_l l^3 C_l^pp/2pi J_2(l th).  Everything is evaluated in difference
form, Delta xi_n = sum_l (l/2pi) C_l [lensed kernel - J_n], and back
transformed, Delta C_l = 2pi int th dth Delta xi_n(th) J_n(l th), so C~ is
exactly C when C_pp = 0.

The JAX package scans over chunks of 128 multipoles; here the chunks are
the same, evaluated several at a time (a group of chunks holds at most
2^23 elements per temporary) and summed in the JAX package's chunk order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import special as sp
from ..utils.weights import (call_device, leggauss_cached,
                             on_device_of_inputs)

__all__ = ["lens_cls_flat_sky_resummed", "displacement_correlations"]

_F64 = torch.float64
_CHUNK = 128
# elements of one (chunks, 128, theta) temporary: 2^23 float64 = 64 MiB
_GROUP_ELEMENTS = 2**23


def _jn_even_upto6(x):
    """(J0, J2, J4, J6)(x) for x >= 0: J0 and J1 from ``special`` (the
    Chebyshev / modulus-phase fit and its derivative), J2..J6 by the
    upward recurrence J_{k+1} = (2k/x) J_k - J_{k-1}, and below x = 0.2,
    where that recurrence loses relative accuracy, the 3-term ascending
    series (exact to ~3e-8 relative there)."""
    j0 = sp.j0(x)
    j1 = sp.j1(x)
    xs = torch.where(x > 1e-30, x, 1.0)
    inv = 1.0 / xs
    j2 = 2.0 * j1 * inv - j0
    j3 = 4.0 * j2 * inv - j1
    j4 = 6.0 * j3 * inv - j2
    j5 = 8.0 * j4 * inv - j3
    j6 = 10.0 * j5 * inv - j4

    # J_n = (x/2)^n/n! [1 - h/(n+1) + h^2/(2(n+1)(n+2))], h = x^2/4
    h = 0.25 * x * x

    def series(n, fact):
        lead = (0.5 * x) ** n / fact
        return lead * (1.0 - h / (n + 1.0)
                       + h * h / (2.0 * (n + 1.0) * (n + 2.0)))

    small = x < 0.2
    j2 = torch.where(small, series(2, 2.0), j2)
    j4 = torch.where(small, series(4, 24.0), j4)
    j6 = torch.where(small, series(6, 720.0), j6)
    return j0, j2, j4, j6


def _pad_chunks(arr, nl):
    """Zero-pad the leading l axis to a multiple of _CHUNK and reshape to
    (nchunk, _CHUNK, ...)."""
    pad = (-nl) % _CHUNK
    arr = torch.cat([arr, arr.new_zeros((pad,) + arr.shape[1:])])
    return arr.reshape((arr.shape[0] // _CHUNK, _CHUNK) + arr.shape[1:])


def _groups(nchunk, ntheta):
    """Slices of chunks evaluated together."""
    g = max(1, _GROUP_ELEMENTS // (_CHUNK * ntheta))
    return [slice(i, min(i + g, nchunk)) for i in range(0, nchunk, g)]


@on_device_of_inputs
def displacement_correlations(clpp, thetas):
    """(sigma2(th), cgl2(th), R) from raw C_l^phiphi (index = l):

    sigma2(th) = sum_l (l^3 C^pp/2pi)(1 - J0(l th)),
    cgl2(th)   = sum_l (l^3 C^pp/2pi) J2(l th),
    R = sigma2(inf)/2 = sum_l l^3 C^pp/4pi."""
    dev = call_device()
    clpp = torch.as_tensor(clpp, dtype=_F64, device=dev)
    thetas = torch.as_tensor(thetas, dtype=_F64, device=dev)
    nl = clpp.shape[0]
    ls = torch.arange(nl, dtype=_F64, device=dev)
    w = ls**3 * clpp / (2.0 * math.pi)
    lc, wc = _pad_chunks(ls, nl), _pad_chunks(w, nl)
    sig2 = torch.zeros_like(thetas)
    cgl2 = torch.zeros_like(thetas)
    for g in _groups(lc.shape[0], thetas.shape[0]):
        x = lc[g, :, None] * thetas                   # (c, chunk, nth)
        j0, j2, _, _ = _jn_even_upto6(x)
        a = (wc[g, None, :] @ (1.0 - j0))[:, 0]       # (c, nth)
        b = (wc[g, None, :] @ j2)[:, 0]
        for i in range(a.shape[0]):
            sig2 = sig2 + a[i]
            cgl2 = cgl2 + b[i]
    return sig2, cgl2, 0.5 * torch.sum(w)


def _delta_xis(cl_tt, cl_ee, cl_bb, cl_te, thetas, sig2, cgl2):
    """The difference correlation functions (Delta xi_T, xi_+, xi_-,
    xi_X) on the theta grid; cl_* integer-l tensors (l = 0, 1 ignored)."""
    dev = cl_tt.device
    nl = cl_tt.shape[0]
    ls = torch.arange(nl, dtype=_F64, device=dev)
    lw = torch.where(ls >= 2.0, ls / (2.0 * math.pi), 0.0)
    wt = lw * cl_tt
    wp = lw * (cl_ee + cl_bb)
    wm = lw * (cl_ee - cl_bb)
    wx = lw * cl_te
    lc = _pad_chunks(ls, nl)
    stack = _pad_chunks(torch.stack([wt, wp, wm, wx], dim=-1), nl)
    acc = [torch.zeros_like(thetas) for _ in range(4)]
    for g in _groups(lc.shape[0], thetas.shape[0]):
        lsc = lc[g, :, None]                          # (c, chunk, 1)
        wsc = stack[g]                                # (c, chunk, 4)
        x = lsc * thetas
        j0, j2, j4, j6 = _jn_even_upto6(x)
        damp = torch.exp(-0.5 * lsc**2 * sig2)
        q = 0.25 * lsc**2 * cgl2
        # n = 0 (T and xi_+): J0 + 2q J2; n = 4: J4 + q (J2 + J6);
        # n = 2 (X): J2 + q (J0 + J4)
        k0 = damp * (j0 + 2.0 * q * j2) - j0
        k4 = damp * (j4 + q * (j2 + j6)) - j4
        k2 = damp * (j2 + q * (j0 + j4)) - j2
        parts = [(wsc[:, None, :, c] @ k)[:, 0]       # (c, nth)
                 for c, k in enumerate((k0, k0, k4, k2))]
        for i in range(x.shape[0]):
            acc = [a + p[i] for a, p in zip(acc, parts)]
    return tuple(acc)


def _back_transform(d_xis, thetas, wthetas, lmax_out):
    """Delta C_l = 2pi int th dth Delta xi_n(th) J_n(l th) for the four
    channels (n = 0, 0, 4, 2)."""
    dt, dp, dm, dx = d_xis
    tw = thetas * wthetas
    ls = torch.arange(lmax_out + 1, dtype=_F64, device=thetas.device)
    lc = _pad_chunks(ls, ls.shape[0])
    rows = []
    for g in _groups(lc.shape[0], thetas.shape[0]):
        x = lc[g, :, None] * thetas
        j0, j2, j4, _ = _jn_even_upto6(x)
        rows.append((2.0 * math.pi) * torch.stack(
            [j0 @ (tw * dt), j0 @ (tw * dp), j4 @ (tw * dm),
             j2 @ (tw * dx)], dim=-1))                # (c, chunk, 4)
    out = torch.cat(rows).reshape(-1, 4)[:lmax_out + 1]
    return out.unbind(-1)


@on_device_of_inputs
def lens_cls_flat_sky_resummed(cl_unlensed, clpp, lmax_out=None,
                               n_theta: int = 8192, theta_max=np.pi):
    """Lensed (lmax_out+1, 4) [TT, EE, BB, TE] from unlensed scalar C_l,
    resummed in sigma^2 (first order in C_gl,2): cl_unlensed (lmax_in+1,
    4) raw C_l, clpp (lmax_pp+1,) raw C_phiphi.  The theta quadrature is
    Gauss-Legendre on [0, theta_max]; n_theta must resolve ~2 lmax_in
    theta_max / pi oscillation pairs (the default handles lmax ~ 3500)."""
    dev = call_device()
    cl_unlensed = torch.as_tensor(cl_unlensed, dtype=_F64, device=dev)
    clpp = torch.as_tensor(clpp, dtype=_F64, device=dev)
    lmax_in = cl_unlensed.shape[0] - 1
    if lmax_out is None:
        lmax_out = lmax_in
    t_np, w_np = leggauss_cached(n_theta)
    thetas = torch.as_tensor(0.5 * float(theta_max) * (t_np + 1.0),
                             device=dev)
    wthetas = torch.as_tensor(0.5 * float(theta_max) * w_np, device=dev)

    sig2, cgl2, _ = displacement_correlations(clpp, thetas)
    d_xis = _delta_xis(cl_unlensed[:, 0], cl_unlensed[:, 1],
                       cl_unlensed[:, 2], cl_unlensed[:, 3],
                       thetas, sig2, cgl2)
    dct, dcp, dcm, dcx = _back_transform(d_xis, thetas, wthetas, lmax_out)

    base = cl_unlensed[:lmax_out + 1]
    keep = (torch.arange(lmax_out + 1, device=dev) >= 2)[:, None]
    out = torch.stack([
        base[:, 0] + dct,
        base[:, 1] + 0.5 * (dcp + dcm),
        base[:, 2] + 0.5 * (dcp - dcm),
        base[:, 3] + dcx,
    ], dim=-1)
    return torch.where(keep, out, 0.0)
