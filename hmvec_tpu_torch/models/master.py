"""Pseudo-C_l (MASTER) mode coupling for masked survey spectra on float64
tensors (port of hmvec_tpu/models/master.py).

On a cut sky the measured spectrum mixes the true one, <C~_l1> =
sum_l2 M_{l1 l2}[W] C_l2 (Hivon et al. 2002).  With

    int_{-1}^{1} d^{l1}_{m1 n1} d^{l2}_{m2 n2} d^{l3}_{m3 n3} dx
        = 2 (l1 l2 l3; m1 m2 m3)(l1 l2 l3; n1 n2 n3),

every sum over the mask's l3 collapses to one x integral of the mask
correlation function xi_W(x) = sum_l3 (2l3+1)/(4pi) W_l3 P_l3(x) against
two Wigner-d tables:

    M^{mn}_{l1 l2} = (2 l2 + 1) * 1/2 int dx xi_W(x) d^{l1}_{mn} d^{l2}_{mn},

exact with Gauss-Legendre on (2 lmax + lmax_mask)/2 + 1 nodes, and one
(L, Q) x (Q, L) matrix product against the d-tables of
``shear.wigner_d_rows``.  The spin-2 matrices split by parity from the
d_{2,2} / d_{2,-2} pair; M^{02} uses d_{2,0}.  The work runs on the
device of the mask spectrum (or spectra) when a tensor, else on
``device``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.weights import (call_device, leggauss_cached,
                             on_device_of_inputs, tensor_or_f64)
from .shear import wigner_d_rows

_F64 = torch.float64


def _gl_nodes(lmax, lmax_mask, device):
    """Gauss-Legendre nodes and weights exact for the coupling integrand
    (degree 2 lmax + lmax_mask)."""
    q = (2 * int(lmax) + int(lmax_mask)) // 2 + 1
    xs, ws = leggauss_cached(q)
    return (torch.tensor(xs, dtype=_F64, device=device),
            torch.tensor(ws, dtype=_F64, device=device))


@on_device_of_inputs
def mask_correlation(mask_cl, xs):
    """xi_W(x) = sum_l3 (2l3+1)/(4pi) W_l3 P_l3(x) at the nodes xs."""
    dev = call_device()
    mask_cl = torch.as_tensor(mask_cl, dtype=_F64, device=dev)
    lmax_mask = mask_cl.shape[0] - 1
    P = wigner_d_rows(lmax_mask, torch.as_tensor(xs, dtype=_F64, device=dev),
                      (0, 0))                               # (l3, Q)
    l3 = torch.arange(lmax_mask + 1, dtype=_F64, device=dev)
    return ((2.0 * l3 + 1.0) / (4.0 * math.pi) * mask_cl) @ P


def _coupling_parts(lmax, mask_cl):
    """(nodes, weights x xi_W) of the coupling quadrature."""
    dev = call_device()
    mask_cl = torch.as_tensor(mask_cl, dtype=_F64, device=dev)
    xs, ws = _gl_nodes(lmax, mask_cl.shape[0] - 1, dev)
    return xs, ws * mask_correlation(mask_cl, xs)


@on_device_of_inputs
def coupling_matrix(lmax, mask_cl, spins=(0, 0)):
    """Mode-coupling matrix (or matrices) on l = 0..lmax for one spin
    pairing: (0, 0) M^{00}; (0, 2) M^{02}; (2, 2) {'++': M_EExEE (=
    BBxBB), '--': M_EExBB}.  <C~_l1> = sum_l2 M_{l1 l2} C_l2 with the
    (2l2+1) convention of Hivon et al. 2002, so the full-sky mask W_l =
    4 pi delta_{l0} gives the identity."""
    xs, wxi = _coupling_parts(lmax, mask_cl)
    twol2p1 = 2.0 * torch.arange(lmax + 1, dtype=_F64, device=xs.device) + 1.0

    def quad(mn):
        D = wigner_d_rows(lmax, xs, mn)                     # (l, Q)
        # (2l2+1)/2 * sum_q w_q xi_q D[l1,q] D[l2,q]
        return 0.5 * (D * wxi[None, :]) @ D.T * twol2p1[None, :]

    s = tuple(sorted(abs(int(v)) for v in spins))
    if s == (0, 0):
        return quad((0, 0))
    if s == (0, 2):
        return quad((2, 0))
    if s == (2, 2):
        A = quad((2, 2))
        B = quad((2, -2))
        return {"++": 0.5 * (A + B), "--": 0.5 * (A - B)}
    raise ValueError(f"unsupported spin pairing {spins}; use (0,0), "
                     f"(0,2) or (2,2)")


def _as(M, x):
    return torch.as_tensor(x, dtype=_F64, device=M.device)


def _matrices(M):
    """A coupling matrix, or the spin-2 dict of them, as tensors."""
    if isinstance(M, dict):
        return {key: tensor_or_f64(m) for key, m in M.items()}
    return tensor_or_f64(M)


@on_device_of_inputs
def couple_cls(M, cls):
    """The pseudo-spectrum C~ = M @ C, or the (EE, BB) pair mixing for
    M = {'++', '--'} with cls = (cl_ee, cl_bb)."""
    M = _matrices(M)
    if isinstance(M, dict):
        cl_ee, cl_bb = (_as(M["++"], c) for c in cls)
        return (M["++"] @ cl_ee + M["--"] @ cl_bb,
                M["++"] @ cl_bb + M["--"] @ cl_ee)
    return M @ _as(M, cls)


@on_device_of_inputs
def bin_operator(lmax, edges, weights=None):
    """(B, P): bandpower binning (nb, lmax+1), averaging C_l over the bands
    [edges[i], edges[i+1]) with flat weights or w_l within each band, and
    the piecewise-constant spread back (lmax+1, nb); B @ P = I.  Built on
    the host, returned on the call's device."""
    dev = call_device()
    edges = np.asarray(edges, dtype=np.int64)
    ls = np.arange(lmax + 1)
    w = (np.ones(lmax + 1) if weights is None
         else np.asarray(torch.as_tensor(weights).cpu(), dtype=np.float64))
    nb = edges.size - 1
    B = np.zeros((nb, lmax + 1))
    P = np.zeros((lmax + 1, nb))
    for i in range(nb):
        sel = (ls >= edges[i]) & (ls < edges[i + 1])
        wi = w * sel
        B[i] = wi / wi.sum()
        P[sel, i] = 1.0
    return (torch.as_tensor(B, dtype=_F64, device=dev),
            torch.as_tensor(P, dtype=_F64, device=dev))


@on_device_of_inputs
def decouple_bandpowers(M, pseudo_cl, lmax, edges, weights=None):
    """MASTER-decoupled bandpowers, the solution of (B M P) c_b = B C~;
    for the spin-2 dict, pseudo_cl = (EE~, BB~) and the coupled 2-block
    system is solved."""
    M = _matrices(M)
    M0 = M["++"] if isinstance(M, dict) else M
    B, P = bin_operator(lmax, edges, weights, device=M0.device)
    if isinstance(M, dict):
        mpp = B @ M["++"] @ P
        mmm = B @ M["--"] @ P
        nb = mpp.shape[0]
        big = torch.cat([torch.cat([mpp, mmm], 1),
                         torch.cat([mmm, mpp], 1)], 0)
        rhs = torch.cat([B @ _as(M0, pseudo_cl[0]), B @ _as(M0, pseudo_cl[1])])
        sol = torch.linalg.solve(big, rhs)
        return sol[:nb], sol[nb:]
    return torch.linalg.solve(B @ M @ P, B @ _as(M, pseudo_cl))


@on_device_of_inputs
def coupling_kernel_xi(lmax, mask_cl):
    """Xi_{l1 l2} = sum_l3 (2l3+1)/(4pi) W_l3 (l1 l2 l3; 0 0 0)^2: the
    coupling matrix without the (2l2+1) factor (symmetric), the per-mode
    kernel of the NKA Gaussian covariance."""
    xs, wxi = _coupling_parts(lmax, mask_cl)
    D = wigner_d_rows(lmax, xs, (0, 0))
    return 0.5 * (D * wxi[None, :]) @ D.T


@on_device_of_inputs
def gaussian_covariance_nka(lmax, mask_sq_cl, cl13, cl24, cl14, cl23):
    """Mode-coupled Gaussian covariance of two masked pseudo-spectra in
    the narrow-kernel approximation (Efstathiou 2004),

        Cov(C~^{12}_l, C~^{34}_l') ~= Xi_{ll'}[W_{w^2}]
            x ( C13_l C24_l' + C13_l' C24_l
              + C14_l C23_l' + C14_l' C23_l ) / 2,

    for four fields sharing one mask w (``mask_sq_cl``: the power
    spectrum of w^2; spectra with noise)."""
    dev = call_device()
    Xi = coupling_kernel_xi(lmax, torch.as_tensor(mask_sq_cl, dtype=_F64,
                                                  device=dev))
    cl13, cl24, cl14, cl23 = (_as(Xi, c) for c in (cl13, cl24, cl14, cl23))
    sym = 0.5 * (cl13[:, None] * cl24[None, :] + cl13[None, :] * cl24[:, None]
                 + cl14[:, None] * cl23[None, :]
                 + cl14[None, :] * cl23[:, None])
    return Xi * sym


@on_device_of_inputs
def decoupled_covariance(M, cov, lmax, edges, weights=None):
    """A pseudo-C_l covariance through the binned MASTER decoupling:
    K = (B M P)^{-1} B, returns K cov K^T (nb, nb)."""
    M = tensor_or_f64(M)
    B, P = bin_operator(lmax, edges, weights, device=M.device)
    K = torch.linalg.solve(B @ M @ P, B)
    return K @ _as(M, cov) @ K.T


@on_device_of_inputs
def cap_mask_cl(lmax, theta_cap_rad):
    """The mask power spectrum W_l of an azimuthal polar cap (1 for theta <
    theta_cap), in closed form on the host:

        W_l = pi I_l^2,  I_l = (P_{l-1}(c) - P_{l+1}(c)) / (2l+1) [l >= 1],
        I_0 = 1 - c,  c = cos(theta_cap)."""
    c = float(np.cos(theta_cap_rad))
    # P_0..P_{lmax+1}(c) by the stable upward Legendre recurrence
    P = np.zeros(lmax + 2)
    P[0] = 1.0
    if lmax + 1 >= 1:
        P[1] = c
    for l in range(1, lmax + 1):
        P[l + 1] = ((2 * l + 1) * c * P[l] - l * P[l - 1]) / (l + 1)
    ls = np.arange(lmax + 1)
    I = np.empty(lmax + 1)
    I[0] = 1.0 - c
    I[1:] = (P[:lmax] - P[2:lmax + 2]) / (2.0 * ls[1:] + 1.0)
    return torch.as_tensor(np.pi * I**2, dtype=_F64,
                           device=call_device())
