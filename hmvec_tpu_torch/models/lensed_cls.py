"""Lensed CMB spectra by the first-order flat-sky lensing convolution on
float64 tensors (port of hmvec_tpu/models/lensed_cls.py):

    Ctilde_l^TT = (1 - l^2 R) C_l^TT + T_1[C^TT],
    Ctilde_l^EE = (1 - l^2 R) C_l^EE + T_cos2[C^EE],
    Ctilde_l^BB =                      T_sin2[C^EE],
    Ctilde_l^TE = (1 - l^2 R) C_l^TE + T_cos[C^TE],

    T_w[X](l) = (1/(2pi)^2) int d^2l' [l'.(l-l')]^2 C_phiphi(|l-l'|)
                X(l') w(2 phi_{l'l}),
    R = (1/4pi) sum_l l^3 C_phiphi

(Hu 2000; Lewis & Challinor 2006 eqs. 4.12-4.20).  The convolution runs
on the device at ~O(100) l nodes, as one (nodes, l', phi) batch cut in
chunks of nodes so that no temporary passes 128 MiB (the JAX package maps
over the nodes one at a time); the smooth correction is splined onto
every integer l on the host, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.quadrature import linear_interp
from ..utils.weights import call_device, on_device_of_inputs

_F64 = torch.float64
# elements of one (nodes, l', phi) temporary: 2^24 float64 = 128 MiB
_CHUNK_ELEMENTS = 2**24


def default_l_nodes(lmax: int):
    """C_l evaluation nodes: dense through the first peaks, then every
    Delta l = 40 (the acoustic period is ~300, so >= 7 nodes per period);
    a copy of hmvec_tpu/models/boltzlite.py's."""
    base = [2, 3, 4, 5, 7, 9, 12, 16, 21, 27, 35, 45, 60, 80, 100, 125,
            150, 175, 200, 220, 240, 260, 280, 300]
    ls = [l for l in base if l <= lmax]
    l = 300
    while l < lmax:
        l = min(l + 40, lmax)
        ls.append(l)
    if ls[-1] != lmax:
        ls.append(lmax)
    return np.unique(np.asarray(ls, dtype=np.int64))


def _phi_grid(n_phi: int):
    """``jax.numpy.linspace(0, pi, n_phi)``'s arithmetic: pi s at s = i /
    (n - 1), the end point exactly pi."""
    s = np.arange(n_phi - 1, dtype=np.float64) / float(n_phi - 1)
    return np.concatenate([0.0 * (1.0 - s) + np.pi * s, [np.pi]])


def _lens_corrections(l_nodes, cl_tt, cl_ee, cl_te, clpp, n_phi: int = 256):
    """The convolution terms T_w at the nodes: (tt, ee, bb, te), each
    (nodes,).  cl_* are integer-l tensors (index = l) on one device; the
    l' integral is the exact sum over integer l' >= 2, the phi integral a
    trapezoid."""
    dev = cl_tt.device
    lmax_in = cl_tt.shape[0] - 1
    lmax_pp = clpp.shape[0] - 1
    lp = torch.arange(2.0, lmax_in + 1.0, dtype=_F64, device=dev)[:, None]
    phi = torch.as_tensor(_phi_grid(n_phi), device=dev)
    wphi = torch.full((n_phi,), math.pi / (n_phi - 1), dtype=_F64,
                      device=dev)
    wphi[0] *= 0.5
    wphi[-1] *= 0.5
    wphi = wphi * 2.0                                 # symmetric doubling
    cosphi = torch.cos(phi)
    cos2 = torch.cos(2.0 * phi)
    # C_phiphi(s) through the linear interpolant of s^4 C_phiphi
    s_grid = torch.arange(lmax_pp + 1, dtype=_F64, device=dev)
    q_grid = s_grid**4 * clpp
    pref = lp[:, 0] / (2.0 * math.pi) ** 2
    ctt, cee, cte = cl_tt[2:], cl_ee[2:], cl_te[2:]

    nodes = torch.as_tensor(np.asarray(l_nodes, dtype=np.float64),
                            device=dev)
    per_node = lp.shape[0] * n_phi
    chunk = max(1, _CHUNK_ELEMENTS // per_node)
    out = []
    for l in torch.split(nodes, chunk):
        l = l[:, None, None]                          # (c, 1, 1)
        dot = l * lp * cosphi - lp**2                 # (c, nlp, nphi)
        s = torch.sqrt(torch.clamp(l**2 + lp**2 - 2.0 * l * lp * cosphi,
                                   min=0.0))
        q = linear_interp(s, s_grid, q_grid, left=0.0, right=0.0)
        s4 = torch.clamp(s, min=2.0) ** 4
        cpp = torch.where((s >= 2.0) & (s <= lmax_pp), q / s4, 0.0)
        kern = dot**2 * cpp
        base = kern @ wphi                            # (c, nlp)
        base2 = (kern * cos2) @ wphi
        base2sq = (kern * cos2**2) @ wphi
        out.append(torch.stack([
            (pref * ctt * base).sum(-1),
            (pref * cee * base2sq).sum(-1),
            (pref * cee * (base - base2sq)).sum(-1),   # sin^2 = 1 - cos^2
            (pref * cte * base2).sum(-1)], dim=-1))
    return torch.cat(out).unbind(-1)


@on_device_of_inputs
def lens_cls_flat_sky(cl_unlensed, clpp, lmax_out: int | None = None,
                      n_phi: int = 256):
    """Lensed (lmax_out+1, 4) [TT, EE, BB, TE] from unlensed scalar C_l.

    cl_unlensed: (lmax_in+1, 4) raw C_l (muK^2), BB column ignored; clpp:
    (lmax_pp+1,) raw C_phiphi.  lmax_out (default lmax_in) must leave a
    few hundred l of headroom for the convolution's support.  The nodes'
    convolution runs on the device; the spline onto every l on the host.
    Returns a float64 tensor on the device."""
    dev = call_device()
    cl_np = np.asarray(torch.as_tensor(cl_unlensed, dtype=_F64).cpu())
    clpp_np = np.asarray(torch.as_tensor(clpp, dtype=_F64).cpu())
    lmax_in = cl_np.shape[0] - 1
    if lmax_out is None:
        lmax_out = lmax_in
    ells = np.arange(lmax_out + 1, dtype=np.float64)

    # R = (1/4pi) sum_l l^3 C_pp (integer-l sum)
    lpp = np.arange(clpp_np.shape[0], dtype=np.float64)
    r_tot = float(np.sum(lpp**3 * clpp_np)) / (4.0 * np.pi)

    l_nodes = default_l_nodes(lmax_out).astype(np.float64)
    cl_d = torch.as_tensor(cl_np, device=dev)
    t_tt, t_ee, t_bb, t_te = (np.asarray(t.cpu()) for t in _lens_corrections(
        l_nodes, cl_d[:, 0], cl_d[:, 1], cl_d[:, 3],
        torch.as_tensor(clpp_np, device=dev), n_phi=n_phi))

    # the smooth convolution terms splined onto every l (host); the
    # (1 - l^2 R) part uses the exact unlensed C_l at every integer l
    from scipy.interpolate import CubicSpline

    def to_all(t_nodes):
        out = np.zeros(lmax_out + 1)
        out[2:] = CubicSpline(np.log(l_nodes), t_nodes)(np.log(ells[2:]))
        return out

    out = np.zeros((lmax_out + 1, 4))
    damp = 1.0 - ells**2 * r_tot
    out[:, 0] = damp * cl_np[:lmax_out + 1, 0] + to_all(t_tt)
    out[:, 1] = damp * cl_np[:lmax_out + 1, 1] + to_all(t_ee)
    out[:, 2] = to_all(t_bb)
    out[:, 3] = damp * cl_np[:lmax_out + 1, 3] + to_all(t_te)
    out[:2] = 0.0
    return torch.as_tensor(out, device=dev)
