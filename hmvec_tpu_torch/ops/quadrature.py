"""Static-weight quadrature and finite differences on tensors (port of
hmvec_tpu/ops/quadrature.py)."""

from __future__ import annotations

import numpy as np
import torch

from ..utils.weights import trapz_weights


def trapz(y, x=None, *, weights=None, dim=-1):
    """np.trapezoid along ``dim`` with a static (numpy) grid ``x``, or a
    precomputed weight vector, or a 1-d tensor ``x`` on y's device (the
    JAX package's ``trapz_traced``: the pairwise form, differentiable in
    the grid)."""
    if weights is None and isinstance(x, torch.Tensor):
        y = torch.movedim(y, dim, -1)
        return ((y[..., 1:] + y[..., :-1]) * torch.diff(x) / 2.0).sum(dim=-1)
    if weights is None:
        weights = trapz_weights(np.asarray(x))
    w = torch.as_tensor(np.asarray(weights), dtype=y.dtype, device=y.device)
    return torch.movedim(y, dim, -1) @ w


def gradient(f, x, dim=-1):
    """np.gradient(f, x, axis=dim) with numpy's default edge_order=1.

    Second-order central differences in the interior (nonuniform-aware),
    first-order one-sided at the edges: the stencil of
    hmvec_tpu.ops.quadrature.gradient, which the mass function's
    dln(sigma^-1)/dln m uses (mass_function.nzm).
    """
    f = torch.movedim(f, dim, -1)
    x = torch.as_tensor(x, dtype=f.dtype, device=f.device)
    hd = x[1:-1] - x[:-2]   # backward spacing
    hs = x[2:] - x[1:-1]    # forward spacing
    denom = hd * hs * (hd + hs)
    interior = (
        hd**2 * f[..., 2:] + (hs**2 - hd**2) * f[..., 1:-1] - hs**2 * f[..., :-2]
    ) / denom
    left = (f[..., 1:2] - f[..., 0:1]) / (x[1] - x[0])
    right = (f[..., -1:] - f[..., -2:-1]) / (x[-1] - x[-2])
    out = torch.cat([left, interior, right], dim=-1)
    return torch.movedim(out, -1, dim)
