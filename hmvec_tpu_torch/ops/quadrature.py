"""Static-weight quadrature, linear interpolation and finite differences on
tensors (port of hmvec_tpu/ops/quadrature.py)."""

from __future__ import annotations

import numpy as np
import torch

from ..utils.weights import on_device_of_inputs, simpson_weights, trapz_weights


def _weighted(y, weights, axis):
    w = torch.as_tensor(np.asarray(weights), dtype=y.dtype, device=y.device)
    return torch.movedim(y, axis, -1) @ w


def trapz(y, x=None, *, weights=None, axis=-1):
    """np.trapezoid along ``axis`` with a static (numpy) grid ``x``, or a
    precomputed weight vector, or a 1-d tensor ``x`` on y's device (the
    JAX package's ``trapz_traced``: the pairwise form, differentiable in
    the grid)."""
    if weights is None and isinstance(x, torch.Tensor):
        return trapz_traced(y, x, axis=axis)
    if weights is None:
        weights = trapz_weights(np.asarray(x))
    return _weighted(y, weights, axis)


def trapz_traced(y, x, axis=-1):
    """Trapezoid along ``axis`` over the grid ``x``, a 1-d tensor on y's
    device (differentiable in the grid)."""
    y = torch.movedim(y, axis, -1)
    return ((y[..., 1:] + y[..., :-1]) * torch.diff(x) / 2.0).sum(dim=-1)


def simpson(y, x=None, *, weights=None, axis=-1):
    """scipy.integrate.simpson along ``axis`` with a static (numpy) grid
    ``x`` or a precomputed weight vector."""
    if weights is None:
        weights = simpson_weights(np.asarray(x))
    return _weighted(y, weights, axis)


def linear_interp(x, xp, fp, left=None, right=None):
    """``jax.numpy.interp(x, xp, fp, left, right)`` on tensors, with its
    arithmetic: the interval from a right-sided search clipped to
    [1, n - 1] (so a point on the last node takes the last interval),
    fp[i-1] + (x - xp[i-1]) / dx * df with dx guarded where it is below
    float64's smallest spacing, and ``left`` / ``right`` (default fp[0],
    fp[-1]) where x < xp[0] or x > xp[-1].  xp: (n,), or (rows, n)
    increasing along each row with x (rows, m), one interpolation per row;
    fp: (n,) on x's device, or (rows, n) with a 1-d xp and x: one table
    per row on the shared nodes, giving (rows,) + x.shape."""
    x = torch.as_tensor(x, dtype=torch.float64, device=xp.device)
    n = xp.shape[-1]
    rows = xp.reshape(1, n) if xp.dim() == 1 else xp
    xr = (x.reshape(1, -1) if xp.dim() == 1 else x).contiguous()
    i = torch.searchsorted(rows, xr, right=True).clamp(1, n - 1)
    x0, x1 = torch.gather(rows, -1, i - 1), torch.gather(rows, -1, i)
    if fp.dim() == 1:
        f0, f1, lo, hi, shape = fp[i - 1], fp[i], fp[0], fp[-1], x.shape
    else:
        idx = i.expand(fp.shape[0], -1)
        f0, f1 = torch.gather(fp, -1, idx - 1), torch.gather(fp, -1, idx)
        lo, hi, shape = fp[:, :1], fp[:, -1:], (fp.shape[0],) + x.shape
    dx = x1 - x0
    # a zero-width interval takes its left value (and no NaN gradient)
    eps = float(np.spacing(np.finfo(np.float64).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, f0,
                    f0 + ((xr - x0) / torch.where(dx0, 1.0, dx)) * (f1 - f0))
    f = torch.where(xr < rows[:, :1], lo if left is None else left, f)
    f = torch.where(xr > rows[:, -1:], hi if right is None else right, f)
    return f.reshape(shape)


def lerp_index(xp, x):
    """The interval and weight of a flat-clipped linear interpolation on
    the increasing nodes xp (n,) at x (any shape): i = searchsorted(xp, x)
    - 1 clipped to [0, n - 2], t = (x - xp[i]) / (xp[i + 1] - xp[i])
    clipped to [0, 1], so a point beyond either end takes the end value.
    The searchsorted-and-clip lerps of the JAX package (limber, cov,
    bispectrum, cluster_counts) all have this arithmetic."""
    n = xp.shape[-1]
    i = (torch.searchsorted(xp, x.contiguous()) - 1).clamp(0, n - 2)
    t = ((x - xp[i]) / (xp[i + 1] - xp[i])).clamp(0.0, 1.0)
    return i, t


@on_device_of_inputs
def interp(x, y, bounds_error=False, fill_value=0.0):
    """Reference-signature 1-d linear interpolator factory: a callable
    that evaluates ``linear_interp`` on the fixed table (x, y), a pair of
    float64 tensors or arrays, with ``fill_value`` outside the range.
    ``bounds_error=True`` is refused, as in the JAX package."""
    if bounds_error:
        raise NotImplementedError("bounds_error=True is not supported; "
                                  "use fill_value instead")
    dev = y.device if isinstance(y, torch.Tensor) else None
    xt = torch.as_tensor(x, dtype=torch.float64, device=dev)
    yt = torch.as_tensor(y, dtype=torch.float64, device=xt.device)

    def _eval(xn):
        return linear_interp(xn, xt, yt, left=fill_value, right=fill_value)

    return _eval


def gradient(f, x, axis=-1):
    """np.gradient(f, x, axis=axis) with numpy's default edge_order=1.

    Second-order central differences in the interior (nonuniform-aware),
    first-order one-sided at the edges: the stencil of
    hmvec_tpu.ops.quadrature.gradient, which the mass function's
    dln(sigma^-1)/dln m uses (mass_function.nzm).
    """
    f = torch.movedim(f, axis, -1)
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
    return torch.movedim(out, -1, axis)
