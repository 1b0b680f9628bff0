"""Vectorized fixed-trip-count bisection on float64 tensors (port of
hmvec_tpu/ops/rootfind.py).

Each solve halves its bracket ``num_iter`` times with ``torch.where``:
90 halvings shrink any practical bracket below float64 resolution.  The
loop is a plain Python loop of elementwise ops; it carries no derivative
from the objective into the root (the bracket ends are selected, never
computed from the objective's value), as in the JAX package.
"""

from __future__ import annotations

import torch


def _bisect(lo, hi, go_right, num_iter):
    for _ in range(num_iter):
        mid = (lo + hi) / 2.0
        right = go_right(mid)
        lo, hi = torch.where(right, mid, lo), torch.where(right, hi, mid)
    return (lo + hi) / 2.0


def invert_monotone(func, targets, lo, hi, num_iter: int = 90,
                    increasing: bool = True):
    """Solve func(y) = targets for y in [lo, hi], func monotone elementwise.

    func maps a tensor of y to a tensor of func(y) with the shape of
    ``targets``; lo and hi broadcast to that shape."""
    targets = torch.as_tensor(targets)
    lo = torch.as_tensor(lo, dtype=targets.dtype,
                         device=targets.device).expand(targets.shape)
    hi = torch.as_tensor(hi, dtype=targets.dtype,
                         device=targets.device).expand(targets.shape)
    if increasing:
        return _bisect(lo, hi, lambda y: func(y) < targets, num_iter)
    return _bisect(lo, hi, lambda y: func(y) > targets, num_iter)


def solve_bisection_root(f, lo, hi, num_iter: int = 90):
    """Find f(y) = 0 for f monotone-decreasing elementwise on [lo, hi]."""
    # decreasing: f(mid) > 0 means the root lies to the right of mid
    return _bisect(lo, hi, lambda y: f(y) > 0, num_iter)
