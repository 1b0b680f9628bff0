"""Work of one launch of the kernel B1 (``nfw_uk_kernel``): u(k) on the
(row, k) grid, in float32 (fast tier) or float64 (exact tier)."""

from __future__ import annotations

from . import nfw_u

KERNEL = "nfw_uk_kernel"


def work(ks, scales, cs, prec: str = "f32"):
    """(bytes, operations by type): ks (nk,) float64 read once, scales and
    cs (rows,) float64 read once, the (rows, nk) u written once."""
    rows, nk = scales.numel(), ks.numel()
    out_bytes = 4 if prec == "f32" else 8
    nbytes = 8 * (nk + 2 * rows) + out_bytes * rows * nk
    return nbytes, nfw_u.ops(ks, scales, cs, prec)
