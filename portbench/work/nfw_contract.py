"""Work of one launch of the kernel B2 (``nfw_contract_kernel``): the
float32 u(k) of every (z, m) row, reduced on the spot to
S1(z, k) = sum_m a u^2 and S2(z, k) = sum_m b u in float64."""

from __future__ import annotations

from . import nfw_u

KERNEL = "nfw_contract_kernel"


def work(ks, scales, cs):
    """(bytes, operations by type).  ks (nk,); scales, cs and the weights
    a, b, all (nz, nm) float64, each read once; S1 and S2 (nz, nk) float64
    written once.  Operations: u, then per element u^2 and the two float64
    multiply-adds (5), and per (z, k) the sum of the 8 warps' partials for
    S1 and S2."""
    nz, nm = scales.shape
    nk = ks.numel()
    nbytes = 8 * (nk + 4 * nz * nm) + 16 * nz * nk
    ops = nfw_u.ops(ks, scales, cs, "f32")
    ops["f64"] += 5 * nz * nm * nk + 2 * 8 * nz * nk
    return nbytes, ops
