"""Work of one launch of the kernel B4b (``pair_lerp_kernel`` or, for
small calls, ``pair_lerp_rows_kernel``): each row of a u(kt) table on the
uniform grid kt_i = i dkt read at the fractional index p = k s / dkt of
every target k, for the row's scale s, and written in float64.  Frozen
from the repository's chip_smoke.py ``pair_lerp_work``."""

from __future__ import annotations

import torch

KERNELS = ("pair_lerp_kernel", "pair_lerp_rows_kernel")


def work(nkt: int, table_bytes: int, scales, ks, dkt: float):
    """(bytes, operations by type) on this call's rows: each table entry
    that some target reads (u[i0] and u[i0 + 1] in the lerp window, u[1]
    below it) once, the float64 scales and ks, and the (rows, nk) float64
    output; per target 2 float64 operations for p and 5 more in the lerp
    window.  scales (...,) and ks (nk,) float64 tensors."""
    rows = scales.numel()
    p = ks[None, :] * scales.reshape(-1)[:, None] / dkt
    win = (p >= 1.0) & (p <= nkt - 1.0)
    i0 = torch.floor(p).clamp(1, nkt - 2).long()
    dummy = torch.full_like(i0, nkt)      # a column no target reads
    touched = torch.zeros((rows, nkt + 1), dtype=torch.bool,
                          device=scales.device)
    touched.scatter_(1, torch.where(win, i0, torch.where(p < 1.0, 1, dummy)),
                     True)
    touched.scatter_(1, torch.where(win, i0 + 1, dummy), True)
    n_read = int(touched[:, :nkt].sum().item())
    nbytes = (n_read * table_bytes + 8 * rows + 8 * ks.numel()
              + 8 * rows * ks.numel())
    return nbytes, {"f64": 2 * p.numel() + 5 * int(win.sum().item())}
