"""Work of one launch of the kernel F1 (``catmull_fill_kernel``): the
Catmull-Rom fill in ln k of y (rows, nkq), float32 or float64, onto nk
columns by four taps (an int32 index and a float64 weight each), written
in float64."""

from __future__ import annotations

KERNEL = "catmull_fill_kernel"


def work(rows: int, nkq: int, nk: int, y_bytes: int):
    """(bytes, operations by type): y read once, the (4, nk) taps read
    once, the (rows, nk) float64 output written once; per output a
    multiply and an add for each of the four taps."""
    nbytes = y_bytes * rows * nkq + 12 * 4 * nk + 8 * rows * nk
    return nbytes, {"f64": 8 * rows * nk}
