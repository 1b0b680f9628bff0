"""The frozen work counts against a count by hand at a small shape, and
the roofline arithmetic."""

import pytest
import torch

from portbench.work import nfw_contract, nfw_uk, roofline

KS = torch.tensor([1.0, 5.0, 50.0], dtype=torch.float64)
SCALES = torch.tensor([[1.0]], dtype=torch.float64)
CS = torch.tensor([[4.0]], dtype=torch.float64)

# By hand, fast tier: x = 1, 5, 50 and x2 = (1 + c) x = 5, 25, 250.  One
# Si/Ci in float32 costs its reciprocal (1) and, by domain, 4 + 60 (x <= 4),
# 3 + 3 + 60 (4 < x <= 40) or the tail 1 + 24 + 2 (x > 40): 65, 67, 28 for
# x and 67, 67, 28 for x2.  The assembly is 3 + 6 plus 12 + 15 (a float32
# log, x <= 4 < x2) at k = 1 and 14 elsewhere: 36, 23, 23.  float32: those
# 404 and 2 x 16 a sin/cos pair per element (96); float64: the two phases a
# element (6), 36 for the row, 2 x 5 a sin/cos pair per element (30).
F32_OPS, F64_OPS = 404 + 96, 6 + 36 + 30


def test_nfw_uk_work_by_hand():
    nbytes, ops = nfw_uk.work(KS, SCALES.reshape(-1), CS.reshape(-1))
    assert nbytes == 8 * (3 + 2) + 4 * 3
    assert ops == {"f64": F64_OPS, "f32": F32_OPS}


def test_nfw_contract_work_by_hand():
    nbytes, ops = nfw_contract.work(KS, SCALES, CS)
    # ks, scales, cs, a, b read once; S1, S2 written once
    assert nbytes == 8 * (3 + 4) + 16 * 3
    # per element u^2 and two float64 multiply-adds (5 x 3), per (z, k) the
    # 8 warps' partials of S1 and S2 (2 x 8 x 3)
    assert ops == {"f64": F64_OPS + 15 + 48, "f32": F32_OPS}


@pytest.mark.parametrize("nbytes, ops, want", [
    (3.35e12, {"f64": 1.0}, 1.0),
    (0, {"f64": 34e12, "f32": 67e12}, 1.0),
    (0, {"f32": 134e12}, 2.0),
])
def test_least_time(nbytes, ops, want):
    assert roofline.least_time_s(nbytes, ops) == pytest.approx(want)
