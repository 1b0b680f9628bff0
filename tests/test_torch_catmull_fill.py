"""PyTorch port, the serving path's Catmull-Rom fill (F1,
ops/resample_kernels.py ``catmull_fill``; pipeline._Grids.resample).

On the CPU the wrapper computes the plain version, which is held bit for
bit to the expression the pipeline evaluated before the kernel existed,
at the serving taps ((0.2, 4) on the README k grid), also under
``torch.func.vmap``, and on random taps at edge shapes; its derivatives
by gradcheck and jvp, and its refusals.  The card tests run the kernel
against the plain version bit for bit and count its launches in a
batched serving call:

    python -m pytest --noconftest -m gpu tests/test_torch_catmull_fill.py

(``--noconftest``: the repository's conftest.py configures JAX.)  The CPU
cases take a few seconds.
"""

import warnings

import numpy as np
import pytest
import torch

from hmvec_tpu_torch import pipeline as tpl
from hmvec_tpu_torch.ops import resample_kernels as rk
from hmvec_tpu_torch.params import merge_params

F64 = torch.float64
# the README grids and the serving options of portbench's configurations
KS = np.geomspace(1e-4, 100, 1001)
ZS = np.linspace(0.1, 3.0, 20)
MS = np.geomspace(2e10, 1e17, 200)
SERVING = (0.2, 4)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _taps(ks=KS, device="cpu"):
    """(tap_i, tap_w, nkq) of the serving fill on the grid ks."""
    g = tpl._Grids(None, ks, MS[:2], merge_params(), SERVING,
                   torch.device(device))
    return (*g.taps, g.kq.shape[0])


def _expression(y, tap_i, tap_w):
    """The pipeline's fill before the kernel: float64 y, int64 taps."""
    tap_i = tap_i.long()
    return sum(y[..., tap_i[j]] * tap_w[j] for j in range(4))


def _bits_equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int64), b.view(torch.int64))


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_wrapper_is_the_expression_at_the_serving_taps(dtype):
    tap_i, tap_w, nkq = _taps()
    assert (tap_i.dtype, tuple(tap_i.shape), nkq) == (torch.int32,
                                                      (4, 1001), 589)
    rng = np.random.default_rng(5)
    y = torch.as_tensor(rng.standard_normal((4, 30, nkq)), dtype=dtype)
    got = rk.catmull_fill(y, tap_i, tap_w)
    assert _bits_equal(got, _expression(y.to(F64), tap_i, tap_w))


def test_wrapper_under_vmap_folds_the_batch_into_the_rows():
    tap_i, tap_w, nkq = _taps()
    Y = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (3, 2, 5, nkq)), dtype=torch.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # a batching fallback would warn
        got = torch.func.vmap(lambda a: rk.catmull_fill(a, tap_i, tap_w),
                              in_dims=1)(Y)
    want = torch.stack([_expression(Y[:, b].to(F64), tap_i, tap_w)
                        for b in range(Y.shape[1])])
    assert _bits_equal(got, want)


def test_derivatives_are_the_fill_of_the_tangent():
    ks = np.geomspace(1e-3, 1.0, 40)
    tap_i, tap_w, nkq = _taps(ks)
    rng = np.random.default_rng(7)
    y = torch.as_tensor(rng.standard_normal((3, nkq)), dtype=F64)
    t = torch.as_tensor(rng.standard_normal((3, nkq)), dtype=F64)

    def fill(a):
        return rk.catmull_fill(a, tap_i, tap_w)

    assert torch.autograd.gradcheck(fill, (y.clone().requires_grad_(),))
    out, tangent = torch.func.jvp(fill, (y,), (t,))
    assert _bits_equal(out, rk.catmull_fill_plain(y, tap_i, tap_w))
    assert _bits_equal(tangent, rk.catmull_fill_plain(t, tap_i, tap_w))
    assert torch.equal(torch.func.jacfwd(fill)(y), torch.func.jacrev(fill)(y))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    tap_i, tap_w, nkq = _taps()
    y = torch.zeros((6, nkq), dtype=F64)
    with pytest.raises(TypeError, match="float32 or float64"):
        rk.catmull_fill(y.half(), tap_i, tap_w)
    with pytest.raises(TypeError, match="int32"):
        rk.catmull_fill(y, tap_i.long(), tap_w)
    with pytest.raises(TypeError, match="float64"):
        rk.catmull_fill(y, tap_i, tap_w.float())
    with pytest.raises(ValueError, match="contiguous"):
        rk.catmull_fill(torch.zeros((nkq, 6), dtype=F64).T, tap_i, tap_w)
    with pytest.raises(ValueError, match=r"\(4, nk\)"):
        rk.catmull_fill(y, tap_i[:3], tap_w[:3])
    with pytest.raises(ValueError, match="is on meta"):
        rk.catmull_fill(y, tap_i.to("meta"), tap_w)
    with pytest.raises(ValueError, match="is on meta"):
        rk.catmull_fill(y, tap_i, tap_w.to("meta"))


@pytest.mark.parametrize("shape,nk,dtype", [
    ((0, 9), 5, F64), ((1, 1), 1, torch.float32), ((2, 3), 1, F64),
    ((5, 40), 257, torch.float32), ((3, 7, 11), 1025, F64),
    ((13, 8000), 300, F64), ((4, 16000), 2049, torch.float32),
    ((2, 2, 2, 37), 64, torch.float32)])
def test_wrapper_is_the_expression_at_any_taps(shape, nk, dtype):
    """Any row count, rank, nk and nkq (wider rows than the kernel stages
    included), on taps drawn at random: the pipeline's old expression."""
    rng = np.random.default_rng(sum(shape) + nk)
    tap_i = torch.as_tensor(rng.integers(0, shape[-1], (4, nk)),
                            dtype=torch.int32)
    tap_w = torch.as_tensor(rng.standard_normal((4, nk)), dtype=F64)
    y = torch.as_tensor(rng.standard_normal(shape), dtype=dtype)
    assert _bits_equal(rk.catmull_fill(y, tap_i, tap_w),
                       _expression(y.to(F64), tap_i, tap_w))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_is_bit_equal_to_the_plain_version_on_the_card():
    """Both storage types at the fast cell's shape (512,000 x 589 ->
    1,001) and at edge shapes (0 rows, 1 row, rows not a multiple of a
    block's 4, nk not a multiple of the block, nk over one column tile,
    rows of y not 16-byte aligned, nkq whose 4 rows take more than the
    48 KB a block stages, so that the gathers read device memory, up to
    16,000, above what two staged blocks of 4 rows could hold), one
    launch each (none for 0 rows)."""
    dev = _card()
    tap_i, tap_w, nkq = _taps(device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    cases = [((512000, nkq), tap_i, tap_w), ((0, nkq), tap_i, tap_w),
             ((1, nkq), tap_i, tap_w), ((4001, nkq), tap_i, tap_w),
             ((3, 7, nkq), tap_i, tap_w)]
    for nk, n_src, rows in ((257, 100, 9), (1000, 37, 13), (5000, 3000, 6),
                            (1001, 8000, 11), (2049, 16000, 5)):
        i = torch.randint(0, n_src, (4, nk), generator=g, device=dev)
        w = torch.randn((4, nk), generator=g, dtype=F64, device=dev)
        cases.append(((rows, n_src), i.to(torch.int32), w))
    for dtype in (torch.float32, F64):
        for shape, i, w in cases:
            y = torch.randn(shape, generator=g, device=dev).to(dtype)
            n0 = rk.catmull_fill.launches
            got = rk.catmull_fill(y, i, w)
            torch.cuda.synchronize()
            assert rk.catmull_fill.launches == n0 + int(y.numel() > 0)
            assert _bits_equal(got, rk.catmull_fill_plain(y, i, w)), shape
            del got, y
        # a row of y that starts off a 16-byte boundary
        base = torch.randn((6 * nkq + 1,), generator=g, device=dev)
        y = base.to(dtype)[1:].view(6, nkq)
        assert y.is_contiguous() and y.data_ptr() % 16 != 0
        assert _bits_equal(rk.catmull_fill(y, tap_i, tap_w),
                           rk.catmull_fill_plain(y, tap_i, tap_w))
    torch.cuda.empty_cache()


def _batched_serving(dev, tier):
    fn = tpl.make_pmm_fn(ZS, KS, MS, device=dev,
                         static_params={"sigma2_numks": 1250},
                         uk_subsample=SERVING, **tier)
    theta = torch.tensor([[0.11, 67.0], [0.12, 70.0], [0.13, 62.0]],
                         dtype=F64, device=dev)
    return tpl.make_batched_fn(fn, ("omch2", "H0")), theta


@pytest.mark.gpu
@pytest.mark.parametrize("tier,fills", [({"fast": True}, 1),
                                        ({"fused_serving": True}, 2)])
def test_batched_serving_call_fills_once_and_as_the_plain_fill(tier, fills):
    """One batched call launches the fill once per fill (the fast tier's
    u cube; the fused tier's two sums), and its spectra are bit-equal to
    the same call with the plain fill in the kernel's place."""
    dev = _card()
    batched, theta = _batched_serving(dev, tier)
    batched(theta)
    n0 = rk.catmull_fill.launches
    got = batched(theta)
    torch.cuda.synchronize()
    assert rk.catmull_fill.launches == n0 + fills
    real = rk._launch_fill
    rk._launch_fill = rk.catmull_fill_plain
    try:
        want = batched(theta)
    finally:
        rk._launch_fill = real
    assert _bits_equal(got, want)


@pytest.mark.gpu
def test_kernel_on_every_card_keeps_the_current_device():
    """The fill on each visible card (a mesh slot of parallel.sharding
    launches on its own card from the one host thread): the output on
    that card, bit-equal to the plain version, and the caller's current
    device left as it was."""
    _card()
    torch.cuda.set_device(0)
    for index in range(torch.cuda.device_count()):
        dev = torch.device("cuda", index)
        tap_i, tap_w, nkq = _taps(device=dev)
        y = torch.rand((2, 40, nkq), device=dev)
        got = rk.catmull_fill(y, tap_i, tap_w)
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == 0 and got.device == dev
        assert _bits_equal(got, rk.catmull_fill_plain(y, tap_i, tap_w))
