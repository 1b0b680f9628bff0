"""The resample kernel of the profile transform: hand-written CUDA for
Hopper, its plain PyTorch version, and the wrappers that choose between
them.

``pair_lerp(u, scales, ks, dkt)`` interpolates each row of u (..., nkt),
sampled on the uniform grid kt_i = i dkt, at the fractional index
p = k s / dkt of every target k (nk,), for the row's scale s (...,): flat
at u[..., 1] below p = 1 and zero above p = nkt - 1.  This is the resample
step of ``sine_transform.resample_uniform_source``.  It ports
hmvec_tpu/ops/pallas_resample.py ``select_pairs`` -- both its float64
(hi/lo) and its float32 kernel -- as the two instantiations of one CUDA
kernel (csrc/resample_kernels.cu), with the index math, the lerp and the
boundaries fused in.  u is float64 or float32; the index math, the lerp
and the output are float64 in both cases.

A wrapper given CUDA tensors launches its kernel (building the library at
first use, kernels/_build.py) or raises; given CPU tensors it computes the
plain version, ``pair_lerp_plain``.  There is no fallback between the two.
Each kernel's wrapper (``pair_lerp_f64``, ``pair_lerp_f32``) counts the
launches of its kernel in ``<wrapper>.launches``.

Both wrappers are differentiable in u and scales, in reverse and forward
mode, through a ``torch.autograd.Function`` whose backward and jvp
recompute the plain version's derivative (the kernel has none of its own,
as the JAX package's ``_pair_lerp_tpu_jvp`` falls back to gathers).

``catmull_fill(y, tap_i, tap_w)`` is the serving path's Catmull-Rom fill
(pipeline._Grids.resample): y (..., nkq), float32 or float64, filled onto
nk targets by four taps, float64 (..., nk).  On the card it is one
hand-written kernel of the same file, bit-equal to ``catmull_fill_plain``;
it ports no TPU kernel (the JAX package fills with jnp gathers).  Its
launches count in ``catmull_fill.launches``.
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from .nfw_kernels import _raise_on_error, _stream

_F64 = torch.float64
_MAX_ROWS = 2**31 - 1
_THREADS = 256  # threads per block, csrc/resample_kernels.cu kThreads
PAIRS = 2  # 16-byte pairs of targets a thread of the flat kernel


def pair_lerp_geometry(rows: int, nk: int, n_sm: int,
                       blocks_per_sm: dict) -> tuple[int, int]:
    """(blocks, rows per block) of one launch for rows x nk float64
    targets on a card of n_sm SMs, where ``blocks_per_sm["rows"]`` blocks
    of the kernel of whole rows and ``blocks_per_sm["flat"]`` of the flat
    kernel fit on one SM.

    A call whose one-target threads fit in one wave is the latency of one
    chain of loads: where nk <= 256 and they do, whole rows a block (rows
    per block > 0), each row nk threads rounded up to whole warps, as many
    rows as 256 threads hold.  Else the flat kernel, two pairs of targets
    a thread, whose loads it issues together (rows per block 0), on the
    blocks the targets need, at most one wave: the blocks stride over the
    rest.  A pure function of its arguments, so the CPU tests cover it."""
    if nk <= _THREADS:
        per_block = _THREADS // (-(-nk // 32) * 32)
        blocks = -(-rows // per_block)
        if blocks <= n_sm * blocks_per_sm["rows"]:
            return blocks, per_block
    needed = -(-rows * nk // (_THREADS * 2 * PAIRS))
    return max(1, min(needed, n_sm * blocks_per_sm["flat"])), 0


def _blocks_per_sm(lib, f32: bool, device) -> dict:
    """{"rows", "flat": resident blocks per SM} of the two kernels on
    ``device``, asked of the occupancy API once per (device, storage
    type)."""
    key = (device.index, f32)
    if key not in _OCCUPANCY:
        occ = {}
        for kernel in ("rows", "flat"):
            n = ctypes.c_int(0)
            _raise_on_error(lib.hmvec_pair_lerp_blocks_per_sm(
                int(f32), int(kernel == "rows"), device.index,
                ctypes.byref(n)), "pair_lerp occupancy")
            occ[kernel] = n.value
        _OCCUPANCY[key] = occ
    return _OCCUPANCY[key]


_OCCUPANCY: dict = {}


def _positions(u, scales, ks, dkt):
    """(p, i0, frac): the fractional index p = k s / dkt of every target,
    shape scales.shape + (nk,), its lerp window start clamped to
    [1, nkt - 2] (float64 and int64) and p - i0.  dkt divides as a tensor
    on u's device: a Python scalar would let the card's division multiply
    by 1/dkt instead, which the kernel does not do."""
    nkt = u.shape[-1]
    dkt_t = torch.full((), float(dkt), dtype=_F64, device=u.device)
    p = ks * scales[..., None] / dkt_t
    i0f = torch.floor(p).clamp(1, nkt - 2)
    return p, i0f.long(), p - i0f


def _pair_lerp_gather(u, i0, frac):
    """u[..., i0] + frac (u[..., i0+1] - u[..., i0]) by two gathers, in
    float64 whatever u's dtype (the JAX package's _pair_lerp_gather)."""
    u0 = torch.gather(u, -1, i0).to(_F64)
    u1 = torch.gather(u, -1, i0 + 1).to(_F64)
    return u0 + frac * (u1 - u0)


def pair_lerp_plain(u, scales, ks, dkt):
    """The resample of u (..., nkt) at the targets ks (nk,) for the row
    scales (...,), as two gathers and a lerp; float64, shape (..., nk)."""
    nkt = u.shape[-1]
    p, i0, frac = _positions(u, scales, ks, dkt)
    val = torch.where(p < 1.0, u[..., 1:2].to(_F64),
                      _pair_lerp_gather(u, i0, frac))
    return torch.where(p > nkt - 1.0, 0.0, val)


def _pair_lerp_jvp(u, scales, ks, dkt, t_u, t_s):
    """Tangent of pair_lerp_plain at (u, scales) along (t_u, t_s), either of
    which may be None, written with the gathers of the primal: in the lerp
    window d val = du0 + frac (du1 - du0) + dp (u1 - u0), with
    dp = k ds / dkt."""
    nkt = u.shape[-1]
    p, i0, frac = _positions(u, scales, ks, dkt)
    out = torch.zeros(p.shape, dtype=_F64, device=u.device)
    if t_u is not None:
        out = out + torch.where(p < 1.0, t_u[..., 1:2].to(_F64),
                                _pair_lerp_gather(t_u, i0, frac))
    if t_s is not None:
        u0 = torch.gather(u, -1, i0).to(_F64)
        u1 = torch.gather(u, -1, i0 + 1).to(_F64)
        dp = ks * t_s[..., None] / dkt
        out = out + torch.where(p < 1.0, 0.0, dp * (u1 - u0))
    return torch.where(p > nkt - 1.0, 0.0, out)


def _check(u, scales, ks, dkt, dtype):
    """Validate types, ranks, sizes and device; raises on what the kernel
    does not take (``_launch`` checks contiguity)."""
    for name, t in (("u", u), ("scales", scales), ("ks", ks)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if u.dtype != dtype:
        raise TypeError(f"u must be {dtype}, got {u.dtype}")
    for name, t in (("scales", scales), ("ks", ks)):
        if t.dtype != _F64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
    if isinstance(dkt, torch.Tensor) or not isinstance(dkt, numbers.Real):
        raise TypeError(f"dkt must be a Python number, got "
                        f"{type(dkt).__name__}")
    if u.dim() < 1 or u.shape[-1] < 3:
        raise ValueError(f"u must be (..., nkt) with nkt >= 3, got shape "
                         f"{tuple(u.shape)}")
    if tuple(scales.shape) != tuple(u.shape[:-1]):
        raise ValueError(f"scales must have shape {tuple(u.shape[:-1])}, got "
                         f"{tuple(scales.shape)}")
    if ks.dim() != 1:
        raise ValueError(f"ks must be 1-d, got shape {tuple(ks.shape)}")
    for name, t in (("scales", scales), ("ks", ks)):
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, expected {u.device}")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {u.device}")


def _sm_count(device) -> int:
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device.index]


_SMS: dict = {}


def _launch(u, scales, ks, dkt):
    from ..kernels._build import load_library

    for name, t in (("u", u), ("scales", scales), ("ks", ks)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on CUDA")
    nkt, nk = u.shape[-1], ks.shape[0]
    rows = scales.numel()
    out = torch.empty((*u.shape[:-1], nk), dtype=_F64, device=u.device)
    if rows == 0 or nk == 0:
        return out
    if rows > _MAX_ROWS or nk > _MAX_ROWS:
        raise ValueError(f"pair_lerp takes at most {_MAX_ROWS} rows and "
                         f"targets, got {rows} and {nk}")
    lib = load_library()
    f64 = u.dtype == _F64
    geometry = pair_lerp_geometry(
        rows, nk, _sm_count(u.device), _blocks_per_sm(lib, not f64, u.device))
    fn = lib.hmvec_pair_lerp_f64 if f64 else lib.hmvec_pair_lerp_f32
    err = fn(u.data_ptr(), scales.data_ptr(), ks.data_ptr(), float(dkt),
             out.data_ptr(), rows, nkt, nk, *geometry, u.device.index,
             _stream(u))
    _raise_on_error(err, f"pair_lerp({u.dtype})")
    (pair_lerp_f64 if f64 else pair_lerp_f32).launches += 1
    return out


class _PairLerp(torch.autograd.Function):
    @staticmethod
    def forward(u, scales, ks, dkt):
        if u.is_cuda:
            return _launch(u, scales, ks, dkt)
        return pair_lerp_plain(u, scales, ks, dkt)

    @staticmethod
    def setup_context(ctx, inputs, output):
        u, scales, ks, dkt = inputs
        ctx.save_for_backward(u, scales, ks)
        ctx.save_for_forward(u, scales, ks)
        ctx.dkt = dkt

    @staticmethod
    def backward(ctx, grad):
        u, scales, ks = ctx.saved_tensors
        _, vjp = torch.func.vjp(
            lambda u_, s_: pair_lerp_plain(u_, s_, ks, ctx.dkt),
            u.detach(), scales.detach())
        g_u, g_s = vjp(grad)
        return g_u, g_s, None, None

    @staticmethod
    def jvp(ctx, t_u, t_s, _t_ks, _t_dkt):
        u, scales, ks = ctx.saved_tensors
        return _pair_lerp_jvp(u, scales, ks, ctx.dkt, t_u, t_s)

    @staticmethod
    def vmap(info, in_dims, u, scales, ks, dkt):
        """torch.func.vmap: the mapped dimension becomes one more batch
        dimension of the rows, so the kernel runs once for the batch."""
        u_bd, s_bd, k_bd, _ = in_dims
        if k_bd is not None:
            raise NotImplementedError("pair_lerp under vmap takes one ks "
                                      "for every mapped element")

        def lead(t, bd):
            return (t.expand(info.batch_size, *t.shape) if bd is None
                    else t.movedim(bd, 0))

        u, scales = lead(u, u_bd), lead(scales, s_bd)
        if u.is_cuda:
            u, scales = u.contiguous(), scales.contiguous()
        return _PairLerp.apply(u, scales, ks, dkt), 0


def pair_lerp_f64(u, scales, ks, dkt):
    """The resample of float64 u (..., nkt) at ks (nk,) for scales (...,)
    and grid step dkt: the float64 kernel (port of select_pairs'
    _select_pair_kernel), float64 output (..., nk).  CPU tensors:
    pair_lerp_plain."""
    _check(u, scales, ks, dkt, _F64)
    return _PairLerp.apply(u, scales, ks, dkt)


def pair_lerp_f32(u, scales, ks, dkt):
    """As pair_lerp_f64 for float32 u: the float32-storage kernel (port of
    _select_pair_kernel_f32); index math, lerp and output in float64.
    CPU tensors: pair_lerp_plain."""
    _check(u, scales, ks, dkt, torch.float32)
    return _PairLerp.apply(u, scales, ks, dkt)


pair_lerp_f64.launches = 0
pair_lerp_f32.launches = 0


def pair_lerp(u, scales, ks, dkt):
    """``pair_lerp_f64`` or ``pair_lerp_f32`` by u's dtype."""
    if isinstance(u, torch.Tensor) and u.dtype == torch.float32:
        return pair_lerp_f32(u, scales, ks, dkt)
    return pair_lerp_f64(u, scales, ks, dkt)


def catmull_fill_plain(y, tap_i, tap_w):
    """The fill of y (..., nkq) by the taps tap_i (4, nk) and tap_w (4, nk):
    sum_j y[..., tap_i[j]] tap_w[j] in float64, as four gathers, four
    multiplies and four adds; (..., nk)."""
    return sum(y[..., tap_i[j]].to(_F64) * tap_w[j] for j in range(4))


def _check_fill(y, tap_i, tap_w):
    """Validate types, shapes and devices; raises on what the kernel does
    not take (``_CatmullFill.forward`` checks contiguity)."""
    for name, t in (("y", y), ("tap_i", tap_i), ("tap_w", tap_w)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if y.dtype not in (torch.float32, _F64):
        raise TypeError(f"y must be float32 or float64, got {y.dtype}")
    if tap_i.dtype != torch.int32:
        raise TypeError(f"tap_i must be int32, got {tap_i.dtype}")
    if tap_w.dtype != _F64:
        raise TypeError(f"tap_w must be float64, got {tap_w.dtype}")
    if tap_i.dim() != 2 or tap_i.shape[0] != 4 \
            or tap_w.shape != tap_i.shape:
        raise ValueError(f"tap_i and tap_w must both be (4, nk), got "
                         f"{tuple(tap_i.shape)} and {tuple(tap_w.shape)}")
    if y.dim() < 1 or y.shape[-1] < 1:
        raise ValueError(f"y must be (..., nkq) with nkq >= 1, got shape "
                         f"{tuple(y.shape)}")
    for name, t in (("tap_i", tap_i), ("tap_w", tap_w)):
        if t.device != y.device:
            raise ValueError(f"{name} is on {t.device}, expected {y.device}")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {y.device}")


def _launch_fill(y, tap_i, tap_w):
    from ..kernels._build import load_library

    nkq, nk = y.shape[-1], tap_i.shape[1]
    rows = y.numel() // nkq
    out = torch.empty((*y.shape[:-1], nk), dtype=_F64, device=y.device)
    if rows == 0 or nk == 0:
        return out
    lib = load_library()
    fn = (lib.hmvec_catmull_fill_f32 if y.dtype == torch.float32
          else lib.hmvec_catmull_fill_f64)
    err = fn(y.data_ptr(), tap_i.data_ptr(), tap_w.data_ptr(),
             out.data_ptr(), rows, nkq, nk, y.device.index, _stream(y))
    _raise_on_error(err, f"catmull_fill({y.dtype})")
    catmull_fill.launches += 1
    return out


class _CatmullFill(torch.autograd.Function):
    @staticmethod
    def forward(y, tap_i, tap_w):
        for name, t in (("y", y), ("tap_i", tap_i), ("tap_w", tap_w)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if y.is_cuda:
            return _launch_fill(y, tap_i, tap_w)
        return catmull_fill_plain(y, tap_i, tap_w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        y, tap_i, tap_w = inputs
        ctx.save_for_backward(y, tap_i, tap_w)
        ctx.save_for_forward(tap_i, tap_w)

    @staticmethod
    def backward(ctx, grad):
        y, tap_i, tap_w = ctx.saved_tensors
        _, vjp = torch.func.vjp(
            lambda y_: catmull_fill_plain(y_, tap_i, tap_w), y.detach())
        return vjp(grad)[0], None, None

    @staticmethod
    def jvp(ctx, t_y, _t_i, _t_w):
        """The fill is linear in y: its tangent is the fill of t_y."""
        tap_i, tap_w = ctx.saved_tensors
        return _CatmullFill.apply(t_y.contiguous(), tap_i, tap_w)

    @staticmethod
    def vmap(info, in_dims, y, tap_i, tap_w):
        """torch.func.vmap: the mapped dimension becomes one more leading
        dimension of the rows, so the kernel runs once for the batch."""
        y_bd, i_bd, w_bd = in_dims
        if i_bd is not None or w_bd is not None:
            raise NotImplementedError("catmull_fill under vmap takes one set "
                                      "of taps for every mapped element")
        return _CatmullFill.apply(y.movedim(y_bd, 0).contiguous(), tap_i,
                                  tap_w), 0


def catmull_fill(y, tap_i, tap_w):
    """The Catmull-Rom fill of y (..., nkq), float32 or float64, by the
    taps tap_i (4, nk) int32, each index in [0, nkq), and tap_w (4, nk)
    float64: float64 (..., nk), bit-equal to ``catmull_fill_plain``.  y and
    the taps contiguous, on one device; CUDA tensors launch the kernel,
    CPU tensors compute catmull_fill_plain."""
    _check_fill(y, tap_i, tap_w)
    return _CatmullFill.apply(y, tap_i, tap_w)


catmull_fill.launches = 0
