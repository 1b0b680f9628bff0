"""The NFW profile kernels: hand-written CUDA for Hopper, their plain
PyTorch versions, and the wrappers that choose between them.

* ``nfw_uk(ks, scales, cs, tier=...)``: u(k) on the (row, k) grid.  Ports
  hmvec_tpu/ops/pallas_kernels.py ``nfw_uk_pallas`` (tier ``"fast"``,
  float32 output) and ``nfw_uk_pallas_ds`` (tier ``"exact"``, float64
  output) as the two instantiations of one CUDA kernel
  (csrc/nfw_kernels.cu).
* ``nfw_contract(ks, scales, cs, a, b)``: u(k) reduced on the spot to the
  two mass integrals S1 = sum_m a u^2 and S2 = sum_m b u.  Ports
  ``nfw_contract_pallas``; like it, the kernel computes u in the fast
  tier's float32 (within 2e-5 relative of the plain version on S1, S2),
  and it sums in float64.

Each kernel takes the per-row scale and concentration as they are and
computes its row constants itself, so a wrapper call on the card is one
launch.

A wrapper given CUDA tensors launches its kernel (building the library at
first use, kernels/_build.py) or raises; given CPU tensors it computes the
plain version, ``nfw_uk_plain`` or ``nfw_contract_plain``.  There is no
fallback between the two.  On the CPU both tiers of ``nfw_uk`` return the
float64 plain version.

Each kernel's wrapper (``nfw_uk_fast``, ``nfw_uk_exact``, ``nfw_contract``)
counts the launches of its kernel in ``<wrapper>.launches``.

Both wrappers are differentiable in ``scales``, ``cs`` (and ``a``, ``b``),
in reverse and forward mode, through a ``torch.autograd.Function`` whose
backward and jvp recompute the plain version's elementwise partials
du/dscale and du/dc with ``torch.func.vjp`` (the kernels have no
derivative of their own, as in the JAX package's ``_pair_lerp_tpu_jvp``).
"""

from __future__ import annotations

import contextlib

import torch

from ..models.profiles import nfw_uk_x

_F64 = torch.float64
TIERS = ("fast", "exact")
_MAX_ROWS = 2**31 - 1   # the C interface counts rows in an int
_MAX_GRID_Y = 65535
_UK_KS = 128            # k per block, csrc/nfw_kernels.cu kUkK * kUkTiles
_CONTRACT_KS = 32       # k per block, csrc/nfw_kernels.cu kContractK


@contextlib.contextmanager
def _calling_thread(t):
    """On CPU tensors, the block runs in the calling thread alone (torch's
    intra-op pool set to one thread, then restored).  torch evaluates
    float64 sin/cos/log on the CPU through MKL's vector math, split
    between its OpenMP threads, and once a second thread's share of a
    process's first such call came out at MKL's low-accuracy level (~1e-8
    relative, tools/vml_ep_repro.py); in one thread the plain version is
    the same whatever the thread count."""
    if t.device.type != "cpu":
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def nfw_uk_plain(ks, scales, cs):
    """u(k | row), shape (B, nk), from ks (nk,), scales = r_s (1+z) (B,) and
    concentrations cs (B,): profiles.nfw_uk_x on the (B, nk) grid."""
    with _calling_thread(ks):
        return nfw_uk_x(ks[None, :] * scales[:, None], cs[:, None])


def nfw_contract_plain(ks, scales, cs, a, b):
    """(S1, S2), each (nz, nk): S1 = sum_m a u^2, S2 = sum_m b u, with u on
    the (nz, nm, nk) grid from scales, cs, a, b of shape (nz, nm)."""
    with _calling_thread(ks):
        u = nfw_uk_x(ks[None, None, :] * scales[..., None], cs[..., None])
        return (torch.einsum("zm,zmk->zk", a, u**2),
                torch.einsum("zm,zmk->zk", b, u))


def _partials(ks, scales, cs):
    """u and its elementwise partials du/dscale, du/dc on the grid
    scales.shape + (nk,), by ``torch.func.vjp`` of the plain version with
    the row inputs broadcast to the full grid."""
    shape = (*scales.shape, ks.shape[0])
    s = scales.detach()[..., None].expand(shape)
    c = cs.detach()[..., None].expand(shape)
    k = ks.detach()
    with _calling_thread(k):
        u, vjp = torch.func.vjp(lambda s_, c_: nfw_uk_x(k * s_, c_), s, c)
        du_ds, du_dc = vjp(torch.ones_like(u))
    return u, du_ds, du_dc


def _stream(t):
    """PyTorch's current cudaStream_t on t's device, as a Python int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(tensors, shapes):
    """Validate dtype, rank, matching sizes and device; returns the device
    (the launch checks contiguity: under ``torch.func.vmap`` the wrapper
    sees the logical tensors, the launch the physical ones)."""
    dev = None
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dtype != _F64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.dim() != len(shapes[name]):
            raise ValueError(f"{name} must have {len(shapes[name])} "
                             f"dimensions, got shape {tuple(t.shape)}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    sizes = {}
    for name, t in tensors.items():
        for axis, size in zip(shapes[name], t.shape):
            if sizes.setdefault(axis, size) != size:
                raise ValueError(f"{name} has {size} along '{axis}', "
                                 f"expected {sizes[axis]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_contiguous(**tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on CUDA")


def _raise_on_error(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with cudaError_t "
                           f"{err}")


def _check_uk_grid(nrows, nk):
    """Rows ride on gridDim.x and k, 128 to a block, on gridDim.y
    (csrc/nfw_kernels.cu), so any batch of rows that fits in memory is
    one launch."""
    if nrows > _MAX_ROWS or -(-nk // _UK_KS) > _MAX_GRID_Y:
        raise ValueError(f"nfw_uk takes at most {_MAX_ROWS} rows and "
                         f"{_UK_KS * _MAX_GRID_Y} k, got {nrows} and {nk}")


def _check_contract_grid(nz, nk):
    """Redshifts (a batch folds into them) ride on gridDim.x and k, 32 to
    a block, on gridDim.y (csrc/nfw_kernels.cu)."""
    if nz > _MAX_ROWS or -(-nk // _CONTRACT_KS) > _MAX_GRID_Y:
        raise ValueError(f"nfw_contract takes at most {_MAX_ROWS} redshifts "
                         f"and {_CONTRACT_KS * _MAX_GRID_Y} k, got {nz} and "
                         f"{nk}")


def _launch_nfw_uk(ks, scales, cs, tier, out=None):
    """One launch of the tier's kernel into ``out`` (allocated if None)."""
    from ..kernels._build import load_library

    nrows, nk = scales.shape[0], ks.shape[0]
    if out is None:
        out = torch.empty((nrows, nk),
                          dtype=_F64 if tier == "exact" else torch.float32,
                          device=scales.device)
    if nrows == 0 or nk == 0:
        return out
    _check_uk_grid(nrows, nk)
    _check_contiguous(ks=ks, scales=scales, cs=cs)
    lib = load_library()
    fn = lib.hmvec_nfw_uk_f64 if tier == "exact" else lib.hmvec_nfw_uk_f32
    err = fn(ks.data_ptr(), scales.data_ptr(), cs.data_ptr(), out.data_ptr(),
             nrows, nk, scales.device.index, _stream(scales))
    _raise_on_error(err, f"nfw_uk(tier={tier!r})")
    _NFW_UK_TIERS[tier].launches += 1
    return out


def _launch_nfw_contract(ks, scales, cs, a, b, out=None):
    """One launch of the contraction kernel into ``out`` = (S1, S2)
    (allocated if None)."""
    from ..kernels._build import load_library

    nz, nm = scales.shape
    nk = ks.shape[0]
    if out is None:
        out = tuple(torch.empty((nz, nk), dtype=_F64, device=scales.device)
                    for _ in range(2))
    s1, s2 = out
    if nz == 0 or nk == 0:
        return s1, s2
    if nm == 0:
        return s1.zero_(), s2.zero_()
    _check_contract_grid(nz, nk)
    _check_contiguous(ks=ks, scales=scales, cs=cs, a=a, b=b)
    lib = load_library()
    err = lib.hmvec_nfw_contract(
        ks.data_ptr(), scales.data_ptr(), cs.data_ptr(), a.data_ptr(),
        b.data_ptr(), s1.data_ptr(), s2.data_ptr(), nz, nm, nk,
        scales.device.index, _stream(scales))
    _raise_on_error(err, "nfw_contract")
    nfw_contract.launches += 1
    return s1, s2


def _fold(t, bdim, batch_size):
    """t with its mapped dimension ``bdim`` (None: unmapped, so repeated)
    folded into its first dimension: (B, n, ...) -> (B n, ...), contiguous
    as the launch wants it."""
    t = (t.expand(batch_size, *t.shape) if bdim is None
         else t.movedim(bdim, 0))
    return t.reshape(batch_size * t.shape[1], *t.shape[2:]).contiguous()


def _refuse_mapped_ks(k_bd, what):
    if k_bd is not None:
        raise NotImplementedError(f"{what} under vmap takes one ks for "
                                  f"every mapped element")


class _NfwUk(torch.autograd.Function):
    @staticmethod
    def forward(ks, scales, cs, tier):
        if scales.is_cuda:
            return _launch_nfw_uk(ks, scales, cs, tier)
        return nfw_uk_plain(ks, scales, cs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ks, scales, cs, _ = inputs
        ctx.save_for_backward(ks, scales, cs)
        ctx.save_for_forward(ks, scales, cs)
        ctx.out_dtype = output.dtype

    @staticmethod
    def backward(ctx, grad):
        ks, scales, cs = ctx.saved_tensors
        _, du_ds, du_dc = _partials(ks, scales, cs)
        g = grad.to(_F64)
        return None, (g * du_ds).sum(-1), (g * du_dc).sum(-1), None

    @staticmethod
    def jvp(ctx, _t_ks, t_scales, t_cs, _t_tier):
        ks, scales, cs = ctx.saved_tensors
        _, du_ds, du_dc = _partials(ks, scales, cs)
        out = torch.zeros_like(du_ds)
        if t_scales is not None:
            out = out + du_ds * t_scales[:, None]
        if t_cs is not None:
            out = out + du_dc * t_cs[:, None]
        return out.to(ctx.out_dtype)

    @staticmethod
    def vmap(info, in_dims, ks, scales, cs, tier):
        """torch.func.vmap: the mapped dimension folds into the rows,
        (B, rows) -> B rows, so the kernel runs once for the batch."""
        k_bd, s_bd, c_bd, _ = in_dims
        _refuse_mapped_ks(k_bd, "nfw_uk")
        n = info.batch_size
        out = _NfwUk.apply(ks, _fold(scales, s_bd, n), _fold(cs, c_bd, n),
                           tier)
        return out.reshape(n, -1, out.shape[-1]), 0


class _NfwContract(torch.autograd.Function):
    @staticmethod
    def forward(ks, scales, cs, a, b):
        if scales.is_cuda:
            return _launch_nfw_contract(ks, scales, cs, a, b)
        return nfw_contract_plain(ks, scales, cs, a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, g1, g2):
        ks, scales, cs, a, b = ctx.saved_tensors
        u, du_ds, du_dc = _partials(ks, scales, cs)
        zero = torch.zeros((scales.shape[0], ks.shape[0]), dtype=_F64,
                           device=scales.device)
        g1 = zero if g1 is None else g1
        g2 = zero if g2 is None else g2
        grad_a = (g1[:, None, :] * u * u).sum(-1)
        grad_b = (g2[:, None, :] * u).sum(-1)
        # dL/du on the (z, m, k) grid
        g_u = (2.0 * a[..., None] * u * g1[:, None, :]
               + b[..., None] * g2[:, None, :])
        return (None, (g_u * du_ds).sum(-1), (g_u * du_dc).sum(-1),
                grad_a, grad_b)

    @staticmethod
    def jvp(ctx, _t_ks, t_scales, t_cs, t_a, t_b):
        ks, scales, cs, a, b = ctx.saved_tensors
        u, du_ds, du_dc = _partials(ks, scales, cs)
        du = torch.zeros_like(u)
        if t_scales is not None:
            du = du + du_ds * t_scales[..., None]
        if t_cs is not None:
            du = du + du_dc * t_cs[..., None]
        # sums over m written as broadcast products: the forward-mode
        # jacobian batches tangents with torch's vmap, which has no
        # batching rule for einsum
        t1 = (a[..., None] * (2.0 * u * du)).sum(1)
        t2 = (b[..., None] * du).sum(1)
        if t_a is not None:
            t1 = t1 + (t_a[..., None] * (u * u)).sum(1)
        if t_b is not None:
            t2 = t2 + (t_b[..., None] * u).sum(1)
        return t1, t2

    @staticmethod
    def vmap(info, in_dims, ks, scales, cs, a, b):
        """torch.func.vmap: the mapped dimension folds into z,
        (B, nz, nm) -> (B nz, nm), so the kernel runs once for the batch."""
        _refuse_mapped_ks(in_dims[0], "nfw_contract")
        n = info.batch_size
        s1, s2 = _NfwContract.apply(
            ks, *(_fold(t, bd, n) for t, bd in zip((scales, cs, a, b),
                                                   in_dims[1:])))
        return ((s1.reshape(n, -1, s1.shape[-1]),
                 s2.reshape(n, -1, s2.shape[-1])), (0, 0))


def _nfw_uk(tier, ks, scales, cs):
    _check({"ks": ks, "scales": scales, "cs": cs},
           {"ks": ("k",), "scales": ("row",), "cs": ("row",)})
    return _NfwUk.apply(ks, scales, cs, tier)


def nfw_uk_fast(ks, scales, cs):
    """u(k | row), shape (B, nk), from ks (nk,), scales = r_s (1+z) (B,) and
    concentrations cs (B,), all float64: the fast-tier kernel (port of
    nfw_uk_pallas), float32 output.  CPU tensors: nfw_uk_plain."""
    return _nfw_uk("fast", ks, scales, cs)


def nfw_uk_exact(ks, scales, cs):
    """As nfw_uk_fast, with the float64 kernel (port of nfw_uk_pallas_ds)
    and float64 output, within 1e-12 of nfw_uk_plain.  Its sin/cos reduce
    the phases k scale and k (1+c) scale by quadrants of a two-part pi/2,
    which holds that accuracy for any phase float64 itself resolves (it
    needs the quadrant count below 2^51; at a phase of 1e9 one ulp of the
    phase is already 1.2e-7 rad), so the arguments get no range check.
    CPU tensors: nfw_uk_plain."""
    return _nfw_uk("exact", ks, scales, cs)


nfw_uk_fast.launches = 0
nfw_uk_exact.launches = 0
_NFW_UK_TIERS = {"fast": nfw_uk_fast, "exact": nfw_uk_exact}


def nfw_uk(ks, scales, cs, *, tier="exact"):
    """u(k | row), shape (B, nk), for ks (nk,) and scales = r_s (1+z) and
    concentrations cs, both (B,); all float64.

    tier="exact": ``nfw_uk_exact``, the float64 kernel (port of
    nfw_uk_pallas_ds), float64 output.  tier="fast": ``nfw_uk_fast``, the
    float32 kernel (port of nfw_uk_pallas), float32 output.  CPU
    tensors: ``nfw_uk_plain`` (float64) for both tiers."""
    if tier not in _NFW_UK_TIERS:
        raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
    return _NFW_UK_TIERS[tier](ks, scales, cs)


def nfw_contract(ks, scales, cs, a, b):
    """(S1, S2), each (nz, nk) float64: S1 = sum_m a u^2, S2 = sum_m b u
    with u the NFW profile of scales = r_s (1+z) and cs; scales, cs, a, b
    are (nz, nm) float64 and ks (nk,).  On the card u is the fast tier's
    float32 and the sums float64; CPU tensors: ``nfw_contract_plain``."""
    _check({"ks": ks, "scales": scales, "cs": cs, "a": a, "b": b},
           {"ks": ("k",), "scales": ("z", "m"), "cs": ("z", "m"),
            "a": ("z", "m"), "b": ("z", "m")})
    return _NfwContract.apply(ks, scales, cs, a, b)


nfw_contract.launches = 0
