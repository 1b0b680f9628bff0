"""Batched real -> Fourier profile transform on tensors (port of
hmvec_tpu/ops/sine_transform.py).

A halo profile rho(x), sampled on a uniform x grid for every (z, m) row,
goes to u(k) in two steps:

1. the sine DFT  u_i = step sum_j y_j sin(2 pi i j / N)  of y = rho x,
   as -Im rfft(y) step (``sine_dft``), then u(kt) = u_i / kt_i / M on the
   uniform grid kt_i = i dkt, with M the profile's mass;
2. the resample of every row at the target ks: with the row's scale
   s = r_s (1+z), target k sits at fractional index p = k s / dkt of the
   kt grid (``resample_uniform_source``); flat at u(kt_1) below it and
   zero above Nyquist, as the reference's np.interp(left=u[1], right=0).
   On a CUDA tensor step 2 runs the hand-written kernel of
   ops/resample_kernels.py; on a CPU tensor its plain gather form.  It is
   the tensor's device that decides, never a fallback.

The JAX package's double-single MXU forms of the DFT (methods "mixed",
"mixed32" and the step/kt-folded matrix) work around the TPU's lack of
float64 and complex128; the card has both, so they are not ported and
raise NotImplementedError (ROADMAP A6).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from ..utils.weights import on_device_of_inputs, tensor_or_f64

from .resample_kernels import pair_lerp, pair_lerp_plain

_F64 = torch.float64


@functools.lru_cache(maxsize=8)
def _sine_matrix(n: int, nk: int):
    """S[j, i] = sin(2 pi i j / n), float64, on the host; the phase is
    reduced modulo n in integers to keep the sine's argument small."""
    j = np.arange(n)[:, None]
    i = np.arange(nk)[None, :]
    return np.sin(2.0 * np.pi * ((j * i) % n) / n)


def sine_dft(y, step, method: str = "auto"):
    """-Im[rfft(y)] * step along the last axis: y (..., N) real ->
    (..., N//2 + 1) of y's dtype.

    method: "fft" (``torch.fft.rfft``; complex128 for float64 y, complex64
    for float32) -- also what "auto" means on every device; "matmul" (the
    dense sine matrix in y's dtype with ``torch.matmul``)."""
    n = y.shape[-1]
    if method in ("auto", "fft"):
        return -torch.fft.rfft(y).imag * step
    if method == "matmul":
        s = torch.as_tensor(_sine_matrix(n, n // 2 + 1), dtype=y.dtype,
                            device=y.device)
        return torch.matmul(y, s) * step
    if method in ("mixed", "mixed32"):
        raise NotImplementedError(
            f"sine_dft method {method!r} is the JAX package's double-single "
            f"TPU form and is not ported (ROADMAP A6); use 'fft' or 'matmul'")
    raise ValueError(f"unknown sine_dft method {method!r}")


@on_device_of_inputs
def fft_integral(x, y):
    """int_0^inf dx x sin(kx) y(x) -> (ks, uk) for x, y (N,) on a uniform
    grid, with the reference's rfft conventions, including its
    step = extent / N.  A validator: compare with ``analytic_fft_integral``
    for y = exp(-x^2/2)."""
    x, y = tensor_or_f64(x), tensor_or_f64(y)
    n = x.shape[-1]
    step = (x[-1] - x[0]) / n
    uk = sine_dft(x * y, step)
    ks = (torch.arange(n // 2 + 1, dtype=x.dtype, device=x.device) * 2.0
          * math.pi / (n * step))
    return ks, uk


@on_device_of_inputs
def analytic_fft_integral(ks):
    """Closed form of ``fft_integral`` for y = exp(-x^2/2):
    sqrt(pi/2) k exp(-k^2/2)."""
    ks = tensor_or_f64(ks)
    return math.sqrt(math.pi / 2.0) * torch.exp(-(ks**2) / 2.0) * ks


@on_device_of_inputs
def uk_fft(rhofunc, rvir, dr: float = 0.001, rmax: float = 100):
    """A validator: u(k) of a radial profile by the sine transform, with
    the reference's conventions (radii arange(dr, rmax, dr), truncation at
    rvir, trapezoid mass norm, step = extent / N).  rhofunc maps the radii
    (a float64 tensor on rvir's device) to rho; rvir: a float64 tensor
    (...,).  Returns (kts, u) with u (..., N//2 + 1)."""
    rvir = torch.as_tensor(rvir, dtype=torch.float64)
    rs = torch.as_tensor(np.arange(dr, rmax, dr), device=rvir.device)
    rhos = rhofunc(rs)
    theta = (rs <= rvir[..., None]).to(rhos.dtype)
    integrand = rhos * theta
    dx = torch.diff(rs)
    prof = integrand * rs**2
    m = ((prof[..., 1:] + prof[..., :-1]) * dx / 2.0).sum(dim=-1) * 4.0 * math.pi
    n = rs.shape[-1]
    step = (rs[-1] - rs[0]) / n
    ukt = sine_dft(integrand * rs, step)
    kts = (torch.arange(n // 2 + 1, dtype=torch.float64, device=rs.device)
           * 2.0 * math.pi / (n * step))
    uk = (4.0 * math.pi * ukt / torch.where(kts == 0, 1.0, kts)
          / m[..., None])
    return kts, uk


@on_device_of_inputs
def uk_brute_force(r, rho, rvir, ks):
    """A validator: the profile transform by direct trapezoid quadrature,
    with the reference's conventions (truncation r < rvir, trapezoid mass
    norm).  r, rho: (nr,); ks: (nk,); returns (nk,)."""
    r = torch.as_tensor(r, dtype=torch.float64)
    rho = torch.as_tensor(rho, dtype=torch.float64, device=r.device)
    ks = torch.as_tensor(ks, dtype=torch.float64, device=r.device)
    w = (r < rvir).to(rho.dtype)
    dx = torch.diff(r)

    def trap(y):
        return ((y[..., 1:] + y[..., :-1]) * dx / 2.0).sum(dim=-1)

    m = trap(rho * w * r**2) * 4.0 * math.pi
    sinkr = torch.sin(r[:, None] * ks[None, :])
    integrand = (4.0 * math.pi * r[:, None] * sinkr * (rho * w)[:, None]
                 / ks[None, :])
    return trap(integrand.T) / m


def resample_uniform_source(u, dkt, scales, ks, method: str = "auto"):
    """u (..., nkt) on the uniform grid kt_i = i dkt, read at the physical
    k grid kt / s of each row's scale s (scales (...,)) and interpolated
    to the targets ks (nk,): float64 (..., nk).

    method: "gather" (``pair_lerp_plain``), "kernel" (the CUDA kernel
    through ``pair_lerp``; a CPU tensor raises) or "auto" (the kernel for
    a CUDA tensor, the gather form for a CPU tensor)."""
    if method == "auto":
        method = "kernel" if u.is_cuda else "gather"
    if method == "kernel":
        if not u.is_cuda:
            raise ValueError("resample method 'kernel' needs a CUDA tensor, "
                             f"got one on {u.device}")
        return pair_lerp(u, scales, ks, dkt)
    if method == "gather":
        return pair_lerp_plain(u, scales, ks, dkt)
    raise ValueError(f"unknown resample method {method!r}")


class SampleGrid(NamedTuple):
    """The x samples of a profile transform and their Fourier grid."""
    xs: torch.Tensor      # (nxs,) float64: np.linspace(0, xmax, nxs+1)[1:]
    step: float           # (xs[-1] - xs[0]) / nxs, the reference's quirk
    dkt: float            # 2 pi / (nxs step)
    kt: torch.Tensor      # (nxs//2 + 1,) float64: i dkt, with kt_0 = 1


@functools.lru_cache(maxsize=8)
def sample_grid(xmax: float, nxs: int, device: torch.device) -> SampleGrid:
    """The grid of ``generic_profile_fft`` for (xmax, nxs), on ``device``;
    cached, so that a pipeline copies it to the card once."""
    xs_np = np.linspace(0.0, xmax, nxs + 1)[1:]
    step = float((xs_np[-1] - xs_np[0]) / nxs)
    dkt = 2.0 * np.pi / (nxs * step)
    kt = np.arange(nxs // 2 + 1, dtype=np.float64) * dkt
    kt[0] = 1.0  # the kt = 0 entry is never sampled by the resample
    return SampleGrid(torch.as_tensor(xs_np, device=device), step, dkt,
                      torch.as_tensor(kt, device=device))


def profile_table(rhofunc_x, cmaxs, rss, zs, xmax, nxs,
                  do_mass_norm: bool = True, method: str = "auto",
                  sample_dtype=None):
    """The first step of ``generic_profile_fft``: (u, scales, dkt, norm),
    with u (nz, nm, nxs//2 + 1) the transform on the uniform kt grid of
    step dkt, scales = r_s (1+z) (nz, nm) the rows' scales for the
    resample, and norm (nz, nm) float64 a per-row factor to apply to the
    resampled rows, or None.  float64 samples: u = u(kt), float64, with
    the mass norm divided in, and norm None.  float32 samples: u = u(kt) M,
    float32, and norm = 1/M."""
    dev = cmaxs.device
    grid = sample_grid(float(xmax), int(nxs), dev)
    dtype = _F64 if sample_dtype is None else sample_dtype
    if dtype not in (_F64, torch.float32):
        raise ValueError(f"sample_dtype must be float64 or float32, got "
                         f"{sample_dtype}")
    rhos = rhofunc_x(grid.xs.to(dtype))
    if rhos.dim() == 1:
        rhos = rhos[None, None, :]
    theta = (grid.xs[None, None, :] <= cmaxs[..., None]).to(rhos.dtype)
    integrand = theta * rhos
    xs_s = grid.xs.to(rhos.dtype)
    y = integrand * xs_s[None, None, :]
    zs = torch.as_tensor(zs, dtype=_F64, device=dev)
    scales = rss * (1.0 + zs)[:, None]

    mnorm = None
    if do_mass_norm:
        dx = torch.diff(xs_s)
        prof = integrand * xs_s[None, None, :] ** 2
        # float64 accumulation even for float32 samples (positive terms)
        mnorm = ((prof[..., 1:] + prof[..., :-1]) * dx / 2.0).sum(
            dim=-1, dtype=_F64)

    ukt = sine_dft(y, grid.step, method=method)
    if ukt.dtype == torch.float32:
        # the per-row 1/M commutes with the lerp along kt, so it is
        # applied to the (nz, nm, nk) result instead of the table
        norm = None if mnorm is None else 1.0 / mnorm
        return ukt / grid.kt.to(torch.float32), scales, grid.dkt, norm
    uk = ukt / grid.kt[None, None, :]
    if mnorm is not None:
        uk = uk / mnorm[..., None]
    return uk, scales, grid.dkt, None


@on_device_of_inputs
def generic_profile_fft(rhofunc_x, cmaxs, rss, zs, ks, xmax, nxs,
                        do_mass_norm: bool = True, method: str = "auto",
                        sample_dtype=None):
    """Profile transform u(k | z, m): returns (ks, u), u (nz, nm, nk)
    float64 on the device of cmaxs.

    rhofunc_x: samples the profile on xs (nxs,) -> (nz, nm, nxs) or (nxs,)
    cmaxs:     (nz, nm) dimensionless cutoff (e.g. concentration)
    rss:       (nz, nm) scale radii in physical Mpc
    zs:        (nz,) redshifts; ks: (nk,) target comoving wavenumbers
    xmax, nxs: the sample grid, Python numbers (they shape it)
    method:    the sine DFT's (``sine_dft``)
    sample_dtype: None or torch.float64 -- float64 samples, DFT, table and
        resample; torch.float32 -- float32 samples (the exponent of the
        profile is still formed in float64), complex64 DFT, a float32
        u(kt) table resampled by the float32-storage kernel, and the mass
        norm applied after the resample.  Deviation from the JAX package:
        None means float64 on every device; JAX picks float32 on the TPU.

    The reference's sampling conventions are kept exactly: xs from
    np.linspace in float64, step = (xs[-1] - xs[0]) / nxs, the cutoff mask
    from the float64 grid whatever the sample dtype, and the mass norm
    accumulated in float64.
    """
    cmaxs, rss, zs, ks = map(tensor_or_f64, (cmaxs, rss, zs, ks))
    u, scales, dkt, norm = profile_table(rhofunc_x, cmaxs, rss, zs, xmax,
                                         nxs, do_mass_norm, method,
                                         sample_dtype)
    ks = torch.as_tensor(ks, dtype=_F64, device=cmaxs.device)
    uk = resample_uniform_source(u, dkt, scales, ks)
    return ks, uk if norm is None else uk * norm[..., None]
