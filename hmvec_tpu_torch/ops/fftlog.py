"""FFTLog spherical-Bessel transforms on float64 tensors (port of
hmvec_tpu/ops/fftlog.py): ``fftlog_sine_j0``, ``fftlog_sphbessel_jl``,
the multi-l ``fftlog_sphbessel_multi``, ``fftlog_lnkr``, the log-sampled
``fftlog_profile_transform``, ``correlation_function`` and
``projected_correlation``.

The FFTLog kernel u_m (complex Gamma ratios) depends only on the static
grid, so it is built on the host in float64; the device does one rfft, a
complex multiply and one irfft, in complex128 on every device (the JAX
package drops to complex64 off the CPU because the TPU has no complex128),
so a result on the card matches the JAX package on the CPU, not on a TPU.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from scipy.special import loggamma

from ..ops.quadrature import linear_interp
from ..utils.weights import (call_device, f64, leggauss_cached, on_device,
                             on_device_of_inputs)


@functools.lru_cache(maxsize=16)
def _fftlog_kernel(n: int, dlnx: float, mu: float = 0.5, q: float = 0.0,
                   lnkr=None):
    """(u_m, lnkr): the Hankel-transform kernel of order mu and bias q on
    an n-point log grid of step dlnx, with the low-ringing offset
    ln(kc xc) that makes u_{n/2} real unless ``lnkr`` is given (host-side
    float64, the JAX package's arithmetic)."""
    m = np.arange(n // 2 + 1)
    eta = 2.0 * np.pi * m / (n * dlnx)
    zp = (mu + 1.0 + q) / 2.0 + 1j * eta / 2.0
    zm = (mu + 1.0 - q) / 2.0 - 1j * eta / 2.0
    u = np.exp((q + 1j * eta) * np.log(2.0) + loggamma(zp) - loggamma(zm))
    if lnkr is None:
        lnkr = 0.0
        arg = np.angle(u[-1] * np.exp(-1j * eta[-1] * lnkr))
        lnkr += arg / eta[-1] if eta[-1] != 0 else 0.0
        u = u * np.exp(-1j * eta * lnkr)
        u[-1] = u[-1].real
    else:
        u = u * np.exp(-1j * eta * float(lnkr))
    return u, float(lnkr)


def fftlog_sine_j0(fx, xs, mu: float = 0.5, lnkr=None):
    """F(k) = int_0^inf f(x) j0(kx) x^2 dx for f (..., n) sampled on the
    log-uniform numpy grid xs (n,).  Returns (ks, F): ks (n,) the
    reciprocal log grid as a float64 tensor on fx's device, F (..., n)."""
    xs = np.asarray(xs, dtype=np.float64)
    n = xs.size
    dlnx = float(np.log(xs[1] / xs[0]))
    u_np, lnkr = _fftlog_kernel(n, dlnx, mu=mu, q=0.0, lnkr=lnkr)
    dev = fx.device

    def t(a):
        return torch.as_tensor(a, device=dev)

    b = fx * t(xs**1.5)
    k0 = float(np.exp(lnkr) / xs[0] * np.exp(-n * dlnx))
    ks = k0 * np.exp(np.arange(n) * dlnx)
    A = torch.fft.irfft(torch.conj(torch.fft.rfft(b) * t(u_np)), n=n)
    F = math.sqrt(math.pi / 2.0) * A * t(ks**-1.5)
    return t(ks), F.to(fx.dtype)


def fftlog_sphbessel_jl(fx, xs, ell: int, lnkr=None):
    """F(k) = int_0^inf f(x) j_ell(kx) x^2 dx by FFTLog: j_ell(x) =
    sqrt(pi / 2x) J_{ell+1/2}(x), so this is the mu = ell + 1/2 path of
    ``fftlog_sine_j0``.  Give the ell = 0 ``lnkr`` (``fftlog_lnkr``) to put
    several ells on one output grid."""
    return fftlog_sine_j0(fx, xs, mu=ell + 0.5, lnkr=lnkr)


def fftlog_lnkr(xs, mu: float = 0.5):
    """The low-ringing ln(kc xc) offset of the log grid xs at order mu."""
    xs = np.asarray(xs, dtype=np.float64)
    _, lnkr = _fftlog_kernel(xs.size, float(np.log(xs[1] / xs[0])), mu=mu)
    return lnkr


@on_device_of_inputs
def correlation_function(ks, pk):
    """xi(r) = (1/2 pi^2) int_0^inf dk k^2 P(k) j0(kr) by FFTLog, for pk
    (..., n) on the log-uniform ks (n,), on pk's device (or ks's), else on
    ``device`` (the card unless the caller asks for the CPU).  Returns (rs,
    xi): rs (n,) the reciprocal log grid [Mpc], xi (..., n)."""
    ks_np = (ks.detach().cpu().numpy() if isinstance(ks, torch.Tensor)
             else np.asarray(ks))
    rs, F = fftlog_sine_j0(f64(pk, call_device()), ks_np)
    return rs, F / (2.0 * math.pi**2)


@functools.lru_cache(maxsize=8)
def _sphbessel_multi_kernel(ells: tuple, n: int, dlnx: float, lnkr: float):
    """The per-l FFTLog kernels U[il, m] of mu = l + 1/2 stacked (host
    float64), every row on the one offset ``lnkr`` so that all ls land on
    one output k grid."""
    rows = [_fftlog_kernel(n, dlnx, mu=ell + 0.5, lnkr=lnkr)[0]
            for ell in ells]
    return np.stack(rows, axis=0)


def fftlog_sphbessel_multi(fx, xs, ells, lnkr=None):
    """F_l(k) = int_0^inf f(x) j_l(kx) x^2 dx for many l at once.

    fx: (..., n) tensor sampled on the log-uniform numpy grid xs (n,);
    ells: integer multipoles.  Returns (ks (n,), F (..., nl, n)): one rfft
    of the x^{3/2}-dressed input, one (nl, n/2+1) complex multiply against
    the host kernels and one batched irfft, in complex128 on every device
    (the JAX package runs complex64 off the CPU, so the card matches
    JAX on the CPU)."""
    xs = np.asarray(xs, dtype=np.float64)
    n = xs.size
    dlnx = float(np.log(xs[1] / xs[0]))
    ells_t = tuple(int(l) for l in np.asarray(ells))
    if lnkr is None:
        lnkr = fftlog_lnkr(xs, mu=ells_t[0] + 0.5)
    lnkr = float(lnkr)
    k0 = float(np.exp(lnkr) / xs[0] * np.exp(-n * dlnx))
    ks = k0 * np.exp(np.arange(n) * dlnx)
    u, dress, undress, ks_t = on_device(
        f"fftlog_multi:{ells_t}:{n}:{dlnx!r}:{lnkr!r}", fx.device,
        lambda: (_sphbessel_multi_kernel(ells_t, n, dlnx, lnkr), xs**1.5,
                 ks**-1.5, ks))
    b = fx * dress
    A = torch.fft.irfft(torch.conj(torch.fft.rfft(b)[..., None, :] * u),
                        n=n, dim=-1)
    F = math.sqrt(math.pi / 2.0) * A * undress
    return ks_t, F.to(fx.dtype)


@on_device_of_inputs
def fftlog_profile_transform(rhofunc_x, cmaxs, rss, zs, ks_out,
                             xmin: float = 1e-5, xmax: float = 1e3,
                             n: int = 1024, do_mass_norm: bool = True):
    """u(k) of a profile rho(x) truncated at cmaxs, by FFTLog on n
    log-spaced x (the JAX package's experimental alternative to
    ``generic_profile_fft``): radial moments by log-trapezoid, a low-k
    Taylor branch where (k x_rms)^2 is small, and the reciprocal grid
    resampled onto ``ks_out`` at each row's scale rss (1+z) by a gather
    and a lerp with the JAX package's clamps (the nearest end below the
    grid, zero above it).

    rhofunc_x maps x (n,) to (n,) or (nz, nm, n); cmaxs, rss (nz, nm) and
    zs (nz,) are tensors or arrays: the work runs on the first tensor's
    device, else on ``device`` (the card unless the caller asks for the
    CPU).  Returns (ks_out, u (nz, nm, nk))."""
    dev = call_device()
    as_t = lambda v: torch.as_tensor(v, dtype=torch.float64, device=dev)
    cmaxs, rss, zs, ks_out = as_t(cmaxs), as_t(rss), as_t(zs), as_t(ks_out)
    xs_np = np.geomspace(xmin, xmax, n)
    xs = as_t(xs_np)
    rhos = rhofunc_x(xs)
    if rhos.dim() == 1:
        rhos = rhos[None, None, :]
    theta = (xs[None, None, :] <= cmaxs[..., None]).to(rhos.dtype)
    fx = rhos * theta

    # radial moments by log-trapz: m_{2n} = int 4 pi x^{2+2n} rho dx
    dln = float(np.log(xs_np[1] / xs_np[0]))

    def logmoment(power):
        integ = 4.0 * math.pi * fx * xs[None, None, :] ** (power + 1)
        return (integ[..., :-1] + integ[..., 1:]).sum(-1) * (dln / 2.0)

    m0 = logmoment(2)
    m2 = logmoment(4)
    m4 = logmoment(6)
    mnorm = m0 if do_mass_norm else torch.ones_like(m0)

    kts, F = fftlog_sine_j0(fx, xs_np)
    uk = 4.0 * math.pi * F / mnorm[..., None]

    # low-k Taylor stitch where the quadratic term is below 5%
    k2 = kts[None, None, :] ** 2
    u_taylor = (m0[..., None] - k2 * m2[..., None] / 6.0
                + k2**2 * m4[..., None] / 120.0) / mnorm[..., None]
    small = k2 * (m2 / m0)[..., None] / 6.0 < 5e-2
    uk = torch.where(small, u_taylor, uk)

    # resample onto the target ks: index algebra on the log-uniform grid
    kts_np = kts.cpu().numpy()
    dlnk = float(np.log(kts_np[1] / kts_np[0]))
    scales = rss * (1.0 + zs)[:, None]                    # (nz, nm)
    p = (torch.log(ks_out)[None, None, :] + torch.log(scales)[..., None]
         - float(np.log(kts_np[0]))) / dlnk
    nkt = kts_np.size
    i0 = torch.floor(p).clamp(0, nkt - 2).long()
    frac = (p - i0).clamp(0.0, 1.0)
    u0 = torch.gather(uk, -1, i0)
    u1 = torch.gather(uk, -1, i0 + 1)
    val = u0 + frac * (u1 - u0)
    val = torch.where(p < 0.0, uk[..., :1], val)
    val = torch.where(p > nkt - 1.0, 0.0, val)
    return ks_out, val


@on_device_of_inputs
def projected_correlation(ks, pk, n_t: int = 192, t_max: float = 9.0):
    """w_p(R) = 2 R int_0^inf dt cosh(t) xi(R cosh t) on the FFTLog xi(r)
    of pk (..., n) on the log-uniform ks (n,), with n_t Gauss-Legendre
    nodes on [0, t_max] and xi taken as 0 beyond its grid, on the device
    that ``correlation_function`` picks.  Returns (Rs, wp) on the
    reciprocal log grid [Mpc]."""
    rs_t, xi = correlation_function(ks, pk)
    rs = rs_t.cpu().numpy()
    t_np, w_np = leggauss_cached(n_t)
    lnrs, t, wt = on_device(
        f"projected_correlation:{n_t}:{t_max!r}:{rs[0]!r}:{rs.size}",
        xi.device,
        lambda: (np.log(rs), 0.5 * t_max * (t_np + 1.0), 0.5 * t_max * w_np))
    ch = torch.cosh(t)                                    # (nt,)
    ln_r_eval = lnrs[:, None] + torch.log(ch)[None, :]    # (n, nt)
    xi2 = xi.reshape(-1, rs.size)
    v = linear_interp(ln_r_eval, lnrs, xi2, right=0.0)   # (rows, n, nt)
    wp = 2.0 * rs_t * ((v * ch) @ wt)
    return rs_t, wp.reshape(xi.shape).to(xi.dtype)
