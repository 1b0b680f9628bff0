"""FFTLog spherical-Bessel transform on float64 tensors: the part of
hmvec_tpu/ops/fftlog.py that the 2-halo exclusion correction and the mean
pairwise velocity need (``fftlog_sine_j0``, ``fftlog_sphbessel_jl``,
``fftlog_lnkr`` and ``correlation_function``).  The profile transform, the
multi-l transform and ``projected_correlation`` come with the
fftlog/nonlimber group of ROADMAP A9.

The FFTLog kernel u_m (complex Gamma ratios) depends only on the static
grid, so it is built on the host in float64; the device does one rfft, a
complex multiply and one irfft, in complex128 on every device (the JAX
package drops to complex64 off the CPU because the TPU has no complex128).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from scipy.special import loggamma


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


def correlation_function(ks, pk):
    """xi(r) = (1/2 pi^2) int_0^inf dk k^2 P(k) j0(kr) by FFTLog, for pk
    (..., n) on the log-uniform ks (n,).  Returns (rs, xi): rs (n,) the
    reciprocal log grid [Mpc], xi (..., n)."""
    ks_np = (ks.detach().cpu().numpy() if isinstance(ks, torch.Tensor)
             else np.asarray(ks))
    rs, F = fftlog_sine_j0(torch.as_tensor(pk, dtype=torch.float64), ks_np)
    return rs, F / (2.0 * math.pi**2)
