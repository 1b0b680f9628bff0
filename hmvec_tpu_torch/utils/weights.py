"""Quadrature weight constructors (the numpy ones a copy of
hmvec_tpu/utils/weights.py), and the float64 conversions the models share.

All halo-model integrals (sigma^2, mass-function integrals) are linear
functionals of the integrand, so static weight vectors are built once per
grid on the host and the reductions run on the device as matmuls or
weighted sums.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import inspect

import numpy as np
import torch

_ON_DEVICE: dict = {}


def f64(x, device=None):
    """x as a float64 tensor on ``device`` (None: a tensor stays where it
    is, host data goes to the CPU)."""
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def device_of(*xs):
    """The device of the first tensor among xs, looked for through lists,
    tuples and dict values; None if there is none."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
        if isinstance(x, dict):
            x = list(x.values())
        if isinstance(x, (list, tuple)):
            dev = device_of(*x)
            if dev is not None:
                return dev
    return None


def tensor_or_f64(x):
    """x itself if it is a tensor (dtype and device kept), else x as a
    float64 tensor on the default device (``on_device_of_inputs`` sets
    it)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=torch.float64)


def on_device_of_inputs(fn):
    """fn with a keyword ``device`` (the card by default): the one rule by
    which a free function of the package chooses its device.  A call with
    a tensor among its arguments (at any depth of their lists, tuples and
    dicts) runs on the first such tensor's device, as written; a call with
    host data only (numpy arrays, numbers) runs on ``device``, as the
    default device of every tensor it makes.  A call made inside another
    such call, with host data and no ``device``, takes the outer call's
    device (a function of tensors that hands a number to another keeps
    its work on one device).  ``call_device()`` reads the device chosen."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        device = kwargs.pop("device", None)
        dev = device_of(args, kwargs)
        host_only = dev is None
        if host_only:
            dev = torch.device(device if device is not None
                               else _CALL_DEVICE.get() or "cuda")
        token = _CALL_DEVICE.set(dev)
        try:
            with dev if host_only else contextlib.nullcontext():
                return fn(*args, **kwargs)
        finally:
            _CALL_DEVICE.reset(token)

    sig = inspect.signature(fn)
    params = list(sig.parameters.values())
    at = next((i for i, q in enumerate(params)
               if q.kind is inspect.Parameter.VAR_KEYWORD), len(params))
    params.insert(at, inspect.Parameter(
        "device", inspect.Parameter.KEYWORD_ONLY, default="cuda"))
    wrapper.__signature__ = sig.replace(parameters=params)
    return wrapper


# the device of the innermost on_device_of_inputs call under way
_CALL_DEVICE = contextvars.ContextVar("hmvec_call_device", default=None)


def call_device() -> torch.device:
    """The device that the innermost ``on_device_of_inputs`` call under
    way chose (the default device outside any)."""
    return _CALL_DEVICE.get() or torch.get_default_device()


def host(x) -> np.ndarray:
    """A grid as a float64 numpy array (a tensor is read back)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def mass_weights(ms):
    """Trapezoid weights of a tensor grid, built on its device with the
    arithmetic of trapz_weights (so bit-identical to it)."""
    half = torch.diff(ms) / 2.0
    zero = torch.zeros_like(ms[:1])
    return torch.cat([half, zero]) + torch.cat([zero, half])


def grid_weights(x, device):
    """Trapezoid weights of a grid on ``device``: from the host for a numpy
    grid, on the device for a tensor (no read back either way)."""
    if isinstance(x, torch.Tensor):
        return mass_weights(x.to(device, torch.float64))
    return f64(trapz_weights(np.asarray(x, dtype=np.float64)), device)


def on_device(key: str, device, make):
    """The host arrays of ``make()`` (a tuple) as tensors of their own
    dtype on ``device``: built and copied there once per (key, device), so
    a call on the card copies no static grid."""
    if (key, device) not in _ON_DEVICE:
        _ON_DEVICE[key, device] = tuple(
            torch.as_tensor(np.array(a), device=device) for a in make())
    return _ON_DEVICE[key, device]


def trapz_weights(x: np.ndarray) -> np.ndarray:
    """Weights w such that w @ y == np.trapezoid(y, x) exactly."""
    x = np.asarray(x, dtype=np.float64)
    w = np.zeros_like(x)
    dx = np.diff(x)
    w[:-1] += dx / 2.0
    w[1:] += dx / 2.0
    return w


def simpson_weights(x: np.ndarray) -> np.ndarray:
    """Weights for composite Simpson on a (possibly nonuniform) grid.

    Matches scipy.integrate.simpson semantics: interval pairs from the left;
    if the number of intervals is odd, the trailing interval uses the
    Cartwright asymmetric correction (as in scipy >= 1.11).
    Used for the sigma^2(R,z) integral (reference: cosmology.py:262-265).
    """
    x = np.asarray(x, dtype=np.float64)
    n = x.size
    if n < 3:
        return trapz_weights(x)
    w = np.zeros_like(x)
    nint = n - 1
    npairs = nint // 2
    # paired panels [x0,x1,x2]
    i0 = 2 * np.arange(npairs)
    h0 = x[i0 + 1] - x[i0]
    h1 = x[i0 + 2] - x[i0 + 1]
    hsum = h0 + h1
    np.add.at(w, i0, hsum / 6.0 * (2.0 - h1 / h0))
    np.add.at(w, i0 + 1, hsum / 6.0 * (hsum**2 / (h0 * h1)))
    np.add.at(w, i0 + 2, hsum / 6.0 * (2.0 - h0 / h1))
    if nint % 2 == 1:
        # Cartwright correction over the last three points
        h0l = x[-2] - x[-3]
        h1l = x[-1] - x[-2]
        alpha = (2 * h1l**2 + 3 * h0l * h1l) / (6 * (h0l + h1l))
        beta = (h1l**2 + 3 * h0l * h1l) / (6 * h0l)
        eta = h1l**3 / (6 * h0l * (h0l + h1l))
        w[-1] += alpha
        w[-2] += beta
        w[-3] -= eta
    return w


from functools import lru_cache


@lru_cache(maxsize=64)
def leggauss_cached(n: int):
    """Gauss-Legendre nodes/weights on [-1, 1], memoized.

    Large n: scipy's roots_legendre (Newton + asymptotic initial
    guesses) instead of numpy's leggauss (companion-matrix
    eigendecomposition) -- same nodes to ~1e-16 but ~35x faster;
    leggauss(8192) costs ~70 s of HOST time on a 1-core box and was
    silently re-paid on every lensed-Cls call.  Small n: numpy's exact
    legacy nodes (cheap there, and several oracles pin quadrature
    results at 1e-12 where the ~1e-16 node difference is visible).
    Memoized because the node sets are a handful of static sizes reused
    across calls/tests."""
    n = int(n)
    if n < 512:
        x, w = np.polynomial.legendre.leggauss(n)
    else:
        from scipy.special import roots_legendre
        x, w = roots_legendre(n)
    x, w = np.asarray(x), np.asarray(w)
    # the cache hands out THE SAME arrays on every call: freeze them so
    # an in-place rescale by any caller cannot corrupt quadrature
    # process-wide (callers must use out-of-place ops, as they all do)
    x.flags.writeable = False
    w.flags.writeable = False
    return x, w


def gauss_legendre(n: int):
    """Gauss-Legendre nodes/weights on [0, 1]."""
    t, w = leggauss_cached(n)
    return (t + 1.0) / 2.0, w / 2.0


def catmull_taps_nonuniform(src, dst):
    """4-tap gather stencil (idx (4, nd), weights (4, nd)) evaluating a
    nonuniform Catmull-Rom cubic through nodes ``src`` at points ``dst``
    as  f(dst) = sum_j W[j] * f_src[idx[j]].

    Finite-difference tangents m_i = (p_{i+1} - p_{i-1})/(x_{i+1} -
    x_{i-1}) (one-sided at the ends -- points in the first/last interval
    interpolate, never extrapolate from a neighboring interval); exact at
    nodes.  Host-side statics: both grids must be concrete, so the taps
    compile to static gathers (used by the batch-serving NFW u(k)
    low-k subsampling in pipeline._stages).
    """
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    n = src.size
    i = np.clip(np.searchsorted(src, dst, side="right") - 1, 0, n - 2)
    x0, x1 = src[i], src[i + 1]
    h = x1 - x0
    t = (dst - x0) / h
    h00 = 2 * t**3 - 3 * t**2 + 1
    h10 = t**3 - 2 * t**2 + t
    h01 = -2 * t**3 + 3 * t**2
    h11 = t**3 - t**2
    im = np.maximum(i - 1, 0)
    ip = np.minimum(i + 2, n - 1)
    dA = src[i + 1] - src[im]
    dB = src[ip] - src[i]
    W = np.zeros((4, dst.size))
    idx = np.stack([im, i, i + 1, ip])
    W[0] += -h10 * h / dA
    W[2] += h10 * h / dA + h01
    W[1] += h00 - h11 * h / dB
    W[3] += h11 * h / dB
    return idx, W
