"""Halo mass function, bias and virial definitions on float64 tensors (port
of hmvec_tpu/models/mass_function.py).

Five modes of ``mass_function_grid``: Sheth-Tormen; Press-Schechter and
Despali 2016, which are the Sheth-Tormen forms with fixed constants;
Tinker 2010 (f(nu) with its bias-consistency norm computed from its
defining integral, and the Tinker 2010 bias); and Tinker 2008 f(sigma) with
its redshift evolution, paired with the Tinker 2010 bias.  The Tinker
parameters at any overdensity in [200, 3200] come from a natural cubic
spline in log10(Delta) through the papers' tables.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..ops.quadrature import gradient
from ..utils.weights import trapz_weights

DELTAC = 1.686
_F64 = torch.float64


def _tensor(x, device=None):
    """x as a float64 tensor (on ``device`` when x is not one already)."""
    if isinstance(x, torch.Tensor):
        return x.to(_F64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def _column(delta, device=None):
    """delta as a float64 tensor, a (nz,) one as a (nz, 1) column."""
    d = _tensor(delta, device)
    return d[:, None] if d.dim() == 1 else d


def R_from_M(M, rho, delta):
    """Radius enclosing mass M at overdensity delta x rho."""
    return (3.0 * M / 4.0 / math.pi / delta / rho) ** (1.0 / 3.0)


def deltav_bryan_norman(omz):
    """Virial overdensity with respect to the critical density."""
    x = omz - 1.0
    return 18.0 * math.pi**2 + 82.0 * x - 39.0 * x**2


def fsigmaz_sheth_torman(sigma2, params):
    """nu f(nu) for Sheth-Tormen."""
    A = params["st_A"]
    a = params["st_a"]
    p = params["st_p"]
    deltac = params["st_deltac"]
    sigma = torch.sqrt(sigma2)
    amp = 2.0 * a / math.pi
    amp = torch.sqrt(amp) if isinstance(amp, torch.Tensor) else math.sqrt(amp)
    return (A * amp
            * (1.0 + (sigma2 / a / deltac**2) ** p)
            * (deltac / sigma)
            * torch.exp(-a * deltac**2 / 2.0 / sigma2))


def bias_sheth_torman(sigma2, params):
    """Sheth-Tormen halo bias."""
    a = params["st_a"]
    p = params["st_p"]
    deltac = params["st_deltac"]
    return (1.0 + (1.0 / deltac) * ((a * deltac**2 / sigma2) - 1.0)
            + (2.0 * p / deltac) / (1.0 + (a * deltac**2 / sigma2) ** p))


# Press-Schechter (A = 1/2, a = 1, p = 0: an identity, not a fit) and
# Despali et al. 2016 (the virial-overdensity values of their eq. 12) in
# the Sheth-Tormen form; the biases are the peak-background split of the
# same forms.
_PS_PARAMS = {"st_A": 0.5, "st_a": 1.0, "st_p": 0.0, "st_deltac": DELTAC}
_DESPALI_PARAMS = {"st_A": 0.3292, "st_a": 0.7665, "st_p": 0.2488,
                   "st_deltac": DELTAC}


# ---- Tinker overdensity-parameter tables -------------------------------
# The published tables at nine overdensities (Delta with respect to the
# mean matter density), read by a natural cubic spline in x = log10(Delta)
# whose second derivatives are solved once on the host.
_TINKER_DELTAS = np.array(
    [200.0, 300.0, 400.0, 600.0, 800.0, 1200.0, 1600.0, 2400.0, 3200.0])
_TINKER_LOGD = np.log10(_TINKER_DELTAS)

# Tinker 2008 Table 2: A, a, b, c of f(sigma)
_T08_ROWS = np.array([
    # A      a     b     c
    [0.186, 1.47, 2.57, 1.19],
    [0.200, 1.52, 2.25, 1.27],
    [0.212, 1.56, 2.05, 1.34],
    [0.218, 1.61, 1.87, 1.45],
    [0.248, 1.87, 1.59, 1.58],
    [0.255, 2.13, 1.51, 1.80],
    [0.260, 2.30, 1.46, 1.97],
    [0.260, 2.53, 1.44, 2.24],
    [0.260, 2.66, 1.41, 2.44]])

# Tinker 2010 Table 4: beta0, gamma0, phi0, eta0 of f(nu) (alpha0 is
# replaced by the bias-consistency integral, computed at any Delta)
_T10_ROWS = np.array([
    # beta0  gamma0  phi0    eta0
    [0.589, 0.864, -0.729, -0.243],
    [0.585, 0.922, -0.789, -0.261],
    [0.544, 0.987, -0.910, -0.261],
    [0.543, 1.09, -1.05, -0.273],
    [0.564, 1.20, -1.20, -0.278],
    [0.623, 1.34, -1.26, -0.301],
    [0.637, 1.50, -1.45, -0.301],
    [0.673, 1.68, -1.50, -0.319],
    [0.702, 1.81, -1.49, -0.336]])


def _natural_spline_d2(ys):
    """Second derivatives of the natural cubic spline through
    (_TINKER_LOGD, ys): a tridiagonal solve in numpy."""
    x = _TINKER_LOGD
    n = x.size
    h = np.diff(x)
    A = np.zeros((n, n))
    r = np.zeros(n)
    A[0, 0] = A[-1, -1] = 1.0
    for i in range(1, n - 1):
        A[i, i - 1] = h[i - 1] / 6.0
        A[i, i] = (h[i - 1] + h[i]) / 3.0
        A[i, i + 1] = h[i] / 6.0
        r[i] = (ys[i + 1] - ys[i]) / h[i] - (ys[i] - ys[i - 1]) / h[i - 1]
    return np.linalg.solve(A, r)


_T08_D2 = np.stack([_natural_spline_d2(_T08_ROWS[:, j]) for j in range(4)])
_T10_D2 = np.stack([_natural_spline_d2(_T10_ROWS[:, j]) for j in range(4)])


@functools.lru_cache(maxsize=None)
def _on_device(name: str, device: torch.device) -> torch.Tensor:
    """One of this module's host tables as a float64 tensor on ``device``,
    copied there once."""
    return torch.as_tensor(globals()[name], dtype=_F64, device=device)


def _tinker_spline(rows, d2s, delta):
    """The four parameter splines at ``delta`` (any shape).  log10(Delta) is
    clamped to the tables' [200, 3200]; at a node the spline returns the
    node's value exactly."""
    delta = _tensor(delta)
    dev = delta.device
    xs = _on_device("_TINKER_LOGD", dev)
    x = torch.clamp(torch.log10(delta), float(_TINKER_LOGD[0]),
                    float(_TINKER_LOGD[-1]))
    # gather through a 1-d index: a 0-d index tensor would be read back to
    # the host
    shape = x.shape
    xf = x.reshape(-1)
    i = torch.clamp(torch.searchsorted(xs, xf.contiguous(), right=True) - 1,
                    0, xs.numel() - 2)
    h = xs[i + 1] - xs[i]
    a = (xs[i + 1] - xf) / h
    b = (xf - xs[i]) / h
    y_t, y2_t = (_on_device(n, dev) for n in (rows, d2s))
    out = []
    for j in range(4):
        y, y2 = y_t[:, j], y2_t[j]
        v = (a * y[i] + b * y[i + 1]
             + ((a**3 - a) * y2[i] + (b**3 - b) * y2[i + 1]) * h**2 / 6.0)
        out.append(v.reshape(shape))
    return tuple(out)


def tinker2008_params(delta):
    """(A, a, b, c) of the Tinker-2008 f(sigma) at overdensity ``delta``
    (with respect to the mean matter density; Table 2 spline)."""
    return _tinker_spline("_T08_ROWS", "_T08_D2", delta)


def tinker2010_params(delta):
    """(beta0, gamma0, phi0, eta0) of the Tinker-2010 f(nu) at overdensity
    ``delta`` (Table 4 spline; z = 0 values)."""
    return _tinker_spline("_T10_ROWS", "_T10_D2", delta)


def bias_tinker(nu, delta=200.0):
    """Tinker et al. 2010 eq. 6 bias."""
    nu = _tensor(nu)
    if isinstance(delta, torch.Tensor):
        y = torch.log10(delta.to(_F64))
        expo = torch.exp(-((4.0 / y) ** 4))
    else:
        y = math.log10(float(delta))
        expo = math.exp(-((4.0 / y) ** 4))
    bigA = 1.0 + 0.24 * y * expo
    a = 0.44 * y - 0.88
    bigB = 0.183
    b = 1.5
    bigC = 0.019 + 0.107 * y + 0.19 * expo
    c = 2.4
    nua = nu**a
    return 1.0 - bigA * nua / (nua + DELTAC**a) + bigB * nu**b + bigC * nu**c


def _tinker_f_nu_unnorm(nu, zs, delta=200.0):
    """Unnormalized Tinker 2010 f(nu), its parameters frozen above z = 3.
    ``delta`` in [200, 3200] (Table-4 spline), possibly z-shaped."""
    nu = _tensor(nu)
    zc = torch.clamp(_tensor(zs, nu.device), max=3.0)
    beta0, gamma0, phi0, eta0 = tinker2010_params(_tensor(delta, nu.device))
    beta = beta0 * (1.0 + zc) ** 0.20
    phi = phi0 * (1.0 + zc) ** -0.08
    eta = eta0 * (1.0 + zc) ** 0.27
    gamma = gamma0 * (1.0 + zc) ** -0.01
    return ((1.0 + (beta * nu) ** (-2.0 * phi))
            * nu ** (2.0 * eta) * torch.exp(-gamma * nu**2 / 2.0))


# The nu grid of the alpha(z) consistency integral and its trapezoid
# weights
_ALPHA_NUS = np.logspace(-8, 2, 10000)
_ALPHA_W = trapz_weights(_ALPHA_NUS)


def tinker_alpha_consistency(zs, delta=200.0):
    """alpha(z) = 1 / int f(nu) b(nu) dnu, which enforces
    int b f dnu = 1 (bias consistency): a (nz, 10,000) @ (10,000,)
    trapezoid."""
    zs = _tensor(zs)
    dev = zs.device
    nus = _on_device("_ALPHA_NUS", dev)
    w = _on_device("_ALPHA_W", dev)
    dcol = _column(delta, dev)
    fnus = _tinker_f_nu_unnorm(nus[None, :], zs[:, None], dcol)
    bs = torch.broadcast_to(bias_tinker(nus[None, :], dcol), fnus.shape)
    return 1.0 / ((fnus * bs) @ w)


def fsigmaz_tinker(sigma2, zs, delta=200.0):
    """nu f(nu) for Tinker 2010 with the consistency norm.  ``delta`` (with
    respect to the mean matter density): a scalar or (nz,)."""
    nus = DELTAC / torch.sqrt(sigma2)
    zs = _tensor(zs, sigma2.device)
    alpha = tinker_alpha_consistency(zs, delta)[:, None]
    return nus * alpha * _tinker_f_nu_unnorm(nus, zs[:, None],
                                             _column(delta, sigma2.device))


def f_nu(nu, zs, delta=200.0, norm_consistency=True):
    """Tinker 2010 f(nu) with the reference's free-function signature; the
    alpha(z) norm is computed from its integral, and ``zs`` may have any
    shape that broadcasts against ``nu``."""
    nu = _tensor(nu)
    zs = _tensor(zs, nu.device)
    un = _tinker_f_nu_unnorm(nu, zs, delta)
    if not norm_consistency:
        return un
    nus_g = _on_device("_ALPHA_NUS", nu.device)
    w = _on_device("_ALPHA_W", nu.device)
    fn = _tinker_f_nu_unnorm(nus_g, zs[..., None], delta)
    alpha = 1.0 / ((fn * bias_tinker(nus_g, delta)) @ w)
    return un * alpha


def simple_f_nu_tinker2008(nu, delta=200.0, zs=None):
    """Tinker 2008 f at any overdensity ((A, a, b, c) from the Table-2
    spline).  ``zs`` (optional) applies the paper's redshift evolution,
    eqs. 5-8, frozen beyond z = 3: A (1+z)^-0.14, a (1+z)^-0.06,
    b (1+z)^-alpha with log10 alpha = -(0.75 / log10(delta/75))^1.2."""
    nu = _tensor(nu)
    sigma = DELTAC / nu
    d = _tensor(delta, nu.device)
    A, a, b, c = tinker2008_params(d)
    if zs is not None:
        zp1 = 1.0 + torch.clamp(_tensor(zs, nu.device), max=3.0)
        A = A * zp1**-0.14
        a = a * zp1**-0.06
        al = 10.0 ** (-((0.75 / torch.log10(d / 75.0)) ** 1.2))
        b = b * zp1**-al
    return A * (1.0 + (sigma / b) ** -a) * torch.exp(-c / sigma**2)


def n_ln_m_sub(Msubs, Mhosts):
    """Tinker & Wetzel 2010 eq. 12 subhalo mass function, (nsub, nhost)."""
    Msubs = _tensor(Msubs)
    mrat = Msubs[:, None] / _tensor(Mhosts, Msubs.device)[None, :]
    return 0.3 * mrat**-0.7 * torch.exp(-9.9 * mrat**2.5)


def simple_f_nu(nu, delta=200.0):
    """Reference-named alias of simple_f_nu_tinker2008 (z = 0)."""
    return simple_f_nu_tinker2008(nu, delta)


def NlnMsub(Msubs, Mhosts):
    """Reference-named alias of n_ln_m_sub."""
    return n_ln_m_sub(Msubs, Mhosts)


def nzm(sigma2, ms, fsigmaz, rho_matter0):
    """Halo number density n(z, m) = rho_m0 f(sigma) dln(sigma^-1)/dln m / m^2,
    with numpy's np.gradient stencil in ln m.  ``ms``: (nm,) tensor."""
    ln_sigma_inv = -0.5 * torch.log(sigma2)
    dln_sigma_dlnm = gradient(ln_sigma_inv, torch.log(ms), dim=-1)
    return rho_matter0 * fsigmaz * dln_sigma_dlnm / ms[None, :] ** 2


def mass_function_grid(sigma2, zs, ms, rho_matter0, mode, params,
                       delta=200.0):
    """(nzm, bh), each (nz, nm), for the requested mass-function mode.

    ``delta`` (the Tinker modes only): the halo overdensity with respect
    to the mean matter density, a scalar or (nz,)."""
    if mode == "sheth-torman":
        fs = fsigmaz_sheth_torman(sigma2, params)
        bh = bias_sheth_torman(sigma2, params)
    elif mode == "tinker":
        fs = fsigmaz_tinker(sigma2, zs, delta)
        bh = bias_tinker(DELTAC / torch.sqrt(sigma2),
                         _column(delta, sigma2.device))
    elif mode == "tinker2008":
        # Tinker-2008 f(sigma) with its z evolution, paired with the
        # Tinker-2010 bias (both calibrated on the same simulations)
        dcol = _column(delta, sigma2.device)
        nu = DELTAC / torch.sqrt(sigma2)
        fs = simple_f_nu_tinker2008(nu, dcol,
                                    _tensor(zs, sigma2.device)[:, None])
        bh = bias_tinker(nu, dcol)
    elif mode == "press-schechter":
        fs = fsigmaz_sheth_torman(sigma2, _PS_PARAMS)
        bh = bias_sheth_torman(sigma2, _PS_PARAMS)
    elif mode == "despali":
        fs = fsigmaz_sheth_torman(sigma2, _DESPALI_PARAMS)
        bh = bias_sheth_torman(sigma2, _DESPALI_PARAMS)
    else:
        raise NotImplementedError(mode)
    return nzm(sigma2, ms, fs, rho_matter0), bh
