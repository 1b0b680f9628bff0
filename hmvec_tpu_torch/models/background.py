"""FRW background on float64 tensors (port of hmvec_tpu/models/background.py).

Closed-form H(z), densities and the LCDM growth factor (Heath 1977 via
2F1).  Conventions follow the JAX package: no h units; Mpc, Msun, km/s/Mpc.
Massive neutrinos count as matter in the background.

For w0/wa backgrounds the growing mode is integrated (``growth_table``,
fixed-step RK4 in ln a) and read by cubic Hermite (``growth_eval``);
``mode="ode"`` of ``growth_unnormalized`` / ``d_growth`` selects it.
``growth_rate_f`` gives f = dlnD/dlna in either mode.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.special import hyp2f1_growth, hyp2f1_growth_and_slope
from ..utils.weights import gauss_legendre

CSPEED_KMS = 299792.458

# The same constants as the JAX package, with the SI round trip folded into
# one float64 factor: rho_crit = H_kms^2 * _RHO_CRIT_FACTOR.
_HZ_TO_SI = 3.241e-20           # (km/s/Mpc) -> 1/s
_G_SI = 6.67259e-11
_RHO_SI_TO_MSUN_MPC3 = 1.477543e37
_RHO_CRIT_FACTOR = (3.0 * _HZ_TO_SI**2 / (8.0 * float(math.pi) * _G_SI)
                    * _RHO_SI_TO_MSUN_MPC3)  # ~2.775e7 Msun/Mpc^3/(km/s/Mpc)^2


_GL_NODES, _GL_WEIGHTS = gauss_legendre(128)
_GL_ON_DEVICE = {}


def _gauss_legendre_on(device):
    """The 128 Gauss-Legendre nodes and weights on [0, 1] as float64
    tensors on ``device``, copied there once."""
    if device not in _GL_ON_DEVICE:
        _GL_ON_DEVICE[device] = tuple(
            torch.as_tensor(a, dtype=torch.float64, device=device)
            for a in (_GL_NODES, _GL_WEIGHTS))
    return _GL_ON_DEVICE[device]


def _varies(t) -> bool:
    """True when ``t`` has no one value to read at build time: it requires
    grad, carries a forward-mode tangent, or is mapped over a batch by
    ``torch.func.vmap``.  The counterpart of the JAX package's
    ``isinstance(v, jax.core.Tracer)`` build-time tests."""
    if not isinstance(t, torch.Tensor):
        return False
    if t.requires_grad or torch._C._functorch.is_batchedtensor(t):
        return True
    return torch.autograd.forward_ad.unpack_dual(t).tangent is not None


class BackgroundParams(NamedTuple):
    """Derived background parameters: 0-d float64 tensors on one device."""

    H0: torch.Tensor
    omm0: torch.Tensor       # (omch2+ombh2)/h^2, massive nu excluded
    omk0: torch.Tensor
    oml0: torch.Tensor       # 1 - omm0 - omk0
    omr0: torch.Tensor       # photons + massless neutrinos
    omnu0: torch.Tensor      # massive neutrinos (matter-like here)
    w0: torch.Tensor
    wa: torch.Tensor
    ombh2: torch.Tensor
    omch2: torch.Tensor
    ns: torch.Tensor
    As: torch.Tensor
    pivot_scalar: torch.Tensor
    as8: torch.Tensor
    Yp: torch.Tensor
    T_cmb_k: torch.Tensor    # CMB temperature in K
    nnu_m: torch.Tensor      # number of degenerate massive nu species (EH99)


def background(params: dict, device, include_radiation: bool = True
               ) -> BackgroundParams:
    """Derive background parameters from a merged params dict.

    Entries may be Python numbers or float64 tensors on ``device``
    (tensors keep their autograd history).  An ``omm`` entry re-derives
    omch2 as omm h^2 - ombh2, as in the JAX package.
    """
    h = params["H0"] / 100.0
    omch2 = params["omch2"]
    if params.get("omm") is not None:
        omch2 = params["omm"] * h**2 - params["ombh2"]
    omh2 = omch2 + params["ombh2"]
    omm0 = omh2 / h**2
    omk0 = params["omk"]
    oml0 = 1.0 - omm0 - omk0
    if include_radiation:
        # omega_gamma h^2 for T=2.7255K; massless-nu boost 0.2271*Neff
        omr0 = 2.47282e-5 * (1.0 + 0.2271 * params["nnu"]) / h**2
    else:
        omr0 = 0.0
    omnu0 = params["mnu"] / 93.14 / h**2

    def arr(v):
        return torch.as_tensor(v, dtype=torch.float64, device=device)

    return BackgroundParams(
        H0=arr(params["H0"]), omm0=arr(omm0), omk0=arr(omk0), oml0=arr(oml0),
        omr0=arr(omr0), omnu0=arr(omnu0),
        w0=arr(params["w0"]), wa=arr(params["wa"]),
        ombh2=arr(params["ombh2"]), omch2=arr(omch2),
        ns=arr(params["ns"]), As=arr(params["As"]),
        pivot_scalar=arr(params["pivot_scalar"]),
        as8=arr(params.get("as8", 1.0)),
        Yp=arr(params.get("Yp", 0.24)),
        T_cmb_k=arr(2.7255),
        nnu_m=arr(params.get("num_massive_neutrinos", 3)),
    )


def e_of_z(bg: BackgroundParams, z):
    """E(z) = H(z)/H0."""
    zp1 = 1.0 + z
    de = zp1 ** (3.0 * (1.0 + bg.w0 + bg.wa)) * torch.exp(
        -3.0 * bg.wa * (1.0 - 1.0 / zp1))
    e2 = (
        bg.omr0 * zp1**4
        + (bg.omm0 + bg.omnu0) * zp1**3
        + bg.omk0 * zp1**2
        + bg.oml0 * de
    )
    return torch.sqrt(e2)


def hubble_parameter(bg: BackgroundParams, z):
    """H(z) in km/s/Mpc."""
    return bg.H0 * e_of_z(bg, z)


def h_of_z(bg: BackgroundParams, z):
    """H(z) in 1/Mpc."""
    return hubble_parameter(bg, z) / CSPEED_KMS


def _on_device(bg: BackgroundParams, z):
    return torch.as_tensor(z, dtype=torch.float64, device=bg.H0.device)


def comoving_radial_distance(bg: BackgroundParams, z):
    """chi(z) in Mpc by 128-node Gauss-Legendre on [0, z]."""
    z = _on_device(bg, z)
    nodes, weights = _gauss_legendre_on(z.device)
    integrand = 1.0 / e_of_z(bg, z[..., None] * nodes)   # (..., 128)
    return (CSPEED_KMS / bg.H0) * z * (integrand @ weights)


def _curvature_comoving(bg: BackgroundParams, chi):
    """S_k(chi): transverse comoving distance from radial chi."""
    H0_invmpc = bg.H0 / CSPEED_KMS
    k = -bg.omk0 * H0_invmpc**2
    sqrt_abs_k = torch.sqrt(torch.abs(k) + 1e-300)
    x = sqrt_abs_k * chi
    open_case = torch.sinh(x) / sqrt_abs_k
    closed_case = torch.sin(x) / sqrt_abs_k
    return torch.where(k > 1e-12, closed_case,
                       torch.where(k < -1e-12, open_case, chi))


def angular_diameter_distance(bg: BackgroundParams, z1, z2=None):
    """D_A(z) or D_A(z1, z2) in Mpc."""
    if z2 is None:
        chi = comoving_radial_distance(bg, z1)
        return _curvature_comoving(bg, chi) / (1.0 + _on_device(bg, z1))
    chi1 = comoving_radial_distance(bg, z1)
    chi2 = comoving_radial_distance(bg, z2)
    return _curvature_comoving(bg, chi2 - chi1) / (1.0 + _on_device(bg, z2))


def sigma_crit(bg: BackgroundParams, zlens, zsource):
    """Lensing critical surface density in Msun/Mpc^2."""
    Gval = 4.517e-48   # Newton G in Mpc, s, Msun units
    cval = 9.716e-15   # c in Mpc/s
    Dd = angular_diameter_distance(bg, zlens)
    Ds = angular_diameter_distance(bg, zsource)
    Dds = angular_diameter_distance(bg, zlens, zsource)
    return cval**2 * Ds / 4.0 / math.pi / Gval / Dd / Dds


def rho_critical_z(bg: BackgroundParams, z):
    """Critical density in Msun/Mpc^3."""
    return hubble_parameter(bg, z) ** 2 * _RHO_CRIT_FACTOR


def rho_matter_z(bg: BackgroundParams, z):
    """Comoving -> physical mean matter density."""
    return rho_critical_z(bg, 0.0) * bg.omm0 * (1.0 + z) ** 3


def omz(bg: BackgroundParams, z):
    return rho_matter_z(bg, z) / rho_critical_z(bg, z)


def growth_unnormalized(bg: BackgroundParams, a, mode: str = "closed",
                        table=None):
    """D(a) with D ~ a in matter domination.

    ``mode="closed"`` is the LCDM-exact Heath 1977 integral via 2F1;
    ``mode="ode"`` reads the integrated growing mode of any (w0, wa)
    background from ``table`` (built here when None).  Pick the mode with
    ``growth_mode_for(params)`` on the host, where w0/wa are numbers.
    """
    if mode == "ode":
        if table is None:
            table = growth_table(bg)
        return growth_eval(table, a)[0]
    if mode != "closed":
        raise ValueError(mode)
    x = (bg.oml0 / bg.omm0) ** (1.0 / 3.0) * a
    x3 = x**3
    return torch.sqrt(1.0 + x3) * hyp2f1_growth(x3) * a


def d_growth(bg: BackgroundParams, a, norm: str = "anorm",
             mode: str = "closed", table=None):
    """Normalized growth factor: D(a)/D(1) ('z0norm') or D ~ a ('anorm')."""
    if mode == "ode" and table is None:
        table = growth_table(bg)
    one = torch.ones((), dtype=torch.float64, device=bg.H0.device)
    d1 = growth_unnormalized(bg, one, mode, table)
    val = growth_unnormalized(bg, a, mode, table) / d1
    if norm == "z0norm":
        return val
    if norm == "anorm":
        return val * d1
    raise ValueError(norm)


def growth_rate_f(bg: BackgroundParams, z, mode: str = "closed",
                  table=None):
    """f(z) = dlnD/dlna, shape (nz,).

    ``mode="closed"``: the derivative of the Heath form
    D = sqrt(1 + x^3) 2F1(x^3) a, x^3 = (oml/omm) a^3, in closed form,
    f = 1 + (3/2) x^3 / (1 + x^3) + 3 x^3 2F1'(x^3) / 2F1(x^3), with
    2F1' the derivative of the same Chebyshev fit (what autodiff of log D
    over ln a gives, and it nests in any autodiff mode and in vmap).
    ``mode="ode"``: f from ``table`` (built here when None) by
    ``growth_eval``; a call that already holds its table passes it.
    """
    z = torch.atleast_1d(_on_device(bg, z))
    a = 1.0 / (1.0 + z)
    if mode == "ode":
        if table is None:
            table = growth_table(bg)
        return growth_eval(table, a)[1]
    if mode != "closed":
        raise ValueError(mode)
    x = (bg.oml0 / bg.omm0) ** (1.0 / 3.0) * a
    x3 = x**3
    f2, df2 = hyp2f1_growth_and_slope(x3)
    return 1.0 + 1.5 * x3 / (1.0 + x3) + 3.0 * x3 * df2 / f2


# ---------------------------------------------------------------------------
# Integrated growth for general (w0, wa) dark energy
# ---------------------------------------------------------------------------
#
# The closed form above is exact only for (w0, wa) = (-1, 0).  For any other
# background the growing mode is integrated: with g = D/a and x = ln a,
#
#   g'' + (4 + dlnE/dx) g' + (3 + dlnE/dx - (3/2) Om_m(a)) g = 0,
#
# over the same reduced background as Heath (matter + curvature + w0waCDM
# dark energy, no radiation), so the LCDM limit reproduces the closed form.
# g is O(1) and flat until late times, so fixed-step RK4 in ln a converges
# fast; nodes carry (D, dD/dlna) and evaluation is cubic Hermite.
#
# The JAX package steps the RK4 in a 384-step scan of scalars.  Here the
# same RK4 is re-associated: the ODE is linear, y' = A(x) y for y = (g, g'),
# with A a function of x and the background alone, so every step is a 2x2
# propagator
#
#   M_n = I + h/6 (K1 + 2 K2 + 2 K3 + K4),    K1 = A(x_n),
#   K2 = A(x_n + h/2) (I + h/2 K1),   K3 = A(x_n + h/2) (I + h/2 K2),
#   K4 = A(x_n + h) (I + h K3),
#
# formed for all steps at once as (n, 2, 2) tensor arithmetic, and the
# trajectory is the running product M_n ... M_0 applied to y0 = (1, 0), a
# log-depth scan of batched products.  That is some hundred small launches
# on a card instead of tens of thousands, equal to the stepped RK4 up to
# rounding, and plain autograd differentiates it in both modes.

_GROWTH_LNA0 = math.log(1e-4)


class GrowthTable(NamedTuple):
    lna0: float              # ln a of the first node
    h: float                 # step in ln a
    d: torch.Tensor          # (n+1,) unnormalized D (D -> a in matter dom.)
    dp: torch.Tensor         # (n+1,) dD/dlna


def _growth_ode_matrix(bg: BackgroundParams, lna):
    """A(x) of y' = A y, y = (g, g'), at every ln a of ``lna``; shape
    lna.shape + (2, 2)."""
    a = torch.exp(lna)
    fde = a ** (-3.0 * (1.0 + bg.w0 + bg.wa)) * torch.exp(
        -3.0 * bg.wa * (1.0 - a))
    m = bg.omm0 * a**-3
    k = bg.omk0 * a**-2
    e2 = m + k + bg.oml0 * fde
    dlne = 0.5 * (-3.0 * m - 2.0 * k + bg.oml0 * fde
                  * (-3.0 * (1.0 + bg.w0 + bg.wa) + 3.0 * bg.wa * a)) / e2
    om_a = m / e2
    zero, one = torch.zeros_like(dlne), torch.ones_like(dlne)
    return torch.stack([torch.stack([zero, one], dim=-1),
                        torch.stack([-(3.0 + dlne - 1.5 * om_a),
                                     -(4.0 + dlne)], dim=-1)], dim=-2)


def _running_products(m):
    """P_n = M_n @ ... @ M_0 for the (n, 2, 2) stack ``m``, by doubling:
    ceil(log2 n) rounds of one batched product each."""
    p, d = m, 1
    while d < p.shape[0]:
        p = torch.cat([p[:d], p[d:] @ p[:-d]])
        d *= 2
    return p


def growth_table(bg: BackgroundParams, n_steps: int = 384,
                 lna_min: float = _GROWTH_LNA0) -> GrowthTable:
    """Integrate the growth ODE on a uniform ln-a grid up to a = 1.

    Initial conditions deep in matter domination (g = 1, g' = 0 at
    a = 1e-4; the dark-energy correction there is O(oml/omm a^3) ~ 1e-12).
    """
    h = (0.0 - lna_min) / n_steps
    dev = bg.H0.device
    steps = torch.arange(n_steps + 1, dtype=torch.float64, device=dev)
    lnas = lna_min + h * steps
    offsets = torch.tensor([0.0, 0.5 * h, h], dtype=torch.float64, device=dev)
    a0, ah, a1 = _growth_ode_matrix(bg, lnas[None, :-1] + offsets[:, None])
    eye = torch.eye(2, dtype=torch.float64, device=dev)
    k1 = a0
    k2 = ah @ (eye + (0.5 * h) * k1)
    k3 = ah @ (eye + (0.5 * h) * k2)
    k4 = a1 @ (eye + h * k3)
    prop = _running_products(eye + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4))
    # y_n = P_(n-1) y0 with y0 = (1, 0): the first column
    y0 = eye[:1, :]
    g, gp = torch.cat([y0, prop[:, :, 0]]).unbind(-1)
    a_nodes = torch.exp(lnas)
    return GrowthTable(lna0=lna_min, h=h, d=a_nodes * g,
                       dp=a_nodes * (g + gp))


def growth_eval(tab: GrowthTable, a):
    """(D(a), f(a) = dlnD/dlna) by cubic-Hermite interpolation of the
    table; below the table D extends as D = a (D0/a0) (pure matter
    domination), above a = 1 it clamps to the last interval's Hermite."""
    lna = torch.log(a)
    n = tab.d.shape[0] - 1
    u = (lna - tab.lna0) / tab.h
    i = torch.clamp(torch.floor(u).to(torch.int64), 0, n - 1)
    t = u - i
    # gather through a 1-d index: a 0-d index tensor would be read back
    # to the host
    lo = i.reshape(-1)
    hi = lo + 1
    d0, d1 = tab.d[lo].reshape(i.shape), tab.d[hi].reshape(i.shape)
    p0 = tab.dp[lo].reshape(i.shape) * tab.h
    p1 = tab.dp[hi].reshape(i.shape) * tab.h
    t2, t3 = t * t, t * t * t
    D = ((2 * t3 - 3 * t2 + 1) * d0 + (t3 - 2 * t2 + t) * p0
         + (-2 * t3 + 3 * t2) * d1 + (t3 - t2) * p1)
    Dp = ((6 * t2 - 6 * t) * d0 + (3 * t2 - 4 * t + 1) * p0
          + (-6 * t2 + 6 * t) * d1 + (3 * t2 - 2 * t) * p1) / tab.h
    below = lna < tab.lna0
    D = torch.where(below, a * (tab.d[0] / math.exp(tab.lna0)), D)
    f = torch.where(below, tab.dp[0] / tab.d[0], Dp / D)
    return D, f


def growth_mode_for(params: dict) -> str:
    """'closed' (Heath/2F1, exact for LCDM) unless (w0, wa) != (-1, 0),
    then 'ode'.  A w0 or wa that is differentiated or batched has no one
    value to read and takes 'ode'."""
    for key, fid in (("w0", -1.0), ("wa", 0.0)):
        v = params.get(key, fid)
        if _varies(v) or float(v) != fid:
            return "ode"
    return "closed"
