"""Recombination history on float64 tensors: Saha + Peebles x_e(a), optical
depth, visibility and conformal time (port of hmvec_tpu/models/recomb.py).

Physics as in the JAX package: hydrogen + helium in coupled Saha
equilibrium while hydrogen is nearly ionized, then the Peebles
three-level-atom ODE (RECFAST fudge F = 1.14) integrated by fixed-step RK4
in x = ln a, and a tanh reionization.

The JAX package integrates with one ``lax.scan`` whose body evaluates
everything at every RK4 sub-point.  Here the work is split in two:

1. everything that depends on x alone -- n_H, T_b, H(x), the coupled Saha
   fixed point (its 40 iterations once on the (n-1, 3) sub-points, which
   gives both the Saha switch and the Saha value at x + dx), and the
   x-only Peebles coefficients -- is one vectorised pass over every
   sub-point (x, x + dx/2, x + dx of each step), each sub-point's x formed
   with the JAX expression's own order of operations;
2. only the x_e recurrence runs serially, in ``ops.boltz_kernels.
   recomb_rk4`` (the hand-written kernel on the card, its plain version on
   the CPU).

τ, τ_x, the visibility and η then follow as vectorised trapezoids.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.boltz_kernels import recomb_rk4
from ..utils.weights import on_device_of_inputs
from . import background as bgmod

# --- constants (CGS + eV), those of the JAX package -----------------------
EPS0_EV = 13.605693122994      # hydrogen ionization energy [eV]
KB_EV_PER_K = 8.617333262e-5   # Boltzmann [eV/K]
MPC_CM = 3.0856775814913673e24
SIGMA_T_CM2 = 6.6524587321e-25
M_H_G = 1.6735575e-24          # hydrogen atom mass [g]
RHO_CRIT_H2 = 1.878341616e-29  # rho_crit0/h^2 [g/cm^3]
LAMBDA_2S1S = 8.227            # 2s->1s two-photon rate [1/s]
_ALPHA2_PREF = 21.8252 * 2.380865e-15   # cm^3/s
_THERMAL_PREF = 3.019213e21    # (m_e c^2 / (2 pi (hbar c)^2))^{3/2}
_LYA_PREF = 1.40129e16         # (3 eps0 / hbar c)^3 / (8 pi)^2 [cm^-3]
_H0_UNIT = 3.2407792700e-20    # (km/s/Mpc) -> 1/s
_FUDGE = 1.14                  # RECFAST case-B correction (SSS 1999)
CHI_HE1_EV = 24.587387         # He I  first-ionization energy [eV]
CHI_HE2_EV = 54.417760         # He II second-ionization energy [eV]
_C_CM_S = 2.99792458e10
_C_KMS = 2.99792458e5


class RecombTable(NamedTuple):
    """Ionization/visibility history on a uniform x = ln a grid."""

    xs: torch.Tensor        # (n,) ln a, uniform, ascending to 0
    xe: torch.Tensor        # (n,) n_e / n_H (reionization included)
    tau: torch.Tensor       # (n,) Thomson optical depth to x=0
    tau_x: torch.Tensor     # (n,) d tau / dx  (negative)
    gvis: torch.Tensor      # (n,) visibility g = -tau_x * exp(-tau)
    eta: torch.Tensor       # (n,) conformal time [Mpc]
    eta0: torch.Tensor      # () conformal age [Mpc]


def ipow(x, n: int):
    """x ** n for an integer n with jax.lax.integer_pow's arithmetic: the
    product by repeated squaring (x^3 = x (x x), x^4 = (x x)(x x)), and
    1 / x^|n| for a negative n.  Works on tensors and Python floats."""
    m = abs(n)
    acc = None
    while m > 0:
        if m & 1:
            acc = x if acc is None else acc * x
        m >>= 1
        if m > 0:
            x = x * x
    return 1.0 / acc if n < 0 else acc


def _peebles_coefficients(tb_ev):
    """The x-only factors of the Peebles rate: (alpha2, beta, beta2)."""
    lnratio = torch.log(EPS0_EV / tb_ev)
    phi2 = 0.448 * lnratio
    alpha2 = _FUDGE * _ALPHA2_PREF * torch.sqrt(EPS0_EV / tb_ev) * phi2
    therm = _THERMAL_PREF * tb_ev ** 1.5
    beta = alpha2 * therm * torch.exp(-EPS0_EV / tb_ev)
    # beta2 = beta * e^{3 eps0/4T} computed directly (avoids overflow)
    beta2 = alpha2 * therm * torch.exp(-0.25 * EPS0_EV / tb_ev)
    return alpha2, beta, beta2


def _peebles_rates(xe, nh_cm3, tb_ev, h_s):
    """dx_e/dx from the Peebles ODE (x = ln a, H in 1/s, n_H in cm^-3)."""
    alpha2, beta, beta2 = _peebles_coefficients(tb_ev)
    n1s = torch.clamp_min((1.0 - xe) * nh_cm3, 1e-30)
    lam_alpha = h_s * _LYA_PREF / n1s
    cr = (LAMBDA_2S1S + lam_alpha) / (LAMBDA_2S1S + lam_alpha + beta2)
    dxe_dt = cr * (beta * (1.0 - xe) - nh_cm3 * alpha2 * ipow(xe, 2))
    return dxe_dt / h_s


def _saha_xe(nh_cm3, tb_ev):
    """Hydrogen-only Saha x_e: x^2/(1-x) = S, solved stably."""
    s = _THERMAL_PREF * tb_ev**1.5 * torch.exp(-EPS0_EV / tb_ev) / nh_cm3
    s = torch.clamp_min(s, 1e-30)
    return 2.0 / (1.0 + torch.sqrt(1.0 + 4.0 / s))


def _saha_coupled(nh_cm3, tb_ev, f_he, n_iter: int = 40):
    """Coupled H + He Saha equilibrium sharing one electron bath, by the
    JAX package's damped fixed-point iteration (n_iter trips, vectorised
    over every point).  Returns (x_e, x_H)."""
    therm = _THERMAL_PREF * tb_ev**1.5 / nh_cm3
    s1 = torch.clamp_min(therm * torch.exp(-EPS0_EV / tb_ev), 1e-300)
    s2 = 4.0 * therm * torch.exp(-torch.clamp_max(CHI_HE1_EV / tb_ev, 650.0))
    s3 = therm * torch.exp(-torch.clamp_max(CHI_HE2_EV / tb_ev, 650.0))
    xe = torch.ones_like(s1) + 2.0 * f_he
    for _ in range(n_iter):
        xe = torch.clamp_min(xe, 1e-12)
        xh = s1 / (s1 + xe)
        y1 = s2 / (xe + s2 * (1.0 + s3 / xe))
        y2 = y1 * s3 / xe
        xe_new = xh + f_he * (y1 + 2.0 * y2)
        xe = 0.5 * (xe + xe_new)
    xe = torch.clamp_min(xe, 1e-12)
    return xe, s1 / (s1 + xe)


def _reio_xe(z, zre, f_he, dz=0.5):
    """CAMB-style tanh reionization in y = (1+z)^1.5 (+He single ion.)."""
    y = (1.0 + z) ** 1.5
    yre = (1.0 + zre) ** 1.5
    dy = 1.5 * math.sqrt(1.0 + zre) * dz
    return 0.5 * (1.0 + f_he) * (1.0 + torch.tanh((yre - y) / dy))


def _linspace(start: float, stop: float, n: int, device):
    """``jax.numpy.linspace(start, stop, n)`` for float endpoints."""
    from ..pipeline import _linspace as lin
    return lin(torch.tensor(start, dtype=torch.float64, device=device),
               stop, n)


def _e_of_z_fn(massive_nu: bool):
    if massive_nu:
        from .boltzlite import e_of_z_fd
        return e_of_z_fd
    return bgmod.e_of_z


def rk4_subpoints(xs, dx):
    """The sub-points of an RK4 step at each x of ``xs`` with step dx:
    (..., 3) = (x, x + 0.5 dx, x + dx), the JAX step's own expressions."""
    half = 0.5 * dx
    return torch.stack([xs, xs + half, xs + dx], dim=-1)


def recomb_tables(bg, xs, dx, massive_nu: bool = False):
    """The x-only inputs of the x_e recurrence on the grid ``xs`` (n,):
    (tab (n-1, 3, 7), saha_next (n-1,), xe0 ()), with tab's columns
    n_H, H [1/s], H Lya_pref, n_H alpha2, beta, beta2 and the Saha switch
    (1.0 where hydrogen's Saha fraction exceeds 0.985) at the sub-points
    of each step, and saha_next the coupled Saha x_e at x + dx."""
    e_of_z = _e_of_z_fn(massive_nu)
    nh0 = (1.0 - bg.Yp) * bg.ombh2 * RHO_CRIT_H2 / M_H_G
    f_he = bg.Yp / (4.0 * (1.0 - bg.Yp))
    tcmb_ev = bg.T_cmb_k * KB_EV_PER_K
    x = rk4_subpoints(xs[:-1], dx)                   # (n-1, 3)
    a = torch.exp(x)
    nh = nh0 * ipow(a, -3)
    tb = tcmb_ev / a
    z = torch.exp(-x) - 1.0
    hs = bg.H0 * e_of_z(bg, z) * _H0_UNIT / 100.0 * 100.0
    xe_saha, saha_xh = _saha_coupled(nh, tb, f_he)
    alpha2, beta, beta2 = _peebles_coefficients(tb)
    use = (saha_xh > 0.985).to(torch.float64)
    tab = torch.stack([nh, hs, hs * _LYA_PREF, nh * alpha2, beta, beta2,
                       use], dim=-1)
    return tab.contiguous(), xe_saha[:, 2].contiguous(), 1.0 + 2.0 * f_he


@on_device_of_inputs
def recombination(bg, n: int = 16384, x_init: float = -18.0,
                  zre: float = 7.7, massive_nu: bool = False) -> RecombTable:
    """Full ionization history on a uniform ln-a grid: the JAX package's
    RK4 scan, with its x-only work vectorised and the serial x_e
    recurrence in ``recomb_rk4`` (one launch on the card).

    massive_nu=True integrates with the exact Fermi-Dirac neutrino
    background (boltzlite.e_of_z_fd), identical to the mnu-as-matter
    background at mnu = 0."""
    e_of_z = _e_of_z_fn(massive_nu)
    dev = bg.H0.device
    nh0 = (1.0 - bg.Yp) * bg.ombh2 * RHO_CRIT_H2 / M_H_G
    f_he = bg.Yp / (4.0 * (1.0 - bg.Yp))

    xs = _linspace(x_init, 0.0, n, dev)
    dx = xs[1] - xs[0]
    tab, saha_next, xe0 = recomb_tables(bg, xs, dx, massive_nu)
    xe = recomb_rk4(tab[None], saha_next[None], xe0.reshape(1),
                    float(dx))[0]

    zs = torch.exp(-xs) - 1.0
    xe = torch.maximum(xe, _reio_xe(zs, zre, f_he))

    # d tau/dx = n_e sigma_T c / H  (dimensionless per e-fold), negative
    a_grid = torch.exp(xs)
    ne = xe * nh0 * ipow(a_grid, -3)
    ez = e_of_z(bg, zs)
    hs = bg.H0 * ez * _H0_UNIT
    tau_x = -ne * SIGMA_T_CM2 * _C_CM_S / hs

    # tau(x) = -int_x^0 tau_x dx' (trapezoid, exact on the table grid)
    seg = -0.5 * (tau_x[1:] + tau_x[:-1]) * dx
    zero = torch.zeros(1, dtype=torch.float64, device=dev)
    tau = torch.cat([torch.cumsum(seg.flip(0), 0).flip(0), zero])
    gvis = -tau_x * torch.exp(-tau)

    # conformal time eta(x) = int c da'/(a'^2 H) (trapezoid in x)
    detadx = (_C_KMS / (bg.H0 * ez)) / a_grid
    seg_eta = 0.5 * (detadx[1:] + detadx[:-1]) * dx
    eta_rel = torch.cat([zero, torch.cumsum(seg_eta, 0)])
    # absolute offset: eta at x_init from the RD closed form
    a_i = torch.exp(xs[0])
    eta_i = (_C_KMS / bg.H0) * a_i / torch.sqrt(bg.omr0)
    eta = eta_i + eta_rel
    return RecombTable(xs=xs, xe=xe, tau=tau, tau_x=tau_x, gvis=gvis,
                       eta=eta, eta0=eta[-1])
