"""boltzlite: the reduced Boltzmann solver for engine-free primary CMB C_l,
on float64 tensors (port of hmvec_tpu/models/boltzlite.py).

The physics is the JAX package's: conformal-Newtonian metric + CDM +
baryons + the photon multipole hierarchy with polarization + massless
neutrinos + an optional massive-neutrino fluid, per wavenumber, with
Peebles recombination (models/recomb.py), tight coupling deep in the
radiation era, and line-of-sight integration of the sources against a
spherical-Bessel table.

The JAX package integrates each segment of x = ln a with one fixed-step
RK4 ``lax.scan`` vmapped over k.  Here every x-only quantity of a segment
(a, H_p, tau_x, tau_xx, dln H_p/dx, eta, rho_nu, w_nu, c_g^2 and the
x-only half of the tight-coupling test, at the three sub-points of each
step) is one vectorised table (``_x_table``), and the serial part runs in
``ops.boltz_kernels.hierarchy_rk4``: one launch a segment on the card, the
plain loop over the steps on the CPU.  The curvature-normalisation mode
(k = 2e-5) rides as one more row through segments A and B and takes its
own segment-C launch.  Every expression keeps the JAX package's order of
operations.

The sources, the Bessel projection (a loop over l nodes that keeps one
(nkf, nx) buffer live at a time) and the C_l assembly are vectorised
PyTorch; the Bessel table and the spline onto integer l are built on the
host with scipy, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.boltz_kernels import (I_DB, I_DC, I_N, I_NM, I_PHI, I_TH, I_THP,
                                 I_VB, I_VC, NSTATE, XCOLS, Consts,
                                 hierarchy_rk4, metric, rhs_full, rhs_tc,
                                 slaved_multipoles, tc_active, with_divisors,
                                 with_slaved)
from ..ops.quadrature import linear_interp
from ..utils.weights import on_device_of_inputs
from . import background as bgmod
from .recomb import RecombTable, ipow, recombination, rk4_subpoints

_F64 = torch.float64
_C_KMS = 299792.458
_LOG_Z1630 = math.log(1.0 / 1630.0)

# --- massive-neutrino Fermi-Dirac integrals (fixed Gauss-Laguerre) --------
_FD_Q, _FD_W = np.polynomial.laguerre.laggauss(64)
_FD_COMMON = _FD_W * _FD_Q**2 / (1.0 + np.exp(-np.minimum(_FD_Q, 500.0)))
_I_RHO0 = 7.0 * np.pi**4 / 120.0
_I_NUM = 1.8030853547393952          # int q^2/(e^q+1) = 3 zeta(3)/2
_KT_NU0_EV = 8.617333262e-5 * 2.7255 * (4.0 / 11.0) ** (1.0 / 3.0)
_FD_DEV: dict = {}


def _fd_nodes(device):
    """(q, c, c q q) of the 64-node quadrature as tensors on ``device``."""
    if device not in _FD_DEV:
        q = torch.as_tensor(_FD_Q, dtype=_F64, device=device)
        c = torch.as_tensor(_FD_COMMON, dtype=_F64, device=device)
        _FD_DEV[device] = (q, c, c * q * q)
    return _FD_DEV[device]


def _fd_sums(y, slopes: bool = False):
    """(I_rho, I_P) at y (any shape), and with ``slopes`` also
    (dI_rho/dy, dI_P/dy): 64-node Gauss-Laguerre, summed over the nodes."""
    q, c, cqq = _fd_nodes(y.device)
    yy = y[..., None]
    s = torch.sqrt(q * q + yy * yy)
    i_rho = torch.sum(c * s, dim=-1)
    i_p = torch.sum(cqq / s, dim=-1) / 3.0
    if not slopes:
        return i_rho, i_p
    di_rho = torch.sum(c * yy / s, dim=-1)
    di_p = -(y / 3.0) * torch.sum(cqq / ipow(s, 3), dim=-1)
    return i_rho, i_p, di_rho, di_p


def _fd_rho_p(y):
    """(I_rho(y), I_P(y)) by 64-node Gauss-Laguerre."""
    return _fd_sums(torch.as_tensor(y, dtype=_F64))


def _nu_rho_w(ctx, a):
    """(rho_nu(a)/rho_crit0, w_nu(a)) of the massive species; (0, 1/3)
    when the cosmology has no massive neutrinos."""
    i_rho, i_p = _fd_sums(ctx.y0_nu * a)
    rho = ctx.omnu_rel / ipow(a, 4) * i_rho / _I_RHO0
    return rho, i_p / torch.clamp_min(i_rho, 1e-300)


def _nu_rho_w_cg(ctx, a):
    """(rho, w, c_g^2), the adiabatic sound speed c_g^2 = w - y w'(y) /
    (3 (1 + w))."""
    y = ctx.y0_nu * a
    i_rho, i_p, di_rho, di_p = _fd_sums(y, slopes=True)
    rho = ctx.omnu_rel / ipow(a, 4) * i_rho / _I_RHO0
    w = i_p / i_rho
    dw = (di_p * i_rho - i_p * di_rho) / ipow(i_rho, 2)
    cg2 = w - y * dw / (3.0 * (1.0 + w))
    return rho, w, cg2


class BoltzCtx(NamedTuple):
    """Static per-cosmology context for the perturbation integration."""

    bg: bgmod.BackgroundParams
    h0m: torch.Tensor          # H0/c in 1/Mpc
    omg: torch.Tensor          # photon density parameter
    omnu: torch.Tensor         # MASSLESS-neutrino density parameter
    omb: torch.Tensor
    omc: torch.Tensor
    xs_t: torch.Tensor         # recombination tables on the uniform x-grid
    lntaux_t: torch.Tensor     # ln(-tau_x)
    dlntaux_t: torch.Tensor    # d ln(-tau_x) / dx
    tau_t: torch.Tensor
    eta_t: torch.Tensor
    eta0: torch.Tensor
    omnm0: torch.Tensor        # nonrelativistic Omega_nu today
    y0_nu: torch.Tensor        # m_nu per species / T_nu0 at a = 1
    omnu_rel: torch.Tensor     # relativistic-limit amplitude of rho_nu a^4


def _massive_split(bg, omnm0, h2):
    """(y0, omnu_rel, f_ml): the massive species' Fermi-Dirac scale, its
    relativistic amplitude and the share of the massless pool left."""
    has_m = omnm0 > 0.0
    m_per = omnm0 * 93.14 * h2 / torch.clamp_min(bg.nnu_m, 1.0)
    y0 = torch.where(has_m, m_per / _KT_NU0_EV, 1.0)
    omnu_rel = torch.where(has_m, omnm0 * _I_RHO0 / (y0 * _I_NUM), 0.0)
    f_ml = torch.where(has_m, torch.clamp(1.0 - bg.nnu_m / 3.0, 0.0, 1.0),
                       1.0)
    return y0, omnu_rel, f_ml


def fd_background_pieces(bg):
    """(omg, omnu_massless, omnm0, y0, omnu_rel) -- the make_ctx
    bookkeeping of the Fermi-Dirac massive-neutrino background."""
    h2 = ipow(bg.H0 / 100.0, 2)
    omg = 2.47282e-5 / h2
    omnm0 = bg.omnu0
    y0, omnu_rel, f_ml = _massive_split(bg, omnm0, h2)
    return omg, (bg.omr0 - omg) * f_ml, omnm0, y0, omnu_rel


def e_of_z_fd(bg, z):
    """E(z) = H(z)/H0 with the exact Fermi-Dirac massive-neutrino density
    (any shape of z); exactly background.e_of_z when mnu = 0."""
    omg, omnu_ml, omnm0, y0, omnu_rel = fd_background_pieces(bg)
    z = torch.as_tensor(z, dtype=_F64, device=bg.H0.device)
    zp1 = 1.0 + z
    a = 1.0 / zp1
    i_rho, _ = _fd_sums(y0 * a)
    rho_nu = omnu_rel * ipow(zp1, 4) * i_rho / _I_RHO0
    de = zp1 ** (3.0 * (1.0 + bg.w0 + bg.wa)) \
        * torch.exp(-3.0 * bg.wa * (1.0 - 1.0 / zp1))
    e2 = ((omg + omnu_ml) * ipow(zp1, 4) + bg.omm0 * ipow(zp1, 3)
          + bg.omk0 * ipow(zp1, 2) + bg.oml0 * de + rho_nu)
    return torch.sqrt(e2)


def _gradient_unit(f):
    """``jax.numpy.gradient(f)`` (unit spacing) of a 1-d tensor."""
    inner = (f[2:] - f[:-2]) * 0.5 / 1.0
    return torch.cat([(f[1:2] - f[0:1]) / 1.0, inner,
                      (f[-1:] - f[-2:-1]) / 1.0])


def make_ctx(bg, rec: RecombTable, massive_nu: bool = True) -> BoltzCtx:
    """massive_nu=False: mnu counted as massless radiation and extra
    matter (the round-3 bookkeeping); True: the massive species on the
    exact Fermi-Dirac background plus the (dn, vn) fluid.  Identical when
    mnu = 0."""
    h2 = ipow(bg.H0 / 100.0, 2)
    omg = 2.47282e-5 / h2
    lntaux = torch.log(-rec.tau_x)
    dx = rec.xs[1] - rec.xs[0]
    omnm0 = bg.omnu0 if massive_nu else torch.zeros_like(bg.omnu0)
    y0, omnu_rel, f_ml = _massive_split(bg, omnm0, h2)
    return BoltzCtx(
        bg=bg, h0m=bg.H0 / _C_KMS, omg=omg, omnu=(bg.omr0 - omg) * f_ml,
        omb=bg.ombh2 / h2, omc=bg.omch2 / h2,
        xs_t=rec.xs, lntaux_t=lntaux, dlntaux_t=_gradient_unit(lntaux) / dx,
        tau_t=rec.tau, eta_t=rec.eta, eta0=rec.eta0,
        omnm0=omnm0, y0_nu=y0, omnu_rel=omnu_rel)


# --- background closed forms ---------------------------------------------

def _e2_and_slope(ctx: BoltzCtx, x):
    """E^2(x) = (H/H0)^2 and d E^2/dx (closed forms, w0/wa-aware)."""
    bg = ctx.bg
    a = torch.exp(x)
    de = a ** (-3.0 * (1.0 + bg.w0 + bg.wa)) \
        * torch.exp(-3.0 * bg.wa * (1.0 - a))
    has_m = ctx.omnu_rel > 0.0
    omr = torch.where(has_m, ctx.omg + ctx.omnu, bg.omr0)
    omm = torch.where(has_m, bg.omm0, bg.omm0 + bg.omnu0)
    rho_nu, w_nu = _nu_rho_w(ctx, a)
    a2, a3, a4 = ipow(a, 2), ipow(a, 3), ipow(a, 4)
    e2 = omr / a4 + omm / a3 + bg.omk0 / a2 + bg.oml0 * de + rho_nu
    de2 = (-4.0 * omr / a4 - 3.0 * omm / a3 - 2.0 * bg.omk0 / a2
           + bg.oml0 * de * (-3.0 * (1.0 + bg.w0 + bg.wa) + 3.0 * bg.wa * a)
           - 3.0 * (1.0 + w_nu) * rho_nu)
    return e2, de2


def _hp(ctx: BoltzCtx, x):
    """Conformal Hubble a'(eta)/a = a H / c in 1/Mpc."""
    e2, _ = _e2_and_slope(ctx, x)
    return ctx.h0m * torch.exp(x) * torch.sqrt(e2)


def _dlnhp(ctx: BoltzCtx, x):
    """d ln(Hp) / dx."""
    e2, de2 = _e2_and_slope(ctx, x)
    return 1.0 + 0.5 * de2 / e2


def _interp_t(ctx, x, tab):
    x = torch.as_tensor(x, dtype=_F64, device=ctx.xs_t.device)
    return linear_interp(x, ctx.xs_t, tab)


def _taux(ctx: BoltzCtx, x):
    """d tau/dx (negative), interpolated in ln|.| from the recomb table."""
    return -torch.exp(_interp_t(ctx, x, ctx.lntaux_t))


def _tauxx(ctx: BoltzCtx, x):
    """d^2 tau/dx^2 = tau_x * d ln(-tau_x)/dx."""
    return _taux(ctx, x) * _interp_t(ctx, x, ctx.dlntaux_t)


def _eta(ctx: BoltzCtx, x):
    return _interp_t(ctx, x, ctx.eta_t)


def _xq(ctx: BoltzCtx, x):
    """Every x-only quantity of the right-hand sides at x (any shape), a
    dict keyed by ``XCOLS`` and the divisors' names."""
    x = torch.as_tensor(x, dtype=_F64, device=ctx.xs_t.device)
    e2, de2 = _e2_and_slope(ctx, x)
    a = torch.exp(x)
    taux = _taux(ctx, x)
    rho, w = _nu_rho_w(ctx, a)
    _, _, cg2 = _nu_rho_w_cg(ctx, a)
    return with_divisors(_consts(ctx), {
        "a": a, "hp": ctx.h0m * a * torch.sqrt(e2),
        "taux": taux, "tauxx": taux * _interp_t(ctx, x, ctx.dlntaux_t),
        "dlnhp": 1.0 + 0.5 * de2 / e2, "eta": _eta(ctx, x),
        "rho_nu": rho, "w_nu": w, "cg2": cg2,
        "tcx": ((torch.abs(taux) > 10.0) & (x < _LOG_Z1630)).to(_F64)})


def _x_table(ctx: BoltzCtx, x):
    """The x-only table of ``hierarchy_rk4``: (..., len(XCOLS))."""
    q = _xq(ctx, x)
    return torch.stack([q[c] for c in XCOLS], dim=-1)


def _consts(ctx: BoltzCtx) -> Consts:
    return Consts(ctx.h0m, ctx.omg, ctx.omnu, ctx.omb, ctx.omc)


# --- right-hand sides (the JAX package's signatures) ----------------------

def _psi_of(ctx, x, k, phi, th2, n2):
    a = torch.exp(torch.as_tensor(x, dtype=_F64))
    return (-phi - 12.0 * ipow(ctx.h0m / (k * a), 2)
            * (ctx.omg * th2 + ctx.omnu * n2))


def _common_metric(ctx, x, k, s):
    """(Psi, Phi', Hp, ck/Hp) shared by the full and TC right-hand sides;
    Phi' from the momentum constraint."""
    return metric(_consts(ctx), _xq(ctx, x), k, s)


def energy_constraint_residual(ctx, x, k, s, dphi):
    """Residual of the (unevolved) energy constraint, for diagnostics:
    Phi' - [Psi - (k/Hp)^2 Phi/3 + (H0/Hp)^2/2 * sum(a^2 rho_i delta_i)]."""
    q = _xq(ctx, x)
    a, hp = q["a"], q["hp"]
    phi = s[..., I_PHI]
    psi = _psi_of(ctx, x, k, phi, s[..., I_TH + 2], s[..., I_N + 2])
    rhs = (psi - ipow(k / hp, 2) / 3.0 * phi
           + ipow(ctx.h0m / hp, 2) / 2.0
           * (ctx.omc / a * s[..., I_DC] + ctx.omb / a * s[..., I_DB]
              + 4.0 * ctx.omg / ipow(a, 2) * s[..., I_TH]
              + 4.0 * ctx.omnu / ipow(a, 2) * s[..., I_N]
              + q["rho_nu"] * ipow(a, 2) * s[..., I_NM]))
    return dphi - rhs


def _rhs_full(ctx: BoltzCtx, k, x, s):
    """Full (post-tight-coupling) Einstein-Boltzmann RHS, d/dx."""
    return rhs_full(_consts(ctx), _xq(ctx, x), k, s)


def _slaved_multipoles(ctx, k, x, th1):
    """Tight-coupling algebraic multipoles from Theta_1."""
    return slaved_multipoles(_xq(ctx, x), k, th1)


def _with_slaved(ctx, k, x, s):
    return with_slaved(_xq(ctx, x), k, s)


def _rhs_tc(ctx: BoltzCtx, k, x, s):
    """Tight-coupling RHS (Callin eqs. 70-71 slip expansion)."""
    return rhs_tc(_consts(ctx), _xq(ctx, x), k, s)


def _tc_active(ctx, k, x):
    """Tight coupling while tau_x is large vs both 1 and ck/Hp, and
    before recombination begins (z > ~1630)."""
    return tc_active(_xq(ctx, x), k)


def _initial_state(ctx: BoltzCtx, k, x0):
    """Adiabatic growing-mode ICs deep in radiation domination, Phi = 1,
    for k of any shape: (..., NSTATE)."""
    q = _xq(ctx, x0)
    k = torch.as_tensor(k, dtype=_F64, device=ctx.h0m.device)
    ckh = k / q["hp"]
    a0 = q["a"]
    phi = torch.ones_like(ckh)
    fv = ctx.omnu / (ctx.omg + ctx.omnu)
    psi = -phi / (1.0 + 0.4 * fv)
    dc = -1.5 * psi
    vc = -0.5 * ckh * psi
    th0 = -0.5 * psi
    th1 = ckh * psi / 6.0
    # N2 from the anisotropic-stress closure of Psi (no NaN when the
    # massless pool is empty)
    n2 = torch.where(ctx.omnu > 0.0,
                     -(psi + phi) * ipow(k * a0 / ctx.h0m, 2)
                     / (12.0 * torch.clamp_min(ctx.omnu, 1e-30)), 0.0)
    # massive-nu fluid: adiabatic, ultra-relativistic at x0
    nm = 3.0 * (1.0 + q["w_nu"]) * th0
    zero = torch.zeros_like(ckh)
    cols = [zero] * NSTATE
    cols[I_PHI], cols[I_DC], cols[I_VC] = phi, dc, vc
    cols[I_DB], cols[I_VB] = dc, vc
    cols[I_TH], cols[I_TH + 1] = th0, th1
    cols[I_N], cols[I_N + 1], cols[I_N + 2] = th0, th1, n2
    cols[I_NM], cols[I_NM + 1] = nm, vc
    return with_slaved(q, k, torch.stack(cols, dim=-1))


# --- integration ----------------------------------------------------------

class PerturbSolution(NamedTuple):
    ks: torch.Tensor         # (nk,) coarse wavenumbers [1/Mpc]
    xs: torch.Tensor         # (nx,) LOS x-grid (ln a)
    states: torch.Tensor     # (nk, nx, NSTATE)
    zeta_unit: torch.Tensor  # comoving curvature per unit Phi_init


def _segment_grid(n_a, n_b_outer, n_b_inner, n_c_outer, n_c_inner, x0):
    xa, xb, xc = -9.2, -5.0, 0.0
    dx_a = (xa - x0) / n_a
    dx_b = (xb - xa) / (n_b_outer * n_b_inner)
    dx_c = (xc - xb) / (n_c_outer * n_c_inner)
    return xa, xb, dx_a, dx_b, dx_c


def _segment(ctx, ks, s0, x_start, dx, n_outer, n_inner, store):
    """One segment of the JAX package's _integrate_segment for the rows
    ks: (s_end, xs of the outer points, states there or None), through
    one ``hierarchy_rk4`` call.  The step starts are x_start + i (n_inner
    dx) + j dx, as the JAX loop forms them."""
    dev = ks.device
    i = torch.arange(n_outer, dtype=_F64, device=dev)
    j = torch.arange(n_inner, dtype=_F64, device=dev)
    x = ((x_start + i * (n_inner * dx))[:, None] + j * dx).reshape(-1)
    xtab = _x_table(ctx, rk4_subpoints(x, dx)).contiguous()
    c = ctx
    consts = torch.stack([c.h0m, c.omg, c.omnu, c.omb, c.omc]).to(_F64)
    s_end, kept = hierarchy_rk4(xtab, ks.contiguous(), consts,
                                s0.contiguous(), float(dx), n_outer, n_inner,
                                store)
    xs = x_start + torch.arange(1, n_outer + 1, dtype=_F64,
                                device=dev) * (n_inner * dx)
    return s_end, xs, kept


@on_device_of_inputs
def solve_perturbations(ctx: BoltzCtx, ks, n_a: int = 1500,
                        n_b_outer: int = 1050, n_b_inner: int = 4,
                        n_c_outer: int = 380, n_c_inner: int = 11,
                        x0: float = -18.0) -> PerturbSolution:
    """Integrate the hierarchy for each k; store states on the LOS grid.

    Segments (x = ln a): A [x0, -9.2] tight-coupled, no storage; B
    [-9.2, -5.0] through recombination, stored every n_b_inner steps; C
    [-5.0, 0] ISW era, stored every n_c_inner steps -- one
    ``hierarchy_rk4`` launch each, the curvature mode k = 2e-5 riding as
    one more row through A and B and taking a fourth launch through the
    first part of C.  Explicit RK4 needs k (dx_c / Hp) below ~2.8; the
    measured edge of the default n_c_inner = 11 is 0.46-0.48/Mpc (see
    ``segment_c_inner_steps``)."""
    dev = ctx.h0m.device
    ks = torch.as_tensor(ks, dtype=_F64, device=dev).reshape(-1)
    xa, xb, dx_a, dx_b, dx_c = _segment_grid(
        n_a, n_b_outer, n_b_inner, n_c_outer, n_c_inner, x0)
    rows = torch.cat([ks, torch.full((1,), 2e-5, dtype=_F64, device=dev)])
    s = _initial_state(ctx, rows, torch.tensor(x0, dtype=_F64, device=dev))
    s, _, _ = _segment(ctx, rows, s, x0, dx_a, 30, n_a // 30, False)
    s, xs_b, st_b = _segment(ctx, rows, s, xa, dx_b, n_b_outer, n_b_inner,
                             True)
    _, xs_c, st_c = _segment(ctx, ks, s[:-1], xb, dx_c, n_c_outer,
                             n_c_inner, True)
    # curvature normalisation: the superhorizon mode in matter domination,
    # zeta = (5/3) Phi_MD per unit Phi_init
    n_md = int(round((-2.3 - xb) / dx_c))
    s_md, _, _ = _segment(ctx, rows[-1:], s[-1:], xb, dx_c, n_md, 1, False)
    return PerturbSolution(
        ks=ks, xs=torch.cat([xs_b, xs_c]),
        states=torch.cat([st_b[:-1], st_c], dim=1),
        zeta_unit=(5.0 / 3.0) * s_md[0, I_PHI])


# --- sources --------------------------------------------------------------

class SourceTable(NamedTuple):
    ks: torch.Tensor       # (nk,) coarse k
    xs: torch.Tensor       # (nx,) LOS grid
    chi: torch.Tensor      # (nx,) comoving distance eta0 - eta(x)
    s_t: torch.Tensor      # (nk, nx) full TT source (dx measure)
    s_e: torch.Tensor      # (nk, nx) E-polarization source g (3/4) Pi
    zeta_unit: torch.Tensor
    s_p: torch.Tensor      # (nk, nx) lensing-potential source
    chi_star: torch.Tensor  # () comoving distance to tau = 1


def _fd_x(y, x):
    """``jax.numpy.gradient(y, x, axis=-1)`` on a nonuniform grid x."""
    dx1 = x[1:-1] - x[:-2]
    dx2 = x[2:] - x[1:-1]
    a = -dx2 / (dx1 * (dx1 + dx2))
    b = (dx2 - dx1) / (dx1 * dx2)
    c = dx1 / (dx2 * (dx1 + dx2))
    inner = a * y[..., :-2] + b * y[..., 1:-1] + c * y[..., 2:]
    lo = (y[..., 1:2] - y[..., 0:1]) / (x[1:2] - x[0:1])
    hi = (y[..., -1:] - y[..., -2:-1]) / (x[-1:] - x[-2:-1])
    return torch.cat([lo, inner, hi], dim=-1)


def compute_sources(ctx: BoltzCtx, sol: PerturbSolution) -> SourceTable:
    """LOS temperature, polarization and lensing-potential sources on the
    stored grid (Callin eq. 76 structure; derivatives as finite
    differences on the LOS grid, local terms from the exact RHS)."""
    xs = sol.xs
    q = _xq(ctx, xs)
    taux, hp = q["taux"], q["hp"]
    tau = _interp_t(ctx, xs, ctx.tau_t)
    emtau = torch.exp(-tau)
    gvis = -taux * emtau
    chi = ctx.eta0 - q["eta"]
    c = _consts(ctx)
    k = sol.ks[:, None]
    s = sol.states
    psi, dphi, _, _ = metric(c, q, k, s)
    ds = rhs_full(c, q, k, s)
    th2, n2 = s[..., I_TH + 2], s[..., I_N + 2]
    dpsi = (-dphi - 12.0 * ipow(ctx.h0m / (k * q["a"]), 2)
            * (ctx.omg * (ds[..., I_TH + 2] - 2.0 * th2)
               + ctx.omnu * (ds[..., I_N + 2] - 2.0 * n2)))
    pi_eq = th2 + s[..., I_THP] + s[..., I_THP + 2]
    local = s[..., I_TH] + psi + pi_eq / 4.0
    weyl2 = psi - s[..., I_PHI]

    doppler = -_fd_x(hp * gvis * s[..., I_VB], xs) / k
    pol_in = hp * gvis * pi_eq
    pol = 0.75 / ipow(k, 2) * _fd_x(hp * _fd_x(pol_in, xs), xs)
    s_t = gvis * local + emtau * (dpsi - dphi) + doppler + pol
    s_e = gvis * 0.75 * pi_eq

    # lensing-potential source (Psi - Phi)/Hp (chi* - chi)/(chi* chi)
    x_star = linear_interp(torch.zeros((), dtype=_F64, device=xs.device),
                           -torch.log(ctx.tau_t), ctx.xs_t)
    chi_star = ctx.eta0 - _interp_t(ctx, x_star, ctx.eta_t)
    w_lens = torch.clamp_min(chi_star - chi, 0.0) / (
        chi_star * torch.clamp_min(chi, 1e-6))
    return SourceTable(ks=sol.ks, xs=xs, chi=chi, s_t=s_t, s_e=s_e,
                       zeta_unit=sol.zeta_unit, s_p=weyl2 * (w_lens / hp),
                       chi_star=chi_star)


# --- spherical Bessel table ----------------------------------------------

_JL_CACHE: dict = {}


def _jl_table(ls, umax, du, device):
    """The spherical Bessel table j_l(u) on a uniform grid, built on the
    host with scipy (once per (ls, umax, du)) and moved to ``device``
    once: (us (nu,), tab (nl, nu))."""
    key = (tuple(int(l) for l in ls), float(umax), float(du))
    if key not in _JL_CACHE:
        from scipy.special import spherical_jn
        us = np.arange(0.0, umax + 2 * du, du)
        tab = np.stack([spherical_jn(int(l), us) for l in ls])
        _JL_CACHE[key] = {"host": (us, tab)}
    entry = _JL_CACHE[key]
    if device not in entry:
        entry[device] = tuple(torch.as_tensor(a, dtype=_F64, device=device)
                              for a in entry["host"])
    return entry[device]


def _jl_interp(tab_us, tab, u):
    """Linear interpolation of the (nl, nu) Bessel table at u (any shape),
    returning shape (nl,) + u.shape."""
    du = tab_us[1] - tab_us[0]
    f = torch.clamp(u / du, 0.0, tab.shape[1] - 1.001)
    i0 = torch.floor(f).long()
    w = f - i0
    return tab[:, i0] * (1.0 - w) + tab[:, i0 + 1] * w


# --- C_l assembly ---------------------------------------------------------

def _trapz_w(x):
    w = torch.zeros_like(x)
    h = 0.5 * (x[1:] - x[:-1])
    w[1:] += h
    w[:-1] += h
    return w


def _prep_projection(src: SourceTable, ls, ks_fine):
    """The source-independent prep of every Bessel projection: trapz
    weights, Bessel table, u-grid gather indices and weights, the 1e-6 u
    floor and the late-time (x > -5) mask.  One read of chi[0] sets the
    table's range, as in the JAX package."""
    dev = src.s_t.device
    wx = _trapz_w(src.xs)
    umax = float(ks_fine[-1]) * float(src.chi[0]) * 1.02
    tab_us, tab = _jl_table(ls, umax, 0.05, dev)
    du = tab_us[1] - tab_us[0]
    u = ks_fine[:, None] * src.chi[None, :]
    uf = torch.clamp(u / du, 0.0, tab.shape[1] - 1.001)
    u_i0 = torch.floor(uf).long()
    ls_arr = torch.as_tensor(np.asarray(ls), dtype=_F64, device=dev)
    return {
        "wx": wx, "tab": tab, "ls_arr": ls_arr,
        "pref_e": torch.sqrt((ls_arr + 2) * (ls_arr + 1) * ls_arr
                             * (ls_arr - 1)),
        "u_i0": u_i0, "u_w": uf - u_i0,
        "u_safe2": ipow(torch.clamp_min(u, 1e-6), 2),
        "late": (src.xs > -5.0).to(_F64),
    }


def _project_l_rows(tab, ls_arr, pref_e_all, st_wx, se_wx, u_i0, u_w,
                    u_safe2, late, lmax_late):
    """Per-l Bessel projection: (th_l, e_l), each (nl, nkf), one l row at
    a time so only one (nkf, nx) Bessel buffer is live."""
    th_rows, e_rows = [], []
    for row, l_val, pref_e in zip(tab, ls_arr, pref_e_all):
        jl = row[u_i0] * (1.0 - u_w) + row[u_i0 + 1] * u_w
        wl_late = torch.exp(-ipow(l_val / lmax_late, 4))
        jw = jl * (1.0 - late + late * wl_late)[None, :]
        th_rows.append(torch.sum(st_wx * jw, dim=-1))
        e_rows.append(pref_e * torch.sum(se_wx * (jw / u_safe2), dim=-1))
    return torch.stack(th_rows), torch.stack(e_rows)


def _catmull_rom_k(src, ks_coarse, ks_fine):
    """Tensor Catmull-Rom interpolation of src(k, x) onto a fine k grid."""
    lnk_c = torch.log(ks_coarse)
    lnk_f = torch.log(ks_fine)
    idx = torch.clamp(torch.searchsorted(lnk_c, lnk_f.contiguous()) - 1, 1,
                      lnk_c.numel() - 3)
    x0, x1, x2, x3 = (lnk_c[idx + o] for o in (-1, 0, 1, 2))
    t = (lnk_f - x1) / (x2 - x1)
    p0, p1, p2, p3 = (src[idx + o] for o in (-1, 0, 1, 2))
    m1 = (p2 - p0) * ((x2 - x1) / (x2 - x0))[:, None]
    m2 = (p3 - p1) * ((x2 - x1) / (x3 - x1))[:, None]
    tt = t[:, None]
    t2, t3 = ipow(tt, 2), ipow(tt, 3)
    h00 = 2 * t3 - 3 * t2 + 1
    h10 = t3 - 2 * t2 + tt
    h01 = -2 * t3 + 3 * t2
    h11 = t3 - t2
    return h00 * p1 + h10 * m1 + h01 * p2 + h11 * m2


def _pzeta_wk(src, bg, ks_fine):
    """The primordial curvature spectrum per unit Phi_init times the
    d ln k trapezoid weights, (nkf,)."""
    pzeta = (bg.As * (ks_fine / bg.pivot_scalar) ** (bg.ns - 1.0)
             / ipow(src.zeta_unit, 2))
    return pzeta * _trapz_w(torch.log(ks_fine))


@on_device_of_inputs
def cls_from_sources(src: SourceTable, bg, ls, ks_fine,
                     lmax_late: float = 60.0):
    """Project sources to Theta_l/E_l and assemble raw C_l (muK^2) at the
    nodes ``ls``: {'ls', 'tt', 'ee', 'te'}; the late-time (x > -5) part
    of the LOS integral is damped above l ~ lmax_late."""
    ks_fine = torch.as_tensor(ks_fine, dtype=_F64, device=src.s_t.device)
    s_t_f = _catmull_rom_k(src.s_t, src.ks, ks_fine)
    s_e_f = _catmull_rom_k(src.s_e, src.ks, ks_fine)
    pp = _prep_projection(src, ls, ks_fine)
    th_l, e_l = _project_l_rows(pp["tab"], pp["ls_arr"], pp["pref_e"],
                                s_t_f * pp["wx"][None, :],
                                s_e_f * pp["wx"][None, :], pp["u_i0"],
                                pp["u_w"], pp["u_safe2"], pp["late"],
                                lmax_late)
    pw = _pzeta_wk(src, bg, ks_fine)
    t0_muk = bg.T_cmb_k * 1e6
    norm = 4.0 * math.pi * ipow(t0_muk, 2)
    return {"ls": torch.as_tensor(np.asarray(ls), device=ks_fine.device),
            "tt": norm * (ipow(th_l, 2) @ pw),
            "ee": norm * (ipow(e_l, 2) @ pw),
            "te": norm * ((th_l * e_l) @ pw)}


@on_device_of_inputs
def clpp_from_sources(src: SourceTable, bg, Ls, ks_fine):
    """Exact (non-Limber) lensing-potential power C_phiphi at the L nodes:
    {'ls', 'pp'}; no late-time damping (the lensing kernel is
    late-time)."""
    ks_fine = torch.as_tensor(ks_fine, dtype=_F64, device=src.s_t.device)
    s_p_f = _catmull_rom_k(src.s_p, src.ks, ks_fine)
    pp = _prep_projection(src, Ls, ks_fine)
    u_i0, u_w = pp["u_i0"], pp["u_w"]
    sp_wx = s_p_f * pp["wx"][None, :]
    phi_l = torch.stack([
        torch.sum(sp_wx * (row[u_i0] * (1.0 - u_w) + row[u_i0 + 1] * u_w),
                  dim=-1) for row in pp["tab"]])
    clpp = 4.0 * math.pi * (ipow(phi_l, 2) @ _pzeta_wk(src, bg, ks_fine))
    return {"ls": torch.as_tensor(np.asarray(Ls), device=ks_fine.device),
            "pp": clpp}


# --- high-level orchestration ---------------------------------------------

def default_l_nodes(lmax: int):
    """C_l evaluation nodes: dense through the first peaks, then every
    Delta l = 40 (the acoustic period is ~300, so >= 7 nodes per
    period)."""
    base = [2, 3, 4, 5, 7, 9, 12, 16, 21, 27, 35, 45, 60, 80, 100, 125,
            150, 175, 200, 220, 240, 260, 280, 300]
    ls = [l for l in base if l <= lmax]
    l = 300
    while l < lmax:
        l = min(l + 40, lmax)
        ls.append(l)
    if ls[-1] != lmax:
        ls.append(lmax)
    return np.unique(np.asarray(ls, dtype=np.int64))


def _interp_l_nodes(l_nodes, vals, ells):
    """Cubic spline of D_l = l(l+1)C_l/2pi in ln(l) from the nodes onto
    integer ells, on the host (table assembly)."""
    from scipy.interpolate import CubicSpline
    d_nodes = vals * (l_nodes * (l_nodes + 1.0)) / (2.0 * np.pi)
    d_all = CubicSpline(np.log(l_nodes), d_nodes)(np.log(ells))
    return d_all * (2.0 * np.pi) / (ells * (ells + 1.0))


def segment_c_inner_steps(kmax, h0_kms, n_c_outer: int = 380,
                          span: float = 5.0, margin: float = 0.65,
                          floor: int = 11) -> int:
    """Segment-C inner step count keeping explicit RK4 stable at kmax
    (k dx_c c/H0 < 2 sqrt(2) with a 35% margin; the floor keeps the
    default grid at the default kmax)."""
    c_over_h0 = 299792.458 / float(h0_kms)
    dx_c_max = margin * 2.0 * np.sqrt(2.0) / (c_over_h0 * float(kmax))
    return max(floor, int(np.ceil(span / (n_c_outer * dx_c_max))))


def _fd_wanted(massive_nu, bg) -> bool:
    """The FD-consistent recombination background: the massive fluid is
    on and the cosmology has mnu > 0."""
    return bool(massive_nu) and float(bg.omnu0) > 0.0


@on_device_of_inputs
def compute_cls(params=None, lmax: int = 1500, *, zre: float = 7.7,
                l_nodes=None, nk: int | None = None, nkf: int | None = None,
                kmax: float | None = None, lens_potential: bool = False,
                lmax_pp: int = 150, massive_nu: bool = True):
    """Engine-free unlensed scalar TT/EE/TE to lmax (muK^2, raw C_l): a
    CAMB-shaped (lmax+1, 4) float64 tensor [TT, EE, BB, TE] (BB = 0, rows
    0-1 zero), and with ``lens_potential=True`` the pair (cls, clpp) with
    clpp (lmax+1,) the exact LOS C_phiphi, nonzero for 2 <= L <= lmax_pp.
    Recombination (one ``recomb_rk4`` launch) -> the hierarchy (four
    ``hierarchy_rk4`` launches) -> sources -> C_l at the l nodes -> the
    host spline onto every integer l."""
    from ..params import merge_params
    from ..utils.weights import call_device
    from scipy.interpolate import CubicSpline

    dev = call_device()
    p = merge_params(params or {})
    bg = bgmod.background(p, dev)
    rec = recombination(bg, zre=zre, massive_nu=_fd_wanted(massive_nu, bg))
    ctx = make_ctx(bg, rec, massive_nu=massive_nu)
    eta0 = float(rec.eta0)

    kmin = 2e-5
    if kmax is None:
        kmax = min(0.5, max(0.22, 2.2 * lmax / eta0))
    if nk is None:
        nk = int(np.ceil(2.0 * (kmax - kmin) / 0.00525))
    if nkf is None:
        nkf = int(np.ceil((kmax - kmin) / 6.7e-5))
    ii = np.linspace(0.0, 1.0, nk)
    ks = kmin + (kmax - kmin) * ii**2

    n_c_inner = segment_c_inner_steps(kmax, float(p["H0"]))
    sol = solve_perturbations(ctx, ks, n_c_inner=n_c_inner)
    src = compute_sources(ctx, sol)

    if l_nodes is None:
        l_nodes = default_l_nodes(lmax)
    l_nodes = np.asarray(l_nodes, dtype=np.int64)
    ks_fine = np.linspace(kmin, 0.95 * kmax, nkf)
    cl = cls_from_sources(src, bg, l_nodes, ks_fine)

    ells = np.arange(2, lmax + 1, dtype=np.float64)
    out = np.zeros((lmax + 1, 4))
    lf = l_nodes.astype(np.float64)
    for col, key in ((0, "tt"), (1, "ee"), (3, "te")):
        out[2:, col] = _interp_l_nodes(lf, cl[key].cpu().numpy(), ells)
    out_t = torch.as_tensor(out, device=dev)
    if not lens_potential:
        return out_t

    lp_base = np.array([2, 3, 4, 5, 7, 9, 12, 16, 21, 27, 35, 45, 60,
                        80, 100, 120, 150, 200], dtype=np.int64)
    lp = lp_base[lp_base <= min(lmax_pp, lmax)]
    clpp_nodes = clpp_from_sources(src, bg, lp, ks_fine)["pp"].cpu().numpy()
    lmax_p = int(lp[-1])
    ells_p = np.arange(2, lmax_p + 1, dtype=np.float64)
    lpf = lp.astype(np.float64)
    d_nodes = clpp_nodes * (lpf * (lpf + 1.0)) ** 2 / (2.0 * np.pi)
    d_all = CubicSpline(np.log(lpf), d_nodes)(np.log(ells_p))
    out_pp = np.zeros(lmax + 1)
    out_pp[2:lmax_p + 1] = d_all * (2.0 * np.pi) \
        / (ells_p * (ells_p + 1.0)) ** 2
    return out_t, torch.as_tensor(out_pp, device=dev)
