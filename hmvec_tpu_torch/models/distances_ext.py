"""Extended background quantities on float64 tensors (port of
hmvec_tpu/models/distances_ext.py): conformal time, recombination, BAO,
the acoustic scale and CMB lensing by Limber.

  * conformal time eta(z) = int_z^inf c dz'/H(z') by the substitution
    u = 1/(1+z') on a finite domain, 256-node Gauss-Legendre;
  * z_star from the Hu & Sugiyama (1996) fitting formula;
  * r_s(drag) from the Eisenstein-Hu sound horizon of the transfer
    function.

``z_of_tau`` is an 80-step bisection on the device (a fixed count, no
host read).  ``solve_h0_from_theta100`` is a parameter-time solve: it
runs on the host, in float64 on the CPU, and returns a Python float.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.weights import gauss_legendre, on_device
from . import background as bgmod
from .transfer import _eh_scales

_GLN, _GLW = gauss_legendre(256)
CSPEED_KMS = 299792.458


def conformal_time(bg, z):
    """eta(z) = int_z^inf c dz'/H(z') in Mpc (conformal lookback to z=inf):
    eta = c int_0^{a(z)} du / (u^2 H(1/u - 1))."""
    z = torch.as_tensor(z, dtype=torch.float64, device=bg.H0.device)
    nodes, weights = on_device("gl256", z.device, lambda: (_GLN, _GLW))
    a = 1.0 / (1.0 + z)
    u = a[..., None] * nodes                     # (..., n)
    zz = 1.0 / torch.clamp(u, min=1e-12) - 1.0
    integrand = 1.0 / (u**2 * bgmod.e_of_z(bg, zz))
    return (CSPEED_KMS / bg.H0) * a * (integrand @ weights)


def conformal_age(bg):
    """Conformal age of the universe (eta at z = 0)."""
    return conformal_time(bg, 0.0)


def z_star_hu_sugiyama(bg):
    """Recombination redshift fit (Hu & Sugiyama 1996 Eq E-1)."""
    ombh2 = bg.ombh2
    omh2 = bg.omch2 + bg.ombh2
    g1 = 0.0783 * ombh2**-0.238 / (1.0 + 39.5 * ombh2**0.763)
    g2 = 0.560 / (1.0 + 21.1 * ombh2**1.81)
    return 1048.0 * (1.0 + 0.00124 * ombh2**-0.738) * (1.0 + g1 * omh2**g2)


def tau_star(bg):
    """Conformal time at recombination (eta at the z_star fit)."""
    return conformal_time(bg, z_star_hu_sugiyama(bg))


def z_of_tau(bg, tau, num_iter: int = 80, zmax: float = 5e3):
    """z at conformal time tau: eta(z) inverted by a fixed-count bisection
    on [0, zmax] (eta decreases with z).  Like the JAX package's, the
    bisection selects among constants and passes no derivative."""
    tau = torch.as_tensor(tau, dtype=torch.float64, device=bg.H0.device)
    lo = torch.zeros_like(tau)
    hi = torch.full_like(tau, zmax)
    with torch.no_grad():
        for _ in range(num_iter):
            mid = (lo + hi) / 2.0
            go_right = conformal_time(bg, mid) > tau
            lo, hi = (torch.where(go_right, mid, lo),
                      torch.where(go_right, hi, mid))
    return (lo + hi) / 2.0


def rs_drag_eh(bg):
    """Sound horizon at the drag epoch from the EH98 fitting forms, in Mpc
    (the transfer function's sh_d, which is in Mpc/h)."""
    s = _eh_scales(bg)
    return s["sh_d"] / s["h"]


def get_bao_rs_dV(bg, zs):
    """r_s(drag) / D_V(z)."""
    zs = torch.atleast_1d(torch.as_tensor(zs, dtype=torch.float64,
                                          device=bg.H0.device))
    Hzs = bgmod.hubble_parameter(bg, zs) / CSPEED_KMS
    D_As = bgmod.angular_diameter_distance(bg, zs)
    D_Vs = ((1.0 + zs) ** 2 * D_As**2 * zs / Hzs) ** (1.0 / 3.0)
    return rs_drag_eh(bg) / D_Vs


def theta_star_approx(bg):
    """100 theta_s: the acoustic angular scale from the EH98 sound horizon
    (at the drag epoch, standing in for r_s(z*)) and the background's
    D_A(z*); an approximate analogue of CAMB's cosmomc_theta (~0.5%)."""
    zstar = z_star_hu_sugiyama(bg)
    rs = rs_drag_eh(bg)
    da = bgmod.angular_diameter_distance(bg, zstar)
    return 100.0 * rs / ((1.0 + zstar) * da)


def solve_h0_from_theta100(params: dict, theta100: float,
                           lo: float = 40.0, hi: float = 100.0,
                           num_iter: int = 60) -> float:
    """H0 that reproduces the requested 100 theta_s, by a 60-step bisection
    on the host: each step builds the background on the CPU in float64 and
    evaluates ``theta_star_approx`` (which increases with H0).  Tensor
    parameters are read once, as Python floats.  The one free function
    that stays on the CPU by design, whatever the caller's device: each of
    its 60 steps branches on one scalar, which on the card would be a
    launch and a read back per step, and the answer is a Python float."""
    base = {k: (float(v.detach()) if isinstance(v, torch.Tensor) else v)
            for k, v in params.items()}
    cpu = torch.device("cpu")

    def theta_of_h0(h0):
        return float(theta_star_approx(
            bgmod.background({**base, "H0": float(h0)}, cpu)))

    lo_v, hi_v = float(lo), float(hi)
    theta100 = float(theta100)
    for _ in range(num_iter):
        mid = (lo_v + hi_v) / 2.0
        if theta_of_h0(mid) < theta100:
            lo_v = mid
        else:
            hi_v = mid
    return (lo_v + hi_v) / 2.0


def cmb_lensing_limber(cosmo, lmax, nonlinear=False, nz: int = 100,
                       kmax: float = 10.0):
    """(ells, C_L^kappakappa) for L = 2..lmax by Limber over chi to the
    last-scattering surface, with the Weyl-potential spectrum from the
    matter power by the Poisson relation
    P_Weyl = [3/2 Omega_m H0^2 (1+z)]^2 P_m / k^4.

    The power is tabulated once on 2,048 log-spaced k per chi node; each
    (L, chi) point reads it by a searchsorted (side left, minus one,
    clipped to the table) and a lerp in ln k, as one (nL, nchi)
    computation.  ``nonlinear`` takes the instance's nonlinear power
    (its ``halofit`` version), else the engine's linear power."""
    from ..pipeline import _linspace

    bg = cosmo.bg
    dev = bg.H0.device
    chistar = conformal_age(bg) - tau_star(bg)
    chis = _linspace(torch.zeros((), dtype=torch.float64, device=dev),
                     chistar, nz)
    dchis = (chis[2:] - chis[:-2]) / 2.0
    chis = chis[1:-1]
    zs = bgmod.redshift_at_comoving_radial_distance(bg, chis)

    ls = torch.arange(2.0, lmax + 1.0, dtype=torch.float64, device=dev)
    H0_invmpc = bg.H0 / CSPEED_KMS
    pref = (1.5 * bg.omm0 * H0_invmpc**2) ** 2
    win = ((chistar - chis) / (chis**2 * chistar)) ** 2

    ktab = torch.as_tensor(np.geomspace(1e-4, kmax, 2048), device=dev)
    if nonlinear:
        Ptab = cosmo._get_matter_power(zs, ktab, nonlinear=True)
    else:
        Ptab = cosmo.engine.plin(bg, zs, ktab, accuracy=cosmo.accuracy,
                                 growth_mode=cosmo.growth_mode)
    lktab = torch.log(ktab)

    k = (ls[:, None] + 0.5) / chis[None, :]             # (nL, nchi)
    lke = torch.log(k)
    ik = (torch.searchsorted(lktab, lke) - 1).clamp(0, ktab.numel() - 2)
    t = (lke - lktab[ik]) / (lktab[ik + 1] - lktab[ik])
    # Ptab[chi, ik[L, chi]] as a gather along k of Ptab^T (nk, nchi)
    pv = (torch.gather(Ptab.T, 0, ik) * (1 - t)
          + torch.gather(Ptab.T, 0, ik + 1) * t)
    w = ((k >= 1e-4) & (k < kmax)).to(torch.float64)
    pweyl = pref * (1.0 + zs) ** 2 * pv / k**4
    cl = (dchis * w * pweyl * win).sum(dim=-1) * (ls * (ls + 1.0)) ** 2
    return ls, cl
