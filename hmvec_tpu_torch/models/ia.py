"""Intrinsic alignments (NLA) and lens magnification for Limber spectra on
float64 tensors (port of hmvec_tpu/models/ia.py).

The nonlinear-linear-alignment model of Bridle & King 2007: the intrinsic
shape field traces the (nonlinear) density field with the amplitude

    F(z) = -A_IA * (C1 rho_cr0) * Omega_m / D(z) * ((1+z)/(1+z0))^eta_IA,

C1 rho_cr0 = 0.0134, D normalized to D(0) = 1.  Density-type legs are
dimensionless (a normalized n(z), or F(z) n(z) for alignments);
lensing-type legs are ``limber.lensing_window``, and the magnification leg
of a flux-limited lens sample is (5 s_mag - 2) times the lensing window of
its own n(z).  Every spectrum is ``limber.limber_integral`` of two legs,
on the background's device.
"""

from __future__ import annotations

import torch

from ..ops.quadrature import trapz_traced
from . import background as bgmod
from . import limber as limb

# C1 * rho_critical(z=0) of the standard NLA normalization (Bridle & King
# 2007, from the SuperCOSMOS measurement of Brown et al.)
C1_RHOCRIT = 0.0134


def _t(bg, x):
    return torch.atleast_1d(limb._t(bg, x))


def nla_amplitude(bg, zs, A_ia=1.0, eta_ia=0.0, z0=0.62,
                  growth_mode="closed", growth_table=None):
    """F(z) = -A_IA (C1 rho_cr0) Om / D(z) * ((1+z)/(1+z0))^eta_IA, with
    D(0) = 1 (``growth_mode="ode"``: the integrated w0/wa growth)."""
    zs = limb._t(bg, zs)
    D = bgmod.d_growth(bg, 1.0 / (1.0 + zs), norm="z0norm",
                       mode=growth_mode, table=growth_table)
    return (-A_ia * C1_RHOCRIT * bg.omm0 / D
            * ((1.0 + zs) / (1.0 + z0)) ** eta_ia)


def _normed(bg, dndz, gzs):
    dndz = limb._t(bg, dndz)
    return dndz / trapz_traced(dndz, gzs)


def ia_window(bg, gzs, dndz, A_ia=1.0, eta_ia=0.0, z0=0.62, **growth_kw):
    """The density-type IA leg on the evaluation grid: F(z) n(z)."""
    gzs = _t(bg, gzs)
    return (nla_amplitude(bg, gzs, A_ia, eta_ia, z0, **growth_kw)
            * _normed(bg, dndz, gzs))


def magnification_window(bg, ezs, gzs, gdndz, s_mag):
    """The lensing-type magnification leg (5 s_mag - 2) W_lens[lens n(z)];
    it vanishes at s_mag = 0.4."""
    return (5.0 * s_mag - 2.0) * limb.lensing_window(bg, ezs, gzs, gdndz)


def _chis_hzs(bg, gzs):
    return (bgmod.comoving_radial_distance(bg, gzs),
            bgmod.h_of_z(bg, gzs))


def C_II(bg, ells, zs, ks, Pmm, gzs, dndz1, dndz2=None,
         A_ia=1.0, eta_ia=0.0, z0=0.62, **growth_kw):
    """Intrinsic-intrinsic spectrum of two source samples sharing (A_ia,
    eta_ia, z0); dndz2=None for an auto spectrum.  Scales as A_ia^2."""
    gzs = _t(bg, gzs)
    W1 = ia_window(bg, gzs, dndz1, A_ia, eta_ia, z0, **growth_kw)
    W2 = W1 if dndz2 is None else ia_window(bg, gzs, dndz2, A_ia, eta_ia,
                                            z0, **growth_kw)
    chis, hzs = _chis_hzs(bg, gzs)
    return limb.limber_integral(ells, zs, ks, Pmm, gzs, W1, W2, hzs, chis)


def C_kI(bg, ells, zs, ks, Pmm, gzs, sdndz, A_ia=1.0, eta_ia=0.0, z0=0.62,
         lzs=None, ldndz=None, lwindow=None, **growth_kw):
    """GI term, lensing convergence x intrinsic alignment (one ordering):
    the lensing leg of the other sample (a source at lzs, an n(z), or a
    precomputed lwindow), the IA leg of the sample whose shapes are
    measured (sdndz).  Negative for A_ia > 0."""
    gzs = _t(bg, gzs)
    WL = (limb.lensing_window(bg, gzs, lzs, ldndz)
          if lwindow is None else lwindow)
    WI = ia_window(bg, gzs, sdndz, A_ia, eta_ia, z0, **growth_kw)
    chis, hzs = _chis_hzs(bg, gzs)
    return limb.limber_integral(ells, zs, ks, Pmm, gzs, WL, WI, hzs, chis)


def C_gI(bg, ells, zs, ks, Pgm, gzs, gdndz, sdndz,
         A_ia=1.0, eta_ia=0.0, z0=0.62, **growth_kw):
    """Lens density x source intrinsic alignment, on the galaxy-matter
    spectrum Pgm (the gamma_t contamination)."""
    gzs = _t(bg, gzs)
    Wg = _normed(bg, gdndz, gzs)
    WI = ia_window(bg, gzs, sdndz, A_ia, eta_ia, z0, **growth_kw)
    chis, hzs = _chis_hzs(bg, gzs)
    return limb.limber_integral(ells, zs, ks, Pgm, gzs, Wg, WI, hzs, chis)


def shear_cls_with_ia(bg, ells, zs, ks, Pmm, gzs, sdndz1, sdndz2=None,
                      A_ia=1.0, eta_ia=0.0, z0=0.62, **growth_kw):
    """The observed cosmic-shear spectrum of bins (1, 2) with NLA
    alignments: {'GG', 'GI' (both orderings), 'II', 'total'}, C^obs =
    C^GG + C^{G1 I2} + C^{G2 I1} + C^{I1 I2}."""
    gzs = _t(bg, gzs)
    chis, hzs = _chis_hzs(bg, gzs)
    WL1 = limb.lensing_window(bg, gzs, gzs, sdndz1)
    WI1 = ia_window(bg, gzs, sdndz1, A_ia, eta_ia, z0, **growth_kw)
    if sdndz2 is None:
        WL2, WI2 = WL1, WI1
    else:
        WL2 = limb.lensing_window(bg, gzs, gzs, sdndz2)
        WI2 = ia_window(bg, gzs, sdndz2, A_ia, eta_ia, z0, **growth_kw)

    def proj(Wa, Wb):
        return limb.limber_integral(ells, zs, ks, Pmm, gzs, Wa, Wb, hzs, chis)

    gg = proj(WL1, WL2)
    gi = proj(WL1, WI2) + proj(WL2, WI1)
    ii = proj(WI1, WI2)
    return {"GG": gg, "GI": gi, "II": ii, "total": gg + gi + ii}


def C_gg_mag(bg, ells, zs, ks, Pgg, Pgm, Pmm, gzs, gdndz, s_mag,
             gdndz2=None, s_mag2=None):
    """Galaxy clustering with lens magnification, C^obs_gg = C^gg +
    C^{g mu} + C^{mu g} + C^{mu mu}: {'gg', 'gmu', 'mumu', 'total'}, Pgm
    in the cross terms and Pmm in mu-mu."""
    gzs = _t(bg, gzs)
    chis, hzs = _chis_hzs(bg, gzs)
    Wg1 = _normed(bg, gdndz, gzs)
    Wm1 = magnification_window(bg, gzs, gzs, gdndz, s_mag)
    if gdndz2 is None:
        Wg2, Wm2 = Wg1, Wm1
    else:
        s2 = s_mag if s_mag2 is None else s_mag2
        Wg2 = _normed(bg, gdndz2, gzs)
        Wm2 = magnification_window(bg, gzs, gzs, gdndz2, s2)

    def proj(P, Wa, Wb):
        return limb.limber_integral(ells, zs, ks, P, gzs, Wa, Wb, hzs, chis)

    gg = proj(Pgg, Wg1, Wg2)
    gmu = proj(Pgm, Wg1, Wm2) + proj(Pgm, Wg2, Wm1)
    mumu = proj(Pmm, Wm1, Wm2)
    return {"gg": gg, "gmu": gmu, "mumu": mumu, "total": gg + gmu + mumu}


def C_kg_mag(bg, ells, zs, ks, Pgm, Pmm, gzs, gdndz, s_mag,
             lzs=None, ldndz=None, lwindow=None):
    """Lensing x galaxies with the lens-magnification term, C^obs_kg =
    C^{kappa g} + C^{kappa mu}: {'kg', 'kmu', 'total'}."""
    gzs = _t(bg, gzs)
    chis, hzs = _chis_hzs(bg, gzs)
    WL = (limb.lensing_window(bg, gzs, lzs, ldndz)
          if lwindow is None else lwindow)
    Wg = _normed(bg, gdndz, gzs)
    Wm = magnification_window(bg, gzs, gzs, gdndz, s_mag)
    kg = limb.limber_integral(ells, zs, ks, Pgm, gzs, WL, Wg, hzs, chis)
    kmu = limb.limber_integral(ells, zs, ks, Pmm, gzs, WL, Wm, hzs, chis)
    return {"kg": kg, "kmu": kmu, "total": kg + kmu}
