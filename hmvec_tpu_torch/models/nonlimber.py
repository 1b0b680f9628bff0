"""Exact (non-Limber) angular power spectra of linear-theory tracers on
float64 tensors (port of hmvec_tpu/models/nonlimber.py).

With separable growth,

    C_l^{XY} = (2/pi) int dk k^2 P_lin(k, 0) Delta_l^X(k) Delta_l^Y(k),

    Delta_l(k)       = int dchi W(chi) D(chi) j_l(k chi)         (density)
    Delta_l^RSD(k)   = -int dchi W(chi) f(chi) D(chi) j_l''(k chi)
    Delta_l^kappa(k) = [l(l+1)/k^2] int dchi phi_kappa(chi) j_l(k chi).

W D / chi^2 is sampled on a static log-uniform chi grid and every l is
projected at once by ``ops.fftlog.fftlog_sphbessel_multi`` (one rfft, one
(nl, n/2+1) complex multiply, one batched irfft); j_l'' and j_l / x^2 are
three-term recurrences over the {l-2, l, l+2} transforms, which share one
output k grid.  The k integral is a trapezoid in ln k.  The hybrid
spectra add the Limber projection of a full nonlinear P(z, k)
(``models.limber``) to the exact-minus-Limber correction of its separable
linear part.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.fftlog import fftlog_lnkr, fftlog_sphbessel_multi
from ..ops.quadrature import linear_interp, trapz_traced
from ..utils.weights import f64, on_device, on_device_of_inputs, tensor_or_f64
from . import background as bgmod

__all__ = [
    "chi_loggrid", "bessel_deltas", "bessel_deltas_j2pp",
    "bessel_deltas_over_x2", "galaxy_kernel", "lensing_kernel",
    "cl_from_deltas",
    "C_gg_exact", "C_kg_exact", "C_kk_exact",
    "C_gg_hybrid", "C_kk_hybrid",
]


def _t(bg, x):
    return f64(x, bg.H0.device)


def chi_loggrid(chi_min: float = 0.5, chi_max: float = 15000.0,
                n: int = 2048) -> np.ndarray:
    """Static (host) log-uniform comoving-distance grid [Mpc]: z ~ 0 -> 20,
    and a reciprocal FFTLog k grid of ~[7e-5, 2] 1/Mpc."""
    return np.geomspace(chi_min, chi_max, n)


def _edge_taper(n: int, frac: float) -> np.ndarray:
    """Cosine taper to 0 at both ends over a ``frac`` fraction of the log
    grid (host, static), against FFTLog wrap-around from kernels that do
    not decay at the grid's edges."""
    m = max(int(round(frac * n)), 1)
    ramp = 0.5 * (1.0 - np.cos(np.pi * np.arange(m) / m))
    t = np.ones(n)
    t[:m] *= ramp
    t[n - m:] *= ramp[::-1]
    return t


@on_device_of_inputs
def bessel_deltas(phi, chis, ells, taper_frac: float = 0.03):
    """Delta_l(k) = int dchi phi(chi) j_l(k chi) for every l of ``ells``:
    phi (..., n) on the log-uniform numpy grid chis (n,).  Returns
    (ks (n,), Delta (..., nl, n)) on the reciprocal FFTLog grid."""
    phi = tensor_or_f64(phi)
    chis = np.asarray(chis, dtype=np.float64)
    (taper,) = on_device(
        f"nonlimber_taper:{chis.size}:{chis[0]!r}:{chis[-1]!r}:{taper_frac!r}",
        phi.device, lambda: (_edge_taper(chis.size, taper_frac) / chis**2,))
    lnkr = fftlog_lnkr(chis, mu=0.5)
    return fftlog_sphbessel_multi(phi * taper, chis,
                                  tuple(int(l) for l in ells), lnkr=lnkr)


def _jpp_coeffs(l: int):
    """j_l'' = c_m j_{l-2} - c_0 j_l + c_p j_{l+2} (exact recurrence)."""
    cm = l * (l - 1.0) / ((2.0 * l + 1.0) * (2.0 * l - 1.0))
    c0 = (l**2 / ((2.0 * l + 1.0) * (2.0 * l - 1.0))
          + (l + 1.0) ** 2 / ((2.0 * l + 1.0) * (2.0 * l + 3.0)))
    cp = (l + 1.0) * (l + 2.0) / ((2.0 * l + 1.0) * (2.0 * l + 3.0))
    return cm, c0, cp


def _union_deltas(phi, chis, ells, taper_frac):
    """The transforms of every l - 2, l, l + 2 (l - 2 floored at 0) and
    the row of each multipole among them."""
    union = sorted({ln for l in ells for ln in (max(l - 2, 0), l, l + 2)})
    ks, F = bessel_deltas(phi, chis, union, taper_frac)
    return ks, F, {l: i for i, l in enumerate(union)}


@on_device_of_inputs
def bessel_deltas_j2pp(phi, chis, ells, taper_frac: float = 0.03):
    """Delta_l^{(2)}(k) = -int dchi phi(chi) j_l''(k chi), the RSD row,
    by the j_l'' recurrence over the {l-2, l, l+2} transforms (for l in
    {0, 1} the l - 2 leg's coefficient is 0)."""
    ells = [int(l) for l in ells]
    ks, F, idx = _union_deltas(phi, chis, ells, taper_frac)
    rows = []
    for l in ells:
        cm, c0, cp = _jpp_coeffs(l)
        rows.append(-(cm * F[..., idx[max(l - 2, 0)], :]
                      - c0 * F[..., idx[l], :]
                      + cp * F[..., idx[l + 2], :]))
    return ks, torch.stack(rows, dim=-2)


@on_device_of_inputs
def bessel_deltas_over_x2(phi_t, chis, ells, taper_frac: float = 0.03):
    """int dchi phi_t(chi) j_l(k chi) / (k chi)^2, the lensing row, by

        j_l(x)/x^2 = [(j_{l-2} + j_l)/(2l-1) + (j_l + j_{l+2})/(2l+3)]/(2l+1)

    over plain transforms of phi_t (an exact identity, which keeps the
    FFTLog noise floor from being multiplied by 1/k^2).  Requires every
    l >= 2: the recurrence needs the j_{l-2} leg (ValueError otherwise)."""
    ells = [int(l) for l in ells]
    if min(ells) < 2:
        raise ValueError(
            f"bessel_deltas_over_x2 requires all ells >= 2 (got min "
            f"{min(ells)}): the j_l/x^2 recurrence needs the j_(l-2) leg")
    ks, F, idx = _union_deltas(phi_t, chis, ells, taper_frac)
    rows = []
    for l in ells:
        fm = F[..., idx[max(l - 2, 0)], :]
        f0 = F[..., idx[l], :]
        fp = F[..., idx[l + 2], :]
        rows.append(((fm + f0) / (2.0 * l - 1.0)
                     + (f0 + fp) / (2.0 * l + 3.0)) / (2.0 * l + 1.0))
    return ks, torch.stack(rows, dim=-2)


def _growth_ratio(bg, zg, growth_mode: str, table=None):
    """D(z)/D(0) (independent of the normalization)."""
    if growth_mode == "ode" and table is None:
        table = bgmod.growth_table(bg)
    zg = _t(bg, zg)
    d = bgmod.growth_unnormalized(bg, 1.0 / (1.0 + zg), mode=growth_mode,
                                  table=table)
    d0 = bgmod.growth_unnormalized(bg, _t(bg, 1.0), mode=growth_mode,
                                   table=table)
    return d / d0


def galaxy_kernel(bg, chis, gzs, gdndz, bias=1.0, growth_mode: str = "closed",
                  table=None, with_growth_rate: bool = False):
    """phi_g(chi) = b n(z(chi)) H(z) D(z)/D(0) on the static chi grid, with
    n(z) normalized to unit integral over gzs and 0 outside it.
    ``with_growth_rate=True`` multiplies by f(z) instead of the bias (the
    RSD kernel)."""
    chis_t = _t(bg, chis)
    zg = bgmod.redshift_at_comoving_radial_distance(bg, chis_t)
    gzs = _t(bg, gzs)
    dndz = _t(bg, gdndz)
    nz = linear_interp(zg, gzs, dndz / trapz_traced(dndz, gzs),
                       left=0.0, right=0.0)
    H = bgmod.h_of_z(bg, zg)
    D = _growth_ratio(bg, zg, growth_mode, table)
    out = nz * H * D
    if with_growth_rate:
        f = bgmod.growth_rate_f(bg, zg, mode=growth_mode, table=table)
        return out * f
    return bias * out


def lensing_kernel(bg, chis, zs=None, dndz=None, growth_mode: str = "closed",
                   table=None):
    """phi_kappa(chi) = 1.5 Om_m H0^2 (1+z) D(chi) q(chi)/chi, with
    q = (chi_s - chi)/chi_s for one source plane (zs a scalar) or its
    dndz-weighted average over the sources (zs an array).  The
    l(l+1)/k^2 transfer is applied by the C_l assemblers."""
    chis_t = _t(bg, chis)
    zg = bgmod.redshift_at_comoving_radial_distance(bg, chis_t)
    zs = torch.atleast_1d(_t(bg, zs))
    chistar = bgmod.comoving_radial_distance(bg, zs)
    if zs.numel() == 1:
        q = torch.where(zg <= zs[0], (chistar[0] - chis_t) / chistar[0], 0.0)
    else:
        dndz = _t(bg, dndz)
        nzn = dndz / trapz_traced(dndz, zs)
        integ = ((chistar[None, :] - chis_t[:, None]) / chistar[None, :]
                 * nzn[None, :])
        integ = torch.where(zs[None, :] < zg[:, None], 0.0, integ)
        q = trapz_traced(integ, zs, axis=-1)
    H0 = bgmod.h_of_z(bg, 0.0)
    D = _growth_ratio(bg, zg, growth_mode, table)
    return 1.5 * bg.omm0 * H0**2 * (1.0 + zg) * D * q / chis_t


def _lnp_on_grid(ks_grid, ks_pk, pk0):
    """ln P interpolated in ln k, extrapolated as a power law beyond the
    table (a left-sided search with an unclipped weight)."""
    lnks = torch.log(ks_pk)
    lnp = torch.log(pk0)
    lnk = torch.log(ks_grid)
    i = (torch.searchsorted(lnks, lnk) - 1).clamp(0, lnks.numel() - 2)
    t = (lnk - lnks[i]) / (lnks[i + 1] - lnks[i])
    return lnp[i] + t * (lnp[i + 1] - lnp[i])


def cl_from_deltas(ks_grid, d1, d2, ks_pk, pk0):
    """C_l = (2/pi) int dln k k^3 P(k, 0) Delta1_l(k) Delta2_l(k) on the
    log-uniform FFTLog grid ks_grid (nk,); d1, d2 (..., nl, nk)."""
    dev = d1.device
    ks_grid = f64(ks_grid, dev)
    P = torch.exp(_lnp_on_grid(ks_grid, f64(ks_pk, dev), f64(pk0, dev)))
    integ = ks_grid**3 * P * d1 * d2
    return (2.0 / math.pi) * trapz_traced(integ, torch.log(ks_grid), axis=-1)


def _kappa_deltas(bg, chis, ells_t, zs, dndz, growth_mode, table):
    """Delta_l^kappa(k) = l(l+1) int dchi [phi_kappa chi^2] j_l/(k chi)^2."""
    phik = lensing_kernel(bg, chis, zs=zs, dndz=dndz,
                          growth_mode=growth_mode, table=table)
    ks, d = bessel_deltas_over_x2(phik * _t(bg, chis) ** 2, chis, ells_t)
    llp1 = _t(bg, [l * (l + 1.0) for l in ells_t])
    return ks, llp1[:, None] * d


def _ells(ells):
    return tuple(int(l) for l in np.asarray(ells))


def _table(bg, growth_mode, table):
    if growth_mode == "ode" and table is None:
        return bgmod.growth_table(bg)
    return table


def C_gg_exact(bg, ells, ks, pk0, gzs, gdndz, bias=1.0, rsd: bool = False,
               smag=None, szs=None, growth_mode: str = "closed",
               chis=None, table=None):
    """Exact linear galaxy auto-spectrum on P_lin(k, 0) = pk0 on ks.
    ``rsd=True`` adds the Kaiser term (-j_l''); ``smag`` adds the
    magnification term (5 smag - 2) Delta^kappa with the galaxies' own
    dndz as sources (on ``szs`` if given, else gzs)."""
    if chis is None:
        chis = chi_loggrid()
    table = _table(bg, growth_mode, table)
    phi = galaxy_kernel(bg, chis, gzs, gdndz, bias, growth_mode, table)
    ells_t = _ells(ells)
    ksg, d = bessel_deltas(phi, chis, ells_t)
    if rsd:
        phif = galaxy_kernel(bg, chis, gzs, gdndz, 1.0, growth_mode, table,
                             with_growth_rate=True)
        _, drsd = bessel_deltas_j2pp(phif, chis, ells_t)
        d = d + drsd
    if smag is not None:
        _, dk = _kappa_deltas(bg, chis, ells_t,
                              gzs if szs is None else szs, gdndz,
                              growth_mode, table)
        d = d + (5.0 * smag - 2.0) * dk
    return cl_from_deltas(ksg, d, d, ks, pk0)


def C_kg_exact(bg, ells, ks, pk0, gzs, gdndz, bias=1.0, lzs=None, ldndz=None,
               rsd: bool = False, growth_mode: str = "closed", chis=None,
               table=None):
    """Exact linear lensing x galaxy cross-spectrum."""
    if chis is None:
        chis = chi_loggrid()
    table = _table(bg, growth_mode, table)
    ells_t = _ells(ells)
    phig = galaxy_kernel(bg, chis, gzs, gdndz, bias, growth_mode, table)
    ksg, dg = bessel_deltas(phig, chis, ells_t)
    if rsd:
        phif = galaxy_kernel(bg, chis, gzs, gdndz, 1.0, growth_mode, table,
                             with_growth_rate=True)
        _, drsd = bessel_deltas_j2pp(phif, chis, ells_t)
        dg = dg + drsd
    _, dk = _kappa_deltas(bg, chis, ells_t, lzs, ldndz, growth_mode, table)
    return cl_from_deltas(ksg, dk, dg, ks, pk0)


def C_kk_exact(bg, ells, ks, pk0, lzs1=None, ldndz1=None, lzs2=None,
               ldndz2=None, growth_mode: str = "closed", chis=None,
               table=None):
    """Exact linear convergence auto/cross-spectrum, with the full
    l(l+1)/k^2 transfer."""
    if chis is None:
        chis = chi_loggrid()
    table = _table(bg, growth_mode, table)
    ells_t = _ells(ells)
    ksg, d1 = _kappa_deltas(bg, chis, ells_t, lzs1, ldndz1, growth_mode, table)
    if lzs2 is None and ldndz2 is None:
        d2 = d1
    else:
        _, d2 = _kappa_deltas(bg, chis, ells_t, lzs2, ldndz2, growth_mode,
                              table)
    return cl_from_deltas(ksg, d1, d2, ks, pk0)


# Hybrid exact + Limber:
#   C_hybrid = C_Limber[P_full] + (C_exact[P_lin sep] - C_Limber[P_lin sep])

def _sep_pzk(bg, zs_nl, ks, pk0, growth_mode, table, bias=1.0):
    """bias^2 D(z)^2 pk0(k) on the Limber grid (the separable twin of the
    full nonlinear P fed to the Limber term)."""
    D = _growth_ratio(bg, zs_nl, growth_mode, table)
    return (bias**2 * D[:, None] ** 2) * _t(bg, pk0)[None, :]


def C_gg_hybrid(bg, ells, ks, pk0, zs_nl, pzk_nl, gzs, gdndz, bias=1.0,
                rsd: bool = False, smag=None, szs=None,
                growth_mode: str = "closed", chis=None, table=None,
                zmin=None, zmax=None):
    """Galaxy auto-spectrum: the Limber projection of the full (already
    biased) P_gg ``pzk_nl`` on (zs_nl, ks) plus the exact-minus-Limber
    correction of b^2 D^2 pk0, with RSD and magnification in the exact
    part only."""
    from . import limber as lim
    table = _table(bg, growth_mode, table)
    cl_nl = lim.C_gg(bg, ells, zs_nl, ks, pzk_nl, gzs, gdndz,
                     zmin=zmin, zmax=zmax)
    pzk_sep = _sep_pzk(bg, zs_nl, ks, pk0, growth_mode, table, bias)
    cl_lin_limber = lim.C_gg(bg, ells, zs_nl, ks, pzk_sep, gzs, gdndz,
                             zmin=zmin, zmax=zmax)
    cl_lin_exact = C_gg_exact(bg, ells, ks, pk0, gzs, gdndz, bias=bias,
                              rsd=rsd, smag=smag, szs=szs,
                              growth_mode=growth_mode, chis=chis,
                              table=table)
    return cl_nl + (cl_lin_exact - cl_lin_limber)


def C_kk_hybrid(bg, ells, ks, pk0, zs_nl, pzk_nl, lzs1=None, ldndz1=None,
                lzs2=None, ldndz2=None, growth_mode: str = "closed",
                chis=None, table=None):
    """Convergence spectrum: the Limber projection of the full P_mm
    ``pzk_nl`` plus the exact-minus-Limber correction of D^2 pk0."""
    from . import limber as lim
    table = _table(bg, growth_mode, table)
    cl_nl = lim.C_kk(bg, ells, zs_nl, ks, pzk_nl, lzs1=lzs1, ldndz1=ldndz1,
                     lzs2=lzs2, ldndz2=ldndz2)
    pzk_sep = _sep_pzk(bg, zs_nl, ks, pk0, growth_mode, table)
    cl_lin_limber = lim.C_kk(bg, ells, zs_nl, ks, pzk_sep, lzs1=lzs1,
                             ldndz1=ldndz1, lzs2=lzs2, ldndz2=ldndz2)
    cl_lin_exact = C_kk_exact(bg, ells, ks, pk0, lzs1=lzs1, ldndz1=ldndz1,
                              lzs2=lzs2, ldndz2=ldndz2,
                              growth_mode=growth_mode, chis=chis,
                              table=table)
    return cl_nl + (cl_lin_exact - cl_lin_limber)
