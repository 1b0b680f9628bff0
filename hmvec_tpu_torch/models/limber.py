"""Limber projections P(k, z) -> C(ell) and lensing windows on float64
tensors (port of hmvec_tpu/models/limber.py).

The (ell, z) evaluation grid is one searchsorted + gather + lerp over the
whole C(ell) table, and the z integral is a trapezoid sum.  Redshift and
multipole grids may be numpy arrays, Python numbers or tensors; they are
carried to the background's device.  Every function runs under
``torch.func.vmap`` over the background (``pipeline.make_batched_fn``).
"""

from __future__ import annotations

import torch

from ..ops.quadrature import lerp_index, trapz
from ..utils.weights import on_device_of_inputs, tensor_or_f64
from . import background as bgmod


def _t(bg, x):
    """x as a float64 tensor on the background's device."""
    return torch.as_tensor(x, dtype=torch.float64, device=bg.H0.device)


def lensing_window(bg, ezs, zs, dndz=None):
    """W_kappa(ezs) for a delta-function source (zs a scalar) or a source
    distribution dndz on zs."""
    ezs = _t(bg, ezs)
    zs = torch.atleast_1d(_t(bg, zs))
    H0 = bgmod.h_of_z(bg, 0.0)
    H = bgmod.h_of_z(bg, ezs)
    chis = bgmod.comoving_radial_distance(bg, ezs)
    chistar = bgmod.comoving_radial_distance(bg, zs)
    if zs.numel() == 1:
        integral = (chistar - chis) / chistar
        integral = torch.where(ezs > zs[0], 0.0, integral)
    else:
        dndz = _t(bg, dndz)
        dndzn = dndz / trapz(dndz, zs)
        integrand = ((chistar[None, :] - chis[:, None]) / chistar[None, :]
                     * dndzn[None, :])
        integrand = torch.where(zs[None, :] < ezs[:, None], 0.0, integrand)
        integral = trapz(integrand, zs, axis=-1)
    return 1.5 * bg.omm0 * H0**2 * (1.0 + ezs) * chis / H * integral


def interp_pzk_at_curve(zs, ks, Pzks, zevals, kevals):
    """P(zevals, kevals[l, z]) by bilinear interpolation in (z, ln k).

    zs (nz,), ks (nk,), Pzks (nz, nk); zevals (nze,); kevals (nl, nze):
    tensors on one device.  Returns (nl, nze).  Outside the table the
    nearest edge value is taken, in z and in k.
    """
    lks = torch.log(ks)
    lke = torch.log(kevals)

    if zs.numel() > 1:
        iz, tz = lerp_index(zs, zevals)
        Pz = (Pzks[iz] * (1.0 - tz)[:, None]
              + Pzks[iz + 1] * tz[:, None])        # (nze, nk)
    else:
        Pz = Pzks[0][None, :].expand(zevals.shape[0], lks.numel())

    ik, tk = lerp_index(lks, lke)
    # Pz[z, ik[l, z]] as a gather along k of Pz^T (nk, nze)
    p0 = torch.gather(Pz.T, 0, ik)
    p1 = torch.gather(Pz.T, 0, ik + 1)
    return p0 + tk * (p1 - p0)


@on_device_of_inputs
def limber_integral(ells, zs, ks, Pzks, gzs, Wz1s, Wz2s, hzs, chis):
    """C(ell) = int dz (H/c) W1 W2 P(z, k = (ell + 0.5) / chi) / chi^2,
    for all ells at once.  Wz1s, Wz2s, hzs, chis broadcast to gzs."""
    Pzks = tensor_or_f64(Pzks)
    dev = Pzks.device
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    ells = as_t(ells)
    gzs = torch.atleast_1d(as_t(gzs))
    hzs, Wz1s, Wz2s, chis = (as_t(x).expand(gzs.shape)
                             for x in (hzs, Wz1s, Wz2s, chis))

    prefactor = hzs * Wz1s * Wz2s / chis**2          # (nz,)
    kevals = (ells[:, None] + 0.5) / chis[None, :]   # (nl, nz)
    Pvals = interp_pzk_at_curve(torch.atleast_1d(as_t(zs)), as_t(ks),
                                torch.atleast_2d(Pzks), gzs, kevals)
    if gzs.numel() == 1:
        return Pvals[:, 0] * prefactor[0]
    return trapz(Pvals * prefactor[None, :], gzs, axis=-1)


def C_kk(bg, ells, zs, ks, Pmm, lzs1=None, ldndz1=None, lzs2=None,
         ldndz2=None, lwindow1=None, lwindow2=None):
    """CMB or galaxy lensing convergence auto-spectrum."""
    zs = _t(bg, zs)
    if lwindow1 is None:
        lwindow1 = lensing_window(bg, zs, lzs1, ldndz1)
    if lwindow2 is None:
        lwindow2 = lensing_window(bg, zs, lzs2, ldndz2)
    chis = bgmod.comoving_radial_distance(bg, zs)
    hzs = bgmod.h_of_z(bg, zs)
    return limber_integral(ells, zs, ks, Pmm, zs, lwindow1, lwindow2, hzs,
                           chis)


def C_kg(bg, ells, zs, ks, Pgm, gzs, gdndz=None, lzs=None, ldndz=None,
         lwindow=None):
    """Lensing x galaxy cross-spectrum."""
    gzs = torch.atleast_1d(_t(bg, gzs))
    Wz1s = lensing_window(bg, gzs, lzs, ldndz) if lwindow is None else lwindow
    chis = bgmod.comoving_radial_distance(bg, gzs)
    hzs = bgmod.h_of_z(bg, gzs)
    if gzs.numel() > 1:
        gdndz = _t(bg, gdndz)
        Wz2s = gdndz / trapz(gdndz, gzs)
    else:
        Wz2s = torch.ones_like(gzs)
    return limber_integral(ells, zs, ks, Pgm, gzs, Wz1s, Wz2s, hzs, chis)


def _galaxy_windows(bg, gzs, gdndz, zmin, zmax, hzs):
    if gzs.numel() > 1:
        gdndz = _t(bg, gdndz)
        W = gdndz / trapz(gdndz, gzs)
        return W, W
    dchi = (bgmod.comoving_radial_distance(bg, zmax)
            - bgmod.comoving_radial_distance(bg, zmin))
    return torch.ones_like(gzs), 1.0 / dchi / hzs


def C_gg(bg, ells, zs, ks, Pgg, gzs, gdndz=None, zmin=None, zmax=None):
    """Galaxy auto-spectrum."""
    gzs = torch.atleast_1d(_t(bg, gzs))
    chis = bgmod.comoving_radial_distance(bg, gzs)
    hzs = bgmod.h_of_z(bg, gzs)
    Wz1s, Wz2s = _galaxy_windows(bg, gzs, gdndz, zmin, zmax, hzs)
    return limber_integral(ells, zs, ks, Pgg, gzs, Wz1s, Wz2s, hzs, chis)


def C_gy(bg, ells, zs, ks, Pgp, gzs, gdndz=None, zmin=None, zmax=None):
    """Galaxy x tSZ-y cross-spectrum."""
    gzs = torch.atleast_1d(_t(bg, gzs))
    chis = bgmod.comoving_radial_distance(bg, gzs)
    hzs = bgmod.h_of_z(bg, gzs)
    _, Wz2s = _galaxy_windows(bg, gzs, gdndz, zmin, zmax, hzs)
    return limber_integral(ells, zs, ks, Pgp, gzs, 1.0, Wz2s, hzs, chis)


def C_ky(bg, ells, zs, ks, Pym, lzs1=None, ldndz1=None, lwindow1=None):
    """Lensing x tSZ-y cross-spectrum."""
    zs = _t(bg, zs)
    if lwindow1 is None:
        lwindow1 = lensing_window(bg, zs, lzs1, ldndz1)
    chis = bgmod.comoving_radial_distance(bg, zs)
    hzs = bgmod.h_of_z(bg, zs)
    return limber_integral(ells, zs, ks, Pym, zs, lwindow1, 1.0, hzs, chis)


def C_yy(bg, ells, zs, ks, Ppp):
    """tSZ-y auto-spectrum."""
    zs = _t(bg, zs)
    chis = bgmod.comoving_radial_distance(bg, zs)
    hzs = bgmod.h_of_z(bg, zs)
    return limber_integral(ells, zs, ks, Ppp, zs, 1.0, 1.0, hzs, chis)
