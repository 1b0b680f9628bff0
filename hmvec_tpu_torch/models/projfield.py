"""Projected-field kSZ^2 x LSS cross-correlation on float64 tensors (port
of hmvec_tpu/models/projfield.py).

Cross-correlating the square of a filtered CMB map with a tracer of large-
scale structure (Dore, Hennawi & Spergel 2004; Ferraro et al. 2016; Hill
et al. 2016).  For a filter f(l),

  C_l^{T_f^2 x g} = int d^2L/(2pi)^2 f(|L|) f(|l-L|) b(|L|, |l-L|, l)

with the projected (flat-sky Limber) hybrid bispectrum b_TTg: the two T
legs carry the kSZ radial kernel K(z) (models/ksz.ksz_radial_function) and
the linear-theory velocity rms, <(v delta_e)(v delta_e) delta_g> ~=
(vrms2/3) B_eeg, and the third leg the tracer's window; B_eeg is the
halo-model bispectrum of the registered profiles (models/bispectrum.py
through ``HaloModel.get_angular_bispectrum``).  The lensing contamination
term, the Gaussian noise of the squared map and the bandpower SNR are
here as well.

The (L, theta) filter convolution is one Gauss-Legendre log-radial x
angular tensor quadrature: every triangle of every output ell goes through
one bispectrum call (``ell_chunk`` splits the output ells across several
calls when the (nz, nm, n_triangles) leg tables would not fit).  Nothing
here launches a kernel of its own; the profiles it reads went through the
NFW and resample kernels when the HaloModel was built.

The free functions run by the package's device rule
(``utils.weights.on_device_of_inputs``); the functions of a HaloModel run
on its device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.quadrature import linear_interp, trapz_traced
from ..utils.weights import call_device, leggauss_cached, on_device_of_inputs
from .ksz import ksz_radial_function
from .limber import lensing_window

__all__ = ["filter_from_table", "filtered_bispectrum_cl",
           "bispectrum_ttg_lensing", "cl_t2_lensing", "cl_t2_t2_gaussian",
           "ksz2_snr", "vrms2_linear", "ksz_t_windows",
           "hybrid_bispectrum_ttg", "cl_ksz2_galaxy", "cl_ksz2_kappa"]

_F64 = torch.float64


def _f64(x):
    return torch.as_tensor(x, dtype=_F64, device=call_device())


# --------------------------------------------------------------- filters

@on_device_of_inputs
def filter_from_table(ells, fells):
    """Linear-interpolation filter callable from a sampled f(l) table;
    zero outside the table's support (the filter defines the analysis
    band)."""
    ells, fells = _f64(ells), _f64(fells)

    def f(l):
        l = torch.as_tensor(l, dtype=_F64, device=ells.device)
        val = linear_interp(l, ells, fells)
        return torch.where((l < ells[0]) | (l > ells[-1]), 0.0, val)

    return f


def _as_filter(f_ell):
    if callable(f_ell):
        return f_ell
    ells, fells = f_ell
    return filter_from_table(ells, fells)


def _table_support(f_ell, lmin, lmax):
    """lmin/lmax, each defaulting to the filter table's first/last l."""
    if lmin is None or lmax is None:
        if callable(f_ell):
            raise ValueError("lmin/lmax are required for a callable filter")
        grid = np.asarray(f_ell[0].cpu() if isinstance(f_ell[0],
                                                       torch.Tensor)
                          else f_ell[0], dtype=float)
        lmin = grid[0] if lmin is None else lmin
        lmax = grid[-1] if lmax is None else lmax
    return lmin, lmax


# ------------------------------------------------------- the convolution

@on_device_of_inputs
def filtered_bispectrum_cl(ells_out, f_ell, b_fn, lmin, lmax,
                           n_radial=48, n_angle=24, ell_chunk=None):
    """C(l) = int d^2L/(2pi)^2 f(|L|) f(|l-L|) b(|L|, |l-L|, l).

    ``f_ell``: callable l -> f(l), or a (grid, values) table (zero
    outside the table).  ``b_fn``: three equal-length 1-d multipole
    tensors (l1, l2, l3) -> the reduced bispectrum b(l1, l2, l3).
    ``lmin``/``lmax`` bound the |L| integral.  Quadrature: Gauss-Legendre
    in ln|L| on [ln lmin, ln lmax] (measure L^2 dlnL) x Gauss-Legendre in
    the angle on [0, pi], doubled by symmetry; all (n_out, n_radial,
    n_angle) triangles through one b_fn call, or ``ell_chunk`` output ells
    a call."""
    f = _as_filter(f_ell)
    dev = call_device()
    ells_out = torch.atleast_1d(torch.as_tensor(ells_out, dtype=_F64,
                                                device=dev))
    if ell_chunk is not None and ells_out.numel() > ell_chunk:
        return torch.cat([
            filtered_bispectrum_cl(ells_out[i:i + ell_chunk], f, b_fn,
                                   lmin, lmax, n_radial, n_angle)
            for i in range(0, ells_out.numel(), ell_chunk)])

    xr, wr = leggauss_cached(n_radial)
    la, lb = np.log(float(lmin)), np.log(float(lmax))
    lnL = 0.5 * (xr + 1.0) * (lb - la) + la
    wL = torch.as_tensor(wr * 0.5 * (lb - la), device=dev)
    L = torch.exp(torch.as_tensor(lnL, device=dev))          # (nr,)

    xa, wa = leggauss_cached(n_angle)
    theta = torch.as_tensor(0.5 * (xa + 1.0) * np.pi, device=dev)
    wth = torch.as_tensor(wa * 0.5 * np.pi, device=dev)

    lo = ells_out[:, None, None]                             # (no, 1, 1)
    shape = (ells_out.numel(), L.numel(), theta.numel())
    L1 = L[None, :, None].expand(shape)
    L2 = torch.sqrt(torch.clamp(
        lo**2 + L1**2 - 2.0 * lo * L1 * torch.cos(theta[None, None, :]),
        min=0.0))
    L3 = lo.expand(shape)

    b = b_fn(L1.reshape(-1), L2.reshape(-1), L3.reshape(-1))
    b = torch.as_tensor(b).reshape(shape)                    # (no, nr, na)

    integrand = f(L1) * f(L2) * b * L1**2                    # L^2 dlnL
    inner = torch.einsum("ora,a->or", integrand, wth)
    return 2.0 * torch.einsum("or,r->o", inner, wL) / (2.0 * math.pi) ** 2


# ------------------------------------------- lensing contamination term

def _cl_interp(l, grid, cl):
    """C(l) of an integer-l table by linear interpolation, 0 beyond it."""
    return linear_interp(torch.as_tensor(l, dtype=_F64, device=cl.device),
                         grid, cl, right=0.0)


@on_device_of_inputs
def bispectrum_ttg_lensing(cl_tt, cl_xg):
    """b_fn of the CMB-lensing contribution to <T_f^2 x g> (first-order
    lensing of T; Ferraro et al. 2016 sec. III), in this module's
    triangle convention v3 = v1 + v2:

      b(l1,l2,l3) = [ (l3^2 + l1^2 - l2^2)/2 C^TT(l1)
                    + (l3^2 + l2^2 - l1^2)/2 C^TT(l2) ] C^{phi g}(l3).

    ``cl_tt``/``cl_xg``: integer-l tables (C^{phi g} = C^{phi phi} for
    g = phi)."""
    cl_tt, cl_xg = _f64(cl_tt), _f64(cl_xg)
    grid_t = torch.arange(cl_tt.shape[0], dtype=_F64, device=cl_tt.device)
    grid_x = torch.arange(cl_xg.shape[0], dtype=_F64, device=cl_xg.device)

    def b_fn(l1, l2, l3):
        l1, l2, l3 = (torch.as_tensor(l, dtype=_F64, device=cl_tt.device)
                      for l in (l1, l2, l3))
        ct1 = _cl_interp(l1, grid_t, cl_tt)
        ct2 = _cl_interp(l2, grid_t, cl_tt)
        cx3 = _cl_interp(l3, grid_x, cl_xg)
        d31 = 0.5 * (l3**2 + l1**2 - l2**2)
        d32 = 0.5 * (l3**2 + l2**2 - l1**2)
        return (d31 * ct1 + d32 * ct2) * cx3

    return b_fn


@on_device_of_inputs
def cl_t2_lensing(ells_out, f_ell, cl_tt, cl_xg, lmin, lmax,
                  n_radial=64, n_angle=48):
    """Lensing contribution to C_l^{T_f^2 x g}: the filtered_bispectrum_cl
    convolution of bispectrum_ttg_lensing."""
    return filtered_bispectrum_cl(ells_out, f_ell,
                                  bispectrum_ttg_lensing(cl_tt, cl_xg),
                                  lmin, lmax, n_radial=n_radial,
                                  n_angle=n_angle)


# ------------------------------------------------- estimator noise / SNR

@on_device_of_inputs
def cl_t2_t2_gaussian(ells_out, f_ell, cl_total, lmin, lmax,
                      n_radial=64, n_angle=48):
    """Gaussian auto-spectrum of the mean-subtracted filtered-squared map,

      C^{ss}(l) = 2 int d^2L/(2pi)^2 [f^2 C^tot](|L|) [f^2 C^tot](|l-L|),

    the noise spectrum of the projected-field estimator; ``cl_total`` an
    integer-l table of the total map spectrum."""
    f = _as_filter(f_ell)
    cl_total = _f64(cl_total)
    grid = torch.arange(cl_total.shape[0], dtype=_F64,
                        device=cl_total.device)

    def f2(l):
        return f(l) ** 2

    def b_fn(l1, l2, l3):
        return 2.0 * _cl_interp(l1, grid, cl_total) \
            * _cl_interp(l2, grid, cl_total)

    return filtered_bispectrum_cl(ells_out, f2, b_fn, lmin, lmax,
                                  n_radial=n_radial, n_angle=n_angle)


@on_device_of_inputs
def ksz2_snr(ells, cl_sg, cl_ss, cl_gg, fsky, delta_ell=None):
    """Gaussian bandpower SNR of a projected-field cross-spectrum:

      SNR^2 = sum_b (C^{sg}_b)^2 (2 l_b + 1) dl_b fsky
                    / (C^{ss}_b C^{gg}_b + (C^{sg}_b)^2),

    delta_ell defaulting to the centers' spacing; cl_gg with shot noise.
    Returns (per-band SNR^2, total SNR)."""
    ells = _f64(ells)
    if delta_ell is None:
        e = torch.cat([ells[:1], ells, ells[-1:]])
        delta_ell = 0.5 * (e[2:] - e[:-2])
    cl_sg = _f64(cl_sg)
    var = _f64(cl_ss) * _f64(cl_gg) + cl_sg**2
    snr2 = cl_sg**2 / var * (2.0 * ells + 1.0) * _f64(delta_ell) * fsky
    return snr2, torch.sqrt(torch.sum(snr2))


# ------------------------------------------------------ the kSZ assembly

def vrms2_linear(hm, zs=None, kLs=None):
    """<(v/c)^2>(z) = int dkL (f a H / kL)^2 P_mm^lin(kL, z) kL^2/(2pi^2),
    the linear-theory velocity variance of the Ma & Fry squeezed kSZ
    auto path, on the HaloModel's device."""
    zs = hm.zs if zs is None else zs
    zs = torch.atleast_1d(hm._t(zs))
    if kLs is None:
        kLs = np.geomspace(1e-4, 3.0, 200)
    kLs = hm._t(kLs)
    p = hm.P_lin_slow(kLs, zs)                               # (nz, nkL)
    faH = hm.get_growth_rate_f(zs) / (1.0 + zs) * hm.h_of_z(zs)
    integrand = p * faH[:, None] ** 2                        # (faH/k)^2 k^2 P
    return trapz_traced(integrand, kLs, axis=-1) / (2.0 * math.pi**2)


def ksz_t_windows(hm, zs=None, gdndz=None, xe=1, tau=0, gasfrac=0.9,
                  vrms2=None):
    """Per-z windows of the two kSZ temperature legs and the galaxy leg in
    the projected_bispectrum convention: W_T = sqrt(vrms2/3) K(z)/H(z),
    W_g = dndz / int dndz dz (None: uniform in z).  Returns (W_T, W_g,
    zs)."""
    zs = hm.zs if zs is None else zs
    zs = torch.atleast_1d(hm._t(zs))
    if zs.numel() < 2:
        raise ValueError("the projected hybrid bispectrum integrates over "
                         "z: build the HaloModel with >= 2 redshifts")
    if vrms2 is None:
        vrms2 = vrms2_linear(hm, zs)
    K = ksz_radial_function(zs, hm.ombh2, hm.YHe, gasfrac=gasfrac, xe=xe,
                            tau=tau, params=hm.p)
    W_T = torch.sqrt(hm._t(vrms2) / 3.0) * K / hm.h_of_z(zs)
    if gdndz is None:
        W_g = torch.ones_like(zs)
        W_g = W_g / trapz_traced(W_g, zs)
    else:
        gdndz = hm._t(gdndz)
        W_g = gdndz / trapz_traced(gdndz, zs)
    return W_T, W_g, zs


def hybrid_bispectrum_ttg(hm, ells1, ells2, ells3, gdndz=None,
                          name_e="e", name_g="g", terms="total",
                          xe=1, tau=0, gasfrac=0.9, vrms2=None):
    """Projected hybrid bispectrum b_TTg(l1, l2, l3) in uK^2: the two T
    legs carry the kSZ radial kernel and the large-scale velocity rms, the
    third the normalized galaxy dndz; B_eeg of the registered electron and
    HOD tracers."""
    W_T, W_g, _ = ksz_t_windows(hm, None, gdndz, xe, tau, gasfrac, vrms2)
    return hm.get_angular_bispectrum(ells1, ells2, ells3, name=name_e,
                                     name2=name_e, name3=name_g,
                                     Wz1s=W_T, Wz2s=W_T, Wz3s=W_g,
                                     terms=terms)


def cl_ksz2_galaxy(hm, ells_out, f_ell, lmin=None, lmax=None, gdndz=None,
                   name_e="e", name_g="g", terms="total", xe=1, tau=0,
                   gasfrac=0.9, vrms2=None, n_radial=48, n_angle=24,
                   ell_chunk=None):
    """Projected-field kSZ^2 x galaxy cross power C_l^{T_f^2 g} in uK^2.

    ``hm``: a HaloModel with an electron profile ``name_e`` and an HOD
    ``name_g``; ``f_ell`` the map filter (callable, or a (grid, values)
    table whose support gives the lmin/lmax defaults); ``gdndz`` the
    galaxy dndz on hm.zs (None: uniform); ``vrms2`` overrides the linear
    <v^2>(z).  Returns (n_ell,) on the HaloModel's device."""
    lmin, lmax = _table_support(f_ell, lmin, lmax)
    W_T, W_g, _ = ksz_t_windows(hm, None, gdndz, xe, tau, gasfrac, vrms2)

    def b_fn(l1, l2, l3):
        return hm.get_angular_bispectrum(l1, l2, l3, name=name_e,
                                         name2=name_e, name3=name_g,
                                         Wz1s=W_T, Wz2s=W_T, Wz3s=W_g,
                                         terms=terms)

    return filtered_bispectrum_cl(ells_out, f_ell, b_fn, lmin, lmax,
                                  n_radial=n_radial, n_angle=n_angle,
                                  ell_chunk=ell_chunk, device=hm.device)


def cl_ksz2_kappa(hm, ells_out, f_ell, lmin=None, lmax=None,
                  zstar=1089.0, name_e="e", name_matter="nfw",
                  terms="total", xe=1, tau=0, gasfrac=0.9, vrms2=None,
                  n_radial=48, n_angle=24, ell_chunk=None):
    """Projected-field kSZ^2 x CMB-lensing-convergence cross power
    C_l^{T_f^2 kappa} in uK^2: the third leg is the matter tracer
    ``name_matter`` through the CMB lensing window W_kappa(z -> zstar),
    on the HaloModel's zs grid."""
    lmin, lmax = _table_support(f_ell, lmin, lmax)
    W_T, _, zs = ksz_t_windows(hm, None, None, xe, tau, gasfrac, vrms2)
    W_k = lensing_window(hm.bg, zs, zstar)

    def b_fn(l1, l2, l3):
        return hm.get_angular_bispectrum(l1, l2, l3, name=name_e,
                                         name2=name_e, name3=name_matter,
                                         Wz1s=W_T, Wz2s=W_T, Wz3s=W_k,
                                         terms=terms)

    return filtered_bispectrum_cl(ells_out, f_ell, b_fn, lmin, lmax,
                                  n_radial=n_radial, n_angle=n_angle,
                                  ell_chunk=ell_chunk, device=hm.device)
