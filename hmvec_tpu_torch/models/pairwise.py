"""Mean pairwise kSZ forecasts on float64 tensors (port of
hmvec_tpu/models/pairwise.py):

    T_pkSZ(r) = - (T_CMB / c) tau_bar v12(r)   [> 0 for infall],

from the Battaglia 2016 gas profile that the class Fourier-transforms for
Pee:

- ``tau_aperture_battaglia``: the mean Thomson optical depth of a halo in
  a disk of physical radius R_ap, tau_bar = sigma_T N_e,cyl / (pi R_ap^2),
  the cylinder count one radial quadrature per (z, m) with the closed-form
  fraction w(r) of a shell that projects inside the aperture;
- the bias-weighted linear v12(r) (``rsd.mean_pairwise_velocity``);
- pair-count errors N_pair = 2 pi nbar^2 V r^2 dr (1 + b^2 xi),
  sigma_bin = sqrt(2 / N_pair) sigma_meas.

Every quadrature is fixed-node Gauss-Legendre on the (nz, nm, n_x) grid,
with a double ``where`` on the square roots at the aperture edge, so
gradients stay finite.  Separations r are comoving Mpc; the aperture and
profile radii are physical Mpc (``theta_arcmin`` gives R_ap = theta
d_A(z)).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.fftlog import correlation_function
from ..ops.quadrature import linear_interp
from ..params import default_params
from ..utils.weights import (leggauss_cached, on_device, on_device_of_inputs,
                             tensor_or_f64)
from . import profiles as prof

_F64 = torch.float64

# the constants of models/ksz.py
_SIGMA_T_SI = 6.6524e-29          # Thomson cross-section, m^2
_M_PROTON_SI = 1.673e-27          # kg
_MSUN_KG = 1.989e30
_METER_TO_MPC = 3.241e-23
_C_KM_S = 299792.458
_XH = 0.76                        # hydrogen mass fraction


def aperture_shell_fraction(r, R_ap):
    """The fraction of a thin shell of radius r whose projected radius lies
    inside R_ap: 1 for r <= R_ap, else 1 - sqrt(1 - (R_ap / r)^2).  The
    square root's argument is masked before the branch, so no gradient
    passes through a clipped zero."""
    outside = r > R_ap
    arg = torch.where(outside,
                      1.0 - (R_ap / torch.where(outside, r, R_ap)) ** 2, 1.0)
    return torch.where(outside, 1.0 - torch.sqrt(arg), 1.0)


def _nodes(n_x, dev):
    """Gauss-Legendre nodes and weights on (0, 1), on ``dev`` once."""
    def make():
        t, w = leggauss_cached(n_x)
        return 0.5 * (t + 1.0), 0.5 * w
    return on_device(f"pairwise_leggauss:{n_x}", dev, make)


@on_device_of_inputs
def tau_aperture_battaglia(zs, m200, r200, cmax, rhocritz, omb, omm,
                           R_ap, gamma, fit_params, n_x=256):
    """Mean aperture optical depth tau_bar(z, m) of the Battaglia 2016 gas
    profile inside a disk of physical radius R_ap [Mpc] (a scalar or
    (nz,)):

        N_e,cyl = int_0^rmax 4 pi r^2 n_e(r) w(r; R_ap) dr,
        tau_bar = sigma_T N_e,cyl / (pi R_ap^2),

    n_e = (1 + X_H) / (2 m_p) rho_gas, the profile cut at x = 2 r / R200 =
    cmax.  zs (nz,), m200/r200/cmax (nz, nm), rhocritz (nz,).  n_x-node
    Gauss-Legendre in x per (z, m), in two panels split at the aperture
    edge (w(r) has a kink there); the outer panel under u^2 = x - x_edge,
    where w ~ u.  Returns (nz, nm)."""
    m200, r200, cmax, rhocritz = map(tensor_or_f64,
                                     (m200, r200, cmax, rhocritz))
    dev = m200.device
    zs = torch.as_tensor(zs, dtype=_F64, device=dev)
    R_ap = torch.as_tensor(R_ap, dtype=_F64, device=dev)
    if R_ap.dim() == 1:
        R_ap = R_ap[:, None]          # (nz, 1) over m
    t, w = _nodes(n_x, dev)
    rg = r200 / 2.0                               # x = r / (R200/2)
    x_edge = torch.clamp(R_ap / rg, min=0.0)
    x_edge = torch.minimum(x_edge, cmax)          # kink location in x
    sigma_T_mpc2 = _SIGMA_T_SI * _METER_TO_MPC**2

    def _f(xs):
        # x^2 n_e(x) w_ap(x)
        rho = prof.rho_gas_x(xs, m200[..., None], zs[:, None, None],
                             omb, omm, rhocritz[:, None, None], gamma,
                             fit_params)          # Msun/Mpc^3 (physical)
        n_e = rho * (_MSUN_KG / _M_PROTON_SI) * (1.0 + _XH) / 2.0
        wap = aperture_shell_fraction(xs * rg[..., None], R_ap[..., None])
        return xs**2 * n_e * wap

    # panel 1: [0, x_edge], where w_ap = 1
    xs1 = x_edge[..., None] * t[None, None, :]
    I1 = x_edge * (_f(xs1) @ w)
    # panel 2: [x_edge, cmax] under u^2 = x - x_edge; the double where
    # keeps a zero width (aperture beyond the halo) gradient-safe
    width2 = torch.clamp(cmax - x_edge, min=0.0)
    pos = width2 > 0.0
    umax = torch.where(pos, torch.sqrt(torch.where(pos, width2, 1.0)), 0.0)
    us = umax[..., None] * t[None, None, :]
    xs2 = x_edge[..., None] + us**2
    I2 = umax * ((2.0 * us * _f(xs2)) @ w)
    Ne_cyl = 4.0 * math.pi * rg**3 * (I1 + I2)
    return sigma_T_mpc2 * Ne_cyl / (math.pi * R_ap**2)


def electron_count_total_battaglia(zs, m200, r200, cmax, rhocritz, omb,
                                   omm, gamma, fit_params, n_x=512):
    """Total electron count N_e(< rmax) of the truncated profile: the
    R_ap -> infinity limit of the cylinder count."""
    big = 1e9 * torch.max(r200)
    tau = tau_aperture_battaglia(zs, m200, r200, cmax, rhocritz, omb,
                                 omm, big, gamma, fit_params, n_x=n_x)
    sigma_T_mpc2 = _SIGMA_T_SI * _METER_TO_MPC**2
    return tau * math.pi * big**2 / sigma_T_mpc2


def compton_y_k0_battaglia(zs, m200, r200, cmax, rhocritz, omb, omm,
                           alpha, gamma, fit_params, hz, n_x=512):
    """The k -> 0 limit of the y-weighted Battaglia pressure profile,

        u_y(0) = 4 pi sigma_T/(m_e c^2) r200^3 (1+z)^2 / H(z)
                 int_0^cmax x^2 P_e(x) dx,

    by n_x-node Gauss-Legendre per (z, m).  The registered profile's grid
    bottoms out near 0.3/Mpc and flat-extrapolates below, which is ~5% low
    for the largest halos; the monopole needs the true limit.  Constants
    as add_battaglia_pres_profile's."""
    dev = m200.device
    zs = torch.as_tensor(zs, dtype=_F64, device=dev)
    t, w = _nodes(n_x, dev)
    xs = cmax[..., None] * t[None, None, :]
    P = prof.pressure_x(xs, m200[..., None], r200[..., None],
                        zs[:, None, None], omb, omm,
                        rhocritz[:, None, None], alpha, gamma, fit_params)
    I = cmax * ((xs**2 * P) @ w)
    sigmaT = 6.6524587321e-29
    mElect = 9.1093837015e-31 / 1.989e30
    c_SI = 299792458.0
    unit = (4.0 * math.pi * (sigmaT / (mElect * c_SI**2)) * r200**3
            * ((1.0 + zs) ** 2 / hz)[:, None])
    return unit * I


@on_device_of_inputs
def pairwise_ksz_signal(ks, pk, f, aH, bg, tau_bar, T_CMB_uK=None):
    """The mean pairwise kSZ temperature on the FFTLog r grid,
    T(r) = - T_CMB tau_bar v12(r) / c [muK], for the linear matter power pk
    on the log-uniform numpy ks at one redshift.  Returns (rs [comoving
    Mpc], T(r))."""
    from .rsd import mean_pairwise_velocity
    if T_CMB_uK is None:
        T_CMB_uK = default_params["T_CMB"]
    rs, v12 = mean_pairwise_velocity(ks, pk, f, aH, b=bg)
    return rs, -T_CMB_uK * tau_bar * v12 / _C_KM_S


@on_device_of_inputs
def pairwise_ksz_errors(r_edges, rs, xi, T_r, ngal_mpc3, volume_gpc3,
                        sigma_meas_uK, bg=1.0):
    """Pair-count errors of the binned signal: in [r_i, r_i+1],
    N_pair = 2 pi nbar^2 V r_c^2 dr (1 + bg^2 xi(r_c)) and sigma_bin =
    sqrt(2 / N_pair) sigma_meas.  r_edges (nb+1,) comoving Mpc; rs, xi,
    T_r on the signal's grid, lerped to the bin centers.  Returns
    (r_centers, T_bins, sigma_bins, snr)."""
    rs, xi, T_r = map(tensor_or_f64, (rs, xi, T_r))
    dev = T_r.device
    r_edges = torch.as_tensor(r_edges, dtype=_F64, device=dev)
    rc = 0.5 * (r_edges[1:] + r_edges[:-1])
    dr = torch.diff(r_edges)
    xi_c = linear_interp(rc, rs, xi)
    T_c = linear_interp(rc, rs, T_r)
    V = volume_gpc3 * 1e9
    npair = (2.0 * math.pi * ngal_mpc3**2 * V * rc**2 * dr
             * (1.0 + bg**2 * xi_c))
    sigma = torch.sqrt(2.0 / npair) * sigma_meas_uK
    snr = torch.sqrt(torch.sum((T_c / sigma) ** 2))
    return rc, T_c, sigma, snr


def get_pairwise_ksz_snr(hm, zindex, ngal_mpc3, volume_gpc3,
                         sigma_meas_uK, r_edges, hod_name="g",
                         R_ap=None, theta_arcmin=1.0, nks=512,
                         tau_bar=None):
    """The pairwise kSZ SNR at one redshift of a HaloModel with a
    registered HOD: tau_bar the HOD-weighted mean aperture optical depth
    (unless given), the bias-weighted v12 from the linear P(k) at
    zs[zindex], the pair-count errors.  Returns a dict of r_centers,
    T_bins, sigma_bins, snr, tau_bar, rs and T_r."""
    z = float(hm.zs_np[zindex])
    if tau_bar is None:
        tau_zm = hm.get_tau_aperture(R_ap=R_ap, theta_arcmin=theta_arcmin)
        tau_bar = hm.get_tau_mean_hod(hod_name, tau_zm)[zindex]
    bg = hm.hods[hod_name]["bg"][zindex]
    ks = np.geomspace(1e-4, 1e2, nks)
    zq = np.array([z])
    pk = hm.P_lin(ks, zq)[0]
    f = hm.get_growth_rate_f(zq)[0]
    aH = hm.h_of_z(zq)[0] * _C_KM_S / (1.0 + z)
    rs, T_r = pairwise_ksz_signal(ks, pk, f, aH, bg, tau_bar)
    _, xi = correlation_function(ks, pk)
    rc, T_b, sig, snr = pairwise_ksz_errors(
        r_edges, rs, xi, T_r, ngal_mpc3, volume_gpc3, sigma_meas_uK, bg=bg)
    return {"r_centers": rc, "T_bins": T_b, "sigma_bins": sig,
            "snr": snr, "tau_bar": tau_bar, "rs": rs, "T_r": T_r}
