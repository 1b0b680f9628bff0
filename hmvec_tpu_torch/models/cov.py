"""Covariances of C_ell bandpowers and of P(k) on float64 tensors (port of
hmvec_tpu/models/cov.py): the Gaussian (Knox) bandpower covariance and its
registry; the P(k) covariance of a survey volume, Gaussian + 1-halo
trispectrum + super-sample (Takada & Hu 2013); the Limber-projected
connected and super-sample C_ell covariances; and the joint super-sample
covariance of binned cluster counts and C_ell on the counts' redshift-bin
windows (``cluster_counts.window_sigma2``).

The trispectrum is one contraction over the mass axis per z, never the
(z, m, k, k') grid; its Limber projection interpolates every z slice at
the (ell, ell') curve in one batched gather.  Grids and weights that the
JAX package forms on the host (trapezoid weights, the bins' overlap
weights) are formed on the host here too, or on the device from a tensor
grid with the same arithmetic.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.quadrature import gradient, lerp_index, linear_interp
from ..ops.special import Wkr, disk_window
from ..utils.weights import (device_of, f64, grid_weights, host,
                             on_device_of_inputs, tensor_or_f64)
from .limber import interp_pzk_at_curve

_F64 = torch.float64


@on_device_of_inputs
def angular_correlation(ells, cls, thetas_rad):
    """w(theta) = sum_l (2l+1)/(4pi) C_l P_l(cos theta) for consecutive
    integer ells (nl,), cls (..., nl) and thetas (nt,): the (0, 0) Wigner
    sum, since d^l_00 = P_l.  Returns (..., nt)."""
    from .shear import wigner_d_sum
    return wigner_d_sum(ells, cls, thetas_rad, mn=(0, 0))


@on_device_of_inputs
def bin_annuli(ells, cls, bin_edges):
    """ell-weighted bandpower binning; the last bin holds its right edge
    (scipy's binned_statistic)."""
    cls = torch.as_tensor(cls, dtype=_F64)
    dev = cls.device
    ells = f64(ells, dev)
    edges = np.asarray(bin_edges, dtype=np.float64)
    nb = edges.size - 1
    idx = (torch.searchsorted(f64(edges, dev), ells, right=True) - 1) \
        .clamp(0, nb - 1)
    in_range = (ells >= edges[0]) & (ells <= edges[-1])
    w = torch.where(in_range, ells, 0.0)
    zero = torch.zeros(nb, dtype=_F64, device=dev)
    numer = zero.index_add(0, idx, torch.where(in_range, ells * cls, 0.0))
    denom = zero.index_add(0, idx, w)
    return numer / denom


def shot_noise(ngal):
    """Galaxy shot noise for ngal per arcmin^2."""
    return 1.0 / (ngal * 1.18e7)


def lensing_shape_noise(ngal, shape_noise=0.3):
    return shape_noise**2 / 2.0 / shot_noise(ngal)


def get_avail_cls(acls, x, y):
    """The 'x_y' spectrum of a dict, either order, 0 if absent."""
    if x + "_" + y in acls:
        return acls[x + "_" + y]
    return acls.get(y + "_" + x, 0)


class GaussianCov:
    """Registry of binned C_ell and noise; the Knox covariance.  The
    spectra are binned on the device of the C_ell given to ``add_cls``
    (a tensor's own; the card for numpy arrays unless ``device`` says
    otherwise)."""

    def __init__(self, bin_edges, device="cuda"):
        self.cls = {}
        self.nls = {}
        self.device = torch.device(device)
        ellmin, ellmax = bin_edges[0], bin_edges[-1]
        self.ells = np.arange(ellmin, ellmax + 1, 1)
        self.bin_edges = np.asarray(bin_edges)
        self.dls = np.diff(self.bin_edges)
        self.ls = (self.bin_edges[1:] + self.bin_edges[:-1]) / 2.0

    def _binned(self, ells, cls):
        dev = cls.device if isinstance(cls, torch.Tensor) else self.device
        fine = linear_interp(f64(self.ells, dev), f64(ells, dev), f64(cls, dev))
        return bin_annuli(self.ells, fine, self.bin_edges)

    def add_cls(self, name1, name2, ells, cls, ellsn=None, ncls=None):
        if "_" in name1 or "_" in name2:
            raise ValueError("spectrum names may not hold '_'")
        if name2 + "_" + name1 in self.cls:
            raise ValueError(f"{name2}_{name1} is already registered")
        self.cls[name1 + "_" + name2] = self._binned(ells, cls)
        if ellsn is not None and ncls is not None:
            self.nls[name1 + "_" + name2] = self._binned(ellsn, ncls)

    def _lookup(self, registry, x, y):
        if x + "_" + y in registry:
            return registry[x + "_" + y]
        if y + "_" + x in registry:
            return registry[y + "_" + x]
        return 0.0

    def get_scls(self, x, y):
        return self._lookup(self.cls, x, y)

    def get_ncls(self, x, y):
        return self._lookup(self.nls, x, y)

    def get_tcls(self, x, y):
        return self.get_scls(x, y) + self.get_ncls(x, y)

    def get_cov(self, x, y, w, z, fsky):
        """cov(C^xy_b, C^wz_b) = (C_xw C_yz + C_xz C_yw)/((2l+1) dl fsky)."""
        clsum = (self.get_tcls(x, w) * self.get_tcls(y, z)
                 + self.get_tcls(x, z) * self.get_tcls(y, w))
        dev = device_of(clsum)
        return clsum / (2.0 * f64(self.ls, dev) + 1.0) / f64(self.dls, dev) \
            / fsky


@on_device_of_inputs
def knox_cov(cl_xw, cl_yz, cl_xz, cl_yw, ell_mids, delta_ells, fsky):
    """The Knox formula on binned total spectra."""
    cl_xw, cl_yz, cl_xz, cl_yw = map(tensor_or_f64,
                                     (cl_xw, cl_yz, cl_xz, cl_yw))
    clsum = cl_xw * cl_yz + cl_xz * cl_yw
    dev = clsum.device
    return clsum / (2.0 * f64(ell_mids, dev) + 1.0) / f64(delta_ells, dev) \
        / fsky


# ---- P(k) covariance: Gaussian + 1-halo trispectrum + super-sample ---------

@on_device_of_inputs
def pk_cov_gaussian(ks, pk_tot, volume_mpc3, dks=None):
    """Diagonal Gaussian covariance of shell-averaged P(k) in a volume:
    2 P(k_i)^2 / N_i, N_i = V k_i^2 dk_i / (2 pi^2) modes (dk by unit-
    spacing np.gradient of ks); pk_tot (..., nk).  Returns (..., nk, nk)."""
    pk_tot = tensor_or_f64(pk_tot)
    dev = pk_tot.device
    ks = f64(ks, dev)
    dks = torch.gradient(ks)[0] if dks is None else f64(dks, dev)
    nmodes = volume_mpc3 * ks**2 * dks / (2.0 * math.pi**2)
    diag = 2.0 * pk_tot**2 / nmodes
    nk = ks.shape[-1]
    return diag[..., None] * torch.eye(nk, dtype=diag.dtype, device=dev)


def _contract_m(nzm, ms, t12, t34):
    """int dm n(z, m) t12(z, m, k) t34(z, m, k') -> (z, k, k'): one batched
    matmul per z over the mass axis."""
    w = grid_weights(ms, nzm.device)
    return torch.bmm((t12 * (nzm * w[None, :])[..., None]).transpose(1, 2),
                     t34)


@on_device_of_inputs
def trispectrum_1h(nzm, ms, rho_matter0, uk1, uk2=None):
    """Connected 1-halo matter trispectrum T(z, k, k') = int dm n (m /
    rho_m0)^4 u1(k)^2 u2(k')^2, contracted over m, never materializing the
    (z, m, k, k') grid."""
    nzm, uk1 = tensor_or_f64(nzm), tensor_or_f64(uk1)
    uk2 = uk1 if uk2 is None else tensor_or_f64(uk2)
    mfac = (f64(ms, nzm.device) / rho_matter0) ** 2
    a1 = uk1**2 * mfac[None, :, None]
    a2 = uk2**2 * mfac[None, :, None]
    return _contract_m(nzm, ms, a1, a2)


@on_device_of_inputs
def trispectrum_1h_terms(nzm, ms, term12, term34):
    """T(z, k, k') = int dm n t1 t2(k) t3 t4(k') from two (z, m, k) 1-halo
    pair terms (power.one_halo_square_term), for any tracer pairing."""
    return _contract_m(*map(tensor_or_f64, (nzm, ms, term12, term34)))


def _interp2_loglog(t_zkk, lks, lke):
    """Every z slice T(k, k') of t_zkk (nz, nk, nk) bilinearly in (ln k,
    ln k') at the outer product of its own curve points lke[:, z] (nl,):
    one gather along k', then one along k, for all z at once.  Returns
    (nz, nl, nl)."""
    nz, nk, _ = t_zkk.shape
    i, t = lerp_index(lks, lke.T.contiguous())               # (nz, nl)
    nl = i.shape[1]
    ib = i[:, None, :].expand(nz, nk, nl)
    tb = t[:, None, :]
    A = (torch.gather(t_zkk, 2, ib) * (1.0 - tb)
         + torch.gather(t_zkk, 2, ib + 1) * tb)              # (nz, nk, nl)
    ia = i[:, :, None].expand(nz, nl, nl)
    ta = t[:, :, None]
    return (torch.gather(A, 1, ia) * (1.0 - ta)
            + torch.gather(A, 1, ia + 1) * ta)               # (nz, nl, nl)


@on_device_of_inputs
def cl_cov_t1h(ells, zs, ks, t_zkk, Wz1s, Wz2s, hzs, chis, fsky=1.0,
               Wz3s=None, Wz4s=None):
    """Connected (1-halo trispectrum) covariance of C_ell bandpowers,

        Cov(C^12_l, C^34_l') = (1/(4 pi fsky))
            int dz H^3 (W1 W2)(W3 W4) / chi^6  T(k_l, k_l', z),

    with limber_integral's window, H and chi conventions; Wz3s/Wz4s
    default to Wz1s/Wz2s."""
    t_zkk = tensor_or_f64(t_zkk)
    dev = t_zkk.device
    ells = f64(ells, dev)
    lks = torch.log(f64(ks, dev))
    chis, hzs = f64(chis, dev), f64(hzs, dev)
    Wz3s = Wz1s if Wz3s is None else Wz3s
    Wz4s = Wz2s if Wz4s is None else Wz4s
    W1, W2, W3, W4 = (f64(w, dev) for w in (Wz1s, Wz2s, Wz3s, Wz4s))
    pref = hzs**3 * (W1 * W2) * (W3 * W4) / chis**6 / (4.0 * math.pi * fsky)
    lke = torch.log((ells[:, None] + 0.5) / chis[None, :])   # (nl, nz)
    integrand = _interp2_loglog(t_zkk, lks, lke) * pref[:, None, None]
    wz = grid_weights(zs, dev)
    return torch.tensordot(wz, integrand, dims=1)


@on_device_of_inputs
def sigma_b2_disk(fsky, chis, ks_lin, plin):
    """Per-z variance of the background mode over the flat-sky survey disk,
    sigma_b^2(z) = (1/2 pi) int dk k P_lin(z, k) W^2(k chi theta_s), W the
    disk window 2 J1(x)/x of the cap of area 4 pi fsky.  plin (nz, nk)."""
    plin = tensor_or_f64(plin)
    dev = plin.device
    theta_s = math.acos(1.0 - 2.0 * fsky)
    ks = f64(ks_lin, dev)
    x = ks[None, :] * f64(chis, dev)[:, None] * theta_s
    W2 = disk_window(x) ** 2
    return (plin * W2 * ks[None, :] / (2.0 * math.pi)) @ grid_weights(ks_lin,
                                                                       dev)


def _response_at_curve(ells, zs, ks, pk_zk, chis, resp_zk):
    """[R P](k = (l + 1/2) / chi(z), z) on the (nl, nz) curve."""
    dev = pk_zk.device
    if resp_zk is None:
        resp_zk = pk_response_ssc(ks, pk_zk)
    zs = torch.atleast_1d(f64(zs, dev))
    chis = f64(chis, dev)
    kevals = (f64(ells, dev)[:, None] + 0.5) / chis[None, :]
    return interp_pzk_at_curve(zs, f64(ks, dev), torch.atleast_2d(resp_zk),
                               zs, kevals)


def cl_cov_ssc(ells, zs, ks, pk_zk, Wz1s, Wz2s, hzs, chis, sigma_b2_z,
               resp_zk=None):
    """Super-sample covariance of C_ell bandpowers,

        Cov(C_l, C_l') = int dz H^3 (W1 W2)^2 / chi^4
                         [R P](k_l, z) [R P](k_l', z) sigma_b^2(z),

    with limber_integral's conventions; resp_zk defaults to
    pk_response_ssc of pk_zk, sigma_b2_z from sigma_b2_disk."""
    dev = pk_zk.device
    RP = _response_at_curve(ells, zs, ks, pk_zk, chis, resp_zk)  # (nl, nz)
    chis, hzs = f64(chis, dev), f64(hzs, dev)
    pref = (hzs**3 * (f64(Wz1s, dev) * f64(Wz2s, dev)) ** 2 / chis**4
            * f64(sigma_b2_z, dev))
    wz = grid_weights(zs, dev)
    return (RP * (wz * pref)[None, :]) @ RP.T


# ---- the joint counts x C_ell super-sample covariance ----------------------
#
#   delta N_i = <bN>_i delta_b,i,  delta C_l = sum_j r_{l,j} delta_b,j,
#   r_{l,j} = int_{z-bin j} dz H W1 W2 / chi^2 [R P](k_l, z):
#   Cov(N_i, N_j) = <bN>_i <bN>_j sigma^2_ij, Cov(N_i, C_l) = <bN>_i
#   sum_j sigma^2_ij r_{l,j}, Cov(C_l, C_l') = sum_ij r_{l,i} sigma^2_ij
#   r_{l',j}, with sigma^2_ij on the counts' bins (window_sigma2).

def cl_ssc_response_binned(ells, zedges, zs, ks, pk_zk, Wz1s, Wz2s, hzs,
                           chis, resp_zk=None):
    """Per-redshift-bin super-sample response r_{b,l} of C_ell, (nbin, nl):
    the Limber integrand times the power response over each [lo, hi],
    endpoints included, so bins sharing an edge sum to the whole range."""
    dev = pk_zk.device
    RP = _response_at_curve(ells, zs, ks, pk_zk, chis, resp_zk)  # (nl, nz)
    rho = RP * (f64(hzs, dev) * f64(Wz1s, dev) * f64(Wz2s, dev)
                / f64(chis, dev) ** 2)[None, :]
    return f64(_bin_overlap_weights(zedges, host(zs)), dev) @ rho.T


def _bin_overlap_weights(zedges, zs):
    """(nbin, nz) weights that integrate a piecewise-linear function of zs
    over each [lo, hi] exactly, partial intervals included (host numpy):
    the rows sum to the trapezoid weights of the range its bins tile, for
    any edges."""
    zs = np.asarray(zs, dtype=float)
    zedges = np.asarray(zedges, dtype=float)
    nb = zedges.size - 1
    Wb = np.zeros((nb, zs.size))
    z0, z1 = zs[:-1], zs[1:]
    dz = z1 - z0
    for b, (lo, hi) in enumerate(zip(zedges[:-1], zedges[1:])):
        a = np.clip(np.maximum(lo, z0), z0, z1)
        c = np.clip(np.minimum(hi, z1), z0, z1)
        olen = np.maximum(c - a, 0.0)
        with np.errstate(invalid="ignore", divide="ignore"):
            ta = np.where(dz > 0, (a - z0) / dz, 0.0)
            tc = np.where(dz > 0, (c - z0) / dz, 0.0)
        # int_a^c lerp(f_i, f_i+1) dz = olen/2 [(1-ta)+(1-tc)] f_i
        #                              + olen/2 [ta+tc] f_i+1
        Wb[b, :-1] += olen * (2.0 - ta - tc) / 2.0
        Wb[b, 1:] += olen * (ta + tc) / 2.0
    return Wb


def cov_counts_cl_ssc(bN_i, sigma2_ij, r_bl):
    """Cov(N_i, C_l) = <bN>_i (sigma^2 r)_{i, l}, (nbin, nl)."""
    return bN_i[:, None] * (sigma2_ij @ r_bl)


def cov_cl_cl_ssc_binned(r_bl, sigma2_ij, r_bl2=None):
    """The binned-window C_ell block r^T sigma^2 r' (nl, nl')."""
    r_bl2 = r_bl if r_bl2 is None else r_bl2
    return r_bl.T @ sigma2_ij @ r_bl2


def joint_counts_cl_cov(N_i, bN_i, sigma2_ij, r_bl, cov_cl_gauss=None):
    """The joint covariance of (N_1..N_nb, C_l1..C_lnl):

        [ diag(N) + bN bN^T o sigma^2   diag(bN) sigma^2 r        ]
        [ (diag(bN) sigma^2 r)^T        r^T sigma^2 r (+ Gaussian) ]

    (its super-sample part is M sigma^2 M^T, positive semi-definite
    whenever sigma^2 is)."""
    top_left = torch.diag(N_i) + bN_i[:, None] * bN_i[None, :] * sigma2_ij
    top_right = cov_counts_cl_ssc(bN_i, sigma2_ij, r_bl)
    bot_right = cov_cl_cl_ssc_binned(r_bl, sigma2_ij)
    if cov_cl_gauss is not None:
        bot_right = bot_right + f64(cov_cl_gauss, bot_right.device)
    return torch.cat([torch.cat([top_left, top_right], dim=1),
                      torch.cat([top_right.T, bot_right], dim=1)], dim=0)


@on_device_of_inputs
def pk_response_ssc(ks, pk):
    """Linear response dP/d(delta_b) = (68/21 - (1/3) dln(k^3 P)/dln k) P
    (beat coupling and dilation, Takada & Hu 2013), along the last axis of
    pk (..., nk)."""
    pk = tensor_or_f64(pk)
    ks = f64(ks, pk.device)
    lnk3p = torch.log(ks**3 * pk)
    dlnk3p = gradient(lnk3p, torch.log(ks), axis=-1)
    return (68.0 / 21.0 - dlnk3p / 3.0) * pk


@on_device_of_inputs
def sigma_b2_tophat(volume_mpc3, ks_lin, plin):
    """Variance of the background mode over a spherical volume,
    sigma_b^2 = (1/2 pi^2) int dk k^2 P_lin(k) W^2(kR), R = (3V/4pi)^(1/3);
    plin (..., nk) -> (...,)."""
    plin = tensor_or_f64(plin)
    dev = plin.device
    ks = f64(ks_lin, dev)
    R = (3.0 * volume_mpc3 / (4.0 * math.pi)) ** (1.0 / 3.0)
    W2 = Wkr(ks, R, 0.01) ** 2
    integrand = plin * W2 * ks**2 / (2.0 * math.pi**2)
    return integrand @ grid_weights(ks_lin, dev)


@on_device_of_inputs
def pk_cov_ssc(response, sigma_b2):
    """Super-sample covariance R(k) R(k') sigma_b^2: rank one per leading
    index; response (..., nk), sigma_b2 (...,)."""
    response = tensor_or_f64(response)
    return (response[..., :, None] * response[..., None, :]
            * torch.as_tensor(sigma_b2, dtype=_F64,
                              device=response.device)[..., None, None])

