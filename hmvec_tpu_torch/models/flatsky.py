"""Flat-sky Gaussian map simulation and FFT-domain lensing reconstruction
on float64 / complex128 tensors (port of hmvec_tpu/models/flatsky.py).

A map-level pipeline on the periodic flat-sky torus: Gaussian fields with
a prescribed C(l) (``synth_gaussian``, ``synth_pol``, ``synth_tqu``),
annulus-binned power (``fourier_power``, ``map_power``), first-order and
fully remapped lensing (``lens_map_first_order``, ``lens_map``) and the
TT, EE, TE and EB quadratic estimators in their separable real-space
forms.  Conventions as in the JAX package: an n x n grid of pixel a rad,
area (n a)^2; T(l) = a^2 FFT2[T](k); C_l arrays indexed by integer l and
sampled on the |l| grid by ``jnp.interp``'s arithmetic.

Every function takes maps with any leading batch dimensions (the JAX
package batches by ``vmap``): n is read from the last axis and the FFTs
run over the last two, so a batch of maps equals the same maps one at a
time.  The random draws take a ``torch.Generator`` in the JAX key's
place; each synthesis is a thin layer over a private function of the
white noise itself (``_synth_from_noise`` and its polarized twins), which
the tests feed with the JAX package's own draws.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.quadrature import linear_interp
from ..utils.weights import call_device, device_of, on_device_of_inputs

__all__ = ["fourier_grid", "synth_gaussian", "map_power", "fourier_power",
           "lens_map_first_order", "lens_map", "qe_tt", "qe_ee", "qe_te",
           "synth_pol", "synth_tqu", "eb_from_qu", "qe_eb"]

_F64 = torch.float64
_ARCMIN = np.pi / (180.0 * 60.0)


def _map(x):
    """A real map as a float64 tensor (a tensor keeps its device)."""
    return torch.as_tensor(x, dtype=_F64, device=device_of(x) or
                           call_device())


def _fft2(x):
    return torch.fft.fft2(x, dim=(-2, -1))


def _ifft2(x):
    return torch.fft.ifft2(x, dim=(-2, -1))


@on_device_of_inputs
def fourier_grid(n: int, pix_arcmin: float):
    """(lx, ly, lmod) for an n x n grid with the given pixel size: the
    angular wavenumbers of numpy's fft2 layout (multipoles), lx (1, n), ly
    (n, 1), lmod = |l| (n, n) with the (0, 0) element 0.  The frequencies
    come from numpy's fftfreq on the host, as in the JAX package."""
    a = pix_arcmin * _ARCMIN
    freqs = torch.as_tensor(np.fft.fftfreq(int(n), d=a) * 2.0 * np.pi,
                            dtype=_F64, device=call_device())
    lx = freqs[None, :]
    ly = freqs[:, None]
    return lx, ly, torch.sqrt(lx**2 + ly**2)


def _cl_on_grid(cl, lmod):
    """C(|l|) by linear interpolation of an integer-l table, 0 beyond it."""
    cl = torch.as_tensor(cl, dtype=_F64, device=lmod.device)
    grid = torch.arange(cl.shape[0], dtype=_F64, device=lmod.device)
    return linear_interp(lmod, grid, cl, right=0.0)


def _draw_device(generator, cl, device):
    """The device of a draw: ``device`` if given, else cl's if it is a
    tensor, else the generator's, else the card."""
    if device is not None:
        return torch.device(device)
    dev = device_of(cl)
    if dev is not None:
        return dev
    return generator.device if generator is not None \
        else torch.device("cuda")


def _normal(generator, shape, device):
    return torch.randn(shape, generator=generator, dtype=_F64, device=device)


def _synth_from_noise(w, pix_arcmin: float, cl):
    """synth_gaussian's map from unit white noise w (..., n, n):
    ifft2(fft2(w / a) sqrt(C(|l|))).real."""
    a = pix_arcmin * _ARCMIN
    lmod = fourier_grid(w.shape[-1], pix_arcmin, device=w.device)[2]
    tk = _fft2(w / a) * torch.sqrt(_cl_on_grid(cl, lmod))
    return _ifft2(tk).real


def synth_gaussian(generator, n: int, pix_arcmin: float, cl, device=None):
    """Real Gaussian map with spectrum C(l) (cl indexed by integer l).

    T = ifft2( fft2(w) sqrt(C(|l|)) ) with w white, Var(w_pix) = 1/a^2:
    then <|a^2 FFT T|^2> = Omega C exactly.  ``generator``: the
    ``torch.Generator`` of the draw (None: torch's default one on the
    device)."""
    dev = _draw_device(generator, cl, device)
    w = _normal(generator, (int(n), int(n)), dev)
    return _synth_from_noise(w, pix_arcmin, cl)


def _annuli(lmod, bin_edges):
    """(bin index of every |l| of the grid clipped into range, its in-range
    weight, the modes in each bin, the edges): a right-sided search,
    jnp.digitize's."""
    edges = torch.as_tensor(bin_edges, dtype=_F64, device=lmod.device)
    idx = torch.bucketize(lmod.reshape(-1), edges, right=True) - 1
    nb = edges.shape[0] - 1
    inb = (idx >= 0) & (idx < nb)
    idxc, w = torch.where(inb, idx, 0), inb.to(_F64)
    counts = torch.zeros(nb, dtype=_F64, device=lmod.device).index_add_(
        0, idxc, w)
    return idxc, w, counts, edges


def _bin_counts(n: int, pix_arcmin: float, bin_edges, device=None):
    """Modes of the n x n grid in each annulus of bin_edges."""
    lmod = fourier_grid(n, pix_arcmin, device=device or call_device())[2]
    return _annuli(lmod, bin_edges)[2]


@on_device_of_inputs
def fourier_power(f1k, f2k, pix_arcmin: float, bin_edges):
    """Annulus-binned cross power of two fields given their (discrete)
    fft2 arrays (..., n, n): C_hat = (a^2/n^2) <Re F1 F2*> per bin, the
    exact inverse of synth_gaussian's convention.  Returns (L_mid, C_hat),
    C_hat (..., n_bins)."""
    dev = call_device()
    f1k = torch.as_tensor(f1k, device=dev)
    f2k = torch.as_tensor(f2k, device=dev)
    n = f1k.shape[-1]
    a = pix_arcmin * _ARCMIN
    lmod = fourier_grid(n, pix_arcmin, device=f1k.device)[2]
    p = (f1k * torch.conj(f2k)).real * (a**2 / n**2)
    idxc, w, cnts, edges = _annuli(lmod, bin_edges)
    p = p.reshape(*p.shape[:-2], n * n)
    sums = torch.zeros(*p.shape[:-1], cnts.numel(), dtype=p.dtype,
                       device=p.device).index_add_(-1, idxc, p * w)
    mids = 0.5 * (edges[:-1] + edges[1:])
    return mids, sums / torch.clamp(cnts, min=1.0)


@on_device_of_inputs
def map_power(map1, map2, pix_arcmin: float, bin_edges):
    """Annulus-binned cross power of two real-space maps (auto if map1
    is map2); see fourier_power."""
    f1 = _fft2(_map(map1))
    f2 = f1 if map2 is map1 else _fft2(_map(map2))
    return fourier_power(f1, f2, pix_arcmin, bin_edges)


def _grad_maps(fk, lx, ly):
    """Real-space gradient of a field given its full-complex FFT."""
    gx = _ifft2(1j * lx * fk).real
    gy = _ifft2(1j * ly * fk).real
    return gx, gy


@on_device_of_inputs
def lens_map_first_order(t, phi, pix_arcmin: float):
    """T + grad(phi).grad(T), both gradients spectral: exact to O(phi),
    the coupling the quadratic estimator's response is derived from."""
    t, phi = _map(t), _map(phi)
    lx, ly, _ = fourier_grid(t.shape[-1], pix_arcmin, device=t.device)
    tx, ty = _grad_maps(_fft2(t), lx, ly)
    px, py = _grad_maps(_fft2(phi), lx, ly)
    return t + px * tx + py * ty


def _fft_pad(fk, o: int):
    """Zero-pad a full fft2 array (..., n, n) to an o-times finer grid
    (band-limited Fourier interpolation); the o^2 factor keeps real-space
    values.  The shared Nyquist row/column is copied, not split."""
    n = fk.shape[-1]
    h = n // 2
    out = torch.zeros(*fk.shape[:-2], o * n, o * n, dtype=fk.dtype,
                      device=fk.device)
    out[..., :h, :h] = fk[..., :h, :h]
    out[..., :h, -h:] = fk[..., :h, -h:]
    out[..., -h:, :h] = fk[..., -h:, :h]
    out[..., -h:, -h:] = fk[..., -h:, -h:]
    return out * (o * o)


def _bilinear_wrap(img, yy, xx):
    """``map_coordinates(img, [yy, xx], order=1, mode="wrap")`` over the
    last two axes: floor indices wrapped by a floor modulo (index % size,
    torch.remainder), weights 1 - frac and frac, the four corners summed
    in the order (lo, lo), (lo, hi), (hi, lo), (hi, hi), each weighted by
    w_y w_x."""
    ny, nx = img.shape[-2:]
    batch = torch.broadcast_shapes(img.shape[:-2], yy.shape[:-2])
    flat = img.expand(*batch, ny, nx).reshape(*batch, ny * nx)
    yy = yy.expand(*batch, *yy.shape[-2:])
    xx = xx.expand(*batch, *yy.shape[-2:])
    y0, x0 = torch.floor(yy), torch.floor(xx)
    wy1, wx1 = yy - y0, xx - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    iy0, ix0 = y0.long(), x0.long()
    rows = [(torch.remainder(iy0, ny), wy0),
            (torch.remainder(iy0 + 1, ny), wy1)]
    cols = [(torch.remainder(ix0, nx), wx0),
            (torch.remainder(ix0 + 1, nx), wx1)]
    out = None
    for iy, wy in rows:
        for ix, wx in cols:
            idx = (iy * nx + ix).reshape(*batch, -1)
            term = (wy * wx) * torch.gather(flat, -1, idx).reshape(yy.shape)
            out = term if out is None else out + term
    return out


@on_device_of_inputs
def lens_map(t, phi, pix_arcmin: float, oversample: int = 2):
    """Fully remapped T(x + grad(phi)(x)) at the coarse pixel centers.

    T is Fourier-interpolated onto an ``oversample``-times finer grid
    (exact for band-limited fields), remapped there by bilinear
    interpolation at the deflections sampled at the coarse centers
    (exact from the coarse FFT), and read back at the coarse centers.
    The bilinear transfer deficit falls ~ o^2."""
    t, phi = _map(t), _map(phi)
    n = t.shape[-1]
    o = int(oversample)
    af = pix_arcmin * _ARCMIN / o
    tf = t if o == 1 else _ifft2(_fft_pad(_fft2(t), o)).real
    lx, ly, _ = fourier_grid(n, pix_arcmin, device=t.device)
    px, py = _grad_maps(_fft2(phi), lx, ly)
    rows = float(o) * torch.arange(n, dtype=t.dtype, device=t.device)
    yy = rows[:, None] + py / af     # axis -2 varies with ly
    xx = rows[None, :] + px / af
    return _bilinear_wrap(tf, yy, xx)


def _inverse_filter(cl_total, lmod, band):
    """1/C^tot(|l|) inside the band where C^tot > 0, else 0."""
    c = _cl_on_grid(cl_total, lmod)
    return torch.where(band & (c > 0.0),
                       1.0 / torch.where(c > 0.0, c, 1.0), 0.0)


def _normalized(gk, norm, lmod):
    """-i N(L) gk(L) on 2 <= |L| <= len(norm) - 1, else 0."""
    norm = torch.as_tensor(norm, dtype=_F64, device=lmod.device)
    lout = (lmod >= 2.0) & (lmod <= float(norm.shape[0] - 1))
    return torch.where(lout, -1j * gk * _cl_on_grid(norm, lmod), 0.0)


@on_device_of_inputs
def qe_tt(tmap, pix_arcmin: float, cl_grad, cl_total, n0_phi,
          lmin=30, lmax=3000):
    """Normalized flat-sky TT quadratic estimator phi_hat(l) (complex
    fft2 layout): phi_hat(L) = -i N0(L) [lx FFT(P_x) + ly FFT(P_y)](L),
    P_j = (d_j T_W) T_I, T_I = T/C^tot, T_W = C^grad T/C^tot on
    lmin <= |l| <= lmax; zero outside [2, len(n0_phi) - 1]."""
    tmap = _map(tmap)
    lx, ly, lmod = fourier_grid(tmap.shape[-1], pix_arcmin,
                                device=tmap.device)
    tk = _fft2(tmap)
    band = (lmod >= lmin) & (lmod <= lmax)
    ti_k = tk * _inverse_filter(cl_total, lmod, band)
    tw_k = ti_k * _cl_on_grid(cl_grad, lmod)
    ti = _ifft2(ti_k).real
    wx, wy = _grad_maps(tw_k, lx, ly)
    gk = lx * _fft2(wx * ti) + ly * _fft2(wy * ti)
    return _normalized(gk, n0_phi, lmod)


def _spin2_phases(n: int, pix_arcmin: float, device):
    """cos(2 psi_l), sin(2 psi_l) on the fft2 grid (0 at l = 0)."""
    lx, ly, lmod = fourier_grid(n, pix_arcmin, device=device)
    m2 = torch.where(lmod > 0.0, lmod**2, 1.0)
    c2 = torch.where(lmod > 0.0, (lx**2 - ly**2) / m2, 0.0)
    s2 = torch.where(lmod > 0.0, 2.0 * lx * ly / m2, 0.0)
    return c2, s2


def _qu_from_eb(ek, bk, c2, s2):
    q = _ifft2(c2 * ek - s2 * bk).real
    u = _ifft2(s2 * ek + c2 * bk).real
    return q, u


def _synth_pol_from_noise(we, wb, pix_arcmin: float, cl_ee, cl_bb=None):
    """synth_pol's (Q, U) from unit white noise we (and wb, used only with
    cl_bb)."""
    a = pix_arcmin * _ARCMIN
    n = we.shape[-1]
    lmod = fourier_grid(n, pix_arcmin, device=we.device)[2]
    ek = _fft2(we / a) * torch.sqrt(_cl_on_grid(cl_ee, lmod))
    if cl_bb is None:
        bk = torch.zeros_like(ek)
    else:
        bk = _fft2(wb / a) * torch.sqrt(_cl_on_grid(cl_bb, lmod))
    return _qu_from_eb(ek, bk, *_spin2_phases(n, pix_arcmin, we.device))


def synth_pol(generator, n: int, pix_arcmin: float, cl_ee, cl_bb=None,
              device=None):
    """(Q, U) real maps from EE (and optionally BB) spectra: E/B
    synthesized like synth_gaussian and rotated by the spin-2 phases,
    Q(l) = cos(2psi) E - sin(2psi) B, U(l) = sin(2psi) E + cos(2psi) B.
    The B draw is made only with cl_bb."""
    dev = _draw_device(generator, cl_ee, device)
    shape = (int(n), int(n))
    we = _normal(generator, shape, dev)
    wb = None if cl_bb is None else _normal(generator, shape, dev)
    return _synth_pol_from_noise(we, wb, pix_arcmin, cl_ee, cl_bb)


def _synth_tqu_from_noise(w1, w2, w3, pix_arcmin: float, cl_tt, cl_ee,
                          cl_te, cl_bb=None):
    """synth_tqu's (T, Q, U) from unit white noise w1, w2 (and w3, used
    only with cl_bb)."""
    a = pix_arcmin * _ARCMIN
    n = w1.shape[-1]
    lmod = fourier_grid(n, pix_arcmin, device=w1.device)[2]
    g1 = _fft2(w1 / a)
    g2 = _fft2(w2 / a)
    ctt = _cl_on_grid(cl_tt, lmod)
    cee = _cl_on_grid(cl_ee, lmod)
    cte = _cl_on_grid(cl_te, lmod)
    sqtt = torch.sqrt(ctt)
    r = torch.where(sqtt > 0.0, cte / torch.where(sqtt > 0.0, sqtt, 1.0),
                    0.0)
    tk = sqtt * g1
    ek = r * g1 + torch.sqrt(torch.clamp(cee - r**2, min=0.0)) * g2
    if cl_bb is None:
        bk = torch.zeros_like(ek)
    else:
        bk = _fft2(w3 / a) * torch.sqrt(_cl_on_grid(cl_bb, lmod))
    q, u = _qu_from_eb(ek, bk, *_spin2_phases(n, pix_arcmin, w1.device))
    return _ifft2(tk).real, q, u


def synth_tqu(generator, n: int, pix_arcmin: float, cl_tt, cl_ee, cl_te,
              cl_bb=None, device=None):
    """(T, Q, U) real maps with the exact TE correlation: T = sqrt(C^TT)
    g1, E = (C^TE/sqrt(C^TT)) g1 + sqrt(C^EE - C^TE^2/C^TT) g2 (the
    Cholesky factor of the (T, E) covariance per mode), B independent
    (zero unless cl_bb).  Three draws (g1, g2, and g3 with cl_bb)."""
    dev = _draw_device(generator, cl_tt, device)
    shape = (int(n), int(n))
    w1 = _normal(generator, shape, dev)
    w2 = _normal(generator, shape, dev)
    w3 = None if cl_bb is None else _normal(generator, shape, dev)
    return _synth_tqu_from_noise(w1, w2, w3, pix_arcmin, cl_tt, cl_ee, cl_te,
                                 cl_bb)


@on_device_of_inputs
def eb_from_qu(qmap, umap, pix_arcmin: float):
    """(E_k, B_k) fft2 arrays from Q/U maps (inverse spin rotation)."""
    qmap, umap = _map(qmap), _map(umap)
    c2, s2 = _spin2_phases(qmap.shape[-1], pix_arcmin, qmap.device)
    qk = _fft2(qmap)
    uk = _fft2(umap)
    return c2 * qk + s2 * uk, -s2 * qk + c2 * uk


@on_device_of_inputs
def qe_ee(qmap, umap, pix_arcmin: float, cl_ee_grad, cl_ee_total,
          n0_phi, lmin=30, lmax=3000):
    """Normalized flat-sky EE quadratic estimator phi_hat(l), optimal
    weights, separable after expanding cos 2(psi1 - psi2):

      phi_hat(L) = -i N0(L) L . ( FFT[(grad We_c) Ie_c]
                                 + FFT[(grad We_s) Ie_s] ),
      We_{c/s}(l) = cos/sin(2psi) C^EE_l E(l)/C^EE,tot_l,
      Ie_{c/s}(x) = ifft[ cos/sin(2psi) E(l)/C^EE,tot_l ]."""
    qmap, umap = _map(qmap), _map(umap)
    n = qmap.shape[-1]
    lx, ly, lmod = fourier_grid(n, pix_arcmin, device=qmap.device)
    c2, s2 = _spin2_phases(n, pix_arcmin, qmap.device)
    ek, _ = eb_from_qu(qmap, umap, pix_arcmin)
    band = (lmod >= lmin) & (lmod <= lmax)
    ei = _inverse_filter(cl_ee_total, lmod, band) * ek
    we = _cl_on_grid(cl_ee_grad, lmod) * ei
    ie_c = _ifft2(c2 * ei).real
    ie_s = _ifft2(s2 * ei).real
    wx_c, wy_c = _grad_maps(c2 * we, lx, ly)
    wx_s, wy_s = _grad_maps(s2 * we, lx, ly)
    gk = lx * _fft2(wx_c * ie_c + wx_s * ie_s) \
        + ly * _fft2(wy_c * ie_c + wy_s * ie_s)
    return _normalized(gk, n0_phi, lmod)


@on_device_of_inputs
def qe_te(tmap, qmap, umap, pix_arcmin: float, cl_te_grad, cl_tt_total,
          cl_ee_total, a_phi, lmin=30, lmax=3000):
    """Normalized flat-sky TE quadratic estimator phi_hat(l) with the
    SIMPLE (separable) weights F = f_TE / (C^TT,tot_1 C^EE,tot_2):

      term A: L . ( FFT[(grad Wt_c) Ie_c] + FFT[(grad Wt_s) Ie_s] ),
        Wt_{c/s}(l) = cos/sin(2psi) C^TE_l T(l)/C^TT,tot_l,
        Ie_{c/s}(x) = ifft[ cos/sin(2psi) E(l)/C^EE,tot_l ];
      term B: L . FFT[ Ti (grad Ve) ],   Ti = ifft[T/C^TT,tot],
        Ve(l) = C^TE_l E(l)/C^EE,tot_l.

    a_phi: 1/response on integer L (lensing_noise.n0_te_simple_flat_sky),
    not the optimal-weight N0."""
    tmap, qmap, umap = _map(tmap), _map(qmap), _map(umap)
    n = tmap.shape[-1]
    lx, ly, lmod = fourier_grid(n, pix_arcmin, device=tmap.device)
    c2, s2 = _spin2_phases(n, pix_arcmin, tmap.device)
    tk = _fft2(tmap)
    ek, _ = eb_from_qu(qmap, umap, pix_arcmin)
    band = (lmod >= lmin) & (lmod <= lmax)
    cte = _cl_on_grid(cl_te_grad, lmod)
    ti_k = _inverse_filter(cl_tt_total, lmod, band) * tk
    ei_k = _inverse_filter(cl_ee_total, lmod, band) * ek
    wt = cte * ti_k                      # C^TE T / C^TT,tot
    ve = cte * ei_k                      # C^TE E / C^EE,tot
    # term A
    ie_c = _ifft2(c2 * ei_k).real
    ie_s = _ifft2(s2 * ei_k).real
    wx_c, wy_c = _grad_maps(c2 * wt, lx, ly)
    wx_s, wy_s = _grad_maps(s2 * wt, lx, ly)
    px = wx_c * ie_c + wx_s * ie_s
    py = wy_c * ie_c + wy_s * ie_s
    # term B
    ti = _ifft2(ti_k).real
    vx, vy = _grad_maps(ve, lx, ly)
    px = px + ti * vx
    py = py + ti * vy
    gk = lx * _fft2(px) + ly * _fft2(py)
    return _normalized(gk, a_phi, lmod)


@on_device_of_inputs
def qe_eb(qmap, umap, pix_arcmin: float, cl_ee_grad, cl_ee_total,
          cl_bb_total, n0_phi, lmin=30, lmax=3000):
    """Normalized flat-sky EB quadratic estimator phi_hat(l): f_EB =
    C^EE_{l1} (L.l1) sin 2(psi1 - psi2) with weights f / (C^EE,tot_{l1}
    C^BB,tot_{l2}) (lensing_noise.n0_flat_sky's EB normalization):

      phi_hat(L) = -i N0(L) L . ( FFT[(grad We_s) Ib_c]
                                 - FFT[(grad We_c) Ib_s] ),
      We_{s/c}(l) = sin/cos(2psi) C^EE_l E(l)/C^EE,tot_l,
      Ib_{c/s}(x) = ifft[ cos/sin(2psi) B(l)/C^BB,tot_l ]."""
    qmap, umap = _map(qmap), _map(umap)
    n = qmap.shape[-1]
    lx, ly, lmod = fourier_grid(n, pix_arcmin, device=qmap.device)
    c2, s2 = _spin2_phases(n, pix_arcmin, qmap.device)
    ek, bk = eb_from_qu(qmap, umap, pix_arcmin)
    band = (lmod >= lmin) & (lmod <= lmax)
    cet = _cl_on_grid(cl_ee_total, lmod)
    we = torch.where(band & (cet > 0.0), _cl_on_grid(cl_ee_grad, lmod)
                     / torch.where(cet > 0.0, cet, 1.0), 0.0) * ek
    ib = _inverse_filter(cl_bb_total, lmod, band) * bk
    ib_c = _ifft2(c2 * ib).real
    ib_s = _ifft2(s2 * ib).real
    wex_s, wey_s = _grad_maps(s2 * we, lx, ly)
    wex_c, wey_c = _grad_maps(c2 * we, lx, ly)
    px = wex_s * ib_c - wex_c * ib_s
    py = wey_s * ib_c - wey_c * ib_s
    gk = lx * _fft2(px) + ly * _fft2(py)
    return _normalized(gk, n0_phi, lmod)
