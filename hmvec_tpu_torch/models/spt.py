"""One-loop standard perturbation theory P(k) on float64 tensors (port of
hmvec_tpu/models/spt.py).

P_1loop(k) = P_lin(k) + P22(k) + P13(k) with the EdS kernels:

    P22(k) = (k^3 / 2 pi^2) int r^2 dr int_-1^1 dx F2(r, x)^2 P(kr) P(ky),
    P13(k) = (k^3 / (252 * 4 pi^2)) P(k) int dr P(kr) f13(r),

with the velocity-divergence and quadratic-bias variants, the wiggle /
no-wiggle split and the IR resummation of the BAO wiggles.

Numerics, as in the JAX package:
- f13 and its family are evaluated directly on an argument pushed out of
  the cancellation zones, with Taylor windows at r < 1e-2, |r - 1| < 1e-4
  and the large-r series beyond r = 10, so the value and its gradient
  stay finite everywhere;
- P is interpolated linearly in (ln k, ln P), with power-law
  extrapolation beyond both ends of the table;
- the P22-type double integrals are dense Gauss-Legendre contractions
  over (k, ln q, ln y), the outer ln-q integral split at q = k and the
  inner one in ln y from max(|1 - r|, qmin/k) to 1 + r.

Each panel is a dense (nk, n_q/2, n_x) float64 tensor per temporary.  The
port evaluates the k axis in chunks of at most ``PANEL_ELEMENTS``
elements per temporary: every k's sums are the same, and the peak memory
stays bounded at any nk.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.quadrature import linear_interp
from ..utils.weights import (f64, host, leggauss_cached, on_device,
                             on_device_of_inputs)

_F64 = torch.float64

# the largest (nk, nq, nx) panel one temporary may hold (float64
# elements): 2^22 elements = 32 MiB
PANEL_ELEMENTS = 1 << 22


def _lnpk_eval(lnk_tab, lnp_tab, kq):
    """ln P at momenta kq: linear interpolation in (ln k, ln P), and
    linear (power-law) extrapolation beyond both table ends."""
    lnq = torch.log(kq)
    lo_slope = (lnp_tab[1] - lnp_tab[0]) / (lnk_tab[1] - lnk_tab[0])
    hi_slope = (lnp_tab[-1] - lnp_tab[-2]) / (lnk_tab[-1] - lnk_tab[-2])
    inner = linear_interp(lnq, lnk_tab, lnp_tab)
    lo = lnp_tab[0] + lo_slope * (lnq - lnk_tab[0])
    hi = lnp_tab[-1] + hi_slope * (lnq - lnk_tab[-1])
    out = torch.where(lnq < lnk_tab[0], lo, inner)
    return torch.where(lnq > lnk_tab[-1], hi, out)


def _pk_eval(lnk_tab, lnp_tab, kq):
    return torch.exp(_lnpk_eval(lnk_tab, lnp_tab, kq))


def f13(r):
    """The P13 density angular kernel (normalization 1/252)."""
    return _f13_family(
        r, 12.0, -158.0, 100.0, -42.0, 7.0, 2.0,
        small=(-168.0, 928.0 / 5.0, -4512.0 / 35.0),
        near1=(-88.0, 8.0, -116.0),
        big=(-488.0 / 5.0, 96.0 / 5.0, -160.0 / 21.0, -1376.0 / 1155.0,
             -1952.0 / 5005.0, -2528.0 / 15015.0))


def _f13_family(r, A, B, C, D, c1, c2, small, near1, big):
    """The P13 angular-kernel family

        A/r^2 + B + C r^2 + D r^4 + (3/r^3)(r^2-1)^3 (c1 r^2 + c2) L,
        L = ln((1+r)/|1-r|),

    evaluated directly at r clipped to [2e-3, 12] and pushed off r = 1,
    and replaced by its Taylor series at r < 1e-2 and |r - 1| < 1e-4 and
    by the large-r series beyond r = 10 (``small``, ``near1``, ``big``
    are the series' coefficients)."""
    r_safe = torch.clamp(r, 2e-3, 12.0)
    r_safe = torch.where(torch.abs(r_safe - 1.0) < 5e-5, 1.0 + 5e-5, r_safe)
    rs2 = r_safe**2
    direct = (A / rs2 + B + C * rs2 + D * rs2**2
              + 3.0 / (rs2 * r_safe) * (rs2 - 1.0) ** 3
              * (c1 * rs2 + c2)
              * torch.log((1.0 + r_safe) / torch.abs(1.0 - r_safe)))
    s0, s2, s4 = small
    small_v = s0 + s2 * r**2 + s4 * r**4
    n0, n1, n2 = near1
    e = r - 1.0
    near1_v = n0 + n1 * e + n2 * e**2
    u2 = 1.0 / torch.clamp(r, min=1.0) ** 2
    b0, b2, b4, b6, b8, b10 = big
    big_v = b0 + u2 * (b2 + u2 * (b4 + u2 * (b6 + u2 * (b8 + u2 * b10))))
    out = torch.where(r < 1e-2, small_v, direct)
    out = torch.where(torch.abs(e) < 1e-4, near1_v, out)
    return torch.where(r > 10.0, big_v, out)


def f13_dt(r):
    """P13 density-velocity angular kernel (normalization 1/252)."""
    return _f13_family(
        r, 24.0, -202.0, 56.0, -30.0, 5.0, 4.0,
        small=(-168.0, 416.0 / 5.0, -2976.0 / 35.0),
        near1=(-152.0, -56.0, -52.0),
        big=(-200.0, 2208.0 / 35.0, -1312.0 / 105.0, -1888.0 / 1155.0,
             -32.0 / 65.0, -608.0 / 3003.0))


def f13_tt(r):
    """P13 velocity-velocity angular kernel (normalization 1/84)."""
    return _f13_family(
        r, 12.0, -82.0, 4.0, -6.0, 1.0, 2.0,
        small=(-56.0, -32.0 / 5.0, -96.0 / 7.0),
        near1=(-72.0, -40.0, 4.0),
        big=(-504.0 / 5.0, 1248.0 / 35.0, -608.0 / 105.0, -160.0 / 231.0,
             -992.0 / 5005.0, -1184.0 / 15015.0))


def _default_qrange(ks_tab):
    """(qmin, qmax): the ends of the table ks_tab (host)."""
    ks_tab = host(ks_tab)
    return float(np.exp(np.log(ks_tab)[0])), float(np.exp(np.log(ks_tab)[-1]))


def _qrange(ks_tab, qmin, qmax):
    if qmin is None or qmax is None:
        d0, d1 = _default_qrange(ks_tab)
        qmin = d0 if qmin is None else qmin
        qmax = d1 if qmax is None else qmax
    return qmin, qmax


def _tables(dev, ks_tab, *pk_tabs):
    """ln k and the ln P of each table, on ``dev``."""
    return (torch.log(f64(ks_tab, dev)),
            *(torch.log(f64(p, dev)) for p in pk_tabs))


def _p13_core(ks, ks_tab, pk_tab, kern_fn, denom, n_q, qmin, qmax):
    pk_tab = torch.as_tensor(pk_tab, dtype=_F64)
    dev = pk_tab.device
    ks = f64(ks, dev)
    lnk_tab, lnp_tab = _tables(dev, ks_tab, pk_tab)
    qmin, qmax = _qrange(ks_tab, qmin, qmax)
    t_np, w_np = leggauss_cached(n_q)
    lo, hi = np.log(qmin), np.log(qmax)
    lnq, wq = on_device(
        f"spt_p13:{n_q}:{lo!r}:{hi!r}", dev,
        lambda: (0.5 * (hi - lo) * (t_np + 1.0) + lo, 0.5 * (hi - lo) * w_np))
    q = torch.exp(lnq)                           # (nq,)
    Pq = _pk_eval(lnk_tab, lnp_tab, q)
    r = q[None, :] / ks[:, None]                 # (nk, nq)
    # int dr kern P(kr) = int dlnq (q/k) kern(q/k) P(q)
    integ = torch.einsum("q,kq->k", wq * Pq * q, kern_fn(r)) / ks
    Pk = _pk_eval(lnk_tab, lnp_tab, ks)
    return ks**3 / (denom * 4.0 * math.pi**2) * Pk * integ


@on_device_of_inputs
def p13(ks, ks_tab, pk_tab, n_q=1024, qmin=None, qmax=None):
    """P13(k) on the q support [qmin, qmax] (default: the table's range),
    Gauss-Legendre in ln q."""
    return _p13_core(ks, ks_tab, pk_tab, f13, 252.0, n_q, qmin, qmax)


@on_device_of_inputs
def p13_dt(ks, ks_tab, pk_tab, n_q=1024, qmin=None, qmax=None):
    """Density-velocity P13 (theta = -div v / (a H f))."""
    return _p13_core(ks, ks_tab, pk_tab, f13_dt, 252.0, n_q, qmin, qmax)


@on_device_of_inputs
def p13_tt(ks, ks_tab, pk_tab, n_q=1024, qmin=None, qmax=None):
    """Velocity-velocity P13 (normalization 1/84)."""
    return _p13_core(ks, ks_tab, pk_tab, f13_tt, 84.0, n_q, qmin, qmax)


def _panel_nodes(n_q, n_x, dev):
    """(tq, wq0, tx, wx): Gauss-Legendre nodes and weights on (0, 1) of
    the half outer (n_q / 2) and the inner (n_x) integrals, on ``dev``."""
    def make():
        t_np, w_np = leggauss_cached(n_q // 2)
        x_np, wx_np = leggauss_cached(n_x)
        return (0.5 * (t_np + 1.0), 0.5 * w_np, 0.5 * (x_np + 1.0),
                0.5 * wx_np)
    return on_device(f"spt_panel:{n_q}:{n_x}", dev, make)


def _split(ks, ks_tab, n_q, n_x, qmin, qmax, dev, r_max=None):
    """The panel nodes and per-k bounds (lo, mid, hi, yfl) of the
    P22-type integrals: the outer ln-q integral split at q = k (capped at
    r_max k when given) and the soft cutoff qmin/k on the |k-q| leg."""
    qmin, qmax = _qrange(ks_tab, qmin, qmax)
    nodes = _panel_nodes(n_q, n_x, dev)
    lo = torch.full(ks.shape, float(np.log(qmin)), dtype=_F64, device=dev)
    hi = torch.full(ks.shape, float(np.log(qmax)), dtype=_F64, device=dev)
    if r_max is not None:
        hi = torch.minimum(hi, torch.log(ks) + float(np.log(r_max)))
    mid = torch.clamp(torch.log(ks), lo, hi)
    yfl = qmin / ks
    return nodes, lo, mid, hi, yfl


def _chunked(panel, ks, lo, mid, hi, yfl, per_k):
    """panel(ks, lnlo, lnhi, yfl) summed over the two ln-q panels
    [lo, mid] and [mid, hi], over chunks of the k axis of at most
    PANEL_ELEMENTS / per_k ks (each k's value is independent of the
    chunking).  panel returns a tuple of (..., nk) tensors."""
    step = max(1, PANEL_ELEMENTS // per_k)
    parts = []
    for i in range(0, ks.shape[0], step):
        s = slice(i, i + step)
        a = panel(ks[s], lo[s], mid[s], yfl[s])
        b = panel(ks[s], mid[s], hi[s], yfl[s])
        parts.append(tuple(x + y for x, y in zip(a, b)))
    return tuple(torch.cat(xs, dim=-1) for xs in zip(*parts))


def _geometry(ks, lnk_tab, lnp_tab, lnlo, lnhi, tq, wq0, tx, wx, yfl):
    """The shared (k, ln q, ln y) panel geometry: (wq, Pq, r, y, y2, wy)
    with q on the outer nodes of [lnlo, lnhi] and y = |k - q|/k on ln-y
    nodes from max(|1 - r|, yfl) to 1 + r."""
    lnq = lnlo[:, None] + (lnhi - lnlo)[:, None] * tq[None, :]  # (nk,nq)
    wq = (lnhi - lnlo)[:, None] * wq0[None, :]
    q = torch.exp(lnq)
    Pq = _pk_eval(lnk_tab, lnp_tab, q)
    r = (q / ks[:, None])[..., None]                            # (nk,nq,1)
    ymin = torch.maximum(torch.abs(1.0 - r), yfl[:, None, None])
    lny = torch.log(ymin) + (torch.log(1.0 + r) - torch.log(ymin)) * tx
    wy = torch.log((1.0 + r) / ymin) * wx
    y = torch.exp(lny)
    return wq, Pq, r, y, y**2, wy


def _p22_panel(ks, lnk_tab, lnp_tab, lnlo, lnhi, tq, wq0, tx, wx, yfl):
    """One outer ln-q panel of the P22 double integral, (nk,)."""
    wq, Pq, r, y, y2, wy = _geometry(ks, lnk_tab, lnp_tab, lnlo, lnhi, tq,
                                     wq0, tx, wx, yfl)
    mu_num = (1.0 - r**2 - y2) / (2.0 * r)     # (x - r) at this y
    F2 = (5.0 / 7.0 + mu_num / (2.0 * y) * (r / y + y / r)
          + 2.0 / 7.0 * mu_num**2 / y2)
    Pky = _pk_eval(lnk_tab, lnp_tab, ks[:, None, None] * y)
    inner = torch.sum(wy * (y2 / r) * F2**2 * Pky, dim=-1)      # (nk,nq)
    return torch.sum(wq * Pq * r[..., 0] ** 3 * inner, dim=-1)


@on_device_of_inputs
def p22(ks, ks_tab, pk_tab, n_q=512, n_x=256, qmin=None, qmax=None):
    """P22(k): a dense (nk, n_q/2, n_x) Gauss-Legendre contraction per
    outer panel, the ln-q integral split at q = k."""
    pk_tab = torch.as_tensor(pk_tab, dtype=_F64)
    dev = pk_tab.device
    ks = f64(ks, dev)
    lnk_tab, lnp_tab = _tables(dev, ks_tab, pk_tab)
    nodes, lo, mid, hi, yfl = _split(ks, ks_tab, n_q, n_x, qmin, qmax, dev)

    def panel(k, a, b, fl):
        return (_p22_panel(k, lnk_tab, lnp_tab, a, b, *nodes, fl),)

    (outer,) = _chunked(panel, ks, lo, mid, hi, yfl, (n_q // 2) * n_x)
    return ks**3 / (2.0 * math.pi**2) * outer


def _velocity_kernels_panel(ks, lnk_tab, lnp_tab, lnlo, lnhi, tq, wq0,
                            tx, wx, yfl):
    """One outer ln-q panel of the mode-coupling integrals with kernels
    {F2^2, F2 G2, G2^2}, G2 = 3/7 + mu/2 (r/y + y/r) + 4/7 mu^2; (3, nk)."""
    wq, Pq, r, y, y2, wy = _geometry(ks, lnk_tab, lnp_tab, lnlo, lnhi, tq,
                                     wq0, tx, wx, yfl)
    mu_num = (1.0 - r**2 - y2) / (2.0 * r)
    cross = mu_num / (2.0 * y) * (r / y + y / r)
    mu2 = mu_num**2 / y2
    F2 = 5.0 / 7.0 + cross + 2.0 / 7.0 * mu2
    G2 = 3.0 / 7.0 + cross + 4.0 / 7.0 * mu2
    Pky = _pk_eval(lnk_tab, lnp_tab, ks[:, None, None] * y)
    base = wy * (y2 / r) * Pky
    kerns = torch.stack([F2 * F2, F2 * G2, G2 * G2])
    inner = torch.sum(kerns * base[None], dim=-1)               # (3,nk,nq)
    return torch.sum((wq * Pq * r[..., 0] ** 3)[None] * inner, dim=-1)


@on_device_of_inputs
def p22_velocity(ks, ks_tab, pk_tab, n_q=512, n_x=256, qmin=None,
                 qmax=None):
    """The three P22 mode-coupling spectra {dd, dt, tt}, (nk,) each, from
    one fused contraction (the kernels share the P evaluations)."""
    pk_tab = torch.as_tensor(pk_tab, dtype=_F64)
    dev = pk_tab.device
    ks = f64(ks, dev)
    lnk_tab, lnp_tab = _tables(dev, ks_tab, pk_tab)
    nodes, lo, mid, hi, yfl = _split(ks, ks_tab, n_q, n_x, qmin, qmax, dev)

    def panel(k, a, b, fl):
        return (_velocity_kernels_panel(k, lnk_tab, lnp_tab, a, b, *nodes,
                                        fl),)

    # the panel holds the stacked (3, nk, nq, nx) kernels
    (outer,) = _chunked(panel, ks, lo, mid, hi, yfl, 3 * (n_q // 2) * n_x)
    outer = ks[None, :] ** 3 / (2.0 * math.pi**2) * outer
    return {"dd": outer[0], "dt": outer[1], "tt": outer[2]}


@on_device_of_inputs
def pk_velocity_1loop(ks, ks_tab, pk_tab, n_q=512, n_x=256, n_q13=1024,
                      qmin=None, qmax=None):
    """One-loop density / velocity-divergence spectra
    P_ab = P_lin + P22_ab + P13_ab, ab in {dd, dt, tt} (theta =
    -div v/(aHf), so all three equal P_lin at tree level)."""
    pk_tab = torch.as_tensor(pk_tab, dtype=_F64)
    dev = pk_tab.device
    ks = f64(ks, dev)
    lnk_tab, lnp_tab = _tables(dev, ks_tab, pk_tab)
    Plin = _pk_eval(lnk_tab, lnp_tab, ks)
    P22s = p22_velocity(ks, ks_tab, pk_tab, n_q=n_q, n_x=n_x, qmin=qmin,
                        qmax=qmax)
    kw = dict(n_q=n_q13, qmin=qmin, qmax=qmax)
    return {"dd": Plin + P22s["dd"] + p13(ks, ks_tab, pk_tab, **kw),
            "dt": Plin + P22s["dt"] + p13_dt(ks, ks_tab, pk_tab, **kw),
            "tt": Plin + P22s["tt"] + p13_tt(ks, ks_tab, pk_tab, **kw)}


def _bias_kernels_panel(ks, lnk_tab, lnp_tab, lnlo, lnhi, tq, wq0, tx,
                        wx, yfl):
    """One outer ln-q panel of the five quadratic-bias integrals with
    kernels {F2, F2 S2, 1, S2, S2^2}, S2 = mu12^2 - 1/3; (5, nk)."""
    wq, Pq, r, y, y2, wy = _geometry(ks, lnk_tab, lnp_tab, lnlo, lnhi, tq,
                                     wq0, tx, wx, yfl)
    mu_num = (1.0 - r**2 - y2) / (2.0 * r)
    mu12 = mu_num / y
    F2 = (5.0 / 7.0 + mu_num / (2.0 * y) * (r / y + y / r)
          + 2.0 / 7.0 * mu_num**2 / y2)
    S2 = mu12**2 - 1.0 / 3.0
    Pky = _pk_eval(lnk_tab, lnp_tab, ks[:, None, None] * y)
    base = wy * (y2 / r) * Pky
    kerns = torch.stack([F2, F2 * S2, torch.ones_like(F2), S2, S2**2])
    inner = torch.sum(kerns * base[None], dim=-1)               # (5,nk,nq)
    return torch.sum((wq * Pq * r[..., 0] ** 3)[None] * inner, dim=-1)


@on_device_of_inputs
def pt_bias_integrals(ks, ks_tab, pk_tab, n_q=512, n_x=256,
                      qmin=None, qmax=None):
    """The five quadratic-bias one-loop integrals (McDonald-Roy basis,
    Beutler et al 2014 eqs 40-44): Pb2_d, Pbs2_d, and Pb22, Pb2s2, Pbs22
    with their k -> 0 constants subtracted.  Returns {name: (nk,)}."""
    pk_tab = torch.as_tensor(pk_tab, dtype=_F64)
    dev = pk_tab.device
    ks = f64(ks, dev)
    lnk_tab, lnp_tab = _tables(dev, ks_tab, pk_tab)
    qmin, qmax = _qrange(ks_tab, qmin, qmax)
    nodes, lo, mid, hi, yfl = _split(ks, ks_tab, n_q, n_x, qmin, qmax, dev)

    def panel(k, a, b, fl):
        return (_bias_kernels_panel(k, lnk_tab, lnp_tab, a, b, *nodes, fl),)

    (I,) = _chunked(panel, ks, lo, mid, hi, yfl, 5 * (n_q // 2) * n_x)
    I = I * ks[None, :] ** 3 / (4.0 * math.pi**2)
    # the separable renormalization constant int_q P(q)^2
    #   = (1/2 pi^2) int q^2 P^2 dq  (ln-q Gauss-Legendre)
    t2, w2 = leggauss_cached(n_q)
    lnq, wq = on_device(
        f"spt_bias_const:{n_q}:{qmin!r}:{qmax!r}", dev,
        lambda: (0.5 * (np.log(qmax) - np.log(qmin)) * (t2 + 1.0)
                 + np.log(qmin),
                 0.5 * (np.log(qmax) - np.log(qmin)) * w2))
    qq = torch.exp(lnq)
    Pq = _pk_eval(lnk_tab, lnp_tab, qq)
    const = torch.sum(wq * qq**3 * Pq**2) / (2.0 * math.pi**2)
    return {
        "Pb2_d": I[0],
        "Pbs2_d": I[1],
        "Pb22": 0.5 * (I[2] - const),
        "Pb2s2": 0.5 * (I[3] - 2.0 / 3.0 * const),
        "Pbs22": 0.5 * (I[4] - 4.0 / 9.0 * const),
    }


@on_device_of_inputs
def pgg_1loop(ks, ks_tab, pk_tab, b1, b2, bs2=None, shot=0.0,
              n_q=512, n_x=256, n_q13=1024, qmin=None, qmax=None):
    """One-loop galaxy auto power in the (b1, b2, bs2) Eulerian bias basis
    (Beutler et al 2014 eq 40); bs2 defaults to -(4/7)(b1 - 1)."""
    if bs2 is None:
        bs2 = -4.0 / 7.0 * (b1 - 1.0)
    Pmm = p1loop(ks, ks_tab, pk_tab, n_q=n_q, n_x=n_x, n_q13=n_q13,
                 qmin=qmin, qmax=qmax)
    t = pt_bias_integrals(ks, ks_tab, pk_tab, n_q=n_q, n_x=n_x,
                          qmin=qmin, qmax=qmax)
    return (b1**2 * Pmm + 2.0 * b1 * b2 * t["Pb2_d"]
            + 2.0 * b1 * bs2 * t["Pbs2_d"] + b2**2 * t["Pb22"]
            + 2.0 * b2 * bs2 * t["Pb2s2"] + bs2**2 * t["Pbs22"]
            + shot)


@on_device_of_inputs
def pgm_1loop(ks, ks_tab, pk_tab, b1, b2, bs2=None,
              n_q=512, n_x=256, n_q13=1024, qmin=None, qmax=None):
    """One-loop galaxy-matter cross power (Beutler et al 2014 eq 41):
    b1 P_mm^1loop + b2 Pb2_d + bs2 Pbs2_d."""
    if bs2 is None:
        bs2 = -4.0 / 7.0 * (b1 - 1.0)
    Pmm = p1loop(ks, ks_tab, pk_tab, n_q=n_q, n_x=n_x, n_q13=n_q13,
                 qmin=qmin, qmax=qmax)
    t = pt_bias_integrals(ks, ks_tab, pk_tab, n_q=n_q, n_x=n_x,
                          qmin=qmin, qmax=qmax)
    return b1 * Pmm + b2 * t["Pb2_d"] + bs2 * t["Pbs2_d"]


def split_wiggle(ks_tab, pk_tab, pk_nw_template, sigma_lnk=0.25):
    """(P_nw, P_w = P - P_nw): Gaussian smoothing in ln k of the ratio to
    a smooth template (the HMcode-2020 dewiggle), the smoothing matrix
    built on the host."""
    pk_tab = torch.as_tensor(pk_tab, dtype=_F64)
    dev = pk_tab.device
    lnk = np.log(host(ks_tab))

    def make():
        d = lnk[None, :] - lnk[:, None]
        S = np.exp(-0.5 * (d / sigma_lnk) ** 2)
        return (S / S.sum(axis=1, keepdims=True),)

    (S,) = on_device(f"spt_wiggle:{lnk.size}:{lnk[0]!r}:{lnk[-1]!r}:"
                     f"{sigma_lnk!r}", dev, make)
    tmpl = f64(pk_nw_template, dev)
    lnr = torch.log(pk_tab / tmpl)
    p_nw = tmpl * torch.exp(S @ lnr)
    return p_nw, pk_tab - p_nw


def bao_damping_sigma2(ks_tab, pk_nw, ell_bao, ks_sep=0.2, n_q=512):
    """Sigma^2 = (1/6 pi^2) int_0^{kS} dq P_nw(q) [1 - j0(q l) + 2 j2(q l)]
    [Mpc^2] (Blas-Garny-Ivanov-Sibiryakov 2016 eq. 3.5)."""
    pk_nw = torch.as_tensor(pk_nw, dtype=_F64)
    dev = pk_nw.device
    lnk_tab, lnp_tab = _tables(dev, ks_tab, pk_nw)
    t_np, w_np = leggauss_cached(n_q)
    lo, hi = np.log(float(host(ks_tab)[0])), np.log(ks_sep)
    lnq, wq = on_device(
        f"spt_bao:{n_q}:{lo!r}:{hi!r}", dev,
        lambda: (0.5 * (hi - lo) * (t_np + 1.0) + lo, 0.5 * (hi - lo) * w_np))
    q = torch.exp(lnq)
    x = q * ell_bao
    small = x < 1e-2
    xs = torch.where(small, 1.0, x)
    j0 = torch.where(small, 1.0 - x**2 / 6.0 + x**4 / 120.0,
                     torch.sin(xs) / xs)
    j2 = torch.where(small, x**2 / 15.0 - x**4 / 210.0,
                     (3.0 / xs**3 - 1.0 / xs) * torch.sin(xs)
                     - 3.0 * torch.cos(xs) / xs**2)
    kern = 1.0 - j0 + 2.0 * j2
    Pq = _pk_eval(lnk_tab, lnp_tab, q)
    return torch.sum(wq * q * Pq * kern) / (6.0 * math.pi**2)


@on_device_of_inputs
def p1loop_ir(ks, ks_tab, pk_tab, pk_nw_template, ell_bao,
              ks_sep=0.2, sigma_lnk=0.25, n_q=512, n_x=256, n_q13=1024,
              qmin=None, qmax=None, return_parts=False):
    """IR-resummed one-loop power (Blas et al 2016 eq. 4.7):

        P_IR = P_nw + e^{-k^2 Sigma^2} (1 + k^2 Sigma^2) P_w
               + [P22 + P13](P_nw + e^{-k^2 Sigma^2} P_w),

    equal to ``p1loop`` for a wiggle-free input.  ell_bao: the BAO scale
    in Mpc."""
    pk_tab = torch.as_tensor(pk_tab, dtype=_F64)
    dev = pk_tab.device
    ks = f64(ks, dev)
    p_nw, p_w = split_wiggle(ks_tab, pk_tab, pk_nw_template, sigma_lnk)
    Sigma2 = bao_damping_sigma2(ks_tab, p_nw, ell_bao, ks_sep)
    ks_tab_t = f64(ks_tab, dev)
    damp_tab = torch.exp(-ks_tab_t**2 * Sigma2)
    p_in = p_nw + damp_tab * p_w
    loops = (p22(ks, ks_tab, p_in, n_q=n_q, n_x=n_x, qmin=qmin,
                 qmax=qmax)
             + p13(ks, ks_tab, p_in, n_q=n_q13, qmin=qmin, qmax=qmax))
    lnk_tab = torch.log(ks_tab_t)
    Pnw_k = _pk_eval(lnk_tab, torch.log(p_nw), ks)
    # the wiggle part can be negative: interpolate the ratio linearly
    w_ratio = linear_interp(torch.log(ks), lnk_tab, p_w / p_nw)
    k2S2 = ks**2 * Sigma2
    P_ir = Pnw_k * (1.0 + torch.exp(-k2S2) * (1.0 + k2S2) * w_ratio) + loops
    if return_parts:
        return P_ir, {"p_nw": Pnw_k, "sigma2": Sigma2, "loops": loops,
                      "w_ratio": w_ratio}
    return P_ir


@on_device_of_inputs
def p1loop(ks, ks_tab, pk_tab, n_q=512, n_x=256, n_q13=1024,
           qmin=None, qmax=None, return_parts=False):
    """One-loop SPT matter power P_lin + P22 + P13 at the table's redshift
    (pass P_lin(k, z))."""
    pk_tab = torch.as_tensor(pk_tab, dtype=_F64)
    dev = pk_tab.device
    ks = f64(ks, dev)
    lnk_tab, lnp_tab = _tables(dev, ks_tab, pk_tab)
    Plin = _pk_eval(lnk_tab, lnp_tab, ks)
    P22 = p22(ks, ks_tab, pk_tab, n_q=n_q, n_x=n_x, qmin=qmin, qmax=qmax)
    P13 = p13(ks, ks_tab, pk_tab, n_q=n_q13, qmin=qmin, qmax=qmax)
    total = Plin + P22 + P13
    if return_parts:
        return total, {"lin": Plin, "p22": P22, "p13": P13}
    return total
