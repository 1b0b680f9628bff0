"""Halo-model bispectra (1-halo, 2-halo, 3-halo) of any registered tracer
triple and their flat-sky Limber projection, on float64 tensors (port of
hmvec_tpu/models/bispectrum.py):

  B_1h(k1,k2,k3) = int dm n(m) <T_1(k1) T_2(k2) T_3(k3)>
  B_2h(k1,k2,k3) = P(k1) I_1(t1;k1) I_2(t2,t3;k2,k3) + 2 cyc.
  B_3h(k1,k2,k3) = I_1(k1) I_1(k2) I_1(k3) B_tree(k1,k2,k3)
                   [+ I_1 I_1 Ib2 (P P + cyc.) with a second-order bias]

with I_1 the consistency-completed 2-halo leg of models/power.py, I_2 the
b1-weighted same-halo pair integral and B_tree the F2 tree bispectrum
(Scoccimarro-Sheth-Hui-Jain 2001; Lacasa 2018 for the projection).

Same-halo pairs and triples dispatch on tracer identity, as the JAX
package does: one HOD tracer with itself takes the factorial moments
(<Nc Ns(Ns-1)> = <NcNs><Ns>, <Ns(Ns-1)(Ns-2)> = <Ns(Ns-1)><Ns>), any two
CIB tracers count as one population (the central counted once), and
distinct tracers factorize.  A leg's terms are gathered at its per-z
wavenumbers (nz, nq) with the index broadcast over the mass axis, so a
batch of triangles is a few gathers and mass reductions, no Python loop
over configurations.
"""

from __future__ import annotations

import torch

from ..ops.quadrature import lerp_index, trapz_traced
from ..utils.weights import on_device_of_inputs, tensor_or_f64
from .power import CIBTracer, HODTracer, _leg, _mass_integral, _term

_F64 = torch.float64


# ---- geometry ---------------------------------------------------------------

def mu12_from_closure(k1, k2, k3):
    """cos(angle between vec k1, vec k2) from vec k3 = -(vec k1 + vec k2)."""
    return (k3**2 - k1**2 - k2**2) / (2.0 * k1 * k2)


def f2_kernel(k1, k2, k3):
    """Second-order SPT kernel F2(vec k1, vec k2) with the angle fixed by
    triangle closure (2/7 on the equilateral)."""
    mu = mu12_from_closure(k1, k2, k3)
    return (5.0 / 7.0
            + 0.5 * mu * (k1 / k2 + k2 / k1)
            + (2.0 / 7.0) * mu**2)


def tree_bispectrum(P1, P2, P3, k1, k2, k3):
    """Tree-level matter bispectrum 2 F2(ki, kj) P(ki) P(kj) + 2 cyc."""
    return 2.0 * (f2_kernel(k1, k2, k3) * P1 * P2
                  + f2_kernel(k2, k3, k1) * P2 * P3
                  + f2_kernel(k3, k1, k2) * P3 * P1)


# ---- second-order bias ------------------------------------------------------

def b2_sheth_torman(sigma2, params):
    """Second-order Eulerian bias from the peak-background split of the
    Sheth-Tormen multiplicity (Scoccimarro et al 2001 eq A6):

      e1 = (a nu^2 - 1)/dc,  e2 = (a nu^2/dc^2)(a nu^2 - 3),
      E1 = (2p/dc)/(1 + (a nu^2)^p),  E2 = E1 ((1+2p)/dc + 2 e1),
      b2 = (8/21)(e1 + E1) + e2 + E2."""
    a = params["st_a"]
    p = params["st_p"]
    dc = params["st_deltac"]
    anu2 = a * dc**2 / sigma2
    e1 = (anu2 - 1.0) / dc
    e2 = (anu2 / dc**2) * (anu2 - 3.0)
    E1 = (2.0 * p / dc) / (1.0 + anu2**p)
    E2 = E1 * ((1.0 + 2.0 * p) / dc + 2.0 * e1)
    return (8.0 / 21.0) * (e1 + E1) + e2 + E2


# ---- interpolation ----------------------------------------------------------

def _normalize_kq(kq, nz, dev):
    """A leg's wavenumbers as (nz, nq) on ``dev``: a scalar or (nq,) is
    shared across z, an (nz, nq) array is per z (k = (l + 1/2) / chi(z))."""
    kq = torch.atleast_1d(torch.as_tensor(kq, dtype=_F64, device=dev))
    if kq.dim() == 1:
        kq = kq[None, :].expand(nz, kq.shape[0])
    return kq


def _interp_zk(ks, F, kq):
    """(nz, nk) table -> (nz, nq) at per-z queries, linear in ln k,
    flat-clipped at the ends (limber.interp_pzk_at_curve's arithmetic)."""
    i, t = lerp_index(torch.log(ks), torch.log(kq))
    f0 = torch.gather(F, -1, i)
    f1 = torch.gather(F, -1, i + 1)
    return f0 + t * (f1 - f0)


def _interp_zmk(ks, T, kq):
    """(nz, nm, nk) tracer term -> (nz, nm, nq) at per-z queries (linear in
    ln k, flat-clipped): the (nz, 1, nq) index expanded over the mass axis,
    so one index per (z, q) whatever nm."""
    i, t = lerp_index(torch.log(ks), torch.log(kq))
    nz, nm = T.shape[0], T.shape[1]
    i = i[:, None, :].expand(nz, nm, i.shape[-1])
    t0 = torch.gather(T, -1, i)
    t1 = torch.gather(T, -1, i + 1)
    return t0 + t[:, None, :] * (t1 - t0)


# ---- legs -------------------------------------------------------------------

class _Leg:
    """One bispectrum leg: a tracer with its terms at this leg's per-z
    wavenumbers kq (nz, nq)."""

    def __init__(self, tracer, ms, rho_matter0, ks, kq):
        self.tracer = tracer
        self.kq = kq
        self.term = _interp_zmk(ks, _term(tracer, ms, rho_matter0), kq)
        if isinstance(tracer, HODTracer):
            self.us = _interp_zmk(ks, tracer.us, kq)
            self.uc = (1.0 if tracer.uc is None
                       else _interp_zmk(ks, tracer.uc, kq))
        elif isinstance(tracer, CIBTracer):
            self.us = _interp_zmk(ks, tracer.us, kq)
            # cross-frequency tuples mix fc / fs of different frequencies
            # but share one galaxy population
            self.fc = tracer.fc[..., None]
            self.fs = tracer.fs[..., None]


def _same_population(a: _Leg, b: _Leg) -> bool:
    """Whether two legs sample one galaxy population, so that same-halo
    self-pair exclusions apply: one tracer object, or any two CIB
    tracers."""
    return a.tracer is b.tracer or (isinstance(a.tracer, CIBTracer)
                                    and isinstance(b.tracer, CIBTracer))


def _pair_term(a: _Leg, b: _Leg):
    """Same-halo pair <T_a(ka) T_b(kb)>: power.one_halo_square_term at two
    wavenumbers (and, for CIB, two frequencies)."""
    t = a.tracer
    if t is b.tracer and isinstance(t, HODTracer):
        return (((a.uc * b.us + a.us * b.uc) * t.NcNs[..., None]
                 + a.us * b.us * t.NsNsm1[..., None])
                / t.ngal[..., None, None] ** 2)
    if isinstance(t, CIBTracer) and isinstance(b.tracer, CIBTracer):
        # the central self-pair (fc_a fc_b) is shot noise
        return (a.fc * b.fs * b.us + b.fc * a.fs * a.us
                + a.fs * b.fs * a.us * b.us)
    return a.term * b.term


def _triple_term(a: _Leg, b: _Leg, c: _Leg):
    """Same-halo triple <T_a(k1) T_b(k2) T_c(k3)> with the factorial-moment
    conventions of the module docstring."""
    t = a.tracer
    if t is b.tracer and t is c.tracer and isinstance(t, HODTracer):
        ncnsns = (t.NcNs * t.Ns)[..., None]
        ns3 = (t.NsNsm1 * t.Ns)[..., None]
        return ((a.uc * b.us * c.us + a.us * b.uc * c.us
                 + a.us * b.us * c.uc) * ncnsns
                + a.us * b.us * c.us * ns3) / t.ngal[..., None, None] ** 3
    if all(isinstance(x.tracer, CIBTracer) for x in (a, b, c)):
        # at most one leg is the central
        return (a.fc * b.fs * c.fs * b.us * c.us
                + b.fc * a.fs * c.fs * a.us * c.us
                + c.fc * a.fs * b.fs * a.us * b.us
                + a.fs * b.fs * c.fs * a.us * b.us * c.us)
    # one shared-population pair and a distinct third leg
    for (x, y, z) in ((a, b, c), (b, c, a), (c, a, b)):
        if _same_population(x, y) and not _same_population(x, z):
            return _pair_term(x, y) * z.term
    return a.term * b.term * c.term


def _leg_completed(tracer, nzm, bh, ms, ks, rho_matter0, kq, b_in=None):
    """The consistency-completed b1 leg I_1 = i + b - c on the native k
    grid, interpolated to the query legs."""
    i, c, b = _leg(tracer, nzm, bh, ms, rho_matter0)
    if b_in is not None:
        b = torch.as_tensor(b_in, dtype=_F64, device=nzm.device).reshape(-1, 1)
    return _interp_zk(ks, i + b - c, kq)


# ---- terms ------------------------------------------------------------------

def _make_legs(tracers, ms, ks, rho_matter0, k1, k2, k3, nz):
    dev = ks.device
    kqs = [_normalize_kq(k, nz, dev) for k in (k1, k2, k3)]
    legs = [_Leg(t, ms, rho_matter0, ks, kq) for t, kq in zip(tracers, kqs)]
    return legs, kqs


def _prep_pi1(ts, legs, kqs, nzm, bh, ms, ks, pzk_lin, rho_matter0, b_in):
    """The P(k) legs and completed I_1 legs that the 2-halo and 3-halo
    terms share, computed once per call."""
    P = [_interp_zk(ks, pzk_lin, kq) for kq in kqs]
    I1 = [_leg_completed(ts[i], nzm, bh, ms, ks, rho_matter0, kqs[i], b_in[i])
          for i in range(3)]
    return P, I1


def _b1h_from(legs, kqs, nzm, ms, kstar_damping):
    integral = _mass_integral(nzm[..., None] * _triple_term(*legs), ms)
    if kstar_damping:
        for kq in kqs:
            integral = integral * (1.0 - torch.exp(-((kq / kstar_damping)
                                                     ** 2)))
    return integral


def _b2h_from(legs, P, I1, nzm, bh, ms):
    w = (nzm * bh)[..., None]
    out = 0.0
    for i in range(3):
        j, l = (i + 1) % 3, (i + 2) % 3
        I2 = _mass_integral(w * _pair_term(legs[j], legs[l]), ms)
        out = out + P[i] * I1[i] * I2
    return out


def _b3h_from(legs, kqs, P, I1, nzm, ms, b2h):
    out = I1[0] * I1[1] * I1[2] * tree_bispectrum(
        P[0], P[1], P[2], kqs[0], kqs[1], kqs[2])
    if b2h is not None:
        w2 = (nzm * b2h)[..., None]
        for l in range(3):
            i, j = (l + 1) % 3, (l + 2) % 3
            Ib2 = _mass_integral(w2 * legs[l].term, ms)
            out = out + I1[i] * I1[j] * Ib2 * P[i] * P[j]
    return out


def _ks_on(ks, nzm):
    return torch.as_tensor(ks, dtype=_F64, device=nzm.device)


def bispectrum_1halo(t1, t2, t3, nzm, ms, ks, rho_matter0, k1, k2, k3,
                     kstar_damping=0.01):
    """B_1h(z; k1, k2, k3) = int dm n <T1(k1) T2(k2) T3(k3)>, damped below
    k* on each leg as power_1halo is.  Returns (nz, nq)."""
    ks = _ks_on(ks, nzm)
    legs, kqs = _make_legs((t1, t2, t3), ms, ks, rho_matter0, k1, k2, k3,
                           nzm.shape[0])
    return _b1h_from(legs, kqs, nzm, ms, kstar_damping)


def bispectrum_2halo(t1, t2, t3, nzm, bh, ms, ks, pzk_lin, rho_matter0,
                     k1, k2, k3, b_in=(None, None, None)):
    """B_2h = P(k1) I_1(t1; k1) I_2(t2, t3; k2, k3) + 2 cyclic, I_2 =
    int dm n b <T_a(ka) T_b(kb)> the b1-weighted same-halo pair."""
    ks = _ks_on(ks, nzm)
    ts = (t1, t2, t3)
    legs, kqs = _make_legs(ts, ms, ks, rho_matter0, k1, k2, k3, nzm.shape[0])
    P, I1 = _prep_pi1(ts, legs, kqs, nzm, bh, ms, ks, pzk_lin, rho_matter0,
                      b_in)
    return _b2h_from(legs, P, I1, nzm, bh, ms)


def bispectrum_3halo(t1, t2, t3, nzm, bh, ms, ks, pzk_lin, rho_matter0,
                     k1, k2, k3, b_in=(None, None, None), b2h=None):
    """B_3h = I_1(k1) I_1(k2) I_1(k3) B_tree, plus, with ``b2h`` (a second-
    order halo bias on the (z, m) grid, e.g. b2_sheth_torman), the local-
    bias term I_1(ki) I_1(kj) Ib2(kl) P(ki) P(kj) + cyc., Ib2 = int dm n b2
    T without consistency completion."""
    ks = _ks_on(ks, nzm)
    ts = (t1, t2, t3)
    legs, kqs = _make_legs(ts, ms, ks, rho_matter0, k1, k2, k3, nzm.shape[0])
    P, I1 = _prep_pi1(ts, legs, kqs, nzm, bh, ms, ks, pzk_lin, rho_matter0,
                      b_in)
    return _b3h_from(legs, kqs, P, I1, nzm, ms, b2h)


def bispectrum_total(t1, t2, t3, nzm, bh, ms, ks, pzk_lin, rho_matter0,
                     k1, k2, k3, kstar_damping=0.01,
                     b_in=(None, None, None), b2h=None):
    """1h + 2h + 3h, with the legs, the P(k) legs and the I_1 mass
    integrals computed once for the three terms."""
    ks = _ks_on(ks, nzm)
    ts = (t1, t2, t3)
    legs, kqs = _make_legs(ts, ms, ks, rho_matter0, k1, k2, k3, nzm.shape[0])
    P, I1 = _prep_pi1(ts, legs, kqs, nzm, bh, ms, ks, pzk_lin, rho_matter0,
                      b_in)
    return (_b1h_from(legs, kqs, nzm, ms, kstar_damping)
            + _b2h_from(legs, P, I1, nzm, bh, ms)
            + _b3h_from(legs, kqs, P, I1, nzm, ms, b2h))


# ---- projection -------------------------------------------------------------

@on_device_of_inputs
def projected_bispectrum(ells1, ells2, ells3, zs, hzs, chis,
                         Wz1s, Wz2s, Wz3s, B_fn):
    """Flat-sky Limber reduced bispectrum in limber_integral's window
    convention,

      b(l1, l2, l3) = int dz H^2 W1 W2 W3 / chi^4 B(k_i = (l_i + 1/2)/chi),

    B_fn mapping three (nz, nl) leg-wavenumber tensors to B(z, l); the ell
    triplets broadcast to one (nl,) shape, a window None is unity."""
    chis, hzs = tensor_or_f64(chis), tensor_or_f64(hzs)
    dev = chis.device
    e1, e2, e3 = torch.broadcast_tensors(*(
        torch.atleast_1d(torch.as_tensor(e, dtype=_F64, device=dev))
        for e in (ells1, ells2, ells3)))
    zs = torch.as_tensor(zs, dtype=_F64, device=dev)
    kq = [(e[None, :] + 0.5) / chis[:, None] for e in (e1, e2, e3)]
    B = B_fn(*kq)                                    # (nz, nl)
    ones = torch.ones_like(zs)
    W = [ones if w is None else torch.as_tensor(w, dtype=_F64, device=dev)
         for w in (Wz1s, Wz2s, Wz3s)]
    pre = hzs**2 * W[0] * W[1] * W[2] / chis**4      # (nz,)
    return trapz_traced(pre[:, None] * B, zs, axis=0)
