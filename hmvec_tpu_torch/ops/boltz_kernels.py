"""The Boltzmann group's two serial integrators: hand-written CUDA for
Hopper (csrc/boltz_kernels.cu), their plain PyTorch versions, and the
wrappers that choose between them.

* ``recomb_rk4(tab, saha_next, xe0, dx)``: the x_e recurrence of
  ``models.recomb.recombination`` -- RK4 on the Peebles branch, the Saha
  value where the step starts in equilibrium -- over tables of its x-only
  coefficients (``recomb.recomb_tables``).  Replaces the ``lax.scan`` of
  hmvec_tpu/models/recomb.py:190.
* ``hierarchy_rk4(xtab, ks, consts, s0, dx, n_outer, n_inner, store)``:
  n_outer x n_inner RK4 steps of the Einstein-Boltzmann hierarchy of
  ``models.boltzlite`` for each k, the tight-coupling or the full
  right-hand side chosen per sub-step, the slaved multipoles set after
  each tight-coupled step, the state after each outer block kept on
  request.  The x-only quantities at every sub-point come from ``xtab``
  (``boltzlite._x_table``); each row adds only its k-dependent parts.
  Replaces the ``lax.scan`` / ``fori_loop`` of
  hmvec_tpu/models/boltzlite.py:540-553, vmapped at :624.

Neither replaces a Pallas kernel (the JAX package has none here): they
exist because the loops, written step by step in eager PyTorch, would
launch ~10^8 kernels per call.

A wrapper given CUDA tensors launches its kernel (building the library at
first use, kernels/_build.py) or raises; given CPU tensors it computes the
plain version.  There is no fallback between the two.  Nothing here is
differentiated (the JAX package's solves return host arrays), so a tensor
that requires grad is refused.  Each wrapper counts the launches of its
kernel in ``<wrapper>.launches``.

This module also holds the hierarchy's right-hand sides on x-only
quantities (``rhs_full``, ``rhs_tc``, ``with_slaved``, ``metric``), the
arithmetic of the JAX package's ``_rhs_full`` / ``_rhs_tc`` /
``_with_slaved`` / ``_common_metric`` in its own order of operations:
the plain integrator evaluates them with each sub-point's x-only values
as Python floats and the k-dependent parts as tensors over the rows, and
``boltzlite.compute_sources`` with tensors over the stored (k, x) grid.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .nfw_kernels import _raise_on_error, _stream

_F64 = torch.float64
_MAX = 2**31 - 1

# state layout: [Phi, dc, vc, db, vb, Th0..Th8, ThP0..ThP8, N0..N8, dn, vn]
L = 8                        # hierarchy truncation for photons/pol/neutrinos
NTH = L + 1
I_PHI, I_DC, I_VC, I_DB, I_VB = 0, 1, 2, 3, 4
I_TH = 5
I_THP = I_TH + NTH
I_N = I_THP + NTH
I_NM = I_N + NTH             # massive-nu fluid: delta, v
NSTATE = I_NM + 2
# the x-only table's columns (csrc/boltz_kernels.cu kXCols); "tcx" is the
# x-only half of the tight-coupling test, 1.0 or 0.0
XCOLS = ("a", "hp", "taux", "tauxx", "dlnhp", "eta", "rho_nu", "w_nu",
         "cg2", "tcx")
# the recombination table's columns (csrc/boltz_kernels.cu kRecCols)
RECCOLS = ("nh", "hs", "lya", "nha2", "beta", "beta2", "use")
LAMBDA_2S1S = 8.227


class Consts(NamedTuple):
    """The hierarchy's cosmology constants (floats or 0-d tensors)."""

    h0m: object      # H0/c in 1/Mpc
    omg: object      # photon density parameter
    omnu: object     # massless-neutrino density parameter
    omb: object
    omc: object
    h0m_d: object = None   # h0m as a tensor where h0m is a float

# The divisors of the right-hand sides that are x-only, by name: every
# division of the right-hand sides takes a tensor on each side, so that it
# is one correctly rounded division on either device (a Python number as
# divisor lets the card's division multiply by its reciprocal, and a
# number divided by a tensor is a reciprocal times the number on both).
DIVISORS = ("hp_d", "hptaux_d", "one_w_d", "one_rb_d", "qden_d")


def divisors(c, q):
    """The x-only divisors of the right-hand sides from the sub-point
    values q (floats or tensors), in DIVISORS' order, with the JAX
    package's arithmetic: H_p, H_p tau_x, 1 + w_nu, 1 + R_b and the
    tight-coupling slip's denominator (1 + R_b) tau_x + dlnH_p/dx - 1."""
    rb = 4.0 * c.omg / (3.0 * c.omb * q["a"])
    return (q["hp"], q["hp"] * q["taux"], 1.0 + q["w_nu"], 1.0 + rb,
            (1.0 + rb) * q["taux"] + q["dlnhp"] - 1.0)


def with_divisors(c, q):
    """q with its DIVISORS entries (tensor sub-point values)."""
    return {**q, **dict(zip(DIVISORS, divisors(c, q)))}


_LIT: dict = {}


def _top(hp, eta):
    """(L + 1) / (H_p eta), the truncation coefficient (a true division
    where H_p eta is a tensor)."""
    if isinstance(hp, torch.Tensor):
        return _lit(L + 1.0, hp.device) / (hp * eta)
    return (L + 1) / (hp * eta)


def _lit(value: float, device):
    """The number as a float64 0-d tensor on ``device`` (a divisor)."""
    key = (value, device)
    if key not in _LIT:
        _LIT[key] = torch.tensor(value, dtype=_F64, device=device)
    return _LIT[key]


def _ipow2(x):
    return x * x


def _last(t):
    """t broadcast against a trailing multipole axis."""
    return t[..., None] if isinstance(t, torch.Tensor) else t


# --- the right-hand sides -------------------------------------------------

def metric(c, q, k, s, v=None):
    """(Psi, Phi', Hp, ck/Hp): Psi from the anisotropic stress, Phi' from
    the momentum constraint (the JAX package's _psi_of and
    _common_metric).  v: s.unbind(-1), where the caller has it."""
    v = s.unbind(-1) if v is None else v
    a, hp = q["a"], q["hp"]
    ckh = k / q["hp_d"]
    h0m = c.h0m if c.h0m_d is None else c.h0m_d
    psi = -v[I_PHI] - 12.0 * _ipow2(h0m / (k * a)) * (
        c.omg * v[I_TH + 2] + c.omnu * v[I_N + 2])
    a2 = _ipow2(a)
    dphi = (psi + 1.5 * _ipow2(c.h0m / hp) * (q["hp_d"] / k)
            * (c.omc / a * v[I_VC] + c.omb / a * v[I_VB]
               - 4.0 * c.omg / a2 * v[I_TH + 1]
               - 4.0 * c.omnu / a2 * v[I_N + 1]
               + q["rho_nu"] * (1.0 + q["w_nu"]) * a2 * v[I_NM + 1]))
    return psi, dphi, hp, ckh


_CONST: dict = {}


def _coef_vectors(device):
    """l, l + 1 and 2l + 1 for l = 2..L-1 as float64 tensors on
    ``device``."""
    if device not in _CONST:
        ell = torch.arange(2, L, dtype=_F64, device=device)
        _CONST[device] = (ell, ell + 1.0, 2.0 * ell + 1.0)
    return _CONST[device]


def _couplings(ckh):
    """(ck l / (2l+1), ck (l+1) / (2l+1)) for l = 2..L-1, (..., L-2)."""
    ell, ellp, den = _coef_vectors(ckh.device)
    ck = ckh[..., None]
    return ck * ell / den, ck * ellp / den


def hierarchy(cpl, ckh, vals, ctop):
    """d/dx of multipoles 2..L of hierarchies vals (..., m, L+1) without
    the Thomson term: (l = 2..L-1 (..., m, L-2), l = L (..., m)), the
    free-streaming couplings (cpl from ``_couplings``) and the open
    truncation at l = L (Callin eq. 32)."""
    ca, cb = (c[..., None, :] for c in cpl)
    d = ca * vals[..., 1:L - 1] - cb * vals[..., 3:]
    top = ckh[..., None] * vals[..., L - 1] - _last(ctop) * vals[..., L]
    return d, top


def _photon_hierarchies(cpl, ckh, th, taux, pi_eq, ctop):
    """Multipoles 2..L of the photon temperature and polarization
    hierarchies (th: (..., 2, L+1)), with the Thomson term (Pi/10 at
    l = 2): (..., 2, L-1)."""
    d, top = hierarchy(cpl, ckh, th, ctop)
    scat = th[..., 2:L].clone()
    scat[..., 0] -= (pi_eq / _lit(10.0, th.device))[..., None]
    tx = taux[..., None, None] if isinstance(taux, torch.Tensor) else taux
    d = d + tx * scat
    top = top + _last(taux) * th[..., L]
    return torch.cat([d, top[..., None]], dim=-1)


def _neutrinos(q, s, v, psi, dphi, ckh, cpl, ckh3, ckh23, ctop):
    """[dN0, dN1, dN2..NL, d dn, d vn]: the massless neutrinos and the
    massive-nu fluid (the JAX package's _nu_fluid_derivs), (..., 11)."""
    d, top = hierarchy(cpl, ckh, s[..., None, I_N:I_N + NTH], ctop)
    w, cg2 = q["w_nu"], q["cg2"]
    dn, vn = v[I_NM], v[I_NM + 1]
    ddn = (1.0 + w) * (ckh * vn - 3.0 * dphi) - 3.0 * (cg2 - w) * dn
    dvn = -(1.0 - 3.0 * cg2) * vn - ckh * (cg2 * dn / q["one_w_d"] + psi)
    return torch.cat([torch.stack([-ckh * v[I_N + 1] - dphi,
                                   ckh3 * (v[I_N] + psi)
                                   - ckh23 * v[I_N + 2]], -1),
                      d[..., 0, :], top, torch.stack([ddn, dvn], -1)],
                     dim=-1)


def rhs_full(c, q, k, s):
    """The full (post-tight-coupling) Einstein-Boltzmann right-hand side,
    d/dx, (..., NSTATE)."""
    v = s.unbind(-1)
    psi, dphi, hp, ckh = metric(c, q, k, s, v)
    a, taux, eta = q["a"], q["taux"], q["eta"]
    ctop = _top(hp, eta)
    th0, th1, th2 = v[I_TH], v[I_TH + 1], v[I_TH + 2]
    thp0, thp1, thp2 = v[I_THP], v[I_THP + 1], v[I_THP + 2]
    pi_eq = th2 + thp0 + thp2
    vc, vb = v[I_VC], v[I_VB]
    cpl = _couplings(ckh)
    three = _lit(3.0, s.device)
    ckh3 = ckh / three
    ckh23 = 2.0 * ckh / three
    cpsi = ckh * psi
    dphi3 = 3.0 * dphi
    rb = 4.0 * c.omg / (3.0 * c.omb * a)
    hi = _photon_hierarchies(
        cpl, ckh, s[..., I_TH:I_N].unflatten(-1, (2, NTH)), taux, pi_eq,
        ctop)
    head = torch.stack([
        dphi, ckh * vc - dphi3, -vc - cpsi, ckh * vb - dphi3,
        -vb - cpsi + taux * rb * (3.0 * th1 + vb),
        -ckh * th1 - dphi,
        ckh3 * (th0 + psi) - ckh23 * th2 + taux * (th1 + vb / three),
    ], dim=-1)
    dthp01 = torch.stack([
        -ckh * thp1 + taux * (thp0 - pi_eq / _lit(2.0, s.device)),
        ckh3 * thp0 - ckh23 * thp2 + taux * thp1], dim=-1)
    return torch.cat([head, hi[..., 0, :], dthp01, hi[..., 1, :],
                      _neutrinos(q, s, v, psi, dphi, ckh, cpl, ckh3, ckh23,
                                 ctop)], dim=-1)


def slaved_multipoles(q, k, th1):
    """Tight-coupling algebraic multipoles from Theta_1: (Theta_2..L,
    ThetaP_0..L), (..., L-1) and (..., L+1); each multipole above l = 2
    is the one below times -(l / (2l+1)) ck/(Hp tau_x)."""
    ckhti = k / q["hptaux_d"]
    th2 = -(8.0 / 15.0) * ckhti * th1
    cl = [-(ell / (2.0 * ell + 1.0)) * ckhti for ell in range(3, NTH)]
    ths = [th2]
    for c_l in cl:
        ths.append(c_l * ths[-1])
    thps = [1.25 * th2, -0.25 * ckhti * th2, 0.25 * th2]
    for c_l in cl:
        thps.append(c_l * thps[-1])
    return torch.stack(ths, -1), torch.stack(thps, -1)


def with_slaved(q, k, s):
    """s with Theta_2..L and the polarization multipoles slaved."""
    ths, thps = slaved_multipoles(q, k, s[..., I_TH + 1])
    return torch.cat([s[..., :I_TH + 2], ths, thps, s[..., I_N:]], dim=-1)


def rhs_tc(c, q, k, s):
    """The tight-coupling right-hand side (Callin eqs. 70-71 slip
    expansion): the slaved multipoles' derivatives are 0."""
    s = with_slaved(q, k, s)
    v = s.unbind(-1)
    psi, dphi, hp, ckh = metric(c, q, k, s, v)
    a, taux, tauxx, dlnhp = q["a"], q["taux"], q["tauxx"], q["dlnhp"]
    ctop = _top(hp, q["eta"])
    th0, th1, th2 = v[I_TH], v[I_TH + 1], v[I_TH + 2]
    vb, vc = v[I_VB], v[I_VC]
    rb = 4.0 * c.omg / (3.0 * c.omb * a)
    cpsi = ckh * psi
    dphi3 = 3.0 * dphi
    dth0 = -ckh * th1 - dphi
    slip = -th0 + 2.0 * th2
    qq = (-((1.0 - 2.0 * rb) * taux + (1.0 + rb) * tauxx) * (3.0 * th1 + vb)
          - cpsi
          + (1.0 - dlnhp) * ckh * slip
          - ckh * dth0) / q["qden_d"]
    dvb = (-vb - cpsi + rb * (qq + ckh * slip - cpsi)) / q["one_rb_d"]
    three = _lit(3.0, s.device)
    head = torch.stack([dphi, ckh * vc - dphi3, -vc - cpsi,
                        ckh * vb - dphi3, dvb, dth0, (qq - dvb) / three], -1)
    zeros = torch.zeros(head.shape[:-1] + (2 * NTH - 2,), dtype=head.dtype,
                        device=head.device)
    return torch.cat([head, zeros,
                      _neutrinos(q, s, v, psi, dphi, ckh, _couplings(ckh),
                                 ckh / three, 2.0 * ckh / three, ctop)],
                     dim=-1)


def tc_active(q, k):
    """Tight coupling while |tau_x| exceeds both 10 and 10 k/Hp, before
    recombination begins (the x-only half is the table's "tcx")."""
    tcx = q["tcx"]
    if isinstance(tcx, torch.Tensor):
        tcx = tcx != 0.0
    return tcx & (abs(q["taux"]) > 10.0 * k / q["hp_d"])


# --- plain versions -------------------------------------------------------

@torch.inference_mode()
def recomb_rk4_plain(tab, saha_next, xe0, dx: float):
    """x_e (batch, nsteps + 1): the recurrence in PyTorch, one step after
    another over the batch.  The Saha switches are read once from the
    table: a step that starts in Saha equilibrium in every row takes the
    Saha value without the RK4 stages it would discard, and a sub-point
    where no row is in equilibrium skips the select."""
    nsteps = saha_next.shape[1]
    half = 0.5 * dx
    sixth = dx / 6.0
    steps = tab.permute(1, 2, 3, 0).unbind(0)     # nsteps x (3, 7, batch)
    use = tab[..., 6] != 0.0
    use_all, use_any = use.all(0).tolist(), use.any(0).tolist()
    sn = saha_next.t().unbind(0)

    def rate(xe, p, saha):
        nh, hs, lya, nha2, beta, beta2, flag = p.unbind(0)
        one_m = 1.0 - xe
        lam = lya / torch.clamp_min(one_m * nh, 1e-30)
        cr = (LAMBDA_2S1S + lam) / (LAMBDA_2S1S + lam + beta2)
        pee = cr * (beta * one_m - nha2 * (xe * xe)) / hs
        return torch.where(flag != 0.0, 0.0, pee) if saha else pee

    xe = xe0
    out = [xe]
    for i in range(nsteps):
        if use_all[i][0]:
            xe = sn[i]
        else:
            p, saha = steps[i], use_any[i]
            k1 = rate(xe, p[0], saha[0])
            k2 = rate(xe + half * k1, p[1], saha[1])
            k3 = rate(xe + half * k2, p[1], saha[1])
            k4 = rate(xe + dx * k3, p[2], saha[2])
            xe = xe + sixth * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
            if saha[0]:
                xe = torch.where(p[0, 6] != 0.0, sn[i], xe)
        out.append(xe)
    return torch.stack(out, dim=-1)


def _f_plain(c, q, k, s, tc):
    """f(x, s) at one sub-point for the plain integrator: tc is True,
    False or a row mask."""
    if tc is True:
        return rhs_tc(c, q, k, s)
    if tc is False:
        return rhs_full(c, q, k, s)
    return torch.where(tc[:, None], rhs_tc(c, q, k, s), rhs_full(c, q, k, s))


def _tc_plain(q, k, kmin, kmax):
    """The tight-coupling switch at a sub-point of Python floats: True or
    False where every row agrees (the test is monotone in k, so the
    smallest and largest k decide), else the row mask."""
    if q["tcx"] == 0.0:
        return False
    taux = abs(q["taux"])
    if taux > 10.0 * kmax / q["hp"]:
        return True
    if not taux > 10.0 * kmin / q["hp"]:
        return False
    return taux > 10.0 * k / q["hp_d"]


@torch.inference_mode()
def hierarchy_rk4_plain(xtab, ks, consts, s0, dx: float, n_outer: int,
                        n_inner: int, store: bool):
    """(s_end (rows, NSTATE), stored (rows, n_outer, NSTATE) or None): the
    segment in PyTorch, one step after another over the rows, each
    sub-point's x-only values read once from the table as Python floats
    (under inference mode: a step is some 600 small operations, and
    nothing here is differentiated)."""
    c = Consts(*consts.tolist(), h0m_d=consts[0])
    rows = [[dict(zip(XCOLS, sub)) for sub in step] for step in xtab.tolist()]
    # the x-only divisors of every sub-point as 0-d tensors on the rows'
    # device, from the table at once
    xq = dict(zip(XCOLS, xtab.unbind(-1)))
    div = torch.stack(divisors(Consts(*consts.unbind(0)), xq), dim=-1)
    for step, dsteps in zip(rows, div.unbind(0)):
        for sub, dsub in zip(step, dsteps.unbind(0)):
            sub.update(zip(DIVISORS, dsub.unbind(0)))
    klist = ks.tolist()
    kmin, kmax = min(klist), max(klist)
    half = 0.5 * dx
    sixth = dx / 6.0
    s = s0
    kept = []
    for io in range(n_outer):
        for j in range(n_inner):
            q0, q1, q2 = rows[io * n_inner + j]
            tc1 = _tc_plain(q1, ks, kmin, kmax)
            k1 = _f_plain(c, q0, ks, s, _tc_plain(q0, ks, kmin, kmax))
            k2 = _f_plain(c, q1, ks, s + half * k1, tc1)
            k3 = _f_plain(c, q1, ks, s + half * k2, tc1)
            tc2 = _tc_plain(q2, ks, kmin, kmax)
            k4 = _f_plain(c, q2, ks, s + dx * k3, tc2)
            s = s + sixth * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
            if tc2 is True:
                s = with_slaved(q2, ks, s)
            elif tc2 is not False:
                s = torch.where(tc2[:, None], with_slaved(q2, ks, s), s)
        if store:
            kept.append(s)
    return s, (torch.stack(kept, dim=1) if store else None)


# --- wrappers -------------------------------------------------------------

def _check(tensors, device=None):
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dtype != _F64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.requires_grad:
            raise ValueError(f"{name} requires grad: the Boltzmann "
                             "integrators are not differentiable")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def _contiguous(tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on CUDA")


def recomb_rk4(tab, saha_next, xe0, dx: float):
    """x_e (batch, nsteps + 1) from the tables of ``recomb.recomb_tables``
    with a leading batch axis -- tab (batch, nsteps, 3, 7), saha_next
    (batch, nsteps), xe0 (batch,) -- and the step dx: one launch of the
    kernel on the card (one block a cosmology: the Saha steps written in
    parallel, one thread integrating the Peebles runs), the plain version
    on the CPU."""
    dev = _check({"tab": tab, "saha_next": saha_next, "xe0": xe0})
    if tab.dim() != 4 or tab.shape[2:] != (3, len(RECCOLS)):
        raise ValueError(f"tab must be (batch, nsteps, 3, {len(RECCOLS)}), "
                         f"got {tuple(tab.shape)}")
    batch, nsteps = tab.shape[:2]
    if tuple(saha_next.shape) != (batch, nsteps) or \
            tuple(xe0.shape) != (batch,):
        raise ValueError("saha_next must be (batch, nsteps) and xe0 "
                         "(batch,)")
    if not isinstance(dx, float):
        raise TypeError("dx must be a Python float")
    if dev.type == "cpu":
        return recomb_rk4_plain(tab, saha_next, xe0, dx)
    from ..kernels._build import load_library

    _contiguous({"tab": tab, "saha_next": saha_next, "xe0": xe0})
    if batch * (nsteps + 1) > _MAX or nsteps * 21 > _MAX:
        raise ValueError("recomb_rk4: the table is too large")
    out = torch.empty((batch, nsteps + 1), dtype=_F64, device=dev)
    if batch == 0:
        return out
    err = load_library().hmvec_recomb_rk4(
        tab.data_ptr(), saha_next.data_ptr(), xe0.data_ptr(), dx, nsteps,
        batch, out.data_ptr(), dev.index, _stream(tab))
    _raise_on_error(err, "recomb_rk4")
    recomb_rk4.launches += 1
    return out


def hierarchy_rk4(xtab, ks, consts, s0, dx: float, n_outer: int,
                  n_inner: int, store: bool = True):
    """n_outer x n_inner RK4 steps of the hierarchy from s0 (rows, NSTATE)
    for the rows' k (rows,), on the x-only table xtab (n_outer n_inner,
    3, len(XCOLS)) of ``boltzlite._x_table`` and consts (5,) =
    (H0/c, Omega_gamma, Omega_nu, Omega_b, Omega_c): (s_end (rows,
    NSTATE), the state after each outer block (rows, n_outer, NSTATE) if
    ``store`` else None).  One launch of the kernel on the card (a warp a
    k, a lane a state component), the plain version on the CPU."""
    dev = _check({"xtab": xtab, "ks": ks, "consts": consts, "s0": s0})
    nsteps = n_outer * n_inner
    if xtab.shape != (nsteps, 3, len(XCOLS)):
        raise ValueError(f"xtab must be ({nsteps}, 3, {len(XCOLS)}), got "
                         f"{tuple(xtab.shape)}")
    rows = ks.shape[0]
    if ks.dim() != 1 or s0.shape != (rows, NSTATE) or consts.shape != (5,):
        raise ValueError("ks must be (rows,), s0 (rows, NSTATE) and "
                         "consts (5,)")
    if not isinstance(dx, float):
        raise TypeError("dx must be a Python float")
    if dev.type == "cpu":
        return hierarchy_rk4_plain(xtab, ks, consts, s0, dx, n_outer,
                                   n_inner, store)
    from ..kernels._build import load_library

    _contiguous({"xtab": xtab, "ks": ks, "consts": consts, "s0": s0})
    if rows * max(n_outer, 1) * NSTATE > _MAX:
        raise ValueError("hierarchy_rk4: too many rows x outer steps")
    s_end = torch.empty((rows, NSTATE), dtype=_F64, device=dev)
    kept = (torch.empty((rows, n_outer, NSTATE), dtype=_F64, device=dev)
            if store else None)
    if rows == 0 or nsteps == 0:
        return s0.clone(), kept
    err = load_library().hmvec_hierarchy_rk4(
        xtab.data_ptr(), ks.data_ptr(), consts.data_ptr(), s0.data_ptr(),
        dx, n_outer, n_inner, rows, s_end.data_ptr(),
        kept.data_ptr() if store else None, dev.index, _stream(ks))
    _raise_on_error(err, "hierarchy_rk4")
    hierarchy_rk4.launches += 1
    return s_end, kept


recomb_rk4.launches = 0
hierarchy_rk4.launches = 0
