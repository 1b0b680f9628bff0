"""Emulate hierarchy_rk4_kernel's lane program (K7, a warp a k) in PyTorch
on the CPU.

hmvec_tpu_torch/csrc/boltz_kernels.cu evaluates each component's
derivative on its own lane through one template, (A X - B Y) + C (G W + E)
with E = P / D, whose operands each lane picks by its role, the missing
terms of a component standing in as exact identities (x + -0, x - 0 * 0,
x + -0 * (0 + -0), x * 1).  This repeats that program operation for
operation, with every quantity held on all 32 lanes of every row ((rows,
32) tensors; a shuffle is an index, a role a code per lane).  A division
here is PyTorch's IEEE division, where the kernel multiplies by the
divisor's reciprocal and corrects twice by FMA (div_rcp), which rounds as
the division does.  So that:

* run as a script, it holds the emulation against
  ``hierarchy_rk4_plain`` bit for bit (``torch.equal``) for 8 k (1e-4 to
  0.1, the Fermi-Dirac background) from x = -18 to -5.2 in three
  segments, through the end of tight coupling: a wrong role or a lost
  identity shows here, before a chip run (exit code 1);
* ``lane_op_counts(counter)`` counts one lane's float64 operations (a
  division one, as ``chip_smoke.F64Ops`` counts) of each piece of a step
  -- a full and a tight-coupling right-hand side, one sub-point's A and B,
  the RK4 combinations, the slaving after a tight-coupled step --, from
  which ``chip_smoke.py`` counts the serial floor of a launch.  The
  once-a-chunk coefficient passes (the block's x-only ones, each warp's
  k-dependent ones, one thread or lane a sub-point) are not on a step's
  chain and not counted.

    python tools/emulate_torch_boltz_lanes.py
"""

from __future__ import annotations

import pathlib
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hmvec_tpu_torch.ops import boltz_kernels as bk  # noqa: E402

F64 = torch.float64
L = bk.L
NTH = L + 1
PHI, VC, VB, TH, THP, N, NM = (bk.I_PHI, bk.I_VC, bk.I_VB, bk.I_TH,
                               bk.I_THP, bk.I_N, bk.I_NM)
COL = {name: i for i, name in enumerate(bk.XCOLS)}


def lane_role(i: int) -> dict:
    """csrc/boltz_kernels.cu lane_role(i) as codes: x1 (0 own, 1 the lane
    below, 2 the lane above, 3 Phi'), y (0 own, 1 the lane above, 2 Phi',
    3 Psi, 4 +0), w (0 own, 1 Theta_1, 2 +0), p (0 -0, 1 v_b, 2 -Pi), a and
    b (0 constant, 1 (ck/Hp n) / d, 2 the truncation coefficient), cc (0
    -0, 1 tau_x, 2 tau_x R_b), tc (0 the template, 1 dv_b, 2 (q - dv_b)/3,
    3 0), lvl and base (0 bm Theta_2, 1 (-1/4 ck/(Hp tau_x)) Theta_2)."""
    r = dict(x1=0, y=4, w=2, p=0, a=0, b=0, cc=0, tc=0, lvl=0, base=0,
             x2psi=False, an=1.0, ad=1.0, ac=0.0, bn=1.0, bd=1.0, bc=0.0,
             g=1.0, dv=1.0, bm=1.0)

    def ckh_a(n, d):
        r.update(a=1, an=float(n), ad=float(d))

    def ckh_b(n, d):
        r.update(b=1, bn=float(n), bd=float(d))

    if i == PHI:
        r.update(x1=3, ac=1.0)
    elif i in (1, 3):
        r.update(x1=2, y=2, bc=3.0)
        ckh_a(1, 1)
    elif i in (VC, VB):
        r.update(x1=0, ac=-1.0, y=3)
        ckh_b(1, 1)
        if i == VB:
            r.update(cc=2, w=1, g=3.0, p=1, tc=1)
    elif i in (TH, N):
        r.update(x1=2, y=2, bc=1.0)
        ckh_a(-1, 1)
    elif i in (TH + 1, N + 1, THP + 1):
        r.update(x1=1, x2psi=i != THP + 1, y=1)
        ckh_a(1, 3)
        ckh_b(2, 3)
        if i != N + 1:
            r.update(cc=1, w=0)
        if i == TH + 1:
            r.update(p=1, dv=3.0, tc=2)
        if i == THP + 1:
            r.update(tc=3, lvl=2, base=1)
    elif i == THP:
        r.update(x1=2, cc=1, w=0, p=2, dv=2.0, tc=3, lvl=2, bm=1.25)
        ckh_a(-1, 1)
    else:
        h = TH if i < THP else THP if i < N else N
        ell = i - h
        r.update(x1=1)
        if ell < L:
            ckh_a(ell, 2 * ell + 1)
            r.update(y=1)
            ckh_b(ell + 1, 2 * ell + 1)
        else:
            ckh_a(1, 1)
            r.update(y=0, b=2)
        if h != N:
            r.update(cc=1, w=0, tc=3, lvl=ell, bm=1.0 if h == TH else 0.25)
            if ell == 2:
                r.update(p=2, dv=10.0)
    return r


def lane_roles() -> SimpleNamespace:
    """Every field of the 32 lanes' roles as a (32,) tensor."""
    roles = [lane_role(i) for i in range(32)]
    out = {}
    for key in roles[0]:
        vals = [r[key] for r in roles]
        if key == "x2psi":
            out[key] = torch.tensor(vals)
        elif isinstance(vals[0], float):
            out[key] = torch.tensor(vals, dtype=F64)
        else:
            out[key] = torch.tensor(vals)
    return SimpleNamespace(**out)


def _t(v):
    return torch.tensor(v, dtype=F64)


def derive(c, q):
    """derive(): the x-only coefficients of the sub-points q (dict of
    (nsub,) columns)."""
    a, hp, taux = q["a"], q["hp"], q["taux"]
    a2 = a * a
    rb = _t(4.0 * c.omg) / (3.0 * c.omb * a)
    return {
        "omca": _t(c.omc) / a, "omba": _t(c.omb) / a,
        "omg4": _t(4.0 * c.omg) / a2, "omnu4": _t(4.0 * c.omnu) / a2,
        "rhow": q["rho_nu"] * (1.0 + q["w_nu"]) * a2,
        "ctop": _t(L + 1.0) / (hp * q["eta"]), "rb": rb, "trb": taux * rb,
        "taux": taux,
        "qa": -((1.0 - 2.0 * rb) * taux + (1.0 + rb) * q["tauxx"]),
        "dl1": 1.0 - q["dlnhp"],
        "qden": (1.0 + rb) * taux + q["dlnhp"] - 1.0, "rb1": 1.0 + rb,
        "w1": 1.0 + q["w_nu"], "cw3": 3.0 * (q["cg2"] - q["w_nu"]),
        "c13": -(1.0 - 3.0 * q["cg2"]), "cg2": q["cg2"]}


def k_derive(c, k, q):
    """k_derive(): the k-dependent coefficients, (rows, nsub) each."""
    hp = q["hp"][None, :]
    kk = k[:, None]
    r = _t(c.h0m) / (kk * q["a"][None, :])
    rh = _t(c.h0m) / hp
    return {
        "ckh": kk / hp, "r12": 12.0 * (r * r),
        "dpc": 1.5 * (rh * rh) * (hp / kk),
        "tight": (q["tcx"][None, :] != 0.0)
        & (torch.abs(q["taux"])[None, :] > 10.0 * kk / hp),
        "ckhti": kk / (hp * q["taux"][None, :])}


def _lanes(v, rows):
    """A per-row value (rows,) or a 0-d one on all 32 lanes."""
    v = v if v.dim() else v.expand(rows)
    return v[:, None].expand(rows, 32)


def _pick(code, options):
    """The option each lane's code selects (a select, never a branch)."""
    out = options[-1]
    for n in range(len(options) - 2, -1, -1):
        out = torch.where(code == n, options[n], out)
    return out


def lane_coefs(R, d, kd, rows):
    """lane_coefs(): the lanes' A and B, (rows, 32)."""
    ckh = _lanes(kd["ckh"], rows)
    qa = ckh * R.an / R.ad
    qb = ckh * R.bn / R.bd
    a = torch.where(R.a == 1, qa, R.ac)
    b = torch.where(R.b == 1, qb, torch.where(R.b == 2, _lanes(d["ctop"],
                                                              rows), R.bc))
    return a, b


def lane_rhs(R, c, d, kd, a, b, tc, own, dn, vn):
    """lane_rhs(): (ds, ddn, dvn), each (rows, 32); tc a bool (one k per
    call of the emulation's step: the kernel's warp)."""
    rows = own.shape[0]
    up = torch.cat([own[:, :1], own[:, :-1]], dim=1)
    down = torch.cat([own[:, 1:], own[:, -1:]], dim=1)

    def bc(i):
        return own[:, i:i + 1].expand(rows, 32)

    phi, vc, vb, th0, th1 = bc(PHI), bc(VC), bc(VB), bc(TH), bc(TH + 1)
    th2b, thp0, thp2 = bc(TH + 2), bc(THP), bc(THP + 2)
    nu1, nu2 = bc(N + 1), bc(N + 2)
    lanes = lambda v: _lanes(v, rows)  # noqa: E731
    ckh = lanes(kd["ckh"])
    th2 = -(8.0 / 15.0) * lanes(kd["ckhti"]) * th1 if tc else th2b
    psi = -phi - lanes(kd["r12"]) * (c.omg * th2 + c.omnu * nu2)
    src = (lanes(d["omca"]) * vc + lanes(d["omba"]) * vb
           - lanes(d["omg4"]) * th1 - lanes(d["omnu4"]) * nu1
           + lanes(d["rhow"]) * vn)
    dphi = psi + lanes(kd["dpc"]) * src
    pi_eq = th2b + thp0 + thp2
    zero, nzero = torch.zeros_like(own), torch.full_like(own, -0.0)
    x = _pick(R.x1, [own, up, down, dphi]) + torch.where(R.x2psi, psi,
                                                         nzero)
    y = _pick(R.y, [own, down, dphi, psi, zero])
    w = _pick(R.w, [own, th1, zero])
    p = _pick(R.p, [nzero, vb, -pi_eq])
    e = p / R.dv
    cc = _pick(R.cc, [nzero, lanes(d["taux"]), lanes(d["trb"])])
    t = (a * x - b * y) + cc * (R.g * w + e)
    if tc:
        dth0 = -ckh * th1 - dphi
        slip = -th0 + 2.0 * th2
        qq = ((lanes(d["qa"]) * (3.0 * th1 + vb) - ckh * psi
               + lanes(d["dl1"]) * ckh * slip - ckh * dth0)
              / lanes(d["qden"]))
        dvb = ((-vb - ckh * psi + lanes(d["rb"]) * (qq + ckh * slip
                                                    - ckh * psi))
               / lanes(d["rb1"]))
        t = _pick(R.tc, [t, dvb, (qq - dvb) / _t(3.0), zero])
    ddn = lanes(d["w1"]) * (ckh * vn - 3.0 * dphi) - lanes(d["cw3"]) * dn
    dvn = (lanes(d["c13"]) * vn
           - ckh * (lanes(d["cg2"]) * dn / lanes(d["w1"]) + psi))
    return t, ddn, dvn


def slave(R, kd2, s):
    """The slaved multipoles after a tight-coupled step, (rows, 32)."""
    rows = s.shape[0]
    ckhti = _lanes(kd2["ckhti"], rows)
    th2 = -(8.0 / 15.0) * ckhti * s[:, TH + 1:TH + 2].expand(rows, 32)
    v = torch.where(R.base == 1, -0.25 * ckhti * th2, R.bm * th2)
    for ell in range(3, NTH):
        cl = -(ell / (2.0 * ell + 1.0)) * ckhti
        v = torch.where(ell <= R.lvl, cl * v, v)
    return torch.where(R.lvl != 0, v, s)


def _rk_stage(s3, ds3, h):
    return [s + h * d for s, d in zip(s3, ds3)]


def _rk_acc(acc3, ds3):
    return [a + 2.0 * d for a, d in zip(acc3, ds3)]


def _rk_end(s3, acc3, ds3, sixth):
    return [s + sixth * (a + d) for s, a, d in zip(s3, acc3, ds3)]


def _sub(tab, i):
    return {key: v[i] for key, v in tab.items()}


@torch.inference_mode()
def hierarchy_rk4_lanes(xtab, ks, consts, s0, dx: float, n_outer: int,
                        n_inner: int, store: bool):
    """The kernel's lane program over the rows: (s_end (rows, 34), stored
    (rows, n_outer, 34) or None), as hierarchy_rk4_plain returns them.
    Rows are emulated one at a time (a warp each: tight coupling is
    decided per k)."""
    R = lane_roles()
    c = SimpleNamespace(**dict(zip(("h0m", "omg", "omnu", "omb", "omc"),
                                   consts.tolist())))
    flat = xtab.reshape(-1, len(bk.XCOLS))
    q = {name: flat[:, i] for name, i in COL.items()}
    der = derive(c, q)
    half = 0.5 * dx
    sixth = dx / 6.0
    ends, kept_all = [], []
    for r in range(ks.numel()):
        kd = k_derive(c, ks[r:r + 1], q)
        own = s0[r:r + 1, :32].clone()
        sdn = s0[r:r + 1, NM:NM + 1].expand(1, 32).clone()
        svn = s0[r:r + 1, NM + 1:NM + 2].expand(1, 32).clone()
        kept = []
        for step in range(n_outer * n_inner):
            d0, d1, d2 = (_sub(der, 3 * step + i) for i in range(3))
            kd0, kd1, kd2 = ({key: v[:, 3 * step + i] for key, v in kd.items()}
                             for i in range(3))
            s3 = [own, sdn, svn]
            a, b = lane_coefs(R, d0, kd0, 1)
            k1 = lane_rhs(R, c, d0, kd0, a, b, bool(kd0["tight"]), *s3)
            acc = list(k1)
            t3 = _rk_stage(s3, k1, half)
            a, b = lane_coefs(R, d1, kd1, 1)
            tc1 = bool(kd1["tight"])
            k2 = lane_rhs(R, c, d1, kd1, a, b, tc1, *t3)
            acc = _rk_acc(acc, k2)
            t3 = _rk_stage(s3, k2, half)
            k3 = lane_rhs(R, c, d1, kd1, a, b, tc1, *t3)
            acc = _rk_acc(acc, k3)
            t3 = _rk_stage(s3, k3, dx)
            a, b = lane_coefs(R, d2, kd2, 1)
            k4 = lane_rhs(R, c, d2, kd2, a, b, bool(kd2["tight"]), *t3)
            own, sdn, svn = _rk_end(s3, acc, k4, sixth)
            if bool(kd2["tight"]):
                own = slave(R, kd2, own)
            if (step + 1) % n_inner == 0 and store:
                kept.append(torch.cat([own, sdn[:, :1], svn[:, :1]], 1))
        ends.append(torch.cat([own, sdn[:, :1], svn[:, :1]], 1))
        if store:
            kept_all.append(torch.stack(kept, dim=1))
    return (torch.cat(ends), torch.cat(kept_all) if store else None)


def lane_op_counts(counter) -> dict:
    """One lane's float64 operations of each piece of a step, counted by
    ``counter`` (a TorchDispatchMode with an ``ops`` total, such as
    chip_smoke.F64Ops) on one row and divided by its 32 lanes: the full
    and the tight-coupling right-hand side, one sub-point's coefficients,
    the RK4 combinations of a step (three stage inputs, two sums, the
    update, over the lane's three components) and the slaving."""
    R = lane_roles()
    c = SimpleNamespace(h0m=1.0, omg=1.0, omnu=1.0, omb=1.0, omc=1.0)
    one = torch.ones(1, dtype=F64)
    q = {name: one.clone() for name in bk.XCOLS}
    d = {key: v[0] for key, v in derive(c, q).items()}
    kd = {key: v[:, 0] for key, v in k_derive(c, one, q).items()}
    s3 = [torch.ones(1, 32, dtype=F64) for _ in range(3)]
    a, b = lane_coefs(R, d, kd, 1)
    pieces = {
        "full": lambda: lane_rhs(R, c, d, kd, a, b, False, *s3),
        "tc": lambda: lane_rhs(R, c, d, kd, a, b, True, *s3),
        "coefs": lambda: lane_coefs(R, d, kd, 1),
        "rk": lambda: (_rk_stage(s3, s3, 0.5), _rk_acc(s3, s3),
                       _rk_stage(s3, s3, 0.5), _rk_acc(s3, s3),
                       _rk_stage(s3, s3, 0.5), _rk_end(s3, s3, s3, 0.1)),
        "slave": lambda: slave(R, kd, s3[0]),
    }
    out = {}
    for name, fn in pieces.items():
        with counter() as m:
            fn()
        out[name] = m.ops / 32
    return out


# (x_start, dx, n_outer, n_inner): the card test's segment A, then through
# the end of tight coupling (x = ln(1/1630)) and on to x = -5.2
SEGMENTS = ((-18.0, 8.8 / 300, 30, 10), (-9.2, 0.005, 100, 4),
            (-7.2, 0.02, 20, 5))


def check() -> int:
    """Hold the emulation against hierarchy_rk4_plain bit for bit on
    SEGMENTS."""
    from hmvec_tpu_torch.models import background as tbg
    from hmvec_tpu_torch.models import boltzlite as tbl
    from hmvec_tpu_torch.models import recomb as trec
    from hmvec_tpu_torch.params import merge_params

    torch.set_num_threads(2)
    bg = tbg.background(merge_params({"mnu": 0.06}), "cpu")
    ctx = tbl.make_ctx(bg, trec.recombination(bg, n=4096))
    ks = torch.as_tensor(np.geomspace(1e-4, 0.1, 8))
    s0 = tbl._initial_state(ctx, ks, torch.tensor(-18.0, dtype=F64))
    consts = torch.stack([ctx.h0m, ctx.omg, ctx.omnu, ctx.omb, ctx.omc])
    bad = 0
    for x_start, dx, n_outer, n_inner in SEGMENTS:
        i = torch.arange(n_outer, dtype=F64)
        j = torch.arange(n_inner, dtype=F64)
        x = ((x_start + i * (n_inner * dx))[:, None] + j * dx).reshape(-1)
        xtab = tbl._x_table(ctx, trec.rk4_subpoints(x, dx)).contiguous()
        args = (xtab, ks, consts, s0, dx, n_outer, n_inner, True)
        t0 = time.perf_counter()
        got = hierarchy_rk4_lanes(*args)
        t_lanes = time.perf_counter() - t0
        want = bk.hierarchy_rk4_plain(*args)
        flat = xtab.reshape(-1, len(bk.XCOLS))
        q = {name: flat[:, n] for name, n in COL.items()}
        tight = k_derive(SimpleNamespace(h0m=float(ctx.h0m)), ks, q)["tight"]
        same = torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
        diff = (got[1] - want[1]).abs().max().item()
        print(f"segment from x = {x_start}, {n_outer} x {n_inner} steps, "
              f"{ks.numel()} k ({int(tight.sum())} of {tight.numel()} "
              f"(k, sub-point) pairs tight-coupled): lanes vs plain "
              f"{'bit for bit' if same else 'DIFFER'} (max abs {diff!r}; "
              f"emulation {t_lanes:.1f} s)")
        bad += not same
        s0 = want[0]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(check())
