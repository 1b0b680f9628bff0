"""Engine-grade linear P(k, z) from the boltzlite hierarchy, the "boltz"
engine, on float64 tensors (port of hmvec_tpu/models/boltz_engine.py).

One host-side construction, as in the JAX package: the hierarchy is solved
on a BAO-resolving k grid (``matter_power_slices``: one recombination and
one perturbation solve, through the kernels of ops/boltz_kernels.py on the
card), the comoving-gauge matter contrast is read off the stored
trajectory at a few redshift slices, and beyond k_graft the tail follows
the EH98 shape scaled to the solve.  ``BoltzEngine.plin`` then serves

    P(k, z) = P0(k) (D(z)/D(0))^2 R(k, z)^2

from those tables, held as float64 tensors on the device of the
background it is given, with the exact As / ns / as8 / growth response to
that background: it is differentiable in the background's parameters
(``torch.func.jacfwd``; with ``shape_response`` also in omch2, ombh2 and
H0 through the cached central differences) and runs under
``torch.func.vmap``.

``matter_power_slices`` refuses a requested slice that would come out
non-finite or that lies between two nodes where the matter contrast
changes sign (z through recombination, where it oscillates through zero
and ln|Delta_m| is no interpolant), where the JAX package returns what
comes out.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import merge_params
from ..utils.weights import call_device, host, on_device_of_inputs
from . import background as bgmod
from . import boltzlite as bz
from .linear_power import TabulatedEngine, _mnu_maybe_active, plin_approx
from .recomb import ipow, recombination
from ..ops.quadrature import linear_interp
from .transfer import eh99_neutrino_ratio

__all__ = ["matter_power_z0", "matter_power_slices", "BoltzEngine"]

_F64 = torch.float64


def _host(v) -> float:
    return float(v.detach()) if isinstance(v, torch.Tensor) else float(v)


def default_k_grid(kmax: float = 0.65, kmin: float = 5e-5,
                   k_bao_lo: float = 0.015, dk_bao: float = 0.005,
                   nk_log: int = 24):
    """Solver k-grid (numpy): log-spaced below the wiggle band, linear
    (>= 8 nodes per 2 pi / r_s at the default dk) through it."""
    k_lo = np.geomspace(kmin, k_bao_lo, nk_log, endpoint=False)
    k_bao = np.arange(k_bao_lo, kmax, dk_bao)
    return np.concatenate([k_lo, k_bao, [kmax]])


def slices_from_solution(ctx, sol, zs, massive_nu: bool = False,
                         component: str = "total"):
    """P(k, z_j) (nz, nk) from a solved trajectory: the comoving-gauge
    matter contrast Delta_m read at x = -ln(1+z) by linear interpolation
    of ln|Delta_m| along the stored grid.  Raises ValueError for a z
    earlier than the stored trajectory, or where a slice would not be
    finite or its bracket of nodes holds a sign change of Delta_m."""
    zs = np.atleast_1d(np.asarray(zs, dtype=np.float64))
    xw = -np.log1p(zs)
    x_first = float(sol.xs[0])
    if xw.min() < x_first:
        raise ValueError(
            f"requested z={float(zs.max()):g} is earlier than the stored "
            f"trajectory (z <= {float(np.expm1(-x_first)):g})")
    bg = ctx.bg
    hp = bz._hp(ctx, sol.xs)
    st = sol.states
    ks = sol.ks
    gau = 3.0 * (hp[None, :] / ks[:, None])
    dc = st[..., bz.I_DC] - gau * st[..., bz.I_VC]
    db = st[..., bz.I_DB] - gau * st[..., bz.I_VB]
    num = ctx.omc * dc + ctx.omb * db
    den = ctx.omc + ctx.omb
    if massive_nu and component == "total" and float(ctx.omnm0) > 0:
        dn = st[..., bz.I_NM] - gau * st[..., bz.I_NM + 1]
        num = num + ctx.omnm0 * dn
        den = den + ctx.omnm0
    dm = num / den
    lndm = torch.log(torch.abs(dm))
    xwt = torch.as_tensor(xw, dtype=_F64, device=ks.device)
    lnd = linear_interp(xwt, sol.xs, lndm)                  # (nk, nz)
    tm = torch.exp(lnd) / sol.zeta_unit
    pzk = (2.0 * np.pi**2 / ipow(ks[:, None], 3)
           * bg.As * (ks[:, None] / bg.pivot_scalar) ** (bg.ns - 1.0)
           * ipow(tm, 2))
    # ROADMAP C3: ln|Delta_m| is a valid interpolant only between two
    # nodes of one sign; through recombination Delta_m oscillates through
    # zero, and the JAX package returns what comes out
    i = torch.searchsorted(sol.xs, xwt, right=True).clamp(
        1, sol.xs.numel() - 1)
    crossing = (dm[:, i - 1] * dm[:, i] <= 0.0).any(dim=0)
    bad = crossing | ~torch.isfinite(pzk).all(dim=0)
    if bool(bad.any()):
        raise ValueError(
            f"P(k, z) at z = {zs[bad.cpu().numpy()].tolist()} would not be "
            "finite or would interpolate ln|Delta_m| across a zero of "
            "Delta_m (which oscillates through recombination); ask for "
            "later slices")
    return pzk.T


@on_device_of_inputs
def matter_power_slices(params=None, ks=None, zs=(0.0,), kmax: float = 0.65,
                        zre: float = 7.7, n_c_inner: int | None = None,
                        solver_opts: dict | None = None,
                        massive_nu: bool = False, component: str = "total"):
    """Linear matter power P(k, z_j) in Mpc^3 at several redshifts from one
    hierarchy solve: (ks (numpy), P (nz, nk) tensor on the call's device).
    ``ks`` defaults to default_k_grid(kmax), ``n_c_inner`` to the
    CFL-stable count for the grid's kmax; massive_nu=True solves with the
    massive-nu fluid, ``component`` 'total' or 'cb'.  A requested slice
    that would not be finite, or that falls where the matter contrast
    changes sign between nodes, raises ValueError (slices_from_solution).
    """
    dev = call_device()
    p = merge_params(params or {})
    bg = bgmod.background(p, dev)
    rec = recombination(bg, zre=zre,
                        massive_nu=bz._fd_wanted(massive_nu, bg))
    ctx = bz.make_ctx(bg, rec, massive_nu=massive_nu)
    if ks is None:
        ks = default_k_grid(kmax)
    ks = np.asarray(ks, dtype=np.float64)
    if n_c_inner is None:
        n_c_inner = bz.segment_c_inner_steps(float(ks[-1]), _host(p["H0"]))
    sol = bz.solve_perturbations(ctx, ks, n_c_inner=n_c_inner,
                                 **(solver_opts or {}))
    return ks, slices_from_solution(ctx, sol, zs, massive_nu, component)


@on_device_of_inputs
def matter_power_z0(params=None, ks=None, kmax: float = 0.65,
                    zre: float = 7.7, n_c_inner: int | None = None,
                    solver_opts: dict | None = None,
                    massive_nu: bool = False, component: str = "total"):
    """Linear matter power P(k, z=0): the z=0 row of
    matter_power_slices."""
    ks, pzk = matter_power_slices(
        params, ks=ks, zs=(0.0,), kmax=kmax, zre=zre, n_c_inner=n_c_inner,
        solver_opts=solver_opts, massive_nu=massive_nu, component=component)
    return ks, pzk[0]


@on_device_of_inputs
def rs_drag_integral(params=None, zre: float = 7.7, rec=None, bg=None):
    """Drag-epoch sound horizon r_s(z_drag) in Mpc, integrated from the
    recombination history (unit baryon drag depth, Hu & Sugiyama 1996):
    (r_s, z_drag) as Python floats.  The recombination runs on the call's
    device; the integrals are host numpy, as in the JAX package."""
    if bg is None:
        bg = bgmod.background(merge_params(params or {}), call_device())
    if rec is None:
        rec = recombination(bg, zre=zre)
    xs = host(rec.xs)
    a = np.exp(xs)
    omg_h2 = 2.47282e-5 * (_host(bg.T_cmb_k) / 2.7255) ** 4
    R = 0.75 * _host(bg.ombh2) / omg_h2 * a
    cs = 1.0 / np.sqrt(3.0 * (1.0 + R))
    eta = host(rec.eta)
    taux = host(rec.tau_x)
    integ = -taux / R
    dx = xs[1] - xs[0]
    rev = 0.5 * (integ[1:] + integ[:-1]) * dx
    taud = np.concatenate([np.cumsum(rev[::-1])[::-1], [0.0]])
    x_d = float(np.interp(-1.0, -taud, xs))
    z_drag = 1.0 / np.exp(x_d) - 1.0
    deta = np.diff(eta)
    rs_cum = np.concatenate([[0.0],
                             np.cumsum(0.5 * (cs[1:] + cs[:-1]) * deta)])
    return float(np.interp(x_d, xs, rs_cum)), z_drag


# table cache: the transfer shape does not depend on As / ns (they rescale
# analytically at serve time), so the key holds only the shape, background
# and recombination parameters and the grid
_TABLE_CACHE: dict = {}

DEFAULT_Z_SLICES = (0.0, 0.5, 1.0, 2.0, 3.0, 5.0, 8.0, 12.0, 20.0)


def _shape_key(p, kmax, zre, n_c_inner, ks, massive_nu="eh99",
               z_slices=DEFAULT_Z_SLICES):
    vals = tuple(_host(p[k]) for k in
                 ("omch2", "ombh2", "H0", "omk", "w0", "wa", "mnu",
                  "T_CMB", "Yp", "nnu", "pivot_scalar")
                 if k in p)
    kk = None if ks is None else tuple(np.asarray(ks).tolist())
    return vals + (float(kmax), float(zre), n_c_inner, kk, massive_nu,
                   tuple(float(z) for z in z_slices))


def _solved_slices(p, kmax, zre, ks, n_c_inner, massive_nu, component,
                   z_slices, solver_opts=None, device=None):
    """Cached hierarchy solve -> (ks_b, p_sl (nzs, nk) numpy, As0, ns0,
    pivot0): the raw slices at the solve cosmology's As / ns."""
    so = tuple(sorted((solver_opts or {}).items()))
    key = _shape_key(p, kmax, zre, n_c_inner, ks,
                     massive_nu + ":" + component, z_slices) + (so,)
    if key not in _TABLE_CACHE:
        ks_b, p_sl = matter_power_slices(
            p, ks=ks, zs=z_slices, kmax=kmax, zre=zre,
            n_c_inner=n_c_inner, massive_nu=(massive_nu == "fluid"),
            component=component, solver_opts=solver_opts, device=device)
        _TABLE_CACHE[key] = (ks_b, host(p_sl), _host(p["As"]),
                             _host(p["ns"]), _host(p["pivot_scalar"]))
    return _TABLE_CACHE[key]


def _graft_eh_tail(bg, ks_b, p0_b, k_graft, k_table_max):
    """EH98 'eisenhu_osc' continuation beyond k_graft, ratio-matched over
    the last wiggle-free nodes below k_graft: (ks_full, p_full, ratio),
    host numpy."""
    sel_lo = ks_b <= k_graft
    win = (ks_b > 0.85 * k_graft) & sel_lo
    ks_hi = np.geomspace(k_graft, k_table_max, 200)[1:]
    ks_eh = np.concatenate([ks_b[win], ks_hi])
    dev = bg.H0.device
    p_eh = host(plin_approx(bg, torch.zeros(1, dtype=_F64, device=dev),
                            torch.as_tensor(ks_eh, device=dev)))[0]
    ratio = float(np.mean(p0_b[win] / p_eh[:win.sum()]))
    ks_full = np.concatenate([ks_b[sel_lo], ks_hi])
    p_full = np.concatenate([p0_b[sel_lo], p_eh[win.sum():] * ratio])
    return ks_full, p_full, ratio


# central-difference steps of the shape-response sensitivities (~2%)
SHAPE_STEPS = {"omch2": 0.0024, "ombh2": 0.00045, "H0": 1.3}


class BoltzEngine:
    """Linear-power engine backed by the boltzlite hierarchy.

    Construction runs the solve on ``device`` (cached per shape
    cosmology) and builds the tables on the host; ``plin`` / ``pzk_grid``
    serve P(k, z) = P0(k) (D(z)/D(0))^2 R(k, z)^2 with the exact As / ns /
    as8 rescaling from the background they are given.  ``massive_nu``:
    'eh99' (the massless solve and the EH99 free-streaming response at
    serve time) or 'fluid' (the massive-nu fluid in the solve, mnu pinned
    at the ctor value); ``z_resolved``: the solved trajectory's
    growth-normalized residual R between the stored slices;
    ``shape_response``: the first-order ln P response to omch2, ombh2 and
    H0 from cached +-h re-solves."""

    name = "boltz"

    def __init__(self, params=None, kmax: float = 0.65,
                 k_graft: float = 0.55, k_table_max: float = 2100.0,
                 zre: float = 7.7, ks=None, n_c_inner: int | None = None,
                 massive_nu: str = "eh99", component: str = "total",
                 z_slices=DEFAULT_Z_SLICES, z_resolved: bool = True,
                 shape_response=False, shape_steps=None,
                 solver_opts: dict | None = None, device="cuda"):
        if massive_nu not in ("eh99", "fluid"):
            raise ValueError(massive_nu)
        dev = torch.device(device)
        p = merge_params(params or {})
        p = {k: (_host(v) if isinstance(v, torch.Tensor) else v)
             for k, v in p.items()}
        bg = bgmod.background(p, dev)
        self._mnu_in_table = (massive_nu == "fluid")
        z_slices = tuple(float(z) for z in z_slices)
        if z_slices[0] != 0.0:
            raise ValueError("z_slices must start at 0")
        ks_b, p_sl, As0, ns0, pivot0 = _solved_slices(
            p, kmax, zre, ks, n_c_inner, massive_nu, component, z_slices,
            solver_opts, dev)
        # rescale the cached rows to this cosmology's As / ns (exact: a
        # k-factor shared by every z row)
        As, ns = float(p["As"]), float(p["ns"])
        p_sl = p_sl * As / As0 * (ks_b / pivot0) ** (ns - ns0)
        ks_full, p_full, ratio = _graft_eh_tail(bg, ks_b, p_sl[0],
                                                k_graft, k_table_max)
        self.ks_t = ks_full
        self.p0_t = p_full
        self._lnk = np.log(ks_full)
        self._lnp = np.log(p_full)
        self._slope = np.gradient(self._lnp, self._lnk)
        self._As0 = As
        self._ns0 = ns
        self._pivot0 = float(p["pivot_scalar"])
        self._graft_ratio = ratio
        self.params = p
        self._bg0 = bg
        self.z_slices = z_slices
        self._z_resolved = bool(z_resolved) and len(z_slices) > 1
        self._lnk_b = np.log(ks_b)
        self._lnratio = 0.5 * np.log(p_sl / p_sl[0])   # (nzs, nk_b)
        self._u_slices = np.log1p(np.asarray(z_slices))
        self._resid_cache: dict = {}
        self._dev: dict = {}
        self._sens = None
        if shape_response:
            steps = dict(SHAPE_STEPS, **(shape_steps or {}))
            if isinstance(shape_response, (tuple, list)):
                steps = {n: steps[n] for n in shape_response}
            self._theta0 = {n: float(p[n]) for n in steps}
            self._sens = {}
            for nm, h in steps.items():
                tabs = []
                for sgn in (+1.0, -1.0):
                    pp = dict(p)
                    pp[nm] = float(p[nm]) + sgn * h
                    ks2, psl2, As2, ns2, piv2 = _solved_slices(
                        pp, kmax, zre, ks, n_c_inner, massive_nu,
                        component, z_slices, solver_opts, dev)
                    bg2 = bgmod.background(merge_params(pp), dev)
                    p02 = (psl2[0] * As / As2 * (ks2 / piv2) ** (ns - ns2))
                    _, pf2, _ = _graft_eh_tail(bg2, ks2, p02, k_graft,
                                               k_table_max)
                    tabs.append(np.log(pf2))
                self._sens[nm] = (tabs[0] - tabs[1]) / (2.0 * h)

    def _resid(self, mode: str):
        """ln R table (nzs, nk_b) on the host: the solved slice ratios
        divided by the serve-mode growth at the ctor cosmology."""
        if mode not in self._resid_cache:
            a = 1.0 / (1.0 + np.asarray(self.z_slices))
            d = host(bgmod.d_growth(
                self._bg0, torch.as_tensor(a, device=self._bg0.H0.device),
                norm="z0norm", mode=mode))
            lnr = self._lnratio - np.log(d)[:, None]
            lnr[0] = 0.0                  # exact by construction
            self._resid_cache[mode] = lnr
        return self._resid_cache[mode]

    def _tables(self, device, mode=None):
        """The serving tables as float64 tensors on ``device`` (moved once
        per device and growth mode)."""
        key = (device, mode)
        if key not in self._dev:
            t = {"lnk": self._lnk, "lnp": self._lnp, "slope": self._slope,
                 "lnk_b": self._lnk_b, "us": self._u_slices}
            if mode is not None:
                t["lnr"] = self._resid(mode)
            if self._sens is not None:
                t.update({f"sens_{n}": v for n, v in self._sens.items()})
            self._dev[key] = {k: torch.as_tensor(np.asarray(v), dtype=_F64,
                                                 device=device)
                              for k, v in t.items()}
        return self._dev[key]

    def _lnp0(self, lks, tabs):
        """Cubic-Hermite (Catmull-Rom slopes) interpolation of ln P0 in
        ln k; linear (a power law in k) outside the table."""
        lkt = tabs["lnk"]
        ik = torch.clamp(torch.searchsorted(lkt, lks.contiguous()) - 1, 0,
                         lkt.numel() - 2)
        h = lkt[ik + 1] - lkt[ik]
        t = (lks - lkt[ik]) / h
        inside = (lks >= lkt[0]) & (lks <= lkt[-1])
        return TabulatedEngine._hermite_axis(tabs["lnp"], tabs["slope"],
                                             ik, t, h, inside)

    def plin(self, bg, zs, ks, accuracy: str = "medium",
             growth_mode: str = "closed", component: str = "total",
             growth_table=None):
        dev = bg.H0.device
        zs = torch.atleast_1d(torch.as_tensor(zs, dtype=_F64, device=dev))
        ks = torch.as_tensor(ks, dtype=_F64, device=dev)
        if accuracy == "low":
            return plin_approx(bg, zs, ks, growth_mode=growth_mode,
                               component=component,
                               growth_table=growth_table)
        tabs = self._tables(dev, growth_mode if self._z_resolved else None)
        lks = torch.log(ks)
        lnp0 = self._lnp0(lks, tabs)
        if self._sens is not None:
            # first-order ln P response of the table to the background's
            # shape parameters
            bgv = {"omch2": bg.omch2, "ombh2": bg.ombh2, "H0": bg.H0}
            for nm in self._sens:
                lnp0 = lnp0 + (bgv[nm] - self._theta0[nm]) * linear_interp(
                    lks, tabs["lnk"], tabs[f"sens_{nm}"])
        p0 = torch.exp(lnp0)
        amp = (bg.As / self._As0) * torch.exp(
            (bg.ns - self._ns0) * (lks - np.log(self._pivot0)))
        a = 1.0 / (1.0 + zs)
        dz0 = bgmod.d_growth(bg, a, norm="z0norm", mode=growth_mode,
                             table=growth_table)
        pzk = p0[None, :] * amp[None, :] * ipow(dz0[:, None], 2)
        if self._z_resolved:
            # growth-normalized residual of the solved trajectory: bilinear
            # in (ln(1+z), ln k), flat beyond the table edges
            rows = linear_interp(lks, tabs["lnk_b"], tabs["lnr"])  # (nzs, nk)
            us = tabs["us"]
            u = torch.log1p(zs)
            iu = torch.clamp(torch.searchsorted(us, u.contiguous()) - 1, 0,
                             us.numel() - 2)
            t = torch.clamp((u - us[iu]) / (us[iu + 1] - us[iu]), 0.0, 1.0)
            lnr = rows[iu] * (1.0 - t[:, None]) + rows[iu + 1] * t[:, None]
            pzk = pzk * torch.exp(2.0 * lnr)
        if _mnu_maybe_active(bg.omnu0) and not self._mnu_in_table:
            # serve-time EH99 free-streaming response (the fluid solve
            # already carries the suppression)
            dz = bgmod.d_growth(bg, a, norm="anorm", mode=growth_mode,
                                table=growth_table)
            pzk = pzk * ipow(eh99_neutrino_ratio(bg, ks, dz,
                                                 component=component), 2)
        return ipow(bg.as8, 2) * pzk

    def pzk_grid(self, bg, zs, ks, nonlinear: bool = False,
                 growth_mode: str = "closed", growth_table=None):
        if nonlinear:
            raise NotImplementedError(
                "BoltzEngine has no nonlinear power; use the halofit "
                "module or a table")
        return self.plin(bg, zs, ks, accuracy="high",
                         growth_mode=growth_mode, growth_table=growth_table)
