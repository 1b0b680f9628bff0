"""Linear matter power and sigma^2(R, z) on float64 tensors (port of
hmvec_tpu/models/linear_power.py).

``EHEngine`` is the engine-free analytic Eisenstein-Hu power, where the
accuracy tiers coincide; ``TabulatedEngine`` reads P(z, k) from a table on
the host (a CAMB or CLASS run), ``boltz_engine.BoltzEngine`` solves the
boltzlite hierarchy, and ``make_engine`` picks one by name.
sigma^2(R, z) is one (z, k) @ (k, m) float64 matmul with static Simpson
weights (``torch.matmul``: the JAX package also leaves this product to the
compiler, outside any kernel).

Not ported: ``_mixed32_matmul`` and the ``fast_f32`` chain, which exist for
the TPU's emulated float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.special import Wkr
from ..utils.weights import simpson_weights
from . import background as bgmod
from .background import _varies
from .transfer import eh99_neutrino_ratio, transfer_eh98

CSPEED_KMS = 299792.458


def _mnu_maybe_active(omnu0) -> bool:
    """Does this call need the EH99 neutrino ratio?  A differentiated or
    batched omnu0 always takes it (the ratio is exactly 1 at f_nu = 0)."""
    return _varies(omnu0) or float(omnu0) > 0.0


def plin_approx(bg, zs, ks, kind: str = "eisenhu_osc",
                growth_mode: str = "closed", component: str = "total",
                growth_table=None):
    """Fully analytic linear P(k, z) in Mpc^3, shape (nz, nk).

    P = [8 pi^2 As c^4 / (25 (omm H0^2)^2)] (k/kp)^(ns-1) k D(z)^2 T(k)^2,
    times the EH99 suppression ratio squared when mnu > 0.

    growth_mode: 'closed' (Heath/2F1, LCDM-exact) or 'ode' (any w0/wa),
    which reads ``growth_table`` (``background.growth_table(bg)``; built
    here when None, so a caller with several spectra of one background
    builds it once and passes it).
    """
    zs = torch.atleast_1d(zs)
    tk = transfer_eh98(bg, ks, kind)[None, :]
    a = 1.0 / (1.0 + zs)
    dz = bgmod.d_growth(bg, a, norm="anorm", mode=growth_mode,
                        table=growth_table)[:, None]
    # omm*H0^2 including massive neutrinos
    omh2 = (bg.omch2 + bg.ombh2) * 100.0**2 + bg.omnu0 * bg.H0**2
    kfacts = (ks / bg.pivot_scalar) ** (bg.ns - 1.0) * ks
    pref = bg.As * (8.0 * np.pi**2 * CSPEED_KMS**4 / 25.0) / omh2**2
    p = pref * kfacts[None, :] * dz**2 * tk**2
    if _mnu_maybe_active(bg.omnu0):
        ratio = eh99_neutrino_ratio(bg, ks, dz[:, 0], component=component)
        p = p * ratio**2
    return p


class EHEngine:
    """Engine-free analytic linear power."""

    name = "eh"

    def plin(self, bg, zs, ks, accuracy: str = "medium",
             growth_mode: str = "closed", component: str = "total",
             growth_table=None):
        p = plin_approx(bg, zs, ks, growth_mode=growth_mode,
                        component=component, growth_table=growth_table)
        if accuracy != "low":
            p = bg.as8**2 * p  # as8 knob applies on engine-normalized tiers
        return p

    def pzk_grid(self, bg, zs, ks, nonlinear: bool = False,
                 growth_mode: str = "closed", growth_table=None):
        if nonlinear:
            raise NotImplementedError(
                "EHEngine has no nonlinear power")
        return bg.as8**2 * plin_approx(bg, zs, ks, growth_mode=growth_mode,
                                       growth_table=growth_table)


def _hermite_weights(t):
    """Cubic-Hermite basis (h00, h10, h01, h11) at fraction t."""
    t2 = t * t
    t3 = t2 * t
    return (2 * t3 - 3 * t2 + 1, t3 - 2 * t2 + t,
            -2 * t3 + 3 * t2, t3 - t2)


class TabulatedEngine:
    """P(z, k) from a table on the host (the CAMB/CLASS parity path).

    ``zs_t, ks_t, p_t`` define the table (``p_t`` of shape (nz_t, nk_t));
    the interpolation is the tensor-product cubic Hermite of ln P in
    (z, ln k), with Catmull-Rom node slopes (``np.gradient``) computed on
    the host, and LINEAR extrapolation of ln P beyond the table's edges (a
    power law in k).  The tables go to each device once.
    """

    name = "tabulated"

    def __init__(self, zs_t, ks_t, p_t, p_nl_t=None):
        self.zs_t = np.asarray(zs_t, dtype=np.float64)
        self.ks_t = np.asarray(ks_t, dtype=np.float64)
        self.lkt = np.log(self.ks_t)
        self.logp_t = np.log(np.asarray(p_t, dtype=np.float64))
        self.logp_nl_t = (np.log(np.asarray(p_nl_t, dtype=np.float64))
                          if p_nl_t is not None else None)
        self._host = {"lin": (self.logp_t, *self._make_slopes(self.logp_t))}
        if self.logp_nl_t is not None:
            self._host["nl"] = (self.logp_nl_t,
                                *self._make_slopes(self.logp_nl_t))
        self._dev = {}

    def _make_slopes(self, tab):
        mk = np.gradient(tab, self.lkt, axis=1)
        if self.zs_t.size > 1:
            mz = np.gradient(tab, self.zs_t, axis=0)
            mzk = np.gradient(mz, self.lkt, axis=1)
        else:
            mz = np.zeros_like(tab)
            mzk = np.zeros_like(tab)
        return mk, mz, mzk

    def _tables(self, which, device):
        """(zt, lkt, tab, mk, mz, mzk) as float64 tensors on ``device``."""
        key = (which, device)
        if key not in self._dev:
            self._dev[key] = tuple(
                torch.as_tensor(a, dtype=torch.float64, device=device)
                for a in (self.zs_t, self.lkt, *self._host[which]))
        return self._dev[key]

    @staticmethod
    def _hermite_axis(y, m, iq, tq, h, inside):
        """Hermite along the LAST axis of y (slopes m) at intervals iq,
        fraction tq, width h; linear from the nearer node outside the node
        range."""
        y0 = y[..., iq]
        y1 = y[..., iq + 1]
        m0 = m[..., iq]
        m1 = m[..., iq + 1]
        h00, h10, h01, h11 = _hermite_weights(tq)
        val = h00 * y0 + h10 * h * m0 + h01 * y1 + h11 * h * m1
        lin = torch.where(tq < 0.5, y0 + tq * h * m0,
                          y1 + (tq - 1.0) * h * m1)
        return torch.where(inside, val, lin)

    def _interp(self, which, zs, ks):
        zs = torch.atleast_1d(zs)
        lks = torch.log(ks)
        zt, lkt, tab, mk_t, mz_t, mzk_t = self._tables(which, zs.device)

        # pass 1: cubic Hermite along ln k (values and z-slopes)
        ik = torch.clamp(torch.searchsorted(lkt, lks.contiguous()) - 1, 0,
                         lkt.numel() - 2)
        hk = lkt[ik + 1] - lkt[ik]
        tk = (lks - lkt[ik]) / hk
        in_k = (lks >= lkt[0]) & (lks <= lkt[-1])
        val_k = self._hermite_axis(tab, mk_t, ik, tk, hk, in_k)
        if zt.numel() == 1:
            return torch.exp(val_k[0].expand(zs.shape[0], lks.shape[0]))
        mz_k = self._hermite_axis(mz_t, mzk_t, ik, tk, hk, in_k)

        # pass 2: cubic Hermite along z
        iz = torch.clamp(torch.searchsorted(zt, zs.contiguous()) - 1, 0,
                         zt.numel() - 2)
        hz = zt[iz + 1] - zt[iz]
        tz = (zs - zt[iz]) / hz
        in_z = (zs >= zt[0]) & (zs <= zt[-1])
        y0 = val_k[iz]
        y1 = val_k[iz + 1]
        m0 = mz_k[iz]
        m1 = mz_k[iz + 1]
        h00, h10, h01, h11 = (w[:, None] for w in _hermite_weights(tz))
        out = (h00 * y0 + h10 * hz[:, None] * m0
               + h01 * y1 + h11 * hz[:, None] * m1)
        lin = torch.where(tz[:, None] < 0.5,
                          y0 + (tz * hz)[:, None] * m0,
                          y1 + ((tz - 1.0) * hz)[:, None] * m1)
        return torch.exp(torch.where(in_z[:, None], out, lin))

    def plin(self, bg, zs, ks, accuracy: str = "medium",
             growth_mode: str = "closed", growth_table=None):
        """'high': the table; 'low': the analytic EH power; 'medium': the
        EH shape normalized to the table at k = 1e-4 /Mpc."""
        dev = bg.H0.device
        zs = torch.as_tensor(zs, dtype=torch.float64, device=dev)
        ks = torch.as_tensor(ks, dtype=torch.float64, device=dev)
        if accuracy == "high":
            return bg.as8**2 * self._interp("lin", zs, ks)
        if accuracy == "low":
            return plin_approx(bg, zs, ks, growth_mode=growth_mode,
                               growth_table=growth_table)
        knorm = 1e-4
        kn = torch.full((1,), knorm, dtype=torch.float64, device=dev)
        tk = transfer_eh98(bg, ks, "eisenhu_osc")
        pnorm = self._interp("lin", zs, kn)                      # (nz, 1)
        tnorm = transfer_eh98(bg, kn, "eisenhu_osc") * knorm**bg.ns
        p = (pnorm / tnorm) * (tk**2 * ks**bg.ns)[None, :]
        return bg.as8**2 * p

    def pzk_grid(self, bg, zs, ks, nonlinear: bool = False,
                 growth_mode: str = "closed", growth_table=None):
        del growth_mode, growth_table  # the table carries its own growth
        if nonlinear and self.logp_nl_t is None:
            raise ValueError("No nonlinear table provided")
        dev = bg.H0.device
        zs = torch.as_tensor(zs, dtype=torch.float64, device=dev)
        ks = torch.as_tensor(ks, dtype=torch.float64, device=dev)
        return bg.as8**2 * self._interp("nl" if nonlinear else "lin", zs, ks)


def make_engine(engine="eh", pk_table=None, params=None, engine_opts=None,
                device="cuda"):
    """The linear-power engine for a name: "eh" (``EHEngine``); "camb" /
    "class", which take ``pk_table`` = (zs_t, ks_t, p_t[, p_nl_t]) as a
    ``TabulatedEngine`` and are the analytic engine without one; "boltz",
    the boltzlite hierarchy solve (``boltz_engine.BoltzEngine(params,
    **engine_opts)``, solved on ``device``).  An engine object (anything
    with ``plin`` and ``pzk_grid``) is returned as it is."""
    if not isinstance(engine, str):
        return engine
    if engine == "boltz":
        from .boltz_engine import BoltzEngine
        return BoltzEngine(params, **{"device": device,
                                      **(engine_opts or {})})
    if engine in ("eh", "camb", "class"):
        if pk_table is not None:
            return TabulatedEngine(*pk_table)
        return EHEngine()
    raise ValueError(f"Unknown engine {engine!r}")


def sigma2_k_grid(params):
    """The static sigma^2 k grid (numpy): params' sigma2_kmin..kmax,
    sigma2_numks log-spaced points (10,000 by default)."""
    return np.geomspace(params["sigma2_kmin"], params["sigma2_kmax"],
                        params["sigma2_numks"])


def sigma2_R(bg, R_m, zs, spzk, ks_sigma2, taylor_switch=0.01):
    """sigma^2(z, m) = int dk k^2 P(z,k) W^2(k R_m) / (2 pi^2).

    ``R_m``: (nm,) Lagrangian radii; ``spzk``: (nz, nks) linear power on the
    sigma^2 grid; ``ks_sigma2``: the static numpy grid.  One float64
    matmul: (nz, nk) @ (nk, nm).
    """
    del bg, zs  # the power already carries them
    ks_np = np.asarray(ks_sigma2)
    dev = spzk.device
    ks = torch.as_tensor(ks_np, dtype=torch.float64, device=dev)
    # k^2 w / 2pi^2 folded on the host (static grid)
    kw = torch.as_tensor(simpson_weights(ks_np) * ks_np**2
                         / (2.0 * math.pi**2), dtype=torch.float64,
                         device=dev)
    return sigma2_weighted(R_m, spzk, ks, kw, taylor_switch)


def sigma2_weighted(R_m, spzk, ks, kw, taylor_switch=0.01):
    """sigma2_R with the grid ``ks`` and the weights k^2 w / (2 pi^2)
    already on the device (pipelines build them once)."""
    W2 = Wkr(ks[None, :], R_m[:, None], taylor_switch) ** 2   # (nm, nk)
    lhs = spzk * kw[None, :]                                  # (nz, nk)
    return lhs @ W2.T
