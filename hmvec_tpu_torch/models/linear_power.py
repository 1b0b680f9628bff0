"""Linear matter power and sigma^2(R, z) on float64 tensors (port of
hmvec_tpu/models/linear_power.py).

``EHEngine`` is the engine-free analytic Eisenstein-Hu power, where the
accuracy tiers coincide.  sigma^2(R, z) is one (z, k) @ (k, m) float64
matmul with static Simpson weights (``torch.matmul``: the JAX package also
leaves this product to the compiler, outside any kernel).

Not ported: ``TabulatedEngine``, ``_mixed32_matmul`` and the ``fast_f32``
chain; the last two exist for the TPU's emulated float64.
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
