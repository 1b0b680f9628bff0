"""1-halo / 2-halo power assembly on float64 tensors (port of
hmvec_tpu/models/power.py for the matter and HOD tracers).

The mass integrals are static trapezoid-weight reductions over the m axis.
The 2-halo term applies the low-k consistency completion, so that
P2h -> P_lin as k -> 0, and the 1-halo term is damped below k*.

Deviation from the JAX package: the assembly always runs in float64.  The
JAX ``fast_assembly`` option (float32 products and sums) exists because
float64 is emulated on the TPU; a GPU has native float64, so the port has
no such option.  ``MatterTracer`` and ``HODTracer`` are ported, without the
concentration-scatter second moments (uk2, us2); the pressure and CIB
tracers come with their slices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class MatterTracer(NamedTuple):
    uk: torch.Tensor  # (nz, nm, nk) normalized profile u(k | z, m)


class HODTracer(NamedTuple):
    Nc: torch.Tensor       # (nz, nm)
    Ns: torch.Tensor       # (nz, nm)
    NsNsm1: torch.Tensor   # (nz, nm)
    NcNs: torch.Tensor     # (nz, nm)
    ngal: torch.Tensor     # (nz,)
    bg: torch.Tensor       # (nz,)
    us: torch.Tensor       # (nz, nm, nk) satellite profile
    uc: Optional[torch.Tensor] = None  # central profile (None -> 1)


def mass_weights(ms):
    """Trapezoid weights of the mass grid, built on its device with the
    arithmetic of utils.weights.trapz_weights (so bit-identical to it)."""
    half = torch.diff(ms) / 2.0
    zero = torch.zeros_like(ms[:1])
    return torch.cat([half, zero]) + torch.cat([zero, half])


def _mass_integral(integrand, ms):
    """int dm integrand(z, m, k) -> (z, k) with static trapz weights."""
    w = mass_weights(ms)
    return (integrand * w[None, :, None]).sum(dim=-2)


def _matter_term(t: MatterTracer, ms, rho_matter0, lowklim=False):
    """m u(k) / rho_m0, shape (nz, nm, nk); (1, nm, 1) in the u -> 1 limit."""
    fac = ms[None, :, None] / rho_matter0
    if lowklim:
        return fac
    return fac * t.uk


def _hod_square_term(t: HODTracer):
    """(2 uc us <NcNs> + <Ns(Ns-1)> us^2) / ngal^2, shape (nz, nm, nk)."""
    uc = 1.0 if t.uc is None else t.uc
    return ((2.0 * uc * t.us * t.NcNs[..., None]
             + t.NsNsm1[..., None] * t.us**2)
            / t.ngal[..., None, None] ** 2)


def _hod_term(t: HODTracer, lowklim=False):
    """(uc <Nc> + us <Ns>) / ngal, shape (nz, nm, nk); (nz, nm, 1) in the
    u -> 1 limit."""
    uc = 1.0 if t.uc is None else t.uc
    us = t.us
    if lowklim:
        uc, us = 1.0, 1.0
    return ((uc * t.Nc[..., None] + us * t.Ns[..., None])
            / t.ngal[..., None, None])


def _term(tracer, ms, rho_matter0, lowklim=False):
    if isinstance(tracer, HODTracer):
        return _hod_term(tracer, lowklim)
    if isinstance(tracer, MatterTracer):
        return _matter_term(tracer, ms, rho_matter0, lowklim)
    raise TypeError(f"only MatterTracer and HODTracer are ported, got "
                    f"{type(tracer).__name__}")


def one_halo_square_term(tracer1, tracer2, ms, rho_matter0):
    """The (z, m, k) pair term that power_1halo integrates.  One HOD sample
    with itself keeps the factorial-moment form; two distinct tracers
    factorize."""
    if tracer1 is tracer2 and isinstance(tracer1, HODTracer):
        return _hod_square_term(tracer1)
    return (_term(tracer1, ms, rho_matter0)
            * _term(tracer2, ms, rho_matter0))


def power_1halo(tracer1, tracer2, nzm, ms, ks, rho_matter0,
                kstar_damping=0.01):
    """P_1h(z, k), shape (nz, nk)."""
    square = one_halo_square_term(tracer1, tracer2, ms, rho_matter0)
    integral = _mass_integral(nzm[..., None] * square, ms)
    damping = 1.0 - torch.exp(-((ks / kstar_damping) ** 2))
    return integral * damping[None, :]


def _leg(tracer, nzm, bh, ms, rho_matter0):
    """(integral, consistency, b) for one 2-halo leg."""
    weighted = nzm[..., None] * bh[..., None]
    integral = _mass_integral(weighted * _term(tracer, ms, rho_matter0), ms)
    term0 = _term(tracer, ms, rho_matter0, lowklim=True)
    consistency = _mass_integral(weighted * term0, ms)
    b = tracer.bg[:, None] if isinstance(tracer, HODTracer) else 1.0
    return integral, consistency, b


def power_2halo(tracer1, tracer2, nzm, bh, ms, pzk_lin, rho_matter0):
    """P_2h(z, k) with the low-k consistency completion, shape (nz, nk)."""
    i1, c1, b1 = _leg(tracer1, nzm, bh, ms, rho_matter0)
    i2, c2, b2 = _leg(tracer2, nzm, bh, ms, rho_matter0)
    e1 = i1 + b1 - c1
    e2 = i2 + b2 - c2
    return pzk_lin * e1 * e2


def power_total(tracer1, tracer2, nzm, bh, ms, ks, pzk_lin, rho_matter0,
                kstar_damping=0.01):
    """P_1h + P_2h, shape (nz, nk)."""
    return (power_1halo(tracer1, tracer2, nzm, ms, ks, rho_matter0,
                        kstar_damping)
            + power_2halo(tracer1, tracer2, nzm, bh, ms, pzk_lin,
                          rho_matter0))

