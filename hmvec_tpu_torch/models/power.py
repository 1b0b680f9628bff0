"""1-halo / 2-halo power assembly on float64 tensors (port of
hmvec_tpu/models/power.py for the matter, pressure, HOD and CIB tracers).

The mass integrals are static trapezoid-weight reductions over the m axis.
The 2-halo term applies the low-k consistency completion, so that
P2h -> P_lin as k -> 0, and the 1-halo term is damped below k*.  ``fnl``
threads the local-fNL scale-dependent bias through each 2-halo leg, and
``exclusion_correction`` is the Baldauf et al 2013 sharp halo exclusion.

Deviation from the JAX package: the assembly always runs in float64.  The
JAX ``fast_assembly`` option (float32 products and sums) exists because
float64 is emulated on the TPU; a GPU has native float64, so the port has
no such option.  ``CIBTracer`` is the emissivity-weighted tracer of the
CIB and HI halo models (models/cib.py, models/hi.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.weights import mass_weights, on_device_of_inputs, tensor_or_f64


class MatterTracer(NamedTuple):
    uk: torch.Tensor  # (nz, nm, nk) normalized profile u(k | z, m), or <u>
    # <u^2> under concentration scatter (profiles.nfw_uk_scatter): the
    # 1-halo auto term uses it; cross and 2-halo terms are linear in u
    uk2: Optional[torch.Tensor] = None


class PressureTracer(NamedTuple):
    pk: torch.Tensor  # (nz, nm, nk) pressure profile in y units


class CIBTracer(NamedTuple):
    """Emissivity-weighted tracer (CIB; HI with fc = 0): fc / fs are the
    central / satellite per-halo emissivities on the (z, m) grid."""
    fc: torch.Tensor       # (nz, nm)
    fs: torch.Tensor       # (nz, nm)
    us: torch.Tensor       # (nz, nm, nk) satellite profile (<u> if scattered)
    # <u^2> of a concentration-scattered satellite profile: the same-halo
    # satellite pair term averages u^2 over one realized concentration
    us2: Optional[torch.Tensor] = None


class HODTracer(NamedTuple):
    Nc: torch.Tensor       # (nz, nm)
    Ns: torch.Tensor       # (nz, nm)
    NsNsm1: torch.Tensor   # (nz, nm)
    NcNs: torch.Tensor     # (nz, nm)
    ngal: torch.Tensor     # (nz,)
    bg: torch.Tensor       # (nz,)
    us: torch.Tensor       # (nz, nm, nk) satellite profile (<u> if scattered)
    uc: Optional[torch.Tensor] = None   # central profile (None -> 1)
    us2: Optional[torch.Tensor] = None  # <u^2> under concentration scatter


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


def _pressure_term(t: PressureTracer, lowklim=False):
    """The pressure profile; in the low-k limit its first k column."""
    if lowklim:
        return t.pk[:, :, :1].expand(t.pk.shape)
    return t.pk


def _hod_square_term(t: HODTracer):
    """(2 uc us <NcNs> + <Ns(Ns-1)> us^2) / ngal^2, shape (nz, nm, nk); under
    concentration scatter the satellite pair term takes <u^2>."""
    uc = 1.0 if t.uc is None else t.uc
    us_sq = t.us**2 if t.us2 is None else t.us2
    return ((2.0 * uc * t.us * t.NcNs[..., None]
             + t.NsNsm1[..., None] * us_sq)
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


def _cib_term(t: CIBTracer, lowklim=False):
    """fc + fs u: centrals at the halo center, satellites on the profile
    (Shang et al 2012 eq 20-21), shape (nz, nm, nk)."""
    us = 1.0 if lowklim else t.us
    return t.fc[..., None] + us * t.fs[..., None]


def _cib_square_term(t1: CIBTracer, t2: CIBTracer):
    """The 1-halo CIB pair term fc1 fs2 u2 + fc2 fs1 u1 + fs1 fs2 u1 u2 (the
    central self-pair is excluded, as in the HOD form).  When both tracers
    hold the same <u^2> tensor (two frequencies on one scattered profile,
    one concentration per halo) the satellite pair takes <u^2>; distinct
    profiles keep the product of the means."""
    u1, u2 = t1.us, t2.us
    fc1, fs1 = t1.fc[..., None], t1.fs[..., None]
    fc2, fs2 = t2.fc[..., None], t2.fs[..., None]
    if t1.us2 is not None and (t1.us2 is t2.us2):
        u1u2 = t1.us2
    else:
        u1u2 = u1 * u2
    return fc1 * fs2 * u2 + fc2 * fs1 * u1 + fs1 * fs2 * u1u2


def _term(tracer, ms, rho_matter0, lowklim=False):
    if isinstance(tracer, HODTracer):
        return _hod_term(tracer, lowklim)
    if isinstance(tracer, CIBTracer):
        return _cib_term(tracer, lowklim)
    if isinstance(tracer, MatterTracer):
        return _matter_term(tracer, ms, rho_matter0, lowklim)
    if isinstance(tracer, PressureTracer):
        return _pressure_term(tracer, lowklim)
    raise TypeError(f"a tracer is a MatterTracer, PressureTracer, HODTracer "
                    f"or CIBTracer, got {type(tracer).__name__}")


def one_halo_square_term(tracer1, tracer2, ms, rho_matter0):
    """The (z, m, k) pair term that power_1halo integrates.  One HOD sample
    with itself keeps the factorial-moment form, a scattered matter
    profile with itself takes <u^2>, two CIB tracers the CIB pair term, a
    pressure profile with itself its square; two distinct tracers
    factorize."""
    if tracer1 is tracer2 and isinstance(tracer1, HODTracer):
        return _hod_square_term(tracer1)
    if (tracer1 is tracer2 and isinstance(tracer1, MatterTracer)
            and tracer1.uk2 is not None):
        fac = ms[None, :, None] / rho_matter0
        return fac * fac * tracer1.uk2
    if isinstance(tracer1, CIBTracer) and isinstance(tracer2, CIBTracer):
        return _cib_square_term(tracer1, tracer2)
    if (isinstance(tracer1, PressureTracer)
            and isinstance(tracer2, PressureTracer)):
        return _pressure_term(tracer1) ** 2
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
    """(integral, consistency, b) for one 2-halo leg.  A pressure leg takes
    no consistency completion and b = 0, as in the reference; a CIB leg
    neither (its L(M) weight vanishes at low mass by itself)."""
    weighted = nzm[..., None] * bh[..., None]
    integral = _mass_integral(weighted * _term(tracer, ms, rho_matter0), ms)
    if isinstance(tracer, (PressureTracer, CIBTracer)):
        return integral, torch.zeros_like(integral), 0.0
    term0 = _term(tracer, ms, rho_matter0, lowklim=True)
    consistency = _mass_integral(weighted * term0, ms)
    b = tracer.bg[:, None] if isinstance(tracer, HODTracer) else 1.0
    return integral, consistency, b


def _leg_fnl(tracer, nzm, bh, ms, rho_matter0):
    """The (b - 1)-weighted 2-halo leg: the local-fNL response
    db = 2 fnl deltac (b - 1) / alpha(z, k) (Dalal et al 2008) integrated
    like b and completed at low k the same way.  A matter leg completes
    to 0 (bias consistency minus mass conservation), an HOD leg to
    bg - 1."""
    integral, consistency, b = _leg(tracer, nzm, bh - 1.0, ms, rho_matter0)
    if isinstance(tracer, HODTracer):
        b = b - 1.0
    elif not isinstance(tracer, (PressureTracer, CIBTracer)):
        b = 0.0
    return integral, consistency, b


def power_2halo(tracer1, tracer2, nzm, bh, ms, pzk_lin, rho_matter0,
                b1_in=None, b2_in=None, fnl=None, alpha_zk=None,
                deltac=1.42):
    """P_2h(z, k) with the low-k consistency completion, shape (nz, nk).

    b1_in, b2_in: a large-scale bias per z in place of a leg's completion.
    fnl: the local primordial non-Gaussianity amplitude, threaded through
    each leg's mass integral; it needs alpha_zk (nz, nk) from
    ``Cosmology.alpha_fnl``."""
    i1, c1, b1 = _leg(tracer1, nzm, bh, ms, rho_matter0)
    i2, c2, b2 = _leg(tracer2, nzm, bh, ms, rho_matter0)
    dev = pzk_lin.device
    if b1_in is not None:
        b1 = torch.as_tensor(b1_in, dtype=torch.float64,
                             device=dev).reshape(-1, 1)
    if b2_in is not None:
        b2 = torch.as_tensor(b2_in, dtype=torch.float64,
                             device=dev).reshape(-1, 1)
    e1 = i1 + b1 - c1
    e2 = i2 + b2 - c2
    if fnl is not None:
        if alpha_zk is None:
            raise ValueError("fnl needs alpha_zk (Cosmology.alpha_fnl)")
        pref = 2.0 * fnl * deltac / alpha_zk
        if1, cf1, bf1 = _leg_fnl(tracer1, nzm, bh, ms, rho_matter0)
        e1 = e1 + pref * (if1 + bf1 - cf1)
        if tracer2 is tracer1:
            if2, cf2, bf2 = if1, cf1, bf1
        else:
            if2, cf2, bf2 = _leg_fnl(tracer2, nzm, bh, ms, rho_matter0)
        e2 = e2 + pref * (if2 + bf2 - cf2)
    return pzk_lin * e1 * e2


def power_total(tracer1, tracer2, nzm, bh, ms, ks, pzk_lin, rho_matter0,
                kstar_damping=0.01, b1_in=None, b2_in=None):
    """P_1h + P_2h, shape (nz, nk); b1_in, b2_in as in ``power_2halo``."""
    return (power_1halo(tracer1, tracer2, nzm, ms, ks, rho_matter0,
                        kstar_damping)
            + power_2halo(tracer1, tracer2, nzm, bh, ms, pzk_lin,
                          rho_matter0, b1_in, b2_in))


@on_device_of_inputs
def exclusion_correction(ks, p2h_zk, r_excl_z):
    """Baldauf et al 2013 sharp halo exclusion: Delta P (nz, nk) to add to
    the 2-halo term,

        -4 pi int_0^R (1 + xi_2h(r)) j0(kr) r^2 dr,

    the '1' piece the analytic top-hat V_R 3 j1(kR)/(kR), the xi piece a
    finite sum on the FFTLog xi grid of p2h_zk itself under a logistic edge
    half a grid cell wide at r = R (which carries the d/dR edge term
    through autograd).  ks (nk,): a log-uniform numpy grid (or tensor);
    p2h_zk (nz, nk); r_excl_z: the comoving exclusion radius [Mpc],
    scalar or (nz,)."""
    from ..ops.fftlog import correlation_function

    ks_np = (ks.detach().cpu().numpy() if isinstance(ks, torch.Tensor)
             else np.asarray(ks, dtype=np.float64))
    dln = np.diff(np.log(ks_np))
    if not np.allclose(dln, dln[0], rtol=1e-6):
        raise ValueError(
            "exclusion_correction needs a log-uniform k grid (the xi "
            "table comes from FFTLog); got non-uniform dlnk")
    p2h_zk = tensor_or_f64(p2h_zk)
    dev = p2h_zk.device
    kt = torch.as_tensor(ks_np, device=dev)
    rz = torch.atleast_1d(torch.as_tensor(r_excl_z, dtype=torch.float64,
                                          device=dev))[:, None]
    rs, xi = correlation_function(ks_np, p2h_zk)
    dlnr = torch.log(rs[1] / rs[0])
    w = torch.full_like(rs, 1.0) * dlnr
    w = torch.cat([0.5 * dlnr.reshape(1), w[1:-1], 0.5 * dlnr.reshape(1)])
    mask = torch.sigmoid((torch.log(rz) - torch.log(rs)[None, :])
                         / (0.5 * dlnr))
    j0_rk = torch.sinc((rs[:, None] * kt[None, :]) / math.pi)
    xi_piece = 4.0 * math.pi * ((mask * xi * (w * rs**3)[None, :]) @ j0_rk)
    x = rz * kt[None, :]
    xs = torch.where(x > 1e-4, x, 1.0)
    tophat = torch.where(x > 1e-4,
                         3.0 * (torch.sin(xs) - xs * torch.cos(xs)) / xs**3,
                         1.0 - x * x / 10.0)
    vol_piece = (4.0 * math.pi / 3.0) * rz**3 * tophat
    return -(xi_piece + vol_piece)


def total_matter_power_spectrum(omch2, ombh2, Pnn, Pne, Pee):
    """fc^2 Pnn + 2 fc fb Pne + fb^2 Pee."""
    omtoth2 = omch2 + ombh2
    fc = omch2 / omtoth2
    fb = ombh2 / omtoth2
    return fc**2 * Pnn + 2.0 * fc * fb * Pne + fb**2 * Pee


def total_matter_galaxy_power_spectrum(omch2, ombh2, Pgn, Pge):
    """fc Pgn + fb Pge."""
    omtoth2 = omch2 + ombh2
    fc = omch2 / omtoth2
    fb = ombh2 / omtoth2
    return fc * Pgn + fb * Pge
