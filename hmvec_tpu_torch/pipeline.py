"""End-to-end pipelines of the PyTorch port: cosmological parameters ->
spectra (port of hmvec_tpu/pipeline.py).

``make_pmm_fn`` builds params -> Pmm(1h+2h)(z, k) on a static (zs, ks, ms)
grid, on one explicit device.  The stages run in the order of the JAX
package's ``_stages``: background; EH98 linear power; sigma^2(R, z) as one
(z, k) @ (k, m) matmul; Sheth-Tormen n(z, m) and bias; Duffy concentration
and r_vir; the NFW u(k | z, m); the 1h + 2h mass integrals.  The NFW stage
runs the plain float64 version (``fast=False``) or a hand-written CUDA
kernel (``fast=True``, ``fast="exact"``, ``fused_serving=True``; see
ops/nfw_kernels.py).  Every path is differentiable through autograd;
``fisher_jacobian`` takes d Pmm / d theta in forward mode.

``make_electron_fn`` builds params -> (Pee, Pme) on the same stages plus
the M200 conversion and the numeric Battaglia gas-profile transform, whose
resample step runs a hand-written CUDA kernel on the card
(ops/resample_kernels.py).

``make_lensing_cls_fn`` builds params -> (C_kk, Pmm), the Limber
projection of Pmm against the lensing window (models/limber.py), and
``make_hod_fn`` params -> (Pgg, Pgm), with the HOD grid and its
ngal -> mthresh bisection (models/hod.py).

``make_ksz_snr_fn`` builds (params, Cls) -> (snr, Nvv(mu, kL), vrec), the
kSZ velocity-reconstruction forecast of one redshift bin: the stages, the
electron transform, the HOD with its ngal solve, the small-scale Pgg/Pge,
the large-scale velocity weights, N_vv and the SNR.
``make_ksz_survey_fn`` runs the same forecast for a set of bins whose
redshifts, volumes and densities are call arguments, as one
``torch.func.vmap`` over the bins.

``make_batched_fn`` batches any of them over sets of parameters with
``torch.func.vmap``; each hand-written kernel then runs once for the whole
batch.  Every ``make_*_fn`` takes ``engine=``, the linear-power engine
(models/linear_power.py; None is ``EHEngine()``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .models import background as bgmod
from .models import ksz as kszm
from .models import limber as limb
from .models import linear_power as lpm
from .models import mass_function as mfm
from .models import power as pwr
from .models import profiles as prof
from .models.hod import build_hod
from .models.mass_conversion import mdelta_from_mdelta
from .ops.nfw_kernels import nfw_contract, nfw_uk
from .ops.quadrature import trapz
from .ops.sine_transform import generic_profile_fft, profile_table
from .params import battaglia_defaults, merge_params, to_torch_params
from .utils.weights import catmull_taps_nonuniform, simpson_weights

_F64 = torch.float64
_SIGMA2_KEYS = ("sigma2_kmin", "sigma2_kmax", "sigma2_numks")


def _growth_mode_from(overrides, setting: str) -> str:
    """Resolve the growth-factor mode for one call.

    'auto': no w0/wa override -> the LCDM closed form.  A w0/wa that is
    differentiated (requires grad or carries a forward-mode tangent),
    batched (``make_batched_fn``) or differs from the fiducial (-1, 0) ->
    'ode', the integrated growing mode (background.growth_table): the
    closed form's dD/dw0 is identically zero.  Pass 'closed' or 'ode' to
    force one.
    """
    if setting != "auto":
        return setting
    o = overrides or {}
    return bgmod.growth_mode_for({k: o[k] for k in ("w0", "wa") if k in o})


def _check_nfw_tier(fast):
    if fast not in (False, True, "exact"):
        raise ValueError(f"fast must be False, True or 'exact', got {fast!r}")


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but "
                               f"torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


class _Grids:
    """The static grids of one pipeline as float64 tensors on its device,
    with the host-side quadrature weights and interpolation taps.  ``zs``
    None: the redshifts are call arguments (``make_ksz_survey_fn``)."""

    def __init__(self, zs, ks, ms, defaults, uk_subsample, device):
        self.device = device
        self.ks_np = np.asarray(ks, dtype=np.float64)
        self.ms_np = np.asarray(ms, dtype=np.float64)
        self.ks, self.ms = self.tensor(self.ks_np), self.tensor(self.ms_np)
        self.zs_np = self.zs = None
        if zs is not None:
            self.zs_np = np.asarray(zs, dtype=np.float64)
            self.zs = self.tensor(self.zs_np)
        self._sigma2 = {}
        self.sigma2_grid(defaults)
        self.kq = self.ks
        self.taps = None
        if uk_subsample is not None:
            # evaluate u(k) on a k grid thinned by `every` below `ksplit`
            # and fill in by Catmull-Rom in ln k (pipeline.py of the JAX
            # package, _stages)
            ksplit, every = uk_subsample
            ilow = np.where(self.ks_np < ksplit)[0]
            sub = np.unique(np.concatenate(
                [ilow[::every], ilow[-1:],
                 np.where(self.ks_np >= ksplit)[0]]))
            tap_i, tap_w = catmull_taps_nonuniform(np.log(self.ks_np[sub]),
                                                   np.log(self.ks_np))
            self.kq = self.tensor(self.ks_np[sub])
            self.taps = (torch.as_tensor(tap_i, device=device),
                         self.tensor(tap_w))

    def tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               dtype=_F64, device=self.device)

    def sigma2_grid(self, p):
        """(ks, k^2 w / 2 pi^2) of the sigma^2 integral for params p,
        cached by the grid settings (static: they shape the grid, so an
        override given as a tensor is read back as a number)."""
        kmin, kmax, numks = (p[k] for k in _SIGMA2_KEYS)
        key = (float(kmin), float(kmax), int(numks))
        if key not in self._sigma2:
            ks_np = lpm.sigma2_k_grid(dict(zip(_SIGMA2_KEYS, key)))
            kw = simpson_weights(ks_np) * ks_np**2 / (2.0 * np.pi**2)
            self._sigma2[key] = (self.tensor(ks_np), self.tensor(kw))
        return self._sigma2[key]

    def resample(self, y):
        """Catmull-Rom fill-in of the thinned-k values y (..., nkq)."""
        if self.taps is None:
            return y
        tap_i, tap_w = self.taps
        return sum(y[..., tap_i[j]] * tap_w[j] for j in range(4))


class _StageOut(NamedTuple):
    bg: bgmod.BackgroundParams
    pzk: torch.Tensor
    nzm: torch.Tensor
    bh: torch.Tensor
    rho_m0: torch.Tensor
    uk: object                 # u (nz, nm, nk), or (cs, rss)
    growth_table: object       # the call's GrowthTable, or None


def _stages(p, g: _Grids, mass_function, mdef, accuracy, engine,
            fast_nfw=False, growth_mode="closed", profile="uk"):
    """Background through mass function and the NFW stage; returns
    (bg, pzk, nzm, bh, rho_m0, uk, growth_table) or, for
    profile='inputs', the NFW inputs (cs, rss) in place of uk.
    growth_table is the call's one table ('ode'), else None."""
    bg = bgmod.background(p, g.device)
    zs, ks, ms = g.zs, g.ks, g.ms
    # one growth table per call, shared by every linear spectrum
    growth = {"growth_mode": growth_mode,
              "growth_table": (bgmod.growth_table(bg)
                               if growth_mode == "ode" else None)}

    # linear power on the target grid
    if accuracy == "low":
        pzk = lpm.plin_approx(bg, zs, ks, **growth)
    else:
        pzk = engine.pzk_grid(bg, zs, ks, **growth)

    # sigma^2 -> mass function
    ks_s2, kw = g.sigma2_grid(p)
    spzk = engine.plin(bg, zs, ks_s2, accuracy=accuracy, **growth)
    rho_m0 = bgmod.rho_matter_z(bg, 0.0)
    R = mfm.R_from_M(ms, rho_m0, delta=1.0)
    sigma2 = lpm.sigma2_weighted(R, spzk, ks_s2, kw, p["Wkr_taylor_switch"])
    nzm, bh = mfm.mass_function_grid(sigma2, zs, ms, rho_m0,
                                     mass_function, p)

    # concentration, r_vir and the NFW profile
    omz = bgmod.omz(bg, zs)
    rhocritz = bgmod.rho_critical_z(bg, zs)
    rhomz = bgmod.rho_matter_z(bg, zs)
    cs = prof.concentration_duffy(ms, zs, mdef, p, p["H0"] / 100.0)
    rvirs = prof.rvir_grid(ms, zs, mdef, rhocritz, rhomz, omz)
    rss = rvirs / cs
    if profile == "inputs":
        return _StageOut(bg, pzk, nzm, bh, rho_m0, (cs, rss),
                         growth["growth_table"])

    if fast_nfw:
        nz, nm = cs.shape
        scales = (rss * (1.0 + zs)[:, None]).reshape(-1)
        tier = "exact" if fast_nfw == "exact" else "fast"
        uk = nfw_uk(g.kq, scales, cs.reshape(-1), tier=tier)
        uk = uk.reshape(nz, nm, -1).to(_F64)
    else:
        uk = prof.nfw_uk_analytic(g.kq, zs, cs, rss)
    return _StageOut(bg, pzk, nzm, bh, rho_m0, g.resample(uk),
                     growth["growth_table"])


def make_pmm_fn(zs, ks, ms, *, device, mass_function: str = "sheth-torman",
                mdef: str = "vir", accuracy: str = "medium", engine=None,
                fast=False, growth: str = "auto",
                static_params: dict | None = None, uk_subsample=None,
                fused_serving: bool = False):
    """Build params -> Pmm(1h+2h), shape (nz, nk), on a static grid.

    The returned function takes a dict of cosmological parameter overrides
    (Python numbers, numpy values or float64 tensors, which may carry
    gradients) and returns a float64 tensor on ``device``.

    device: 'cpu' or 'cuda[:i]'; required.  A CUDA device without a card
        raises.
    mass_function: 'sheth-torman', 'tinker', 'tinker2008',
        'press-schechter' or 'despali' (models/mass_function.py).
    engine: the linear-power engine (``EHEngine``, ``TabulatedEngine`` or
        a ``linear_power.make_engine`` product); None is ``EHEngine()``.
    fast: False -- the plain float64 NFW stage; True -- the fast-tier CUDA
        kernel (float32 Si/Ci, <= 5e-6 on u); "exact" -- the float64 CUDA
        kernel.  On the CPU both kernel tiers run the plain version.
    fused_serving: u(k) and both mass integrals in one CUDA kernel
        (``nfw_contract``); as in the JAX package it ignores ``fast``.
    static_params: build-time default overrides (e.g. sigma2_numks).
    uk_subsample: (ksplit, every) -- evaluate u(k) on a k grid thinned by
        ``every`` below ``ksplit`` and fill in by Catmull-Rom in ln k.
    growth: 'auto' (the closed form unless w0/wa are overridden away from
        (-1, 0) or differentiated, then the integrated growth), 'closed'
        or 'ode'.
    """
    _check_nfw_tier(fast)
    dev = _resolve_device(device)
    defaults = merge_params(static_params)
    grids = _Grids(zs, ks, ms, defaults, uk_subsample, dev)
    engine = engine or lpm.EHEngine()

    if fused_serving:
        return _make_pmm_fused_fn(grids, mass_function, mdef, accuracy,
                                  engine, growth, defaults)

    def pmm(overrides=None):
        ov = to_torch_params(overrides, dev)
        p = {**defaults, **ov}
        _, pzk, nzm, bh, rho_m0, uk, _ = _stages(
            p, grids, mass_function, mdef, accuracy, engine,
            fast_nfw=fast, growth_mode=_growth_mode_from(ov, growth))
        tr = pwr.MatterTracer(uk=uk)
        return pwr.power_total(tr, tr, nzm, bh, grids.ms, grids.ks, pzk,
                               rho_m0, p["kstar_damping"])

    pmm.device = dev
    return pmm


def make_lensing_cls_fn(zs, ks, ms, ells, zsource: float = 1100.0, *, device,
                        mass_function: str = "sheth-torman",
                        mdef: str = "vir", accuracy: str = "medium",
                        engine=None, fast=False, growth: str = "auto"):
    """Build params -> (C_kk, Pmm): the halo-model lensing convergence
    spectrum at the multipoles ``ells`` for a source at ``zsource``,
    shape (nl,), and the Pmm (nz, nk) it projects (bench config 4 of the
    JAX package).  float64 tensors on ``device``.

    fast: the NFW stage, as in ``make_pmm_fn``.  The assembly stays
    float64 in every tier (the JAX package's ``fast_assembly`` exists for
    the TPU's emulated float64 and is not ported).
    """
    _check_nfw_tier(fast)
    dev = _resolve_device(device)
    defaults = merge_params()
    grids = _Grids(zs, ks, ms, defaults, None, dev)
    ells_t = grids.tensor(ells)
    engine = engine or lpm.EHEngine()

    def cls_fn(overrides=None):
        ov = to_torch_params(overrides, dev)
        p = {**defaults, **ov}
        bg, pzk, nzm, bh, rho_m0, uk, _ = _stages(
            p, grids, mass_function, mdef, accuracy, engine,
            fast_nfw=fast, growth_mode=_growth_mode_from(ov, growth))
        tr = pwr.MatterTracer(uk=uk)
        pmm = pwr.power_total(tr, tr, nzm, bh, grids.ms, grids.ks, pzk,
                              rho_m0, p["kstar_damping"])
        ckk = limb.C_kk(bg, ells_t, grids.zs, grids.ks, pmm, lzs1=zsource,
                        lzs2=zsource)
        return ckk, pmm

    cls_fn.device = dev
    return cls_fn


def make_hod_fn(zs, ks, ms, ngal, *, device,
                mass_function: str = "sheth-torman", mdef: str = "vir",
                accuracy: str = "medium", engine=None, fast=False,
                growth: str = "auto"):
    """Build params -> (Pgg, Pgm): the HOD galaxy auto spectrum and its
    cross with matter, each (nz, nk) float64 on ``device``, for the galaxy
    number densities ``ngal`` (nz,) in 1/Mpc^3 (bench config 3 of the JAX
    package).  Every call solves ngal -> the stellar-mass threshold by a
    fixed-count bisection (hod_bisection_num_iter rounds, 90 by default),
    which passes no derivative to the threshold.

    fast: the NFW stage, as in ``make_pmm_fn``; the assembly stays float64.
    """
    _check_nfw_tier(fast)
    dev = _resolve_device(device)
    defaults = merge_params()
    grids = _Grids(zs, ks, ms, defaults, None, dev)
    ngal_t = grids.tensor(ngal)
    engine = engine or lpm.EHEngine()

    def hod_fn(overrides=None):
        ov = to_torch_params(overrides, dev)
        p = {**defaults, **ov}
        _, pzk, nzm, bh, rho_m0, uk, _ = _stages(
            p, grids, mass_function, mdef, accuracy, engine,
            fast_nfw=fast, growth_mode=_growth_mode_from(ov, growth))
        hp = {k: p[k] for k in p if k.startswith("hod_")}
        grid = build_hod(grids.zs, grids.ms, nzm, bh, hp, ngal=ngal_t)
        tg = pwr.HODTracer(Nc=grid.Nc, Ns=grid.Ns, NsNsm1=grid.NsNsm1,
                           NcNs=grid.NcNs, ngal=grid.ngal, bg=grid.bg,
                           us=uk, uc=None)
        tn = pwr.MatterTracer(uk=uk)
        pgg = pwr.power_total(tg, tg, nzm, bh, grids.ms, grids.ks, pzk,
                              rho_m0, p["kstar_damping"])
        pgm = pwr.power_total(tg, tn, nzm, bh, grids.ms, grids.ks, pzk,
                              rho_m0, p["kstar_damping"])
        return pgg, pgm

    hod_fn.device = dev
    return hod_fn


_ELECTRON_GRID_KEYS = ("electron_density_profile_integral_numxs",
                       "electron_density_profile_integral_xmax")
# parameters that shape a grid or a loop: never batched
_STATIC_PARAMS = (*_SIGMA2_KEYS, *_ELECTRON_GRID_KEYS,
                  "hod_bisection_num_iter")


def _gas_profile(p, zs, ms, bg, mdef, fit):
    """(rhofunc, cmaxs, rgs) of the electron profile transform at the
    redshifts zs (nz,) and masses ms (nm,): the Battaglia gas density on
    x = r / (R200/2), with M200 from the halo mass by the NFW
    mass-definition conversion, truncated at c = r_vir / rgs, and the
    scale radii rgs = R200/2."""
    rhocritz = bgmod.rho_critical_z(bg, zs)
    omz = bgmod.omz(bg, zs)
    rhomz = bgmod.rho_matter_z(bg, zs)
    cs = prof.concentration_duffy(ms, zs, mdef, p, p["H0"] / 100.0)
    rvirs = prof.rvir_grid(ms, zs, mdef, rhocritz, rhomz, omz)
    if mdef == "vir":
        dr1 = rhocritz * mfm.deltav_bryan_norman(omz)
    else:
        dr1 = rhomz * 200.0
    m200 = mdelta_from_mdelta(ms, cs, dr1, 200.0 * rhocritz)
    r200 = mfm.R_from_M(m200, rhocritz[:, None], delta=200.0)
    omb = p["ombh2"] / (p["H0"] / 100.0) ** 2

    def rhofunc(xsamp):
        return prof.rho_gas_x(xsamp[None, None, :], m200[..., None],
                              zs[:, None, None], omb, bg.omm0,
                              rhocritz[:, None, None],
                              p["battaglia_gas_gamma"], fit)

    rgs = r200 / 2.0
    return rhofunc, rvirs / rgs, rgs


def _electron_grid(overrides, defaults, nxs, xmax):
    """(nxs, xmax) as Python numbers: the build-time values, else the
    electron profile parameters from the caller's overrides or the
    defaults.  They shape the sample grid, so a tensor is refused (it
    would have to be read back from the device)."""
    out = []
    for key, val in zip(_ELECTRON_GRID_KEYS, (nxs, xmax)):
        if val is None:
            val = (overrides or {}).get(key, defaults[key])
        if isinstance(val, torch.Tensor):
            raise TypeError(f"{key} shapes the sample grid: pass a Python "
                            f"number, not a tensor")
        out.append(val)
    return int(out[0]), float(out[1])


def make_electron_fn(zs, ks, ms, *, device, family: str = "AGN",
                     nxs: int | None = None, xmax: float | None = None,
                     mass_function: str = "sheth-torman", mdef: str = "vir",
                     accuracy: str = "medium", engine=None,
                     fast: bool = False, growth: str = "auto"):
    """Build params -> (Pee, Pme): the Battaglia gas-density electron
    auto spectrum and its cross with matter, each (nz, nk) float64 on
    ``device`` (bench config 2 of the JAX package).

    The electron profile is the Battaglia 2016 gas density of the family's
    fit, truncated at r_vir and transformed numerically
    (``ops.sine_transform.generic_profile_fft``, nxs samples on (0, xmax]
    in units of R200/2); M200 comes from the halo mass by the NFW
    mass-definition conversion.  The matter leg is the NFW profile of
    ``make_pmm_fn``.

    device: 'cpu' or 'cuda[:i]'; required.
    nxs, xmax: the sample grid; None reads the parameters
        electron_density_profile_integral_numxs / _xmax from the overrides
        or the defaults, as Python numbers.
    fast: False -- the plain float64 NFW stage and a float64 transform,
        resampled by the float64-storage kernel on the card; True -- the
        fast-tier NFW kernel, and the transform sampled in float32
        (complex64 FFT, float32 table resampled by the float32-storage
        kernel).  The port ties float32 sampling to ``fast``; the JAX
        package ties it to the backend (float32 on the TPU).  On the CPU
        both kernels run their plain versions.
    growth: 'auto', 'closed' or 'ode', as in ``make_pmm_fn``.
    """
    if fast not in (False, True):
        raise ValueError(f"fast must be False or True, got {fast!r}")
    dev = _resolve_device(device)
    defaults = merge_params()
    grids = _Grids(zs, ks, ms, defaults, None, dev)
    engine = engine or lpm.EHEngine()
    fit = dict(battaglia_defaults[family])
    sample_dtype = torch.float32 if fast else _F64

    def electron(overrides=None):
        nxs_l, xmax_l = _electron_grid(overrides, defaults, nxs, xmax)
        ov = to_torch_params(overrides, dev)
        p = {**defaults, **ov}
        bg, pzk, nzm, bh, rho_m0, uk_nfw, _ = _stages(
            p, grids, mass_function, mdef, accuracy, engine,
            fast_nfw=fast, growth_mode=_growth_mode_from(ov, growth))
        rhofunc, cmaxs, rgs = _gas_profile(p, grids.zs, grids.ms, bg, mdef,
                                           fit)
        _, uk_e = generic_profile_fft(rhofunc, cmaxs, rgs, grids.zs,
                                      grids.ks, xmax_l, nxs_l,
                                      sample_dtype=sample_dtype)
        te = pwr.MatterTracer(uk=uk_e)
        tn = pwr.MatterTracer(uk=uk_nfw)
        pee = pwr.power_total(te, te, nzm, bh, grids.ms, grids.ks, pzk,
                              rho_m0, p["kstar_damping"])
        pme = pwr.power_total(tn, te, nzm, bh, grids.ms, grids.ks, pzk,
                              rho_m0, p["kstar_damping"])
        return pee, pme

    electron.device = dev
    return electron


def electron_stage_inputs(zs, ks, ms, overrides=None, *, device, nxs, xmax,
                          fast: bool = False, family: str = "AGN",
                          mdef: str = "vir"):
    """What ``make_electron_fn`` hands the resample kernel at one
    cosmology: (u, scales, ks, dkt), with u (nz, nm, nxs//2 + 1) the
    u(kt) table (float64, or float32 for ``fast=True``), scales (nz, nm)
    and ks (nk,) float64 tensors on ``device``, and dkt a Python float."""
    dev = _resolve_device(device)
    defaults = merge_params()
    grids = _Grids(zs, ks, ms, defaults, None, dev)
    p = {**defaults, **to_torch_params(overrides, dev)}
    bg = bgmod.background(p, dev)
    rhofunc, cmaxs, rgs = _gas_profile(p, grids.zs, grids.ms, bg, mdef,
                                       dict(battaglia_defaults[family]))
    u, scales, dkt, _ = profile_table(
        rhofunc, cmaxs, rgs, grids.zs, xmax, nxs,
        sample_dtype=torch.float32 if fast else _F64)
    return u, scales, grids.ks, dkt


def _contract_inputs(p, grids: _Grids, mass_function, mdef, accuracy,
                     engine, growth_mode):
    """(pzk, scales, cs, a, b, c_z) of the fused tier for params p: the
    kernel's row inputs scales = r_s (1+z) and c, the mass-integral weights
    a = w n (m/rho)^2 and b = w n b_h (m/rho), all (nz, nm), and the
    u -> 1 consistency sum c_z = sum_m b."""
    _, pzk, nzm, bh, rho_m0, (cs, rss), _ = _stages(
        p, grids, mass_function, mdef, accuracy, engine,
        growth_mode=growth_mode, profile="inputs")
    w_m = pwr.mass_weights(grids.ms)
    mfac = grids.ms[None, :] / rho_m0
    a_zm = w_m[None, :] * nzm * mfac**2
    b_zm = w_m[None, :] * nzm * bh * mfac
    scales = rss * (1.0 + grids.zs)[:, None]
    return pzk, scales, cs, a_zm, b_zm, b_zm.sum(dim=1)


def _make_pmm_fused_fn(grids: _Grids, mass_function, mdef, accuracy, engine,
                       growth, defaults):
    """Fused-contraction tier: u(k) and its two mass integrals

        S1(z,k) = int dm n(m) (m/rho)^2 u^2      (1-halo)
        S2(z,k) = int dm n(m) b(m) (m/rho) u     (2-halo leg)

    in one ``nfw_contract`` pass, so the (z, m, k) cube is never stored.
    The consistency completion (u -> 1) is the same integrals with u = 1,
    plain sums."""

    def pmm(overrides=None):
        ov = to_torch_params(overrides, grids.device)
        p = {**defaults, **ov}
        pzk, scales, cs, a_zm, b_zm, c_z = _contract_inputs(
            p, grids, mass_function, mdef, accuracy, engine,
            _growth_mode_from(ov, growth))
        s1, s2 = nfw_contract(grids.kq, scales, cs, a_zm, b_zm)
        s1, s2 = grids.resample(s1), grids.resample(s2)
        damping = 1.0 - torch.exp(-((grids.ks / p["kstar_damping"]) ** 2))
        e = s2 + 1.0 - c_z[:, None]
        return s1 * damping[None, :] + pzk * e**2

    pmm.device = grids.device
    return pmm


def nfw_stage_inputs(zs, ks, ms, overrides=None, *, device,
                     mass_function: str = "sheth-torman", mdef: str = "vir",
                     accuracy: str = "medium", engine=None):
    """What ``make_pmm_fn`` hands the NFW kernels at one cosmology:
    (ks, scales, cs, a, b) as float64 tensors on ``device``, with
    scales = r_s (1+z), cs and the fused tier's weights a, b of shape
    (nz, nm).  ``nfw_uk`` takes scales and cs flattened to (nz * nm,)."""
    dev = _resolve_device(device)
    defaults = merge_params()
    grids = _Grids(zs, ks, ms, defaults, None, dev)
    ov = to_torch_params(overrides, dev)
    _, scales, cs, a_zm, b_zm, _ = _contract_inputs(
        {**defaults, **ov}, grids, mass_function, mdef, accuracy,
        engine or lpm.EHEngine(), _growth_mode_from(ov, "auto"))
    return grids.ks, scales, cs, a_zm, b_zm


def _linspace(start, stop, num: int):
    """``jax.numpy.linspace(start, stop, num)`` for tensor endpoints, with
    its arithmetic: start (1 - s) + stop s at s = i / (num - 1), and the
    end point exactly ``stop``.  ``torch.linspace`` takes no batched or
    differentiated endpoint."""
    start = torch.as_tensor(start, dtype=_F64)
    stop = torch.as_tensor(stop, dtype=_F64, device=start.device)
    div = num - 1
    s = torch.arange(div, dtype=_F64, device=start.device) / float(div)
    return torch.cat([start * (1.0 - s) + stop * s, stop.reshape(1)])


def _ksz_large_scale(bg, p, zs1, kLs, mu, ks, Cls, sPge, sPgg, bgal, b_eff,
                     ngg, plin_L, f, volume_gpc3):
    """(snr, Nvv(mu, kL), d2vs) of one redshift bin from its small-scale
    spectra sPge, sPgg (nkS,) and its large-scale linear power plin_L
    (nkL,): N_vv from the kS integral, then
    snr^2 = V int dmu int dkL kL^2 Pgv^2 / (Pgg + Ngg) / N_vv / (2 pi)^2
    with Pgg = b^2 P, Pgv = b P f a H / kL and b = b_eff."""
    a = 1.0 / (1.0 + zs1)
    H = bgmod.h_of_z(bg, zs1)
    d2vs = (f * a * H)[:, None] / kLs[None, :]
    chistar = bgmod.comoving_radial_distance(bg, zs1)[0]
    Fstar = kszm.ksz_radial_function(zs1, p["ombh2"], p.get("Yp", 0.24),
                                     params=p)[0]
    nvv = kszm.Nvv_core_integral(chistar, Fstar, mu, kLs, ks, Cls, sPge,
                                 sPgg + ngg)
    zero_mu = 0.0 * mu[:, None]
    lPgg = plin_L[None, :] * b_eff**2 + zero_mu
    lPgv = (plin_L * b_eff * d2vs[0])[None, :] + zero_mu
    integrand = kszm._sanitize(kLs[None, :] ** 2 * lPgv**2 / (lPgg + ngg)
                               / nvv)
    snr2 = trapz(trapz(integrand, kLs), mu) / (2.0 * math.pi) ** 2
    return torch.sqrt(volume_gpc3 * 1e9 * snr2), nvv, d2vs


def make_ksz_snr_fn(z: float, volume_gpc3: float, ngal_mpc3: float, *,
                    device, kL_max: float = 0.1, num_kL_bins: int = 100,
                    kS_min: float = 0.1, kS_max: float = 10.0,
                    num_kS_bins: int = 101, num_mu_bins: int = 102, ms=None,
                    family: str = "AGN", nxs: int = 4096, xmax: float = 20.0,
                    mass_function: str = "sheth-torman", mdef: str = "vir",
                    accuracy: str = "medium", engine=None,
                    growth: str = "auto"):
    """Build (params, Cls) -> (snr, Nvv(mu, kL), vrec): the kSZ velocity
    reconstruction forecast of one redshift bin (bench config 5 of the JAX
    package), float64 tensors on ``device``: snr 0-d, Nvv
    (num_mu_bins, num_kL_bins), vrec (1,).

    The halo model of the bin (the stages with the plain NFW u, the
    Battaglia gas transform of ``make_electron_fn`` sampled in float64,
    the HOD with its ngal solve) gives the small-scale Pgg and Pge on
    num_kS_bins k in [kS_min, kS_max]; the linear power on num_kL_bins k
    from the volume's fundamental mode to kL_max, with the growth rate f,
    gives the large-scale Pgg and Pgv.  ``Cls`` (nl,): the CMB's total
    C_l, read at l = chi(z) k.  Both bisections (M200 and ngal) pass no
    derivative, as in the JAX package.

    ms: the mass grid (None: geomspace(1e6, 1e16, 1000)).
    growth: 'auto', 'closed' or 'ode', as in ``make_pmm_fn``.
    """
    dev = _resolve_device(device)
    if ms is None:
        ms = np.geomspace(1e6, 1e16, 1000)
    zs = np.atleast_1d(np.asarray(z, dtype=np.float64))
    defaults = merge_params()
    grids = _Grids(zs, np.geomspace(kS_min, kS_max, num_kS_bins), ms,
                   defaults, None, dev)
    mu = grids.tensor(np.linspace(-1.0, 1.0, num_mu_bins))
    kLs = grids.tensor(np.geomspace(kszm.get_kmin(volume_gpc3), kL_max,
                                    num_kL_bins))
    ngal = grids.tensor(np.atleast_1d(np.asarray(ngal_mpc3)))
    ngg = kszm.Ngg(ngal)
    engine = engine or lpm.EHEngine()
    fit = dict(battaglia_defaults[family])
    nxs, xmax = int(nxs), float(xmax)

    def fn(overrides, Cls):
        ov = to_torch_params(overrides, dev)
        p = {**defaults, **ov}
        gm = _growth_mode_from(ov, growth)
        bg, pzk, nzm, bh, rho_m0, uk, table = _stages(
            p, grids, mass_function, mdef, accuracy, engine, growth_mode=gm)
        rhofunc, cmaxs, rgs = _gas_profile(p, grids.zs, grids.ms, bg, mdef,
                                           fit)
        _, uk_e = generic_profile_fft(rhofunc, cmaxs, rgs, grids.zs,
                                      grids.ks, xmax, nxs)
        hp = {k: p[k] for k in p if k.startswith("hod_")}
        grid = build_hod(grids.zs, grids.ms, nzm, bh, hp, ngal=ngal)
        tg = pwr.HODTracer(Nc=grid.Nc, Ns=grid.Ns, NsNsm1=grid.NsNsm1,
                           NcNs=grid.NcNs, ngal=grid.ngal, bg=grid.bg,
                           us=uk, uc=None)
        te = pwr.MatterTracer(uk=uk_e)
        sPgg = pwr.power_total(tg, tg, nzm, bh, grids.ms, grids.ks, pzk,
                               rho_m0, p["kstar_damping"])
        sPge = pwr.power_total(tg, te, nzm, bh, grids.ms, grids.ks, pzk,
                               rho_m0, p["kstar_damping"])

        # the large-scale velocity spectra
        plin_L = engine.plin(bg, grids.zs, kLs, accuracy=accuracy,
                             growth_mode=gm, growth_table=table)
        f = bgmod.growth_rate_f(bg, grids.zs, mode=gm, table=table)
        bgal = grid.bg
        snr, nvv, d2vs = _ksz_large_scale(
            bg, p, grids.zs, kLs, mu, grids.ks,
            torch.as_tensor(Cls, dtype=_F64, device=dev), sPge[0], sPgg[0],
            bgal, bgal[0], ngg[0], plin_L[0], f, volume_gpc3)
        flPgg = plin_L * bgal[:, None] ** 2 + ngg[:, None]
        flPgv = plin_L * bgal[:, None] * d2vs
        vrec = trapz(kszm._sanitize(kLs[None, :] ** 2 * flPgv**2 / flPgg),
                     kLs)
        return snr, nvv, vrec

    fn.device = dev
    return fn


def make_ksz_survey_fn(num_bins: int, *, device, kL_max: float = 0.1,
                       num_kL_bins: int = 100, kS_min: float = 0.1,
                       kS_max: float = 10.0, num_kS_bins: int = 101,
                       num_mu_bins: int = 102, ms=None, family: str = "AGN",
                       nxs: int = 2048, xmax: float = 20.0,
                       mass_function: str = "sheth-torman",
                       mdef: str = "vir", accuracy: str = "medium",
                       engine=None, growth: str = "auto"):
    """Build the survey-level kSZ forecast: fn(overrides, zcents (B,),
    vols_gpc3 (B,), ngals (B,), Cls, bs=None) -> (total_snr, per_bin_snr
    (B,), bgals (B,)), with total_snr^2 the sum of the bins' snr^2.

    Each bin is ``make_ksz_snr_fn``'s forecast at its redshift, volume and
    galaxy density (the linear power from ``engine.plin``, u from the
    plain NFW form), all call arguments: the bins run as one
    ``torch.func.vmap`` over them, so every stage, both bisections and the
    resample kernel run once for all bins, and nothing reads a bin's
    values on the host.  ``bs`` (B,): a large-scale galaxy bias per bin
    in place of the HOD's where it is > 0.  ``num_bins`` is kept for the
    JAX package's signature; the shapes come from the inputs.
    """
    del num_bins
    dev = _resolve_device(device)
    if ms is None:
        ms = np.geomspace(1e6, 1e16, 1000)
    defaults = merge_params()
    grids = _Grids(None, np.geomspace(kS_min, kS_max, num_kS_bins), ms,
                   defaults, None, dev)
    mu = grids.tensor(np.linspace(-1.0, 1.0, num_mu_bins))
    engine = engine or lpm.EHEngine()
    fit = dict(battaglia_defaults[family])
    nxs, xmax = int(nxs), float(xmax)
    acc_l = "low" if accuracy == "low" else "medium"
    log_kL_max = math.log(kL_max)

    def one_bin(p, bg, growth, Cls, z, vol_gpc3, ngal, b_ov):
        zs1 = z.reshape(1)
        ks, ms_t = grids.ks, grids.ms
        pzk = engine.plin(bg, zs1, ks, accuracy=acc_l, **growth)
        ks_s2, kw = grids.sigma2_grid(p)
        spzk = engine.plin(bg, zs1, ks_s2, accuracy=accuracy, **growth)
        rho_m0 = bgmod.rho_matter_z(bg, 0.0)
        R = mfm.R_from_M(ms_t, rho_m0, delta=1.0)
        sigma2 = lpm.sigma2_weighted(R, spzk, ks_s2, kw,
                                     p["Wkr_taylor_switch"])
        nzm, bh = mfm.mass_function_grid(sigma2, zs1, ms_t, rho_m0,
                                         mass_function, p)
        omz = bgmod.omz(bg, zs1)
        rhocritz = bgmod.rho_critical_z(bg, zs1)
        rhomz = bgmod.rho_matter_z(bg, zs1)
        cs = prof.concentration_duffy(ms_t, zs1, mdef, p, p["H0"] / 100.0)
        rvirs = prof.rvir_grid(ms_t, zs1, mdef, rhocritz, rhomz, omz)
        uk = prof.nfw_uk_analytic(ks, zs1, cs, rvirs / cs)
        rhofunc, cmaxs, rgs = _gas_profile(p, zs1, ms_t, bg, mdef, fit)
        _, uk_e = generic_profile_fft(rhofunc, cmaxs, rgs, zs1, ks, xmax,
                                      nxs)

        hp = {k: p[k] for k in p if k.startswith("hod_")}
        grid = build_hod(zs1, ms_t, nzm, bh, hp, ngal=ngal.reshape(1))
        tg = pwr.HODTracer(Nc=grid.Nc, Ns=grid.Ns, NsNsm1=grid.NsNsm1,
                           NcNs=grid.NcNs, ngal=grid.ngal, bg=grid.bg,
                           us=uk, uc=None)
        te = pwr.MatterTracer(uk=uk_e)
        sPgg = pwr.power_total(tg, tg, nzm, bh, ms_t, ks, pzk, rho_m0,
                               p["kstar_damping"])
        sPge = pwr.power_total(tg, te, nzm, bh, ms_t, ks, pzk, rho_m0,
                               p["kstar_damping"])

        # the bin's long-wavelength grid, from its volume
        kmin = math.pi / (vol_gpc3 * 1e9) ** (1.0 / 3.0)
        kLs = torch.exp(_linspace(torch.log(kmin), log_kL_max, num_kL_bins))
        plin_L = engine.plin(bg, zs1, kLs, accuracy=acc_l, **growth)
        f = bgmod.growth_rate_f(bg, zs1, mode=growth["growth_mode"],
                                table=growth["growth_table"])
        bgal = grid.bg
        b_eff = torch.where(b_ov > 0.0, b_ov, bgal[0])
        snr, _, _ = _ksz_large_scale(bg, p, zs1, kLs, mu, ks, Cls, sPge[0],
                                     sPgg[0], bgal, b_eff, kszm.Ngg(ngal),
                                     plin_L[0], f, vol_gpc3)
        return snr, bgal[0]

    def fn(overrides, zcents, vols_gpc3, ngals, Cls, bs=None):
        ov = to_torch_params(overrides, dev)
        p = {**defaults, **ov}
        bg = bgmod.background(p, dev)
        gm = _growth_mode_from(ov, growth)
        growth_kw = {"growth_mode": gm,
                     "growth_table": (bgmod.growth_table(bg)
                                      if gm == "ode" else None)}
        zc, vols, ng = (torch.as_tensor(a, dtype=_F64, device=dev)
                        for a in (zcents, vols_gpc3, ngals))
        bs_t = (torch.full_like(zc, -1.0) if bs is None
                else torch.as_tensor(bs, dtype=_F64, device=dev))
        cls_t = torch.as_tensor(Cls, dtype=_F64, device=dev)
        snrs, bgals = torch.func.vmap(
            lambda z, v, n, b: one_bin(p, bg, growth_kw, cls_t, z, v, n, b))(
            zc, vols, ng, bs_t)
        return torch.sqrt(torch.sum(snrs**2)), snrs, bgals

    fn.device = dev
    return fn


def bind_args(fn, *args):
    """fn(overrides, *args) as a function of the overrides alone, keeping
    ``fn.device``: the kSZ functions take (overrides, Cls), and
    ``make_batched_fn`` calls its function with the overrides alone."""

    def bound(overrides=None):
        return fn(overrides, *args)

    bound.device = getattr(fn, "device", None)
    return bound


def make_batched_fn(fn, param_names, base: dict | None = None,
                    out_dtype=None):
    """Batch a pipeline function over sets of cosmological parameters:
    MCMC chains, emulator training sets and grid scans evaluate one
    static-grid pipeline at many cosmologies.

    fn: a ``make_*_fn`` product (overrides dict -> tensor or tuple of
        tensors); the batch runs on its device.  A kSZ function takes
        (overrides, Cls): bind Cls first, ``bind_args(ksz_fn, Cls)``.
    param_names: the parameter keys varied across the batch.  Parameters
        that shape a grid (sigma2_*, the electron sample grid, the
        bisection's trip count) are static and are refused here.
    base: fixed overrides applied to every batch element.
    out_dtype: optional torch dtype that every leaf of the result is cast
        to (float32 halves the result's bytes at ~6e-8 relative).

    Returns batched(theta), with theta a (B, len(param_names)) array or
    tensor, or a dict of (B,) leaves, and every leaf of the result with a
    leading B.  The batch is ``torch.func.vmap`` of the per-cosmology
    function, so every stage runs once on tensors with a batch dimension
    and each hand-written kernel is launched once for the whole batch
    (its vmap rule folds the batch into its rows).  A parameter in
    ``param_names`` counts as varying at build time: a batch over mnu or
    H0 takes the neutrino ratio, one over w0 or wa the integrated growth.
    """
    names = tuple(param_names)
    static = [k for k in names if k in _STATIC_PARAMS]
    if static:
        raise ValueError(f"{static} shape a grid and cannot vary across a "
                         f"batch: pass them as static_params or in base")
    base = dict(base or {})
    dev = getattr(fn, "device", None)

    def one(theta_row):
        ov = dict(base)
        for i, k in enumerate(names):
            ov[k] = theta_row[i]
        out = fn(ov)
        if out_dtype is None:
            return out
        if isinstance(out, tuple):
            return tuple(o.to(out_dtype) for o in out)
        return out.to(out_dtype)

    def batched(theta):
        if isinstance(theta, dict):
            theta = torch.stack(
                [torch.as_tensor(theta[k], dtype=_F64, device=dev)
                 for k in names], dim=-1)
        else:
            theta = torch.as_tensor(theta, device=dev).to(_F64)
        if theta.dim() != 2 or theta.shape[1] != len(names):
            raise ValueError(f"theta must be (B, {len(names)}), got "
                             f"{tuple(theta.shape)}")
        return torch.func.vmap(one)(theta)

    return batched


def fisher_jacobian(fn, params0: dict, param_names, *, device):
    """d fn(params) / d theta for the named parameters, in forward mode
    (``torch.autograd.functional.jacobian``, strategy 'forward-mode');
    shape fn's output shape + (len(param_names),), as the JAX package's
    jacfwd gives it."""
    names = tuple(param_names)
    theta0 = torch.tensor([float(params0[k]) for k in names], dtype=_F64,
                          device=_resolve_device(device))

    def wrapped(theta):
        overrides = dict(params0)
        for i, name in enumerate(names):
            overrides[name] = theta[i]
        return fn(overrides)

    return torch.autograd.functional.jacobian(
        wrapped, theta0, vectorize=True, strategy="forward-mode")
