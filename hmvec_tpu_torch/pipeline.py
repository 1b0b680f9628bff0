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

Not ported yet: ``make_batched_fn`` and the Limber, HOD and kSZ pipelines.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import background as bgmod
from .models import linear_power as lpm
from .models import mass_function as mfm
from .models import power as pwr
from .models import profiles as prof
from .models.linear_power import _varies
from .models.mass_conversion import mdelta_from_mdelta
from .ops.nfw_kernels import nfw_contract, nfw_uk
from .ops.sine_transform import generic_profile_fft, profile_table
from .params import battaglia_defaults, merge_params, to_torch_params
from .utils.weights import catmull_taps_nonuniform, simpson_weights

_F64 = torch.float64
_SIGMA2_KEYS = ("sigma2_kmin", "sigma2_kmax", "sigma2_numks")


def _growth_mode_from(overrides, setting: str) -> str:
    """Resolve the growth-factor mode for one call.

    'auto': no w0/wa override -> the LCDM closed form.  A w0/wa that is
    differentiated (requires grad or carries a forward-mode tangent) or
    differs from the fiducial (-1, 0) -> 'ode', the integrated growing
    mode (background.growth_table): the closed form's dD/dw0 is
    identically zero.  Pass 'closed' or 'ode' to force one.
    """
    if setting != "auto":
        return setting
    o = overrides or {}
    for key, fid in (("w0", -1.0), ("wa", 0.0)):
        if key in o:
            v = o[key]
            if _varies(v) or float(v) != fid:
                return "ode"
    return "closed"


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
    with the host-side quadrature weights and interpolation taps."""

    def __init__(self, zs, ks, ms, defaults, uk_subsample, device):
        self.device = device
        self.zs_np = np.asarray(zs, dtype=np.float64)
        self.ks_np = np.asarray(ks, dtype=np.float64)
        self.ms_np = np.asarray(ms, dtype=np.float64)
        self.zs, self.ks, self.ms = (self.tensor(a) for a in
                                     (self.zs_np, self.ks_np, self.ms_np))
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


def _stages(p, g: _Grids, mass_function, mdef, accuracy, engine,
            fast_nfw=False, growth_mode="closed", profile="uk"):
    """Background through mass function and the NFW stage; returns
    (bg, pzk, nzm, bh, rho_m0, uk) or, for profile='inputs', the NFW
    inputs (cs, rss) in place of uk."""
    bg = bgmod.background(p, g.device)
    zs, ks, ms = g.zs, g.ks, g.ms
    # one growth table per call, shared by both linear spectra
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
        return bg, pzk, nzm, bh, rho_m0, (cs, rss)

    if fast_nfw:
        nz, nm = cs.shape
        scales = (rss * (1.0 + zs)[:, None]).reshape(-1)
        tier = "exact" if fast_nfw == "exact" else "fast"
        uk = nfw_uk(g.kq, scales, cs.reshape(-1), tier=tier)
        uk = uk.reshape(nz, nm, -1).to(_F64)
    else:
        uk = prof.nfw_uk_analytic(g.kq, zs, cs, rss)
    return bg, pzk, nzm, bh, rho_m0, g.resample(uk)


def make_pmm_fn(zs, ks, ms, *, device, mass_function: str = "sheth-torman",
                mdef: str = "vir", accuracy: str = "medium", fast=False,
                growth: str = "auto", static_params: dict | None = None,
                uk_subsample=None, fused_serving: bool = False):
    """Build params -> Pmm(1h+2h), shape (nz, nk), on a static grid.

    The returned function takes a dict of cosmological parameter overrides
    (Python numbers, numpy values or float64 tensors, which may carry
    gradients) and returns a float64 tensor on ``device``.

    device: 'cpu' or 'cuda[:i]'; required.  A CUDA device without a card
        raises.
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
    if fast not in (False, True, "exact"):
        raise ValueError(f"fast must be False, True or 'exact', got {fast!r}")
    dev = _resolve_device(device)
    defaults = merge_params(static_params)
    grids = _Grids(zs, ks, ms, defaults, uk_subsample, dev)
    engine = lpm.EHEngine()

    if fused_serving:
        return _make_pmm_fused_fn(grids, mass_function, mdef, accuracy,
                                  engine, growth, defaults)

    def pmm(overrides=None):
        ov = to_torch_params(overrides, dev)
        p = {**defaults, **ov}
        _, pzk, nzm, bh, rho_m0, uk = _stages(
            p, grids, mass_function, mdef, accuracy, engine,
            fast_nfw=fast, growth_mode=_growth_mode_from(ov, growth))
        tr = pwr.MatterTracer(uk=uk)
        return pwr.power_total(tr, tr, nzm, bh, grids.ms, grids.ks, pzk,
                               rho_m0, p["kstar_damping"])

    return pmm


_ELECTRON_GRID_KEYS = ("electron_density_profile_integral_numxs",
                       "electron_density_profile_integral_xmax")


def _gas_profile(p, g: _Grids, bg, mdef, fit):
    """(rhofunc, cmaxs, rgs) of the electron profile transform: the
    Battaglia gas density on x = r / (R200/2), with M200 from the halo mass
    by the NFW mass-definition conversion, truncated at c = r_vir / rgs,
    and the scale radii rgs = R200/2."""
    zs, ms = g.zs, g.ms
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
                     accuracy: str = "medium", fast: bool = False,
                     growth: str = "auto"):
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
    engine = lpm.EHEngine()
    fit = dict(battaglia_defaults[family])
    sample_dtype = torch.float32 if fast else _F64

    def electron(overrides=None):
        nxs_l, xmax_l = _electron_grid(overrides, defaults, nxs, xmax)
        ov = to_torch_params(overrides, dev)
        p = {**defaults, **ov}
        bg, pzk, nzm, bh, rho_m0, uk_nfw = _stages(
            p, grids, mass_function, mdef, accuracy, engine,
            fast_nfw=fast, growth_mode=_growth_mode_from(ov, growth))
        rhofunc, cmaxs, rgs = _gas_profile(p, grids, bg, mdef, fit)
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
    rhofunc, cmaxs, rgs = _gas_profile(p, grids, bg, mdef,
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
    _, pzk, nzm, bh, rho_m0, (cs, rss) = _stages(
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

    return pmm


def nfw_stage_inputs(zs, ks, ms, overrides=None, *, device,
                     mass_function: str = "sheth-torman", mdef: str = "vir",
                     accuracy: str = "medium"):
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
        lpm.EHEngine(), _growth_mode_from(ov, "auto"))
    return grids.ks, scales, cs, a_zm, b_zm


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
