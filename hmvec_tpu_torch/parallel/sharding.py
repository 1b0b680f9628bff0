"""Grid, batch, bin, k and l parallelism over a mesh of cards (port of
hmvec_tpu/parallel/sharding.py).

The natural scaling axis of this workload is the mass integral: every
spectrum is a (z, m, k) integrand reduced over m.  The mass axis is split
over the mesh's slots; each slot evaluates its slice of the profile grid
(the Si/Ci- and transform-heavy part) and its partial mass integrals, and
one ``psum`` closes each spectrum.  The small (z, m) stages (sigma^2,
n(z, m), bias, HOD occupations, the M200 conversion) run once, replicated
on the mesh's first device: cheaper than moving them, and it keeps the
neighbour-dependent d ln sigma / d ln m stencil whole.

Beyond the mass axis: batches of cosmologies (data-parallel serving), kSZ
survey bins, the Boltzmann hierarchy over k and its Bessel projection over
l split the same way, the last three with no collective but the gather.

The JAX module runs one program across the devices of a
``jax.sharding.Mesh`` under ``shard_map``.  This port keeps its single
controller: one host thread issues each slot's launches in turn, in slot
order, on the slot's device, and the collectives are three helpers of
``Mesh`` in the same order -- ``shard`` (slice an input along an axis and
move each piece to its slot), ``psum`` (move each slot's partial to the
first device and sum), ``all_gather`` (concatenate there) -- so every
result is deterministic.  Nothing waits on the device between slots: on
separate cards the slots' device work overlaps; on one card repeated in
several slots it runs one slot after the other.  Autograd flows through
``.to()`` and the sums, so ``make_fisher_step_fn`` differentiates through
the psum.  A ``torch.distributed`` process group would change every
signature (one process a card) and, on one card, degenerate to a world of
one.

Every kernel of a slot launches on that slot's device and leaves the
caller's current device as it was (csrc/device_guard.cuh).  The
``axis_name`` parameters keep the JAX signatures; the collectives here need
no name.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from .. import pipeline as pl
from ..models import background as bgmod
from ..models import bispectrum as bis
from ..models import limber as limb
from ..models import linear_power as lpm
from ..models import mass_function as mfm
from ..models import profiles as prof
from ..models.hod import build_hod
from ..models.mass_conversion import mdelta_from_mdelta
from ..ops.sine_transform import generic_profile_fft
from ..params import battaglia_defaults, merge_params, to_torch_params
from ..utils.profiling import span
from ..utils.weights import mass_weights

__all__ = ["Mesh", "make_mesh", "make_sharded_pmm_fn",
           "make_sharded_galaxy_electron_fn", "make_fisher_step_fn",
           "make_sharded_batched_fn", "make_sharded_ksz_survey_fn",
           "sharded_solve_perturbations", "sharded_cls_from_sources",
           "make_sharded_matter_bispectrum_fn"]

_F64 = torch.float64


class Mesh:
    """A one-axis mesh: ``devices`` holds one ``torch.device`` a slot, in
    slot order (a device may fill several slots), and ``axis_names`` the
    axis's one name, as a ``jax.sharding.Mesh`` holds them."""

    def __init__(self, devices, axis_names=("m",)):
        self.devices = tuple(pl._resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one slot")
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> tuple:
        """The mesh's devices, each once, in slot order."""
        return tuple(dict.fromkeys(self.devices))

    def shard(self, x, axis: int = 0) -> list:
        """x (a tensor or an array) cut into ``size`` equal pieces along
        ``axis``, piece i on slot i's device."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        if x.shape[axis] % self.size:
            raise ValueError(f"mesh size {self.size} must divide axis "
                             f"{axis} of length {x.shape[axis]}")
        return [piece.to(dev) for piece, dev in
                zip(torch.chunk(x, self.size, dim=axis), self.devices)]

    def psum(self, parts):
        """The sum of the slots' partials, in slot order, on the first
        device."""
        d0 = self.devices[0]
        total = parts[0].to(d0)
        for part in parts[1:]:
            total = total + part.to(d0)
        return total

    def all_gather(self, parts, axis: int = 0):
        """The slots' pieces (tensors, or tuples of them) concatenated
        along ``axis`` on the first device."""
        if isinstance(parts[0], tuple):
            return tuple(self.all_gather(list(p), axis) for p in zip(*parts))
        return torch.cat([p.to(self.devices[0]) for p in parts], dim=axis)


def make_mesh(n_devices: int | None = None, axis_name: str = "m", *,
              devices=None) -> Mesh:
    """A mesh of ``n_devices`` slots on the first visible cards, in order
    (all of them by default).  More slots than cards, or no card, is
    refused: there is no CPU fallback.  ``devices``: the slots' devices
    given explicitly, which may repeat one ("cpu" eight times for the CPU
    tests, ["cuda:0"] * 4 for four slots on one card)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: torch.cuda.is_available() is "
                               "False; pass devices= for a mesh on the CPU")
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if not 0 < n <= count:
            raise ValueError(f"make_mesh: {n} slots on {count} visible "
                             f"cards; pass devices= to repeat a card")
        devices = [torch.device("cuda", i) for i in range(n)]
    elif n_devices is not None and int(n_devices) != len(devices):
        raise ValueError(f"n_devices {n_devices} and {len(devices)} "
                         f"devices given")
    return Mesh(devices, (axis_name,))


def _per_device(mesh: Mesh, make):
    """{device: make(device)} over the mesh's distinct devices."""
    return {dev: make(dev) for dev in mesh.distinct()}


def _check_mass_axis(ms, mesh: Mesh):
    if np.asarray(ms).size % mesh.size:
        raise ValueError("mesh size must divide len(ms)")


def _mass_shards(grids, mesh: Mesh) -> list:
    """Each slot's (masses, trapezoid weights) of the whole grid's mass
    integral."""
    return list(zip(mesh.shard(grids.ms),
                    mesh.shard(mass_weights(grids.ms))))


def _to_device(tree, device):
    """A named tuple of tensors (and numbers, and named tuples of them)
    with its tensors on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_device(v, device) for v in tree))
    return tree


def _f64(x):
    """x as a float64 tensor: a tensor where it is, host data on the CPU
    (``Mesh.shard`` moves each piece to its slot)."""
    if isinstance(x, torch.Tensor):
        return x.to(_F64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _replicated(p, overrides, grids, mass_function, mdef, accuracy,
                engine):
    """The replicated (z, m) stages on the mesh's first device: (bg, pzk,
    nzm, bh, rho_m0, cs, rss, sigma2)."""
    bg, pzk, nzm, bh, rho_m0, (cs, rss, sigma2), _ = pl._stages(
        p, grids, mass_function, mdef, accuracy, engine,
        growth_mode=pl._growth_mode_from(overrides, "auto"),
        profile="inputs")
    return bg, pzk, nzm, bh, rho_m0, cs, rss, sigma2


def _damping(ks, p):
    return 1.0 - torch.exp(-((ks / p["kstar_damping"]) ** 2))


def make_sharded_pmm_fn(zs, ks, ms, mesh: Mesh, axis_name: str = "m",
                        mass_function: str = "sheth-torman",
                        mdef: str = "vir", accuracy: str = "medium",
                        engine=None):
    """params -> Pmm(1h+2h) (nz, nk) on the mesh's first device, with the
    mass axis sharded over ``mesh``: each slot evaluates the plain NFW
    u(k) of its masses and three partial integrals (the 1-halo integral,
    the 2-halo leg and its u -> 1 completion), and one psum closes them.
    len(ms) must be divisible by the mesh size."""
    _check_mass_axis(ms, mesh)
    d0 = mesh.devices[0]
    defaults = merge_params()
    engine = engine or lpm.EHEngine()
    grids = pl._Grids(zs, ks, ms, defaults, None, d0)
    zs_d = _per_device(mesh, grids.zs.to)
    ks_d = _per_device(mesh, grids.ks.to)
    ms_w = _mass_shards(grids, mesh)

    def pmm(overrides=None):
        ov = to_torch_params(overrides, d0)
        p = {**defaults, **ov}
        _, pzk, nzm, bh, rho_m0, cs, rss, _ = _replicated(
            p, ov, grids, mass_function, mdef, accuracy, engine)
        parts = []
        for dev, (ms_l, w_l), nzm_l, bh_l, cs_l, rss_l in zip(
                mesh.devices, ms_w,
                *(mesh.shard(t, axis=1) for t in (nzm, bh, cs, rss))):
            uk_l = prof.nfw_uk_analytic(ks_d[dev], zs_d[dev], cs_l, rss_l)
            # the matter term without 1/rho_m0 (applied after the psum)
            term_l = ms_l[None, :, None] * uk_l
            wnb = nzm_l * bh_l * w_l
            p1 = torch.einsum("zmk,m->zk", nzm_l[..., None] * term_l**2, w_l)
            i2 = torch.einsum("zmk,zm->zk", term_l, wnb)
            c2 = (wnb * ms_l).sum(dim=1)
            parts.append(torch.stack([p1, i2, c2[:, None].expand_as(i2)]))
        p1, i2, c2 = mesh.psum(parts)
        p1h = p1 / rho_m0**2 * _damping(grids.ks, p)[None, :]
        return p1h + pzk * (i2 / rho_m0 + 1.0 - c2 / rho_m0) ** 2

    pmm.device = d0
    return pmm


def make_sharded_galaxy_electron_fn(zs, ks, ms, ngal, mesh: Mesh,
                                    axis_name: str = "m",
                                    family: str = "AGN", nxs: int = 1024,
                                    xmax: float = 20.0,
                                    mass_function: str = "sheth-torman",
                                    mdef: str = "vir",
                                    accuracy: str = "medium", engine=None):
    """params -> (Pgg, Pge, Pee), each (nz, nk), with the mass axis
    sharded over ``mesh``: the kSZ small-scale workload.  Each slot
    evaluates the plain NFW u(k) of its masses (the HOD satellites) and
    the Battaglia electron profile (sampling, sine DFT and the resample,
    which is the float64 resample kernel on a card), forms seven partial
    1-halo and 2-halo integrals, and one psum closes all three spectra.
    The mass function, the M200 conversion and the HOD with its ngal
    solve run replicated.  As in the JAX package, the gas profile's
    baryon fraction and gamma come from the default parameters, not the
    overrides."""
    _check_mass_axis(ms, mesh)
    d0 = mesh.devices[0]
    defaults = merge_params()
    engine = engine or lpm.EHEngine()
    fit = dict(battaglia_defaults[family])
    grids = pl._Grids(zs, ks, ms, defaults, None, d0)
    ngal_t = grids.tensor(ngal)
    zs_d = _per_device(mesh, grids.zs.to)
    ks_d = _per_device(mesh, grids.ks.to)
    ms_w = _mass_shards(grids, mesh)
    omb = defaults["ombh2"] / (defaults["H0"] / 100.0) ** 2
    gamma = defaults["battaglia_gas_gamma"]

    def electron_profile(dev, m200_l, rgs_l, cmaxs_l, rhocritz, omm):
        """u_e(k) (nz, nm_l, nk) of one slot's masses: the Battaglia gas
        density sampled, sine-transformed and resampled on ``dev``."""
        zs_l = zs_d[dev]

        def rhofunc(xsamp):
            return prof.rho_gas_x(xsamp[None, None, :], m200_l[..., None],
                                  zs_l[:, None, None], omb, omm,
                                  rhocritz[:, None, None], gamma, fit)

        return generic_profile_fft(rhofunc, cmaxs_l, rgs_l, zs_l, ks_d[dev],
                                   xmax, nxs)[1]

    def spectra(overrides=None):
        ov = to_torch_params(overrides, d0)
        p = {**defaults, **ov}
        bg, pzk, nzm, bh, rho_m0, cs, rss, _ = _replicated(
            p, ov, grids, mass_function, mdef, accuracy, engine)
        zs_t = grids.zs
        omz = bgmod.omz(bg, zs_t)
        rhocritz = bgmod.rho_critical_z(bg, zs_t)
        if mdef == "vir":
            dr1 = rhocritz * mfm.deltav_bryan_norman(omz)
        else:
            dr1 = bgmod.rho_matter_z(bg, zs_t) * 200.0
        m200 = mdelta_from_mdelta(grids.ms, cs, dr1, 200.0 * rhocritz)
        rgs = mfm.R_from_M(m200, rhocritz[:, None], delta=200.0) / 2.0
        hp = {k: p[k] for k in p if k.startswith("hod_")}
        grid = build_hod(zs_t, grids.ms, nzm, bh, hp, ngal=ngal_t)
        rhoc_d = _per_device(mesh, rhocritz.to)
        omm_d = _per_device(mesh, bg.omm0.to)

        parts = []
        for (dev, (ms_l, w_l), nzm_l, bh_l, cs_l, rss_l, m200_l, rgs_l, nc_l,
             ns_l, nsnsm1_l, ncns_l) in zip(
                mesh.devices, ms_w,
                *(mesh.shard(t, axis=1) for t in (
                    nzm, bh, cs, rss, m200, rgs, grid.Nc, grid.Ns,
                    grid.NsNsm1, grid.NcNs))):
            ks_l = ks_d[dev]
            uk_l = prof.nfw_uk_analytic(ks_l, zs_d[dev], cs_l, rss_l)
            uke_l = electron_profile(dev, m200_l, rgs_l, rss_l * cs_l / rgs_l,
                                     rhoc_d[dev], omm_d[dev])
            # the tracers' terms; 1/ngal and 1/rho_m0 come after the psum
            term_g = nc_l[..., None] + uk_l * ns_l[..., None]   # uc = 1
            term_e = ms_l[None, :, None] * uke_l
            sq_gg = (2.0 * uk_l * ncns_l[..., None]
                     + nsnsm1_l[..., None] * uk_l**2)
            nzw = nzm_l * w_l
            wnb = nzw * bh_l

            def red(x, wz):
                return torch.einsum("zmk,zm->zk", x, wz)

            nk = ks_l.numel()
            parts.append(torch.stack([
                red(sq_gg, nzw),                                  # gg 1h
                red(term_g * term_e, nzw),                        # ge 1h
                red(term_e**2, nzw),                              # ee 1h
                red(term_g, wnb),                                 # g leg
                red(term_e, wnb),                                 # e leg
                (wnb * ms_l).sum(1)[:, None].expand(-1, nk),      # e, u->1
                (wnb * (nc_l + ns_l)).sum(1)[:, None].expand(-1, nk),
            ]))
        gg1, ge1, ee1, gleg, eleg, eleg0, gleg0 = mesh.psum(parts)
        ng = grid.ngal[:, None]
        damping = _damping(grids.ks, p)[None, :]
        fac_g = gleg / ng + grid.bg[:, None] - gleg0 / ng
        fac_e = eleg / rho_m0 + 1.0 - eleg0 / rho_m0
        return (gg1 / ng**2 * damping + pzk * fac_g * fac_g,
                ge1 / ng / rho_m0 * damping + pzk * fac_g * fac_e,
                ee1 / rho_m0**2 * damping + pzk * fac_e * fac_e)

    spectra.device = d0
    return spectra


def _fisher_step(pmm_fn, zs, ks, ells, param_names, lr, device):
    """(step, model) of the Fisher training step on any params -> Pmm
    function on ``device``: model(theta_rel) -> C_kk at ``ells`` for a
    source at z = 1100, step(theta_rel, data) -> (theta_next, loss) by
    one gradient-descent update through torch.autograd."""
    defaults = merge_params()
    fiducial = torch.tensor([float(defaults[n]) for n in param_names],
                            dtype=_F64, device=device)
    zs_t, ks_t, ells_t = (torch.as_tensor(np.asarray(a, dtype=np.float64),
                                          device=device)
                          for a in (zs, ks, ells))

    def model(theta_rel):
        theta = fiducial * torch.as_tensor(theta_rel, dtype=_F64,
                                           device=device)
        overrides = {name: theta[i] for i, name in enumerate(param_names)}
        pmm = pmm_fn(overrides)
        bg = bgmod.background({**defaults, **overrides}, device)
        return limb.C_kk(bg, ells_t, zs_t, ks_t, pmm, lzs1=1100.0,
                         lzs2=1100.0)

    def step(theta_rel, data):
        theta = torch.as_tensor(theta_rel, dtype=_F64, device=device
                                ).detach().requires_grad_(True)
        data = torch.as_tensor(data, dtype=_F64, device=device)
        resid = (model(theta) - data) / (data.abs() + 1e-30)
        loss = torch.mean(resid**2)
        grad, = torch.autograd.grad(loss, theta)
        return (theta - lr * grad).detach(), loss.detach()

    return step, model


def make_fisher_step_fn(zs, ks, ms, ells, mesh: Mesh,
                        param_names=("omch2", "As"), lr: float = 1e-3,
                        **kw):
    """One 'training step' of the forecasting workload: a gradient-descent
    update of cosmological parameters against a C_kk data vector, with the
    mass axis sharded over the mesh and the gradient taken through its
    psum.  Parameters are in fiducial-relative units (theta = value /
    fiducial), so one learning rate serves parameters ten decades apart.
    ``kw`` goes to ``make_sharded_pmm_fn``.

    Returns (step, model): step(theta_rel, data) -> (theta_rel_next,
    loss), model(theta_rel) -> C_kk, on the mesh's first device."""
    pmm_fn = make_sharded_pmm_fn(zs, ks, ms, mesh, **kw)
    return _fisher_step(pmm_fn, zs, ks, ells, tuple(param_names), lr,
                        mesh.devices[0])


def _replica(fn, device):
    """fn itself on its own device, else its rebuild on ``device``."""
    if getattr(fn, "device", None) == device:
        return fn
    if not hasattr(fn, "_on_device"):
        raise ValueError(f"{fn!r} has no replica on {device}: pass a "
                         f"make_*_fn product (or bind_args of one)")
    return fn._on_device(device)


def make_sharded_batched_fn(fn, param_names, mesh: Mesh,
                            axis_name: str = "m", base: dict | None = None):
    """Data-parallel serving: a batch of cosmologies sharded over the
    mesh.  Each slot runs ``pipeline.make_batched_fn`` of fn's replica on
    its device over its share of the rows, with no communication but the
    gather of the outputs.  The replicas are built once, here, one per
    distinct device of the mesh (fn itself on its own device).  The mesh
    size must divide B.

    fn: a ``make_*_fn`` product (or ``bind_args`` of one); param_names:
    keys of the batched parameters; returns batched(theta (B, P)) ->
    stacked outputs on the mesh's first device."""
    names = tuple(param_names)
    nd = mesh.size
    serve = _per_device(mesh, lambda dev: pl.make_batched_fn(
        _replica(fn, dev), names, base))

    def batched(theta):
        with span("hmvec.call"):
            theta = _f64(theta)
            if theta.shape[0] % nd:
                raise ValueError(f"mesh size {nd} must divide the batch "
                                 f"(got batch {theta.shape[0]})")
            parts = []
            for i, (dev, rows) in enumerate(zip(mesh.devices,
                                                mesh.shard(theta))):
                # the one host thread's issue of slot i's share
                with span(f"hmvec.shard.issue:{i}"):
                    parts.append(serve[dev](rows))
            return mesh.all_gather(parts)

    return batched


def make_sharded_ksz_survey_fn(num_bins: int, mesh: Mesh,
                               axis_name: str = "m", **survey_kwargs):
    """Survey kSZ forecast with the bin axis sharded over the mesh: each
    slot runs ``pipeline.make_ksz_survey_fn`` (the whole per-bin
    forecast) on its share of the bins, and one psum closes the total
    SNR^2.  The mesh size must divide num_bins.  Same call as the
    unsharded survey, per-bin ``bs`` included (sharded like the other
    bin inputs)."""
    nd = mesh.size
    if num_bins % nd:
        raise ValueError("mesh size must divide num_bins")
    inner = _per_device(mesh, lambda dev: pl.make_ksz_survey_fn(
        num_bins // nd, device=dev, **survey_kwargs))
    d0 = mesh.devices[0]

    def fn(overrides, zcents, vols_gpc3, ngals, Cls, bs=None):
        zc, vols, ng = (_f64(a) for a in (zcents, vols_gpc3, ngals))
        # <= 0: the HOD's bias (pipeline.make_ksz_survey_fn)
        bs_t = torch.full_like(zc, -1.0) if bs is None else _f64(bs)
        cls_d = _per_device(mesh, _f64(Cls).to)
        out = [inner[dev](overrides, z_l, v_l, n_l, cls_d[dev], bs=b_l)
               for dev, z_l, v_l, n_l, b_l in zip(
                   mesh.devices, *(mesh.shard(t) for t in
                                   (zc, vols, ng, bs_t)))]
        tot2 = mesh.psum([torch.sum(snrs**2) for _, snrs, _ in out])
        snrs, bgals = mesh.all_gather([(s, b) for _, s, b in out])
        return torch.sqrt(tot2), snrs, bgals

    fn.device = d0
    return fn


def _pad_to(n: int, nd: int) -> int:
    return (-n) % nd


def sharded_solve_perturbations(ctx, ks, mesh: Mesh, axis_name: str = "k",
                                **solve_kwargs):
    """k-sharded Boltzmann-lite hierarchy solve over the mesh.

    Each slot integrates its slice of the k grid through the segments'
    RK4 schedule, one ``hierarchy_rk4`` launch a segment on its device,
    from the context replicated there; the first slot carries the
    curvature mode as one more row, as the unsharded solve does.  K7's
    rows are independent, so the stitched solution equals the unsharded
    one bit for bit on the same card.  ks is padded with its last value
    to a multiple of the mesh size and trimmed after.  solve_kwargs: the
    solver's grid counts, whose defaults are ``solve_perturbations``'
    own."""
    from ..models import boltzlite as bl

    ks = np.asarray(ks, dtype=np.float64).reshape(-1)
    nk = ks.size
    ks_pad = np.concatenate([ks, np.full(_pad_to(nk, mesh.size), ks[-1])])
    sig = inspect.signature(bl.solve_perturbations.__wrapped__)
    kw = {name: par.default for name, par in sig.parameters.items()
          if par.default is not inspect.Parameter.empty}
    kw.update(solve_kwargs)
    grid = [kw[k] for k in ("n_a", "n_b_outer", "n_b_inner", "n_c_outer",
                            "n_c_inner", "x0")]
    ctx_d = _per_device(mesh, lambda dev: _to_device(ctx, dev))
    out = [bl._solve_ks(ctx_d[dev], ks_l, *grid, calibrate=(i == 0))
           for i, (dev, ks_l) in enumerate(zip(
               mesh.devices, mesh.shard(torch.as_tensor(ks_pad))))]
    xs, _, zeta = out[0]
    states = mesh.all_gather([st for _, st, _ in out])[:nk]
    return bl.PerturbSolution(ks=torch.as_tensor(ks, device=xs.device),
                              xs=xs, states=states, zeta_unit=zeta)


def sharded_cls_from_sources(src, bg, ls, ks_fine, mesh: Mesh,
                             axis_name: str = "k",
                             lmax_late: float = 60.0):
    """l-sharded Bessel projection of the line-of-sight sources to C_l.

    The per-l projections are independent: the prep (fine-k sources,
    Bessel table, gather indices) runs once, as
    ``boltzlite.cls_from_sources`` runs it, on the sources' device; its
    (nl, nu) table rows are padded with the last row to a multiple of the
    mesh size and sharded, each slot projects its rows with the shared
    inputs moved to its device, and the gathered rows assemble the C_l as
    in the unsharded path (the same per-l program: equal bit for bit on
    one card)."""
    from ..models import boltzlite as bl

    ls = np.asarray(ls)
    nl = ls.size
    pad = _pad_to(nl, mesh.size)
    ks_fine, rows, shared = bl._projection_inputs(src, ls, ks_fine)
    # padded by repeating the last row: ls itself keys the Bessel table
    # cache, so the padding costs no table of its own
    rows = [torch.cat([r, r[-1:].expand(pad, *r.shape[1:])]) for r in rows]
    shared_d = _per_device(mesh, lambda dev: [t.to(dev) for t in shared])
    th_l, e_l = mesh.all_gather([
        bl._project_l_rows(*rows_l, *shared_d[dev], lmax_late)
        for dev, *rows_l in zip(mesh.devices,
                                *(mesh.shard(r) for r in rows))])
    dev = ks_fine.device
    return bl._assemble_cls(src, bg, ls, ks_fine, th_l[:nl].to(dev),
                            e_l[:nl].to(dev))


def make_sharded_matter_bispectrum_fn(zs, ks, ms, k1, k2, k3, mesh: Mesh,
                                      axis_name: str = "m",
                                      mass_function: str = "sheth-torman",
                                      mdef: str = "vir",
                                      accuracy: str = "medium",
                                      engine=None, include_b2=False):
    """params -> B_mmm^{1h+2h+3h}(z, q) with the mass axis sharded.

    Each slot evaluates its mass slice of the NFW grid, interpolates it to
    the three legs' wavenumbers and forms every partial integral (the
    triple-product 1-halo integral, three pair and three b1 legs and,
    with ``include_b2``, the three quadratic-bias legs of the Sheth-Tormen
    peak-background split); one psum closes them all.  The
    k-interpolation commutes with the (linear) mass integral, so this
    equals the unsharded bispectrum up to float reassociation.

    ``k1/k2/k3``: leg wavenumbers (scalar, (nq,) or (nz, nq) per leg),
    one configuration shape for all three."""
    _check_mass_axis(ms, mesh)
    d0 = mesh.devices[0]
    defaults = merge_params()
    engine = engine or lpm.EHEngine()
    grids = pl._Grids(zs, ks, ms, defaults, None, d0)
    nz = grids.zs.numel()
    kqs = [bis._normalize_kq(k, nz, d0) for k in (k1, k2, k3)]
    if len({tuple(kq.shape) for kq in kqs}) != 1:
        raise ValueError("the three legs must share one configuration "
                         "shape")
    zs_d = _per_device(mesh, grids.zs.to)
    ks_d = _per_device(mesh, grids.ks.to)
    kqs_d = _per_device(mesh, lambda dev: [kq.to(dev) for kq in kqs])
    ms_w = _mass_shards(grids, mesh)

    def bispec(overrides=None):
        ov = to_torch_params(overrides, d0)
        p = {**defaults, **ov}
        _, pzk, nzm, bh, rho, cs, rss, sigma2 = _replicated(
            p, ov, grids, mass_function, mdef, accuracy, engine)
        b2 = (bis.b2_sheth_torman(sigma2, p) if include_b2
              else torch.zeros_like(nzm))
        parts = []
        for dev, (ms_l, w_l), nzm_l, bh_l, b2_l, cs_l, rss_l in zip(
                mesh.devices, ms_w,
                *(mesh.shard(t, axis=1) for t in (nzm, bh, b2, cs, rss))):
            ks_l = ks_d[dev]
            uk_l = prof.nfw_uk_analytic(ks_l, zs_d[dev], cs_l, rss_l)
            # the matter term without 1/rho_m0, applied after the psum
            term_l = ms_l[None, :, None] * uk_l
            tq = [bis._interp_zmk(ks_l, term_l, kq) for kq in kqs_d[dev]]
            nzw = nzm_l * w_l
            wnb = nzw * bh_l

            def red(x, wz):
                return torch.einsum("zmq,zm->zq", x, wz)

            c = (wnb * ms_l).sum(-1)
            rows = [red(tq[0] * tq[1] * tq[2], nzw),        # B1h
                    red(tq[1] * tq[2], wnb),                 # I2, P(k1) leg
                    red(tq[2] * tq[0], wnb),                 # I2, P(k2) leg
                    red(tq[0] * tq[1], wnb),                 # I2, P(k3) leg
                    red(tq[0], wnb), red(tq[1], wnb),        # I1 integrals
                    red(tq[2], wnb),
                    c[:, None].expand_as(tq[0][:, 0])]       # u -> 1
            if include_b2:
                rows += [red(t, nzw * b2_l) for t in tq]
            parts.append(torch.stack(rows))
        parts = mesh.psum(parts)
        b1h = parts[0] / rho**3
        for kq in kqs:
            b1h = b1h * (1.0 - torch.exp(-((kq / p["kstar_damping"]) ** 2)))
        I2 = [parts[1 + i] / rho**2 for i in range(3)]
        cc = parts[7] / rho
        I1 = [parts[4 + i] / rho + 1.0 - cc for i in range(3)]
        Pq = [bis._interp_zk(grids.ks, pzk, kq) for kq in kqs]
        b2h = sum(Pq[i] * I1[i] * I2[i] for i in range(3))
        b3h = I1[0] * I1[1] * I1[2] * bis.tree_bispectrum(
            Pq[0], Pq[1], Pq[2], kqs[0], kqs[1], kqs[2])
        if include_b2:
            for ll in range(3):
                i, j = (ll + 1) % 3, (ll + 2) % 3
                b3h = b3h + I1[i] * I1[j] * (parts[8 + ll] / rho) \
                    * Pq[i] * Pq[j]
        return b1h + b2h + b3h

    bispec.device = d0
    return bispec
