"""Where the time of one call of each pipeline of the PyTorch port goes on
the GPU: config 1 (Pmm), config 2 (electron), config 3 (HOD), config 4
(Limber), config 5 (kSZ) and the batch-serving lines.

For each NFW path of hmvec_tpu_torch.pipeline.make_pmm_fn (plain, exact,
fast, fused) and each tier of make_electron_fn (electron_plain,
electron_fast; nxs 4096, xmax 20) at 20 z x 200 m x 1001 k, this measures
the call's wall time (host clock to synchronize, median of 10, profiler
off), then traces one call with torch.profiler and reports the device time
summed over the call's kernels, the device's busy share of the unprofiled
wall time, the number of kernel launches, the number of host-device
synchronisations (scalar reads of device tensors), and the kernels that
took the most device time.  The exact path is measured once more as
"exact_ode": the same function at (w0, wa) = (-1.1, 0.3), which takes the
integrated growth (background.growth_table) in place of the closed form.
The same is measured for make_hod_fn and make_lensing_cls_fn (hod,
hod_fast, limber, limber_fast; ngal, ells and the source redshift from
their golden files) and for the batched calls b16, bN and bNf of
make_batched_fn (bench.py's batch lines, theta from pmm_batch_golden.npz),
with the wall time per cosmology and the peak memory allocated, and for
config 5 (ksz: make_ksz_snr_fn at the bench shape; ksz_survey: the
four-bin make_ksz_survey_fn; ksz_b16: a batch of 16 cosmologies of
make_ksz_snr_fn; shapes, bins and cosmology from ksz_config5_golden.npz),
and for the class API (class: the README example, hmvec_tpu_torch.HaloModel
at config 1's grids with the Battaglia gas and pressure profiles, an HOD
and the fast NFW profile, and its five spectra; class_ksz: get_ksz_snr at
config 5), and for the first extension group (extensions: HaloModel at
config 1's grids with halofit="mead", CIB tracers at 545 and 217 GHz and
an HI tracer on the fast NFW profile and the Battaglia pressure profile,
then get_p21, get_cib_cls at 16 ells and CIB x y; cmb_lensing_nl: the CMB
lensing C_L to L = 3000 on HMcode's nonlinear power).

For the electron tiers it then runs the call's layers one at a time --
the halo-model stages through the NFW profile, the M200 bisection, the
profile sampling and its DFT, the resample, the two spectra's assembly --
and reports each layer's wall time (median of 10), device time and
launches; the DFT is the share of the sampling layer's device time spent
in kernels named *fft*.  The HOD and Limber calls get the same: the stages,
the HOD grid with its ngal bisection and the two spectra's assembly; the
stages with the Pmm assembly and the Limber projection.

Run from the repository root on a machine with a CUDA card:

    python3 tools/profile_torch_pmm.py [--out profile.json] [--paths P ...]

--paths measures only the named paths, and skips the layers.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parents[1]
PATHS = {"plain": {"fast": False}, "exact": {"fast": "exact"},
         "fast": {"fast": True}, "fused": {"fused_serving": True}}
E_PATHS = {"electron_plain": False, "electron_fast": True}
W0WA = {"w0": -1.1, "wa": 0.3}     # a cosmology on the integrated growth
NXS, XMAX = 4096, 20.0
SERVING = {"static_params": {"sigma2_numks": 1250}, "uk_subsample": (0.2, 4)}
# batch line: (theta of, make_pmm_fn options, float32 output)
BATCHES = {"b16": ("b16", {"fast": True}, False),
           "bN": ("bN", {"fast": True, **SERVING}, True),
           "bNf": ("bN", {"fused_serving": True, **SERVING}, True)}


def _median_wall_ms(fn, n=10, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls), walls


def _trace(fn):
    """(result, profiler) of one traced call of fn."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, prof


def _kernels(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _device_us(evt) -> float:
    return float(evt.self_device_time_total)


def readme_example(g, ngal, ov, dev):
    """The README's example through the class API at config 1's grids,
    with the fast NFW profile, and its five spectra."""
    from hmvec_tpu_torch import HaloModel

    hm = HaloModel(g["zs"], g["ks"], ms=g["ms"], params=ov, device=dev)
    hm.add_battaglia_profile("e", family="AGN")
    hm.add_battaglia_pres_profile("y")
    hm.add_hod("g", ngal=ngal)
    hm.add_nfw_profile("nfw_fast", fast=True)
    return [hm.get_power(*names) for names in
            (("nfw",), ("g",), ("g", "e"), ("e", "e"), ("y", "y"))]


def extensions(g, ov, dev):
    """The extensions phase of chip_smoke.py: the build and three of its
    spectra."""
    from hmvec_tpu_torch import HaloModel

    hm = HaloModel(g["zs"], g["ks"], ms=g["ms"], params=ov, halofit="mead",
                   device=dev)
    hm.add_nfw_profile("nfw_fast", fast=True)
    hm.add_cib_tracer("cib545", 545.0, satellite_profile="nfw_fast")
    hm.add_cib_tracer("cib217", 217.0, satellite_profile="nfw_fast")
    hm.add_battaglia_pres_profile("y")
    hm.add_hi_tracer("hi", profile_name="nfw_fast")
    return [hm.get_p21("hi"),
            hm.get_cib_cls(np.geomspace(100.0, 3000.0, 16), "cib545",
                           "cib217"),
            hm.get_power("cib545", "y")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the report as JSON")
    ap.add_argument("--paths", nargs="*", default=None,
                    help="measure only these paths (and no layers)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_pmm: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from hmvec_tpu_torch import Cosmology, get_ksz_snr
    from hmvec_tpu_torch import pipeline as pl

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    g = np.load(ROOT / "hmvec_tpu_torch" / "data" / "pmm_config1_golden.npz")
    ov = dict(zip(g["param_names"].tolist(),
                  map(float, g["param_values"][0])))
    dev = torch.device("cuda", 0)
    report = {"card": card, "torch": torch.__version__, "paths": {},
              "electron_layers": {}}
    fns = {path: pl.make_pmm_fn(g["zs"], g["ks"], g["ms"], device=dev, **kw)
           for path, kw in PATHS.items()}
    fns.update({path: pl.make_electron_fn(g["zs"], g["ks"], g["ms"],
                                          device=dev, nxs=NXS, xmax=XMAX,
                                          fast=fast)
                for path, fast in E_PATHS.items()})
    data = ROOT / "hmvec_tpu_torch" / "data"
    gh = np.load(data / "hod_config3_golden.npz")
    gl = np.load(data / "lensing_config4_golden.npz")
    gb = np.load(data / "pmm_batch_golden.npz")
    for tier, fast in (("", False), ("_fast", True)):
        fns[f"hod{tier}"] = pl.make_hod_fn(g["zs"], g["ks"], g["ms"],
                                           gh["ngal"], device=dev, fast=fast)
        fns[f"limber{tier}"] = pl.make_lensing_cls_fn(
            g["zs"], g["ks"], g["ms"], gl["ells"], float(gl["zsource"]),
            device=dev, fast=fast)
    calls = {path: (fn, ov) for path, fn in fns.items()}
    calls["exact_ode"] = (fns["exact"], {**ov, **W0WA})
    batch_size = {"ksz_b16": 16}
    gk = np.load(data / "ksz_config5_golden.npz")
    kcfg = {k: int(gk[k]) for k in ("num_kL_bins", "num_kS_bins",
                                     "num_mu_bins")}
    cls = torch.as_tensor(gk["cls"], device=dev)
    ksz = pl.bind_args(pl.make_ksz_snr_fn(
        float(gk["z"]), float(gk["volume_gpc3"]), float(gk["ngal_mpc3"]),
        device=dev, ms=gk["ms"], nxs=int(gk["nxs"]), xmax=float(gk["xmax"]),
        growth="closed", **kcfg), cls)
    survey = pl.make_ksz_survey_fn(
        gk["zcents"].size, device=dev, ms=gk["ms"], nxs=int(gk["survey_nxs"]),
        xmax=float(gk["xmax"]), growth="closed", **kcfg)
    calls["ksz"] = (ksz, ov)
    calls["ksz_survey"] = (lambda o: survey(o, gk["zcents"], gk["vols_gpc3"],
                                            gk["ngals"], cls), ov)
    calls["ksz_b16"] = (pl.make_batched_fn(ksz, ("omch2", "As")),
                        gb["theta_b16"])
    calls["class"] = (lambda o: readme_example(g, gh["ngal"], o, dev), ov)
    calls["class_ksz"] = (lambda o: get_ksz_snr(
        float(gk["volume_gpc3"]), float(gk["z"]), float(gk["ngal_mpc3"]),
        gk["cls"], params=o, ms=gk["ms"], electron_profile_nxs=int(gk["nxs"]),
        electron_profile_xmax=float(gk["xmax"]), device=dev, **kcfg)[0], ov)
    calls["extensions"] = (lambda o: extensions(g, o, dev), ov)
    calls["cmb_lensing_nl"] = (lambda o: Cosmology(o, device=dev)
                               .cmb_lensing_limber(3000, nonlinear=True), ov)
    for line, (tkey, kw, f32) in BATCHES.items():
        theta = gb[f"theta_{tkey}"]
        batch_size[line] = theta.shape[0]
        calls[line] = (pl.make_batched_fn(
            pl.make_pmm_fn(g["zs"], g["ks"], g["ms"], device=dev, **kw),
            tuple(gb["param_names"].tolist()),
            out_dtype=torch.float32 if f32 else None), theta)
    if args.paths is not None:
        calls = {p: calls[p] for p in args.paths}
    for path, (fn, ov_) in calls.items():
        n = 5 if path in batch_size else 10
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        wall, walls = _median_wall_ms(lambda: fn(ov_), n=n)
        peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
        _, prof = _trace(lambda: fn(ov_))
        kernels = _kernels(prof)
        device_ms = sum(_device_us(e) for e in kernels) / 1e3
        d2h = sum(1 for e in prof.events()
                  if e.name == "aten::_local_scalar_dense")
        top = sorted(prof.key_averages(), key=_device_us, reverse=True)[:8]
        rep = {"wall_ms": wall, "wall_ms_quartiles": statistics.quantiles(
                   walls, n=4),
               "device_ms": device_ms, "busy_share": device_ms / wall,
               "kernel_launches": len(kernels), "host_syncs": d2h,
               "peak_mib": peak_mib,
               "top_kernels": [{"name": e.key[:90],
                                "device_ms": _device_us(e) / 1e3,
                                "calls": e.count} for e in top
                               if _device_us(e) > 0]}
        per = ""
        if path in batch_size:
            rep["batch"] = batch_size[path]
            rep["wall_ms_per_cosmology"] = wall / batch_size[path]
            per = (f" = {rep['wall_ms_per_cosmology']!r} ms per cosmology of "
                   f"{batch_size[path]}")
        report["paths"][path] = rep
        print(f"[{path}] wall {wall!r} ms (median of {n}){per}, device "
              f"{device_ms!r} ms in {len(kernels)} kernels, busy share "
              f"{rep['busy_share']!r}, host syncs {d2h}, peak "
              f"{peak_mib:.1f} MiB allocated ({card})")
        for t in rep["top_kernels"]:
            print(f"    {t['device_ms']:.4f} ms  x{t['calls']:<4d} "
                  f"{t['name']}")
    for path, fast in E_PATHS.items() if args.paths is None else ():
        report["electron_layers"][path] = layers = electron_layers(
            pl, g, ov, dev, fast)
        for name, rep in layers.items():
            print(f"[{path} / {name}] wall {rep['wall_ms']!r} ms (median of "
                  f"10), device {rep['device_ms']!r} ms in "
                  f"{rep['kernel_launches']} kernels" + (
                      f", of which fft {rep['fft_device_ms']!r} ms"
                      if "fft_device_ms" in rep else "") + f" ({card})")
    for what in ("hod", "limber") if args.paths is None else ():
        report[f"{what}_layers"] = (
            hod_layers(pl, g, ov, dev, gh["ngal"]) if what == "hod"
            else limber_layers(pl, g, ov, dev, gl["ells"],
                               float(gl["zsource"])))
        for name, rep in report[f"{what}_layers"].items():
            print(f"[{what}_fast / {name}] wall {rep['wall_ms']!r} ms (median "
                  f"of 10), device {rep['device_ms']!r} ms in "
                  f"{rep['kernel_launches']} kernels ({card})")
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


def electron_layers(pl, g, ov, dev, fast):
    """The layers of one make_electron_fn call run one at a time, as the
    call runs them (hmvec_tpu_torch/pipeline.py, make_electron_fn)."""
    from hmvec_tpu_torch.models import linear_power as lpm
    from hmvec_tpu_torch.models import power as pwr
    from hmvec_tpu_torch.ops.sine_transform import (profile_table,
                                                    resample_uniform_source)
    from hmvec_tpu_torch.params import (battaglia_defaults, merge_params,
                                        to_torch_params)

    defaults = merge_params()
    grids = pl._Grids(g["zs"], g["ks"], g["ms"], defaults, None, dev)
    engine = lpm.EHEngine()
    fit = dict(battaglia_defaults["AGN"])
    p = {**defaults, **to_torch_params(ov, dev)}
    dtype = torch.float32 if fast else torch.float64
    st = {}

    def stages():
        st["stages"] = pl._stages(p, grids, "sheth-torman", "vir", "medium",
                                  engine, fast_nfw=fast,
                                  growth_mode="closed")

    def bisection():
        st["gas"] = pl._gas_profile(p, grids.zs, grids.ms, st["stages"].bg,
                                     "vir", fit)

    def sampling():
        rhofunc, cmaxs, rgs = st["gas"]
        st["table"] = profile_table(rhofunc, cmaxs, rgs, grids.zs, XMAX,
                                    NXS, sample_dtype=dtype)

    def resample():
        u, scales, dkt, norm = st["table"]
        uk = resample_uniform_source(u, dkt, scales, grids.ks)
        st["uk_e"] = uk if norm is None else uk * norm[..., None]

    def assembly():
        _, pzk, nzm, bh, rho_m0, uk_nfw, _ = st["stages"]
        te = pwr.MatterTracer(uk=st["uk_e"])
        tn = pwr.MatterTracer(uk=uk_nfw)
        return (pwr.power_total(te, te, nzm, bh, grids.ms, grids.ks, pzk,
                                rho_m0, p["kstar_damping"]),
                pwr.power_total(tn, te, nzm, bh, grids.ms, grids.ks, pzk,
                                rho_m0, p["kstar_damping"]))

    return _run_layers((("stages through NFW", stages),
                        ("M200 bisection", bisection),
                        ("sampling + DFT", sampling), ("resample", resample),
                        ("assembly", assembly)))


def _fast_stages(pl, g, ov, dev):
    """(p, grids, stages) of one fast-tier call at the overrides ov:
    stages() runs pipeline._stages as the make_*_fn functions do."""
    from hmvec_tpu_torch.models import linear_power as lpm
    from hmvec_tpu_torch.params import merge_params, to_torch_params

    defaults = merge_params()
    grids = pl._Grids(g["zs"], g["ks"], g["ms"], defaults, None, dev)
    p = {**defaults, **to_torch_params(ov, dev)}
    engine = lpm.EHEngine()
    return p, grids, lambda: pl._stages(p, grids, "sheth-torman", "vir",
                                        "medium", engine, fast_nfw=True,
                                        growth_mode="closed")


def hod_layers(pl, g, ov, dev, ngal):
    """The layers of one make_hod_fn(fast=True) call run one at a time."""
    from hmvec_tpu_torch.models import power as pwr
    from hmvec_tpu_torch.models.hod import build_hod

    p, grids, run_stages = _fast_stages(pl, g, ov, dev)
    ngal_t = grids.tensor(ngal)
    hp = {k: p[k] for k in p if k.startswith("hod_")}
    st = {}

    def stages():
        st["stages"] = run_stages()

    def hod_grid():
        _, _, nzm, bh, _, _, _ = st["stages"]
        st["grid"] = build_hod(grids.zs, grids.ms, nzm, bh, hp, ngal=ngal_t)

    def assembly():
        _, pzk, nzm, bh, rho_m0, uk, _ = st["stages"]
        gr = st["grid"]
        tg = pwr.HODTracer(Nc=gr.Nc, Ns=gr.Ns, NsNsm1=gr.NsNsm1,
                           NcNs=gr.NcNs, ngal=gr.ngal, bg=gr.bg, us=uk)
        tn = pwr.MatterTracer(uk=uk)
        return (pwr.power_total(tg, tg, nzm, bh, grids.ms, grids.ks, pzk,
                                rho_m0, p["kstar_damping"]),
                pwr.power_total(tg, tn, nzm, bh, grids.ms, grids.ks, pzk,
                                rho_m0, p["kstar_damping"]))

    return _run_layers((("stages through NFW", stages),
                        ("HOD grid + ngal bisection", hod_grid),
                        ("assembly", assembly)))


def limber_layers(pl, g, ov, dev, ells, zsource):
    """The layers of one make_lensing_cls_fn(fast=True) call run one at a
    time."""
    from hmvec_tpu_torch.models import limber as limb
    from hmvec_tpu_torch.models import power as pwr

    p, grids, run_stages = _fast_stages(pl, g, ov, dev)
    ells_t = grids.tensor(ells)
    st = {}

    def stages_and_pmm():
        bg, pzk, nzm, bh, rho_m0, uk, _ = run_stages()
        tr = pwr.MatterTracer(uk=uk)
        st["bg"] = bg
        st["pmm"] = pwr.power_total(tr, tr, nzm, bh, grids.ms, grids.ks, pzk,
                                    rho_m0, p["kstar_damping"])

    def projection():
        return limb.C_kk(st["bg"], ells_t, grids.zs, grids.ks, st["pmm"],
                         lzs1=zsource, lzs2=zsource)

    return _run_layers((("stages + Pmm assembly", stages_and_pmm),
                        ("Limber projection", projection)))


def _run_layers(layers):
    """{name: wall (median of 10), device time and launches} of each
    (name, fn) run in turn."""
    out = {}
    for name, fn in layers:
        wall, _ = _median_wall_ms(fn)
        _, prof = _trace(fn)
        kernels = _kernels(prof)
        rep = {"wall_ms": wall, "kernel_launches": len(kernels),
               "device_ms": sum(_device_us(e) for e in kernels) / 1e3}
        if name == "sampling + DFT":
            rep["fft_device_ms"] = sum(_device_us(e) for e in kernels
                                       if "fft" in e.name.lower()) / 1e3
        out[name] = rep
    return out


if __name__ == "__main__":
    sys.exit(main())
