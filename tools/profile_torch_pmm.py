"""Where the time of one config-1 Pmm call and one config-2 electron call
goes on the GPU.

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

For the electron tiers it then runs the call's layers one at a time --
the halo-model stages through the NFW profile, the M200 bisection, the
profile sampling and its DFT, the resample, the two spectra's assembly --
and reports each layer's wall time (median of 10), device time and
launches; the DFT is the share of the sampling layer's device time spent
in kernels named *fft*.

Run from the repository root on a machine with a CUDA card:

    python3 tools/profile_torch_pmm.py [--out profile.json]
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the report as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_pmm: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
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
    calls = {path: (fn, ov) for path, fn in fns.items()}
    calls["exact_ode"] = (fns["exact"], {**ov, **W0WA})
    for path, (fn, ov_) in calls.items():
        wall, walls = _median_wall_ms(lambda: fn(ov_))
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
               "top_kernels": [{"name": e.key[:90],
                                "device_ms": _device_us(e) / 1e3,
                                "calls": e.count} for e in top
                               if _device_us(e) > 0]}
        report["paths"][path] = rep
        print(f"[{path}] wall {wall!r} ms (median of 10), device "
              f"{device_ms!r} ms in {len(kernels)} kernels, busy share "
              f"{rep['busy_share']!r}, host syncs {d2h} ({card})")
        for t in rep["top_kernels"]:
            print(f"    {t['device_ms']:.4f} ms  x{t['calls']:<4d} "
                  f"{t['name']}")
    for path, fast in E_PATHS.items():
        report["electron_layers"][path] = layers = electron_layers(
            pl, g, ov, dev, fast)
        for name, rep in layers.items():
            print(f"[{path} / {name}] wall {rep['wall_ms']!r} ms (median of "
                  f"10), device {rep['device_ms']!r} ms in "
                  f"{rep['kernel_launches']} kernels" + (
                      f", of which fft {rep['fft_device_ms']!r} ms"
                      if "fft_device_ms" in rep else "") + f" ({card})")
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
        st["gas"] = pl._gas_profile(p, grids, st["stages"][0], "vir", fit)

    def sampling():
        rhofunc, cmaxs, rgs = st["gas"]
        st["table"] = profile_table(rhofunc, cmaxs, rgs, grids.zs, XMAX,
                                    NXS, sample_dtype=dtype)

    def resample():
        u, scales, dkt, norm = st["table"]
        uk = resample_uniform_source(u, dkt, scales, grids.ks)
        st["uk_e"] = uk if norm is None else uk * norm[..., None]

    def assembly():
        _, pzk, nzm, bh, rho_m0, uk_nfw = st["stages"]
        te = pwr.MatterTracer(uk=st["uk_e"])
        tn = pwr.MatterTracer(uk=uk_nfw)
        return (pwr.power_total(te, te, nzm, bh, grids.ms, grids.ks, pzk,
                                rho_m0, p["kstar_damping"]),
                pwr.power_total(tn, te, nzm, bh, grids.ms, grids.ks, pzk,
                                rho_m0, p["kstar_damping"]))

    out = {}
    for name, fn in (("stages through NFW", stages),
                     ("M200 bisection", bisection),
                     ("sampling + DFT", sampling), ("resample", resample),
                     ("assembly", assembly)):
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
