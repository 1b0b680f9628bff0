"""Measure the port's resample kernel (B4a, float64 u; B4b, float32 u) on
a CUDA card, beside chip_smoke.py.

    python3 tools/measure_torch_resample.py --roots PARENT . . PARENT
    python3 tools/measure_torch_resample.py --sweep [--out sweep.json]
    python3 tools/measure_torch_resample.py --fill [--out fill.json]

The shapes are the main path's, made once on the card by this checkout
from the golden files' grids at the bench cosmology: the electron path's
table (config 2: 4,000 rows x 2,049 kt -> 1,001 k, float64 for B4a and
float32 for B4b), the class build's gas and pressure tables (the README
example's Battaglia profiles at nxs 5,000: 4,000 x 2,501 -> 1,001), the kSZ
call's (500 x 2,049 -> 101) and the four-bin survey's (2,000 x 1,025 ->
101).  For each: the bound (chip_smoke.pair_lerp_work: each touched table
entry read once, scales, ks and the float64 output written once, over
3.35 TB/s) and, beside it, the reads counted in the 32-byte sectors that
hold the touched entries, and the share of a row between its first and
last touched entry.

--roots DIR [DIR ...]: for each checkout in the order given, one process
    that builds that checkout's kernels and times, by CUDA-graph replay
    (chip_smoke.device_ms, 200 calls a sample), the wrapper call at every
    shape, five samples each, after checking it against pair_lerp_plain
    with torch.equal; beside them an empty launch (a one-element zero_),
    a torch.gather of the 2 nk samples of each row, and the pressure table
    with the L2 flushed before each call: a graph of (zero_ of a 256 MiB
    buffer, call) minus a graph of the zero_ alone.  Give a parent and a
    change as parent, change, change, parent (unpack the parent with git
    archive into the git-ignored _trees/): all runs share the one card,
    the inputs and the timing code of this checkout.  Prints each shape's
    median per checkout and the spread over its runs and samples.

--sweep: this checkout's kernels at every launch geometry they take
    (1 to 4 whole rows a block where nk <= 256; the flat kernel on a grid
    of one wave or of every block the targets need) at every shape, 200
    calls a sample, by the ctypes call
    into a preallocated output, beside the geometry that
    resample_kernels.pair_lerp_geometry picks, and each kernel's
    registers and static SASS counts.

--fill: the serving path's Catmull-Rom fill (catmull_fill, F1) alone, at
    the fast cell's cube (512,000 x 589 -> 1,001, float32 y) and at one
    fused-cell sum (10,240 x 589 -> 1,001, float64 y), on the serving taps
    ((0.2, 4) on the README k grid), and at rows too wide to stage
    (20,000 x 8,000 -> 1,001, float64 y, on random sorted taps): the
    kernel checked bit for bit against catmull_fill_plain, then timed by
    CUDA-graph replay (five samples of 200 calls) beside the plain version
    (three samples of 10 calls) and the byte bound (y read once, the taps,
    the float64 output written once, over 3.35 TB/s), and the fill
    kernels' ptxas registers.

Run from the repository root on a machine with a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "hmvec_tpu_torch" / "data"
SAMPLES = 5
# one sample: 25 calls captured in a CUDA graph, replayed 8 times; the
# small shapes take ~2.5 us, where launch-to-launch jitter is ~0.5 us
REPLAY = {"calls": 25, "replays": 8}
FLUSH_BYTES = 256 * 2**20   # five times the L2
SECTOR = 32


def _chip_smoke():
    """This checkout's chip_smoke.py as a module (its timing and bound
    helpers), whichever checkout's package is being measured."""
    spec = importlib.util.spec_from_file_location("chip_smoke_tools",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs(dev) -> dict:
    """{shape name: (u, scales, ks, dkt)} at the main path's shapes, on the
    card, from this checkout's package (the pressure table by a class
    build whose resample calls are recorded and answered by the plain
    version, so nothing is built here)."""
    sys.path.insert(0, str(ROOT))
    from hmvec_tpu_torch import HaloModel
    from hmvec_tpu_torch import pipeline as pl
    from hmvec_tpu_torch.ops import resample_kernels as rk

    g = np.load(DATA / "pmm_config1_golden.npz")
    ge = np.load(DATA / "electron_config2_golden.npz")
    gk = np.load(DATA / "ksz_config5_golden.npz")
    zs, ks, ms = g["zs"], g["ks"], g["ms"]
    cosmo = dict(zip(g["param_names"].tolist(),
                     map(float, g["param_values"][0])))
    nxs, xmax = int(ge["nxs"]), float(ge["xmax"])
    out = {}
    for name, fast in (("electron", False), ("electron_fast", True)):
        out[name] = pl.electron_stage_inputs(zs, ks, ms, cosmo, device=dev,
                                             nxs=nxs, xmax=xmax, fast=fast)
    hm = HaloModel(zs, ks, ms=ms, params=cosmo, device=dev)
    nxs_c = int(hm.p["electron_density_profile_integral_numxs"])
    xmax_c = float(hm.p["electron_density_profile_integral_xmax"])
    out["class_gas"] = pl.electron_stage_inputs(zs, ks, ms, cosmo,
                                                device=dev, nxs=nxs_c,
                                                xmax=xmax_c)
    real, seen = rk._launch, []

    def record(*args):
        seen.append(args)
        return rk.pair_lerp_plain(*args)

    rk._launch = record
    try:
        hm.add_battaglia_pres_profile("y")
    finally:
        rk._launch = real
    out["class_pressure"] = seen[-1]
    cosmo_k = dict(zip(gk["param_names"].tolist(),
                       map(float, gk["param_values"][0])))
    ks_ksz = np.geomspace(0.1, 10.0, int(gk["num_kS_bins"]))
    for name, zs_l, nxs_l in (
            ("ksz", np.array([float(gk["z"])]), int(gk["nxs"])),
            ("ksz_survey", gk["zcents"], int(gk["survey_nxs"]))):
        out[name] = pl.electron_stage_inputs(zs_l, ks_ksz, gk["ms"], cosmo_k,
                                             device=dev, nxs=nxs_l,
                                             xmax=float(gk["xmax"]))
    return out


def sector_bytes(u, scales, ks, dkt) -> int:
    """Bytes of the 32-byte sectors of u that hold an entry some target
    reads (the entries of chip_smoke.pair_lerp_work), rows contiguous
    from an aligned start."""
    nkt = u.shape[-1]
    p = ks[None, :] * scales.reshape(-1)[:, None] / dkt
    win = (p >= 1.0) & (p <= nkt - 1.0)
    i0 = torch.floor(p).clamp(1, nkt - 2).long()
    rows = torch.arange(p.shape[0], device=u.device)[:, None] * nkt
    ones = (torch.zeros_like(i0) + 1 + rows)[p < 1.0]   # u[b, 1] below
    flat = torch.cat([(i0 + rows)[win], (i0 + 1 + rows)[win], ones])
    sectors = torch.unique(flat * u.element_size() // SECTOR)
    return int(sectors.numel()) * SECTOR


def window_share(u, scales, ks, dkt) -> float:
    """The mean over rows of the share of a row's samples between its
    first and last touched entry in the lerp window (what staging that
    window in shared memory would read)."""
    nkt = u.shape[-1]
    p = ks[None, :] * scales.reshape(-1)[:, None] / dkt
    win = (p >= 1.0) & (p <= nkt - 1.0)
    i0 = torch.floor(p).clamp(1, nkt - 2)
    lo = torch.where(win, i0, float(nkt)).amin(1)
    hi = torch.where(win, i0 + 1, -1.0).amax(1)
    has = win.any(1)
    return float(((hi - lo + 1) / nkt)[has].mean()) if has.any() else 0.0


def shape_of(args) -> str:
    u, s, k, _ = args
    return f"{s.numel()} x {u.shape[-1]} kt -> {k.numel()} k ({u.dtype})"


def time_root(root: pathlib.Path, inputs_path: pathlib.Path) -> dict:
    """Device times of the resample kernel of the checkout at root (run in
    a process of its own) on the saved inputs."""
    sys.path.insert(0, str(root))
    from hmvec_tpu_torch.ops import resample_kernels as rk

    cs_mod = _chip_smoke()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    inputs = torch.load(inputs_path, map_location=dev)
    one = torch.zeros(1, dtype=torch.float64, device=dev)
    flush = torch.empty(FLUSH_BYTES // 8, dtype=torch.float64, device=dev)
    times = {"empty_launch": [cs_mod.device_ms(lambda: one.zero_(), **REPLAY)
                              for _ in range(SAMPLES)]}
    equal = {}
    for name, args in inputs.items():
        wrapper = rk.pair_lerp_f32 if name == "electron_fast" else \
            rk.pair_lerp_f64
        got = wrapper(*args)
        torch.cuda.synchronize()
        equal[name] = torch.equal(got, rk.pair_lerp_plain(*args))
        times[name] = [cs_mod.device_ms(lambda: wrapper(*args), **REPLAY)
                       for _ in range(SAMPLES)]
    args = inputs["class_pressure"]
    times["class_pressure_l2_flushed"] = [
        cs_mod.device_ms(lambda: (flush.zero_(), rk.pair_lerp_f64(*args)),
                         **REPLAY)
        - cs_mod.device_ms(lambda: flush.zero_(), **REPLAY)
        for _ in range(SAMPLES)]
    return {"root": str(root), "card": cs_mod.card_line(), "times": times,
            "equal": equal, "sass": kernel_resources(cs_mod)}


def kernel_resources(cs_mod) -> dict:
    """Registers and static SASS counts by class of the resample kernels
    in the library that this process built (cuobjdump -res-usage, -sass)."""
    from hmvec_tpu_torch.kernels import _build

    path = _build.build_info["path"]
    tool = str(pathlib.Path(_build.find_nvcc()).with_name("cuobjdump"))
    out = {}
    for name, regions in cs_mod.sass_counts(subprocess.run(
            [tool, "-sass", path], capture_output=True, text=True,
            check=True, timeout=120).stdout).items():
        if name.startswith("pair_lerp"):
            out[name] = {"body": sum(regions["body"].values()),
                         "by_class": dict(sorted(regions["body"].items()))}
    fn = None
    for line in subprocess.run([tool, "-res-usage", path],
                               capture_output=True, text=True, check=True,
                               timeout=120).stdout.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = cs_mod.kernel_name(m.group(1))
        m = re.search(r"REG:(\d+)", line)
        if m and fn in out:
            out[fn]["registers"] = int(m.group(1))
    return out


def time_gathers(inputs, cs_mod) -> dict:
    """The yardstick for the loads alone: one torch.gather of the same
    2 nk indices per row."""
    out = {}
    for name, (u, s, k, dkt) in inputs.items():
        i0 = torch.floor(k * s.reshape(-1)[:, None] / dkt).clamp(
            1, u.shape[-1] - 2).long()
        idx = torch.cat([i0, i0 + 1], dim=1)
        u2 = u.reshape(-1, u.shape[-1])
        out[name] = cs_mod.device_ms(lambda: torch.gather(u2, 1, idx))
    return out


def sweep(inputs, cs_mod) -> dict:
    """This checkout's kernel at every geometry, by its ctypes call."""
    from hmvec_tpu_torch.kernels._build import load_library
    from hmvec_tpu_torch.ops import resample_kernels as rk

    from hmvec_tpu_torch.kernels import _build

    lib = load_library()
    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    report = {"ptxas": []}
    for line in _build.build_info.get("log", "").splitlines():
        if any(w in line for w in ("Function properties", "Used", "spill")):
            line = re.sub(r"_Z\w+", lambda m: cs_mod.kernel_name(
                m.group(0)), line.strip())
            report["ptxas"].append(line)
            print(f"[ptxas] {line}")
    for name, (u, s, k, dkt) in inputs.items():
        f32 = u.dtype == torch.float32
        occ = rk._blocks_per_sm(lib, f32, dev)
        fn = lib.hmvec_pair_lerp_f32 if f32 else lib.hmvec_pair_lerp_f64
        rows, nkt, nk = s.numel(), u.shape[-1], k.numel()
        out = torch.empty((rows, nk), dtype=torch.float64, device=dev)
        want = rk.pair_lerp_plain(u, s, k, dkt).reshape(rows, nk)
        chosen = rk.pair_lerp_geometry(rows, nk, n_sm, occ)
        rows_out = []
        needed = -(-rows * nk // (256 * 2 * rk.PAIRS))
        geometries = {(min(needed, n_sm * occ["flat"]), 0), (needed, 0)}
        width = -(-nk // 32) * 32
        for per_block in range(1, min(256 // width, 4) + 1):
            geometries.add((-(-rows // per_block), per_block))
        for geometry in sorted(geometries, key=lambda g: (-g[1], g[0])):
            def call(geometry=geometry):
                err = fn(u.data_ptr(), s.data_ptr(), k.data_ptr(),
                         float(dkt), out.data_ptr(), rows, nkt, nk,
                         *geometry, dev.index,
                         torch.cuda.current_stream(dev).cuda_stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: {err}")
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"{name} at {geometry} differs from "
                                   "pair_lerp_plain")
            ms = [cs_mod.device_ms(call, **REPLAY) for _ in range(3)]
            blocks, per_block_rows = geometry
            occupancy = occ["rows" if per_block_rows else "flat"]
            rows_out.append({"blocks": blocks, "rows_per_block":
                             per_block_rows, "blocks_per_sm": occupancy,
                             "ms": ms, "chosen": geometry == chosen})
            what = (f"{per_block_rows} whole rows a block" if per_block_rows
                    else f"{2 * rk.PAIRS} targets a thread")
            print(f"[sweep] {name} {shape_of((u, s, k, dkt))}: {blocks} "
                  f"blocks, {what} ({occupancy} blocks per SM"
                  f"{', chosen' if rows_out[-1]['chosen'] else ''}): "
                  f"{statistics.median(ms)!r} ms {ms!r}")
        report[name] = rows_out
    return report


def time_fill(cs_mod) -> dict:
    """The fill (F1) at the two serving shapes and at unstaged rows:
    bit-equality, kernel and plain device times and the bound."""
    sys.path.insert(0, str(ROOT))
    from hmvec_tpu_torch import pipeline as pl
    from hmvec_tpu_torch.kernels import _build
    from hmvec_tpu_torch.ops import resample_kernels as rk
    from hmvec_tpu_torch.params import merge_params

    dev = torch.device("cuda", 0)
    g = np.load(DATA / "pmm_config1_golden.npz")
    grids = pl._Grids(None, g["ks"], g["ms"], merge_params(), (0.2, 4), dev)
    serving = grids.taps
    nk = serving[0].shape[1]
    gen = torch.Generator(device=dev).manual_seed(3)
    wide_i = torch.randint(0, 8000, (4, nk), generator=gen, device=dev)
    wide = (wide_i.sort(dim=1).values.to(torch.int32),
            torch.randn((4, nk), generator=gen, dtype=torch.float64,
                        device=dev))
    report = {"ptxas": {
        k: v for k, v in cs_mod.ptxas_resources(
            _build.build_info.get("log", "")).items()
        if k.startswith("catmull_fill")}}
    for name, rows, nkq, dtype, (tap_i, tap_w) in (
            ("fast_cube", 512000, grids.kq.shape[0], torch.float32, serving),
            ("fused_sum", 10240, grids.kq.shape[0], torch.float64, serving),
            ("unstaged", 20000, 8000, torch.float64, wide)):
        y = torch.rand((rows, nkq), generator=gen, device=dev).to(dtype)
        got = rk.catmull_fill(y, tap_i, tap_w)
        want = rk.catmull_fill_plain(y, tap_i, tap_w)
        torch.cuda.synchronize()
        equal = torch.equal(got.view(torch.int64), want.view(torch.int64))
        del got, want
        nbytes = (y.numel() * y.element_size() + tap_i.numel() * 4
                  + tap_w.numel() * 8 + rows * nk * 8)
        bound_ms, bound_by = cs_mod.bound(nbytes, {"f64": 8 * rows * nk})
        kernel = [cs_mod.device_ms(lambda: rk.catmull_fill(y, tap_i, tap_w),
                                   **REPLAY) for _ in range(SAMPLES)]
        plain = [cs_mod.device_ms(
            lambda: rk.catmull_fill_plain(y, tap_i, tap_w), calls=5,
            replays=2) for _ in range(3)]
        med = statistics.median(kernel)
        report[name] = {
            "shape": f"{rows} x {nkq} -> {nk} ({dtype})", "equal": equal,
            "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_ms": kernel, "kernel_median_ms": med,
            "time_over_bound": med / bound_ms, "plain_ms": plain,
            "plain_median_ms": statistics.median(plain)}
        print(f"[fill] {name} {report[name]['shape']}: bit-equal {equal}; "
              f"kernel {med!r} ms ({kernel!r}), bound {bound_ms!r} ms by "
              f"{bound_by} ({nbytes} bytes), time / bound {med / bound_ms!r}; "
              f"plain {statistics.median(plain)!r} ms ({plain!r})")
        del y
        torch.cuda.empty_cache()
    for kern, res in sorted(report["ptxas"].items()):
        print(f"[ptxas] {kern}: {res}")
    return report


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--roots", nargs="+", type=pathlib.Path)
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--fill", action="store_true")
    parser.add_argument("--out", help="write the results as JSON here")
    parser.add_argument("--time-root", nargs=2, type=pathlib.Path,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("measure_torch_resample: needs a CUDA card", file=sys.stderr)
        return 2
    if args.time_root:
        root, inputs_path = args.time_root
        print(json.dumps(time_root(root.resolve(), inputs_path)))
        return 0
    cs_mod = _chip_smoke()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if args.fill:
        results = {"card": cs_mod.card_line(), "fill": time_fill(cs_mod)}
        print(results["card"])
        if args.out:
            pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            pathlib.Path(args.out).write_text(json.dumps(results, indent=1))
        return 0
    inputs = make_inputs(dev)
    card = cs_mod.card_line()
    print(card)
    results = {"card": card, "shapes": {}}
    for name, a in inputs.items():
        nbytes, ops = cs_mod.pair_lerp_work(*a)
        b_ms, b_by = cs_mod.bound(nbytes, ops)
        sec = sector_bytes(*a)
        touched = nbytes - 8 * (a[1].numel() + a[2].numel()
                                + a[1].numel() * a[2].numel())
        results["shapes"][name] = {
            "shape": shape_of(a), "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "read_bytes_entries": touched,
            "read_bytes_sectors": sec,
            "bound_ms_sectors": (nbytes - touched + sec) / 3.35e12 * 1e3,
            "window_share": window_share(*a)}
        row = results["shapes"][name]
        print(f"[shape] {name} {shape_of(a)}: bound {b_ms!r} ms by {b_by} "
              f"({nbytes} bytes; reads {touched} bytes by entries, {sec} "
              f"in 32-byte sectors, which would make the bound "
              f"{row['bound_ms_sectors']!r} ms); a row's touched window "
              f"{row['window_share']!r} of its samples on average")
    results["gather_ms"] = time_gathers(inputs, cs_mod)
    # the write stream alone: zero_ of a tensor of the output's size
    results["write_ms"] = {}
    for name, (u, s, k, _) in inputs.items():
        out = torch.empty((s.numel(), k.numel()), dtype=torch.float64,
                          device=dev)
        results["write_ms"][name] = cs_mod.device_ms(lambda: out.zero_())
        print(f"[time] zero_ of {name}'s output ({out.numel() * 8} bytes): "
              f"{results['write_ms'][name]!r} ms")
    if args.roots:
        with tempfile.TemporaryDirectory() as tmp:
            saved = pathlib.Path(tmp) / "inputs.pt"
            torch.save(inputs, saved)
            runs = []
            for root in args.roots:
                proc = subprocess.run(
                    [sys.executable, __file__, "--time-root", str(root),
                     str(saved)], capture_output=True, text=True,
                    timeout=900)
                if proc.returncode != 0:
                    raise RuntimeError(f"{root} failed:\n{proc.stderr}")
                runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        results["roots"] = runs
        for run in runs:
            for name, ok in run["equal"].items():
                if not ok:
                    print(f"[check] {run['root']}: {name} DIFFERS from "
                          f"pair_lerp_plain")
            for kern, res in sorted(run["sass"].items()):
                print(f"[sass] {run['root']}: {kern}: {res.get('registers')} "
                      f"registers, {res['body']} instructions "
                      f"{res['by_class']}")
        by_root = {}
        for run in runs:
            for name, ms in run["times"].items():
                by_root.setdefault(run["root"], {}).setdefault(
                    name, []).append(ms)
        for root, shapes in by_root.items():
            for name, samples in shapes.items():
                per_run = [statistics.median(ms) for ms in samples]
                flat = [t for ms in samples for t in ms]
                bound = results["shapes"].get(
                    name.replace("_l2_flushed", ""), {}).get("bound_ms")
                med = statistics.median(flat)
                extra = f", time / bound {med / bound!r}" if bound else ""
                print(f"[time] {root}: {name} median {med!r}"
                      f" ms, run medians {per_run!r}, spread "
                      f"{min(flat)!r}-{max(flat)!r}{extra} (CUDA-graph "
                      f"replays, 200 calls a sample; {card})")
    for name, t in results["gather_ms"].items():
        print(f"[time] torch.gather of {name}'s 2 nk samples: {t!r} ms")
    if args.sweep:
        results["sweep"] = sweep(inputs, cs_mod)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
