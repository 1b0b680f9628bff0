"""Measure the port's NFW kernels on a CUDA card, beside chip_smoke.py.

    python3 tools/measure_torch_nfw.py --roots PARENT . . PARENT
    python3 tools/measure_torch_nfw.py --floors [--out floors.json]
                                       [--sass-out probes.sass]

--roots DIR [DIR ...]: for each checkout in the order given, one process
    that builds that checkout's kernels and times, by CUDA-graph replay at
    the config-1 shapes (4,000 rows x 1,001 k; 20 x 200 x 1,001), each NFW
    wrapper call (nfw_uk_fast, nfw_uk_exact, nfw_contract) and its bare
    launch: the kernel's ctypes call into preallocated outputs.  Where a
    checkout's kernels take precomputed row constants (the port before its
    kernels computed their own; PERF.md's row-constant costs come from
    that comparison), the bare launch gets them computed outside the
    timed graph, so that wrapper minus bare is what the row constants'
    launches cost.  Give a parent and a change as parent,
    change, change, parent: all runs share the one card and the timing
    code of this checkout's chip_smoke.py.

--floors: the issue-rate floor of this checkout's NFW kernels at the
    config-1 inputs.  It builds tools/torch_nfw_probe.cu -- hmvec::nfw_u
    with the Si/Ci domains of x and x2 fixed at compile time -- to a cubin
    and counts each probe's SASS instructions (cuobjdump -sass, the body
    before the trap loop), which is the path an element in that pair of
    domains runs.  The count per element, weighted over the run's elements
    by their domains (in the tier's precision), times the elements, over
    132 SMs x 4 warp-instructions per clock x 32 lanes x the maximum SM
    clock nvidia-smi reports, is the least time the card needs to issue
    the kernel's instructions; warps that straddle a domain edge, which
    run two bodies, are counted at one (their share is printed).  The
    contraction kernel's floor counts its float32 u evaluations alone.
    Beside it, the float64-pipe floor: an SM has 64 float64 lanes, two
    warp-instructions per clock, so the float64 arithmetic instructions
    per element (DFMA, DMUL, DADD, DSETP, DMNMX) times the elements, over
    132 SMs x 2 x 32 lanes x the clock.  The larger of the two is the
    kernel's floor.  --sass-out FILE keeps the probes' disassembly.

Run from the repository root on a machine with a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROBE = ROOT / "tools" / "torch_nfw_probe.cu"
ISSUE_PER_CLOCK = 4   # warp-instructions per SM per clock
FP64_PER_CLOCK = 2    # of them float64 arithmetic: 64 lanes per SM
WARP = 32


def _run(cmd, timeout) -> str:
    """Standard output of cmd; raises with its standard error if it
    fails."""
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    return proc.stdout


def _chip_smoke():
    """This checkout's chip_smoke.py as a module (its timing and SASS
    helpers), whichever checkout's package is being measured."""
    spec = importlib.util.spec_from_file_location("chip_smoke_tools",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config1_inputs(root, dev):
    from hmvec_tpu_torch import pipeline as pl

    g = np.load(root / "hmvec_tpu_torch" / "data" / "pmm_config1_golden.npz")
    cosmo = dict(zip(g["param_names"].tolist(),
                     map(float, g["param_values"][0])))
    return pl.nfw_stage_inputs(g["zs"], g["ks"], g["ms"], cosmo, device=dev)


def time_root(root: pathlib.Path) -> dict:
    """Wrapper and bare-launch device times of the NFW kernels of the
    checkout at root (run in a process of its own)."""
    sys.path.insert(0, str(root))
    from hmvec_tpu_torch.kernels import _build
    from hmvec_tpu_torch.ops import nfw_kernels as nk

    cs_mod = _chip_smoke()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ks, scales, cs, a, b = _config1_inputs(root, dev)
    s, c = scales.reshape(-1).contiguous(), cs.reshape(-1).contiguous()
    nz, nm = scales.shape
    lib = _build.load_library()
    u32 = torch.empty((s.numel(), ks.numel()), dtype=torch.float32,
                      device=dev)
    u64 = torch.empty((s.numel(), ks.numel()), dtype=torch.float64,
                      device=dev)
    s1 = torch.empty((nz, ks.numel()), dtype=torch.float64, device=dev)
    s2 = torch.empty_like(s1)

    def raw(fn, *args):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[t.data_ptr() if isinstance(t, torch.Tensor) else t
                   for t in args], dev.index, stream)
        if err != 0:
            raise RuntimeError(f"launch failed with cudaError_t {err}")

    if hasattr(nk, "_row_constants"):
        rows = nk._row_constants(s, c)
        rows_zm = nk._row_constants(scales, cs)
        bare = {
            "nfw_uk_fast": lambda: raw(lib.hmvec_nfw_uk_f32, ks, rows, u32,
                                       s.numel(), ks.numel()),
            "nfw_uk_exact": lambda: raw(lib.hmvec_nfw_uk_f64, ks, rows, u64,
                                        s.numel(), ks.numel()),
            "nfw_contract": lambda: raw(lib.hmvec_nfw_contract_f64, ks,
                                        rows_zm, a, b, s1, s2, nz, nm,
                                        ks.numel()),
        }
    else:
        bare = {
            "nfw_uk_fast": lambda: nk._launch_nfw_uk(ks, s, c, "fast",
                                                     out=u32),
            "nfw_uk_exact": lambda: nk._launch_nfw_uk(ks, s, c, "exact",
                                                      out=u64),
            "nfw_contract": lambda: nk._launch_nfw_contract(
                ks, scales, cs, a, b, out=(s1, s2)),
        }
    wrapper = {
        "nfw_uk_fast": lambda: nk.nfw_uk_fast(ks, s, c),
        "nfw_uk_exact": lambda: nk.nfw_uk_exact(ks, s, c),
        "nfw_contract": lambda: nk.nfw_contract(ks, scales, cs, a, b),
    }
    times = {name: {"wrapper_ms": cs_mod.device_ms(wrapper[name]),
                    "bare_ms": cs_mod.device_ms(bare[name])}
             for name in wrapper}
    return {"root": str(root), "card": cs_mod.card_line(), "times": times}


def _domains(x):
    """Si/Ci domain of each x: 0 (<= 4), 1 (<= 10), 2 (<= 40), 3."""
    return ((x > 4.0).to(torch.int64) + (x > 10.0).to(torch.int64)
            + (x > 40.0).to(torch.int64))


def floors(sass_out=None) -> dict:
    """Issue-rate floors of this checkout's NFW kernels (see above)."""
    sys.path.insert(0, str(ROOT))
    from hmvec_tpu_torch.kernels import _build

    cs_mod = _chip_smoke()
    dev = torch.device("cuda", 0)
    _build.load_library()
    lib_dir = pathlib.Path(_build.build_info["path"]).parent
    nvcc = _build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        cubin = pathlib.Path(tmp) / "probe.cubin"
        _run([nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
              "-std=c++17", "-O3", "-I", str(lib_dir), "-I", str(_build.CSRC),
              "-o", str(cubin), str(PROBE)], 600)
        sass = _run([str(pathlib.Path(nvcc).with_name("cuobjdump")), "-sass",
                     str(cubin)], 120)
    if sass_out:
        pathlib.Path(sass_out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(sass_out).write_text(sass)
    probes = {}
    for name, regions in cs_mod.sass_counts(sass).items():
        m = re.search(r"nfw_u_probeI([fd])Li(\d)ELi(\d)E", name)
        if m:
            probes[(m.group(1), int(m.group(2)), int(m.group(3)))] = \
                regions["body"]
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ks, scales, cs, _, _ = _config1_inputs(ROOT, dev)
    x = ks[None, :] * scales.reshape(-1)[:, None]
    x2 = ks[None, :] * ((1.0 + cs.reshape(-1)) * scales.reshape(-1))[:, None]
    report = {"card": cs_mod.card_line(), "clock_max_sm_mhz": clock_mhz,
              "sms": n_sm, "probes": {f"{t}{d1}{d2}": dict(v) for
                                     (t, d1, d2), v in probes.items()}}
    for kernel, t, dtype in (("nfw_uk_fast", "f", torch.float32),
                             ("nfw_uk_exact", "d", torch.float64),
                             ("nfw_contract", "f", torch.float32)):
        d1, d2 = _domains(x.to(dtype)), _domains(x2.to(dtype))
        pairs = collections.Counter(
            zip(d1.reshape(-1).tolist(), d2.reshape(-1).tolist()))
        per_class = collections.Counter()
        for (p1, p2), n in pairs.items():
            for cls, cnt in probes[(t, p1, p2)].items():
                per_class[cls] += n * cnt
        n_el = x.numel()
        total = sum(per_class.values())
        # warps: 32 neighbouring k of one row, from k = 0
        nk = ks.numel()
        pad = -nk % WARP
        w1 = torch.nn.functional.pad(d1, (0, pad), value=-1).reshape(
            d1.shape[0], -1, WARP)
        w2 = torch.nn.functional.pad(d2, (0, pad), value=-1).reshape(
            d2.shape[0], -1, WARP)

        def mixed(w):
            lo = torch.where(w < 0, 9, w).amin(-1)
            return lo != w.amax(-1)

        divergent = (mixed(w1) | mixed(w2)).double().mean().item()
        warp_clocks_per_ms = n_sm * clock_mhz * 1e3
        floor_ms = total / WARP / (ISSUE_PER_CLOCK * warp_clocks_per_ms)
        fp64_ms = per_class["fp64"] / WARP / (FP64_PER_CLOCK
                                              * warp_clocks_per_ms)
        report[kernel] = {
            "elements": n_el,
            "instructions_per_element": total / n_el,
            "per_element_by_class": {k: v / n_el for k, v in
                                     sorted(per_class.items())},
            "divergent_warp_share": divergent,
            "issue_floor_ms": floor_ms,
            "fp64_pipe_floor_ms": fp64_ms,
        }
        print(f"[floor] {kernel}: {total / n_el!r} SASS instructions per "
              f"element ({ {k: round(v / n_el, 2) for k, v in sorted(per_class.items())} }), "
              f"{n_el} elements, issue floor {floor_ms!r} ms, float64-pipe "
              f"floor {fp64_ms!r} ms at "
              f"{clock_mhz} MHz x {n_sm} SMs; warps straddling a domain "
              f"edge {divergent!r} ({report['card']})")
    return report


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--roots", nargs="+", type=pathlib.Path)
    parser.add_argument("--floors", action="store_true")
    parser.add_argument("--out", help="write the results as JSON here")
    parser.add_argument("--sass-out",
                        help="with --floors: write the probes' SASS here")
    parser.add_argument("--time-root", type=pathlib.Path,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("measure_torch_nfw: needs a CUDA card", file=sys.stderr)
        return 2
    if args.time_root:
        print(json.dumps(time_root(args.time_root.resolve())))
        return 0
    results = {}
    if args.roots:
        runs = []
        for root in args.roots:
            out = _run([sys.executable, __file__, "--time-root", str(root)],
                       900)
            run = json.loads(out.strip().splitlines()[-1])
            runs.append(run)
            for name, t in run["times"].items():
                print(f"[time] {run['root']}: {name} wrapper "
                      f"{t['wrapper_ms']!r} ms, bare launch {t['bare_ms']!r} "
                      f"ms (CUDA-graph replays of 25 calls; {run['card']})")
        results["roots"] = runs
    if args.floors:
        results["floors"] = floors(args.sass_out)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
