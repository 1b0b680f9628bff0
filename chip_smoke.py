#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU.

Builds the hand-written CUDA kernels from hmvec_tpu_torch/csrc, checks each
against its plain PyTorch version on the card, and drives the port's two
paths at bench width, 20 z x 200 m x 1001 k, for the three cosmologies of
the golden files that the JAX package wrote (tools/gen_torch_golden.py):

* config 1, hmvec_tpu_torch.pipeline.make_pmm_fn, through its four NFW
  paths (plain, exact, fast, fused);
* config 2, make_electron_fn (Pee, Pme; nxs 4096, xmax 20), through both
  tiers (float64 sampling; fast=True: float32 sampling and the fast NFW
  kernel).

A growth_ode phase then drives config 1 on the integrated w0/wa growth
(growth="ode": plain, exact and fused) against its own golden file, with
the Jacobian over (omch2, w0, wa), the launches of one growth table, and
an ode call's latency beside a closed-form call's.

A batch phase drives pipeline.make_batched_fn on the batch-serving lines
of bench.py -- b16 (16 cosmologies, fast tier, float64 out), bN (128
cosmologies, fast tier, sigma^2 on 1,250 k, u(k) thinned below k = 0.2,
float32 out) and bNf (the same through the fused tier) -- and on a plain
and an exact B = 16 batch and a B = 2 electron batch: chosen rows against
a JAX golden file, every row against the port's own single call, one
launch of each NFW kernel per batched call, the launches of a batched
call beside a single call's, latency per cosmology and peak memory.  The
hod and limber phases drive config 3, make_hod_fn (Pgg, Pgm; ngal 1e-4
per z), and config 4, make_lensing_cls_fn (C_kk at 60 ells, Pmm; source
at z = 1100), plain and fast, against their golden files.  The massfn
phase drives config 1 with each further mass function (Tinker, Tinker
2008, Press-Schechter, Despali), plain and fast, against its golden file.
The ksz phase drives config 5: make_ksz_snr_fn at the bench shape (z 0.55,
10 Gpc^3, 500 masses, 100/101/102 kL/kS/mu bins, nxs 4096) against its
golden snr, Nvv and vrec, the Jacobian of snr over (omch2, As), the four-bin
make_ksz_survey_fn (nxs 2048), and a B = 16 batch over (omch2, As) against
its single calls, each with one launch of the float64 resample kernel.

It differentiates both paths, and times the kernels, at one cosmology's
shapes and at the batches', and the end-to-end calls.
Each path is driven with every kernel's launch count set to 0 just before
it and read just after.  Every gate that fails raises, so the script exits
nonzero and prints no result.

Before the paths it prints, as [env] lines, each kernel's registers, stack
and spills (ptxas), its static SASS instruction count by class (cuobjdump)
and the NFW kernels' occupancy and waves at config 1, and it holds each
kernel against its plain version: the NFW kernels at config 1 and on
adversarial rows, among them inputs that put x and (1+c)x on the Si/Ci
domain edges inside single warps; the contraction also against itself on
a second call (bit for bit).  With the NFW kernels' device times it
prints each one's bare launch (its ctypes call into preallocated outputs)
beside the wrapper call.

Run from the repository root, on a machine with a CUDA card:

    python3 chip_smoke.py

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it lists each kernel with its launches on the paths, its
error against the plain version, its time, the plain version's time, and
the least time the card could take for the same work (bound_ms, set by
bytes or operations).
"""

from __future__ import annotations

import collections
import ctypes
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "hmvec_tpu_torch" / "data"
GOLDEN = DATA / "pmm_config1_golden.npz"
GOLDEN_E = DATA / "electron_config2_golden.npz"
GOLDEN_W = DATA / "pmm_config1_w0wa_golden.npz"
GOLDEN_B = DATA / "pmm_batch_golden.npz"
GOLDEN_H = DATA / "hod_config3_golden.npz"
GOLDEN_L = DATA / "lensing_config4_golden.npz"
GOLDEN_K = DATA / "ksz_config5_golden.npz"
GOLDEN_M = DATA / "pmm_massfn_golden.npz"

# kernel vs plain version on the card (absolute on u; relative on S1, S2;
# the resample kernel repeats the plain version's float64 operations in
# the same order, so it must agree bit for bit).  The contraction kernel
# computes u in the fast tier's float32, as the TPU kernel it ports does
# (and the fused tier's JAX path asks for), and sums in float64, so its
# gate is that TPU kernel's own 2e-5 relative, not float64's rounding.
GATE_UK = {"exact": 2e-7, "fast": 5e-6}
# what the float64 kernel is designed to beside its gate: float64-class u
# on every case (tools/emulate_torch_nfw_fast.py --tier exact holds its
# arithmetic to the same number on the CPU)
EXPECT_UK_EXACT = 1e-12
GATE_CONTRACT_REL = 2e-5
GATE_LERP = 0.0
# end to end, max relative error against the golden spectra
GATE_PMM = {"plain": 1e-10, "exact": 1e-7, "fast": 1e-5, "fused": 1e-5}
GATE_E = {"electron_plain": 1e-10, "electron_fast": 1e-5}
GATE_JAC_REL = 1e-6
# growth="ode" at LCDM against the closed form (the JAX package's own
# gate, tests/test_background.py), and the launches of one growth table
GATE_ODE_VS_CLOSED = 1e-7
MAX_GROWTH_TABLE_LAUNCHES = 2500
ODE_PATHS = ("plain", "exact", "fused")
# configs 3 and 4 against their golden files, by NFW tier
GATE_TIER = {"plain": 1e-10, "fast": 1e-5}
# config 5 (kSZ) against its golden file: snr, Nvv, vrec and the survey
GATE_KSZ = 1e-10
KSZ_BATCH = 16
# the mass-function modes of config 1 by NFW tier: (fast, gate)
MASSFN_TIERS = {"plain": (False, 1e-10), "fast": (True, 1e-5)}
# a batched call against the port's own single calls, row by row: the same
# arithmetic per element, whatever the batch
GATE_BATCH_VS_SINGLE = 1e-12
# the serving options of bench.py's bN and bNf lines
SERVING = {"static_params": {"sigma2_numks": 1250}, "uk_subsample": (0.2, 4)}
# batch line: (theta and golden rows of, make_pmm_fn options, gate against
# the golden rows, float32 output, the NFW kernel it must launch once)
BATCH_LINES = {
    "b16": ("b16", {"fast": True}, 1e-5, False, "nfw_uk_fast"),
    "b16_plain": ("b16", {"fast": False}, 1e-10, False, None),
    "b16_exact": ("b16", {"fast": "exact"}, 1e-7, False, "nfw_uk_exact"),
    "bN": ("bN", {"fast": True, **SERVING}, 1e-5, True, "nfw_uk_fast"),
    "bNf": ("bN", {"fused_serving": True, **SERVING}, 1e-5, True,
            "nfw_contract"),
}
PATHS = {"plain": {"fast": False}, "exact": {"fast": "exact"},
         "fast": {"fast": True}, "fused": {"fused_serving": True}}
E_PATHS = {"electron_plain": {"fast": False}, "electron_fast": {"fast": True}}
# wrapper, module, source, the TPU kernel it replaces, the paths that must
# launch it
KERNEL_ROWS = (
    ("nfw_uk_fast", "nfw_kernels", "hmvec_tpu/ops/pallas_kernels.py:321",
     ("fast", "electron_fast", "b16", "bN", "hod_fast", "limber_fast")),
    ("nfw_uk_exact", "nfw_kernels", "hmvec_tpu/ops/pallas_kernels.py:800",
     ("exact", "ode_exact", "b16_exact")),
    ("nfw_contract", "nfw_kernels", "hmvec_tpu/ops/pallas_kernels.py:388",
     ("fused", "ode_fused", "bNf")),
    ("pair_lerp_f64", "resample_kernels",
     "hmvec_tpu/ops/pallas_resample.py:110",
     ("electron_plain", "electron_plain_b2", "ksz", "ksz_survey",
      "ksz_b16")),
    ("pair_lerp_f32", "resample_kernels",
     "hmvec_tpu/ops/pallas_resample.py:110",
     ("electron_fast", "electron_fast_b2")),
)
SOURCE = {"nfw_kernels": "hmvec_tpu_torch/csrc/nfw_kernels.cu",
          "resample_kernels": "hmvec_tpu_torch/csrc/resample_kernels.cu"}

# the card's data-sheet peaks (H100 SXM, dense, outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"f64": 34e12, "f32": 67e12}
# operations counted for one call of the math library's log: an estimate
# of its range reduction and polynomial, since its source is not ours
LIB_OPS = {"log": {"f64": 30, "f32": 15}}
# the NFW kernels' per-row constants (nfw_u.cuh row_constants): 1 + c
# twice, c / (1 + c), the difference, 1 / F, (1 + c) scale, and a log
ROW_OPS_F64 = 6 + LIB_OPS["log"]["f64"]
# one sin/cos pair of nfw_u.cuh sincos_phase.  Exact tier, all float64:
# the quadrant (an FMA and a subtraction), two FMAs of the two-part pi/2,
# r^2, five FMAs for each polynomial, r^3 and the FMA of sin, two FMAs of
# cos.  Fast tier: the FMA, the subtraction and one FMA in float64, then
# r^2, two FMAs for each polynomial and three operations and two FMAs to
# finish, in float32.
SINCOS_OPS = {"f64": {"f64": 3 + 4 + 1 + 20 + 3 + 4},
              "f32": {"f64": 5, "f32": 16}}
# the reciprocal: the hardware's seed, and in float64 two Newton steps of
# two FMAs each
RCP_OPS = {"f64": 1 + 8, "f32": 1}


# SASS opcodes by the class of unit or work they take (the rest: integer,
# move and predicate logic, special registers, shuffles)
SASS_CLASSES = {
    "fp32": ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK",
             "FSWZADD"),
    "fp64": ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX"),
    "mufu": ("MUFU",),
    "convert": ("F2F", "F2I", "I2F", "F2FP", "I2FP", "FRND"),
    "memory": ("LDG", "STG", "LDS", "STS", "LDC", "ULDC", "LDL", "STL", "LD",
               "ST", "ATOM", "ATOMS", "RED"),
    "control": ("BRA", "BSSY", "BSYNC", "EXIT", "RET", "CALL", "BAR",
                "WARPSYNC", "BPT", "JMP"),
}
_SASS_CLASS = {op: cls for cls, ops in SASS_CLASSES.items() for op in ops}


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def kernel_name(symbol: str) -> str:
    """The readable name of one of the port's kernels in a mangled symbol
    (nfw_uk_kernel<float>, nfw_contract_kernel, ...); other symbols as
    they are."""
    m = re.search(r"(nfw_uk_kernel|nfw_contract_kernel|pair_lerp_kernel)"
                  r"(?:I([fd])E)?", symbol)
    if not m:
        return symbol
    return m.group(1) + {"f": "<float>", "d": "<double>", None: ""}[m.group(2)]


def sass_counts(text: str) -> dict:
    """Static SASS instruction counts per kernel from ``cuobjdump -sass``:
    {kernel: {"body": Counter by class, "cold": Counter}}.  "cold" is the
    out-of-line subroutines that the kernel reaches by CALL, such as a
    math library's slow path, which the main path takes only on rare
    inputs: everything from the first CALL target on.  NOPs and the trap
    loop at the end (a BRA to its own address) are not counted."""
    funcs = {}
    insns = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            insns = funcs.setdefault(kernel_name(m.group(1)), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)\S*\s*([^;]*);", line)
        if m and insns is not None and m.group(2) != "NOP":
            insns.append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    out = {}
    for name, insns in funcs.items():
        calls = [int(t, 16) for _, op, t in insns
                 if op == "CALL" and t.startswith("0x")]
        cold_from = min(calls, default=math.inf)
        counts = {"body": collections.Counter(),
                  "cold": collections.Counter()}
        for addr, op, target in insns:
            if op == "BRA" and target.startswith("0x") \
                    and int(target, 16) == addr:
                continue
            region = "cold" if addr >= cold_from else "body"
            counts[region][_SASS_CLASS.get(op, "int")] += 1
        out[name] = counts
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, n=25, warmup=3) -> float:
    """Median device time of one call of fn, by CUDA events per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_ms(fn, calls=5, replays=5, warmup=3) -> float:
    """Device time of one call of fn without the host's launch gaps: the
    calls are captured in a CUDA graph, which is replayed back to back
    between two CUDA events; the mean over calls x replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop) / (calls * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


def host_ms(fn, n=10, warmup=2) -> float:
    """Median host time of one call of fn that ends in a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(nbytes: int, ops: dict) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations of each type over that type's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(n / PEAK_OPS[t] for t, n in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _sici_ops(x, prec):
    """Floating-point operations of one Si/Ci argument x in csrc/nfw_u.cuh
    (an FMA counts 2, compares and selects 0): its reciprocal, then the
    body of its domain alone -- the Chebyshev variable, the two series by
    Horner (one FMA per term after the first, with the domain's number of
    terms from kernels/_build.py), and f = A v, g = B v^2 in domains 1-2;
    above x = 40 only the asymptotic tail, no series."""
    from hmvec_tpu_torch.kernels._build import NASY, NCOEF

    series = [2 * 2 * (n - 1) for n in NCOEF[prec.upper()]]
    # the Chebyshev variable: x/4, its square and an FMA below 4 (in
    # float64 x^2 and an FMA); an FMA and a product above
    n = torch.where(x <= 4.0, (4 if prec == "f32" else 3) + series[0],
                    3 + 3 + torch.where(x <= 10.0, series[1], series[2]))
    tail = 1 + 2 * 2 * (NASY[prec.upper()] - 1) + 2
    return RCP_OPS[prec] + torch.where(x > 40.0, tail, n)


def nfw_ops(ks, scales, cs, tier) -> dict:
    """Operations of hmvec::nfw_u over the (row, k) grid, counted from
    csrc/nfw_u.cuh on this run's inputs, by type: the phases x = k s1 and
    x2 = k s2 in float64; their sin/cos (SINCOS_OPS); two Si/Ci; the
    assembly (a log in the branch with x <= 4 < x2); and the row
    constants, once per row, in float64."""
    x = ks[None, :] * scales.reshape(-1)[:, None]
    x2 = x * (1.0 + cs.reshape(-1))[:, None]
    prec = "f32" if tier == "fast" else "f64"
    in01, in02 = x <= 4.0, x2 <= 4.0
    assembly = 3 + torch.where(
        in02, 5, torch.where(in01, 12 + LIB_OPS["log"][prec], 14)) + 6
    body = _sici_ops(x, prec) + _sici_ops(x2, prec) + assembly
    n_el = x.numel()
    body = int(body.sum().item())
    ops = {"f64": 2 * n_el + ROW_OPS_F64 * scales.numel()}
    ops[prec] = ops.get(prec, 0) + body
    for t, n in SINCOS_OPS[prec].items():
        ops[t] += 2 * n * n_el
    return ops


def pair_lerp_work(u, scales, ks, dkt) -> tuple[int, dict]:
    """(bytes, operations) of one pair_lerp call on this run's data: each
    table entry that some target reads (u[b, i0], u[b, i0+1] in the lerp
    window, u[b, 1] below it) once, scales, ks and the float64 output;
    2 float64 operations per target for p, 5 more in the lerp window."""
    nkt = u.shape[-1]
    rows = scales.numel()
    p = ks[None, :] * scales.reshape(-1)[:, None] / dkt
    win = (p >= 1.0) & (p <= nkt - 1.0)
    i0 = torch.floor(p).clamp(1, nkt - 2).long()
    dummy = torch.full_like(i0, nkt)      # a column no target reads
    touched = torch.zeros((rows, nkt + 1), dtype=torch.bool, device=u.device)
    touched.scatter_(1, torch.where(win, i0, torch.where(p < 1.0, 1, dummy)),
                     True)
    touched.scatter_(1, torch.where(win, i0 + 1, dummy), True)
    n_read = int(touched[:, :nkt].sum().item())
    nbytes = (n_read * u.element_size() + 8 * rows + 8 * ks.numel()
              + 8 * rows * ks.numel())
    return nbytes, {"f64": 2 * p.numel() + 5 * int(win.sum().item())}


def adversarial_rows(dev):
    """(name, ks, scales, cs) sweeps of tests/test_pallas_fast.py at sizes
    that are not multiples of the block: c in [1.2, 30], r_s (1+z) up to
    12, phases k (1+c) r_s up to ~3.7e4, and one case a thousand times
    beyond, where an ulp of the phase is 7e-9 rad."""
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    yield ("adversarial", t(np.geomspace(1e-4, 100.0, 777)),
           t(np.exp(rng.uniform(np.log(0.003), np.log(12.0), 1237))),
           t(rng.uniform(1.2, 30.0, 1237)))
    yield ("phase3.7e4", t(np.geomspace(10.0, 100.0, 64)),
           t([8.0, 12.0]), t([25.0, 30.0]))
    yield ("phase3.7e7", t(np.geomspace(1e3, 1e5, 96)),
           t([8.0, 12.0]), t([25.0, 30.0]))
    yield ("edges", t(np.geomspace(1e-3, 50, 77)),
           t(np.array([0.1, 0.3, 0.6]) * 1.5), t([3.0, 7.0, 11.0]))
    yield ("domain_edges", *map(t, domain_edges()))


def domain_edges():
    """(ks, scales, cs) that put x = k s and x2 = (1+c) x on the Si/Ci
    domain edges 4, 10 and 40 inside single warps: c = 3 and scales 1 and
    1/4, so that x and x2 are k, 4k and k/4, k exactly; each edge K of x
    or x2 gets a run of 32 ks (one warp of the kernels) holding K, K
    +- 1 ulp in float64 and in float32, K (1 +- 1e-3) and 25 more ks
    within 2% of K."""
    ks = []
    for K in (1.0, 2.5, 4.0, 10.0, 16.0, 40.0, 160.0):
        f = np.float32(K)
        edge = [K, np.nextafter(K, 0.0), np.nextafter(K, np.inf),
                float(np.nextafter(f, np.float32(0.0))),
                float(np.nextafter(f, np.float32(np.inf))),
                K * (1.0 - 1e-3), K * (1.0 + 1e-3)]
        fill = K * (1.0 + np.concatenate([np.linspace(-2e-2, -2e-3, 12),
                                          np.linspace(2e-3, 2e-2, 13)]))
        ks.append(np.sort(np.concatenate([edge, fill])))
    return np.concatenate(ks), np.array([1.0, 0.25]), np.array([3.0, 3.0])


def adversarial_lerp(dev):
    """(u, scales, ks, dkt) for the resample kernel: a (3, 7) batch of
    1,031-sample rows (unaligned) to 333 targets from far below kt_1 to
    far above Nyquist, and scales that are powers of two with targets on a
    grid of quarters, so that many positions p = k s / dkt land exactly on
    integers."""
    rng = np.random.default_rng(1)
    dkt = 0.25
    scales = 2.0 ** rng.integers(-3, 3, (3, 7)).astype(np.float64)
    ks = np.concatenate([np.geomspace(1e-4, 5e3, 233),
                         np.arange(100) * 0.25 * 7.0])
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    return (t(rng.standard_normal((3, 7, 1031))), t(scales),
            t(np.sort(ks)), dkt)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import hmvec_tpu_torch
    from hmvec_tpu_torch import pipeline as pl
    from hmvec_tpu_torch.kernels import _build
    from hmvec_tpu_torch.models import background as bgmod
    from hmvec_tpu_torch.ops import nfw_kernels as nk
    from hmvec_tpu_torch.ops import resample_kernels as rk
    from hmvec_tpu_torch.params import merge_params, to_torch_params

    check(pathlib.Path(hmvec_tpu_torch.__file__).resolve().parent
          == ROOT / "hmvec_tpu_torch",
          "hmvec_tpu_torch is imported from this checkout")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # the float64 path has no float32 matmul, but state the setting
    torch.backends.cuda.matmul.allow_tf32 = False
    modules = {"nfw_kernels": nk, "resample_kernels": rk}
    wrappers = {name: getattr(modules[mod], name)
                for name, mod, _, _ in KERNEL_ROWS}

    # ---- phase 1: environment and build --------------------------------
    card = card_line()
    print(card)
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()}), python "
          f"{sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.load_library()
    info = _build.build_info
    print(f"[env] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {info['seconds']:.2f} s, cached={info['cached']}) "
          f"-> {pathlib.Path(info['path']).relative_to(ROOT)}")
    for line in info.get("log", "").splitlines():
        if any(w in line for w in ("Function properties", "Used", "spill")):
            name = re.sub(r"_Z\w+", lambda m: kernel_name(m.group(0)),
                          line.strip())
            print(f"[env] ptxas: {name}")
    sass = subprocess.run(
        [str(pathlib.Path(_build.find_nvcc()).with_name("cuobjdump")), "-sass",
         info["path"]], capture_output=True, text=True, check=True,
        timeout=120).stdout
    for name, regions in sorted(sass_counts(sass).items()):
        body, cold = regions["body"], regions["cold"]
        print(f"[env] sass {name}: {sum(body.values())} instructions in the "
              f"body {dict(sorted(body.items()))}, {sum(cold.values())} in "
              f"cold subroutines {dict(sorted(cold.items()))} (static counts, "
              f"cuobjdump -sass)")

    # ---- phase 2: each kernel against its plain version on the card ----
    g = np.load(GOLDEN)
    ge = np.load(GOLDEN_E)
    zs, ks_np, ms = g["zs"], g["ks"], g["ms"]
    for key in ("zs", "ks", "ms", "param_values"):
        check(np.array_equal(g[key], ge[key]), f"golden files share {key}")
    names = g["param_names"].tolist()
    cosmos = [dict(zip(names, map(float, row))) for row in g["param_values"]]
    nxs, xmax = int(ge["nxs"]), float(ge["xmax"])
    ks, scales, cs, a_zm, b_zm = pl.nfw_stage_inputs(zs, ks_np, ms,
                                                     cosmos[0], device=dev)
    rows_s = scales.reshape(-1).contiguous()
    rows_c = cs.reshape(-1).contiguous()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = _build.load_library()
    for which, name, nrows in ((0, "nfw_uk_kernel<float>", rows_s.numel()),
                               (1, "nfw_uk_kernel<double>", rows_s.numel()),
                               (2, "nfw_contract_kernel", zs.size)):
        kinfo = (ctypes.c_int * 6)()
        check(lib.hmvec_nfw_kernel_info(which, dev.index, nrows, ks.numel(),
                                        kinfo) == 0, f"{name} attributes")
        regs, local, smem, threads, per_sm, blocks = kinfo
        waves = blocks / (per_sm * n_sm) if per_sm > 0 else math.nan
        print(f"[env] occupancy {name}: {regs} registers, {local} local bytes "
              f"per thread, {smem} static shared bytes, {threads} threads "
              f"per block, {per_sm} resident blocks per SM x {n_sm} SMs; "
              f"config-1 launch {blocks} blocks = {waves!r} waves")
    err = {}
    cases = [("config1", ks, rows_s, rows_c), *adversarial_rows(dev)]
    for case, k_, s_, c_ in cases:
        ref = nk.nfw_uk_plain(k_, s_, c_)
        for name, tier in (("nfw_uk_fast", "fast"), ("nfw_uk_exact", "exact")):
            u = wrappers[name](k_, s_, c_)
            torch.cuda.synchronize()
            check(u.is_cuda and u.shape == ref.shape, f"{name} output")
            e = (u.double() - ref).abs().max().item()
            check(e <= GATE_UK[tier], f"{name} on {case}: {e!r} > "
                  f"{GATE_UK[tier]}")
            if tier == "exact":
                check(e <= EXPECT_UK_EXACT, f"{name} on {case}: {e!r} > "
                      f"{EXPECT_UK_EXACT}")
            if case == "config1":
                err[name] = e
            print(f"[kernel] {name} vs nfw_uk_plain on {case} "
                  f"{tuple(ref.shape)}: max abs err {e!r} "
                  f"(gate {GATE_UK[tier]})")
    s1, s2 = nk.nfw_contract(ks, scales, cs, a_zm, b_zm)
    torch.cuda.synchronize()
    p1, p2 = nk.nfw_contract_plain(ks, scales, cs, a_zm, b_zm)
    rel = max(((s1 - p1).abs() / p1.abs()).max().item(),
              ((s2 - p2).abs() / p2.abs()).max().item())
    err["nfw_contract"] = max((s1 - p1).abs().max().item(),
                              (s2 - p2).abs().max().item())
    check(rel <= GATE_CONTRACT_REL, f"nfw_contract rel err {rel!r}")
    print(f"[kernel] nfw_contract vs nfw_contract_plain on config1 "
          f"{tuple(scales.shape)} x {ks.numel()} k: max rel err {rel!r} "
          f"(gate {GATE_CONTRACT_REL}), max abs err {err['nfw_contract']!r}")
    again = nk.nfw_contract(ks, scales, cs, a_zm, b_zm)
    torch.cuda.synchronize()
    check(torch.equal(again[0], s1) and torch.equal(again[1], s2),
          "nfw_contract gives the same bits on a second call")
    print("[kernel] nfw_contract: a second call on config1 gives the same "
          "bits")

    # the resample kernel on the config-2 u(kt) table of each tier at the
    # bench cosmology, and on the adversarial batch
    tables = {name: pl.electron_stage_inputs(
                  zs, ks_np, ms, cosmos[0], device=dev, nxs=nxs, xmax=xmax,
                  fast=name == "pair_lerp_f32")
              for name in ("pair_lerp_f64", "pair_lerp_f32")}
    u_adv, s_adv, k_adv, dkt_adv = adversarial_lerp(dev)
    p_adv = k_adv * s_adv[..., None] / dkt_adv
    on_int = (p_adv == torch.round(p_adv)) & (p_adv >= 1) & (p_adv <= 1030)
    check(bool((p_adv < 1).any()) and bool((p_adv > 1030).any())
          and bool(on_int.any()),
          "the adversarial resample case reaches both boundaries and "
          "integer positions inside the lerp window")
    for name, (u, s_, k_, dkt) in tables.items():
        dtype = u.dtype
        for case, args in (("config2", (u, s_, k_, dkt)),
                           ("adversarial", (u_adv.to(dtype), s_adv, k_adv,
                                            dkt_adv))):
            got = wrappers[name](*args)
            torch.cuda.synchronize()
            ref = rk.pair_lerp_plain(*args)
            check(got.is_cuda and got.shape == ref.shape
                  and got.dtype == torch.float64, f"{name} output")
            e = (got - ref).abs().max().item()
            check(e <= GATE_LERP, f"{name} on {case}: {e!r} > {GATE_LERP}")
            if case == "config2":
                err[name] = e
            print(f"[kernel] {name} vs pair_lerp_plain on {case} "
                  f"{tuple(args[0].shape)} -> {args[2].numel()} k: "
                  f"max abs err {e!r} (gate {GATE_LERP})")

    # ---- phase 3: both main paths at full width vs the golden files -----
    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts():
        return {name: w.launches for name, w in wrappers.items()}

    def drive(path, fn, want, gate, cosmos=cosmos, vary=("omch2", "As")):
        """Run one path for every cosmology with the launch counts set to
        0 just before and read just after; returns the counts."""
        reset_counts()
        for i, ov in enumerate(cosmos):
            out = fn(ov)
            torch.cuda.synchronize()
            outs = out if isinstance(out, tuple) else (out,)
            for key, o in zip(want, outs):
                check(o.is_cuda and o.shape == want[key][i].shape
                      and o.dtype == torch.float64, f"{path} {key} output")
                got = o.cpu().numpy()
                check(bool(np.all(np.isfinite(got))), f"{path} {key} finite")
                e = float(np.max(np.abs(got / want[key][i] - 1.0)))
                check(e <= gate, f"{path} {key} cosmology {i}: {e!r}")
                what = ", ".join(f"{k}={ov[k]}" for k in vary)
                print(f"[e2e] {path} {key} cosmology {i} ({what}): max rel "
                      f"err vs golden {e!r} (gate {gate})")
        counts = read_counts()
        print(f"[e2e] {path}: launches over {len(cosmos)} calls: {counts}")
        return counts

    fns = {p: pl.make_pmm_fn(zs, ks_np, ms, device=dev, **kw)
           for p, kw in PATHS.items()}
    efns = {p: pl.make_electron_fn(zs, ks_np, ms, device=dev, nxs=nxs,
                                   xmax=xmax, **kw)
            for p, kw in E_PATHS.items()}
    launches = {}
    for path, fn in fns.items():
        launches[path] = drive(path, fn, {"pmm": g["pmm"]}, GATE_PMM[path])
    for path, fn in efns.items():
        launches[path] = drive(path, fn, {"pee": ge["pee"], "pme": ge["pme"]},
                               GATE_E[path])

    # ---- phase 4: derivatives through the kernels and plain -------------
    jac = {}
    for path in ("plain", "exact"):
        t0 = time.perf_counter()
        jac[path] = pl.fisher_jacobian(fns[path], cosmos[0],
                                       ("omch2", "As"), device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(bool(torch.isfinite(jac[path]).all()), f"{path} jacobian")
        print(f"[grad] fisher_jacobian {path}: shape "
              f"{tuple(jac[path].shape)} in {dt:.2f} s")
    jrel = ((jac["exact"] - jac["plain"]).abs()
            / jac["plain"].abs()).max().item()
    check(jrel <= GATE_JAC_REL, f"jacobian exact vs plain {jrel!r}")
    print(f"[grad] exact vs plain: max rel diff {jrel!r} "
          f"(gate {GATE_JAC_REL})")
    jac_names = tuple(ge["jac_names"].tolist())
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ejac = pl.fisher_jacobian(efns["electron_plain"], cosmos[0], jac_names,
                              device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    for key, j in zip(("pee", "pme"), ejac):
        got = j.cpu().numpy()
        want = ge[f"jac_{key}"]
        check(got.shape == want.shape and bool(np.all(np.isfinite(got))),
              f"electron jacobian {key}")
        for col, pname in enumerate(jac_names):
            e = float(np.max(np.abs(got[..., col] / want[..., col] - 1.0)))
            check(e <= GATE_JAC_REL, f"d {key} / d {pname}: {e!r}")
            print(f"[grad] fisher_jacobian electron_plain d {key} / d "
                  f"{pname}: max rel err vs golden {e!r} "
                  f"(gate {GATE_JAC_REL})")
    print(f"[grad] fisher_jacobian electron_plain in {dt:.2f} s, peak "
          f"{peak:.1f} MiB allocated ({card})")

    # ---- phase 4b: config 1 on the integrated w0/wa growth ----------------
    gw = np.load(GOLDEN_W)
    for key in ("zs", "ks", "ms"):
        check(np.array_equal(g[key], gw[key]), f"golden files share {key}")
    cosmos_w = [dict(zip(gw["param_names"].tolist(), map(float, row)))
                for row in gw["param_values"]]
    check(cosmos_w[2] == cosmos[0], "the third w0/wa cosmology is the bench's")
    ode_fns = {p: pl.make_pmm_fn(zs, ks_np, ms, device=dev, growth="ode",
                                 **PATHS[p]) for p in ODE_PATHS}
    for p, fn in ode_fns.items():
        launches[f"ode_{p}"] = drive(f"growth_ode {p}", fn,
                                     {"pmm": gw["pmm"]}, GATE_PMM[p],
                                     cosmos=cosmos_w, vary=("w0", "wa"))
    e = ((ode_fns["plain"](cosmos[0]) / fns["plain"](cosmos[0]) - 1.0)
         .abs().max().item())
    check(e <= GATE_ODE_VS_CLOSED, f"growth ode vs closed at LCDM: {e!r}")
    print(f"[e2e] growth_ode plain at LCDM vs growth='closed': max rel diff "
          f"{e!r} (gate {GATE_ODE_VS_CLOSED})")
    # growth='auto' takes a differentiated w0/wa to the integrated growth
    jac_w_names = tuple(gw["jac_names"].tolist())
    t0 = time.perf_counter()
    jac_w = pl.fisher_jacobian(fns["exact"], cosmos[0], jac_w_names,
                               device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got, want = jac_w.cpu().numpy(), gw["jac_pmm"]
    check(got.shape == want.shape and bool(np.all(np.isfinite(got))),
          "growth_ode jacobian")
    for col, pname in enumerate(jac_w_names):
        e = float(np.max(np.abs(got[..., col] / want[..., col] - 1.0)))
        check(e <= GATE_JAC_REL, f"d pmm / d {pname}: {e!r}")
        print(f"[grad] fisher_jacobian exact d pmm / d {pname}: max rel err "
              f"vs golden {e!r} (gate {GATE_JAC_REL}), max abs "
              f"{float(np.abs(got[..., col]).max())!r}")
    print(f"[grad] fisher_jacobian exact over {jac_w_names} in {dt:.2f} s")
    # one growth table, and one call of each growth mode, traced: kernel
    # launches and device-to-host reads
    def traced(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        return (sum(1 for ev in events
                    if ev.device_type == torch.autograd.DeviceType.CUDA),
                sum(1 for ev in events
                    if ev.name == "aten::_local_scalar_dense"))

    bg_w = bgmod.background({**merge_params(),
                             **to_torch_params(cosmos_w[1], dev)}, dev)
    bgmod.growth_table(bg_w)
    n_table, sync_table = traced(lambda: bgmod.growth_table(bg_w))
    check(0 < n_table <= MAX_GROWTH_TABLE_LAUNCHES and sync_table == 0,
          f"growth_table: {n_table} launches, {sync_table} host reads")
    n_closed, sync_closed = traced(lambda: fns["exact"](cosmos_w[2]))
    n_ode, sync_ode = traced(lambda: fns["exact"](cosmos_w[1]))
    check(sync_ode <= sync_closed, f"an ode call reads the device "
          f"{sync_ode} times, a closed call {sync_closed}")
    print(f"[growth] one growth_table: {n_table} kernel launches (limit "
          f"{MAX_GROWTH_TABLE_LAUNCHES}), {sync_table} host reads; one "
          f"make_pmm_fn exact call: {n_ode} launches and {sync_ode} host "
          f"reads with growth 'ode' (w0, wa = {cosmos_w[1]['w0']}, "
          f"{cosmos_w[1]['wa']}), {n_closed} and {sync_closed} with "
          f"'closed' (torch.profiler)")
    t_closed = host_ms(lambda: fns["exact"](cosmos_w[2]))
    t_ode = host_ms(lambda: fns["exact"](cosmos_w[1]))
    t_ode2 = host_ms(lambda: fns["exact"](cosmos_w[1]))
    t_closed2 = host_ms(lambda: fns["exact"](cosmos_w[2]))
    print(f"[time] make_pmm_fn exact at 20x200x1001, growth 'closed' / "
          f"'ode' / 'ode' / 'closed': {t_closed!r} / {t_ode!r} / {t_ode2!r} "
          f"/ {t_closed2!r} ms per call (host clock to synchronize, median "
          f"of 10 each) ({card})")

    # ---- phase 4c: batch serving (make_batched_fn) ------------------------
    gb = np.load(GOLDEN_B)
    for key in ("zs", "ks", "ms"):
        check(np.array_equal(g[key], gb[key]), f"golden files share {key}")
    names_b = tuple(gb["param_names"].tolist())
    single_fns = {"b16": fns["fast"], "b16_plain": fns["plain"],
                  "b16_exact": fns["exact"]}

    def rel_rows(got, want):
        """Max relative difference of got (tensor) and want, over all."""
        return (got.double() / want - 1.0).abs().max().item()

    batch_stats = {}
    for line, (tkey, kw, gate, f32_out, kernel) in BATCH_LINES.items():
        theta_np = gb[f"theta_{tkey}"]
        nb = theta_np.shape[0]
        fn1 = single_fns.get(line) or pl.make_pmm_fn(zs, ks_np, ms,
                                                     device=dev, **kw)
        bfn = pl.make_batched_fn(
            fn1, names_b, out_dtype=torch.float32 if f32_out else None)
        bfn(theta_np[:2])                      # warm up at a small batch
        torch.cuda.synchronize()
        # the main path of this line: counts set to 0 just before, read
        # just after
        reset_counts()
        out = bfn(theta_np)
        torch.cuda.synchronize()
        launches[line] = read_counts()
        check(out.is_cuda and out.shape == (nb, zs.size, ks_np.size)
              and out.dtype == (torch.float32 if f32_out else torch.float64)
              and bool(torch.isfinite(out).all()), f"{line} output")
        want_kernels = {name: int(name == kernel) for name in wrappers}
        check(launches[line] == want_kernels,
              f"{line}: one launch of {kernel} for the whole batch, got "
              f"{launches[line]}")
        rows_g = gb[f"rows_{tkey}"]
        want = torch.as_tensor(gb[f"pmm_{tkey}"], device=dev)
        e_gold = rel_rows(out[torch.as_tensor(rows_g, device=dev)], want)
        check(e_gold <= gate, f"{line} rows {rows_g.tolist()} vs golden: "
              f"{e_gold!r} > {gate}")
        # every row against the port's own single call at that cosmology
        # (in float64: a float32 line is the cast of the same batch)
        out64 = pl.make_batched_fn(fn1, names_b)(theta_np) if f32_out else out
        if f32_out:
            check(torch.equal(out64.to(torch.float32), out),
                  f"{line}: the float32 output is the float64 batch, cast")
        e_single = max(rel_rows(out64[i], fn1(dict(zip(names_b, row))))
                       for i, row in enumerate(theta_np.tolist()))
        check(e_single <= GATE_BATCH_VS_SINGLE,
              f"{line} vs single calls: {e_single!r}")
        if line == "bNf":
            again = bfn(theta_np)
            check(torch.equal(again, out), "bNf repeats bit for bit")
            del again
        del out64, want
        ov0 = dict(zip(names_b, theta_np[0].tolist()))
        n_single, sync_single = traced(lambda: fn1(ov0))
        n_batch, sync_batch = traced(lambda: bfn(theta_np))
        check(n_batch < 2 * n_single and sync_batch <= sync_single,
              f"{line}: a batched call is {n_batch} launches and "
              f"{sync_batch} host reads, a single call {n_single} and "
              f"{sync_single}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t_batch = host_ms(lambda: bfn(theta_np), n=5, warmup=1)
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        t_single = host_ms(lambda: fn1(ov0), n=5, warmup=1)
        batch_stats[line] = {"B": nb, "ms": t_batch, "ms_per_cosmology":
                             t_batch / nb, "single_ms": t_single,
                             "launches": n_batch, "single_launches": n_single,
                             "peak_mib": peak}
        print(f"[batch] {line} (B = {nb}, {kw}, out "
              f"{str(out.dtype).split('.')[-1]}): rows {rows_g.tolist()} vs "
              f"golden max rel err {e_gold!r} (gate {gate}); every row vs "
              f"its single call {e_single!r} (gate {GATE_BATCH_VS_SINGLE}); "
              f"kernel launches of the batched call {launches[line]}; "
              f"{n_batch} launches and {sync_batch} host reads per batched "
              f"call, {n_single} and {sync_single} per single call "
              f"(torch.profiler); {t_batch!r} ms per batch = "
              f"{t_batch / nb!r} ms per cosmology, a single call "
              f"{t_single!r} ms (host clock to synchronize, median of 5); "
              f"peak {peak:.1f} MiB allocated ({card})")
        del out
    # a small electron batch, through the resample kernel's vmap rule
    theta_e = gb["theta_b16"][[0, 15]]
    for path, fn in efns.items():
        bfn = pl.make_batched_fn(fn, names_b)
        reset_counts()
        outs = bfn(theta_e)
        torch.cuda.synchronize()
        launches[f"{path}_b2"] = read_counts()
        lerp = "pair_lerp_f32" if path == "electron_fast" else "pair_lerp_f64"
        check(launches[f"{path}_b2"][lerp] == 1,
              f"{path} batched: one launch of {lerp}")
        e = max(rel_rows(o[i], s_)
                for i, row in enumerate(theta_e.tolist())
                for o, s_ in zip(outs, fn(dict(zip(names_b, row)))))
        check(e <= GATE_BATCH_VS_SINGLE, f"{path} batched vs single: {e!r}")
        print(f"[batch] {path} (B = 2): every row vs its single call {e!r} "
              f"(gate {GATE_BATCH_VS_SINGLE}); kernel launches of the "
              f"batched call {launches[f'{path}_b2']}")
        del outs
    torch.cuda.empty_cache()

    # ---- phase 4d: config 3 (HOD) and config 4 (Limber) -------------------
    gh, gl = np.load(GOLDEN_H), np.load(GOLDEN_L)
    for key in ("zs", "ks", "ms", "param_values"):
        check(np.array_equal(g[key], gh[key]) and np.array_equal(g[key], gl[key]),
              f"golden files share {key}")
    cfns = {}
    for tier, fast in (("plain", False), ("fast", True)):
        cfns[f"hod_{tier}"] = (
            pl.make_hod_fn(zs, ks_np, ms, gh["ngal"], device=dev, fast=fast),
            {"pgg": gh["pgg"], "pgm": gh["pgm"]})
        cfns[f"limber_{tier}"] = (
            pl.make_lensing_cls_fn(zs, ks_np, ms, gl["ells"],
                                   float(gl["zsource"]), device=dev,
                                   fast=fast),
            {"ckk": gl["ckk"], "pmm": gl["pmm"]})
    for path, (fn, want) in cfns.items():
        launches[path] = drive(path, fn, want,
                               GATE_TIER[path.split("_")[1]])
    for path, (fn, _) in cfns.items():
        n_l, n_sync = traced(lambda: fn(cosmos[0]))
        torch.cuda.reset_peak_memory_stats(dev)
        t_ms = host_ms(lambda: fn(cosmos[0]))
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        print(f"[time] {path} at 20x200x1001: {t_ms!r} ms per call (host "
              f"clock to synchronize, median of 10), {n_l} launches and "
              f"{n_sync} host reads per call (torch.profiler), peak "
              f"{peak:.1f} MiB allocated ({card})")
    # ---- phase 4e: config 1 with every further mass function -------------
    gm = np.load(GOLDEN_M)
    for key in ("zs", "ks", "ms"):
        check(np.array_equal(g[key], gm[key]), f"golden files share {key}")
    check(dict(zip(gm["param_names"].tolist(),
                   map(float, gm["param_values"]))) == cosmos[0],
          "the mass-function golden file is at the bench cosmology")
    for i, mode in enumerate(gm["modes"].tolist()):
        for tier, (fast, gate) in MASSFN_TIERS.items():
            fn = pl.make_pmm_fn(zs, ks_np, ms, device=dev, fast=fast,
                                mass_function=mode)
            launches[f"massfn_{mode}_{tier}"] = drive(
                f"massfn {mode} {tier}", fn, {"pmm": gm["pmm"][i:i + 1]},
                gate, cosmos=cosmos[:1])

    # ---- phase 4f: config 5, the kSZ forecast -----------------------------
    gk = np.load(GOLDEN_K)
    cosmos_k = [dict(zip(gk["param_names"].tolist(), map(float, row)))
                for row in gk["param_values"]]
    kcfg = {k: int(gk[k]) for k in ("num_kL_bins", "num_kS_bins",
                                     "num_mu_bins")}
    cls_t = torch.as_tensor(gk["cls"], device=dev)
    kfn = pl.make_ksz_snr_fn(float(gk["z"]), float(gk["volume_gpc3"]),
                             float(gk["ngal_mpc3"]), device=dev, ms=gk["ms"],
                             nxs=int(gk["nxs"]), xmax=float(gk["xmax"]),
                             growth="closed", **kcfg)
    one_k = pl.bind_args(kfn, cls_t)
    sfn = pl.make_ksz_survey_fn(gk["zcents"].size, device=dev, ms=gk["ms"],
                                nxs=int(gk["survey_nxs"]),
                                xmax=float(gk["xmax"]), growth="closed",
                                **kcfg)

    def survey(ov):
        return sfn(ov, gk["zcents"], gk["vols_gpc3"], gk["ngals"], cls_t)

    one_lerp = {name: int(name == "pair_lerp_f64") for name in wrappers}
    for path, fn, want in (
            ("ksz", one_k, {"snr": gk["snr"], "nvv": gk["nvv"],
                            "vrec": gk["vrec"]}),
            ("ksz_survey", survey, {"total": gk["total"],
                                    "per_bin": gk["per_bin"],
                                    "bgal": gk["bgal"]})):
        launches[path] = drive(path, fn, want, GATE_KSZ, cosmos=cosmos_k)
        check(launches[path] == {k: v * len(cosmos_k)
                                 for k, v in one_lerp.items()},
              f"{path}: one launch of pair_lerp_f64 per call, got "
              f"{launches[path]}")
    jac_names_k = tuple(gk["jac_names"].tolist())
    t0 = time.perf_counter()
    kjac = pl.fisher_jacobian(lambda ov: kfn(ov, cls_t)[0], cosmos_k[0],
                              jac_names_k, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = kjac.cpu().numpy()
    check(got.shape == gk["jac_snr"][0].shape
          and bool(np.all(np.isfinite(got))), "ksz jacobian")
    for col, pname in enumerate(jac_names_k):
        e = abs(float(got[col]) / float(gk["jac_snr"][0][col]) - 1.0)
        check(e <= GATE_JAC_REL, f"d snr / d {pname}: {e!r}")
        print(f"[grad] fisher_jacobian ksz d snr / d {pname}: {got[col]!r}, "
              f"rel err vs golden {e!r} (gate {GATE_JAC_REL})")
    print(f"[grad] fisher_jacobian ksz over {jac_names_k} in {dt:.2f} s")
    # a B = 16 batch over (omch2, As): every row against its single call
    theta_k = gb["theta_b16"][:KSZ_BATCH]
    bk = pl.make_batched_fn(one_k, names_b)
    bk(theta_k[:2])
    torch.cuda.synchronize()
    reset_counts()
    outs = bk(theta_k)
    torch.cuda.synchronize()
    launches["ksz_b16"] = read_counts()
    check(launches["ksz_b16"] == one_lerp,
          f"ksz_b16: one launch of pair_lerp_f64, got {launches['ksz_b16']}")
    e = max(rel_rows(o[i], s_)
            for i, row in enumerate(theta_k.tolist())
            for o, s_ in zip(outs, kfn(dict(zip(names_b, row)), cls_t)))
    check(all(bool(torch.isfinite(o).all()) for o in outs)
          and e <= GATE_BATCH_VS_SINGLE, f"ksz_b16 vs single calls: {e!r}")
    print(f"[batch] ksz_b16 (B = {KSZ_BATCH}): every row vs its single call "
          f"{e!r} (gate {GATE_BATCH_VS_SINGLE}); kernel launches of the "
          f"batched call {launches['ksz_b16']}")
    del outs
    ksz_stats = {}
    for path, fn, nb in (("ksz", lambda: one_k(cosmos_k[0]), 1),
                         ("ksz_survey", lambda: survey(cosmos_k[0]), 1),
                         ("ksz_b16", lambda: bk(theta_k), KSZ_BATCH)):
        n_l, n_sync = traced(fn)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t_ms = host_ms(fn, n=5 if nb > 1 else 10)
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        ksz_stats[path] = {"ms": t_ms, "ms_per_cosmology": t_ms / nb,
                           "launches": n_l, "host_reads": n_sync,
                           "peak_mib": peak}
        print(f"[time] {path}: {t_ms!r} ms per call (host clock to "
              f"synchronize, median of {5 if nb > 1 else 10}), "
              f"{t_ms / nb!r} ms per cosmology, {n_l} launches and {n_sync} "
              f"host reads per call (torch.profiler), peak {peak:.1f} MiB "
              f"allocated ({card})")

    for name, _, _, paths in KERNEL_ROWS:
        for path in paths:
            check(launches[path][name] > 0, f"{name} launched on {path}")

    # ---- phase 5: times on the card --------------------------------------
    # each timed call: its device time from CUDA-graph replays (device_ms)
    # and the per-call CUDA-event time, which also holds the host's launch
    # gaps (event_ms)
    calls = {
        "nfw_uk_fast": (lambda: nk.nfw_uk_fast(ks, rows_s, rows_c),
                        lambda: nk.nfw_uk_plain(ks, rows_s, rows_c)),
        "nfw_uk_exact": (lambda: nk.nfw_uk_exact(ks, rows_s, rows_c),
                         lambda: nk.nfw_uk_plain(ks, rows_s, rows_c)),
        "nfw_contract": (
            lambda: nk.nfw_contract(ks, scales, cs, a_zm, b_zm),
            lambda: nk.nfw_contract_plain(ks, scales, cs, a_zm, b_zm)),
    }
    gather_calls = {}
    for name, (u, s_, k_, dkt) in tables.items():
        calls[name] = (
            lambda u=u, s_=s_, k_=k_, dkt=dkt, w=wrappers[name]:
                w(u, s_, k_, dkt),
            lambda u=u, s_=s_, k_=k_, dkt=dkt:
                rk.pair_lerp_plain(u, s_, k_, dkt))
        # the yardstick for the loads alone: one torch.gather of the same
        # 2 nk indices per row (no PyTorch call computes the lerp with its
        # boundaries)
        i0 = torch.floor(k_ * s_.reshape(-1)[:, None] / dkt).clamp(
            1, u.shape[-1] - 2).long()
        idx = torch.cat([i0, i0 + 1], dim=1)
        u2 = u.reshape(-1, u.shape[-1])
        gather_calls[name] = lambda u2=u2, idx=idx: torch.gather(u2, 1, idx)
    # each NFW kernel's bare launch: its ctypes call into outputs allocated
    # once, without the wrapper's checks, autograd and allocation
    u32 = torch.empty((rows_s.numel(), ks.numel()), dtype=torch.float32,
                      device=dev)
    u64 = torch.empty((rows_s.numel(), ks.numel()), dtype=torch.float64,
                      device=dev)
    s12 = (torch.empty_like(s1), torch.empty_like(s2))
    bare_calls = {
        "nfw_uk_fast": lambda: nk._launch_nfw_uk(ks, rows_s, rows_c, "fast",
                                                 out=u32),
        "nfw_uk_exact": lambda: nk._launch_nfw_uk(ks, rows_s, rows_c,
                                                  "exact", out=u64),
        "nfw_contract": lambda: nk._launch_nfw_contract(
            ks, scales, cs, a_zm, b_zm, out=s12),
    }
    times, per_call, bare_ms = {}, {}, {}
    for name, (kern, plain) in calls.items():
        times[name] = (device_ms(kern), device_ms(plain))
        per_call[name] = (event_ms(kern), event_ms(plain))
        if name in bare_calls:
            bare_ms[name] = device_ms(bare_calls[name])
    gather_ms = {name: device_ms(fn) for name, fn in gather_calls.items()}
    work = {
        "nfw_uk_fast": (8 * (ks.numel() + 2 * rows_s.numel())
                        + 4 * rows_s.numel() * ks.numel(),
                        nfw_ops(ks, rows_s, rows_c, "fast")),
        "nfw_uk_exact": (8 * (ks.numel() + 2 * rows_s.numel())
                         + 8 * rows_s.numel() * ks.numel(),
                         nfw_ops(ks, rows_s, rows_c, "exact")),
    }
    # the float32 u of the fast tier, then per element u^2 and the two
    # float64 multiply-adds; per (z, k) the sum of a block's 8 warps, for
    # S1 and S2
    ops_c = nfw_ops(ks, rows_s, rows_c, "fast")
    ops_c["f64"] += (5 * rows_s.numel() * ks.numel()
                     + 2 * 8 * zs.size * ks.numel())
    work["nfw_contract"] = (8 * (ks.numel() + 4 * rows_s.numel())
                            + 16 * zs.size * ks.numel(), ops_c)
    for name, (u, s_, k_, dkt) in tables.items():
        work[name] = pair_lerp_work(u, s_, k_, dkt)
    bounds = {name: bound(*work[name]) for name in wrappers}
    library = {name: None for name in wrappers}
    for name, (t_k, t_p) in times.items():
        extra = (f", torch.gather of the 2 nk samples {gather_ms[name]!r} ms"
                 if name in gather_ms else "")
        if name in bare_ms:
            extra += f", bare launch {bare_ms[name]!r} ms"
        print(f"[time] {name}: {t_k!r} ms, plain version {t_p!r} ms{extra} "
              f"(device time, CUDA-graph replays of 25 calls); per call "
              f"with launch gaps {per_call[name][0]!r} ms, plain "
              f"{per_call[name][1]!r} ms (CUDA events, median of 25); bound "
              f"{bounds[name][0]!r} ms by {bounds[name][1]} "
              f"({work[name][0]} bytes, ops {work[name][1]}) ({card})")

    # the NFW kernels at the shapes the batch lines give them: the inputs
    # of every cosmology of the batch, folded as the wrappers' vmap rules
    # fold them (rows for nfw_uk, z for nfw_contract)
    def batch_inputs(theta_np):
        per = [pl.nfw_stage_inputs(zs, ks_np, ms, dict(zip(names_b, row)),
                                   device=dev)[1:]
               for row in theta_np.tolist()]
        return [torch.cat(x).contiguous() for x in zip(*per)]

    kq = pl._Grids(zs, ks_np, ms, merge_params(), SERVING["uk_subsample"],
                   dev).kq
    batch_rows = collections.defaultdict(list)
    for line, k_ in (("b16", ks), ("b16_exact", ks), ("bN", kq), ("bNf", kq)):
        kernel = BATCH_LINES[line][4]
        s_b, c_b, a_b, b_b = batch_inputs(gb[f"theta_{BATCH_LINES[line][0]}"])
        flat_s, flat_c = s_b.reshape(-1), c_b.reshape(-1)
        n_el = flat_s.numel() * k_.numel()
        # the plain version holds some 35 temporaries of the output's size:
        # it runs on slices of at most 64,000 rows (one b16), one after
        # the other, and its time is the sum over the slices
        n_cut = -(-flat_s.numel() // 64000)
        if kernel == "nfw_contract":
            kern = lambda: nk.nfw_contract(k_, s_b, c_b, a_b, b_b)
            plain = lambda: [torch.cat(x) for x in zip(*(
                nk.nfw_contract_plain(k_, *cut) for cut in zip(
                    *(t.chunk(n_cut) for t in (s_b, c_b, a_b, b_b)))))]
            got, ref = kern(), plain()
            e = max(((x - y).abs() / y.abs()).max().item()
                    for x, y in zip(got, ref))
            gate_b = GATE_CONTRACT_REL
            ops_b = nfw_ops(k_, flat_s, flat_c, "fast")
            ops_b["f64"] += 5 * n_el + 2 * 8 * s_b.shape[0] * k_.numel()
            nbytes = (8 * (k_.numel() + 4 * flat_s.numel())
                      + 16 * s_b.shape[0] * k_.numel())
        else:
            tier = "fast" if kernel == "nfw_uk_fast" else "exact"
            kern = lambda: wrappers[kernel](k_, flat_s, flat_c)
            plain = lambda: torch.cat([
                nk.nfw_uk_plain(k_, s_, c_) for s_, c_ in zip(
                    flat_s.chunk(n_cut), flat_c.chunk(n_cut))])
            e = (kern().double() - plain()).abs().max().item()
            gate_b = GATE_UK[tier]
            ops_b = nfw_ops(k_, flat_s, flat_c, tier)
            nbytes = (8 * (k_.numel() + 2 * flat_s.numel())
                      + (4 if tier == "fast" else 8) * n_el)
        torch.cuda.synchronize()
        check(e <= gate_b, f"{kernel} at {line}'s shape: {e!r} > {gate_b}")
        torch.cuda.empty_cache()
        t_k = device_ms(kern)
        t_p = event_ms(plain, n=2, warmup=1)
        b_ms, b_by = bound(nbytes, ops_b)
        shape = (f"{s_b.shape[0]} x {s_b.shape[1]} x {k_.numel()}"
                 if kernel == "nfw_contract"
                 else f"{flat_s.numel()} x {k_.numel()}")
        batch_rows[kernel].append(
            {"line": line, "shape": shape, "max_err": e, "ms": t_k,
             "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
             "launches": launches[line][kernel]})
        print(f"[time] {kernel} at {line}'s shape {shape}: {t_k!r} ms "
              f"(device time, CUDA-graph replays of 25 calls), plain version "
              f"{t_p!r} ms (CUDA events, median of 2, in {n_cut} slices of "
              f"rows), bound {b_ms!r} ms by "
              f"{b_by} ({nbytes} bytes, ops {ops_b}), time / bound "
              f"{t_k / b_ms!r}; max err vs the plain version {e!r} (gate "
              f"{gate_b}); {launches[line][kernel]} launch per batched call "
              f"({card})")
        del s_b, c_b, a_b, b_b, flat_s, flat_c
        torch.cuda.empty_cache()
    # the float64 resample kernel at the kSZ shapes: the single bin's
    # (500 rows x 2,049 kt -> 101 k) and the four-bin survey's (2,000 rows x
    # 1,025 kt; the kernel's vmap rule folds the bins into its rows)
    ksz_rows = []
    ks_ksz = np.geomspace(0.1, 10.0, kcfg["num_kS_bins"])
    for line, zs_l, nxs_l in (
            ("ksz", np.array([float(gk["z"])]), int(gk["nxs"])),
            ("ksz_survey", gk["zcents"], int(gk["survey_nxs"]))):
        u, s_, k_, dkt = pl.electron_stage_inputs(
            zs_l, ks_ksz, gk["ms"], cosmos_k[0], device=dev, nxs=nxs_l,
            xmax=float(gk["xmax"]))
        got = rk.pair_lerp_f64(u, s_, k_, dkt)
        torch.cuda.synchronize()
        e = (got - rk.pair_lerp_plain(u, s_, k_, dkt)).abs().max().item()
        check(e <= GATE_LERP, f"pair_lerp_f64 at {line}'s shape: {e!r}")
        t_k = device_ms(lambda: rk.pair_lerp_f64(u, s_, k_, dkt))
        t_p = device_ms(lambda: rk.pair_lerp_plain(u, s_, k_, dkt))
        i0 = torch.floor(k_ * s_.reshape(-1)[:, None] / dkt).clamp(
            1, u.shape[-1] - 2).long()
        idx = torch.cat([i0, i0 + 1], dim=1)
        u2 = u.reshape(-1, u.shape[-1])
        t_g = device_ms(lambda: torch.gather(u2, 1, idx))
        nbytes, ops = pair_lerp_work(u, s_, k_, dkt)
        b_ms, b_by = bound(nbytes, ops)
        shape = f"{s_.numel()} x {u.shape[-1]} kt -> {k_.numel()} k"
        ksz_rows.append({"line": line, "shape": shape, "max_err": e,
                         "ms": t_k, "plain_ms": t_p, "gather_ms": t_g,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "launches": launches[line]["pair_lerp_f64"]})
        print(f"[time] pair_lerp_f64 at {line}'s shape {shape}: {t_k!r} ms "
              f"(device time, CUDA-graph replays of 25 calls), plain version "
              f"{t_p!r} ms, torch.gather of the 2 nk samples {t_g!r} ms, "
              f"bound {b_ms!r} ms by {b_by} ({nbytes} bytes, ops {ops}), "
              f"time / bound {t_k / b_ms!r}; max err vs the plain version "
              f"{e!r} (gate {GATE_LERP}); "
              f"{launches[line]['pair_lerp_f64']} launches on the path "
              f"({card})")
    for path, fn in {**fns, **efns}.items():
        torch.cuda.reset_peak_memory_stats(dev)
        t_ms = host_ms(lambda: fn(cosmos[0]))
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        what = "make_pmm_fn" if path in fns else "make_electron_fn"
        print(f"[time] {what} {path} at 20x200x1001: {t_ms!r} ms per "
              f"call (host clock to synchronize, median of 10), peak "
              f"{peak:.1f} MiB allocated ({card})")

    kernels = []
    for name, mod, replaces, _ in KERNEL_ROWS:
        row = {"name": name, "route": "cuda", "source": SOURCE[mod],
               "replaces": replaces,
               "launches": sum(c[name] for c in launches.values()),
               "max_abs_err": err[name], "ms": times[name][0],
               "plain_ms": times[name][1], "bound_ms": bounds[name][0],
               "bound_by": bounds[name][1], "library_ms": library[name]}
        if name in gather_ms:
            row["gather_ms"] = gather_ms[name]
        if name in bare_ms:
            row["bare_ms"] = bare_ms[name]
        if name in batch_rows:
            row["batch"] = batch_rows[name]
        if name == "pair_lerp_f64":
            row["ksz"] = ksz_rows
        kernels.append(row)
    check(all(math.isfinite(k["ms"]) and math.isfinite(k["plain_ms"])
              and math.isfinite(k["bound_ms"]) for k in kernels), "timings")
    print("[batch] " + json.dumps(batch_stats))
    print("[ksz] " + json.dumps(ksz_stats))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
