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
The class phase drives the class API: the README's example
(hmvec_tpu_torch.HaloModel at 20 x 200 x 1001 with the Battaglia gas and
pressure profiles, an HOD and the fast NFW profile) against its golden
file, with one launch of the fast NFW kernel and one of the float64
resample kernel per numeric profile, and the class kSZ forecast
(get_ksz_snr at config 5) against make_ksz_snr_fn and its golden file;
with the build's and each spectrum's latency, launches, host reads and
peak memory, and both kernels' times at the class's shapes.  The
cov_bispectrum phase drives the covariance group on the class phase's
build, with no kernel launch in its calls: the connected and super-sample
C_ell covariances, the cluster counts through a Y-M relation and their
covariance, the joint counts x C_ell covariance (block by block), the
P(k) covariance, bispectra (plain and fast NFW, an HOD with the
second-order bias, the angular y bispectrum), the mean Compton y, the
aperture optical depth, the pairwise kSZ SNR and the angular correlation
of C_yy, against its golden file, with each entry point's latency,
launches, host reads and peak memory.  The rsd_nonlimber phase drives the
exact (non-Limber) C_ell, one-loop and redshift-space group on the same
build, with no kernel launch in its calls: C_gg (with RSD and
magnification), C_kg and C_kk exact on 2048 chis at ells 2-200, the
hybrid C_gg and C_kk on the build's P_gg and P_mm (analytic and fast NFW
profile), P_mm_1loop with and without the IR resummation, the Kaiser,
Scoccimarro and TNS multipoles of get_rsd_multipoles at 20 z x 100 k,
get_galaxy_rsd_multipoles on the build's 1001 k, and the multi-l FFTLog
transform in complex128, against its golden file, with each entry point's
latency, launches, host reads and peak memory.  The lensing phase drives the
weak- and CMB-lensing group on the same build, with no kernel launch in
its calls: the intrinsic-alignment and magnification spectra (also on the
fast NFW profile), xi_+/-, gamma_t and their Gaussian covariance, the
MASTER chain (coupling matrices for spins 00, 02, 22, couple, bin,
decouple, the NKA covariance), the resummed and first-order lensed CMB
spectra, the quadratic-estimator N0 family, N0 full sky, N1, iterative EB
delensing, threej000_sq and the tabulated CMB spectra, against its golden
file, with each entry point's latency, launches and host reads (CardOps,
a count of aten operations on the card) and peak memory; then the float64
resample kernel at the three 4,000-row tables beside an empty launch.
The extensions phase drives the
first extension group through the class API at config 1's width:
HaloModel(halofit="mead") (HMcode-2016), CIB tracers at 545 and 217 GHz
and an HI tracer on the fast NFW profile, the Battaglia pressure profile,
the nine halofit versions and 'mead' under w0/wa, the CMB lensing C_L to
L = 3000 on the nonlinear power, the BAO ratio, tau_*, z(tau), H0 from
theta100 and the cluster-lensing profiles, against its golden file, with
one launch of each kernel in the build.  The projfield phase drives the
projected-field kSZ^2 group on the class build at the settings of
examples/projected_field_ksz2.py (4,800 triangles a bispectrum call, also
in chunks of two ells; the fast NFW leg; the lensing term, the Gaussian
noise and the SNR), the checkpoint phase saves the build and restores it
into a fresh HaloModel (spectra bit for bit, timed through
utils.profiling), the flatsky phase the 16-sim lensing reconstruction of
examples/lensing_qe_sim.py at n = 1,024 as one batch on white noise drawn
by numpy from the golden file's seed (and a polarized draw through the
EE, TE and EB estimators; the batch against one sim alone), and the
emulator phase examples/emulator_pk.py (the training set by vmapped
make_pmm_fn chunks, a float64 fit from JAX's initial net, the float32 fit,
jacfwd against central differences, and the exact-tier training set's one
kernel launch a chunk), each against its golden file, with no kernel
launch in their calls and each entry point's latency, launches, host reads
and peak memory.  The boltz phase holds the Boltzmann group's two kernels
(recomb_rk4 at n = 16,384, hierarchy_rk4 on the reduced grid of the CPU
tests' golden file) against their plain versions, keeps the k = 0.5 row
of the default grid finite, and drives Cosmology().get_cmb_cls(approx=
True) at lmax 3,000, BoltzEngine() and the README example on
engine="boltz" against their golden files (one recomb_rk4 and four
hierarchy_rk4 launches a solve; B1 once and B4a twice a build).  The
sharded phase drives the multi-device layer (hmvec_tpu_torch.parallel.
sharding) on a mesh of four slots on cuda:0 and, where more cards are
visible, on a mesh of all of them, each entry point against its unsharded
counterpart: the mass-sharded Pmm, two Fisher steps through the psum,
data-parallel batches (bN, bNf, the exact tier, the fast electron tier),
the galaxy x electron spectra and the matter bispectrum against the class
API, the bin-sharded four-bin kSZ survey, the k-sharded Boltzmann solve
(bit for bit) and l-sharded projection on get_cmb_cls()'s grid, and the
data-parallel emulator fit; with each call's latency beside the unsharded
call's and every kernel at the shard shapes.

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
a second call (bit for bit) and at 70,000 redshifts, more than a grid's
y dimension holds; the serving path's Catmull-Rom fill (F1) bit for bit
at the bN line's u cube, the bNf line's sums and edge shapes, and timed
there.  With the NFW kernels' device times it
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
import contextlib
import ctypes
import functools
import importlib.util
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

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
GOLDEN_C = DATA / "class_config1_golden.npz"
GOLDEN_X = DATA / "extensions_config1_golden.npz"
GOLDEN_V = DATA / "cov_bispectrum_config1_golden.npz"
GOLDEN_RN = DATA / "rsd_nonlimber_config1_golden.npz"
GOLDEN_LC = DATA / "lensing_cmb_golden.npz"
GOLDEN_PF = DATA / "projfield_config1_golden.npz"
GOLDEN_FS = DATA / "flatsky_qe_golden.npz"
GOLDEN_EM = DATA / "emulator_pk_golden.npz"
GOLDEN_BS = DATA / "boltz_small_golden.npz"
GOLDEN_BC = DATA / "boltz_cmb_golden.npz"
GOLDEN_BE = DATA / "boltz_engine_golden.npz"
GOLDEN_BK = DATA / "boltz_class_golden.npz"
FIXTURE_CMB = ROOT / "tests" / "fixtures" / "camb_table_fixture.npz"

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
# the class API: the README's spectra (name -> get_power's arguments)
# against the JAX class's golden file, plain and through the fast NFW
# kernel; the class kSZ forecast against the port's own pipeline at the
# JAX package's class-vs-fused gate (tests/test_ksz_fused.py)
CLASS_SPECTRA = {"pmm": ("nfw", None), "pgg": ("g", None),
                 "pge": ("g", "e"), "pee": ("e", "e"), "pyy": ("y", "y")}
GATE_CLASS = 1e-10
GATE_CLASS_FAST = 1e-5
GATE_KSZ_CLASS_VS_FN = 1e-12
# the first extension group (tools/gen_torch_golden.py --config x): 1e-10
# on what holds no fast-NFW factor, 1e-5 where the fast profile enters (HI,
# CIB).  H0 from theta100: 1e-12 where the Gauss-Legendre weights are the
# golden file's (the CPU tests); here 5e-11, the spread of the JAX
# package's own solve between numpy's 128-node weights (8e-11 from the
# exact ones, and they differ between numpy versions) and exact weights,
# 3.8e-11, which a distance to z* carries to H0 amplified by 1 /
# (dln theta / dln H0) ~ 5.5
GATE_EXT = 1e-10
GATE_EXT_FAST = 1e-5
GATE_H0 = 5e-11
# the covariance group (tools/gen_torch_golden.py --config v) on the
# README example's build: 1e-10, and 1e-5 where the fast NFW profile's u
# (float32, within 5e-6 of the analytic u) enters
GATE_COV = 1e-10
GATE_COV_FAST = 1e-5
# the exact C_ell, one-loop and redshift-space group
# (tools/gen_torch_golden.py --config rsd_nonlimber) on the README
# example's build: 1e-10; 1e-5 where the fast NFW profile's u enters (the
# hybrid spectra on it, against the golden file's analytic-profile ones);
# the multi-l FFTLog transform 1e-12 of each row's scale (on k^{3/2} F,
# the irfft's own output); the TNS rows below k = 1/Mpc, whose A/B
# integrals carry the rounding of whichever order evaluates their
# catastrophically cancelling kernels (tools/tns_spread.py), GATE_RN_TNS_LOW
GATE_RN = 1e-10
GATE_RN_FAST = 1e-5
GATE_RN_FFT = 1e-12
GATE_RN_TNS_LOW = 1e-2
# the weak- and CMB-lensing group (tools/gen_torch_golden.py --config
# lensing) on the README example's build: 1e-10 element by element; 1e-5
# where the fast NFW profile's u enters (the shear spectra on it); 1e-10 of
# the row's largest value for the Wigner-d sums (xi_+/-, gamma_t, their
# covariance) and lensed_cf (its J2-J6 come from an upward recurrence,
# absolute error at the seeds' ~1e-13); 1e-9 for threej000_sq and
# n0_tt_fullsky (3j^2 through log-gamma sums of ~4e4, whose absolute
# rounding exp turns into relative error); n0_eb_iterative's iteration
# count equal to JAX's
GATE_LC = 1e-10
GATE_LC_FAST = 1e-5
GATE_LC_ROW = 1e-10
GATE_LC_3J = 1e-9
# the projected-field kSZ^2 group (tools/gen_torch_golden.py --config
# projfield) on the README example's build: 1e-10 element by element, 1e-5
# on the fast NFW profile's leg (against the golden file's analytic one)
GATE_PF = 1e-10
GATE_PF_FAST = 1e-5
# the map-level reconstruction (--config flatsky): 1e-10 of each array's
# largest value on the file's fixed sample of elements, the binned spectra
# whole element by element; a batch of sims against one sim alone 1e-12
GATE_FS = 1e-10
GATE_FS_BATCH = 1e-12
# the emulator (--config emulator): training-set rows 1e-10; a float64 fit
# from JAX's initial net, its losses and predictions 1e-9; the float32 fit
# against JAX's at the file's gate (ten times the spread of the two on the
# CPU); the Jacobian by jacfwd against central differences, 1e-6 of its
# largest element; the exact-tier training set 1e-7
# the multi-device layer against its unsharded counterparts on the card:
# the mass-sharded sums reassociate (the plain Pmm and the Fisher step at
# the JAX package's own sharded-vs-unsharded gates, tests/test_pipeline.py;
# the galaxy x electron spectra and the bispectrum at _sharded_suite.py's
# 1e-9); the batch, bin, k and l shards run the same per-row programs
# (1e-12, C_l 1e-12 of a spectrum's largest value; the solve bit for bit)
GATE_SHARD_PMM = 1e-10
GATE_SHARD_FISHER = 1e-8
GATE_SHARD_GE = 1e-9
GATE_SHARD_CLS = 1e-12
SHARD_NXS = 4096
GATE_EM_ROWS = 1e-10
GATE_EM_FIT64 = 1e-9
GATE_EM_JAC_FD = 1e-6
# nfw_contract beyond gridDim.y's 65,535: redshifts on gridDim.x (C13)
# the Boltzmann group: a kernel against its plain version on the same card
# tensors (both keep every multiply and add unfused: -fmad=false), relative
# to a row's largest value; the recombination table against the JAX
# golden file; the solve, the C_l, the engine's tables and the README
# build on the engine against the golden files: the tight-coupling era
# amplifies rounding ~1e7 (tests/test_torch_boltz_solve.py
# test_the_solve_amplifies_rounding), so two evaluation orders agree to
# ~1e-7 there (the CPU port against the JAX package: states 2.8e-7 of a
# state's largest component, C_l 2.2e-6 element by element at lmax 3,400)
GATE_BOLTZ_KERNEL = 1e-10
GATE_BOLTZ_REC = 1e-10
GATE_BOLTZ_SOLVE = 1e-6
GATE_BOLTZ_OUT = 1e-5
C13_NZ, C13_NM, C13_NK = 70_000, 200, 16
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
# launches of the Catmull-Rom fill (F1) per batched call of a line: the u
# cube (bN), the two mass sums (bNf); none where u(k) is not thinned
FILLS = {"bN": 1, "bNf": 2}
PATHS = {"plain": {"fast": False}, "exact": {"fast": "exact"},
         "fast": {"fast": True}, "fused": {"fused_serving": True}}
E_PATHS = {"electron_plain": {"fast": False}, "electron_fast": {"fast": True}}
# wrapper, module, source, the TPU kernel it replaces, the paths that must
# launch it
KERNEL_ROWS = (
    ("nfw_uk_fast", "nfw_kernels", "hmvec_tpu/ops/pallas_kernels.py:321",
     ("fast", "electron_fast", "b16", "bN", "hod_fast", "limber_fast",
      "class", "extensions", "sharded_bN", "sharded_electron_fast")),
    ("nfw_uk_exact", "nfw_kernels", "hmvec_tpu/ops/pallas_kernels.py:800",
     ("exact", "ode_exact", "b16_exact", "sharded_b16_exact")),
    ("nfw_contract", "nfw_kernels", "hmvec_tpu/ops/pallas_kernels.py:388",
     ("fused", "ode_fused", "bNf", "sharded_bNf")),
    ("pair_lerp_f64", "resample_kernels",
     "hmvec_tpu/ops/pallas_resample.py:110",
     ("electron_plain", "electron_plain_b2", "ksz", "ksz_survey",
      "ksz_b16", "class", "class_ksz", "extensions",
      "sharded_galaxy_electron", "sharded_survey")),
    ("pair_lerp_f32", "resample_kernels",
     "hmvec_tpu/ops/pallas_resample.py:110",
     ("electron_fast", "electron_fast_b2", "sharded_electron_fast")),
    ("recomb_rk4", "boltz_kernels",
     "no Pallas counterpart: the lax.scan of hmvec_tpu/models/recomb.py:190",
     ("boltz_cmb", "boltz_engine", "boltz_class", "sharded_solve")),
    ("hierarchy_rk4", "boltz_kernels",
     "no Pallas counterpart: the lax.scan / fori_loop of "
     "hmvec_tpu/models/boltzlite.py:540-553, vmapped at :624",
     ("boltz_cmb", "boltz_engine", "boltz_class", "sharded_solve")),
    ("catmull_fill", "resample_kernels",
     "no Pallas counterpart: the jnp gathers of hmvec_tpu/pipeline.py:147 "
     "and :249",
     ("bN", "bNf", "sharded_bN", "sharded_bNf")),
)
SOURCE = {"nfw_kernels": "hmvec_tpu_torch/csrc/nfw_kernels.cu",
          "resample_kernels": "hmvec_tpu_torch/csrc/resample_kernels.cu",
          "boltz_kernels": "hmvec_tpu_torch/csrc/boltz_kernels.cu"}

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
    (nfw_uk_kernel<float>, nfw_contract_kernel, pair_lerp_kernel<double,
    2, 2, true>, ...); other symbols as they are."""
    m = re.search(r"(nfw_uk_kernel|nfw_contract_kernel|pair_lerp_rows_kernel"
                  r"|pair_lerp_kernel|recomb_rk4_kernel|hierarchy_rk4_kernel"
                  r"|catmull_fill_kernel)"
                  r"(?:I([fd])((?:L[ib]\d+E)*)E)?", symbol)
    if not m:
        return symbol
    args = [{"f": "float", "d": "double"}[m.group(2)]] if m.group(2) else []
    for kind, val in re.findall(r"L([ib])(\d+)E", m.group(3) or ""):
        args.append(val if kind == "i" else ("false", "true")[int(val)])
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def ptxas_resources(log: str) -> dict:
    """Each kernel's registers, stack, spills and static shared memory as
    ``nvcc -Xptxas -v`` reports them in a build log: {kernel: {"registers",
    "stack_bytes", "spill_store_bytes", "spill_load_bytes",
    "smem_bytes"}}."""
    out, kern = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kern = kernel_name(m.group(1))
            out[kern] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and kern:
            out[kern].update(zip(("stack_bytes", "spill_store_bytes",
                                  "spill_load_bytes"), map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", line)
        if m and kern:
            smem = re.search(r"(\d+) bytes smem", line)
            out[kern].update(registers=int(m.group(1)),
                             smem_bytes=int(smem.group(1)) if smem else 0)
    return out


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


def fill_work(y, tap_i) -> tuple[int, dict]:
    """(bytes, operations) of one Catmull-Rom fill (F1) of y (..., nkq) by
    taps (4, nk): y read once, the int32 and float64 taps, the float64
    output written once; a multiply and an add per tap and output."""
    rows, nk = y.numel() // y.shape[-1], tap_i.shape[1]
    return (y.numel() * y.element_size() + 12 * tap_i.numel()
            + 8 * rows * nk, {"f64": 8 * rows * nk})


def close_err(got, want):
    """Max error of got against want along the last axis, row by row:
    relative, element by element, on a row that keeps one sign and holds
    no zero; relative to the row's largest |want| on a row that changes
    sign or holds exact zeros."""
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    one_sign = np.all(want > 0.0, -1) | np.all(want < 0.0, -1)
    row_max = np.max(np.abs(want), -1)
    scale = np.where(one_sign[..., None], np.abs(want),
                     np.where(row_max > 0.0, row_max, 1.0)[..., None])
    return float(np.max(np.abs(got - want) / scale))


def row_err(got, want):
    """Max error along the last axis relative to the row's largest
    |want|."""
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    scale = np.max(np.abs(want), -1, keepdims=True)
    return float(np.max(np.abs(got - want) / np.where(scale > 0, scale, 1)))


class CardOps(TorchDispatchMode):
    """Counts, far more cheaply than torch.profiler's traces, the aten
    operations that write a tensor on the card (one kernel launch each,
    give or take: a view writes nothing and launches nothing; a matmul may
    launch more than one kernel) and the host reads (a tensor's value
    copied from the card: .item(), float(), a copy to the CPU).  The port's
    own kernels are ctypes calls, not aten operations: their wrappers
    count them."""

    def __init__(self):
        super().__init__()
        self.launches = 0
        self.host_reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        if func is torch.ops.aten._local_scalar_dense.default:
            self.host_reads += 1
        elif func in (torch.ops.aten._to_copy.default,
                      torch.ops.aten.copy_.default) and any(
                t.is_cuda for t in ins) and any(
                not t.is_cuda for t in (out if isinstance(out, (list, tuple))
                                        else [out])
                if isinstance(t, torch.Tensor)):
            self.host_reads += 1
        elif not any(r.alias_info is not None and not r.alias_info.is_write
                     for r in func._schema.returns):
            outs = out if isinstance(out, (list, tuple)) else [out]
            if any(isinstance(t, torch.Tensor) and t.is_cuda
                   and t.numel() > 0 for t in outs):
                self.launches += 1
        return out


def card_ops(fn):
    """(launches, host reads) of one call of fn, by CardOps."""
    torch.cuda.synchronize()
    with CardOps() as ops:
        fn()
    torch.cuda.synchronize()
    return ops.launches, ops.host_reads


def joint_err(got, want, nb):
    """close_err on each block of a joint (counts, C_ell) covariance with
    nb count bins: the counts block, the counts x C_ell block (a row per
    count bin; its transpose, the other off-diagonal block, likewise) and
    the C_ell block, each on its own scale."""
    return max(close_err(got[:nb, :nb], want[:nb, :nb]),
               close_err(got[:nb, nb:], want[:nb, nb:]),
               close_err(got[nb:, :nb].T, want[nb:, :nb].T),
               close_err(got[nb:, nb:], want[nb:, nb:]))


@contextlib.contextmanager
def recorded(module, name):
    """Within the block, the inputs of every launch of one of the port's
    kernels, by wrapping its module's launch function (the wrapper's own
    count is untouched)."""
    real, calls = getattr(module, name), []

    def launch(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    setattr(module, name, launch)
    try:
        yield calls
    finally:
        setattr(module, name, real)


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


def lerp_edge_cases(dev):
    """(name, (u, scales, ks, dkt)) for the resample kernel at the shapes
    that break a tiled, vectorised or row-packed design: nk 1, 2, 3, 101,
    1,001 and 4,097 against 1, 3 and 4,001 rows, nkt odd and even down to
    3; targets on a grid of quarters with dkt = 1/4 and scales 1/2, 1, 2
    and nkt - 1, so that positions land exactly on 1 and nkt - 1; targets
    unsorted and repeated, below 1 and above Nyquist; a (2, 3) batch; and
    one nkt of 40,001 (float64 u; each case is also run on float32 u)."""
    rng = np.random.default_rng(21)
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    for n, (nk, rows) in enumerate(
            [(nk, rows) for nk in (1, 2, 3, 101, 1001, 4097)
             for rows in (1, 3, 4001)]):
        nkt = (3, 4, 1031, 2050)[n % 4]
        m = np.round(rng.uniform(-1.0, nkt + 2.0, nk) * 4.0) / 4.0
        special = [1.0, nkt - 1.0, 0.5, nkt + 0.25, 0.0][:nk]
        m[:len(special)] = special
        if nk > 5:
            m[5:8] = m[0]
        rng.shuffle(m)
        scales = 2.0 ** rng.integers(-1, 2, rows).astype(np.float64)
        scales[:3] = [1.0, nkt - 1.0, 0.5][:rows]
        yield (f"{rows}x{nkt}->{nk}",
               (t(rng.standard_normal((rows, nkt))), t(scales), t(m * 0.25),
                0.25))
    yield ("(2,3)x7->33", (t(rng.standard_normal((2, 3, 7))),
                           t(np.full((2, 3), 1.0)), t(np.arange(33) * 0.25),
                           0.25))
    yield ("3x40001->101", (t(rng.standard_normal((3, 40001))),
                            t([1.0, 3.0, 7.0]),
                            t(np.sort(rng.uniform(0.0, 40001.0, 101)) * 0.25),
                            0.25))


def lerp_wide_case(dev, dtype):
    """(u, scales, ks, dkt) on the card whose offsets into u pass 2^31
    elements, so that the resample kernel takes its 64-bit instantiation
    (as a batch of ~210 cosmologies at 2,049 kt does): (rows + 1) x nkt
    just above 2^31 at nkt = 2,049, nk = 5 (odd: pairs straddle rows),
    targets on quarters with dkt = 1/4 and scales 1/2, 1 and 2 (positions
    on 1 and nkt - 1, below 1 and above Nyquist)."""
    nkt = 2049
    rows = 2**31 // nkt + 64
    g = torch.Generator(device=dev).manual_seed(23)
    u = torch.randn((rows, nkt), generator=g, dtype=dtype, device=dev)
    scales = 2.0 ** torch.randint(-1, 2, (rows,), generator=g, device=dev)
    ks = torch.tensor([0.25, (nkt - 1) * 0.25, 0.1, nkt * 0.25, 300.125],
                      dtype=torch.float64, device=dev)
    return u, scales.to(torch.float64), ks, 0.25


def sample_err(got, idx, want, maxabs):
    """Max |got.flat[idx] - want| over the whole array's largest |value|
    (from the golden file): a fixed sample of a large array."""
    g = got.reshape(-1)[torch.as_tensor(idx, device=got.device)].cpu().numpy()
    return float(np.max(np.abs(g - want)) / float(maxabs))


def to_max(got, want):
    """Max |got - want| over the largest |want| (tensors)."""
    return ((got - want).abs().max() / want.abs().max()).item()


def entry_stats(phase, calls, dev, card, n=5):
    """Latency (median of n, host clock to synchronize()), launches and
    host reads (CardOps) and peak memory of each entry point, printed."""
    stats = {}
    for what, fn in calls.items():
        n_l, n_sync = card_ops(fn)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t_v = host_ms(fn, n=n, warmup=0)
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        stats[what] = {"ms": t_v, "launches": n_l, "host_reads": n_sync,
                       "peak_mib": peak}
        print(f"[time] {phase} {what}: {t_v!r} ms (host clock to "
              f"synchronize, median of {n}), {n_l} launches and {n_sync} "
              f"host reads (aten operations on the card, CardOps), peak "
              f"{peak:.1f} MiB allocated ({card})")
    return stats


def projfield_filter(nl):
    """examples/projected_field_ksz2.py's filter b_l / (C_l^TT + N_l) and
    C_l^TT on l = 2..8,000 (tools/gen_torch_golden.py's recipe)."""
    fgrid = np.arange(2.0, 8001.0)
    cl_tt = 2.0 * np.pi * 2500.0 / (fgrid * (fgrid + 1.0) ** 2) \
        * np.exp(-((fgrid / 3500.0) ** 2))
    fvals = np.exp(-0.5 * (fgrid * 1.4 * np.pi / 10800.0 / 2.355) ** 2) \
        / (cl_tt + nl)
    return fgrid, cl_tt, fvals


def phase_projfield(hm, dev, card, counts):
    """The projected-field kSZ^2 group on the class build at the settings
    of examples/projected_field_ksz2.py, against its golden file; no
    kernel launched in its calls.  Returns (launches, stats)."""
    from hmvec_tpu_torch.models import limber as tlimb
    from hmvec_tpu_torch.models import projfield as tpf
    from hmvec_tpu_torch.models.lensing_noise import white_noise_nl

    t_phase = time.perf_counter()
    gp = np.load(GOLDEN_PF)
    for key in ("zs", "ks", "ms"):
        check(np.array_equal(gp[key], getattr(hm, key + "_np")),
              f"the projfield golden file is on the build's {key}")
    zs, ks = hm.zs_np, hm.ks_np
    ells, tri, fsky = gp["ells"], gp["tri"], float(gp["fsky"])
    nodes = dict(zip(("n_radial", "n_angle"), map(int, gp["nodes"])))
    fgrid = np.arange(2.0, 8001.0)
    nl = white_noise_nl(fgrid, *map(float, gp["noise"]), device=dev)
    nl = nl.cpu().numpy()
    fgrid, cl_tt, fvals = projfield_filter(nl)
    table = (fgrid, fvals)
    dndz = np.exp(-0.5 * ((zs - 0.6) / 0.25) ** 2)
    pgm, pgg = hm.get_power("g", name2="nfw"), hm.get_power("g", name2="g")
    ckg = tlimb.C_kg(hm.bg, fgrid, zs, ks, pgm, zs, gdndz=dndz, lzs=1100.0)
    cl_phig = 2.0 * ckg / torch.as_tensor(fgrid, device=dev) ** 2
    chis = hm.comoving_radial_distance(hm.zs).cpu().numpy()
    hzs = hm.h_of_z(hm.zs).cpu().numpy()
    ngal2d = float(hm.hods["g"]["ngal"][0]) * np.trapezoid(
        chis**2 / hzs * dndz / np.trapezoid(dndz, zs), zs)
    clgg = tlimb.C_gg(hm.bg, ells, zs, ks, pgg, zs, gdndz=dndz) \
        + 1.0 / ngal2d
    torch.cuda.synchronize()
    res = {}
    calls = {
        "cl_ksz2_galaxy": lambda: tpf.cl_ksz2_galaxy(
            hm, ells, table, gdndz=dndz, **nodes),
        "cl_ksz2_galaxy ell_chunk=2": lambda: tpf.cl_ksz2_galaxy(
            hm, ells, table, gdndz=dndz, ell_chunk=2, **nodes),
        "cl_ksz2_kappa nfw": lambda: tpf.cl_ksz2_kappa(hm, ells, table,
                                                       **nodes),
        "cl_ksz2_kappa nfw_fast": lambda: tpf.cl_ksz2_kappa(
            hm, ells, table, name_matter="nfw_fast", **nodes),
        "hybrid_bispectrum_ttg": lambda: tpf.hybrid_bispectrum_ttg(
            hm, *tri, gdndz=dndz),
        "vrms2_linear": lambda: tpf.vrms2_linear(hm),
        "cl_t2_lensing": lambda: tpf.cl_t2_lensing(
            ells, table, cl_tt, cl_phig, lmin=2.0, lmax=8000.0),
        "cl_t2_t2_gaussian": lambda: tpf.cl_t2_t2_gaussian(
            ells, table, cl_tt + nl, lmin=2.0, lmax=8000.0, device=dev),
        "ksz2_snr": lambda: tpf.ksz2_snr(
            ells, res["cl_ksz2_galaxy"], res["cl_t2_t2_gaussian"], clgg,
            fsky=fsky),
    }
    # the main path of the phase: the calls with the counts set to 0 just
    # before and read just after
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    counts.reset()
    for what, fn in calls.items():
        res[what] = fn()
    torch.cuda.synchronize()
    launches = counts.read()
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    check(not any(launches.values()), f"the projfield calls launch no "
          f"kernel: {launches}")
    fields = {
        "C_kg (the lensing term's input)": (ckg, "ckg", GATE_PF),
        "C_gg + shot noise": (clgg, "clgg", GATE_PF),
        "cl_ksz2_galaxy": (res["cl_ksz2_galaxy"], "ksz2_g", GATE_PF),
        "cl_ksz2_galaxy ell_chunk=2": (res["cl_ksz2_galaxy ell_chunk=2"],
                                       "ksz2_g", GATE_PF),
        "cl_ksz2_kappa nfw": (res["cl_ksz2_kappa nfw"], "ksz2_k", GATE_PF),
        "cl_ksz2_kappa nfw_fast": (res["cl_ksz2_kappa nfw_fast"], "ksz2_k",
                                   GATE_PF_FAST),
        "hybrid_bispectrum_ttg": (res["hybrid_bispectrum_ttg"], "hybrid",
                                  GATE_PF),
        "vrms2_linear": (res["vrms2_linear"], "vrms2", GATE_PF),
        "cl_t2_lensing": (res["cl_t2_lensing"], "t2_lensing", GATE_PF),
        "cl_t2_t2_gaussian": (res["cl_t2_t2_gaussian"], "t2_t2", GATE_PF),
        "ksz2_snr per band": (res["ksz2_snr"][0], "snr2", GATE_PF),
        "ksz2_snr total": (res["ksz2_snr"][1], "snr", GATE_PF),
    }
    for what, (got, key, gate) in fields.items():
        want = gp[key]
        check(got.device == dev and got.dtype == torch.float64
              and tuple(got.shape) == want.shape
              and bool(torch.isfinite(got).all()),
              f"projfield {what} output {tuple(got.shape)}")
        e = close_err(got.cpu().numpy(), want)
        check(e <= gate, f"projfield {what} vs golden: {e!r} > {gate}")
        print(f"[projfield] {what} {tuple(got.shape)}: max rel err vs the "
              f"JAX golden {e!r} element by element (gate {gate})")
    print(f"[projfield] the {len(calls)} calls' launches {launches}; peak "
          f"{peak:.1f} MiB allocated ({card})")
    stats = entry_stats("projfield", calls, dev, card)
    print(f"[projfield] the phase's wall time "
          f"{time.perf_counter() - t_phase:.1f} s (host clock)")
    return launches, stats


def log_interp_on_L(nodes, vals, lmax):
    """examples/lensing_qe_sim.py's N0 on integer L: log-log interpolation
    of the node values, 0 below L = 2 (tools/gen_torch_golden.py's)."""
    Li = np.arange(lmax + 1, dtype=np.float64)
    out = np.exp(np.interp(np.log(np.maximum(Li, 2.0)), np.log(nodes),
                           np.log(vals)))
    out[:2] = 0.0
    return out


def phase_flatsky(dev, card, counts):
    """The map-level lensing reconstruction of examples/lensing_qe_sim.py
    (16 sims as one batch) on white noise drawn by numpy from the golden
    file's seed, against the golden file; no kernel launched.  Returns
    (launches, stats)."""
    from hmvec_tpu_torch.models import flatsky as tfs
    from hmvec_tpu_torch.models import lensing_noise as lnm
    from hmvec_tpu_torch.models.lensed_cf import lens_cls_flat_sky_resummed

    t_phase = time.perf_counter()
    gf = np.load(GOLDEN_FS)
    cfg = dict(zip(gf["settings_names"].tolist(), gf["settings"]))
    n, pix, lmax_t = int(cfg["n"]), float(cfg["pix"]), int(cfg["lmax_t"])
    lmax_rec, ns, o = int(cfg["lmax_rec"]), int(cfg["nsims"]), \
        int(cfg["oversample"])
    unl, clpp, bins = gf["unlensed"], gf["clpp"], gf["bins"]
    # the spectra: the port's own lensed spectra, noise, N0 family and N1
    clpp_pad = np.zeros(unl.shape[0])
    clpp_pad[:clpp.size] = clpp
    cl_len = lens_cls_flat_sky_resummed(unl, clpp_pad, lmax_out=lmax_t,
                                        device=dev)
    cl_len[:2] = 0.0
    lv = np.arange(lmax_t + 1.0)
    nl = lnm.white_noise_nl(lv, float(cfg["noise_t"]), float(cfg["beam"]),
                            device=dev)
    nl_p = lnm.white_noise_nl(lv, float(cfg["noise_t"]) * math.sqrt(2.0),
                              float(cfg["beam"]), device=dev)
    tot = cl_len[:, 0] + nl
    tot_ee, tot_bb = cl_len[:, 1] + nl_p, cl_len[:, 2] + nl_p
    nodes = gf["nodes"]
    kw = dict(lmin=30, lmax=lmax_t)
    grads = {"TT": cl_len[:, 0], "EE": cl_len[:, 1], "TE": cl_len[:, 3]}
    tots = {"TT": tot, "EE": tot_ee, "BB": tot_bb, "TE": cl_len[:, 3]}
    n0_nodes = torch.stack([
        lnm.n0_flat_sky(nodes, "TT", cl_len[:, 0], tot, **kw),
        lnm.n0_flat_sky(nodes, "EE", cl_len[:, 1], tot_ee, **kw),
        lnm.n0_flat_sky(nodes, "EB", cl_len[:, 1], tot_ee, cl_total2=tot_bb,
                        **kw),
        lnm.n0_te_simple_flat_sky(nodes, grads, tots, **kw)[0]])
    n0n = n0_nodes.cpu().numpy()
    n0, n0_ee, n0_eb = (log_interp_on_L(nodes, v, lmax_rec) for v in n0n[:3])
    a_te = log_interp_on_L(nodes, 1.0 / n0n[3], lmax_rec)
    L_n1 = gf["L_n1"]
    n1 = lnm.n1_tt_flat_sky(L_n1, cl_len[:, 0], tot, clpp, n0_phi=np.interp(
        L_n1, np.arange(lmax_rec + 1.0), n0), **kw)
    # the resummed spectra relative to each row's largest value, as the
    # lensing phase holds them (their J2-J6 recurrences' absolute error)
    for what, got, want, measure in (
            ("lens_cls_flat_sky_resummed", cl_len.T, gf["cl_len"].T,
             row_err),
            ("N0 TT/EE/EB and the TE response at the nodes", n0_nodes,
             gf["n0_nodes"], close_err),
            ("n1_tt_flat_sky", n1, gf["n1"], close_err)):
        e = measure(got.cpu().numpy(), want)
        check(e <= GATE_FS, f"flatsky {what} vs golden: {e!r}")
        kind = "of the row's largest value" if measure is row_err \
            else "element by element"
        print(f"[flatsky] {what} {tuple(want.shape)}: max rel err vs the "
              f"JAX golden {e!r} {kind} (gate {GATE_FS})")
    # white noise, as the golden file drew it
    rng = np.random.default_rng(int(cfg["seed"]))
    w = rng.standard_normal((ns, 3, n, n))
    wp = rng.standard_normal((2, n, n))
    check(np.array_equal(w.reshape(-1)[gf["idx"][:16]], gf["noise_check"]),
          "numpy draws the golden file's white noise")
    W = torch.as_tensor(w, device=dev)
    Wp = torch.as_tensor(wp, device=dev)
    del w, wp
    cl_t = torch.as_tensor(unl[:lmax_t + 1, 0], device=dev)
    qe = lambda t: tfs.qe_tt(t, pix, cl_len[:, 0], tot, n0, lmin=30,
                             lmax=lmax_t)

    def sims(w):
        """The example's per-sim chain on w (..., 3, n, n)."""
        t0 = tfs._synth_from_noise(w[..., 0, :, :], pix, cl_t)
        phi = tfs._synth_from_noise(w[..., 1, :, :], pix, clpp)
        noise = tfs._synth_from_noise(w[..., 2, :, :], pix, nl)
        lensed = tfs.lens_map(t0, phi, pix, oversample=o)
        ph = qe(lensed + noise)
        ph0 = qe(t0 + noise)
        pk = torch.fft.fft2(phi)
        binned = torch.stack([tfs.fourier_power(a, b, pix, bins)[1]
                              for a, b in ((ph, pk), (ph, ph), (ph0, ph0),
                                           (pk, pk))], dim=-2)
        return {"lensed": lensed, "ph": ph, "ph0": ph0, "phi": phi,
                "binned": binned}

    def pol(phi):
        t, q, u = tfs._synth_tqu_from_noise(
            Wp[0], Wp[1], None, pix, cl_t, unl[:lmax_t + 1, 1],
            unl[:lmax_t + 1, 3])
        tl, ql, ul = (tfs.lens_map(m, phi, pix, oversample=o)
                      for m in (t, q, u))
        return {"ee": tfs.qe_ee(ql, ul, pix, cl_len[:, 1], tot_ee, n0_ee,
                                **kw),
                "te": tfs.qe_te(tl, ql, ul, pix, cl_len[:, 3], tot, tot_ee,
                                a_te, **kw),
                "eb": tfs.qe_eb(ql, ul, pix, cl_len[:, 1], tot_ee, tot_bb,
                                n0_eb, **kw)}

    # the main path of the phase: the 16 sims as one batch, then the
    # polarized draw, the counts set to 0 just before and read just after
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    counts.reset()
    out = sims(W)
    out_pol = pol(out["phi"][0])
    torch.cuda.synchronize()
    launches = counts.read()
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    check(not any(launches.values()), f"the flatsky calls launch no kernel: "
          f"{launches}")
    for key in ("lensed", "ph", "ph0"):
        got = out[key]
        check(got.device == dev and tuple(got.shape) == (ns, n, n),
              f"flatsky {key} shape {tuple(got.shape)}")
        e = sample_err(got, gf["idx"], gf[f"{key}_sample"],
                       gf[f"{key}_maxabs"])
        check(e <= GATE_FS, f"flatsky {key} vs golden: {e!r}")
        print(f"[flatsky] {key} ({ns}, {n}, {n}): max err vs the JAX golden "
              f"{e!r} of the array's largest value on "
              f"{gf['idx'].size} sampled elements (gate {GATE_FS})")
    for key, got in out_pol.items():
        e = sample_err(got, gf["idx_pol"], gf[f"ph_{key}_sample"],
                       gf[f"ph_{key}_maxabs"])
        check(got.device == dev and e <= GATE_FS, f"flatsky qe_{key} vs golden: "
              f"{e!r}")
        print(f"[flatsky] qe_{key} on the lensed synth_tqu draw: max err vs "
              f"the JAX golden {e!r} of the array's largest value on "
              f"{gf['idx_pol'].size} sampled elements (gate {GATE_FS})")
    for j, key in enumerate(("cx", "caa", "c00", "cpp")):
        got = out["binned"][:, j].cpu().numpy()
        e = close_err(got, gf[f"binned_{key}"])
        check(e <= GATE_FS, f"flatsky binned {key} vs golden: {e!r}")
        print(f"[flatsky] binned {key} {got.shape}: max rel err vs the JAX "
              f"golden {e!r} element by element (gate {GATE_FS})")
    # the batch against one sim alone
    i1 = min(3, ns - 1)
    one = sims(W[i1])
    e_b = max(to_max(out[k][i1], one[k]) for k in out)
    check(e_b <= GATE_FS_BATCH, f"flatsky batch vs one sim: {e_b!r}")
    cx = out["binned"][:, 0].sum(0)
    caa = out["binned"][:, 1].sum(0)
    cpp = out["binned"][:, 3].sum(0)
    rho = (cx / torch.sqrt(caa * cpp)).cpu().numpy()
    print(f"[flatsky] sim {i1} of the batch against it alone: max err "
          f"{e_b!r} of each array's largest value (gate {GATE_FS_BATCH}); "
          f"the reconstruction's cross-correlation rho(L) over the bins "
          f"{np.round(rho, 3).tolist()}; the batch's launches {launches}, "
          f"peak {peak:.1f} MiB allocated ({card})")
    del one, out, out_pol
    gen = torch.Generator(device=dev).manual_seed(7)
    ph1 = qe(W[0, 0])
    calls = {
        "synth_gaussian (CUDA generator, one map)": lambda: tfs.synth_gaussian(
            gen, n, pix, cl_t),
        "the 16-sim reconstruction (synthesis, lens_map, 2 qe_tt, 4 binned "
        "spectra)": lambda: sims(W),
        "lens_map x16": lambda: tfs.lens_map(W[:, 0], W[:, 1] * 1e-4, pix,
                                             oversample=o),
        "qe_tt x16": lambda: qe(W[:, 0]),
        "fourier_power x16": lambda: tfs.fourier_power(ph1, ph1, pix, bins),
        "synth_tqu + lens_map + qe_ee, qe_te, qe_eb": lambda: pol(W[0, 1]
                                                                  * 1e-4),
    }
    stats = entry_stats("flatsky", calls, dev, card)
    del W, Wp
    torch.cuda.empty_cache()
    print(f"[flatsky] the phase's wall time "
          f"{time.perf_counter() - t_phase:.1f} s (host clock)")
    return launches, stats


def phase_emulator(dev, card, counts, wrappers):
    """examples/emulator_pk.py on the card: the training set by vmapped
    make_pmm_fn chunks, a float64 fit from JAX's initial net, the float32
    fit, jacfwd through the emulator, against the golden file.  Returns
    (launches, stats, what the sharded phase fits again)."""
    from hmvec_tpu_torch import pipeline as pl
    from hmvec_tpu_torch.models import emulator as tem

    t_phase = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 GEMMs run in float32 (TF32 off)")
    ge = np.load(GOLDEN_EM)
    names = tuple(ge["names"].tolist())
    lo, hi = ge["lo"], ge["hi"]
    n_train, n_val, steps, chunk, seed = map(int, ge["fit"])
    fit = dict(n_train=n_train, n_val=n_val,
               widths=tuple(map(int, ge["widths"])),
               learning_rate=float(ge["learning_rate"]), log_y=True,
               chunk=chunk, seed=seed)
    nW = len([k for k in ge.files if re.fullmatch(r"W\d+", k)])
    init = {"W": [ge[f"W{i}"] for i in range(nW)],
            "b": [np.zeros(ge[f"W{i}"].shape[1]) for i in range(nW)]}
    pmm = pl.make_pmm_fn(ge["zs"], ge["ks"], ge["ms"], device=dev)
    target = tem.pipeline_target(pmm, names)
    thetas = tem.sample_params(lo, hi, n_train + n_val, seed=seed)
    n_chunks = -(-thetas.shape[0] // chunk)
    # the main path of the phase: the training set, both fits and the
    # Jacobian, the counts set to 0 just before and read just after
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    counts.reset()
    Y = tem._training_set(target, thetas, chunk, dev)
    em64, info64 = tem.fit_emulator(target, lo, hi, steps=int(ge["steps64"]),
                                    dtype=torch.float64, init_net=init, **fit)
    em32, info32 = tem.fit_emulator(target, lo, hi, steps=steps,
                                    init_net=init, **fit)
    theta0 = torch.as_tensor(ge["val_thetas"][0], device=dev)
    jac = torch.func.jacfwd(em64)(theta0)
    torch.cuda.synchronize()
    launches = counts.read()
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    check(not any(launches.values()), f"the emulator's plain-tier pipeline "
          f"launches no kernel: {launches}")
    e_rows = close_err(Y[ge["rows"]], ge["Y_rows"])
    check(e_rows <= GATE_EM_ROWS, f"emulator training rows vs golden: "
          f"{e_rows!r}")
    for em in (em64, em32):
        check(em.device == dev and all(p.device == dev
                                       for p in em.parameters()),
              "the emulator trained on the card")
    check(em32.net.W[0].dtype == torch.float32
          and em64.net.W[0].dtype == torch.float64, "the fits' dtypes")
    e64 = float(np.max(np.abs(info64["losses"] / ge["losses64"] - 1.0)))
    check(e64 <= GATE_EM_FIT64, f"float64 fit losses vs golden: {e64!r}")
    with torch.no_grad():
        pred64 = em64(ge["val_thetas"]).cpu().numpy()
    e_p64 = close_err(pred64, ge["pred64"])
    check(e_p64 <= GATE_EM_FIT64, f"float64 fit predictions vs golden: "
          f"{e_p64!r}")
    metrics = np.array([np.mean(info32["losses"][-50:]),
                        info32["val_max_rel"], info32["val_rms_rel"]])
    want32 = np.array([np.mean(ge["losses32"][-50:]), *ge["val32"]])
    spread = np.abs(metrics / want32 - 1.0)
    gate32 = float(ge["f32_gate"])
    check(float(spread.max()) <= gate32, f"float32 fit vs JAX's: {spread} > "
          f"{gate32}")
    # jacfwd against central differences of the float64 emulator
    h = 1e-6 * torch.as_tensor(hi - lo, device=dev)
    with torch.no_grad():
        fd = torch.stack([(em64(theta0 + h[i] * torch.eye(3, device=dev)[i])
                           - em64(theta0 - h[i] * torch.eye(3, device=dev)[i]))
                          / (2.0 * h[i]) for i in range(3)], dim=-1)
    e_jac = to_max(jac, fd)
    check(e_jac <= GATE_EM_JAC_FD, f"jacfwd vs central differences: "
          f"{e_jac!r}")
    print(f"[emulator] training set {Y.shape} on the card in {n_chunks} "
          f"vmapped chunks: every 16th row vs the JAX golden {e_rows!r} "
          f"element by element (gate {GATE_EM_ROWS}); float64 fit of "
          f"{int(ge['steps64'])} steps from JAX's initial net: losses "
          f"{e64!r}, predictions {e_p64!r} (gate {GATE_EM_FIT64}); float32 "
          f"fit of {steps} steps: final loss {metrics[0]!r} (JAX "
          f"{want32[0]!r}), held-out max rel {metrics[1]!r} (JAX "
          f"{want32[1]!r}), rms {metrics[2]!r} (JAX {want32[2]!r}); spread "
          f"{spread.tolist()} (gate {gate32!r}, ten times the CPU spread "
          f"{ge['f32_spread_cpu'].tolist()}); jacfwd vs central differences "
          f"{e_jac!r} of its largest element (gate {GATE_EM_JAC_FD}); the "
          f"phase's launches {launches}, peak {peak:.1f} MiB ({card})")
    # the same training set through the exact NFW kernel: one launch a
    # chunk (the vmap rule folds the chunk into the kernel's rows)
    pmm_x = pl.make_pmm_fn(ge["zs"], ge["ks"], ge["ms"], device=dev,
                           fast="exact")
    target_x = tem.pipeline_target(pmm_x, names)
    counts.reset()
    Yx = tem._training_set(target_x, thetas, chunk, dev)
    torch.cuda.synchronize()
    launches_x = counts.read()
    want_x = {k: (n_chunks if k == "nfw_uk_exact" else 0) for k in wrappers}
    check(launches_x == want_x, f"exact-tier training set: one "
          f"nfw_uk_exact launch a chunk, got {launches_x}")
    e_x = close_err(Yx[ge["rows"]], ge["Y_rows"])
    check(e_x <= GATE_PMM["exact"], f"exact-tier training rows: {e_x!r}")
    print(f"[emulator] the training set through nfw_uk_exact: launches "
          f"{launches_x}, rows vs the golden {e_x!r} (gate "
          f"{GATE_PMM['exact']})")
    chain = torch.as_tensor(np.random.default_rng(1).uniform(lo, hi,
                                                             (512, 3)),
                            device=dev)
    th_chunk = torch.as_tensor(thetas[:chunk], device=dev)
    gen = torch.func.vmap(target)
    calls = {
        f"training-set chunk ({chunk} cosmologies, vmapped make_pmm_fn)":
            lambda: gen(th_chunk),
        "emulator float32, 512 cosmologies": lambda: em32(chain),
        "jacfwd through the float64 emulator": lambda: torch.func.jacfwd(
            em64)(theta0),
    }
    stats = entry_stats("emulator", calls, dev, card)
    t0 = time.perf_counter()
    tem.fit_emulator(target, lo, hi, steps=steps, init_net=init, **fit)
    torch.cuda.synchronize()
    t_fit = (time.perf_counter() - t0) * 1e3
    stats[f"fit_emulator float32 ({steps} steps, with its training set)"] = {
        "ms": t_fit}
    keep = {"target": target, "lo": lo, "hi": hi, "init": init, "fit": fit,
            "steps": steps, "em": em32, "info": info32,
            "val": ge["val_thetas"], "ms": t_fit}
    print(f"[time] emulator fit_emulator float32 ({steps} steps, training "
          f"set included): {t_fit!r} ms (host clock to synchronize, one "
          f"call) ({card})")
    print(f"[emulator] the phase's wall time "
          f"{time.perf_counter() - t_phase:.1f} s (host clock)")
    return launches, stats, keep


def phase_checkpoint(hm, build, dev, card, counts):
    """The class build saved, restored into a fresh HaloModel on the card,
    and its spectra equal bit for bit; timed through utils.profiling."""
    import tempfile

    from hmvec_tpu_torch.utils import checkpoint as tck
    from hmvec_tpu_torch.utils import profiling as tprof

    spectra = {**CLASS_SPECTRA, "pmm_fast": ("nfw_fast", None)}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "class_build.npz")
        res = {}
        counts.reset()
        with tprof.timer("save", res):
            tck.save_halo_model(hm, path)
        fresh = build()
        with tprof.timer("restore", res):
            tck.restore_halo_model(fresh, path)
            torch.cuda.synchronize()
        launches = counts.read()
        size = pathlib.Path(path).stat().st_size / 2**20
        for key, names in spectra.items():
            a, b = fresh.get_power(*names), hm.get_power(*names)
            check(a.device == dev and torch.equal(a, b), f"checkpoint {key}: the "
                  f"restored build's spectrum equals the build's")
        check(not any(launches.values()), f"save and restore launch no "
              f"kernel: {launches}")
        t_restore = tprof.time_fn(lambda: tck.restore_halo_model(
            fresh, path).Pzk, iters=3, warmup=1)
        with tprof.torch_trace(str(pathlib.Path(tmp) / "trace")) as prof:
            tprof.fetch_sync(fresh.get_power("g"))
        n_cuda = sum(1 for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"[checkpoint] the class build ({len(hm.uk_profiles)} profiles, "
          f"{len(hm.hods)} HOD) saved to {size:.1f} MiB in "
          f"{res['save'] * 1e3!r} ms, restored into a fresh HaloModel on the "
          f"card in {res['restore'] * 1e3!r} ms (host clock; time_fn median "
          f"of 3: {t_restore * 1e3!r} ms): {len(spectra)} spectra equal bit "
          f"for bit; launches {launches}; torch_trace of a get_power saw "
          f"{n_cuda} kernels ({card})")
    return launches, {"save": {"ms": res["save"] * 1e3},
                      "restore": {"ms": t_restore * 1e3},
                      "file_mib": size}


class F64Ops(TorchDispatchMode):
    """The float64 operations of a plain PyTorch computation: the float64
    elements that each arithmetic aten operation writes (one operation
    each; a division or a square root counts one, as an issue floor does).
    Comparisons write booleans and selects (where) do no arithmetic, so
    neither counts."""

    ARITH = {"add", "sub", "mul", "div", "neg", "clamp_min", "clamp",
             "maximum", "minimum", "abs", "rsub", "reciprocal", "sqrt", "exp",
             "log", "pow", "sum", "sub_", "add_", "mul_", "div_"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func._schema.name.split("::")[-1] in self.ARITH:
            for t in (out if isinstance(out, (list, tuple)) else [out]):
                if isinstance(t, torch.Tensor) and t.dtype == torch.float64:
                    self.ops += t.numel()
        return out


def hierarchy_work(bk, xtab, ks, n_outer, n_inner, store):
    """(bytes, float64 operations, the serial operations of its longest
    row) of one hierarchy_rk4 call on these inputs.  The operations: the
    plain version's own count (F64Ops) of each right-hand side
    (tight-coupling or full, chosen per row and sub-point by the table as
    the kernel chooses), of the slaving after a tight-coupled step and of
    the RK4 combination, calibrated on one row and summed over the rows
    and sub-points of this call.  The serial operations: the kernel runs a
    row on one warp, every lane issuing the same instructions (each
    component's derivative through one template, the shared quantities on
    every lane), so a row's chain is one lane's program.  Its float64
    operations (a division one) of each piece of a step are counted by
    F64Ops on the emulation of that program
    (tools/emulate_torch_boltz_lanes.py, lane_op_counts: a full or a
    tight-coupling right-hand side, one sub-point's coefficients, three
    per step, the RK4 combinations, the slaving after a tight-coupled
    step), summed over the row's steps as the table chooses each piece,
    and the longest row's sum returned; the once-a-chunk coefficient
    passes (the block's and the warp's, one thread or lane a sub-point)
    are off the chain and not counted."""
    dev = ks.device
    c = bk.Consts(1.0, 1.0, 1.0, 1.0, 1.0,
                  h0m_d=torch.ones((), dtype=torch.float64, device=dev))
    # one sub-point as the plain version holds it: x-only values as
    # numbers, the divisors as 0-d tensors
    q0 = dict(zip(bk.XCOLS, xtab[0, 0].tolist()))
    q0.update(zip(bk.DIVISORS, torch.stack(bk.divisors(
        c, dict(zip(bk.XCOLS, xtab[0, 0].unbind(0))))).unbind(0)))
    s1 = torch.ones((1, bk.NSTATE), dtype=torch.float64, device=dev)
    k1 = torch.ones(1, dtype=torch.float64, device=dev)
    per = {}
    for name, fn in (("full", lambda: bk.rhs_full(c, q0, k1, s1)),
                     ("tc", lambda: bk.rhs_tc(c, q0, k1, s1)),
                     ("slave", lambda: bk.with_slaved(q0, k1, s1)),
                     ):
        with F64Ops() as m:
            fn()
        per[name] = m.ops
    # the RK4 combination: three stage inputs s + h k (2 each) and
    # s + dx/6 (k1 + 2 k2 + 2 k3 + k4) (7), per state entry
    per["rk"] = 13 * bk.NSTATE
    tab = xtab.cpu().numpy()
    kk = ks.cpu().numpy()
    tc = (tab[:, :, 9][:, :, None] != 0.0) & (
        np.abs(tab[:, :, 2])[:, :, None] > 10.0 * kk[None, None, :]
        / tab[:, :, 1][:, :, None])                  # (steps, 3, rows)
    n_tc = tc[:, [0, 1, 1, 2], :].sum()
    n_full = tc.shape[0] * 4 * kk.size - n_tc
    steps = n_outer * n_inner
    ops = (n_tc * per["tc"] + n_full * per["full"] + tc[:, 2, :].sum()
           * per["slave"] + steps * kk.size * per["rk"])
    lane = lane_op_counts()
    n_tc_row = tc[:, [0, 1, 1, 2], :].sum((0, 1))
    row_ops = float((n_tc_row * lane["tc"] + (4 * steps - n_tc_row)
                     * lane["full"] + tc[:, 2, :].sum(0) * lane["slave"]
                     + steps * (3 * lane["coefs"] + lane["rk"])).max())
    nbytes = 8 * (xtab.numel() + 2 * kk.size + 5 + kk.size * bk.NSTATE
                  * (2 + (n_outer if store else 0)))
    return int(nbytes), {"f64": int(ops)}, float(row_ops)


@functools.lru_cache(maxsize=None)
def lane_op_counts() -> dict:
    """One lane's float64 operations of each piece of a hierarchy_rk4 step
    (tools/emulate_torch_boltz_lanes.py, counted by F64Ops)."""
    spec = importlib.util.spec_from_file_location(
        "emulate_torch_boltz_lanes",
        ROOT / "tools" / "emulate_torch_boltz_lanes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lane_op_counts(F64Ops)


def hierarchy_vs_plain(bk, args):
    """(error of a row's largest value, largest absolute error, plain ms by
    the host clock) of one hierarchy_rk4 launch against its plain version
    on the same card tensors: the end state and, where stored, every outer
    point."""
    got = bk.hierarchy_rk4(*args)
    t0 = time.perf_counter()
    want = bk.hierarchy_rk4_plain(*args)
    torch.cuda.synchronize()
    t_plain = (time.perf_counter() - t0) * 1e3
    e = a = 0.0
    for g, w in zip(got, want):
        if g is not None:
            e = max(e, close_err(g.cpu().numpy(), w.cpu().numpy()))
            a = max(a, (g - w).abs().max().item())
    return e, a, t_plain


def phase_boltz(dev, card, counts, wrappers, sass):
    """The Boltzmann group on the card: recomb_rk4 (K6) and hierarchy_rk4
    (K7) against their plain versions, the k = 0.5 row of the default grid
    kept finite, and the slice's path at full width against the JAX
    golden files, each entry point with the counts set to 0 just before
    it and read just after: Cosmology().get_cmb_cls(approx=True) at lmax
    3,000, BoltzEngine() at its defaults and the README example built
    with engine="boltz".  Returns (launches by entry point, stats, the
    two kernels' rows)."""
    from hmvec_tpu_torch import BoltzEngine, Cosmology, HaloModel
    from hmvec_tpu_torch.models import background as bgmod
    from hmvec_tpu_torch.models import boltz_engine as tbe
    from hmvec_tpu_torch.models import boltzlite as tbl
    from hmvec_tpu_torch.models import recomb as trec
    from hmvec_tpu_torch.ops import boltz_kernels as bk
    from hmvec_tpu_torch.params import merge_params

    t_phase = time.perf_counter()
    gs, gc, ge, gk = (np.load(p) for p in (GOLDEN_BS, GOLDEN_BC, GOLDEN_BE,
                                           GOLDEN_BK))
    f_sm = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]) * 1e6
    rows, launches, stats = {}, {}, {}
    bg = bgmod.background(merge_params({}), dev)

    # K6 at n = 16,384 against its plain version
    t_sec = time.perf_counter()
    xs = trec._linspace(-18.0, 0.0, 16384, dev)
    dx = xs[1] - xs[0]
    tab, sn, xe0 = trec.recomb_tables(bg, xs, dx)
    args6 = (tab[None].contiguous(), sn[None].contiguous(), xe0.reshape(1),
             float(dx))
    got6 = bk.recomb_rk4(*args6)
    t0 = time.perf_counter()
    want6 = bk.recomb_rk4_plain(*args6)
    torch.cuda.synchronize()
    plain6 = (time.perf_counter() - t0) * 1e3
    e6 = close_err(got6.cpu().numpy(), want6.cpu().numpy())
    abs6 = (got6 - want6).abs().max().item()
    check(e6 <= GATE_BOLTZ_KERNEL, f"recomb_rk4 vs plain: {e6!r}")
    ms6 = event_ms(lambda: bk.recomb_rk4(*args6), n=5, warmup=1)
    # the work this run's table needs: a Saha step (its flag set at x)
    # reads the flag and saha_next and does no arithmetic; a Peebles step
    # reads its three sub-points' 7 columns and does the plain version's
    # count of one Peebles step (counted on the first step that is Peebles
    # at all three sub-points); x_e0 read, x_e written.  The serial floor:
    # one thread integrates the Peebles runs and nothing else (the staging
    # warps write the Saha steps beside it), so its chain is the Peebles
    # steps' operations, at one a cycle
    flags = (tab[:, :, 6] != 0.0).cpu().numpy()
    peebles = int((~flags[:, 0]).sum())
    partial = int((~flags[:, 0] & flags[:, 1:].any(1)).sum())
    i_p = int(np.flatnonzero(~flags.any(1))[0])
    with F64Ops() as m6:
        bk.recomb_rk4_plain(args6[0][:, i_p:i_p + 1], args6[1][:, i_p:i_p + 1],
                            xe0.reshape(1), float(dx))
    step_ops6 = m6.ops
    ops6 = peebles * step_ops6
    n6 = 8 * (peebles * 3 * 7 + (16383 - peebles) * 2 + 1 + 16384)
    b6 = bound(n6, {"f64": ops6})
    floor6 = ops6 / f_sm * 1e3
    rows["recomb_rk4"] = {
        "max_abs_err": abs6, "max_rel_err": e6, "ms": ms6,
        "plain_ms": plain6, "bound_ms": b6[0], "bound_by": b6[1],
        "serial_floor_ms": floor6, "steps": 16383, "peebles_steps": peebles,
        "shape": "1 cosmology x 16,383 steps"}
    print(f"[boltz] recomb_rk4 at n = 16,384 ({peebles} Peebles steps of "
          f"16,383, {partial} of them with a later sub-point in Saha "
          f"equilibrium): max err vs the plain version {abs6!r} abs, {e6!r} "
          f"of the row's largest (gate {GATE_BOLTZ_KERNEL}); {ms6!r} ms "
          f"(CUDA events, median of 5), plain version {plain6!r} ms (host "
          f"clock, one call); bound {b6[0]!r} ms by {b6[1]} ({n6} bytes, "
          f"{ops6} float64 operations: {step_ops6} a Peebles step by the "
          f"plain version's count); serial floor of its integrating "
          f"thread {floor6!r} ms (those operations at one a cycle at "
          f"{f_sm / 1e6:.0f} MHz); section {time.perf_counter() - t_sec:.1f}"
          f" s ({card})")

    # K7 on the reduced grid of the CPU tests' golden file, every segment
    # against the plain version on the same card tensors
    t_sec = time.perf_counter()
    grid = dict(zip(gs["grid_names"].tolist(), map(int, gs["grid_values"])))
    ctx = tbl.make_ctx(bg, trec.recombination(bg, n=int(gs["n_rec"])))
    with recorded(tbl, "hierarchy_rk4") as segs:
        sol = tbl.solve_perturbations(ctx, gs["ks"], **grid)
    torch.cuda.synchronize()
    check(len(segs) == 4, f"the reduced solve: 4 hierarchy_rk4 launches, "
          f"got {len(segs)}")
    ms7 = plain7 = 0.0
    n7, ops7, row7 = 0, 0, 0.0
    e7 = a7 = 0.0
    for args in segs:
        e, a, t_plain = hierarchy_vs_plain(bk, args)
        e7, a7, plain7 = max(e7, e), max(a7, a), plain7 + t_plain
        ms7 += event_ms(lambda a=args: bk.hierarchy_rk4(*a), n=3, warmup=1)
        nb, ops, r_ops = hierarchy_work(bk, *args[:2], *args[5:8])
        n7, ops7, row7 = n7 + nb, ops7 + ops["f64"], row7 + r_ops
    check(e7 <= GATE_BOLTZ_KERNEL, f"hierarchy_rk4 vs plain: {e7!r}")
    e_sol = close_err(sol.states[:, ::3].cpu().numpy(),
                      gs["massless_states_every3"])
    e_zeta = abs(float(sol.zeta_unit) / float(gs["massless_zeta_unit"]) - 1)
    check(e_sol <= GATE_BOLTZ_SOLVE and e_zeta <= GATE_BOLTZ_REC,
          f"the reduced solve vs its golden file: {e_sol!r}, {e_zeta!r}")
    b7 = bound(n7, {"f64": ops7})
    floor7 = row7 / f_sm * 1e3
    reduced7 = {
        "max_abs_err": a7, "max_rel_err": e7, "ms": ms7, "plain_ms": plain7,
        "bound_ms": b7[0], "bound_by": b7[1], "serial_floor_ms": floor7,
        "shape": f"{gs['ks'].size} k (+ the curvature row) x the reduced "
                 f"grid's 4 segments", "vs_golden": e_sol}
    print(f"[boltz] hierarchy_rk4 on the reduced grid ({gs['ks'].size} k, "
          f"n_a {grid['n_a']}, n_b {grid['n_b_outer']} x "
          f"{grid['n_b_inner']}, n_c {grid['n_c_outer']} x "
          f"{grid['n_c_inner']}; 4 launches): max err vs the plain version "
          f"{a7!r} abs, {e7!r} of a row's largest (gate "
          f"{GATE_BOLTZ_KERNEL}); states vs the JAX golden {e_sol!r} (gate "
          f"{GATE_BOLTZ_SOLVE}), zeta_unit {e_zeta!r}; {ms7!r} ms (CUDA "
          f"events, sum of the launches' medians of 3), plain version "
          f"{plain7!r} ms (host clock); bound {b7[0]!r} ms by {b7[1]} ({n7} "
          f"bytes, {ops7} float64 operations); serial floor (the longest "
          f"row's lane program at one operation a cycle) {floor7!r} ms; "
          f"section {time.perf_counter() - t_sec:.1f} s ({card})")

    # the k = 0.5 row of the default grid at segment_c_inner_steps' count:
    # finite, and bounded at late times (the kernel only)
    t_sec = time.perf_counter()
    rec = trec.recombination(bg)
    ctx = tbl.make_ctx(bg, rec)
    n_c = tbl.segment_c_inner_steps(0.5, float(bg.H0))
    st = tbl.solve_perturbations(ctx, [0.5], n_c_inner=n_c).states
    late = st[0, -40:].abs().max().item()
    check(bool(torch.isfinite(st).all()) and late < 1e6,
          f"k = 0.5 at n_c_inner {n_c}: finite and bounded ({late!r})")
    print(f"[boltz] k = 0.5 on the default grid at n_c_inner {n_c}: states "
          f"finite, late-time max |state| {late!r} (< 1e6); section "
          f"{time.perf_counter() - t_sec:.1f} s")

    def entry(name, fn, want):
        """fn with the counts set to 0 just before and read just after."""
        torch.cuda.synchronize()
        counts.reset()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = counts.read()
        w = {n: want.get(n, 0) for n in wrappers}
        check(launches[name] == w, f"{name}: launches {launches[name]}, "
              f"expected {w}")
        return out

    def cmb():
        return Cosmology(device=dev).get_cmb_cls(approx=True)

    # get_cmb_cls(approx=True) at lmax 3,000: one recombination, four
    # segments
    t_sec = time.perf_counter()
    with recorded(tbl, "hierarchy_rk4") as segs_cmb:
        out = entry("boltz_cmb", cmb, {"recomb_rk4": 1, "hierarchy_rk4": 4})
    errs = {}
    for key in ("total", "unlensed_scalar", "lens_potential"):
        o = out[key]
        check(o.is_cuda and o.dtype == torch.float64
              and tuple(o.shape) == gc[key].shape, f"get_cmb_cls {key}")
        got, want = o.cpu().numpy().T, gc[key].T
        live = np.any(want != 0.0, axis=1)
        errs[key] = close_err(got[live][:, 2:], want[live][:, 2:])
        check(bool(np.isfinite(got).all()) and errs[key] <= GATE_BOLTZ_OUT,
              f"get_cmb_cls {key} vs golden: {errs[key]!r}")
    check(out["approx"] is True, "get_cmb_cls marks the approximation")
    rec_e = max(close_err(getattr(rec, k)[::4].cpu().numpy()[None],
                          gc[f"rec_{k}"][None])
                for k in ("xe", "tau_x", "eta"))
    check(rec_e <= GATE_BOLTZ_REC, f"recombination vs golden: {rec_e!r}")
    t_cmb = time.perf_counter() - t_sec
    # K7 at the main path's shapes: each of the four launches of that
    # get_cmb_cls (192 rows in six blocks, k to 0.5, 1,500 / 4,200 /
    # 6,080 steps, the curvature row's segment C) against the plain
    # version on the same card tensors
    t_sec = time.perf_counter()
    seg_rows, n7, ops7 = [], 0, 0
    for a in segs_cmb:
        e, a_err, t_plain = hierarchy_vs_plain(bk, a)
        check(e <= GATE_BOLTZ_KERNEL, f"hierarchy_rk4 vs plain on the main "
              f"path's segment of {a[1].numel()} rows, {a[5] * a[6]} steps: "
              f"{e!r}")
        t_k = event_ms(lambda a=a: bk.hierarchy_rk4(*a), n=3, warmup=1)
        nb, ops, r_ops = hierarchy_work(bk, *a[:2], *a[5:8])
        n7, ops7 = n7 + nb, ops7 + ops["f64"]
        b_ms, b_by = bound(nb, ops)
        seg_rows.append({"rows": int(a[1].numel()), "steps": a[5] * a[6],
                         "max_abs_err": a_err, "max_rel_err": e,
                         "ms": t_k, "plain_ms": t_plain, "bound_ms": b_ms,
                         "bound_by": b_by,
                         "serial_floor_ms": r_ops / f_sm * 1e3})
    # the kernels line's row: the main path's four launches summed, the
    # largest error over them and the reduced grid's
    b7 = bound(n7, {"f64": ops7})
    rows["hierarchy_rk4"] = {
        "max_abs_err": max([a7] + [r["max_abs_err"] for r in seg_rows]),
        "max_rel_err": max([e7] + [r["max_rel_err"] for r in seg_rows]),
        **{key: sum(r[key] for r in seg_rows)
           for key in ("ms", "plain_ms", "serial_floor_ms")},
        "bound_ms": b7[0], "bound_by": b7[1],
        "shape": "get_cmb_cls()'s 4 segments (192 / 192 / 191 / 1 rows)",
        "cmb_segments": seg_rows, "reduced_grid": reduced7}
    print(f"[boltz] get_cmb_cls(approx=True) at lmax 3,000 vs the JAX "
          f"golden (close_err by column): {errs} (gate {GATE_BOLTZ_OUT}); "
          f"recombination {rec_e!r} (gate {GATE_BOLTZ_REC}); launches "
          f"{launches['boltz_cmb']}; section {t_cmb:.1f} s; hierarchy_rk4 "
          f"per segment against the plain version (gate "
          f"{GATE_BOLTZ_KERNEL}): {seg_rows}; section "
          f"{time.perf_counter() - t_sec:.1f} s ({card})")
    stats["get_cmb_cls"] = entry_stats("boltz", {"get_cmb_cls": cmb}, dev,
                                       card, n=3)["get_cmb_cls"]

    # BoltzEngine() at its defaults: one solve
    def engine():
        tbe._TABLE_CACHE.clear()
        return BoltzEngine(device=dev)

    eng = entry("boltz_engine", engine, {"recomb_rk4": 1,
                                         "hierarchy_rk4": 4})
    e_eng = {"ks_t": close_err(eng.ks_t, ge["ks_t"]),
             "p0_t": close_err(eng.p0_t, ge["p0_t"]),
             "lnratio": close_err(eng._lnratio, ge["lnratio"]),
             "graft_ratio": abs(eng._graft_ratio / float(ge["graft_ratio"])
                                - 1.0)}
    p_lin = eng.plin(bg, ge["zs"], ge["ks"])
    e_eng["plin"] = close_err(p_lin.cpu().numpy(), ge["plin"])
    rs, zd = tbe.rs_drag_integral()
    e_eng["rs_drag"] = max(abs(rs / float(ge["rs_drag"]) - 1.0),
                           abs(zd / float(ge["z_drag"]) - 1.0))
    check(all(v <= GATE_BOLTZ_OUT for v in e_eng.values())
          and e_eng["rs_drag"] <= GATE_BOLTZ_REC,
          f"BoltzEngine() vs golden: {e_eng}")
    print(f"[boltz] BoltzEngine() vs the JAX golden: {e_eng} (gate "
          f"{GATE_BOLTZ_OUT}; r_s and z_drag {GATE_BOLTZ_REC}); launches "
          f"{launches['boltz_engine']}")
    stats["BoltzEngine"] = entry_stats("boltz", {"BoltzEngine": engine},
                                       dev, card, n=3)["BoltzEngine"]
    stats["plin"] = entry_stats("boltz", {"plin": lambda: eng.plin(
        bg, ge["zs"], ge["ks"])}, dev, card)["plin"]

    # the README example built on engine="boltz": the solve, B1 once and
    # B4a twice
    cosmo = dict(zip(gk["param_names"].tolist(),
                     map(float, gk["param_values"])))

    def build():
        tbe._TABLE_CACHE.clear()
        hm = HaloModel(gk["zs"], gk["ks"], ms=gk["ms"], params=cosmo,
                       engine="boltz", device=dev)
        hm.add_battaglia_profile("e", family="AGN")
        hm.add_battaglia_pres_profile("y")
        hm.add_hod("g", ngal=gk["ngal"])
        hm.add_nfw_profile("nfw_fast", fast=True)
        return hm

    hm = entry("boltz_class", build, {"recomb_rk4": 1, "hierarchy_rk4": 4,
                                      "nfw_uk_fast": 1, "pair_lerp_f64": 2})
    e_cls = {}
    for key, names in {**CLASS_SPECTRA, "pmm_fast": ("nfw_fast", None)}.items():
        o = hm.get_power(*names)
        want = gk[key.replace("_fast", "")]
        check(o.is_cuda and tuple(o.shape) == want.shape
              and bool(torch.isfinite(o).all()), f"boltz class {key}")
        e_cls[key] = float(np.max(np.abs(o.cpu().numpy() / want - 1.0)))
        check(e_cls[key] <= GATE_BOLTZ_OUT, f"boltz class {key} vs golden: "
              f"{e_cls[key]!r}")
    print(f"[boltz] the README example on engine='boltz' at 20x200x1001 vs "
          f"the JAX class's golden: {e_cls} (gate {GATE_BOLTZ_OUT}); build "
          f"launches {launches['boltz_class']}")
    stats["class_build"] = entry_stats("boltz", {"class_build": build}, dev,
                                       card, n=1)["class_build"]
    from hmvec_tpu_torch.kernels import _build

    res = ptxas_resources(_build.build_info.get("log", ""))
    for name in ("recomb_rk4_kernel", "hierarchy_rk4_kernel"):
        row = rows[name.replace("_kernel", "")]
        if name in sass:
            row["sass_body"] = dict(sass[name]["body"])
        row.update(res.get(name, {}))
        print(f"[boltz] {name}: ptxas {res.get(name)} ({card})")
    del hm, eng
    torch.cuda.empty_cache()
    print(f"[boltz] the phase's wall time {time.perf_counter() - t_phase:.1f}"
          f" s (host clock)")
    return launches, stats, rows


def mesh_ms(fn, mesh, n=5, warmup=1) -> float:
    """Median host time of one call of fn that ends when every card of the
    mesh has finished (host_ms for a mesh of several cards)."""
    def sync():
        for d in mesh.distinct():
            torch.cuda.synchronize(d)

    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_sharded(mesh, ref, card, counts, wrappers, kernel_rows=None):
    """The multi-device layer (parallel/sharding.py) on ``mesh``, each
    entry point held against its unsharded counterpart on the card (the
    outputs of earlier phases where they exist) with the launch counts set
    to 0 just before it and read just after: the mass-sharded Pmm (config
    1, plain), two Fisher steps (config 4's ells), data-parallel batches
    (bN and bNf at B = 128, the exact tier at B = 16, the fast electron
    tier at B = 4), the galaxy x electron spectra and the matter
    bispectrum (config 1's grid, config 3's ngal), the four-bin kSZ
    survey, the k-sharded Boltzmann solve on get_cmb_cls()'s grid and the
    l-sharded projection, and the data-parallel emulator fit; each
    sharded call's latency beside the unsharded call's.  With
    ``kernel_rows`` (a dict), each kernel's launches at the shard shapes,
    recorded from these calls, are timed into it with their bounds.
    Returns (launches by entry point, stats)."""
    from hmvec_tpu_torch import HaloModel
    from hmvec_tpu_torch import pipeline as pl
    from hmvec_tpu_torch.models import background as bgmod
    from hmvec_tpu_torch.models import boltzlite as tbl
    from hmvec_tpu_torch.models import emulator as tem
    from hmvec_tpu_torch.models import recomb as trec
    from hmvec_tpu_torch.ops import nfw_kernels as nk
    from hmvec_tpu_torch.ops import resample_kernels as rk
    from hmvec_tpu_torch.params import merge_params
    from hmvec_tpu_torch.parallel import sharding as tsh

    t_phase = time.perf_counter()
    dev, n = mesh.devices[0], mesh.size
    tag = f"{n} slots on {', '.join(str(d) for d in mesh.distinct())}"
    launches, stats, records = {}, {}, collections.defaultdict(list)

    def entry(name, fn, want, record=()):
        """fn with the counts set to 0 just before and read just after,
        the inputs of the kernels in ``record`` kept."""
        for d in mesh.distinct():
            torch.cuda.synchronize(d)
        with contextlib.ExitStack() as stack:
            recs = {r: stack.enter_context(recorded(*RECORD[r]))
                    for r in record}
            counts.reset()
            out = fn()
            for d in mesh.distinct():
                torch.cuda.synchronize(d)
            launches[name] = counts.read()
        for r, calls in recs.items():
            records[r] += calls
        w = {k: want.get(k, 0) for k in wrappers}
        check(launches[name] == w, f"sharded {name} on {tag}: launches "
              f"{launches[name]}, expected {w}")
        return out

    t_item = [time.perf_counter()]

    def timed(name, sharded, unsharded, n_t=5):
        stats[name] = {"ms": mesh_ms(sharded, mesh, n=n_t),
                       "unsharded_ms": mesh_ms(unsharded, mesh, n=n_t),
                       "launches": launches[name]}
        print(f"[sharded] {name} on {tag}: {stats[name]['ms']!r} ms, "
              f"unsharded {stats[name]['unsharded_ms']!r} ms (host clock to "
              f"the mesh's synchronize, median of {n_t}); kernel launches "
              f"{launches[name]}; section "
              f"{time.perf_counter() - t_item[0]:.1f} s ({card})")
        t_item[0] = time.perf_counter()

    RECORD = {"nfw_uk": (nk, "_launch_nfw_uk"),
              "nfw_contract": (nk, "_launch_nfw_contract"),
              "pair_lerp": (rk, "_launch"),
              "catmull_fill": (rk, "_launch_fill"),
              "hierarchy_rk4": (tbl, "hierarchy_rk4")}
    zs, ks_np, ms = ref.zs, ref.ks_np, ref.ms

    # 1. Pmm, config 1, plain, the mass axis over the slots
    spmm = tsh.make_sharded_pmm_fn(zs, ks_np, ms, mesh)
    got = entry("pmm", lambda: spmm(ref.cosmos[0]), {})
    e_g = float(np.max(np.abs(got.cpu().numpy() / ref.g["pmm"][0] - 1.0)))
    e_u = rel_max(got, ref.pmm_plain)
    check(e_g <= GATE_SHARD_PMM and e_u <= GATE_SHARD_PMM,
          f"sharded pmm: {e_g!r} vs golden, {e_u!r} vs make_pmm_fn")
    print(f"[sharded] pmm (config 1, plain) on {tag}: max rel err vs the "
          f"golden {e_g!r}, vs make_pmm_fn on the card {e_u!r} (gate "
          f"{GATE_SHARD_PMM})")
    timed("pmm", lambda: spmm(ref.cosmos[0]),
          lambda: ref.fns["plain"](ref.cosmos[0]))

    # 2. two Fisher steps at config 4's ells against the unsharded step
    ells = ref.gl["ells"]
    step, model = tsh.make_fisher_step_fn(zs, ks_np, ms, ells, mesh)
    step_u, model_u = tsh._fisher_step(ref.fns["plain"], zs, ks_np, ells,
                                       ("omch2", "As"), 1e-3, dev)
    theta0 = torch.tensor([1.04, 1.08], dtype=torch.float64, device=dev)

    def two_steps(step=step, model=model):
        data = model(torch.ones(2, dtype=torch.float64, device=dev))
        t1, l0 = step(theta0, data)
        t2, l1 = step(t1, data)
        return torch.stack([l0, l1]), torch.stack([t1, t2])

    losses, thetas = entry("fisher", two_steps, {})
    losses_u, thetas_u = two_steps(step_u, model_u)
    e = max(rel_max(losses, losses_u), rel_max(thetas, thetas_u))
    check(bool(torch.isfinite(losses).all()) and losses[1] <= losses[0]
          and e <= GATE_SHARD_FISHER, f"sharded Fisher steps: losses "
          f"{losses.tolist()}, {e!r} vs the unsharded step")
    print(f"[sharded] two Fisher steps (config 4's {ells.size} ells) on "
          f"{tag}: losses {losses.tolist()}, theta and loss vs the unsharded "
          f"autograd step {e!r} (gate {GATE_SHARD_FISHER})")
    timed("fisher", two_steps, lambda: two_steps(step_u, model_u), n_t=3)

    # 3. data-parallel batches against make_batched_fn on one card
    theta_e = ref.gb["theta_b16"][[0, 5, 10, 15]]
    batches = {
        "bN": (*ref.batch["bN"], "nfw_uk_fast", "nfw_uk"),
        "bNf": (*ref.batch["bNf"], "nfw_contract", "nfw_contract"),
        "b16_exact": (*ref.batch["b16_exact"], "nfw_uk_exact", "nfw_uk"),
        "electron_fast": (ref.efns["electron_fast"], theta_e,
                          pl.make_batched_fn(ref.efns["electron_fast"],
                                             ref.names_b)(theta_e),
                          "pair_lerp_f32", "pair_lerp"),
    }
    for line, (fn1, theta, want, kernel, rec) in batches.items():
        sb = tsh.make_sharded_batched_fn(fn1, ref.names_b, mesh)
        counts_want = {kernel: n, "catmull_fill": n * FILLS.get(line, 0)}
        if line == "electron_fast":
            counts_want["nfw_uk_fast"] = n
        got = entry(line, lambda: sb(theta), counts_want,
                    record=(rec, "catmull_fill") if line in FILLS else
                    (rec,) if line != "electron_fast" else
                    ("pair_lerp", "nfw_uk"))
        e_row = max(rel_max(g_, w_) for g_, w_ in zip(
            got if isinstance(got, tuple) else (got,),
            want if isinstance(want, tuple) else (want,)))
        check(e_row <= GATE_BATCH_VS_SINGLE, f"sharded {line}: {e_row!r}")
        msg = ""
        if line in ("bN", "bNf"):
            rows_g = ref.gb["rows_bN"]
            e_gold = rel_max(got[torch.as_tensor(rows_g, device=dev)],
                             torch.as_tensor(ref.gb["pmm_bN"], device=dev))
            check(e_gold <= 1e-5, f"sharded {line} rows vs golden: "
                  f"{e_gold!r}")
            msg = f", rows {rows_g.tolist()} vs golden {e_gold!r} (gate 1e-5)"
        print(f"[sharded] {line} (B = {len(theta)}) on {tag}: every row vs "
              f"make_batched_fn on one card {e_row!r} (gate "
              f"{GATE_BATCH_VS_SINGLE}){msg}")
        ub = pl.make_batched_fn(fn1, ref.names_b)
        timed(line, lambda: sb(theta), lambda: ub(theta))
        del got, sb
    torch.cuda.empty_cache()

    # 4. Pgg, Pge, Pee with the mass axis sharded, against the class API;
    # 6. the bispectrum with the quadratic-bias term
    def build():
        hm = HaloModel(zs, ks_np, ms=ms, device=dev)
        hm.add_battaglia_profile("e", family="AGN", nxs=SHARD_NXS, xmax=20.0)
        hm.add_hod("g", ngal=ref.gh["ngal"])
        return hm

    hm = build()
    kq = np.geomspace(5e-3, 2.0, 10)
    sge = tsh.make_sharded_galaxy_electron_fn(zs, ks_np, ms, ref.gh["ngal"],
                                              mesh, nxs=SHARD_NXS, xmax=20.0)
    got = entry("galaxy_electron", lambda: sge({}), {"pair_lerp_f64": n},
                record=("pair_lerp",))
    e = max(rel_max(g_, hm.get_power(*names)) for g_, names in zip(
        got, (("g",), ("g", "e"), ("e",))))
    check(e <= GATE_SHARD_GE, f"sharded galaxy x electron: {e!r}")
    print(f"[sharded] Pgg, Pge, Pee ({zs.size} x {ms.size} x {ks_np.size}, "
          f"nxs {SHARD_NXS}) on {tag}: vs HaloModel on the card {e!r} (gate "
          f"{GATE_SHARD_GE})")
    timed("galaxy_electron", lambda: sge({}), lambda: [
        h.get_power(*names) for h in [build()]
        for names in (("g",), ("g", "e"), ("e",))])
    sbis = tsh.make_sharded_matter_bispectrum_fn(
        zs, ks_np, ms, kq, 1.3 * kq, 1.8 * kq, mesh, include_b2=True)
    got = entry("bispectrum", lambda: sbis({}), {})
    want = hm.get_bispectrum(kq, 1.3 * kq, 1.8 * kq, include_b2=True)
    e = rel_max(got, want)
    check(e <= GATE_SHARD_GE, f"sharded bispectrum: {e!r}")
    print(f"[sharded] the matter bispectrum with b2 (config 1's grid, 10 "
          f"triangles) on {tag}: vs HaloModel.get_bispectrum {e!r} (gate "
          f"{GATE_SHARD_GE})")
    timed("bispectrum", lambda: sbis({}), lambda: HaloModel(
        zs, ks_np, ms=ms, device=dev).get_bispectrum(
        kq, 1.3 * kq, 1.8 * kq, include_b2=True))
    del hm, got, want
    torch.cuda.empty_cache()

    # 5. the four-bin kSZ survey, a bin a slot
    gk = ref.gk
    ssv = tsh.make_sharded_ksz_survey_fn(
        gk["zcents"].size, mesh, ms=gk["ms"], nxs=int(gk["survey_nxs"]),
        xmax=float(gk["xmax"]), growth="closed", **ref.kcfg)
    args = (gk["zcents"], gk["vols_gpc3"], gk["ngals"], ref.cls_k)
    bs = np.linspace(1.5, 3.0, gk["zcents"].size)
    ov = ref.cosmos_k[0]

    def both(fn):
        return fn(ov, *args), fn(ov, *args, bs=bs)

    got = entry("survey", lambda: both(ssv),
                {"pair_lerp_f64": 2 * gk["zcents"].size}, record=("pair_lerp",))
    want = both(ref.survey_fn)
    e = max(rel_max(g_, w_) for gs_, ws_ in zip(got, want)
            for g_, w_ in zip(gs_, ws_))
    check(e <= GATE_KSZ, f"sharded survey: {e!r}")
    print(f"[sharded] the four-bin kSZ survey, with and without bs, on "
          f"{tag}: vs make_ksz_survey_fn(4) {e!r} (gate {GATE_KSZ})")
    timed("survey", lambda: ssv(ov, *args), lambda: ref.survey_fn(ov, *args),
          n_t=3)

    # 7. the Boltzmann hierarchy over k on get_cmb_cls()'s grid (lmax
    # 3,000 solves at 3,400), then the Bessel projection over its l nodes
    bg = bgmod.background(merge_params({}), dev)
    lpad = 3400

    def solve():
        ctx = tbl.make_ctx(bg, trec.recombination(bg))
        ks, _, n_c = tbl._cls_grid(lpad, float(ctx.eta0), float(bg.H0))
        mk = tsh.make_mesh(devices=mesh.devices, axis_name="k")
        return ctx, ks, n_c, tsh.sharded_solve_perturbations(
            ctx, ks, mk, n_c_inner=n_c)

    ctx, ks_b, n_c, sol = entry(
        "solve", solve, {"recomb_rk4": 1, "hierarchy_rk4": 3 * n + 1},
        record=("hierarchy_rk4",))
    sol_u = tbl.solve_perturbations(ctx, ks_b, n_c_inner=n_c)
    check(torch.equal(sol.states, sol_u.states.to(sol.states.device))
          and torch.equal(sol.xs, sol_u.xs)
          and torch.equal(sol.zeta_unit, sol_u.zeta_unit),
          "the k-sharded solve equals the unsharded one bit for bit")
    print(f"[sharded] sharded_solve_perturbations ({ks_b.size} k, padded to "
          f"a multiple of {n}, n_c_inner {n_c}) on {tag}: states "
          f"{tuple(sol.states.shape)}, x grid and zeta_unit equal to the "
          f"unsharded solve bit for bit")
    mk = tsh.make_mesh(devices=mesh.devices, axis_name="k")
    timed("solve", lambda: tsh.sharded_solve_perturbations(
        ctx, ks_b, mk, n_c_inner=n_c),
        lambda: tbl.solve_perturbations(ctx, ks_b, n_c_inner=n_c), n_t=3)
    src = tbl.compute_sources(ctx, sol_u)
    _, ks_fine, _ = tbl._cls_grid(lpad, float(ctx.eta0), float(bg.H0))
    l_nodes = tbl.default_l_nodes(lpad)
    got = entry("cls", lambda: tsh.sharded_cls_from_sources(
        src, bg, l_nodes, ks_fine, mk), {})
    want = tbl.cls_from_sources(src, bg, l_nodes, ks_fine)
    e = max(to_max(got[k], want[k]) for k in ("tt", "ee", "te"))
    check(e <= GATE_SHARD_CLS, f"sharded C_l: {e!r}")
    print(f"[sharded] sharded_cls_from_sources ({l_nodes.size} l nodes to "
          f"{lpad}, {ks_fine.size} fine k) on {tag}: vs cls_from_sources "
          f"{e!r} of each spectrum's largest value (gate "
          f"{GATE_SHARD_CLS}), bit for bit "
          f"{all(torch.equal(got[k], want[k]) for k in ('tt', 'ee', 'te'))}")
    timed("cls", lambda: tsh.sharded_cls_from_sources(
        src, bg, l_nodes, ks_fine, mk),
        lambda: tbl.cls_from_sources(src, bg, l_nodes, ks_fine), n_t=3)
    del sol, sol_u, src, got, want
    torch.cuda.empty_cache()

    # 8. the data-parallel emulator fit against the emulator phase's fit
    em = ref.emulator
    t0 = time.perf_counter()
    em_s, info_s = entry("fit", lambda: tem.fit_emulator(
        em["target"], em["lo"], em["hi"], steps=em["steps"],
        init_net=em["init"], mesh=mesh, **em["fit"]), {})
    for d in mesh.distinct():
        torch.cuda.synchronize(d)
    t_fit = (time.perf_counter() - t0) * 1e3
    e_loss = abs(float(info_s["losses"][-1]) / float(em["info"]["losses"][-1])
                 - 1.0)
    with torch.no_grad():
        e_pred = rel_max(em_s(em["val"]), em["em"](em["val"]))
    check(e_loss <= 1e-3 and e_pred <= 2e-3,
          f"sharded fit: final loss {e_loss!r}, predictions {e_pred!r}")
    stats["fit"] = {"ms": t_fit, "unsharded_ms": em["ms"],
                    "launches": launches["fit"]}
    print(f"[sharded] fit_emulator(mesh=) ({em['steps']} float32 steps, "
          f"n_train {em['fit']['n_train']}) on {tag}: final loss vs the "
          f"unsharded fit {e_loss!r} (gate 1e-3), held-out predictions "
          f"{e_pred!r} (gate 2e-3); {t_fit!r} ms, one call with its training "
          f"set (host clock; the unsharded fit {em['ms']!r} ms) ({card})")

    if kernel_rows is not None:
        t0 = time.perf_counter()
        shard_kernel_rows(records, launches, kernel_rows, card)
        print(f"[sharded] the kernels at the shard shapes: section "
              f"{time.perf_counter() - t0:.1f} s")
    print(f"[sharded] the phase on {tag}: "
          f"{time.perf_counter() - t_phase:.1f} s (host clock)")
    return launches, stats


def shard_kernel_rows(records, launches, rows, card):
    """Each kernel at the shard shapes the sharded calls gave it (slot 0's
    inputs of each call): its device time, bound and launches on the
    sharded path, into rows[kernel]."""
    from hmvec_tpu_torch.ops import boltz_kernels as bk
    from hmvec_tpu_torch.ops import nfw_kernels as nk
    from hmvec_tpu_torch.ops import resample_kernels as rk

    def add(name, shape, t_ms, nbytes, ops, line):
        b_ms, b_by = bound(nbytes, ops)
        rows[name].append({"line": f"sharded {line}", "shape": shape,
                           "ms": t_ms, "bound_ms": b_ms, "bound_by": b_by,
                           "launches": launches[line][name]})
        print(f"[time] {name} at the shard shape of sharded {line}, {shape}: "
              f"{t_ms!r} ms, bound {b_ms!r} ms by {b_by}, time / bound "
              f"{t_ms / b_ms!r}; {launches[line][name]} launches on the "
              f"path ({card})")

    seen = set()
    for ks, s_, c_, tier in records["nfw_uk"]:
        name = "nfw_uk_exact" if tier == "exact" else "nfw_uk_fast"
        key = (name, s_.numel(), ks.numel())
        if key in seen:
            continue
        seen.add(key)
        line = "b16_exact" if tier == "exact" else (
            "bN" if ks.numel() < 1001 else "electron_fast")
        add(name, f"{s_.numel()} x {ks.numel()}",
            device_ms(lambda: getattr(nk, name)(ks, s_, c_)),
            8 * (ks.numel() + 2 * s_.numel())
            + (8 if tier == "exact" else 4) * s_.numel() * ks.numel(),
            nfw_ops(ks, s_, c_, tier), line)
    ks, s_, c_, a_, b_ = records["nfw_contract"][0][:5]
    ops = nfw_ops(ks, s_, c_, "fast")
    ops["f64"] += 5 * s_.numel() * ks.numel() + 2 * 8 * s_.shape[0] * ks.numel()
    add("nfw_contract", f"{s_.shape[0]} x {s_.shape[1]} x {ks.numel()}",
        device_ms(lambda: nk.nfw_contract(ks, s_, c_, a_, b_)),
        8 * (ks.numel() + 4 * s_.numel()) + 16 * s_.shape[0] * ks.numel(),
        ops, "bNf")
    for u, s_, ks, dkt in records["pair_lerp"]:
        key = ("lerp", u.dtype, s_.numel(), u.shape[-1], ks.numel())
        if key in seen:
            continue
        seen.add(key)
        f64 = u.dtype == torch.float64
        name = "pair_lerp_f64" if f64 else "pair_lerp_f32"
        line = ("electron_fast" if not f64 else
                "survey" if ks.numel() < 1001 else "galaxy_electron")
        add(name, f"{s_.numel()} x {u.shape[-1]} kt -> {ks.numel()} k",
            device_ms(lambda: getattr(rk, name)(u, s_, ks, dkt)),
            *pair_lerp_work(u, s_, ks, dkt), line)
    for y, tap_i, tap_w in records["catmull_fill"]:
        key = ("fill", y.dtype, y.numel())
        if key in seen:
            continue
        seen.add(key)
        rows_y, nk = y.numel() // y.shape[-1], tap_i.shape[1]
        add("catmull_fill", f"{rows_y} x {y.shape[-1]} -> {nk} ({y.dtype})",
            device_ms(lambda: rk.catmull_fill(y, tap_i, tap_w)),
            *fill_work(y, tap_i), "bN" if y.dtype == torch.float32 else "bNf")
    segs = []
    n7, ops7 = 0, 0
    for a in records["hierarchy_rk4"]:
        t_k = event_ms(lambda a=a: bk.hierarchy_rk4(*a), n=3, warmup=1)
        nb, ops, _ = hierarchy_work(bk, *a[:2], *a[5:8])
        n7, ops7 = n7 + nb, ops7 + ops["f64"]
        segs.append({"rows": int(a[1].numel()), "steps": a[5] * a[6],
                     "ms": t_k})
    b_ms, b_by = bound(n7, {"f64": ops7})
    t_sum = sum(s["ms"] for s in segs)
    rows["hierarchy_rk4"].append({
        "line": "sharded solve", "shape": f"{len(segs)} launches, rows "
        f"{[s['rows'] for s in segs]}", "segments": segs, "ms": t_sum,
        "bound_ms": b_ms, "bound_by": b_by,
        "launches": launches["solve"]["hierarchy_rk4"]})
    print(f"[time] hierarchy_rk4 at the k-shard shapes of the sharded "
          f"solve: {segs}; {t_sum!r} ms over the {len(segs)} launches (CUDA "
          f"events, medians of 3), bound {b_ms!r} ms by {b_by} ({card})")


def rel_max(got, want):
    """Max |got / want - 1| over every element (tensors, want moved to
    got's device)."""
    return (got.double() / want.to(got.device).double() - 1.0).abs().max(
        ).item()


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
    from hmvec_tpu_torch.ops import boltz_kernels as bk

    modules = {"nfw_kernels": nk, "resample_kernels": rk,
               "boltz_kernels": bk}
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
    sass = sass_counts(sass)
    for name, regions in sorted(sass.items()):
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
    # more redshifts than gridDim.y's 65,535 (C13): scales and
    # concentrations drawn log-uniform over config 1's ranges, positive
    # weights; the plain version in slices of 2,000 redshifts
    gen = torch.Generator(device=dev).manual_seed(13)

    def log_uniform(t, shape):
        lo, hi = math.log(t.min().item()), math.log(t.max().item())
        return torch.exp(lo + (hi - lo) * torch.rand(
            shape, generator=gen, device=dev, dtype=torch.float64))

    k_c13 = torch.exp(torch.linspace(math.log(ks_np[0]), math.log(ks_np[-1]),
                                     C13_NK, dtype=torch.float64, device=dev))
    s_c13 = log_uniform(scales, (C13_NZ, C13_NM))
    c_c13 = log_uniform(cs, (C13_NZ, C13_NM))
    a_c13, b_c13 = (torch.rand((C13_NZ, C13_NM), generator=gen, device=dev,
                               dtype=torch.float64) for _ in range(2))
    got_c13 = nk.nfw_contract(k_c13, s_c13, c_c13, a_c13, b_c13)
    torch.cuda.synchronize()
    ref_c13 = [torch.cat(x) for x in zip(*(
        nk.nfw_contract_plain(k_c13, *cut) for cut in zip(
            *(t.split(2000) for t in (s_c13, c_c13, a_c13, b_c13)))))]
    rel_c13 = max(((x - y).abs() / y.abs()).max().item()
                  for x, y in zip(got_c13, ref_c13))
    check(rel_c13 <= GATE_CONTRACT_REL, f"nfw_contract at {C13_NZ} "
          f"redshifts: rel err {rel_c13!r}")
    err["nfw_contract_c13"] = rel_c13
    print(f"[kernel] nfw_contract vs nfw_contract_plain at {C13_NZ} "
          f"redshifts (more than gridDim.y's 65,535; z on gridDim.x) x "
          f"{C13_NM} m x {C13_NK} k: max rel err {rel_c13!r} (gate "
          f"{GATE_CONTRACT_REL})")
    del s_c13, c_c13, a_c13, b_c13, got_c13, ref_c13

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
    edges = list(lerp_edge_cases(dev))
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
            check(e <= GATE_LERP and torch.equal(got, ref),
                  f"{name} on {case}: {e!r} > {GATE_LERP}")
            if case == "config2":
                err[name] = e
            print(f"[kernel] {name} vs pair_lerp_plain on {case} "
                  f"{tuple(args[0].shape)} -> {args[2].numel()} k: "
                  f"max abs err {e!r} (gate {GATE_LERP})")
        # the edge cases, bit for bit, one launch each, and a vmapped call
        # over a leading batch of 5 (one launch for the batch)
        n_edge = 0
        for case, (u_c, s_c, k_c, dkt_c) in edges:
            args = (u_c.to(dtype), s_c, k_c, dkt_c)
            n0 = wrappers[name].launches
            got = wrappers[name](*args)
            torch.cuda.synchronize()
            check(wrappers[name].launches == n0 + 1
                  and torch.equal(got, rk.pair_lerp_plain(*args)),
                  f"{name} on the edge case {case}: one launch, bit for bit")
            n_edge += 1
        u_v = torch.stack([u_adv[0] + i for i in range(5)]).to(dtype)
        n0 = wrappers[name].launches
        got = torch.func.vmap(
            lambda a: wrappers[name](a, s_adv[0], k_adv, dkt_adv))(u_v)
        torch.cuda.synchronize()
        check(wrappers[name].launches == n0 + 1 and torch.equal(
            got, torch.stack([rk.pair_lerp_plain(a, s_adv[0], k_adv, dkt_adv)
                              for a in u_v])),
              f"{name} under vmap: one launch, bit for bit")
        # offsets into u past 2^31 elements: the 64-bit instantiation,
        # held 2^17 rows at a time
        u_w, s_w, k_w, dkt_w = lerp_wide_case(dev, dtype)
        n0 = wrappers[name].launches
        got = wrappers[name](u_w, s_w, k_w, dkt_w)
        torch.cuda.synchronize()
        check(wrappers[name].launches == n0 + 1 and all(
            torch.equal(got[a:a + 2**17], rk.pair_lerp_plain(
                u_w[a:a + 2**17], s_w[a:a + 2**17], k_w, dkt_w))
            for a in range(0, u_w.shape[0], 2**17)),
              f"{name} past 32-bit offsets {tuple(u_w.shape)} -> "
              f"{k_w.numel()} k: one launch, bit for bit")
        del u_w, s_w, got
        torch.cuda.empty_cache()
        print(f"[kernel] {name} vs pair_lerp_plain on {n_edge} edge cases "
              f"(nk 1-4,097 x rows 1-4,001, nkt 3-40,001, positions on 1 "
              f"and nkt - 1, unsorted and repeated targets, a (2, 3) batch), "
              f"a vmapped call over 5 tables and a table of 1,048,128 x "
              f"2,049 (offsets past 2^31): equal bit for bit, one launch "
              f"each")

    # the serving path's Catmull-Rom fill (F1) on the serving taps at the
    # shapes of the bN line's u cube (B x nz x nm rows, float32) and of one
    # of the bNf line's two sums (B x nz rows, float64), bit for bit, one
    # launch each, then timed with its bound
    n_batch = np.load(GOLDEN_B)["theta_bN"].shape[0]
    grids_s = pl._Grids(zs, ks_np, ms, merge_params(),
                        SERVING["uk_subsample"], dev)
    tap_i, tap_w = grids_s.taps
    nkq = grids_s.kq.numel()
    gen_f = torch.Generator(device=dev).manual_seed(20)

    def fill_equal(y, i_, w_):
        n0 = wrappers["catmull_fill"].launches
        got = wrappers["catmull_fill"](y, i_, w_)
        torch.cuda.synchronize()
        want = rk.catmull_fill_plain(y, i_, w_)
        return (wrappers["catmull_fill"].launches == n0 + int(y.numel() > 0)
                and got.dtype == torch.float64 and got.shape == want.shape
                and torch.equal(got.view(torch.int64),
                                want.view(torch.int64)))

    fill_rows = []
    for line, rows_f, dtype in (("bN", n_batch * zs.size * ms.size,
                                 torch.float32),
                                ("bNf", n_batch * zs.size, torch.float64)):
        y = torch.rand((rows_f, nkq), generator=gen_f, device=dev).to(dtype)
        check(fill_equal(y, tap_i, tap_w), f"catmull_fill at {line}'s shape "
              f"{tuple(y.shape)} ({dtype}): one launch, bit for bit")
        torch.cuda.empty_cache()
        t_k = device_ms(lambda: rk.catmull_fill(y, tap_i, tap_w))
        t_p = device_ms(lambda: rk.catmull_fill_plain(y, tap_i, tap_w),
                        calls=2, replays=2)
        nbytes, ops = fill_work(y, tap_i)
        b_ms, b_by = bound(nbytes, ops)
        shape = f"{rows_f} x {nkq} -> {tap_i.shape[1]} ({dtype})"
        fill_rows.append({"line": line, "shape": shape, "max_err": 0.0,
                          "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms,
                          "bound_by": b_by})
        print(f"[kernel] catmull_fill vs catmull_fill_plain at {line}'s "
              f"shape {shape}: equal bit for bit; {t_k!r} ms, plain version "
              f"{t_p!r} ms (device time, CUDA-graph replays), bound "
              f"{b_ms!r} ms by {b_by} ({nbytes} bytes), time / bound "
              f"{t_k / b_ms!r} ({card})")
        del y
        torch.cuda.empty_cache()
    # the edges: 0 and 1 row, rows not a multiple of a block's 4, a batch
    # of rows, nk not a multiple of the block and over one column tile of
    # 1,024, rows of y off a 16-byte boundary, and nkq whose 4 rows are
    # more than a block stages (the gathers then read device memory)
    fill_cases = [((0, nkq), tap_i, tap_w), ((1, nkq), tap_i, tap_w),
                  ((4001, nkq), tap_i, tap_w), ((3, 7, nkq), tap_i, tap_w)]
    for nk_e, nkq_e, rows_e in ((257, 100, 9), (2049, 37, 13),
                                (1001, 8000, 11), (2049, 16000, 5)):
        i_e = torch.randint(0, nkq_e, (4, nk_e), generator=gen_f, device=dev)
        w_e = torch.randn((4, nk_e), generator=gen_f, dtype=torch.float64,
                          device=dev)
        fill_cases.append(((rows_e, nkq_e), i_e.to(torch.int32), w_e))
    for dtype in (torch.float32, torch.float64):
        for shape, i_e, w_e in fill_cases:
            y = torch.randn(shape, generator=gen_f, device=dev).to(dtype)
            check(fill_equal(y, i_e, w_e), f"catmull_fill on {shape} -> "
                  f"{i_e.shape[1]} ({dtype}): one launch, bit for bit")
        y = torch.randn((6 * nkq + 1,), generator=gen_f,
                        device=dev).to(dtype)[1:].view(6, nkq)
        check(y.data_ptr() % 16 != 0 and fill_equal(y, tap_i, tap_w),
              f"catmull_fill on rows off a 16-byte boundary ({dtype})")
        y_v = torch.rand((5, 3, nkq), generator=gen_f, device=dev).to(dtype)
        n0 = wrappers["catmull_fill"].launches
        got = torch.func.vmap(
            lambda a: wrappers["catmull_fill"](a, tap_i, tap_w))(y_v)
        torch.cuda.synchronize()
        check(wrappers["catmull_fill"].launches == n0 + 1 and torch.equal(
            got, rk.catmull_fill_plain(y_v, tap_i, tap_w)),
            f"catmull_fill under vmap ({dtype}): one launch, bit for bit")
    print(f"[kernel] catmull_fill vs catmull_fill_plain on "
          f"{len(fill_cases) + 2} edge cases a storage type (0, 1, 4,001 "
          f"rows, a (3, 7) batch, nk 257-2,049, nkq 37-16,000, rows off a "
          f"16-byte boundary, a vmapped call over 5): equal bit for bit, one "
          f"launch each")
    del grids_s, fill_cases, y, y_v, got
    torch.cuda.empty_cache()

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
    batch_keep = {}   # (fn, theta, float64 batch) of the lines the sharded
    # phase serves again
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
        want_kernels["catmull_fill"] = FILLS.get(line, 0)
        check(launches[line] == want_kernels,
              f"{line}: one launch of {kernel} and {FILLS.get(line, 0)} of "
              f"catmull_fill for the whole batch, got {launches[line]}")
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
        if line in ("bN", "bNf", "b16_exact"):
            batch_keep[line] = (fn1, theta_np, out64)
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

    # ---- phase 4g: the class API ------------------------------------------
    from hmvec_tpu_torch import HaloModel, get_ksz_snr

    gc = np.load(GOLDEN_C)
    for key in ("zs", "ks", "ms"):
        check(np.array_equal(g[key], gc[key]), f"golden files share {key}")
    cosmo_c = dict(zip(gc["param_names"].tolist(),
                       map(float, gc["param_values"])))
    check(cosmo_c == cosmos[0], "the class golden file is at the bench "
          "cosmology")

    def build_class():
        """The README's example at bench width, with its fast NFW profile."""
        hm = HaloModel(zs, ks_np, ms=ms, params=cosmo_c, device=dev)
        hm.add_battaglia_profile("e", family="AGN")
        hm.add_battaglia_pres_profile("y")
        hm.add_hod("g", ngal=gc["ngal"])
        hm.add_nfw_profile("nfw_fast", fast=True)
        return hm

    # the main path of the phase: counts set to 0 just before, read after
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    with recorded(rk, "_launch") as b4_in_c:
        hm = build_class()
    torch.cuda.synchronize()
    launches["class"] = read_counts()
    class_peak = torch.cuda.max_memory_allocated(dev) / 2**20
    want_class = {name: {"nfw_uk_fast": 1, "pair_lerp_f64": 2}.get(name, 0)
                  for name in wrappers}
    check(launches["class"] == want_class,
          f"class build: one nfw_uk_fast launch and one pair_lerp_f64 per "
          f"numeric profile (2), got {launches['class']}")
    spectra = {key: hm.get_power(*names)
               for key, names in CLASS_SPECTRA.items()}
    spectra["pmm_fast"] = hm.get_power("nfw_fast")
    torch.cuda.synchronize()
    for key, out in spectra.items():
        want = gc[key.replace("_fast", "")]
        gate = GATE_CLASS_FAST if key.endswith("_fast") else GATE_CLASS
        check(out.is_cuda and out.dtype == torch.float64
              and out.shape == want.shape
              and bool(torch.isfinite(out).all()), f"class {key} output")
        e = float(np.max(np.abs(out.cpu().numpy() / want - 1.0)))
        check(e <= gate, f"class {key} vs golden: {e!r} > {gate}")
        print(f"[class] README example {key} at 20x200x1001: max rel err vs "
              f"the JAX class's golden {e!r} (gate {gate})")
    print(f"[class] build launches {launches['class']}")
    # the class's own kernel inputs: B1's rows and B4a's gas table
    cs_c = hm.concentration()
    rss_c = hm.rvir(hm.ms[None, :], hm.zs[:, None]) / cs_c
    s_c = (rss_c * (1.0 + hm.zs)[:, None]).reshape(-1).contiguous()
    c_c = cs_c.reshape(-1).contiguous()
    u_b1 = nk.nfw_uk_fast(hm.ks, s_c, c_c)
    torch.cuda.synchronize()
    e_b1 = (u_b1.double() - nk.nfw_uk_plain(hm.ks, s_c, c_c)).abs().max()
    e_b1 = e_b1.item()
    check(e_b1 <= GATE_UK["fast"], f"nfw_uk_fast at the class's rows: {e_b1!r}")
    check(torch.equal(u_b1.reshape(hm.uk_profiles["nfw_fast"].shape)
                      .to(torch.float64), hm.uk_profiles["nfw_fast"]),
          "the class's fast profile is the kernel's output")
    nxs_e = int(hm.p["electron_density_profile_integral_numxs"])
    xmax_e = float(hm.p["electron_density_profile_integral_xmax"])
    u_e, s_e, k_e, dkt_e = pl.electron_stage_inputs(
        zs, ks_np, ms, cosmo_c, device=dev, nxs=nxs_e, xmax=xmax_e)
    got_e = rk.pair_lerp_f64(u_e, s_e, k_e, dkt_e)
    torch.cuda.synchronize()
    e_b4 = (got_e - rk.pair_lerp_plain(u_e, s_e, k_e, dkt_e)).abs().max()
    e_b4 = e_b4.item()
    check(e_b4 <= GATE_LERP, f"pair_lerp_f64 at the class's gas table: "
          f"{e_b4!r}")
    e_tab = ((got_e - hm.uk_profiles["e"]).abs().max()
             / got_e.abs().max()).item()
    check(e_tab <= 1e-12, f"the class's gas profile vs the pipeline's "
          f"table through the kernel: {e_tab!r}")
    # both tables the build resampled (gas, then pressure, which the
    # covariance group reads), against the plain version at the build's
    # own inputs
    e_b4_build = []
    for args in b4_in_c:
        e_b4_build.append((rk.pair_lerp_f64(*args) - rk.pair_lerp_plain(*args))
                          .abs().max().item())
        check(e_b4_build[-1] <= GATE_LERP, f"pair_lerp_f64 at a table of the "
              f"class build: {e_b4_build[-1]!r}")
    e_b4 = max(e_b4, *e_b4_build)
    print(f"[class] nfw_uk_fast vs nfw_uk_plain at the class's "
          f"{s_c.numel()} x {hm.ks.numel()}: max abs err {e_b1!r} (gate "
          f"{GATE_UK['fast']}); pair_lerp_f64 vs pair_lerp_plain at the gas "
          f"table {tuple(u_e.shape)} -> {k_e.numel()} k: max abs err "
          f"{e_b4!r} (gate {GATE_LERP}), at the build's gas and pressure "
          f"tables {e_b4_build!r}; the class's gas profile within "
          f"{e_tab!r} of that resample (relative to its largest value)")
    # the class kSZ forecast at config 5 (the ksz phase's widths)
    cos_k0 = cosmos_k[0]
    reset_counts()
    snr_c, fksz = get_ksz_snr(
        float(gk["volume_gpc3"]), float(gk["z"]), float(gk["ngal_mpc3"]),
        gk["cls"], params=cos_k0, ms=gk["ms"],
        electron_profile_nxs=int(gk["nxs"]),
        electron_profile_xmax=float(gk["xmax"]), device=dev, **kcfg)
    nvv_c = fksz.Nvv(0, gk["cls"])
    torch.cuda.synchronize()
    launches["class_ksz"] = read_counts()
    check(launches["class_ksz"] == one_lerp,
          f"class kSZ: one pair_lerp_f64 launch, got {launches['class_ksz']}")
    snr_f, nvv_f, vrec_f = kfn(cos_k0, cls_t)
    for key, got, fn_v, gold in (
            ("snr", snr_c, snr_f, gk["snr"][0]),
            ("nvv", nvv_c, nvv_f, gk["nvv"][0]),
            ("vrec", fksz.vrec, vrec_f, gk["vrec"][0])):
        check(got.is_cuda and bool(torch.isfinite(got).all())
              and got.shape == fn_v.shape, f"class ksz {key} output")
        e_fn = (got / fn_v - 1.0).abs().max().item()
        e_gold = float(np.max(np.abs(got.cpu().numpy() / gold - 1.0)))
        check(e_fn <= GATE_KSZ_CLASS_VS_FN,
              f"class ksz {key} vs make_ksz_snr_fn: {e_fn!r}")
        check(e_gold <= GATE_KSZ, f"class ksz {key} vs golden: {e_gold!r}")
        print(f"[class] get_ksz_snr {key}: max rel diff vs make_ksz_snr_fn "
              f"{e_fn!r} (gate {GATE_KSZ_CLASS_VS_FN}), vs golden {e_gold!r} "
              f"(gate {GATE_KSZ})")
    del fksz, spectra
    # latency, launches, host reads and peak memory of the build and of
    # each spectrum
    n_b, sync_b = traced(build_class)
    t_build = host_ms(build_class, n=10, warmup=1)
    class_stats = {"build": {"ms": t_build, "launches": n_b,
                             "host_reads": sync_b, "peak_mib": class_peak}}
    print(f"[time] class build (HaloModel + 4 profiles + HOD) at "
          f"20x200x1001: {t_build!r} ms (host clock to synchronize, median "
          f"of 10), {n_b} launches and {sync_b} host reads (torch.profiler), "
          f"peak {class_peak:.1f} MiB allocated ({card})")
    for key, names in {**CLASS_SPECTRA, "pmm_fast": ("nfw_fast", None)}.items():
        n_l, n_sync = traced(lambda: hm.get_power(*names))
        t_p = host_ms(lambda: hm.get_power(*names), n=10)
        class_stats[f"get_power {key}"] = {"ms": t_p, "launches": n_l,
                                           "host_reads": n_sync}
        print(f"[time] class get_power{names}: {t_p!r} ms (host clock to "
              f"synchronize, median of 10), {n_l} launches and {n_sync} host "
              f"reads (torch.profiler) ({card})")
    ksz_build = lambda: get_ksz_snr(
        float(gk["volume_gpc3"]), float(gk["z"]), float(gk["ngal_mpc3"]),
        gk["cls"], params=cos_k0, ms=gk["ms"],
        electron_profile_nxs=int(gk["nxs"]),
        electron_profile_xmax=float(gk["xmax"]), device=dev, **kcfg)
    n_k, sync_k = traced(ksz_build)
    t_k = host_ms(ksz_build, n=10, warmup=1)
    class_stats["get_ksz_snr"] = {"ms": t_k, "launches": n_k,
                                  "host_reads": sync_k}
    print(f"[time] class get_ksz_snr at config 5: {t_k!r} ms (host clock to "
          f"synchronize, median of 10), {n_k} launches and {sync_k} host "
          f"reads (torch.profiler) ({card})")
    # both kernels at the class's shapes: device time, plain version,
    # torch.gather of the same samples (B4a), bound
    t_b1 = device_ms(lambda: nk.nfw_uk_fast(hm.ks, s_c, c_c))
    tp_b1 = device_ms(lambda: nk.nfw_uk_plain(hm.ks, s_c, c_c))
    b1_bytes = (8 * (hm.ks.numel() + 2 * s_c.numel())
                + 4 * s_c.numel() * hm.ks.numel())
    b1_ms, b1_by = bound(b1_bytes, nfw_ops(hm.ks, s_c, c_c, "fast"))
    t_b4 = device_ms(lambda: rk.pair_lerp_f64(u_e, s_e, k_e, dkt_e))
    tp_b4 = device_ms(lambda: rk.pair_lerp_plain(u_e, s_e, k_e, dkt_e))
    i0_e = torch.floor(k_e * s_e.reshape(-1)[:, None] / dkt_e).clamp(
        1, u_e.shape[-1] - 2).long()
    idx_e = torch.cat([i0_e, i0_e + 1], dim=1)
    u2_e = u_e.reshape(-1, u_e.shape[-1])
    tg_b4 = device_ms(lambda: torch.gather(u2_e, 1, idx_e))
    b4_bytes, b4_ops = pair_lerp_work(u_e, s_e, k_e, dkt_e)
    b4_ms, b4_by = bound(b4_bytes, b4_ops)
    class_rows = {
        "nfw_uk_fast": {"shape": f"{s_c.numel()} x {hm.ks.numel()}",
                        "max_err": e_b1, "ms": t_b1, "plain_ms": tp_b1,
                        "bound_ms": b1_ms, "bound_by": b1_by,
                        "launches": launches["class"]["nfw_uk_fast"]},
        "pair_lerp_f64": {"shape": f"{s_e.numel()} x {u_e.shape[-1]} kt -> "
                                   f"{k_e.numel()} k",
                          "max_err": e_b4, "ms": t_b4, "plain_ms": tp_b4,
                          "gather_ms": tg_b4, "bound_ms": b4_ms,
                          "bound_by": b4_by,
                          "launches": launches["class"]["pair_lerp_f64"]},
    }
    for name, row in class_rows.items():
        print(f"[time] {name} at the class's shape {row['shape']}: "
              f"{row['ms']!r} ms (device time, CUDA-graph replays of 25 "
              f"calls), plain version {row['plain_ms']!r} ms"
              + (f", torch.gather of the 2 nk samples {row['gather_ms']!r} "
                 f"ms" if "gather_ms" in row else "")
              + f", bound {row['bound_ms']!r} ms by {row['bound_by']}, time "
              f"/ bound {row['ms'] / row['bound_ms']!r}; "
              f"{row['launches']} launches in the class build ({card})")
    # ---- phase 4h: covariances, cluster counts, bispectra, pairwise ------
    from hmvec_tpu_torch import angular_correlation, get_pairwise_ksz_snr

    t_phase_v = time.perf_counter()
    gv = np.load(GOLDEN_V)
    for key in ("zs", "ks", "ms", "ngal"):
        check(np.array_equal(gc[key], gv[key]), f"golden files share {key}")
    check(dict(zip(gv["param_names"].tolist(),
                   map(float, gv["param_values"]))) == cosmo_c,
          "the cov_bispectrum golden file is at the bench cosmology")
    scaling_v = dict(zip(("lnYstar", "alpha", "beta", "Mpivot", "sigma_lnY"),
                         map(float, gv["scaling"])))
    q_v, sn_v, fsky_v = map(float, gv["counts"])
    mmin_v, fsky_jv = map(float, gv["joint"])
    ells_v, rows_v, krows_v = gv["ells"], gv["rows"], gv["k_rows"]
    _, ngal_pw, vol_pw, smeas_pw, theta_pw = map(float, gv["pairwise"])
    iz_pw = int(gv["pairwise_iz"])
    vol_v = float(gv["volume_gpc3"])

    def pk_cov_parts(hm, name):
        """The golden file's reductions of get_pk_covariance: each block's
        diagonal and two k rows, at three z rows."""
        cov = hm.get_pk_covariance(vol_v, name)
        out = {}
        for key, block in cov.items():
            block = block[rows_v]
            out[f"pk_{key}_diag"] = torch.diagonal(block, dim1=1, dim2=2)
            out[f"pk_{key}_rows"] = block[:, krows_v]
        return out

    # each new entry point as the phase calls it
    cov_calls = {
        "get_cl_cov_t1h": lambda h: h.get_cl_cov_t1h(ells_v, "y"),
        "get_cl_cov_t1h yy x gg": lambda h: h.get_cl_cov_t1h(
            ells_v, "y", name3="g", name4="g"),
        "get_cl_cov_ssc": lambda h: h.get_cl_cov_ssc(ells_v, "y", fsky=0.4),
        "cluster_counts_obs": lambda h: h.cluster_counts_obs(
            q_v, sn_v, fsky=fsky_v, **scaling_v),
        "cluster_counts_q_bins": lambda h: h.cluster_counts_q_bins(
            gv["q_edges"], sn_v, fsky=fsky_v, z_edges=gv["z_edges"],
            **scaling_v),
        "cluster_counts_covariance": lambda h: h.cluster_counts_covariance(
            gv["z_edges"], fsky=fsky_v, q=q_v, sigma_noise=sn_v,
            **scaling_v),
        "joint_counts_cl_cov": lambda h: h.joint_counts_cl_cov(
            gv["z_edges"], ells_v, "y", mmin=mmin_v, fsky=fsky_jv),
        "get_pk_covariance": lambda h: pk_cov_parts(h, "nfw"),
        "get_pk_covariance nfw_fast": lambda h: pk_cov_parts(h, "nfw_fast"),
        "get_bispectrum": lambda h: h.get_bispectrum(),
        "get_bispectrum nfw_fast": lambda h: h.get_bispectrum(
            name="nfw_fast"),
        "get_bispectrum g, b2": lambda h: h.get_bispectrum(
            name="g", include_b2=True),
        "get_angular_bispectrum": lambda h: h.get_angular_bispectrum(
            ells_v, name="y"),
        "get_mean_compton_y": lambda h: h.get_mean_compton_y(),
        "get_tau_aperture": lambda h: h.get_tau_aperture(
            theta_arcmin=theta_pw),
        "get_pairwise_ksz_snr": lambda h: get_pairwise_ksz_snr(
            h, iz_pw, ngal_pw, vol_pw, smeas_pw, gv["r_edges"],
            theta_arcmin=theta_pw),
        "angular_correlation": lambda h: angular_correlation(
            gv["cf_ells"], h.C_yy(gv["cf_ells"], zs, ks_np,
                                  h.get_power("y")), gv["thetas"]),
    }

    def cov_outputs(res):
        """(name, output, golden, count bins of a joint matrix or None)."""
        zr = lambda x: x[rows_v]
        out = [("get_cl_cov_t1h y", res["get_cl_cov_t1h"], gv["t1h_yy"]),
               ("get_cl_cov_t1h yy x gg", res["get_cl_cov_t1h yy x gg"],
                gv["t1h_yy_gg"]),
               ("get_cl_cov_ssc y", res["get_cl_cov_ssc"], gv["ssc_yy"])]
        dndz, n_obs = res["cluster_counts_obs"]
        out += [("cluster_counts_obs dN/dz", dndz, gv["dndz_obs"]),
                ("cluster_counts_obs N", n_obs, gv["n_obs"]),
                ("cluster_counts_q_bins", res["cluster_counts_q_bins"],
                 gv["q_bins"])]
        for key, got in zip(("n_cov", "counts_cov"),
                            res["cluster_counts_covariance"]):
            out.append((f"cluster_counts_covariance {key}", got, gv[key]))
        n_joint, joint = res["joint_counts_cl_cov"]
        out += [("joint_counts_cl_cov n_joint", n_joint, gv["n_joint"]),
                ("joint_counts_cl_cov joint_cov", joint, gv["joint_cov"],
                 gv["n_joint"].size)]
        for name in ("get_pk_covariance", "get_pk_covariance nfw_fast"):
            out += [(f"{name} {key}", got, gv[key])
                    for key, got in res[name].items()]
        out += [("get_bispectrum nfw", zr(res["get_bispectrum"]),
                 gv["b_nfw"]),
                ("get_bispectrum nfw_fast",
                 zr(res["get_bispectrum nfw_fast"]), gv["b_nfw"]),
                ("get_bispectrum g, b2", zr(res["get_bispectrum g, b2"]),
                 gv["b_g_b2"]),
                ("get_angular_bispectrum y", res["get_angular_bispectrum"],
                 gv["b_ang_y"]),
                ("get_mean_compton_y", res["get_mean_compton_y"],
                 gv["mean_y"]),
                ("get_tau_aperture", res["get_tau_aperture"], gv["tau_ap"])]
        for key in ("snr", "T_bins", "sigma_bins", "tau_bar"):
            out.append((f"get_pairwise_ksz_snr {key}",
                        res["get_pairwise_ksz_snr"][key],
                        gv[f"pairwise_{key}"]))
        out.append(("angular_correlation of C_yy",
                    res["angular_correlation"], gv["w_yy"]))
        return [o if len(o) == 4 else (*o, None) for o in out]

    # the main path of the phase: the class phase's build (its launches
    # are those counted there), then the group's calls on it with the
    # counts set to 0 just before and read just after
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    res_v = {what: fn(hm) for what, fn in cov_calls.items()}
    cl_yy = hm.C_yy(gv["cf_ells"], zs, ks_np, hm.get_power("y"))
    torch.cuda.synchronize()
    launches["cov_bispectrum"] = read_counts()
    cov_peak = torch.cuda.max_memory_allocated(dev) / 2**20
    check(not any(launches["cov_bispectrum"].values()),
          f"the covariance group's calls launch no kernel: "
          f"{launches['cov_bispectrum']}")
    outs_v = cov_outputs(res_v) + [("C_yy", cl_yy, gv["cl_yy"], None)]
    for what, got, want, nb in outs_v:
        check(got.is_cuda and got.dtype == torch.float64
              and tuple(got.shape) == want.shape
              and bool(torch.isfinite(got).all()),
              f"cov_bispectrum {what} output")
        gate = GATE_COV_FAST if "nfw_fast" in what else GATE_COV
        g_np = got.cpu().numpy()
        e = close_err(g_np, want) if nb is None else joint_err(g_np, want, nb)
        check(e <= gate, f"cov_bispectrum {what} vs golden: {e!r} > {gate}")
        print(f"[cov_bispectrum] {what} {tuple(got.shape)}: max "
              f"{'rel err' if nb is None else 'rel err by block'} vs the "
              f"JAX class's golden {e!r} (gate {gate})")
    print(f"[cov_bispectrum] the class build's launches {launches['class']}, "
          f"the {len(cov_calls)} calls' {launches['cov_bispectrum']}; peak "
          f"{cov_peak:.1f} MiB allocated ({card})")
    del res_v, outs_v, cl_yy
    # latency, launches, host reads and peak memory of each entry point
    cov_stats = {}
    for what, fn in cov_calls.items():
        n_l, n_sync = traced(lambda: fn(hm))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t_v = host_ms(lambda: fn(hm), n=10, warmup=1)
        peak_v = torch.cuda.max_memory_allocated(dev) / 2**20
        cov_stats[what] = {"ms": t_v, "launches": n_l, "host_reads": n_sync,
                           "peak_mib": peak_v}
        print(f"[time] cov_bispectrum {what} at 20x200x1001: {t_v!r} ms "
              f"(host clock to synchronize, median of 10), {n_l} launches "
              f"and {n_sync} host reads (torch.profiler), peak "
              f"{peak_v:.1f} MiB allocated ({card})")
    print(f"[cov_bispectrum] the phase's wall time "
          f"{time.perf_counter() - t_phase_v:.1f} s (host clock)")

    # ---- phase 4h': exact C_ell, one loop, redshift space -----------------
    from hmvec_tpu_torch.models import nonlimber as nlm
    from hmvec_tpu_torch.ops.fftlog import fftlog_lnkr, fftlog_sphbessel_multi

    t_phase_rn = time.perf_counter()
    grn = np.load(GOLDEN_RN)
    for key in ("zs", "ks", "ms", "ngal"):
        check(np.array_equal(gc[key], grn[key]), f"golden files share {key}")
    check(dict(zip(grn["param_names"].tolist(),
                   map(float, grn["param_values"]))) == cosmo_c,
          "the rsd_nonlimber golden file is at the bench cosmology")
    check(launches["class"] == want_class, f"the build this phase runs on "
          f"launched what the class phase counted: {launches['class']}")
    ells_rn, gzs_rn, dndz_rn = grn["ells"], grn["gzs"], grn["gdndz"]
    bias_rn, smag_rn, lzs_rn = map(float, grn["scalars"])
    ks_rn = grn["rsd_ks"]
    chis_rn = nlm.chi_loggrid()
    fft_ells = tuple(int(l) for l in grn["fft_ells"])
    fx_rn = torch.as_tensor(grn["fft_fx"], device=dev)
    # an HOD whose satellites ride on the fast NFW profile: its P_gg is
    # the hybrid C_gg's input through B1's output
    hm.add_hod("g_fast", ngal=gc["ngal"], satellite_profile_name="nfw_fast")
    pk0_rn = hm.P_lin(ks_np, [0.0])[0]
    gal_rn = dict(bias=bias_rn)
    rn_calls = {
        "C_gg_exact": lambda h: h.C_gg_exact(
            ells_rn, ks_np, pk0_rn, gzs_rn, dndz_rn, **gal_rn),
        "C_gg_exact rsd smag": lambda h: h.C_gg_exact(
            ells_rn, ks_np, pk0_rn, gzs_rn, dndz_rn, rsd=True, smag=smag_rn,
            **gal_rn),
        "C_kg_exact": lambda h: h.C_kg_exact(
            ells_rn, ks_np, pk0_rn, gzs_rn, dndz_rn, lzs=lzs_rn, **gal_rn),
        "C_kk_exact": lambda h: h.C_kk_exact(ells_rn, ks_np, pk0_rn,
                                             lzs1=lzs_rn),
        "C_gg_hybrid": lambda h: h.C_gg_hybrid(
            ells_rn, ks_np, pk0_rn, zs, h.get_power("g"), gzs_rn, dndz_rn,
            **gal_rn),
        "C_gg_hybrid g_fast": lambda h: h.C_gg_hybrid(
            ells_rn, ks_np, pk0_rn, zs, h.get_power("g_fast"), gzs_rn,
            dndz_rn, **gal_rn),
        "C_kk_hybrid": lambda h: h.C_kk_hybrid(
            ells_rn, ks_np, pk0_rn, zs, h.get_power("nfw"), lzs1=lzs_rn,
            lzs2=lzs_rn),
        "C_kk_hybrid nfw_fast": lambda h: h.C_kk_hybrid(
            ells_rn, ks_np, pk0_rn, zs, h.get_power("nfw_fast"),
            lzs1=lzs_rn, lzs2=lzs_rn),
        "P_mm_1loop": lambda h: h.P_mm_1loop(zs, ks_rn),
        "P_mm_1loop ir_resum": lambda h: h.P_mm_1loop(zs, ks_rn,
                                                      ir_resum=True),
        "get_rsd_multipoles kaiser": lambda h: h.get_rsd_multipoles(
            zs, ks_rn, b=bias_rn, model="kaiser"),
        "get_rsd_multipoles scoccimarro": lambda h: h.get_rsd_multipoles(
            zs, ks_rn, b=bias_rn, model="scoccimarro"),
        "get_rsd_multipoles tns": lambda h: h.get_rsd_multipoles(
            zs, ks_rn, b=bias_rn, model="tns"),
        "get_galaxy_rsd_multipoles": lambda h: h.get_galaxy_rsd_multipoles(
            "g"),
        "fftlog_sphbessel_multi": lambda h: fftlog_sphbessel_multi(
            fx_rn, chis_rn, fft_ells, lnkr=fftlog_lnkr(chis_rn, mu=0.5)),
    }
    # (output name, golden key, gate, the ks of a TNS row)
    rn_golden = {
        "C_gg_exact": [("", "c_gg", GATE_RN, None)],
        "C_gg_exact rsd smag": [("", "c_gg_rsd_smag", GATE_RN, None)],
        "C_kg_exact": [("", "c_kg", GATE_RN, None)],
        "C_kk_exact": [("", "c_kk", GATE_RN, None)],
        "C_gg_hybrid": [("", "c_gg_hybrid", GATE_RN, None)],
        "C_gg_hybrid g_fast": [("", "c_gg_hybrid", GATE_RN_FAST, None)],
        "C_kk_hybrid": [("", "c_kk_hybrid", GATE_RN, None)],
        "C_kk_hybrid nfw_fast": [("", "c_kk_hybrid", GATE_RN_FAST, None)],
        "P_mm_1loop": [("", "p1loop", GATE_RN, None)],
        "P_mm_1loop ir_resum": [("", "p1loop_ir", GATE_RN, None)],
        **{f"get_rsd_multipoles {m}": [
            (ell, f"rsd_{m}_{ell}", GATE_RN, ks_rn if m == "tns" else None)
            for ell in (0, 2, 4)] for m in ("kaiser", "scoccimarro", "tns")},
        "get_galaxy_rsd_multipoles": [
            (ell, f"galaxy_tns_{ell}", GATE_RN, ks_np) for ell in (0, 2, 4)],
        "fftlog_sphbessel_multi": [("ks", "fft_ks", GATE_RN, None),
                                   ("F", "fft_F", GATE_RN_FFT, None)],
    }

    def rn_err(got, want, tns_ks):
        """(close_err at k >= 1/Mpc, close_err below it) on a TNS row, None
        for a band without a k; (close_err, None) on any other row."""
        if tns_ks is None:
            return close_err(got, want), None
        lo = np.asarray(tns_ks) < 1.0
        return tuple(close_err(got[..., m], want[..., m]) if m.any() else None
                     for m in (~lo, lo))

    # the main path of the phase: the class phase's build, then the
    # group's calls on it with the counts set to 0 just before and read
    # just after
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    res_rn = {what: fn(hm) for what, fn in rn_calls.items()}
    torch.cuda.synchronize()
    launches["rsd_nonlimber"] = read_counts()
    rn_peak = torch.cuda.max_memory_allocated(dev) / 2**20
    check(not any(launches["rsd_nonlimber"].values()),
          f"the rsd_nonlimber group's calls launch no kernel: "
          f"{launches['rsd_nonlimber']}")
    for what, outs in rn_golden.items():
        res = res_rn[what]
        for key, gkey, gate, tns_ks in outs:
            if what == "fftlog_sphbessel_multi":
                got = res[0] if key == "ks" else res[1]
            else:
                got = res if key == "" else res[key]
            want = grn[gkey]
            check(got.is_cuda and got.dtype == torch.float64
                  and tuple(got.shape) == want.shape
                  and bool(torch.isfinite(got).all()),
                  f"rsd_nonlimber {what} {key} output")
            g_np = got.cpu().numpy()
            if key == "F":
                dress = grn["fft_ks"] ** 1.5
                e = float(np.max(np.abs(g_np - want) * dress
                                 / np.max(np.abs(want) * dress, -1,
                                          keepdims=True)))
                e_lo = None
            else:
                e, e_lo = rn_err(g_np, want, tns_ks)
            check(e is None or e <= gate, f"rsd_nonlimber {what} {key} vs "
                  f"golden: {e!r} > {gate}")
            check(e_lo is None or e_lo <= GATE_RN_TNS_LOW, f"rsd_nonlimber "
                  f"{what} {key} below k = 1/Mpc vs golden: {e_lo!r} > "
                  f"{GATE_RN_TNS_LOW}")
            bands = []
            if e is not None:
                bands.append(f"{'at k >= 1/Mpc ' if tns_ks is not None else ''}"
                             f"{e!r} (gate {gate})")
            if e_lo is not None:
                bands.append(f"below k = 1/Mpc {e_lo!r} (gate "
                             f"{GATE_RN_TNS_LOW})")
            print(f"[rsd_nonlimber] {what} {key} {tuple(got.shape)}: max "
                  f"rel err vs the JAX class's golden {'; '.join(bands)}")
    print(f"[rsd_nonlimber] the class build's launches {launches['class']}, "
          f"the {len(rn_calls)} calls' {launches['rsd_nonlimber']}; peak "
          f"{rn_peak:.1f} MiB allocated ({card})")
    del res_rn
    # latency, launches, host reads and peak memory of each entry point
    rn_stats = {}
    for what, fn in rn_calls.items():
        n_l, n_sync = traced(lambda: fn(hm))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t_v = host_ms(lambda: fn(hm), n=2, warmup=0)
        peak_v = torch.cuda.max_memory_allocated(dev) / 2**20
        rn_stats[what] = {"ms": t_v, "launches": n_l, "host_reads": n_sync,
                          "peak_mib": peak_v}
        print(f"[time] rsd_nonlimber {what}: {t_v!r} ms (host clock to "
              f"synchronize, median of 2), {n_l} launches and {n_sync} host "
              f"reads (torch.profiler), peak {peak_v:.1f} MiB allocated "
              f"({card})")
    print(f"[rsd_nonlimber] the phase's wall time "
          f"{time.perf_counter() - t_phase_rn:.1f} s (host clock)")

    # ---- phase 4h'': weak lensing and CMB lensing --------------------------
    from hmvec_tpu_torch import Cosmology as TorchCosmology
    from hmvec_tpu_torch.models import lensed_cf as lcf
    from hmvec_tpu_torch.models import lensed_cls as lcl
    from hmvec_tpu_torch.models import lensing_noise as lnm
    from hmvec_tpu_torch.models import master as mst
    from hmvec_tpu_torch.models import shear as shm

    t_phase_lc = time.perf_counter()
    glc = np.load(GOLDEN_LC)
    for key in ("zs", "ks", "ms", "ngal"):
        check(np.array_equal(gc[key], glc[key]), f"golden files share {key}")
    check(dict(zip(glc["param_names"].tolist(),
                   map(float, glc["param_values"]))) == cosmo_c,
          "the lensing golden file is at the bench cosmology")
    check(launches["class"] == want_class, f"the build this phase runs on "
          f"launched what the class phase counted: {launches['class']}")
    ells_lc, szs, sdndz = glc["ells"], glc["szs"], glc["sdndz"]
    gzs_lc, gdndz_lc = glc["gzs"], glc["gdndz"]
    ia_kw = dict(zip(("A_ia", "eta_ia", "z0"), map(float, glc["ia"])))
    smag, shape_n, fsky_lc, nl_g, noise_t, beam = map(float, glc["scalars"])
    thetas_lc = glc["thetas"]
    lm, cap = int(glc["lmax_m"]), float(glc["cap"])
    edges, mrows = glc["edges"], glc["rows"]
    lmax_out, Ls, Ls8 = int(glc["lmax_out"]), glc["Ls"], glc["Ls8"]
    lmax_cmb = glc["unlensed"].shape[0] - 1
    # the inputs on the card: the build's spectra, the synthetic unlensed
    # CMB spectra and noise, C_phiphi from the build's nonlinear C_kk
    pmm_lc, pgm_lc = hm.get_power("nfw"), hm.get_power("g", "nfw")
    pgg_lc, pmm_fast_lc = hm.get_power("g"), hm.get_power("nfw_fast")
    unl = torch.as_tensor(glc["unlensed"], device=dev)
    cl_tt, cl_ee, cl_te = unl[:, 0], unl[:, 1], unl[:, 3]
    lv = torch.arange(lmax_cmb + 1, dtype=torch.float64, device=dev)
    nl_p = lnm.white_noise_nl(lv, noise_t * math.sqrt(2.0), beam)
    ells_kk, clkk = hm.cmb_lensing_limber(lmax_cmb, nonlinear=True)
    L_int = np.arange(lmax_cmb + 1, dtype=float)
    clkk_int = np.interp(L_int, ells_kk.cpu().numpy(), clkk.cpu().numpy())
    clpp_np = np.zeros(lmax_cmb + 1)
    clpp_np[2:] = 4.0 * clkk_int[2:] / (L_int[2:] * (L_int[2:] + 1.0)) ** 2
    e_clpp = close_err(clpp_np[2:], glc["clpp"][2:])
    check(e_clpp <= GATE_LC, f"lensing C_phiphi vs golden: {e_clpp!r}")
    print(f"[lensing] C_phiphi from cmb_lensing_limber({lmax_cmb}, "
          f"nonlinear=True): max rel err vs golden {e_clpp!r} (gate "
          f"{GATE_LC})")
    clpp = torch.as_tensor(clpp_np, device=dev)
    tot_tt = lnm.total_cl_tt(cl_tt, noise_t, beam)
    tot_ee = cl_ee + nl_p
    tot_bb = lnm.lensed_bb_from_ee(cl_ee, clpp, lmax_out=lmax_cmb) + nl_p
    grad_lc = {"TT": cl_tt, "EE": cl_ee, "TE": cl_te}
    total_lc = {"TT": tot_tt, "EE": tot_ee, "BB": tot_bb, "TE": cl_te}
    n0_kw = dict(lmin=30, lmax=lmax_cmb)
    gdndz_s = glc["gdndz_on_szs"]
    table = dict(np.load(FIXTURE_CMB))
    cmb_t = TorchCosmology(params=cosmo_c, cls_table=table, device=dev)
    fix_lmax = int(glc["fixture_lmax"])
    tri = torch.as_tensor(glc["tri"].astype(np.float64), device=dev)
    ells_m = np.arange(2, lm + 1, dtype=np.float64)
    cl_m = [torch.cat([torch.zeros(2, dtype=torch.float64, device=dev), c])
            for c in (hm.C_gg(ells_m, zs, ks_np, pgg_lc, gzs_lc,
                              gdndz=gdndz_lc),
                      hm.C_kk(ells_m, zs, ks_np, pmm_lc, lzs1=szs,
                              ldndz1=sdndz, lzs2=szs, ldndz2=sdndz),
                      hm.C_kg(ells_m, zs, ks_np, pgm_lc, gzs_lc,
                              gdndz=gdndz_lc, lzs=szs, ldndz=sdndz))]
    tt_m = cl_m[0] + nl_g
    ee_m, bb_m = cl_m[1] + shape_n, torch.full_like(tt_m, shape_n)
    wl_m = mst.cap_mask_cl(2 * lm, cap, device=dev)
    shear_tot = hm.shear_cls_with_ia(ells_lc, zs, ks_np, pmm_lc, szs, sdndz,
                                     **ia_kw)["total"]
    kg_tot = hm.C_kg_mag(ells_lc, zs, ks_np, pgm_lc, pmm_lc, gzs_lc,
                         gdndz_lc, smag, lzs=szs, ldndz=sdndz)["total"]
    xi_tot = shear_tot + shape_n
    m00 = mst.coupling_matrix(lm, wl_m, (0, 0))
    m02 = mst.coupling_matrix(lm, wl_m, (0, 2))
    m22 = mst.coupling_matrix(lm, wl_m, (2, 2))
    p00, p02 = mst.couple_cls(m00, tt_m), mst.couple_cls(m02, cl_m[2])
    pee, pbb = mst.couple_cls(m22, (ee_m, bb_m))
    cov_nka = mst.gaussian_covariance_nka(lm, wl_m, tt_m, tt_m, tt_m, tt_m)
    torch.cuda.synchronize()
    lc_calls = {
        # intrinsic alignments and magnification on the build's spectra
        "shear_cls_with_ia": lambda: hm.shear_cls_with_ia(
            ells_lc, zs, ks_np, pmm_lc, szs, sdndz, **ia_kw),
        "shear_cls_with_ia nfw_fast": lambda: hm.shear_cls_with_ia(
            ells_lc, zs, ks_np, pmm_fast_lc, szs, sdndz, **ia_kw),
        "C_II": lambda: hm.C_II(ells_lc, zs, ks_np, pmm_lc, szs, sdndz,
                                **ia_kw),
        "C_kI": lambda: hm.C_kI(ells_lc, zs, ks_np, pmm_lc, szs, sdndz,
                                lzs=1100.0, **ia_kw),
        "C_gI": lambda: hm.C_gI(ells_lc, zs, ks_np, pgm_lc, szs, gdndz_s,
                                sdndz, **ia_kw),
        "C_gg_mag": lambda: hm.C_gg_mag(ells_lc, zs, ks_np, pgg_lc, pgm_lc,
                                        pmm_lc, gzs_lc, gdndz_lc, smag),
        "C_kg_mag": lambda: hm.C_kg_mag(ells_lc, zs, ks_np, pgm_lc, pmm_lc,
                                        gzs_lc, gdndz_lc, smag, lzs=szs,
                                        ldndz=sdndz),
        # real space
        "xi_plus": lambda: shm.xi_plus(ells_lc, shear_tot, thetas_lc,
                                       input_kind="convergence"),
        "xi_minus": lambda: shm.xi_minus(ells_lc, shear_tot, thetas_lc,
                                         input_kind="convergence"),
        "gamma_t": lambda: shm.gamma_t(ells_lc, kg_tot, thetas_lc),
        "xi_gaussian_cov plus plus": lambda: shm.xi_gaussian_cov(
            ells_lc, xi_tot, xi_tot, xi_tot, xi_tot, thetas_lc, "plus",
            "plus", fsky=fsky_lc),
        "xi_gaussian_cov plus minus": lambda: shm.xi_gaussian_cov(
            ells_lc, xi_tot, xi_tot, xi_tot, xi_tot, thetas_lc, "plus",
            "minus", fsky=fsky_lc),
        # MASTER
        "cap_mask_cl": lambda: mst.cap_mask_cl(2 * lm, cap, device=dev),
        "coupling_matrix 00": lambda: mst.coupling_matrix(lm, wl_m, (0, 0)),
        "coupling_matrix 02": lambda: mst.coupling_matrix(lm, wl_m, (0, 2)),
        "coupling_matrix 22": lambda: mst.coupling_matrix(lm, wl_m, (2, 2)),
        "couple_cls": lambda: (mst.couple_cls(m00, tt_m),
                               mst.couple_cls(m02, cl_m[2]),
                               *mst.couple_cls(m22, (ee_m, bb_m))),
        "decouple_bandpowers": lambda: (
            mst.decouple_bandpowers(m00, p00, lm, edges),
            mst.decouple_bandpowers(m02, p02, lm, edges),
            torch.stack(mst.decouple_bandpowers(m22, (pee, pbb), lm, edges))),
        "gaussian_covariance_nka": lambda: mst.gaussian_covariance_nka(
            lm, wl_m, tt_m, tt_m, tt_m, tt_m),
        "decoupled_covariance": lambda: mst.decoupled_covariance(
            m00, cov_nka, lm, edges),
        # CMB lensing
        "lens_cls_flat_sky_resummed": lambda: lcf.lens_cls_flat_sky_resummed(
            unl, clpp, lmax_out=lmax_out),
        "lens_cls_flat_sky": lambda: lcl.lens_cls_flat_sky(
            unl, clpp, lmax_out=lmax_out),
        "lensed_bb_from_ee": lambda: lnm.lensed_bb_from_ee(
            cl_ee, clpp, lmax_out=lmax_cmb),
        "n0_flat_sky TT EE EB": lambda: (
            lnm.n0_flat_sky(Ls, "TT", cl_tt, tot_tt, **n0_kw),
            lnm.n0_flat_sky(Ls, "EE", cl_ee, tot_ee, **n0_kw),
            lnm.n0_flat_sky(Ls, "EB", cl_ee, tot_ee, cl_total2=tot_bb,
                            **n0_kw)),
        "n0_pair_flat_sky TE TB": lambda: (
            lnm.n0_pair_flat_sky(Ls, "TE", grad_lc, total_lc, **n0_kw),
            lnm.n0_pair_flat_sky(Ls, "TB", grad_lc, total_lc, **n0_kw)),
        "n0_cross_flat_sky TT TE": lambda: lnm.n0_cross_flat_sky(
            Ls, "TT", "TE", grad_lc, total_lc, **n0_kw),
        "n0_mv_flat_sky": lambda: lnm.n0_mv_flat_sky(
            Ls, grad_lc, total_lc, return_matrix=True, **n0_kw),
        "n0_eb_iterative": lambda: lnm.n0_eb_iterative(
            Ls, cl_ee, tot_ee, clpp, nl_p, return_info=True, **n0_kw),
        "n0_tt_fullsky": lambda: lnm.n0_tt_fullsky(Ls8, cl_tt, tot_tt,
                                                   **n0_kw),
        "n1_tt_flat_sky": lambda: lnm.n1_tt_flat_sky(Ls8, cl_tt, tot_tt,
                                                     clpp, **n0_kw),
        "threej000_sq": lambda: lnm.threej000_sq(
            tri[0], float(lmax_cmb), tri[1]),
        # the tabulated CMB spectra
        "get_cmb_cls": lambda: cmb_t.get_cmb_cls(lmax=fix_lmax),
        "cmb_lensing_kk_exact": lambda: cmb_t.cmb_lensing_kk_exact(
            fix_lmax),
    }
    # the main path of the phase: the class phase's build, then the
    # group's calls on it with the counts set to 0 just before and read
    # just after
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    res_lc = {what: fn() for what, fn in lc_calls.items()}
    torch.cuda.synchronize()
    launches["lensing"] = read_counts()
    lc_peak = torch.cuda.max_memory_allocated(dev) / 2**20
    check(not any(launches["lensing"].values()),
          f"the lensing group's calls launch no kernel: "
          f"{launches['lensing']}")

    def master_rows(mat):
        return mat.diagonal(), mat[torch.as_tensor(mrows, device=dev)]

    spectra_rows = lambda a: np.asarray(a).T[:, 2:]
    # output -> (tensor, golden array, gate, measure; None: bit for bit)
    fields = {
        **{f"shear_cls_with_ia {k}": (res_lc["shear_cls_with_ia"][k],
                                      glc[f"shear_{k}"], GATE_LC, close_err)
           for k in ("GG", "GI", "II", "total")},
        **{f"shear_cls_with_ia nfw_fast {k}": (
            res_lc["shear_cls_with_ia nfw_fast"][k], glc[f"shear_{k}"],
            GATE_LC_FAST, close_err) for k in ("GG", "GI", "II", "total")},
        "C_II": (res_lc["C_II"], glc["c_ii"], GATE_LC, close_err),
        "C_kI": (res_lc["C_kI"], glc["c_ki"], GATE_LC, close_err),
        "C_gI": (res_lc["C_gI"], glc["c_gi"], GATE_LC, close_err),
        **{f"C_gg_mag {k}": (v, glc[f"gg_mag_{k}"], GATE_LC, close_err)
           for k, v in res_lc["C_gg_mag"].items()},
        **{f"C_kg_mag {k}": (v, glc[f"kg_mag_{k}"], GATE_LC, close_err)
           for k, v in res_lc["C_kg_mag"].items()},
        **{what: (res_lc[what], glc[key], GATE_LC_ROW, row_err)
           for what, key in (("xi_plus", "xi_plus"),
                             ("xi_minus", "xi_minus"),
                             ("gamma_t", "gamma_t"),
                             ("xi_gaussian_cov plus plus", "xi_cov_pp"),
                             ("xi_gaussian_cov plus minus", "xi_cov_pm"))},
        "cap_mask_cl": (res_lc["cap_mask_cl"], glc["cap_mask"], GATE_LC,
                        close_err),
        # a coupling matrix is a Gauss-Legendre sum of Wigner-d products:
        # its diagonal element by element, its rows (whose far entries are
        # the sum's rounding) relative to the row's largest value
        **{f"{name} {part}": (master_rows(mat)[i], glc[f"{key}_{part}"],
                              GATE_LC, measure)
           for name, key, mat in (
               ("coupling_matrix 00", "m00", res_lc["coupling_matrix 00"]),
               ("coupling_matrix 02", "m02", res_lc["coupling_matrix 02"]),
               ("coupling_matrix 22 ++", "mpp",
                res_lc["coupling_matrix 22"]["++"]),
               ("coupling_matrix 22 --", "mmm",
                res_lc["coupling_matrix 22"]["--"]),
               ("gaussian_covariance_nka", "cov_nka",
                res_lc["gaussian_covariance_nka"]))
           for i, (part, measure) in enumerate((("diag", close_err),
                                                ("rows", row_err)))},
        **{f"couple_cls {k}": (v, glc[f"master_pseudo_{k}"], GATE_LC,
                               close_err)
           for k, v in zip(("00", "02", "ee", "bb"), res_lc["couple_cls"])},
        **{f"decouple_bandpowers {k}": (v, glc[f"master_bp_{k}"], GATE_LC,
                                        close_err)
           for k, v in zip(("00", "02", "ee_bb"),
                           res_lc["decouple_bandpowers"])},
        "decoupled_covariance": (res_lc["decoupled_covariance"],
                                 glc["master_cov_bp"], GATE_LC, close_err),
        "lens_cls_flat_sky_resummed": (
            res_lc["lens_cls_flat_sky_resummed"].T[:, 2:],
            spectra_rows(glc["lensed_resummed"]), GATE_LC_ROW, row_err),
        "lens_cls_flat_sky": (res_lc["lens_cls_flat_sky"].T[:, 2:],
                              spectra_rows(glc["lensed_first_order"]),
                              GATE_LC, close_err),
        "lensed_bb_from_ee": (res_lc["lensed_bb_from_ee"][2:],
                              glc["lensed_bb"][2:], GATE_LC, close_err),
        **{f"n0_flat_sky {k}": (v, glc[f"n0_{k.lower()}"], GATE_LC,
                                close_err)
           for k, v in zip(("TT", "EE", "EB"),
                           res_lc["n0_flat_sky TT EE EB"])},
        **{f"n0_pair_flat_sky {k}": (v, glc[f"n0_pair_{k.lower()}"],
                                     GATE_LC, close_err)
           for k, v in zip(("TE", "TB"), res_lc["n0_pair_flat_sky TE TB"])},
        "n0_cross_flat_sky TT TE": (res_lc["n0_cross_flat_sky TT TE"],
                                    glc["n0_cross_tt_te"], GATE_LC,
                                    close_err),
        "n0_mv_flat_sky": (res_lc["n0_mv_flat_sky"][0], glc["n0_mv"],
                           GATE_LC, close_err),
        "n0_mv_flat_sky matrix": (
            res_lc["n0_mv_flat_sky"][1].reshape(len(Ls), -1),
            glc["n0_mv_matrix"].reshape(len(Ls), -1), GATE_LC, close_err),
        "n0_eb_iterative": (res_lc["n0_eb_iterative"][0],
                            glc["n0_eb_iterative"], GATE_LC, close_err),
        "n0_tt_fullsky": (res_lc["n0_tt_fullsky"], glc["n0_tt_fullsky"],
                          GATE_LC_3J, close_err),
        "n1_tt_flat_sky": (res_lc["n1_tt_flat_sky"], glc["n1_tt"], GATE_LC,
                           close_err),
        "threej000_sq": (res_lc["threej000_sq"], glc["threej"], GATE_LC_3J,
                         close_err),
        **{f"get_cmb_cls {k}": (v, glc[f"cmb_{k}"], 0.0, None)
           for k, v in res_lc["get_cmb_cls"].items()},
        "cmb_lensing_kk_exact": (res_lc["cmb_lensing_kk_exact"][1],
                                 glc["kk_exact"], 0.0, None),
    }
    lc_err = {}
    for what, (got, want, gate, measure) in fields.items():
        check(got.is_cuda and got.dtype == torch.float64
              and tuple(got.shape) == want.shape,
              f"lensing {what} output {tuple(got.shape)}")
        g_np = got.cpu().numpy()
        if measure is None:
            # a table's rows as they are: equal bit for bit, NaN padding
            # where the table ends
            same = np.array_equal(np.isnan(g_np), np.isnan(want)) and \
                np.array_equal(g_np[~np.isnan(g_np)], want[~np.isnan(want)])
            check(same, f"lensing {what}: the table's values")
            e = 0.0
        else:
            check(bool(np.all(np.isfinite(g_np))), f"lensing {what} finite")
            e = measure(g_np, want)
        check(e <= gate, f"lensing {what} vs golden: {e!r} > {gate}")
        lc_err[what] = e
        kind = {row_err: "of the row's largest value", close_err:
                "element by element", None: "(bit for bit)"}[measure]
        print(f"[lensing] {what} {tuple(got.shape)}: max rel err vs the JAX "
              f"golden {e!r} {kind} (gate {gate})")
    iters = res_lc["n0_eb_iterative"][1]["iters"]
    check(iters == int(glc["n0_eb_iters"]), f"n0_eb_iterative stopped after "
          f"{iters} iterations, JAX after {int(glc['n0_eb_iters'])}")
    print(f"[lensing] n0_eb_iterative: {iters} iterations, as JAX's")
    print(f"[lensing] the class build's launches {launches['class']}, "
          f"the {len(lc_calls)} calls' {launches['lensing']}; peak "
          f"{lc_peak:.1f} MiB allocated ({card})")
    del res_lc
    # latency, launches, host reads and peak memory of each entry point
    lc_stats = entry_stats("lensing", lc_calls, dev, card)
    # CardOps beside the profiler's kernel count on two of the calls
    for what in ("shear_cls_with_ia", "n0_mv_flat_sky"):
        n_prof, sync_prof = traced(lc_calls[what])
        print(f"[lensing] {what}: CardOps {lc_stats[what]['launches']} "
              f"launches and {lc_stats[what]['host_reads']} host reads, "
              f"torch.profiler {n_prof} kernels and {sync_prof} host reads")
    print(f"[lensing] the phase's wall time "
          f"{time.perf_counter() - t_phase_lc:.1f} s (host clock)")

    # ---- phase 4j: projected-field kSZ^2, flat-sky maps, the emulator,
    # stage checkpoints (projfield and checkpoint on the same build, whose
    # B1 and B4a launches are re-checked) ----------------------------------
    counts = types.SimpleNamespace(reset=reset_counts, read=read_counts)
    check(launches["class"] == want_class, f"the build the projfield and "
          f"checkpoint phases run on launched what the class phase counted: "
          f"{launches['class']}")
    launches["projfield"], pf_stats = phase_projfield(hm, dev, card, counts)
    launches["checkpoint"], ck_stats = phase_checkpoint(
        hm, lambda: HaloModel(zs, ks_np, ms=ms, params=cosmo_c, device=dev),
        dev, card, counts)
    launches["flatsky"], fs_stats = phase_flatsky(dev, card, counts)
    launches["emulator"], em_stats, em_keep = phase_emulator(
        dev, card, counts, wrappers)

    # B4a at the 4,000-row shapes beside the device time of an empty launch
    # (a one-element zero_ replayed in a CUDA graph): the electron path's
    # table (4,000 x 2,049 kt) and the class build's gas and pressure tables
    # (4,000 x 2,501 kt), in one run
    one = torch.zeros(1, dtype=torch.float64, device=dev)
    empty_ms = device_ms(lambda: one.zero_())
    b4a_settle = []
    for what, args in (("electron table", tables["pair_lerp_f64"]),
                       ("class gas table", b4_in_c[0]),
                       ("class pressure table", b4_in_c[1])):
        t_k = device_ms(lambda: rk.pair_lerp_f64(*args))
        nbytes, ops = pair_lerp_work(*args)
        b_ms, b_by = bound(nbytes, ops)
        row = {"table": what, "shape": f"{args[1].numel()} x "
               f"{args[0].shape[-1]} kt -> {args[2].numel()} k", "ms": t_k,
               "bound_ms": b_ms, "bound_by": b_by, "time_over_bound":
               t_k / b_ms, "empty_launch_ms": empty_ms,
               "half_of_bound": t_k <= 2.0 * b_ms}
        b4a_settle.append(row)
        print(f"[time] pair_lerp_f64 at the {what} {row['shape']}: {t_k!r} "
              f"ms (device time, CUDA-graph replays of 25 calls), bound "
              f"{b_ms!r} ms by {b_by}, time / bound {t_k / b_ms!r} ("
              f"{'reaches' if row['half_of_bound'] else 'below'} half its "
              f"bound); an empty launch {empty_ms!r} ms ({card})")

    del hm, b4_in_c, u_b1, u_e, got_e, u2_e, idx_e, i0_e
    torch.cuda.empty_cache()

    # ---- phase 4i: the first extension group -----------------------------
    from hmvec_tpu_torch import Cosmology

    gx = np.load(GOLDEN_X)
    for key in ("zs", "ks", "ms"):
        check(np.array_equal(g[key], gx[key]), f"golden files share {key}")
    cosmo_x = dict(zip(gx["param_names"].tolist(),
                       map(float, gx["param_values"])))
    check(cosmo_x == cosmos[0], "the extensions golden file is at the bench "
          "cosmology")
    rows_x = gx["rows"]
    versions_x = sorted(k[4:] for k in gx.files if k.startswith("pnl_")
                        and k != "pnl_ode_mead")
    check(len(versions_x) == 8, f"eight further halofit versions: "
          f"{versions_x}")
    # the phase's inputs, as the golden file was written at them
    ells_x, thetas_x, lmax_x = gx["ells"], gx["thetas"], int(gx["lmax"])
    nus_x = {f"cib{int(nu)}": float(nu) for nu in gx["nus"]}
    pairs_x = [tuple(list(nus_x)[i] for i in pair) for pair in gx["cib_pairs"]]
    w0wa_x = dict(zip(("w0", "wa"), map(float, gx["w0wa"])))
    c = dict(zip(("M", "conc", "zsource", "sig_theta"),
                 map(float, gx["cluster"])))

    def build_ext():
        """The extension tracers on the class at bench width: HMcode's
        nPzk, CIB at two frequencies and HI on the fast NFW profile, the
        Battaglia pressure profile."""
        hm = HaloModel(zs, ks_np, ms=ms, params=cosmo_x, halofit="mead",
                       device=dev)
        hm.add_nfw_profile("nfw_fast", fast=True)
        for name, nu in nus_x.items():
            hm.add_cib_tracer(name, nu, satellite_profile="nfw_fast")
        hm.add_battaglia_pres_profile("y")
        hm.add_hi_tracer("hi", profile_name="nfw_fast")
        return hm

    def ext_outputs(hm):
        """(name, output, golden, gate, relative to the largest value)."""
        out = [("npzk", hm.nPzk, gx["npzk"], GATE_EXT, False)]
        for v in versions_x:
            out.append((f"P_mm_nonlinear {v}",
                        hm.P_mm_nonlinear(ks_np, zs, v)[rows_x],
                        gx[f"pnl_{v}"], GATE_EXT, False))
        ode = Cosmology({**cosmo_x, **w0wa_x}, device=dev)
        check(ode.growth_mode == "ode", "w0/wa takes the integrated growth")
        out.append(("P_mm_nonlinear mead, ode",
                    ode.P_mm_nonlinear(ks_np, zs, "mead")[rows_x],
                    gx["pnl_ode_mead"], GATE_EXT, False))
        out += [
            ("get_p21", hm.get_p21("hi"), gx["p21"], GATE_EXT_FAST, False),
            ("get_omega_hi", hm.get_omega_hi("hi"), gx["omega_hi"],
             GATE_EXT, False),
            ("get_hi_bias", hm.get_hi_bias("hi"), gx["b_hi"], GATE_EXT,
             False),
            ("CIB x y", hm.get_power(pairs_x[0][0], "y")[rows_x], gx["cib_y"],
             GATE_EXT_FAST, False),
            ("get_cib_cls", torch.stack([hm.get_cib_cls(ells_x, a, b)
                                         for a, b in pairs_x]),
             gx["cib_cls"], GATE_EXT_FAST, False),
            ("get_cib_mean_intensity", torch.stack(
                [hm.get_cib_mean_intensity(n) for n in nus_x]),
             gx["cib_intensity"], GATE_EXT, False),
            ("sigma_1h", hm.sigma_1h_profiles(thetas_x, c["M"], c["conc"]),
             gx["sigma_1h"], GATE_EXT, False),
            ("sigma_1h miscentered", hm.sigma_1h_profiles(
                thetas_x, c["M"], c["conc"], sig_theta=c["sig_theta"]),
             gx["sigma_1h_off"], GATE_EXT, False),
            ("kappa_1h", hm.kappa_1h_profiles(thetas_x, c["M"], c["conc"],
                                              c["zsource"]),
             gx["kappa_1h"], GATE_EXT, False),
            # the J0 sum changes sign: relative to its largest value
            ("kappa_2h", hm.kappa_2h_profiles(thetas_x, c["M"],
                                              c["zsource"]),
             gx["kappa_2h"], GATE_EXT, True),
            ("get_bao_rs_dV", hm.get_bao_rs_dV(zs), gx["bao_rs_dv"],
             GATE_EXT, False),
            ("get_tau_star", hm.get_tau_star(), gx["tau_star"], GATE_EXT,
             False),
            ("z_of_tau", hm.z_of_tau(gx["taus"]), gx["z_of_tau"], GATE_EXT,
             False),
            ("conformal_time", hm.conformal_time(zs), gx["conformal_time"],
             GATE_EXT, False),
            ("cmb_lensing_limber nonlinear",
             hm.cmb_lensing_limber(lmax_x, nonlinear=True)[1],
             gx["cl_kk_nl"], GATE_EXT, False)]
        return out

    # the main path of the phase: counts set to 0 just before, read after
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    hx = build_ext()
    outs_x = ext_outputs(hx)
    torch.cuda.synchronize()
    launches["extensions"] = read_counts()
    ext_peak = torch.cuda.max_memory_allocated(dev) / 2**20
    want_ext = {name: {"nfw_uk_fast": 1, "pair_lerp_f64": 1}.get(name, 0)
                for name in wrappers}
    check(launches["extensions"] == want_ext,
          f"extensions: one nfw_uk_fast and one pair_lerp_f64 launch, got "
          f"{launches['extensions']}")
    for what, got, want, gate, to_max in outs_x:
        check(got.is_cuda and got.dtype == torch.float64
              and tuple(got.shape) == want.shape
              and bool(torch.isfinite(got).all()), f"extensions {what} output")
        g_np = got.cpu().numpy()
        e = float(np.max(np.abs(g_np - want)) / np.max(np.abs(want))
                  if to_max else np.max(np.abs(g_np / want - 1.0)))
        check(e <= gate, f"extensions {what} vs golden: {e!r} > {gate}")
        print(f"[extensions] {what} {tuple(got.shape)}: max "
              f"{'abs err / max' if to_max else 'rel err'} vs the JAX "
              f"class's golden {e!r} (gate {gate})")
    theta100 = float(gx["theta100"])
    h0 = Cosmology({**cosmo_x, "theta100": theta100}, device=dev).p["H0"]
    e_h0 = abs(h0 / float(gx["h0_theta100"]) - 1.0)
    check(e_h0 <= GATE_H0, f"H0 from theta100: {e_h0!r}")
    print(f"[extensions] H0 from theta100 = {theta100}: {h0!r}, rel err "
          f"vs the JAX class {e_h0!r} (gate {GATE_H0}; numpy "
          f"{np.__version__}); build launches "
          f"{launches['extensions']}, peak {ext_peak:.1f} MiB allocated "
          f"({card})")
    del outs_x
    # each kernel's inputs in the build, held against its plain version
    with recorded(nk, "_launch_nfw_uk") as b1_in, \
            recorded(rk, "_launch") as b4_in:
        hx2 = build_ext()
    torch.cuda.synchronize()
    check(len(b1_in) == 1 and len(b4_in) == 1, "one launch of each kernel "
          "in a build")
    k_b1, s_b1, c_b1 = b1_in[0][:3]
    u_x, s_x, k_x, dkt_x = b4_in[0]
    del hx2, b1_in, b4_in
    e_b1x = (nk.nfw_uk_fast(k_b1, s_b1, c_b1).double()
             - nk.nfw_uk_plain(k_b1, s_b1, c_b1)).abs().max().item()
    check(e_b1x <= GATE_UK["fast"], f"nfw_uk_fast at the extensions' rows: "
          f"{e_b1x!r}")
    e_b4x = (rk.pair_lerp_f64(u_x, s_x, k_x, dkt_x)
             - rk.pair_lerp_plain(u_x, s_x, k_x, dkt_x)).abs().max().item()
    check(e_b4x <= GATE_LERP, f"pair_lerp_f64 at the pressure table: "
          f"{e_b4x!r}")
    check(torch.equal(nk.nfw_uk_fast(k_b1, s_b1, c_b1).to(torch.float64)
                      .reshape(hx.uk_profiles["nfw_fast"].shape),
                      hx.uk_profiles["nfw_fast"]),
          "the extensions' fast profile is the kernel's output")
    print(f"[extensions] nfw_uk_fast vs nfw_uk_plain at the build's "
          f"{s_b1.numel()} x {k_b1.numel()}: max abs err {e_b1x!r} (gate "
          f"{GATE_UK['fast']}); pair_lerp_f64 vs pair_lerp_plain at the "
          f"pressure table {tuple(u_x.shape)} -> {k_x.numel()} k: max abs "
          f"err {e_b4x!r} (gate {GATE_LERP})")
    # latency, launches, host reads and peak memory of the build and of
    # each of the phase's entry points
    ext_calls = {
        "build": build_ext,
        "get_p21": lambda: hx.get_p21("hi"),
        "get_cib_cls": lambda: hx.get_cib_cls(ells_x, *pairs_x[1]),
        "P_mm_nonlinear mead": lambda: hx.P_mm_nonlinear(ks_np, zs, "mead"),
        "P_mm_nonlinear takahashi":
            lambda: hx.P_mm_nonlinear(ks_np, zs, "takahashi"),
        "cmb_lensing_limber": lambda: hx.cmb_lensing_limber(
            lmax_x, nonlinear=True),
    }
    ext_stats = {}
    for what, fn in ext_calls.items():
        n_l, n_sync = traced(fn)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t_x = host_ms(fn, n=10, warmup=1)
        peak_x = torch.cuda.max_memory_allocated(dev) / 2**20
        ext_stats[what] = {"ms": t_x, "launches": n_l, "host_reads": n_sync,
                           "peak_mib": peak_x}
        print(f"[time] extensions {what} at 20x200x1001: {t_x!r} ms (host "
              f"clock to synchronize, median of 10), {n_l} launches and "
              f"{n_sync} host reads (torch.profiler), peak {peak_x:.1f} MiB "
              f"allocated ({card})")
    # both kernels at the extensions' shapes: device time, plain version,
    # torch.gather of the same samples (B4a), bound
    t_b1x = device_ms(lambda: nk.nfw_uk_fast(k_b1, s_b1, c_b1))
    tp_b1x = device_ms(lambda: nk.nfw_uk_plain(k_b1, s_b1, c_b1))
    b1x_ms, b1x_by = bound(8 * (k_b1.numel() + 2 * s_b1.numel())
                           + 4 * s_b1.numel() * k_b1.numel(),
                           nfw_ops(k_b1, s_b1, c_b1, "fast"))
    t_b4x = device_ms(lambda: rk.pair_lerp_f64(u_x, s_x, k_x, dkt_x))
    tp_b4x = device_ms(lambda: rk.pair_lerp_plain(u_x, s_x, k_x, dkt_x))
    i0_x = torch.floor(k_x * s_x.reshape(-1)[:, None] / dkt_x).clamp(
        1, u_x.shape[-1] - 2).long()
    idx_x = torch.cat([i0_x, i0_x + 1], dim=1)
    u2_x = u_x.reshape(-1, u_x.shape[-1])
    tg_b4x = device_ms(lambda: torch.gather(u2_x, 1, idx_x))
    b4x_ms, b4x_by = bound(*pair_lerp_work(u_x, s_x, k_x, dkt_x))
    ext_rows = {
        "nfw_uk_fast": {"shape": f"{s_b1.numel()} x {k_b1.numel()}",
                        "max_err": e_b1x, "ms": t_b1x, "plain_ms": tp_b1x,
                        "bound_ms": b1x_ms, "bound_by": b1x_by,
                        "library_ms": None,
                        "launches": launches["extensions"]["nfw_uk_fast"]},
        "pair_lerp_f64": {"shape": f"{s_x.numel()} x {u_x.shape[-1]} kt -> "
                                   f"{k_x.numel()} k",
                          "max_err": e_b4x, "ms": t_b4x, "plain_ms": tp_b4x,
                          "gather_ms": tg_b4x, "library_ms": None,
                          "bound_ms": b4x_ms, "bound_by": b4x_by,
                          "launches":
                              launches["extensions"]["pair_lerp_f64"]},
    }
    for name, row in ext_rows.items():
        print(f"[time] {name} at the extensions' shape {row['shape']}: "
              f"{row['ms']!r} ms (device time, CUDA-graph replays of 25 "
              f"calls), plain version {row['plain_ms']!r} ms"
              + (f", torch.gather of the 2 nk samples {row['gather_ms']!r} "
                 f"ms" if "gather_ms" in row else "")
              + f", bound {row['bound_ms']!r} ms by {row['bound_by']}, time "
              f"/ bound {row['ms'] / row['bound_ms']!r}; "
              f"{row['launches']} launch in the extensions build ({card})")
    del hx, u_x, s_x, k_x, u2_x, idx_x, i0_x, k_b1, s_b1, c_b1
    torch.cuda.empty_cache()


    # ---- phase 4k: the Boltzmann group (recomb, boltzlite, boltz_engine)
    boltz_launches, boltz_stats, boltz_rows = phase_boltz(dev, card, counts,
                                                          wrappers, sass)
    launches.update(boltz_launches)

    # ---- phase 4l: the multi-device layer (parallel/sharding.py) --------
    from hmvec_tpu_torch.parallel import sharding as tsh

    ref = types.SimpleNamespace(
        zs=zs, ks_np=ks_np, ms=ms, cosmos=cosmos, g=g, fns=fns,
        pmm_plain=fns["plain"](cosmos[0]), gl=gl, gh=gh, gb=gb,
        names_b=names_b, batch=batch_keep, efns=efns, gk=gk, kcfg=kcfg,
        cls_k=cls_t, cosmos_k=cosmos_k, survey_fn=sfn, emulator=em_keep)
    shard_rows = collections.defaultdict(list)
    sh_launches, sharded_stats = phase_sharded(
        tsh.make_mesh(devices=[dev] * 4), ref, card, counts, wrappers,
        kernel_rows=shard_rows)
    launches.update({f"sharded_{k}": v for k, v in sh_launches.items()})
    check(torch.cuda.current_device() == dev.index,
          "the sharded phase leaves the current device as it was")
    if torch.cuda.device_count() > 1:
        sh_all, stats_all = phase_sharded(tsh.make_mesh(), ref, card, counts,
                                          wrappers)
        launches.update({f"sharded_cards_{k}": v for k, v in sh_all.items()})
        sharded_stats = {"4 slots on one card": sharded_stats,
                         f"{torch.cuda.device_count()} cards": stats_all}
        check(torch.cuda.current_device() == dev.index,
              "the sharded phase on every card leaves the current device "
              "as it was")
    del ref, batch_keep, em_keep
    torch.cuda.empty_cache()

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
    bounds = {name: bound(*work[name]) for name in work}
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

    # the fill, timed in phase 2 at the bN line's shape (and bNf's)
    times["catmull_fill"] = (fill_rows[0]["ms"], fill_rows[0]["plain_ms"])
    bounds["catmull_fill"] = (fill_rows[0]["bound_ms"],
                              fill_rows[0]["bound_by"])
    err["catmull_fill"] = 0.0
    batch_rows["catmull_fill"] = fill_rows
    # the Boltzmann group's kernels, timed in their phase (phase 4k)
    for name, row in boltz_rows.items():
        times[name] = (row["ms"], row["plain_ms"])
        bounds[name] = (row["bound_ms"], row["bound_by"])
        err[name] = row["max_abs_err"]
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
        if name in class_rows:
            row["class"] = class_rows[name]
        if name in ext_rows:
            row["extensions"] = ext_rows[name]
        if name == "pair_lerp_f64":
            row["settle_4000_rows"] = b4a_settle
        if name == "nfw_contract":
            row["c13_max_rel_err"] = err["nfw_contract_c13"]
        if name in boltz_rows:
            row.update({k: v for k, v in boltz_rows[name].items()
                        if k not in row})
        row["sharded"] = shard_rows[name]
        kernels.append(row)
    check(all(math.isfinite(k["ms"]) and math.isfinite(k["plain_ms"])
              and math.isfinite(k["bound_ms"]) for k in kernels), "timings")
    print("[batch] " + json.dumps(batch_stats))
    print("[ksz] " + json.dumps(ksz_stats))
    print("[class] " + json.dumps(class_stats))
    print("[extensions] " + json.dumps(ext_stats))
    print("[cov_bispectrum] " + json.dumps(cov_stats))
    print("[rsd_nonlimber] " + json.dumps(rn_stats))
    print("[lensing] " + json.dumps(lc_stats))
    print("[projfield] " + json.dumps(pf_stats))
    print("[flatsky] " + json.dumps(fs_stats))
    print("[emulator] " + json.dumps(em_stats))
    print("[checkpoint] " + json.dumps(ck_stats))
    print("[boltz] " + json.dumps(boltz_stats))
    print("[sharded] " + json.dumps(sharded_stats))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
