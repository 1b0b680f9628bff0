"""Build the CUDA kernels from ``hmvec_tpu_torch/csrc`` and load them.

At first use, ``load_library()``:

1. writes ``sici_coeffs.cuh`` (the Si/Ci series as constexpr tables of
   polynomial coefficients) from ``hmvec_tpu_torch/ops/_sici_coeffs.py``,
   so the tables are generated and never typed by hand;
2. compiles each ``csrc/*.cu`` with its own ``nvcc -gencode
   arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c``, all
   started together, and links the objects with ``nvcc -shared`` into
   ``hmvec_tpu_torch/build/<hash of sources and flags>/libhmvec_kernels.so``
   (git ignores ``build/``), the compilers' output (ptxas's registers and
   spills) beside it in ``build.log``; a library that already exists for
   the same hash is loaded as it is, its ``build.log`` read back;
3. loads the library with ``ctypes`` and declares every function's
   argument and return types (``c_void_p`` for each pointer and the
   stream).

Nothing here runs at import: the CPU-only install imports the package
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

import numpy as np
from numpy.polynomial.chebyshev import cheb2poly

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "build"
LIB_NAME = "libhmvec_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
# flags of one source only: the Boltzmann integrators keep every multiply
# and add as its own IEEE operation (no FMA contraction), so that they
# repeat their plain versions' arithmetic bit for bit
SOURCE_FLAGS = {"boltz_kernels.cu": ("-fmad=false",)}

# Series terms kept per precision and Si/Ci domain (x <= 4, <= 10, <= 40),
# and asymptotic-tail terms.  The tables are least-squares Chebyshev fits:
# their coefficients fall to the fit's noise floor, a few 1e-15, at index
# 11-12, 16-17 and 14-15 of the three domains, and the terms after that add
# only that noise (cut there, each series stays within 2.4e-14 of its
# 24-term sum on [-1, 1]).  The float64 tier stops at the floor; the
# float32 tier at 16 terms (truncation < 1e-9, below float32 resolution)
# and 7 tail terms.
NCOEF = {"F64": (12, 17, 15), "F32": (16, 16, 16)}
NASY = {"F64": 13, "F32": 7}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def _c_list(vals):
    if isinstance(vals, np.ndarray) and vals.ndim == 1:
        return "{" + ", ".join(repr(float(v)) for v in vals) + "}"
    return "{" + ",\n   ".join(_c_list(v) for v in vals) + "}"


def sici_header() -> str:
    """Text of sici_coeffs.cuh, generated from ops/_sici_coeffs.py.

    Each domain's two Chebyshev series in t (A: Si/x or x f; B: Ci -
    gamma - ln x or x^2 g), cut at the precision's length for that domain
    (``len``), are converted to the coefficients of t^k (numpy's
    ``cheb2poly``, in float64; rows shorter than the widest are padded
    with zeros that no kernel reads), so that the kernels evaluate them by
    Horner, one FMA per term; float32 values are the float64 coefficients
    rounded.  The asymptotic tails' (-1)^n
    (2n)! and (-1)^n (2n+1)! follow.  The float32 tables are constexpr
    and the float64 ones sit in constant memory; both are read through
    accessors whose indices are template arguments, so that a float32
    coefficient compiles to an immediate of its FMA and a float64 one to
    one load from the constant bank.  Values print with repr (shortest
    round-trip form)."""
    from ..ops import _sici_coeffs as sc

    out = ["// Generated by hmvec_tpu_torch/kernels/_build.py from",
           "// hmvec_tpu_torch/ops/_sici_coeffs.py -- do not edit.",
           "#pragma once", "",
           f"#define SICI_EULER_GAMMA {float(sc.EULER_GAMMA)!r}", "",
           "namespace hmvec {", "",
           "template <typename T> struct SiciTables;"]
    for tag, ctype, cast in (("F64", "double", np.float64),
                             ("F32", "float", np.float32)):
        lens, na = NCOEF[tag], NASY[tag]
        n = max(lens)
        poly = np.zeros((2, 3, n))
        for s, ab in enumerate("AB"):
            for d, length in enumerate(lens):
                poly[s, d, :length] = cheb2poly(np.asarray(
                    getattr(sc, f"SICI_{ab}{d}")[:length], np.float64))
        poly = poly.astype(cast)
        fasy = np.asarray([(-1.0) ** i * math.factorial(2 * i)
                           for i in range(na)]).astype(cast)
        gasy = np.asarray([(-1.0) ** i * math.factorial(2 * i + 1)
                           for i in range(na)]).astype(cast)
        const_bank = tag == "F64"
        if const_bank:
            # a float64 coefficient is no immediate of its FMA (the
            # instruction holds 32 bits): out of a constexpr table each
            # costs two integer moves, out of constant memory at a
            # compile-time offset one uniform load, off the integer pipe
            out += ["", "// poly[s][d][k]: series s (0 A, 1 B), domain d, "
                    "coefficient of t^k",
                    f"static __constant__ double kSiciPoly[2][3][{n}] = "
                    f"{_c_list(poly)};",
                    f"static __constant__ double kSiciAsy[2][{na}] = "
                    f"{_c_list(np.stack([fasy, gasy]))};"]
        out += ["", f"template <> struct SiciTables<{ctype}> {{",
                f"  static constexpr int nasy = {na};",
                "  // series terms of each domain",
                "  static constexpr int len[3] = "
                f"{{{', '.join(map(str, lens))}}};"]
        if const_bank:
            out += ["  template <int S, int D, int K>",
                    "  __device__ static __forceinline__ double coef() "
                    "{ return kSiciPoly[S][D][K]; }",
                    "  template <int S, int N>",
                    "  __device__ static __forceinline__ double asy() "
                    "{ return kSiciAsy[S][N]; }",
                    "};"]
            continue
        out += ["  // poly[s][d][k]: series s (0 A, 1 B), domain d, "
                "coefficient of t^k",
                f"  static constexpr {ctype} poly[2][3][{n}] = "
                f"{_c_list(poly)};",
                f"  static constexpr {ctype} fasy[{na}] = {_c_list(fasy)};",
                f"  static constexpr {ctype} gasy[{na}] = {_c_list(gasy)};",
                "  template <int S, int D, int K>",
                f"  __device__ static __forceinline__ {ctype} coef() {{",
                f"    constexpr {ctype} c = poly[S][D][K];",
                "    return c;",
                "  }",
                "  template <int S, int N>",
                f"  __device__ static __forceinline__ {ctype} asy() {{",
                f"    constexpr {ctype} c = S == 0 ? fasy[N] : gasy[N];",
                "    return c;",
                "  }",
                "};"]
    out += ["", "}  // namespace hmvec"]
    return "\n".join(out) + "\n"


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "hmvec_tpu_torch/csrc at first use and need the CUDA "
                       "toolkit (PATH, CUDA_HOME or /usr/local/cuda)")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _run_all(cmds, out_dir):
    """Run the commands side by side; returns (returncode, log) of each.
    Output goes to files, so that no pipe fills while another is waited
    on."""
    procs = []
    try:
        for n, cmd in enumerate(cmds):
            log = (out_dir / f"nvcc{n}.log").open("w+")
            procs.append((subprocess.Popen(cmd, stdout=log,
                                           stderr=subprocess.STDOUT), log))
        results = []
        for proc, log in procs:
            rc = proc.wait()
            log.seek(0)
            results.append((rc, log.read()))
        return results
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


def _build(nvcc: str) -> pathlib.Path:
    header = sici_header()
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(header.encode())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True,
                          log=log_path.read_text() if log_path.exists()
                          else "")
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "sici_coeffs.cuh").write_text(header)
    # one nvcc per source, all started together, then one link; build into
    # a temporary name and rename, so that a process that finds the
    # library finds a whole one
    tmp_dir = pathlib.Path(tempfile.mkdtemp(dir=out_dir))
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [tmp_dir / f"{s.stem}.o" for s in srcs]
    compile_cmds = [[nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(s.name, ()), "-c",
                     "-I", str(out_dir), "-I", str(CSRC), "-o", str(o), str(s)]
                    for s, o in zip(srcs, objs)]
    tmp = tmp_dir / LIB_NAME
    link_cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
    t0 = time.perf_counter()
    try:
        logs = []
        for cmds in (compile_cmds, [link_cmd]):
            for cmd, (rc, log) in zip(cmds, _run_all(cmds, tmp_dir)):
                logs.append(log)
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}):\n"
                                       f"{' '.join(cmd)}\n{log}")
        log_path.write_text("".join(logs))
        os.replace(tmp, lib_path)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    build_info.update(path=str(lib_path), seconds=time.perf_counter() - t0,
                      cached=False, log="".join(logs))
    return lib_path


def _declare(lib):
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("hmvec_nfw_uk_f64", "hmvec_nfw_uk_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, i, i, i, p]
        fn.restype = i
    fn = lib.hmvec_nfw_contract
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    fn.restype = i
    fn = lib.hmvec_nfw_kernel_info
    fn.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    fn.restype = i
    fn = lib.hmvec_recomb_rk4
    fn.argtypes = [p, p, p, d, i, i, p, i, p]
    fn.restype = i
    fn = lib.hmvec_hierarchy_rk4
    fn.argtypes = [p, p, p, p, d, i, i, i, p, p, i, p]
    fn.restype = i
    for name in ("hmvec_pair_lerp_f64", "hmvec_pair_lerp_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, d, p, i, i, i, i, i, i, p]
        fn.restype = i
    fn = lib.hmvec_pair_lerp_blocks_per_sm
    fn.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
    fn.restype = i
    for name in ("hmvec_catmull_fill_f32", "hmvec_catmull_fill_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, i, p]
        fn.restype = i
    return lib


def load_library():
    """The kernels' ctypes library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(_build(find_nvcc()))))
        return _lib
