"""Reproduce, to the last digit, a failure of
tests/test_torch_nfw_kernels.py::test_plain_matches_jax_analytic[random]
seen once in a full test run: nfw_uk_plain 6.909180116920766e-09 away
from the JAX float64 profile (gate 1e-12), its z = 3 rows moved, the
JAX reference not.

Hypothesis tested: torch evaluates float64 sin on the CPU through MKL's
vector math (vmdSin, asked for at high accuracy) and splits a
3,120-element call between its two OpenMP threads; in that run the
second thread's half of the profile's first sin call came out at MKL's
enhanced-performance accuracy (VML_EP, about half the mantissa).  The
script recomputes the sweep with exactly that half of exactly that call
evaluated by vmdSin in VML_EP mode, and prints the error against the
JAX profile beside the failing run's numbers.

    JAX_PLATFORMS=cpu python tools/vml_ep_repro.py

CPU only; needs the MKL symbols that PyTorch's CPU library exports.
"""

import ctypes
import importlib.util
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hmvec_tpu_torch.ops import nfw_kernels as nk  # noqa: E402

# what the failing run printed (its traceback in the test log)
FAILED_MAX = 6.909180116920766e-09
FAILED_ROW23_LAST3 = (1.44944563e-13, 9.72540648e-14, 3.25408645e-14)
VML_EP = 0x3


def _vmd_sin_ep():
    lib = ctypes.CDLL(str(pathlib.Path(torch.__file__).parent / "lib"
                          / "libtorch_cpu.so"))
    f = lib.vmdSin
    ptr = ctypes.POINTER(ctypes.c_double)
    f.argtypes = [ctypes.c_longlong, ptr, ptr, ctypes.c_longlong]

    def sin_ep(x):
        a = np.ascontiguousarray(x.numpy(), dtype=np.float64)
        out = np.empty_like(a)
        f(a.size, a.ctypes.data_as(ptr), out.ctypes.data_as(ptr), VML_EP)
        return torch.from_numpy(out)
    return sin_ep


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    spec = importlib.util.spec_from_file_location(
        "nfw_test", ROOT / "tests" / "test_torch_nfw_kernels.py")
    t = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(t)
    name, zs, cs, rss, ks = t.SWEEPS[0]
    scales, c = t._rows(zs, cs, rss)
    want, take = t._analytic_on_union()
    rows, cols = take[name]
    want = want[rows][:, cols]

    sin, sin_ep, calls = torch.sin, _vmd_sin_ep(), [0]

    def first_call_second_half_ep(x):
        y = sin(x)
        if calls[0] == 0:
            flat, xf = y.reshape(-1).clone(), x.reshape(-1)
            half = xf.numel() // 2
            flat[half:] = sin_ep(xf[half:])
            y = flat.reshape(x.shape)
        calls[0] += 1
        return y

    torch.sin = first_call_second_half_ep
    try:
        u = nk.nfw_uk_plain(t._t(ks), t._t(scales), t._t(c)).numpy()
    finally:
        torch.sin = sin
    err = np.abs(u - want)
    print(f"max |u - JAX|: {err.max()!r} (the failing run: {FAILED_MAX!r})")
    print(f"last z row, last three ks: {err[-1, -3:]} (the failing run: "
          f"{np.array(FAILED_ROW23_LAST3)})")
    clean = nk.nfw_uk_plain(t._t(ks), t._t(scales), t._t(c)).numpy()
    print(f"without it: max |u - JAX| {np.abs(clean - want).max()!r}")


if __name__ == "__main__":
    main()
