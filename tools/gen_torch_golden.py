"""Write the golden files that hold the PyTorch port to the JAX package.

Each runs an all-float64 JAX pipeline on the CPU at bench config 1's full
width (20 z x 200 m x 1001 k) for three cosmologies:

  * the bench overrides (bench.py, config 1);
  * the same with (omch2, As) = (0.11, 2.0e-9);
  * the same with (omch2, As) = (0.13, 2.4e-9);

--config 1 (the default): hmvec_tpu.pipeline.make_pmm_fn(fast=False,
growth="closed") -> hmvec_tpu_torch/data/pmm_config1_golden.npz with the
grids, the parameter names and values, and Pmm of shape (3, 20, 1001).

--config 2: make_electron_fn(nxs=4096, xmax=20, fast=False,
growth="closed"), bench config 2, on the same grids ->
hmvec_tpu_torch/data/electron_config2_golden.npz with Pee and Pme of shape
(3, 20, 1001) and the forward-mode fisher_jacobian of both over
(omch2, As) at the bench cosmology, (20, 1001, 2) each (~30 s).

--config 1w: config 1 on the integrated w0/wa growth.  make_pmm_fn(
fast=False, growth="ode") for the bench overrides with (w0, wa) =
(-0.9, 0.0), (-1.1, 0.3) and (-1.0, 0.0) ->
hmvec_tpu_torch/data/pmm_config1_w0wa_golden.npz with Pmm of shape
(3, 20, 1001) and the forward-mode fisher_jacobian over (omch2, w0, wa) at
the bench cosmology, (20, 1001, 3) (~30 s).

The machine with the GPU has no JAX, so chip_smoke.py compares the port
against these files.  Each run writes only its own file.

Run from the repository root:
    JAX_PLATFORMS=cpu python tools/gen_torch_golden.py [--config 2|1w]
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
DATA = REPO / "hmvec_tpu_torch" / "data"
OUT = {"1": DATA / "pmm_config1_golden.npz",
       "2": DATA / "electron_config2_golden.npz",
       "1w": DATA / "pmm_config1_w0wa_golden.npz"}
NXS, XMAX = 4096, 20          # bench.py config 2
JAC_NAMES = {"2": ("omch2", "As"), "1w": ("omch2", "w0", "wa")}

BENCH_OVERRIDES = {
    "omch2": 0.1198, "ombh2": 0.02225, "H0": 67.3, "ns": 0.9645,
    "As": 2.2e-9, "w0": -1.0, "wa": 0.0, "mnu": 0.0, "omk": 0.0,
    "pivot_scalar": 0.05,
}
VARIANTS = ({}, {"omch2": 0.11, "As": 2.0e-9}, {"omch2": 0.13, "As": 2.4e-9})
VARIANTS_W0WA = ({"w0": -0.9, "wa": 0.0}, {"w0": -1.1, "wa": 0.3},
                 {"w0": -1.0, "wa": 0.0})


def config1_grids():
    """bench.py config 1: (zs, ms, ks)."""
    return (np.linspace(0.1, 3.0, 20), np.geomspace(2e10, 1e17, 200),
            np.geomspace(1e-4, 100, 1001))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(OUT), default="1")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from hmvec_tpu import pipeline as jpl

    zs, ms, ks = config1_grids()
    variants = VARIANTS
    if args.config == "1":
        fn = jpl.make_pmm_fn(zs, ks, ms, fast=False, growth="closed")
        keys = ("pmm",)
    elif args.config == "1w":
        fn = jpl.make_pmm_fn(zs, ks, ms, fast=False, growth="ode")
        keys = ("pmm",)
        variants = VARIANTS_W0WA
    else:
        fn = jpl.make_electron_fn(zs, ks, ms, nxs=NXS, xmax=XMAX, fast=False,
                                  growth="closed")
        keys = ("pee", "pme")
    names = list(BENCH_OVERRIDES)
    values, outs = [], []
    for var in variants:
        ov = {**BENCH_OVERRIDES, **var}
        values.append([ov[k] for k in names])
        out = fn({k: jnp.asarray(v) for k, v in ov.items()})
        outs.append([np.asarray(o) for o in
                     (out if isinstance(out, tuple) else (out,))])
        print(f"{var or 'bench'}: " + ", ".join(
            f"{k}[0, 0] = {o[0, 0]!r}" for k, o in zip(keys, outs[-1])))
    arrays = {k: np.stack([o[i] for o in outs]) for i, k in enumerate(keys)}
    if args.config in JAC_NAMES:
        jac_names = JAC_NAMES[args.config]
        arrays["jac_names"] = np.asarray(jac_names)
        jacs = jpl.fisher_jacobian(fn, BENCH_OVERRIDES, jac_names)
        for k, jac in zip(keys, jacs if len(keys) > 1 else (jacs,)):
            arrays[f"jac_{k}"] = np.asarray(jac)
    if args.config == "2":
        arrays.update(nxs=NXS, xmax=XMAX)
    path = OUT[args.config]
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, zs=zs, ms=ms, ks=ks,
                        param_names=np.asarray(names),
                        param_values=np.asarray(values, dtype=np.float64),
                        **arrays)
    print(f"wrote {path.relative_to(REPO)} ({path.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
