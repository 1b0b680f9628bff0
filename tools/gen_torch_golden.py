"""Write the golden files that hold the PyTorch port to the JAX package.

Each runs an all-float64 JAX pipeline on the CPU at bench config 1's full
width (20 z x 200 m x 1001 k), configs 1 to 4 for three cosmologies:

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

--config 3: make_hod_fn(ngal = 1e-4 per z, fast=False, growth="closed"),
bench config 3 -> hmvec_tpu_torch/data/hod_config3_golden.npz with Pgg and
Pgm of shape (3, 20, 1001) and ngal (~15 s).

--config 4: make_lensing_cls_fn(ells = geomspace(30, 3000, 60), zsource =
1100, fast=False, growth="closed"), bench config 4 ->
hmvec_tpu_torch/data/lensing_config4_golden.npz with C_kk (3, 60), Pmm
(3, 20, 1001), ells and zsource (~10 s).

--config b: the batch-serving lines of bench.py.  Single float64 calls of
make_pmm_fn(fast=False, growth="closed") at rows 0, 7, 15 of the B = 16
theta (omch2 0.11-0.13, As 2.0e-9-2.4e-9, linearly spaced), and of the same
with static_params={"sigma2_numks": 1250} and uk_subsample=(0.2, 4) at
rows 0, 63, 127 of the B = 128 theta ->
hmvec_tpu_torch/data/pmm_batch_golden.npz with pmm_b16 and pmm_bN, each
(3, 20, 1001), their rows and both thetas (~15 s).

--config 5: bench config 5, the kSZ forecast (bench.py:271-276, 291-293).
make_ksz_snr_fn(z = 0.55, 10 Gpc^3, ngal 1e-4, ms = geomspace(1e8, 1e16,
500), 100/101/102 kL/kS/mu bins, nxs 4096, xmax 20, growth="closed") with
Cls = 1e-5 ones(10000), at the three cosmologies: snr (3,), Nvv (3, 102,
100), vrec (3, 1) and the forward-mode d snr / d (omch2, As) (3, 2); and
make_ksz_survey_fn at the same widths with nxs 2048 for four bins, zcents
(0.3, 0.5, 0.7, 0.9), volumes (4, 8, 12, 16) Gpc^3, ngals (3e-4, 2e-4,
1.5e-4, 1e-4): the total (3,), per-bin snr (3, 4) and bias (3, 4) ->
hmvec_tpu_torch/data/ksz_config5_golden.npz (~60 s).

--config m: config-1 Pmm, make_pmm_fn(fast=False, growth="closed"), at the
bench cosmology for each mass function other than Sheth-Tormen (tinker,
tinker2008, press-schechter, despali) -> hmvec_tpu_torch/data/
pmm_massfn_golden.npz with Pmm of shape (4, 20, 1001) and the modes
(~20 s).

The machine with the GPU has no JAX, so chip_smoke.py compares the port
against these files.  Each run writes only its own file.

Run from the repository root:
    JAX_PLATFORMS=cpu python tools/gen_torch_golden.py [--config 2|1w|3|4|b|5|m]
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
       "1w": DATA / "pmm_config1_w0wa_golden.npz",
       "3": DATA / "hod_config3_golden.npz",
       "4": DATA / "lensing_config4_golden.npz",
       "b": DATA / "pmm_batch_golden.npz",
       "5": DATA / "ksz_config5_golden.npz",
       "m": DATA / "pmm_massfn_golden.npz"}
NXS, XMAX = 4096, 20          # bench.py config 2
NGAL = 1e-4                   # bench.py config 3, per z
ELLS, ZSOURCE = np.geomspace(30, 3000, 60), 1100.0   # bench.py config 4
# bench.py's batch lines: (B, the rows kept, make_pmm_fn's serving options)
BATCHES = {"b16": (16, (0, 7, 15), {}),
           "bN": (128, (0, 63, 127),
                  {"static_params": {"sigma2_numks": 1250},
                   "uk_subsample": (0.2, 4)})}
JAC_NAMES = {"2": ("omch2", "As"), "1w": ("omch2", "w0", "wa")}
# bench.py config 5 and the survey's four bins
KSZ = {"z": 0.55, "volume_gpc3": 10.0, "ngal_mpc3": 1e-4}
KSZ_CFG = {"num_kL_bins": 100, "num_kS_bins": 101, "num_mu_bins": 102,
           "xmax": 20.0}
KSZ_MS = np.geomspace(1e8, 1e16, 500)
KSZ_NXS, KSZ_SURVEY_NXS = 4096, 2048
KSZ_CLS = 1e-5 * np.ones(10000)
SURVEY = {"zcents": np.array([0.3, 0.5, 0.7, 0.9]),
          "vols_gpc3": np.array([4.0, 8.0, 12.0, 16.0]),
          "ngals": np.array([3e-4, 2e-4, 1.5e-4, 1e-4])}
MASS_FUNCTIONS = ("tinker", "tinker2008", "press-schechter", "despali")

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


def batch_theta(B):
    """bench.py's (B, 2) batch of (omch2, As)."""
    return np.column_stack([np.linspace(0.11, 0.13, B),
                            np.linspace(2.0e-9, 2.4e-9, B)])


def write_batch_golden(jpl, jnp, zs, ms, ks):
    arrays = {}
    for name, (B, rows, kw) in BATCHES.items():
        fn = jpl.make_pmm_fn(zs, ks, ms, fast=False, growth="closed", **kw)
        theta = batch_theta(B)
        arrays[f"theta_{name}"] = theta
        arrays[f"rows_{name}"] = np.asarray(rows)
        arrays[f"pmm_{name}"] = np.stack([
            np.asarray(fn({"omch2": jnp.asarray(theta[r, 0]),
                           "As": jnp.asarray(theta[r, 1])})) for r in rows])
        print(f"{name}: rows {rows}, pmm[:, 0, 0] = "
              f"{arrays[f'pmm_{name}'][:, 0, 0]!r}")
    return arrays


def write_ksz_golden(jpl, jnp):
    """config 5: the single-bin forecast with its Jacobian, and the
    four-bin survey, at the three cosmologies."""
    import jax

    fn = jpl.make_ksz_snr_fn(**KSZ, ms=KSZ_MS, nxs=KSZ_NXS, growth="closed",
                             **KSZ_CFG)
    sfn = jpl.make_ksz_survey_fn(SURVEY["zcents"].size, ms=KSZ_MS,
                                 nxs=KSZ_SURVEY_NXS, growth="closed",
                                 **KSZ_CFG)
    names = list(BENCH_OVERRIDES)
    jac_names = JAC_NAMES["2"]
    arrays = {k: [] for k in ("snr", "nvv", "vrec", "jac_snr", "total",
                              "per_bin", "bgal")}
    values = []
    for var in VARIANTS:
        ov = {**BENCH_OVERRIDES, **var}
        values.append([ov[k] for k in names])
        jov = {k: jnp.asarray(v) for k, v in ov.items()}
        for key, o in zip(("snr", "nvv", "vrec"), fn(jov, KSZ_CLS)):
            arrays[key].append(np.asarray(o))
        theta = jnp.asarray([ov[k] for k in jac_names])
        arrays["jac_snr"].append(np.asarray(jax.jacfwd(
            lambda t, ov=ov: fn({**ov, **dict(zip(jac_names, t))},
                                KSZ_CLS)[0])(theta)))
        for key, o in zip(("total", "per_bin", "bgal"),
                          sfn(jov, SURVEY["zcents"], SURVEY["vols_gpc3"],
                              SURVEY["ngals"], KSZ_CLS)):
            arrays[key].append(np.asarray(o))
        print(f"{var or 'bench'}: snr {arrays['snr'][-1]!r}, d snr "
              f"{arrays['jac_snr'][-1]!r}, survey {arrays['per_bin'][-1]!r}")
    out = {k: np.stack(v) for k, v in arrays.items()}
    out.update(param_names=np.asarray(names),
               param_values=np.asarray(values, dtype=np.float64),
               jac_names=np.asarray(jac_names), ms=KSZ_MS, cls=KSZ_CLS,
               nxs=KSZ_NXS, survey_nxs=KSZ_SURVEY_NXS,
               **{k: np.asarray(v) for k, v in {**KSZ, **KSZ_CFG}.items()},
               **SURVEY)
    return out


def write_massfn_golden(jpl, jnp, zs, ms, ks):
    """config-1 Pmm at the bench cosmology for each further mass
    function."""
    jov = {k: jnp.asarray(v) for k, v in BENCH_OVERRIDES.items()}
    pmm = []
    for mode in MASS_FUNCTIONS:
        fn = jpl.make_pmm_fn(zs, ks, ms, fast=False, growth="closed",
                             mass_function=mode)
        pmm.append(np.asarray(fn(jov)))
        print(f"{mode}: pmm[0, 0] = {pmm[-1][0, 0]!r}")
    return {"pmm": np.stack(pmm), "modes": np.asarray(MASS_FUNCTIONS),
            "param_names": np.asarray(list(BENCH_OVERRIDES)),
            "param_values": np.asarray(list(BENCH_OVERRIDES.values()),
                                       dtype=np.float64)}


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
    path = OUT[args.config]
    path.parent.mkdir(parents=True, exist_ok=True)
    if args.config == "b":
        np.savez_compressed(path, zs=zs, ms=ms, ks=ks, param_names=np.asarray(
            ("omch2", "As")), **write_batch_golden(jpl, jnp, zs, ms, ks))
        print(f"wrote {path.relative_to(REPO)} ({path.stat().st_size} bytes)")
        return
    if args.config in ("5", "m"):
        arrays = (write_ksz_golden(jpl, jnp) if args.config == "5" else
                  dict(zs=zs, ms=ms, ks=ks,
                       **write_massfn_golden(jpl, jnp, zs, ms, ks)))
        np.savez_compressed(path, **arrays)
        print(f"wrote {path.relative_to(REPO)} ({path.stat().st_size} bytes)")
        return
    variants = VARIANTS
    extra = {}
    if args.config == "1":
        fn = jpl.make_pmm_fn(zs, ks, ms, fast=False, growth="closed")
        keys = ("pmm",)
    elif args.config == "1w":
        fn = jpl.make_pmm_fn(zs, ks, ms, fast=False, growth="ode")
        keys = ("pmm",)
        variants = VARIANTS_W0WA
    elif args.config == "3":
        extra = {"ngal": np.full(zs.size, NGAL)}
        fn = jpl.make_hod_fn(zs, ks, ms, extra["ngal"], fast=False,
                             growth="closed")
        keys = ("pgg", "pgm")
    elif args.config == "4":
        extra = {"ells": ELLS, "zsource": ZSOURCE}
        fn = jpl.make_lensing_cls_fn(zs, ks, ms, ELLS, zsource=ZSOURCE,
                                     fast=False, growth="closed")
        keys = ("ckk", "pmm")
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
            f"{k}.flat[0] = {o.flat[0]!r}" for k, o in zip(keys, outs[-1])))
    arrays = {k: np.stack([o[i] for o in outs]) for i, k in enumerate(keys)}
    if args.config in JAC_NAMES:
        jac_names = JAC_NAMES[args.config]
        arrays["jac_names"] = np.asarray(jac_names)
        jacs = jpl.fisher_jacobian(fn, BENCH_OVERRIDES, jac_names)
        for k, jac in zip(keys, jacs if len(keys) > 1 else (jacs,)):
            arrays[f"jac_{k}"] = np.asarray(jac)
    if args.config == "2":
        arrays.update(nxs=NXS, xmax=XMAX)
    arrays.update(extra)
    np.savez_compressed(path, zs=zs, ms=ms, ks=ks,
                        param_names=np.asarray(names),
                        param_values=np.asarray(values, dtype=np.float64),
                        **arrays)
    print(f"wrote {path.relative_to(REPO)} ({path.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
