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

--config c: the class API, the README's example at config 1's width.
hmvec_tpu.HaloModel(zs, ks, ms=ms, params=the bench overrides) with
add_battaglia_profile("e", family="AGN"), add_battaglia_pres_profile("y")
and add_hod("g", ngal = 1e-4 per z), at the profiles' default sampling
(nxs 5000) -> hmvec_tpu_torch/data/class_config1_golden.npz with Pmm =
get_power("nfw"), Pgg, Pge, Pee and Pyy, each (20, 1001) (~60 s).

--config x: the first extension group through the JAX class at config 1's
width and the bench cosmology: HaloModel(halofit="mead") with CIB tracers
at 545 and 217 GHz and an HI tracer on the analytic NFW profile, and the
Battaglia pressure profile -> hmvec_tpu_torch/data/
extensions_config1_golden.npz with nPzk (20, 1001); P_mm_nonlinear of the
other eight halofit versions and of 'mead' under w0/wa = (-0.9, 0.2), each
at three z rows (3, 1001); get_p21 (20, 1001); CIB x y at three z rows;
get_cib_cls at 16 ells (3 pairs); the CIB mean intensities; Omega_HI and
b_HI; sigma_1h (with and without miscentering), kappa_1h and kappa_2h at
M = 3e14 Msun on 32 thetas; the BAO ratio, tau_*, z(tau), conformal time,
C_L^kk to L = 3000 on the nonlinear power, and H0 from theta100 (~3 min).

--config v: the covariance group through the JAX class at config 1's width
and the bench cosmology, on the README example's profiles (Battaglia gas
"e" and pressure "y" at nxs 5000, HOD "g") ->
hmvec_tpu_torch/data/cov_bispectrum_config1_golden.npz with the connected
C_ell covariance of "y" and Cov(C_yy, C_gg) and the super-sample one of
"y" (fsky 0.4) on 60 ells in [30, 3000]; cluster_counts_obs /
_q_bins / _covariance at q = 5, sigma_N = 1e-4, fsky 0.4, with the JAX
test's scaling and z bins [0.2, 0.6, 1.0, 1.4]; joint_counts_cl_cov(...,
"y", mmin=2e14, fsky=0.3), padded; get_pk_covariance(10 Gpc^3, "nfw"),
its four blocks' diagonals and two k rows each at three z rows; the
equilateral get_bispectrum on ks of "nfw" and of "g" with the second-order
bias at three z rows; get_angular_bispectrum("y") on the 60 ells;
get_mean_compton_y, get_tau_aperture(theta_arcmin=1.6); get_pairwise_ksz_snr
at the z nearest 0.5; C_yy on ells 2..2000 and its angular_correlation on
16 angles (~3 min).

--config rsd_nonlimber: the exact C_ell, one-loop and redshift-space
group through the JAX class at config 1's width and the bench cosmology,
on the README example's build (its HOD "g") -> hmvec_tpu_torch/data/
rsd_nonlimber_config1_golden.npz with C_gg_exact (and with RSD and
magnification), C_kg_exact and C_kk_exact (CMB lensing) on the default
2048-point chi grid at ells 2..200; C_gg_hybrid on get_power("g") and
C_kk_hybrid on get_power("nfw"); P_mm_1loop at its defaults, with and
without the IR resummation, and get_rsd_multipoles for the kaiser,
scoccimarro and tns models, on the build's 20 z and 100 ks in
[0.01, 0.3]; get_galaxy_rsd_multipoles("g") (tns, the class defaults) on
the build's 1001 ks; and fftlog_sphbessel_multi of the galaxy kernel at
four ells, with its input (~2 min).  Every JAX call is one compiled
program.

--config lensing: the weak-lensing and CMB-lensing group at the bench
cosmology on the README example's build -> hmvec_tpu_torch/data/
lensing_cmb_golden.npz: shear_cls_with_ia, C_II, C_kI, C_gI, C_gg_mag and
C_kg_mag on ells 60-2000 (examples/forecast_3x2pt.py's n(z)); xi_+, xi_-,
gamma_t and the xi_+ x xi_+/- covariance at 20 thetas; the MASTER chain of
examples/pseudo_cl.py at LMAX 500 (each coupling matrix's diagonal and
three rows, the pseudo-spectra, bandpowers, the decoupled covariance);
the resummed and first-order lensed spectra to 2,600, lensed BB, the N0
family at 40 L, n0_eb_iterative with its iteration count, n0_tt_fullsky
and n1_tt_flat_sky at 8 L, 20,000 threej000_sq triangles at L = 3,000,
on C_phiphi from cmb_lensing_limber(3000, nonlinear=True); the tabulated
get_cmb_cls and cmb_lensing_kk_exact of tests/fixtures/camb_table_fixture.npz.

--config projfield: the projected-field kSZ^2 group at the settings of
examples/projected_field_ksz2.py on the README example's build at config
1's width and the bench cosmology -> hmvec_tpu_torch/data/
projfield_config1_golden.npz: cl_ksz2_galaxy (the example's filter on l =
2..8,000, a Gaussian dndz on the build's zs, ells 100-1,600, 40 x 20
nodes), cl_ksz2_kappa on the analytic NFW profile, vrms2_linear,
hybrid_bispectrum_ttg at 64 seeded triangles, C_kg on l = 2..8,000 and
from it cl_t2_lensing, cl_t2_t2_gaussian, C_gg with shot noise and
ksz2_snr (~3 min).

--config flatsky: the map-level lensing reconstruction of
examples/lensing_qe_sim.py (n = 1,024, 1' pixels, lmax_t 2,500, L to 800,
oversample 2, 16 sims) on white noise drawn by numpy from a seed (so the
machine with the card draws the same) -> hmvec_tpu_torch/data/
flatsky_qe_golden.npz: the unlensed and lensed spectra, the TT, EE, EB N0
and the TE simple-weight response at 24 nodes, N1 at L = 100, 300, 600;
per sim the lensed map, phi_hat and its unlensed-sim twin at a fixed
sample of 4,096 elements with each array's largest |value|, and the four
binned spectra whole; on one synth_tqu draw lensed by sim 0's phi, the
EE, TE and EB phi_hat at 2,048 elements (~1 min).

--config emulator: examples/emulator_pk.py -- make_pmm_fn at 3 z x 128 k
x 96 m over (omch2, ombh2, ns), 256 + 64 Sobol' points, widths 128^3,
2,000 steps, log_y -> hmvec_tpu_torch/data/emulator_pk_golden.npz: every
16th row of the training set, JAX's initial net (float64; the float32 fit
starts at its float32 cast), the float32 fit's loss curve and held-out
errors, a 50-step float64 fit's losses and its predictions at four
held-out points; and the port's float32 fit on the CPU from the same net,
whose spread against JAX's (final loss, held-out errors) sets the card's
gate at ten times it (~2 min; imports the port too).

--config boltz_small: the Boltzmann group's solve at a reduced grid, for
the CPU tests (tests/test_torch_boltz*.py): at the default cosmology
(massless) and at mnu = 0.06 with the massive-nu fluid, the
recombination table at n = 4,096, solve_perturbations on 6 k in
[1e-4, 0.1]/Mpc with n_a 300, n_b 210 x 4, n_c 120 x 11 (below this
grid's segment-C stability edge of ~0.15/Mpc), its states, compute_sources
and matter_power_slices on the same grid at the engine's z slices (for
the fluid: both components); and at mnu = 0.06 the slices of the
massless-hierarchy solve that BoltzEngine(massive_nu="eh99") reads ->
hmvec_tpu_torch/data/boltz_small_golden.npz.  Each cosmology's JAX
programs run in a process of their own (~1-2 min together).

--config boltz: the Boltzmann group at full width, for chip_smoke.py's
boltz phase: Cosmology().get_cmb_cls(approx=True) at lmax 3,000 (total,
unlensed, lens potential) and every 4th row of the default recombination
table -> hmvec_tpu_torch/data/boltz_cmb_golden.npz; the default
BoltzEngine()'s tables and its plin at config 1's 20 z x 1001 k ->
boltz_engine_golden.npz; the README example built with engine="boltz"
(config c's spectra) -> boltz_class_golden.npz.  Two processes (~10 min).

The machine with the GPU has no JAX, so chip_smoke.py compares the port
against these files.  Each run writes only its own file.

Run from the repository root:
    JAX_PLATFORMS=cpu python tools/gen_torch_golden.py [--config 2|1w|3|4|b|5|m|c|x|v|rsd_nonlimber|lensing|projfield|flatsky|emulator|boltz_small|boltz]
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
       "m": DATA / "pmm_massfn_golden.npz",
       "c": DATA / "class_config1_golden.npz",
       "x": DATA / "extensions_config1_golden.npz",
       "v": DATA / "cov_bispectrum_config1_golden.npz",
       "rsd_nonlimber": DATA / "rsd_nonlimber_config1_golden.npz",
       "lensing": DATA / "lensing_cmb_golden.npz",
       "projfield": DATA / "projfield_config1_golden.npz",
       "flatsky": DATA / "flatsky_qe_golden.npz",
       "emulator": DATA / "emulator_pk_golden.npz",
       "boltz_small": DATA / "boltz_small_golden.npz",
       "boltz": DATA / "boltz_cmb_golden.npz"}
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


# the README's spectra of the class API: name -> get_power's arguments
CLASS_SPECTRA = {"pmm": ("nfw", None), "pgg": ("g", None),
                 "pge": ("g", "e"), "pee": ("e", "e"), "pyy": ("y", "y")}


def write_class_golden(zs, ms, ks):
    """The README example through the JAX class API at the bench
    cosmology."""
    import hmvec_tpu as hm

    ngal = np.full(zs.size, NGAL)
    hcos = hm.HaloModel(zs, ks, ms=ms, params=BENCH_OVERRIDES)
    hcos.add_battaglia_profile("e", family="AGN")
    hcos.add_battaglia_pres_profile("y")
    hcos.add_hod("g", ngal=ngal)
    out = {k: np.asarray(hcos.get_power(*names))
           for k, names in CLASS_SPECTRA.items()}
    for k, v in out.items():
        print(f"{k}[0, 0] = {v[0, 0]!r}")
    return dict(zs=zs, ms=ms, ks=ks, ngal=ngal,
                param_names=np.asarray(list(BENCH_OVERRIDES)),
                param_values=np.asarray(list(BENCH_OVERRIDES.values()),
                                        dtype=np.float64), **out)


# the extensions phase of chip_smoke.py: the halofit versions besides the
# default 'mead', the z rows kept of the row-wise spectra, the CIB
# frequencies and pairs, the C_ell and the cluster-lensing inputs
EXT_VERSIONS = ("mead2015", "mead2020", "mead2020_feedback", "takahashi",
                "original", "bird", "peacock", "casarini")
EXT_W0WA = {"w0": -0.9, "wa": 0.2}
EXT_ROWS = np.array([0, 9, 19])
EXT_NUS = {"cib545": 545.0, "cib217": 217.0}
EXT_CIB_PAIRS = (("cib545", "cib545"), ("cib545", "cib217"),
                 ("cib217", "cib217"))
EXT_ELLS = np.geomspace(100.0, 3000.0, 16)
EXT_THETAS = np.geomspace(1e-4, 1e-2, 32)
EXT_CLUSTER = {"M": 3e14, "conc": 5.0, "zsource": 1100.0, "sig_theta": 2e-4}
EXT_TAUS = np.array([1000.0, 5000.0, 10000.0])
EXT_THETA100 = 1.0411
EXT_LMAX = 3000


def write_extensions_golden(zs, ms, ks):
    """The first extension group through the JAX class API at the bench
    cosmology (the satellite profile of the CIB and HI tracers is the
    analytic NFW; the port's phase puts them on the fast one)."""
    import jax.numpy as jnp
    import hmvec_tpu as hm

    hcos = hm.HaloModel(zs, ks, ms=ms, params=BENCH_OVERRIDES,
                        halofit="mead")
    for name, nu in EXT_NUS.items():
        hcos.add_cib_tracer(name, nu)
    hcos.add_battaglia_pres_profile("y")
    hcos.add_hi_tracer("hi")
    zr = zs[EXT_ROWS]
    out = {"npzk": hcos.nPzk}
    for v in EXT_VERSIONS:
        out[f"pnl_{v}"] = hcos.P_mm_nonlinear(ks, zr, v)
    ode = hm.Cosmology({**BENCH_OVERRIDES, **EXT_W0WA})
    out["pnl_ode_mead"] = ode.P_mm_nonlinear(ks, zr, "mead")
    out["p21"] = hcos.get_p21("hi")
    out["omega_hi"] = hcos.get_omega_hi("hi")
    out["b_hi"] = hcos.get_hi_bias("hi")
    out["cib_y"] = hcos.get_power("cib545", "y")[EXT_ROWS]
    out["cib_cls"] = jnp.stack([hcos.get_cib_cls(EXT_ELLS, a, b)
                                for a, b in EXT_CIB_PAIRS])
    out["cib_intensity"] = jnp.stack([hcos.get_cib_mean_intensity(n)
                                      for n in EXT_NUS])
    c = EXT_CLUSTER
    out["sigma_1h"] = hcos.sigma_1h_profiles(EXT_THETAS, c["M"], c["conc"])
    out["sigma_1h_off"] = hcos.sigma_1h_profiles(
        EXT_THETAS, c["M"], c["conc"], sig_theta=c["sig_theta"])
    out["kappa_1h"] = hcos.kappa_1h_profiles(EXT_THETAS, c["M"], c["conc"],
                                             c["zsource"])
    out["kappa_2h"] = hcos.kappa_2h_profiles(EXT_THETAS, c["M"],
                                             c["zsource"])
    out["bao_rs_dv"] = hcos.get_bao_rs_dV(zs)
    out["tau_star"] = hcos.get_tau_star()
    out["z_of_tau"] = hcos.z_of_tau(EXT_TAUS)
    out["conformal_time"] = hcos.conformal_time(zs)
    out["cl_kk_nl"] = hcos.cmb_lensing_limber(EXT_LMAX, nonlinear=True)[1]
    out["h0_theta100"] = hm.Cosmology(
        {**BENCH_OVERRIDES, "theta100": EXT_THETA100}).p["H0"]
    out = {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}
    for k, v in out.items():
        print(f"{k}{v.shape}: flat[0] = {v.flat[0]!r}")
    return dict(zs=zs, ms=ms, ks=ks, rows=EXT_ROWS, ells=EXT_ELLS,
                thetas=EXT_THETAS, taus=EXT_TAUS,
                nus=np.asarray(list(EXT_NUS.values())),
                cib_pairs=np.asarray([[list(EXT_NUS).index(n) for n in pair]
                                      for pair in EXT_CIB_PAIRS]),
                w0wa=np.asarray([EXT_W0WA["w0"], EXT_W0WA["wa"]]),
                cluster=np.asarray([EXT_CLUSTER[k] for k in
                                    ("M", "conc", "zsource", "sig_theta")]),
                theta100=EXT_THETA100, lmax=EXT_LMAX,
                param_names=np.asarray(list(BENCH_OVERRIDES)),
                param_values=np.asarray(list(BENCH_OVERRIDES.values()),
                                        dtype=np.float64), **out)


# the cov_bispectrum phase of chip_smoke.py: the C_ell multipoles, the
# count selection (the JAX package's test scaling, tests/test_cluster_counts
# .py), the z and k rows kept of the (nz, nk, nk) and (nz, nk) outputs, the
# pairwise-kSZ survey and the angles of the correlation function
COV_ELLS = np.geomspace(30.0, 3000.0, 60)
COV_SCALING = dict(lnYstar=np.log(2.4e-4), alpha=1.79, beta=2.0 / 3.0,
                   Mpivot=6e14, sigma_lnY=0.25)
COV_COUNTS = {"q": 5.0, "sigma_noise": 1e-4, "fsky": 0.4}
COV_Q_EDGES = np.array([5.0, 6.0, 8.0, np.inf])
COV_Z_EDGES = np.array([0.2, 0.6, 1.0, 1.4])
COV_JOINT = {"mmin": 2e14, "fsky": 0.3}
COV_ROWS = np.array([0, 9, 19])
COV_K_ROWS = np.array([200, 700])
COV_VOLUME = 10.0
COV_PAIRWISE = {"z": 0.5, "ngal_mpc3": 1e-4, "volume_gpc3": 10.0,
                "sigma_meas_uK": 2.0, "theta_arcmin": 1.6}
COV_R_EDGES = np.linspace(20.0, 150.0, 9)
COV_CF_ELLS = np.arange(2, 2001)
COV_THETAS = np.geomspace(1e-4, 0.1, 16)


def write_cov_bispectrum_golden(zs, ms, ks):
    """The covariance group through the JAX class API at the bench
    cosmology, on the README example's profiles."""
    import jax.numpy as jnp
    import hmvec_tpu as hm
    from hmvec_tpu.models import cov as jcov
    from hmvec_tpu.models import pairwise as jpw

    ngal = np.full(zs.size, NGAL)
    hcos = hm.HaloModel(zs, ks, ms=ms, params=BENCH_OVERRIDES)
    hcos.add_battaglia_profile("e", family="AGN")
    hcos.add_battaglia_pres_profile("y")
    hcos.add_hod("g", ngal=ngal)
    out = {"t1h_yy": hcos.get_cl_cov_t1h(COV_ELLS, "y"),
           "t1h_yy_gg": hcos.get_cl_cov_t1h(COV_ELLS, "y", name3="g",
                                            name4="g"),
           "ssc_yy": hcos.get_cl_cov_ssc(COV_ELLS, "y", fsky=0.4)}
    c = COV_COUNTS
    out["dndz_obs"], out["n_obs"] = hcos.cluster_counts_obs(
        c["q"], c["sigma_noise"], fsky=c["fsky"], **COV_SCALING)
    out["q_bins"] = hcos.cluster_counts_q_bins(
        COV_Q_EDGES, c["sigma_noise"], fsky=c["fsky"], z_edges=COV_Z_EDGES,
        **COV_SCALING)
    out["n_cov"], out["counts_cov"] = hcos.cluster_counts_covariance(
        COV_Z_EDGES, fsky=c["fsky"], q=c["q"], sigma_noise=c["sigma_noise"],
        **COV_SCALING)
    out["n_joint"], out["joint_cov"] = hcos.joint_counts_cl_cov(
        COV_Z_EDGES, COV_ELLS, "y", **COV_JOINT)
    pk = hcos.get_pk_covariance(COV_VOLUME, "nfw")
    for key in ("gauss", "t1h", "ssc", "total"):
        block = pk[key][COV_ROWS]
        out[f"pk_{key}_diag"] = jnp.diagonal(block, axis1=1, axis2=2)
        out[f"pk_{key}_rows"] = block[:, COV_K_ROWS]
    out["b_nfw"] = hcos.get_bispectrum()[COV_ROWS]
    out["b_g_b2"] = hcos.get_bispectrum(name="g", include_b2=True)[COV_ROWS]
    out["b_ang_y"] = hcos.get_angular_bispectrum(COV_ELLS, name="y")
    out["mean_y"] = hcos.get_mean_compton_y()
    p = COV_PAIRWISE
    out["tau_ap"] = hcos.get_tau_aperture(theta_arcmin=p["theta_arcmin"])
    iz = int(np.argmin(np.abs(zs - p["z"])))
    pw = jpw.get_pairwise_ksz_snr(hcos, iz, p["ngal_mpc3"], p["volume_gpc3"],
                                  p["sigma_meas_uK"], COV_R_EDGES,
                                  theta_arcmin=p["theta_arcmin"])
    for key in ("snr", "T_bins", "sigma_bins", "tau_bar"):
        out[f"pairwise_{key}"] = pw[key]
    out["cl_yy"] = hcos.C_yy(COV_CF_ELLS, zs, ks, hcos.get_power("y"))
    out["w_yy"] = jcov.angular_correlation(COV_CF_ELLS, out["cl_yy"],
                                           COV_THETAS)
    out = {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}
    for k, v in out.items():
        print(f"{k}{v.shape}: flat[0] = {v.flat[0]!r}")
    return dict(zs=zs, ms=ms, ks=ks, ngal=ngal, ells=COV_ELLS,
                scaling=np.asarray([COV_SCALING[k] for k in (
                    "lnYstar", "alpha", "beta", "Mpivot", "sigma_lnY")]),
                counts=np.asarray([c["q"], c["sigma_noise"], c["fsky"]]),
                q_edges=COV_Q_EDGES, z_edges=COV_Z_EDGES,
                joint=np.asarray([COV_JOINT["mmin"], COV_JOINT["fsky"]]),
                rows=COV_ROWS, k_rows=COV_K_ROWS, volume_gpc3=COV_VOLUME,
                pairwise=np.asarray([p[k] for k in (
                    "z", "ngal_mpc3", "volume_gpc3", "sigma_meas_uK",
                    "theta_arcmin")]),
                pairwise_iz=iz, r_edges=COV_R_EDGES, cf_ells=COV_CF_ELLS,
                thetas=COV_THETAS,
                param_names=np.asarray(list(BENCH_OVERRIDES)),
                param_values=np.asarray(list(BENCH_OVERRIDES.values()),
                                        dtype=np.float64), **out)


# the rsd_nonlimber phase of chip_smoke.py: the multipoles, the galaxy
# sample and lensing source of the exact C_ell, the loops' ks, the bias
RN_ELLS = np.arange(2, 201)
RN_GZS = np.linspace(0.05, 2.0, 100)
RN_GDNDZ = np.exp(-0.5 * ((RN_GZS - 0.7) / 0.25) ** 2)
RN_BIAS, RN_SMAG, RN_LZS = 1.8, 0.4, 1100.0
RN_KS = np.geomspace(0.01, 0.3, 100)
RN_FFT_ELLS = (2, 10, 50, 200)


def write_rsd_nonlimber_golden(zs, ms, ks):
    """The exact C_ell, one-loop and redshift-space group through the JAX
    class API at the bench cosmology, on the README example's build."""
    import jax
    import jax.numpy as jnp
    import hmvec_tpu as hm
    from hmvec_tpu.models import nonlimber as jnl
    from hmvec_tpu.ops import fftlog as jfft

    def jit(fn):
        def body():
            with jax.ensure_compile_time_eval():
                return fn()
        return jax.jit(body)()

    ngal = np.full(zs.size, NGAL)
    hcos = hm.HaloModel(zs, ks, ms=ms, params=BENCH_OVERRIDES)
    hcos.add_battaglia_profile("e", family="AGN")
    hcos.add_battaglia_pres_profile("y")
    hcos.add_hod("g", ngal=ngal)
    pk0 = np.asarray(hcos.P_lin(ks, np.array([0.0]))[0])
    pgg = np.asarray(hcos.get_power("g"))
    pmm = np.asarray(hcos.get_power("nfw"))
    chis = jnl.chi_loggrid()
    ells = RN_ELLS
    gal = dict(bias=RN_BIAS)
    out = {}
    out["c_gg"], out["c_gg_rsd_smag"], out["c_kg"], out["c_kk"] = jit(
        lambda: (hcos.C_gg_exact(ells, ks, pk0, RN_GZS, RN_GDNDZ, **gal),
                 hcos.C_gg_exact(ells, ks, pk0, RN_GZS, RN_GDNDZ, rsd=True,
                                 smag=RN_SMAG, **gal),
                 hcos.C_kg_exact(ells, ks, pk0, RN_GZS, RN_GDNDZ,
                                 lzs=RN_LZS, **gal),
                 hcos.C_kk_exact(ells, ks, pk0, lzs1=RN_LZS)))
    out["c_gg_hybrid"], out["c_kk_hybrid"] = jit(
        lambda: (hcos.C_gg_hybrid(ells, ks, pk0, zs, pgg, RN_GZS, RN_GDNDZ,
                                  **gal),
                 hcos.C_kk_hybrid(ells, ks, pk0, zs, pmm, lzs1=RN_LZS,
                                  lzs2=RN_LZS)))
    out["p1loop"], out["p1loop_ir"] = jit(
        lambda: (hcos.P_mm_1loop(zs, RN_KS),
                 hcos.P_mm_1loop(zs, RN_KS, ir_resum=True)))
    for model in ("kaiser", "scoccimarro", "tns"):
        mp = jit(lambda: hcos.get_rsd_multipoles(zs, RN_KS, b=RN_BIAS,
                                                 model=model))
        for ell, v in mp.items():
            out[f"rsd_{model}_{ell}"] = v
    mp = jit(lambda: hcos.get_galaxy_rsd_multipoles("g"))
    for ell, v in mp.items():
        out[f"galaxy_tns_{ell}"] = v
    # the multi-l transform of the galaxy kernel as bessel_deltas feeds it
    phi = jit(lambda: jnl.galaxy_kernel(hcos.bg, chis, RN_GZS, RN_GDNDZ,
                                        RN_BIAS))
    fx = np.asarray(phi) * jnl._edge_taper(chis.size, 0.03) / chis**2
    out["fft_fx"] = fx
    out["fft_ks"], out["fft_F"] = jax.jit(
        lambda f: jfft.fftlog_sphbessel_multi(
            f, chis, RN_FFT_ELLS, lnkr=jfft.fftlog_lnkr(chis, mu=0.5)))(fx)
    out = {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}
    for k, v in out.items():
        print(f"{k}{v.shape}: flat[0] = {v.flat[0]!r}")
    return dict(zs=zs, ms=ms, ks=ks, ngal=ngal, ells=ells, gzs=RN_GZS,
                gdndz=RN_GDNDZ,
                scalars=np.asarray([RN_BIAS, RN_SMAG, RN_LZS]),
                rsd_ks=RN_KS, fft_ells=np.asarray(RN_FFT_ELLS),
                param_names=np.asarray(list(BENCH_OVERRIDES)),
                param_values=np.asarray(list(BENCH_OVERRIDES.values()),
                                        dtype=np.float64), **out)


# the lensing phase of chip_smoke.py: examples/forecast_3x2pt.py's ells
# (:33-34), lens n(z) (:29-30) and source n(z) (:114-116); the IA and
# magnification parameters of tests/test_ia.py; 20 thetas over 2.5-250
# arcmin; a DES-like shape noise; examples/pseudo_cl.py's MASTER chain
# (LMAX 500, a 40-degree cap); the synthetic CMB spectra of
# tests/test_lensing_noise.py at lmax 3,000 (with a TE made the same way)
# and examples/cmb_forecast.py's L grid (:50)
LC_ELLS = np.arange(60, 2001)
LC_GZS = np.linspace(0.3, 0.95, 40)
LC_GDNDZ = np.exp(-0.5 * ((LC_GZS - 0.6) / 0.12) ** 2)
LC_SZS = np.linspace(0.5, 1.3, 30)
LC_SDNDZ = np.exp(-0.5 * ((LC_SZS - 0.9) / 0.1) ** 2)
LC_IA = {"A_ia": 0.9, "eta_ia": -0.7, "z0": 0.62}
LC_SMAG = 0.85
LC_THETAS = np.deg2rad(np.geomspace(2.5, 250.0, 20) / 60.0)
LC_SHAPE_NOISE = 0.26**2 / (6.0 * 1.18e7)     # sigma_e^2 / n, 6 / arcmin^2
LC_FSKY = 0.12
LC_LMAX_M = 500
LC_CAP = np.deg2rad(40.0)
LC_EDGES = np.unique(np.geomspace(30, LC_LMAX_M + 1, 9).astype(int))
LC_ROWS = np.array([30, 200, 450])
LC_LMAX = 3000
LC_LMAX_OUT = 2600
LC_LS = np.unique(np.geomspace(20, 2000, 40).astype(int)).astype(float)
LC_LS8 = LC_LS[::5]
LC_NOISE = (10.0, 1.4)                        # muK-arcmin, arcmin
LC_FIXTURE = REPO / "tests" / "fixtures" / "camb_table_fixture.npz"
LC_FIXTURE_LMAX = 600
LC_3J = 20000


def lensing_cmb_inputs():
    """The synthetic unlensed TT, EE, TE at lmax 3,000 (the recipe of
    tests/test_lensing_noise.py) and the triangles of the threej000_sq
    check: (l1, L = 3000, l2) with l1, l2 in [30, 3000], drawn from a
    seed."""
    l = np.arange(LC_LMAX + 1, dtype=np.float64)
    ls = np.maximum(l, 1.0)
    dl_tt = 2500.0 * np.exp(-((l / 1800.0) ** 2)) \
        * (1.0 + 0.25 * np.sin(l / 48.0)) + 20.0
    dl_ee = 40.0 * np.exp(-((l / 1500.0) ** 2)) \
        * (1.0 + 0.4 * np.sin(l / 48.0 + 1.0)) + 0.5
    dl_te = 100.0 * np.exp(-((l / 1500.0) ** 2)) * np.sin(l / 48.0 + 0.5)
    cls = [2.0 * np.pi * d / (ls * (ls + 1.0)) for d in (dl_tt, dl_ee, dl_te)]
    for c in cls:
        c[:2] = 0.0
    rng = np.random.default_rng(3000)
    tri = rng.integers(30, LC_LMAX + 1, (2, LC_3J)).astype(np.int16)
    return (*cls, tri)


def clpp_from_clkk(ells_kk, clkk, lmax):
    """C_phiphi on integer L from a C_kappakappa row (examples/
    cmb_forecast.py:52-55)."""
    L = np.arange(lmax + 1, dtype=float)
    clkk_int = np.interp(L, np.asarray(ells_kk), np.asarray(clkk))
    clpp = np.zeros(lmax + 1)
    clpp[2:] = 4.0 * clkk_int[2:] / (L[2:] * (L[2:] + 1.0)) ** 2
    return clpp


def write_lensing_cmb_golden(zs, ms, ks):
    """The weak-lensing and CMB-lensing group at the bench cosmology on the
    README example's build: IA and magnification spectra, xi_+/-,
    gamma_t and their covariance, the MASTER chain (each matrix's diagonal
    and three rows, not the 501^2 matrices), lensed spectra, the N0 family,
    N0 full sky, N1, iterative EB delensing, the tabulated CMB spectra."""
    import jax
    import jax.numpy as jnp
    import hmvec_tpu as hm
    from hmvec_tpu.models import lensing_noise as jln
    from hmvec_tpu.models import master as jmst
    from hmvec_tpu.models import shear as jsh

    def jit(fn):
        def body():
            with jax.ensure_compile_time_eval():
                return fn()
        return jax.jit(body)()

    ngal = np.full(zs.size, NGAL)
    hcos = hm.HaloModel(zs, ks, ms=ms, params=BENCH_OVERRIDES)
    hcos.add_battaglia_profile("e", family="AGN")
    hcos.add_battaglia_pres_profile("y")
    hcos.add_hod("g", ngal=ngal)
    pmm = np.asarray(hcos.get_power("nfw"))
    pgm = np.asarray(hcos.get_power("g", "nfw"))
    pgg = np.asarray(hcos.get_power("g"))
    out = {}
    ells, ia = LC_ELLS, LC_IA
    sh = jit(lambda: hcos.shear_cls_with_ia(ells, zs, ks, pmm, LC_SZS,
                                            LC_SDNDZ, **ia))
    for k, v in sh.items():
        out[f"shear_{k}"] = v
    gdndz_s = np.exp(-0.5 * ((LC_SZS - 0.6) / 0.12) ** 2)
    out["c_ii"], out["c_ki"], out["c_gi"] = jit(lambda: (
        hcos.C_II(ells, zs, ks, pmm, LC_SZS, LC_SDNDZ, **ia),
        hcos.C_kI(ells, zs, ks, pmm, LC_SZS, LC_SDNDZ, lzs=1100.0, **ia),
        hcos.C_gI(ells, zs, ks, pgm, LC_SZS, gdndz_s, LC_SDNDZ, **ia)))
    gmag = jit(lambda: hcos.C_gg_mag(ells, zs, ks, pgg, pgm, pmm, LC_GZS,
                                     LC_GDNDZ, LC_SMAG))
    kmag = jit(lambda: hcos.C_kg_mag(ells, zs, ks, pgm, pmm, LC_GZS,
                                     LC_GDNDZ, LC_SMAG, lzs=LC_SZS,
                                     ldndz=LC_SDNDZ))
    for k, v in gmag.items():
        out[f"gg_mag_{k}"] = v
    for k, v in kmag.items():
        out[f"kg_mag_{k}"] = v
    # real space
    tot = np.asarray(sh["total"]) + LC_SHAPE_NOISE
    out["xi_plus"], out["xi_minus"], out["gamma_t"] = jax.jit(
        lambda c, k: (jsh.xi_plus(ells, c, LC_THETAS,
                                  input_kind="convergence"),
                      jsh.xi_minus(ells, c, LC_THETAS,
                                   input_kind="convergence"),
                      jsh.gamma_t(ells, k, LC_THETAS)))(
        np.asarray(sh["total"]), np.asarray(kmag["total"]))
    out["xi_cov_pp"], out["xi_cov_pm"] = jax.jit(lambda t: (
        jsh.xi_gaussian_cov(ells, t, t, t, t, LC_THETAS, "plus", "plus",
                            fsky=LC_FSKY),
        jsh.xi_gaussian_cov(ells, t, t, t, t, LC_THETAS, "plus", "minus",
                            fsky=LC_FSKY)))(tot)
    # MASTER
    lm = LC_LMAX_M
    ells_m = np.arange(2, lm + 1, dtype=np.float64)
    cl_gg, cl_kk, cl_gk = (np.asarray(c) for c in jit(lambda: (
        hcos.C_gg(ells_m, zs, ks, pgg, LC_GZS, gdndz=LC_GDNDZ),
        hcos.C_kk(ells_m, zs, ks, pmm, lzs1=LC_SZS, ldndz1=LC_SDNDZ,
                  lzs2=LC_SZS, ldndz2=LC_SDNDZ),
        hcos.C_kg(ells_m, zs, ks, pgm, LC_GZS, gdndz=LC_GDNDZ, lzs=LC_SZS,
                  ldndz=LC_SDNDZ))))
    cl = np.zeros((3, lm + 1))
    cl[:, 2:] = cl_gg, cl_kk, cl_gk
    wl = np.asarray(jmst.cap_mask_cl(2 * lm, LC_CAP))
    out["cap_mask"] = wl
    nl_g = 1.0 / (6.0 * 1.18e7)
    tt = cl[0] + nl_g
    ee, bb = cl[1] + LC_SHAPE_NOISE, np.full(lm + 1, LC_SHAPE_NOISE)

    def master(w, tt, ee, bb, gk):
        m00 = jmst.coupling_matrix(lm, w, (0, 0))
        m02 = jmst.coupling_matrix(lm, w, (0, 2))
        m22 = jmst.coupling_matrix(lm, w, (2, 2))
        p00 = jmst.couple_cls(m00, tt)
        p02 = jmst.couple_cls(m02, gk)
        pee, pbb = jmst.couple_cls(m22, (ee, bb))
        cov = jmst.gaussian_covariance_nka(lm, w, tt, tt, tt, tt)
        return {"m00": m00, "m02": m02, "mpp": m22["++"],
                "mmm": m22["--"], "pseudo_00": p00, "pseudo_02": p02,
                "pseudo_ee": pee, "pseudo_bb": pbb,
                "bp_00": jmst.decouple_bandpowers(m00, p00, lm, LC_EDGES),
                "bp_02": jmst.decouple_bandpowers(m02, p02, lm, LC_EDGES),
                "bp_ee_bb": jnp.stack(jmst.decouple_bandpowers(
                    m22, (pee, pbb), lm, LC_EDGES)),
                "cov_nka": cov,
                "cov_bp": jmst.decoupled_covariance(m00, cov, lm, LC_EDGES)}

    res = {k: np.asarray(v) for k, v in jax.jit(master)(
        wl, tt, ee, bb, cl[2]).items()}
    for k in ("m00", "m02", "mpp", "mmm", "cov_nka"):
        mat = res.pop(k)
        out[f"{k}_diag"] = np.diag(mat)
        out[f"{k}_rows"] = mat[LC_ROWS]
    out.update({f"master_{k}": v for k, v in res.items()})
    # CMB lensing
    cl_tt, cl_ee, cl_te, tri = lensing_cmb_inputs()
    ells_kk, clkk = hcos.cmb_lensing_limber(LC_LMAX, nonlinear=True)
    clpp = clpp_from_clkk(ells_kk, clkk, LC_LMAX)
    out["clpp"] = clpp
    unl = np.stack([cl_tt, cl_ee, np.zeros_like(cl_tt), cl_te], -1)
    lv = np.arange(LC_LMAX + 1, dtype=np.float64)
    nl_t = np.asarray(jln.white_noise_nl(lv, *LC_NOISE))
    nl_p = np.asarray(jln.white_noise_nl(lv, LC_NOISE[0] * np.sqrt(2.0),
                                         LC_NOISE[1]))
    out["lensed_resummed"] = np.asarray(hm.lens_cls_flat_sky_resummed(
        unl, clpp, lmax_out=LC_LMAX_OUT))
    out["lensed_first_order"] = np.asarray(hm.lens_cls_flat_sky(
        unl, clpp, lmax_out=LC_LMAX_OUT))
    bb_l = np.asarray(hm.lensed_bb_from_ee(cl_ee, clpp, lmax_out=LC_LMAX))
    out["lensed_bb"] = bb_l
    tot_tt = np.asarray(hm.total_cl_tt(cl_tt, *LC_NOISE))
    tot_ee, tot_bb = cl_ee + nl_p, bb_l + nl_p
    Ls = LC_LS
    kw = dict(lmin=30, lmax=LC_LMAX)
    out["n0_tt"] = np.asarray(hm.n0_flat_sky(Ls, "TT", cl_tt, tot_tt, **kw))
    out["n0_ee"] = np.asarray(hm.n0_flat_sky(Ls, "EE", cl_ee, tot_ee, **kw))
    out["n0_eb"] = np.asarray(hm.n0_flat_sky(Ls, "EB", cl_ee, tot_ee,
                                             cl_total2=tot_bb, **kw))
    grad = {"TT": cl_tt, "EE": cl_ee, "TE": cl_te}
    total = {"TT": tot_tt, "EE": tot_ee, "BB": tot_bb, "TE": cl_te}
    out["n0_pair_te"] = np.asarray(hm.n0_pair_flat_sky(Ls, "TE", grad, total,
                                                       **kw))
    out["n0_pair_tb"] = np.asarray(hm.n0_pair_flat_sky(Ls, "TB", grad, total,
                                                       **kw))
    out["n0_cross_tt_te"] = np.asarray(hm.n0_cross_flat_sky(
        Ls, "TT", "TE", grad, total, **kw))
    n_mv, N = hm.n0_mv_flat_sky(Ls, grad, total, return_matrix=True, **kw)
    out["n0_mv"], out["n0_mv_matrix"] = np.asarray(n_mv), np.asarray(N)
    it, info = hm.n0_eb_iterative(Ls, cl_ee, tot_ee, clpp, nl_p,
                                  return_info=True, **kw)
    out["n0_eb_iterative"] = np.asarray(it)
    out["n0_eb_iters"] = np.asarray(info["iters"])
    out["n0_tt_fullsky"] = np.asarray(hm.n0_tt_fullsky(LC_LS8, cl_tt, tot_tt,
                                                       **kw))
    out["n1_tt"] = np.asarray(hm.n1_tt_flat_sky(LC_LS8, cl_tt, tot_tt, clpp,
                                                **kw))
    out["threej"] = np.asarray(hm.threej000_sq(
        tri[0].astype(float), float(LC_LMAX), tri[1].astype(float)))
    # the tabulated CMB spectra
    table = dict(np.load(LC_FIXTURE))
    cmb = hm.Cosmology(params=BENCH_OVERRIDES, cls_table=table)
    for k, v in cmb.get_cmb_cls(lmax=LC_FIXTURE_LMAX).items():
        out[f"cmb_{k}"] = v
    out["kk_exact"] = cmb.cmb_lensing_kk_exact(LC_FIXTURE_LMAX)[1]
    out = {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}
    for k, v in out.items():
        print(f"{k}{v.shape}: flat[0] = {v.flat[0]!r}")
    print(f"n0_eb_iterative: {int(out['n0_eb_iters'])} iterations")
    return dict(zs=zs, ms=ms, ks=ks, ngal=ngal, ells=ells, gzs=LC_GZS,
                gdndz=LC_GDNDZ, szs=LC_SZS, sdndz=LC_SDNDZ,
                gdndz_on_szs=gdndz_s,
                ia=np.asarray([ia["A_ia"], ia["eta_ia"], ia["z0"]]),
                scalars=np.asarray([LC_SMAG, LC_SHAPE_NOISE, LC_FSKY,
                                    nl_g, *LC_NOISE]),
                thetas=LC_THETAS, lmax_m=np.asarray(lm), cap=np.asarray(
                    LC_CAP), edges=LC_EDGES, rows=LC_ROWS,
                unlensed=unl, lmax_out=np.asarray(LC_LMAX_OUT), Ls=Ls,
                Ls8=LC_LS8, tri=tri, fixture_lmax=np.asarray(LC_FIXTURE_LMAX),
                param_names=np.asarray(list(BENCH_OVERRIDES)),
                param_values=np.asarray(list(BENCH_OVERRIDES.values()),
                                        dtype=np.float64), **out)


# the projfield phase: examples/projected_field_ksz2.py's settings
PF_ELLS = np.array([100.0, 200.0, 400.0, 700.0, 1100.0, 1600.0])
PF_NODES = {"n_radial": 40, "n_angle": 20}
PF_NOISE = (6.0, 1.4)          # muK-arcmin, beam FWHM arcmin
PF_FSKY = 0.4
PF_NTRI = 64


def projfield_filter(nl):
    """The example's filter b_l / (C_l^TT + N_l) and C_l^TT on l = 2..8,000
    (nl: the white noise there)."""
    fgrid = np.arange(2.0, 8001.0)
    cl_tt = 2.0 * np.pi * 2500.0 / (fgrid * (fgrid + 1.0) ** 2) \
        * np.exp(-((fgrid / 3500.0) ** 2))
    fvals = np.exp(-0.5 * (fgrid * 1.4 * np.pi / 10800.0 / 2.355) ** 2) \
        / (cl_tt + nl)
    return fgrid, cl_tt, fvals


def write_projfield_golden(zs, ms, ks):
    """The projected-field kSZ^2 group on the README example's build."""
    import jax
    import hmvec_tpu as hm
    from hmvec_tpu.models import limber as jlimb
    from hmvec_tpu.models import projfield as jpf
    from hmvec_tpu.models.lensing_noise import white_noise_nl

    def jit(fn):
        def body():
            with jax.ensure_compile_time_eval():
                return fn()
        return np.asarray(jax.jit(body)())

    ngal = np.full(zs.size, NGAL)
    hcos = hm.HaloModel(zs, ks, ms=ms, params=BENCH_OVERRIDES)
    hcos.add_battaglia_profile("e", family="AGN")
    hcos.add_battaglia_pres_profile("y")
    hcos.add_hod("g", ngal=ngal)
    fgrid = np.arange(2.0, 8001.0)
    nl = np.asarray(white_noise_nl(fgrid, *PF_NOISE))
    fgrid, cl_tt, fvals = projfield_filter(nl)
    table = (fgrid, fvals)
    dndz = np.exp(-0.5 * ((zs - 0.6) / 0.25) ** 2)
    tri = np.random.default_rng(1600).uniform(50.0, 3000.0, (3, PF_NTRI))
    out = {}
    out["ksz2_g"] = jit(lambda: jpf.cl_ksz2_galaxy(
        hcos, PF_ELLS, table, gdndz=dndz, **PF_NODES))
    print("ksz2_g", out["ksz2_g"])
    out["ksz2_k"] = jit(lambda: jpf.cl_ksz2_kappa(hcos, PF_ELLS, table,
                                                  **PF_NODES))
    out["vrms2"] = jit(lambda: jpf.vrms2_linear(hcos))
    out["hybrid"] = jit(lambda: jpf.hybrid_bispectrum_ttg(hcos, *tri,
                                                          gdndz=dndz))
    pgm = np.asarray(hcos.get_power("g", name2="nfw"))
    pgg = np.asarray(hcos.get_power("g", name2="g"))
    out["ckg"] = jit(lambda: jlimb.C_kg(hcos.bg, fgrid, zs, ks, pgm, zs,
                                        gdndz=dndz, lzs=1100.0))
    cl_phig = 2.0 * out["ckg"] / fgrid**2
    out["t2_lensing"] = jit(lambda: jpf.cl_t2_lensing(
        PF_ELLS, table, cl_tt, cl_phig, lmin=2.0, lmax=8000.0))
    out["t2_t2"] = jit(lambda: jpf.cl_t2_t2_gaussian(
        PF_ELLS, table, cl_tt + nl, lmin=2.0, lmax=8000.0))
    chis = np.asarray(hcos.comoving_radial_distance(zs))
    hzs = np.asarray(hcos.h_of_z(zs))
    ngal2d = NGAL * np.trapezoid(chis**2 / hzs * dndz
                                 / np.trapezoid(dndz, zs), zs)
    out["clgg"] = jit(lambda: jlimb.C_gg(hcos.bg, PF_ELLS, zs, ks, pgg, zs,
                                         gdndz=dndz)) + 1.0 / ngal2d
    snr2, snr = jax.jit(lambda a, b, c: jpf.ksz2_snr(PF_ELLS, a, b, c,
                                                     fsky=PF_FSKY))(
        out["ksz2_g"], out["t2_t2"], out["clgg"])
    out["snr2"], out["snr"] = np.asarray(snr2), np.asarray(snr)
    print("t2_lensing", out["t2_lensing"], "snr", out["snr"])
    return dict(zs=zs, ms=ms, ks=ks, ngal=ngal, ells=PF_ELLS, tri=tri,
                nodes=np.asarray([PF_NODES["n_radial"],
                                  PF_NODES["n_angle"]]),
                noise=np.asarray(PF_NOISE), fsky=np.asarray(PF_FSKY),
                param_names=np.asarray(list(BENCH_OVERRIDES)),
                param_values=np.asarray(list(BENCH_OVERRIDES.values()),
                                        dtype=np.float64), **out)


# the flatsky phase: examples/lensing_qe_sim.py's settings
FS = {"n": 1024, "pix": 1.0, "lmax_t": 2500, "lmax_rec": 800, "nsims": 16,
      "oversample": 2, "noise_t": 7.0, "beam": 1.4, "seed": 1024}
FS_NSAMPLE, FS_NSAMPLE_POL = 4096, 2048
FS_BINS = np.linspace(40.0, 600.0, 12)
FS_LN1 = np.array([100.0, 300.0, 600.0])


def flatsky_spectra():
    """The example's unlensed TT (with the EE and TE of the lensing
    phase's recipe) on l = 0..lmax_t + 400, as (lmax+1, 4) [TT, EE, BB,
    TE], and its C_phiphi on L = 0..1,200."""
    lpad = FS["lmax_t"] + 400
    l = np.arange(lpad + 1, dtype=np.float64)
    ls = np.maximum(l, 1.0)
    dl_tt = 2500.0 * np.exp(-((l / 1800.0) ** 2)) \
        * (1.0 + 0.25 * np.sin(l / 48.0)) + 20.0
    dl_ee = 40.0 * np.exp(-((l / 1500.0) ** 2)) \
        * (1.0 + 0.4 * np.sin(l / 48.0 + 1.0)) + 0.5
    dl_te = 100.0 * np.exp(-((l / 1500.0) ** 2)) * np.sin(l / 48.0 + 0.5)
    unl = np.zeros((lpad + 1, 4))
    for col, d in ((0, dl_tt), (1, dl_ee), (3, dl_te)):
        unl[:, col] = 2.0 * np.pi * d / (ls * (ls + 1.0))
    unl[:2] = 0.0
    Lpp = np.arange(1201, dtype=np.float64)
    q = np.maximum(Lpp, 1.0) / 50.0
    clpp = 2.0 * np.pi * (1.5e-7 * q / (1.0 + q**3.2) ** 0.8) \
        / (np.maximum(Lpp, 1.0) * (Lpp + 1.0)) ** 2
    clpp[:2] = 0.0
    return unl, clpp


def flatsky_noise():
    """Unit white noise: (nsims, 3, n, n) for each sim's T, phi and noise
    maps, then (2, n, n) for the polarized draw, from one numpy seed."""
    n = FS["n"]
    rng = np.random.default_rng(FS["seed"])
    w = rng.standard_normal((FS["nsims"], 3, n, n))
    return w, rng.standard_normal((2, n, n))


def flatsky_samples():
    """Fixed flat indices: into a (nsims, n, n) batch and into one map."""
    n, ns = FS["n"], FS["nsims"]
    rng = np.random.default_rng(FS["seed"] + 1)
    return (np.sort(rng.choice(ns * n * n, FS_NSAMPLE, replace=False)),
            np.sort(rng.choice(n * n, FS_NSAMPLE_POL, replace=False)))


def log_interp_on_L(nodes, vals, lmax):
    """examples/lensing_qe_sim.py's N0 on integer L: log-log interpolation
    of the node values, 0 below L = 2."""
    Li = np.arange(lmax + 1, dtype=np.float64)
    out = np.exp(np.interp(np.log(np.maximum(Li, 2.0)), np.log(nodes),
                           np.log(vals)))
    out[:2] = 0.0
    return out


def write_flatsky_golden():
    """The map-level reconstruction of examples/lensing_qe_sim.py."""
    import jax
    import jax.numpy as jnp
    from hmvec_tpu.models import flatsky as jfs
    from hmvec_tpu.models import lensing_noise as jln
    from hmvec_tpu.models.lensed_cf import lens_cls_flat_sky_resummed

    n, pix, lmax_t, lmax_rec = FS["n"], FS["pix"], FS["lmax_t"], \
        FS["lmax_rec"]
    unl, clpp = flatsky_spectra()
    clpp_pad = np.zeros(unl.shape[0])
    clpp_pad[:clpp.size] = clpp
    cl_len = np.array(jax.jit(lambda u, c: lens_cls_flat_sky_resummed(
        u, c, lmax_out=lmax_t))(unl, clpp_pad))
    cl_len[:2] = 0.0
    lv = np.arange(lmax_t + 1.0)
    nl = np.asarray(jln.white_noise_nl(lv, FS["noise_t"], FS["beam"]))
    nl_p = np.asarray(jln.white_noise_nl(lv, FS["noise_t"] * np.sqrt(2.0),
                                         FS["beam"]))
    tot = cl_len[:, 0] + nl
    tot_ee, tot_bb = cl_len[:, 1] + nl_p, cl_len[:, 2] + nl_p
    nodes = np.unique(np.round(np.geomspace(30, lmax_rec, 24)))
    kw = dict(lmin=30, lmax=lmax_t)

    def norms(cl_len, tot, tot_ee, tot_bb):
        grads = {"TT": cl_len[:, 0], "EE": cl_len[:, 1], "TE": cl_len[:, 3]}
        tots = {"TT": tot, "EE": tot_ee, "BB": tot_bb, "TE": cl_len[:, 3]}
        return (jln.n0_flat_sky(nodes, "TT", cl_len[:, 0], tot, **kw),
                jln.n0_flat_sky(nodes, "EE", cl_len[:, 1], tot_ee, **kw),
                jln.n0_flat_sky(nodes, "EB", cl_len[:, 1], tot_ee,
                                cl_total2=tot_bb, **kw),
                jln.n0_te_simple_flat_sky(nodes, grads, tots, **kw)[0])

    n0n, n0n_ee, n0n_eb, resp_te = (np.asarray(a) for a in jax.jit(norms)(
        cl_len, tot, tot_ee, tot_bb))
    n0 = log_interp_on_L(nodes, n0n, lmax_rec)
    n0_ee = log_interp_on_L(nodes, n0n_ee, lmax_rec)
    n0_eb = log_interp_on_L(nodes, n0n_eb, lmax_rec)
    a_te = log_interp_on_L(nodes, 1.0 / resp_te, lmax_rec)
    n0_at = np.interp(FS_LN1, np.arange(lmax_rec + 1.0), n0)
    n1 = np.asarray(jax.jit(lambda c, t, p, a: jln.n1_tt_flat_sky(
        FS_LN1, c, t, p, n0_phi=a, **kw))(cl_len[:, 0], tot, clpp, n0_at))
    print("N1/N0 at L = 100/300/600:", n1 / n0_at)

    def synth(w, cl):
        a = pix * np.pi / 10800.0
        lmod = jfs.fourier_grid(n, pix)[2]
        return jnp.fft.ifft2(jnp.fft.fft2(w / a)
                             * jnp.sqrt(jfs._cl_on_grid(cl, lmod))).real

    qe = lambda t: jfs.qe_tt(t, pix, cl_len[:, 0], tot, n0, lmin=30,
                             lmax=lmax_t)

    @jax.jit
    def one(w):
        t0 = synth(w[0], unl[:lmax_t + 1, 0])
        phi = synth(w[1], clpp)
        noise = synth(w[2], nl)
        lensed = jfs.lens_map(t0, phi, pix, oversample=FS["oversample"])
        ph = qe(lensed + noise)
        ph0 = qe(t0 + noise)
        pk = jnp.fft.fft2(phi)
        spectra = [jfs.fourier_power(a, b, pix, FS_BINS)[1]
                   for a, b in ((ph, pk), (ph, ph), (ph0, ph0), (pk, pk))]
        return lensed, ph, ph0, phi, jnp.stack(spectra)

    w, wp = flatsky_noise()
    idx, idx_pol = flatsky_samples()
    outs = {k: [] for k in ("lensed", "ph", "ph0", "binned")}
    phi0 = None
    for i in range(FS["nsims"]):
        lensed, ph, ph0, phi, binned = (np.asarray(a) for a in one(w[i]))
        phi0 = phi if i == 0 else phi0
        for k, v in (("lensed", lensed), ("ph", ph), ("ph0", ph0),
                     ("binned", binned)):
            outs[k].append(v)
    out = {}
    for k in ("lensed", "ph", "ph0"):
        full = np.stack(outs[k])
        out[f"{k}_sample"] = full.reshape(-1)[idx]
        out[f"{k}_maxabs"] = np.asarray(np.max(np.abs(full)))
    binned = np.stack(outs["binned"])            # (nsims, 4, nbins)
    for j, k in enumerate(("cx", "caa", "c00", "cpp")):
        out[f"binned_{k}"] = binned[:, j]

    @jax.jit
    def pol(wp, phi):
        a = pix * np.pi / 10800.0
        lmod = jfs.fourier_grid(n, pix)[2]
        g1, g2 = jnp.fft.fft2(wp[0] / a), jnp.fft.fft2(wp[1] / a)
        ctt, cee, cte = (jfs._cl_on_grid(unl[:lmax_t + 1, c], lmod)
                         for c in (0, 1, 3))
        sqtt = jnp.sqrt(ctt)
        r = jnp.where(sqtt > 0.0, cte / jnp.where(sqtt > 0.0, sqtt, 1.0),
                      0.0)
        tk = sqtt * g1
        ek = r * g1 + jnp.sqrt(jnp.maximum(cee - r**2, 0.0)) * g2
        c2, s2 = jfs._spin2_phases(n, pix)
        t = jnp.fft.ifft2(tk).real
        q = jnp.fft.ifft2(c2 * ek).real
        u = jnp.fft.ifft2(s2 * ek).real
        tl, ql, ul = (jfs.lens_map(m, phi, pix, oversample=FS["oversample"])
                      for m in (t, q, u))
        return (jfs.qe_ee(ql, ul, pix, cl_len[:, 1], tot_ee, n0_ee,
                          lmin=30, lmax=lmax_t),
                jfs.qe_te(tl, ql, ul, pix, cl_len[:, 3], tot, tot_ee, a_te,
                          lmin=30, lmax=lmax_t),
                jfs.qe_eb(ql, ul, pix, cl_len[:, 1], tot_ee, tot_bb, n0_eb,
                          lmin=30, lmax=lmax_t))

    for k, v in zip(("ee", "te", "eb"), pol(wp, phi0)):
        v = np.asarray(v)
        out[f"ph_{k}_sample"] = v.reshape(-1)[idx_pol]
        out[f"ph_{k}_maxabs"] = np.asarray(np.max(np.abs(v)))
    print("binned cx[0]", out["binned_cx"][0])
    return dict(unlensed=unl, clpp=clpp, cl_len=cl_len, nodes=nodes,
                n0_nodes=np.stack([n0n, n0n_ee, n0n_eb, resp_te]), n1=n1,
                L_n1=FS_LN1, bins=FS_BINS, idx=idx, idx_pol=idx_pol,
                noise_check=w.reshape(-1)[idx[:16]],
                settings_names=np.asarray(list(FS)),
                settings=np.asarray(list(FS.values()), dtype=np.float64),
                **out)


# the emulator phase: examples/emulator_pk.py's settings
EM = {"zs": np.array([0.0, 0.5, 1.0]), "ks": np.geomspace(1e-3, 10.0, 128),
      "ms": np.geomspace(2e10, 1e17, 96)}
EM_NAMES = ("omch2", "ombh2", "ns")
EM_LO, EM_HI = np.array([0.10, 0.020, 0.92]), np.array([0.14, 0.024, 1.00])
EM_FIT = dict(n_train=256, n_val=64, widths=(128, 128, 128), steps=2000,
              learning_rate=3e-3, log_y=True, chunk=32, seed=0)
EM_STEPS64 = 50
EM_ROWS = np.arange(0, 320, 16)


def emulator_f32_spread(got, want):
    """The float32 fit's metrics against JAX's: |got/want - 1| of the final
    loss (mean of the last 50 steps) and of both held-out errors."""
    def metrics(info):
        return np.array([np.mean(info["losses"][-50:]), info["val_max_rel"],
                         info["val_rms_rel"]], dtype=np.float64)
    return np.abs(metrics(got) / metrics(want) - 1.0)


def write_emulator_golden():
    """The example's emulator, in both packages on the CPU."""
    import jax
    import jax.numpy as jnp
    from hmvec_tpu import pipeline as jpl
    from hmvec_tpu.models import emulator as jem
    import torch
    from hmvec_tpu_torch import pipeline as tpl
    from hmvec_tpu_torch.models import emulator as tem

    pmm = jpl.make_pmm_fn(EM["zs"], EM["ks"], EM["ms"], jit=False)
    target = jem.pipeline_target(pmm, EM_NAMES)
    thetas = jem.sample_params(EM_LO, EM_HI, 320, seed=EM_FIT["seed"])
    gen = jax.jit(jax.vmap(target))
    Y = np.concatenate([np.asarray(gen(jnp.asarray(thetas[s:s + 32])))
                        for s in range(0, 320, 32)])
    em32, info32 = jem.fit_emulator(target, EM_LO, EM_HI, key=0, **EM_FIT)
    sizes = info32["sizes"]
    net = jem._init_net(jax.random.PRNGKey(0), sizes, jnp.float64)
    fit64 = dict(EM_FIT, steps=EM_STEPS64)
    em64, info64 = jem.fit_emulator(target, EM_LO, EM_HI, key=0,
                                    dtype=jnp.float64, **fit64)
    val = thetas[EM_FIT["n_train"]:EM_FIT["n_train"] + 4]
    pred64 = np.asarray(jax.jit(em64.__call__)(jnp.asarray(val)))
    print("JAX float32 fit: final loss", np.mean(info32["losses"][-50:]),
          "val", info32["val_max_rel"], info32["val_rms_rel"])
    # the port's float32 fit on the CPU from the same net: the spread that
    # sets the card's gate
    torch.set_num_threads(min(8, torch.get_num_threads()))
    init = {k: [np.asarray(a) for a in v] for k, v in net.items()}
    t_target = tem.pipeline_target(tpl.make_pmm_fn(
        EM["zs"], EM["ks"], EM["ms"], device="cpu"), EM_NAMES)
    _, t_info = tem.fit_emulator(t_target, EM_LO, EM_HI, init_net=init,
                                 **EM_FIT)
    spread = emulator_f32_spread(t_info, info32)
    print("port float32 fit on the CPU: final loss",
          np.mean(t_info["losses"][-50:]), "val", t_info["val_max_rel"],
          t_info["val_rms_rel"], "spread vs JAX", spread)
    return dict(zs=EM["zs"], ks=EM["ks"], ms=EM["ms"],
                names=np.asarray(EM_NAMES), lo=EM_LO, hi=EM_HI,
                widths=np.asarray(EM_FIT["widths"]),
                fit=np.asarray([EM_FIT[k] for k in ("n_train", "n_val",
                                                    "steps", "chunk",
                                                    "seed")]),
                learning_rate=np.asarray(EM_FIT["learning_rate"]),
                rows=EM_ROWS, Y_rows=Y[EM_ROWS],
                **{f"W{i}": np.asarray(w) for i, w in enumerate(net["W"])},
                losses32=np.asarray(info32["losses"]),
                val32=np.asarray([info32["val_max_rel"],
                                  info32["val_rms_rel"]]),
                steps64=np.asarray(EM_STEPS64),
                losses64=np.asarray(info64["losses"]), val_thetas=val,
                pred64=pred64, f32_spread_cpu=spread,
                f32_gate=np.asarray(10.0 * np.max(spread)))


# the Boltzmann group's reduced grid (--config boltz_small): 6 k below the
# grid's segment-C stability edge, and solve_perturbations' step counts
BOLTZ_SMALL_KS = np.geomspace(1e-4, 0.1, 6)
BOLTZ_SMALL_GRID = {"n_a": 300, "n_b_outer": 210, "n_b_inner": 4,
                    "n_c_outer": 120, "n_c_inner": 11}
BOLTZ_SMALL_COSMOS = {"massless": {}, "fluid": {"mnu": 0.06},
                      "eh99": {"mnu": 0.06}}
BOLTZ_SMALL_NREC = 4096      # the recombination table's rows
BOLTZ_PARTS = {"boltz_small": ("massless", "fluid", "eh99"),
               "boltz": ("cmb", "engine")}


def boltz_small_part(name):
    """One cosmology of --config boltz_small, in this process."""
    import jax.numpy as jnp
    from hmvec_tpu.models import background as jbg
    from hmvec_tpu.models import boltz_engine as jbe
    from hmvec_tpu.models import boltzlite as jbl
    from hmvec_tpu.models import recomb as jrec
    from hmvec_tpu.params import merge_params

    p = merge_params(BOLTZ_SMALL_COSMOS[name])
    # the recombination table at BOLTZ_SMALL_NREC rows, also inside
    # matter_power_slices (module state of this process only)
    full = jrec.recombination
    jbe.recombination = lambda bg, **kw: full(bg, n=BOLTZ_SMALL_NREC, **kw)
    opts = {k: v for k, v in BOLTZ_SMALL_GRID.items() if k != "n_c_inner"}
    n_c = BOLTZ_SMALL_GRID["n_c_inner"]
    zs = np.asarray(jbe.DEFAULT_Z_SLICES)

    def slices(fluid, component="total"):
        return np.asarray(jbe.matter_power_slices(
            p, ks=BOLTZ_SMALL_KS, zs=zs, n_c_inner=n_c, solver_opts=opts,
            massive_nu=fluid, component=component)[1])

    if name == "eh99":
        return {"eh99_slices": slices(False)}
    fluid = name == "fluid"
    bg = jbg.background(p)
    rec = jbe.recombination(bg, massive_nu=fluid)
    ctx = jbl.make_ctx(bg, rec, massive_nu=True)
    sol = jbl.solve_perturbations(ctx, jnp.asarray(BOLTZ_SMALL_KS),
                                  **BOLTZ_SMALL_GRID)
    src = jbl.compute_sources(ctx, sol)
    # every third stored x of the states keeps the file under 1 MB
    out = {"xs": sol.xs, "states_every3": sol.states[:, ::3],
           "zeta_unit": sol.zeta_unit,
           "chi": src.chi, "s_t": src.s_t, "s_e": src.s_e, "s_p": src.s_p,
           "chi_star": src.chi_star, "slices": slices(fluid)}
    if fluid:
        out["slices_cb"] = slices(True, "cb")
    print(f"{name}: zeta_unit = {float(sol.zeta_unit)!r}, states finite "
          f"{bool(np.isfinite(np.asarray(sol.states)).all())}")
    return {f"{name}_{k}": np.asarray(v) for k, v in out.items()}


def boltz_part(name, zs, ms, ks):
    """One process of --config boltz: "cmb" -> the arrays of
    boltz_cmb_golden.npz; "engine" -> those of boltz_engine_golden.npz
    and boltz_class_golden.npz (the README build reads the engine's
    cached solve)."""
    import jax.numpy as jnp
    import hmvec_tpu as hm
    from hmvec_tpu.models import background as jbg
    from hmvec_tpu.models import boltz_engine as jbe
    from hmvec_tpu.models import recomb as jrec
    from hmvec_tpu.models.cosmology import Cosmology
    from hmvec_tpu.params import merge_params

    p = merge_params({})
    bg = jbg.background(p)
    if name == "cmb":
        out = Cosmology().get_cmb_cls(approx=True)
        rec = jrec.recombination(bg)
        arrays = {k: np.asarray(out[k]) for k in
                  ("total", "unlensed_scalar", "lens_potential")}
        arrays.update({f"rec_{k}": np.asarray(getattr(rec, k))[::4]
                       for k in ("xs", "xe", "tau", "tau_x", "gvis", "eta")})
        arrays["rec_eta0"] = np.asarray(rec.eta0)
        arrays["lmax"] = np.asarray(3000)
        print(f"cmb: TT[100] = {arrays['total'][100, 0]!r}")
        return {"cmb": arrays}
    eng = jbe.BoltzEngine()
    rs, zd = jbe.rs_drag_integral()
    plin = np.asarray(eng.plin(bg, jnp.asarray(zs), jnp.asarray(ks)))
    engine = dict(zs=zs, ks=ks, ks_t=eng.ks_t, p0_t=eng.p0_t,
                  ks_b=np.exp(eng._lnk_b), lnratio=eng._lnratio,
                  graft_ratio=np.asarray(eng._graft_ratio), plin=plin,
                  rs_drag=np.asarray(rs), z_drag=np.asarray(zd))
    print(f"engine: plin[0, 0] = {plin[0, 0]!r}, r_s = {rs!r}")
    ngal = np.full(zs.size, NGAL)
    hcos = hm.HaloModel(zs, ks, ms=ms, params=BENCH_OVERRIDES,
                        engine="boltz")
    hcos.add_battaglia_profile("e", family="AGN")
    hcos.add_battaglia_pres_profile("y")
    hcos.add_hod("g", ngal=ngal)
    spectra = {k: np.asarray(hcos.get_power(*names))
               for k, names in CLASS_SPECTRA.items()}
    print(f"class: pmm[0, 0] = {spectra['pmm'][0, 0]!r}")
    klass = dict(zs=zs, ms=ms, ks=ks, ngal=ngal,
                 param_names=np.asarray(list(BENCH_OVERRIDES)),
                 param_values=np.asarray(list(BENCH_OVERRIDES.values()),
                                         dtype=np.float64), **spectra)
    return {"engine": engine, "class": klass}


def write_boltz_golden(config):
    """Run each part of ``config`` in a process of its own (XLA:CPU
    crashes natively on large scan programs once a process holds many)
    side by side, and write the config's files."""
    import subprocess
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        procs = [(part, subprocess.Popen(
            [sys.executable, __file__, "--config", config, "--part", part,
             "--part-out", os.path.join(tmp, part + ".npz")]))
            for part in BOLTZ_PARTS[config]]
        for part, proc in procs:
            if proc.wait() != 0:
                raise SystemExit(f"part {part} failed ({proc.returncode})")
        parts = {part: dict(np.load(os.path.join(tmp, part + ".npz")))
                 for part in BOLTZ_PARTS[config]}
    if config == "boltz_small":
        arrays = {k: v for part in parts.values() for k, v in part.items()}
        arrays.update(ks=BOLTZ_SMALL_KS, n_rec=np.asarray(BOLTZ_SMALL_NREC),
                      z_slices=np.asarray(
            (0.0, 0.5, 1.0, 2.0, 3.0, 5.0, 8.0, 12.0, 20.0)),
            grid_names=np.asarray(list(BOLTZ_SMALL_GRID)),
            grid_values=np.asarray(list(BOLTZ_SMALL_GRID.values())))
        return {OUT[config]: arrays}
    files = {"cmb": OUT[config], "engine": DATA / "boltz_engine_golden.npz",
             "class": DATA / "boltz_class_golden.npz"}
    out = {}
    for part in parts.values():
        for key in {k.split("/", 1)[0] for k in part}:
            out[files[key]] = {k.split("/", 1)[1]: v for k, v in part.items()
                               if k.startswith(key + "/")}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(OUT), default="1")
    ap.add_argument("--part", help=argparse.SUPPRESS)
    ap.add_argument("--part-out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from hmvec_tpu import pipeline as jpl

    zs, ms, ks = config1_grids()
    if args.part:
        # one part of a boltz config, in the process write_boltz_golden
        # started for it
        if args.config == "boltz_small":
            arrays = boltz_small_part(args.part)
        else:
            arrays = {f"{f}/{k}": v for f, a in
                      boltz_part(args.part, zs, ms, ks).items()
                      for k, v in a.items()}
        np.savez(args.part_out, **arrays)
        return
    if args.config in BOLTZ_PARTS:
        for path, arrays in write_boltz_golden(args.config).items():
            np.savez_compressed(path, **arrays)
            print(f"wrote {path.relative_to(REPO)} "
                  f"({path.stat().st_size} bytes)")
        return
    path = OUT[args.config]
    path.parent.mkdir(parents=True, exist_ok=True)
    if args.config == "b":
        np.savez_compressed(path, zs=zs, ms=ms, ks=ks, param_names=np.asarray(
            ("omch2", "As")), **write_batch_golden(jpl, jnp, zs, ms, ks))
        print(f"wrote {path.relative_to(REPO)} ({path.stat().st_size} bytes)")
        return
    if args.config in ("5", "m", "c", "x", "v", "rsd_nonlimber", "lensing",
                       "projfield", "flatsky", "emulator"):
        if args.config == "5":
            arrays = write_ksz_golden(jpl, jnp)
        elif args.config == "c":
            arrays = write_class_golden(zs, ms, ks)
        elif args.config == "x":
            arrays = write_extensions_golden(zs, ms, ks)
        elif args.config == "v":
            arrays = write_cov_bispectrum_golden(zs, ms, ks)
        elif args.config == "rsd_nonlimber":
            arrays = write_rsd_nonlimber_golden(zs, ms, ks)
        elif args.config == "lensing":
            arrays = write_lensing_cmb_golden(zs, ms, ks)
        elif args.config == "projfield":
            arrays = write_projfield_golden(zs, ms, ks)
        elif args.config == "flatsky":
            arrays = write_flatsky_golden()
        elif args.config == "emulator":
            arrays = write_emulator_golden()
        else:
            arrays = dict(zs=zs, ms=ms, ks=ks,
                          **write_massfn_golden(jpl, jnp, zs, ms, ks))
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
