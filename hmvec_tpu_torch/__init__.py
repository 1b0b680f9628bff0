"""hmvec_tpu_torch: the PyTorch / CUDA port of hmvec_tpu.

Module names mirror the JAX package (``hmvec_tpu_torch.models.profiles``
is the counterpart of ``hmvec_tpu.models.profiles``).  The port imports
torch, numpy and scipy, never jax.  Everything runs in float64 tensors on
one explicit device; the NFW profile stage and the resample step of the
numeric profile transform have hand-written CUDA kernels for Hopper
(``ops.nfw_kernels``, ``ops.resample_kernels``; sources in ``csrc/``),
built with nvcc at first use.

The class API (``Cosmology``, ``HaloModel``, ``kSZ`` and the kSZ
forecasts) takes ``device="cuda"`` by default; ``device="cpu"`` runs every
kernel's plain version.  The pipelines, in ``hmvec_tpu_torch.pipeline``
(``make_pmm_fn``, ``make_electron_fn``, ``make_hod_fn``,
``make_lensing_cls_fn``, ``make_ksz_snr_fn``, ``make_ksz_survey_fn``, and
``make_batched_fn``, which batches any of them over sets of parameters),
take ``device=`` explicitly.

The free functions that make tensors of what they are given run on the
device of their first tensor argument, or on ``device=`` (the card by
default) when given only host data, all by one rule
(``utils.weights.on_device_of_inputs``); those that compute in the array
library they are given (numpy in, numpy out) do so as the JAX package's
do, and ``distances_ext.solve_h0_from_theta100`` bisects on the host.
The map-level simulations and quadratic estimators are the module
``flatsky``; stage checkpoints and timers are ``utils.checkpoint`` and
``utils.profiling``.  The public names of ``hmvec_tpu`` whose modules are
still to be ported (the Boltzmann group) are listed in ROADMAP.md (A9)
and the README.
"""

from .params import battaglia_defaults, default_params, merge_params  # noqa: F401
from .models.cosmology import Cosmology, a2z, get_eds_model  # noqa: F401
from .models.halo_model import HaloModel  # noqa: F401
from .models.ksz import (  # noqa: F401
    Ngg, Nvv, Nvv_core_integral, chi, chi_ion, get_interpolated_cls,
    get_kmin, get_ksz_auto_signal_mafry, get_ksz_auto_squeezed,
    get_ksz_snr, get_ksz_snr_survey, get_ksz_template_signal_snapshot,
    get_survey_volume, kSZ, ksz_radial_function, ne0_shaw, pge_err_core)
from .models.cib import (  # noqa: F401
    build_cib_tracer, cib_luminosity, default_cib_params, sed_graybody)
from .models.cov import (  # noqa: F401
    GaussianCov, angular_correlation, bin_annuli, cl_cov_ssc, cl_cov_t1h,
    get_avail_cls, knox_cov, lensing_shape_noise, pk_cov_gaussian,
    pk_cov_ssc, pk_response_ssc, shot_noise, sigma_b2_disk, sigma_b2_tophat,
    trispectrum_1h, trispectrum_1h_terms)
from .models.bispectrum import (  # noqa: F401
    b2_sheth_torman, bispectrum_1halo, bispectrum_2halo, bispectrum_3halo,
    bispectrum_total, f2_kernel, projected_bispectrum, tree_bispectrum)
from .models.shear import (  # noqa: F401
    gamma_t, kappa_to_shear_cl_factor, wigner_d_outer_sum, wigner_d_sum,
    xi_gaussian_cov, xi_minus, xi_plus)
from .models.ia import (  # noqa: F401
    C_gg_mag, C_gI, C_II, C_kg_mag, C_kI, ia_window, magnification_window,
    nla_amplitude, shear_cls_with_ia)
from .models.master import (  # noqa: F401
    bin_operator, cap_mask_cl, couple_cls, coupling_matrix,
    decouple_bandpowers, decoupled_covariance, gaussian_covariance_nka)
from .models.lensed_cf import lens_cls_flat_sky_resummed  # noqa: F401
from .models.lensed_cls import lens_cls_flat_sky  # noqa: F401
from .models.pairwise import (  # noqa: F401
    get_pairwise_ksz_snr, pairwise_ksz_errors, pairwise_ksz_signal,
    tau_aperture_battaglia)
from .models.rsd import (  # noqa: F401
    correlation_multipoles, kaiser_multipole_factors, kaiser_pk_mu,
    mean_pairwise_velocity, rsd_multipoles, scoccimarro_multipoles,
    scoccimarro_pk_mu, sigma_v_lin)
from .models.nonlimber import (  # noqa: F401
    C_gg_exact, C_gg_hybrid, C_kg_exact, C_kk_exact, C_kk_hybrid,
    bessel_deltas, bessel_deltas_j2pp, bessel_deltas_over_x2)
from .models.spt import (  # noqa: F401
    p1loop, p1loop_ir, p13, p13_dt, p13_tt, p22, p22_velocity, pgg_1loop,
    pgm_1loop, pk_velocity_1loop, pt_bias_integrals)
from .models.tns import (  # noqa: F401
    tns_a_term, tns_ab_integrals, tns_b_term, tns_multipoles, tns_pk_mu,
    tns_power)
from .models.rsd_obs import (  # noqa: F401
    ap_multipoles, ap_shift, multipole_covariance, multipole_snr,
    tns_pk_mu_points, window_convolve_multipoles, window_coupling)
# the root's threej000_sq is lensing_noise's (a tensor function of
# arrays), as in the JAX package's root; rsd_obs keeps its exact scalar
from .models.lensing_noise import (  # noqa: F401
    lensed_bb_from_ee, n0_cross_flat_sky, n0_eb_iterative, n0_flat_sky,
    n0_kappa_from_phi, n0_minimum_variance, n0_mv_flat_sky,
    n0_pair_flat_sky, n0_tt_fullsky, n1_tt_flat_sky, threej000_sq,
    total_cl_tt, white_noise_nl)
from .models.power import (  # noqa: F401
    exclusion_correction, total_matter_galaxy_power_spectrum,
    total_matter_power_spectrum)
from .models.profiles import (  # noqa: F401
    Fcon, P_e, P_e_generic, P_e_generic_x, battaglia_gas_fit,
    concentration_bhattacharya, duffy_concentration, rho_einasto_x, rho_gas,
    rho_gas_generic, rho_gas_generic_x, rho_nfw, rho_nfw_x, rhoscale_nfw)
from .models.mass_conversion import (  # noqa: F401
    mdelta_from_mdelta, mdelta_from_mdelta_unvectorized)
from .models.mass_function import (  # noqa: F401
    NlnMsub, R_from_M, bias_tinker, f_nu, simple_f_nu)
from .models.hod import (  # noqa: F401
    Mhalo_stellar, Mhalo_stellar_core, Mstellar_halo, avg_Nc, avg_NcNs,
    avg_Ns, avg_NsNsm1, avg_nc_zheng05, avg_ns_zheng05, build_hod_zheng05,
    hod_default_mfunc, ngal_from_mthresh)
from .models.limber import limber_integral  # noqa: F401
from .models import flatsky  # noqa: F401
from .models.projfield import (  # noqa: F401
    bispectrum_ttg_lensing, cl_ksz2_galaxy, cl_ksz2_kappa, cl_t2_lensing,
    cl_t2_t2_gaussian, filtered_bispectrum_cl, hybrid_bispectrum_ttg,
    ksz2_snr, vrms2_linear)
from .models.emulator import (  # noqa: F401
    Emulator, fit_emulator, load_emulator, pipeline_target, sample_params,
    save_emulator)
from .models.linear_power import EHEngine, TabulatedEngine  # noqa: F401
from .models.boltz_engine import BoltzEngine, rs_drag_integral  # noqa: F401
from .ops.special import Wkr, Wkr_taylor  # noqa: F401
from .ops.rootfind import invert_monotone, vectorized_bisection_search  # noqa: F401
from .ops.quadrature import interp  # noqa: F401
from .ops.sine_transform import (  # noqa: F401
    analytic_fft_integral, fft_integral, generic_profile_fft, uk_brute_force,
    uk_fft)
from .ops.fftlog import correlation_function, projected_correlation  # noqa: F401
from .pipeline import (  # noqa: F401
    fisher_jacobian, make_batched_fn, make_electron_fn, make_hod_fn,
    make_ksz_snr_fn, make_ksz_survey_fn, make_lensing_cls_fn, make_pmm_fn)

# the reference's tinker.py module-level name
bias = bias_tinker
