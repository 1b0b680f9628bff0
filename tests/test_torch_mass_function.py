"""PyTorch port, every mass-function mode: the Tinker, Tinker-2008,
Press-Schechter and Despali functions of models/mass_function.py against
the JAX package's (1e-12 relative), each mode of ``mass_function_grid``
through ``pipeline.make_pmm_fn`` against the JAX pipeline (1e-10), and a
batch of one such mode against its single calls (1e-12), with inputs made
by numpy from a seed.  Both sides run the same float64 algorithm."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hmvec_tpu import pipeline as jpipe
from hmvec_tpu.models import mass_function as jmf
from hmvec_tpu_torch import pipeline as tpipe
from hmvec_tpu_torch.models import mass_function as tmf
from hmvec_tpu_torch.params import default_params

RTOL = 1e-12
ZS = np.linspace(0.1, 3.0, 3)
MS = np.geomspace(2e10, 1e17, 24)
KS = np.geomspace(1e-4, 100, 64)
RNG = np.random.default_rng(11)
SIGMA2 = RNG.uniform(0.05, 20.0, (4, 24))
NU = RNG.uniform(0.1, 5.0, (4, 24))
ZQ = np.array([0.05, 0.9, 2.5, 3.6])           # one beyond the z = 3 clamp
DELTAS = {"200": 200.0, "node": 1600.0, "between": 517.0, "clamped": 4000.0,
          "per_z": np.array([210.0, 650.0, 1900.0, 3100.0])}
MODES = ("sheth-torman", "tinker", "tinker2008", "press-schechter",
         "despali")
ST = {k: default_params[k] for k in ("st_A", "st_a", "st_p", "st_deltac")}
T = torch.as_tensor


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got / want - 1.0)))


def _both(delta):
    """delta for each side: the number itself, or a (nz,) array as each
    framework's array."""
    if np.ndim(delta):
        return T(delta), jnp.asarray(delta)
    return delta, delta


def test_tables_and_splines_match_jax():
    """The Tinker tables, their spline second derivatives, and the four
    parameter splines of each paper at nodes, between them, beyond the
    table and per z."""
    for name in ("_TINKER_DELTAS", "_T08_ROWS", "_T10_ROWS", "_T08_D2",
                 "_T10_D2", "_ALPHA_NUS", "_ALPHA_W"):
        np.testing.assert_array_equal(getattr(tmf, name), getattr(jmf, name))
    assert tmf._PS_PARAMS == jmf._PS_PARAMS
    assert tmf._DESPALI_PARAMS == jmf._DESPALI_PARAMS
    jax_params = jax.jit(lambda d: (*jmf.tinker2008_params(d),
                                    *jmf.tinker2010_params(d)))
    for delta in DELTAS.values():
        td = _both(delta)[0]
        got = (*tmf.tinker2008_params(td), *tmf.tinker2010_params(td))
        for g, w in zip(got, jax_params(jnp.asarray(delta))):
            assert _rel(g, w) <= RTOL
    # at a node the spline gives the table's value exactly
    assert [float(v) for v in tmf.tinker2008_params(200.0)] == \
        tmf._T08_ROWS[0].tolist()


def _jax_tinker_side(nu, zc, z, s2, d, dcol, scalar):
    """The JAX package's Tinker functions, in the order of the port's
    below: at one overdensity d (dcol: d, or per z as a column)."""
    out = [jmf.bias_tinker(nu, dcol), jmf._tinker_f_nu_unnorm(nu, zc, dcol),
           jmf.tinker_alpha_consistency(z, d), jmf.fsigmaz_tinker(s2, z, d),
           jmf.simple_f_nu_tinker2008(nu, dcol, zc)]
    if scalar:
        out += [jmf.f_nu(nu, zc, d),
                jmf.f_nu(nu, zc, d, norm_consistency=False),
                jmf.simple_f_nu(nu, d), jmf.simple_f_nu_tinker2008(nu, d)]
    return out


# one compile per shape of delta, shared by the cases
_jax_tinker = jax.jit(_jax_tinker_side, static_argnums=6)


@pytest.mark.parametrize("delta", sorted(DELTAS))
def test_tinker_functions_match_jax(delta):
    """bias_tinker, the unnormalized and normalized f(nu), the alpha(z)
    consistency integral, nu f(nu), and the Tinker-2008 f with and without
    its z evolution, at one overdensity or one per z."""
    td = _both(DELTAS[delta])[0]
    per_z = np.ndim(DELTAS[delta]) == 1
    tcol = td[:, None] if per_z else td
    nu_t, zc_t = T(NU), T(ZQ)[:, None]
    jd = jnp.asarray(DELTAS[delta])
    want = _jax_tinker(jnp.asarray(NU), jnp.asarray(ZQ)[:, None],
                       jnp.asarray(ZQ), jnp.asarray(SIGMA2), jd,
                       jd[:, None] if per_z else jd, not per_z)
    got = [tmf.bias_tinker(nu_t, tcol),
           tmf._tinker_f_nu_unnorm(nu_t, zc_t, tcol),
           tmf.tinker_alpha_consistency(T(ZQ), td),
           tmf.fsigmaz_tinker(T(SIGMA2), T(ZQ), td),
           tmf.simple_f_nu_tinker2008(nu_t, tcol, zc_t)]
    if not per_z:
        got += [tmf.f_nu(nu_t, zc_t, td),
                tmf.f_nu(nu_t, zc_t, td, norm_consistency=False),
                tmf.simple_f_nu(nu_t, td),
                tmf.simple_f_nu_tinker2008(nu_t, td)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= RTOL, i


def test_subhalo_mass_function_matches_jax():
    msub = np.geomspace(1e9, 1e13, 7)
    mhost = np.geomspace(1e13, 1e15, 5)
    want = jmf.n_ln_m_sub(jnp.asarray(msub), jnp.asarray(mhost))
    assert _rel(tmf.n_ln_m_sub(T(msub), T(mhost)), want) <= RTOL
    assert _rel(tmf.NlnMsub(msub, mhost, device="cpu"), want) <= RTOL


_jax_grid = jax.jit(jmf.mass_function_grid, static_argnums=4)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("delta", ("200", "per_z"))
def test_mass_function_grid_matches_jax(mode, delta):
    td, jd = _both(DELTAS[delta])
    ms = np.geomspace(1e10, 1e16, 24)
    got = tmf.mass_function_grid(T(SIGMA2), T(ZQ), T(ms), 3.1e10, mode, ST,
                                 delta=td)
    want = _jax_grid(jnp.asarray(SIGMA2), jnp.asarray(ZQ), jnp.asarray(ms),
                     3.1e10, mode, ST, delta=jnp.asarray(jd))
    for g, w in zip(got, want):
        assert _rel(g, w) <= RTOL


def test_press_schechter_keeps_finite_derivatives():
    """st_p = 0: (sigma2 / a / deltac^2)^0 has a finite derivative, in
    both autodiff modes."""
    s2 = T(SIGMA2).clone().requires_grad_(True)
    nzm, bh = tmf.mass_function_grid(s2, T(ZQ), T(MS), 3.1e10,
                                     "press-schechter", ST)
    (nzm.sum() + bh.sum()).backward()
    assert bool(torch.isfinite(s2.grad).all())
    jac = torch.autograd.functional.jacobian(
        lambda x: tmf.mass_function_grid(x, T(ZQ[:1]), T(MS[:3]), 3.1e10,
                                         "press-schechter", ST)[0],
        T(SIGMA2[:1, :3]), vectorize=True, strategy="forward-mode")
    assert bool(torch.isfinite(jac).all())


OV = {"omch2": 0.117, "As": 2.1e-9}


@pytest.fixture(scope="module")
def pmm_fns():
    """The port's make_pmm_fn of each mode at the smoke size."""
    return {mode: tpipe.make_pmm_fn(ZS, KS, MS, device="cpu",
                                    mass_function=mode) for mode in MODES}


@pytest.fixture(scope="module")
def jax_pmm():
    """The JAX pipeline's Pmm of each mode at OV, all five modes in one
    compile (they share every stage but the mass function)."""
    fns = [jpipe.make_pmm_fn(ZS, KS, MS, mass_function=mode, jit=False)
           for mode in MODES]
    out = jax.jit(lambda ov: [f(ov) for f in fns])(
        {k: jnp.asarray(v) for k, v in OV.items()})
    return dict(zip(MODES, (np.asarray(o) for o in out)))


@pytest.mark.parametrize("mode", MODES)
def test_make_pmm_fn_mode_matches_jax(pmm_fns, jax_pmm, mode):
    assert _rel(pmm_fns[mode](OV), jax_pmm[mode]) <= 1e-10


def test_batched_tinker_matches_single_calls(pmm_fns):
    """A B = 2 batch of the Tinker mode against its single calls, with
    vmap's fallback warning turned into an error; and the Jacobian of one
    call, forward against reverse mode."""
    fn = pmm_fns["tinker"]
    theta = np.column_stack([RNG.uniform(0.11, 0.13, 2),
                             RNG.uniform(2.0e-9, 2.4e-9, 2)])
    bfn = tpipe.make_batched_fn(fn, ("omch2", "As"))
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*batching rule.*")
        out = bfn(theta)
    for i, (om, As) in enumerate(theta):
        assert _rel(out[i], fn({"omch2": om, "As": As})) <= 1e-12
    ov = {"omch2": 0.12, "As": 2.2e-9}
    fwd = tpipe.fisher_jacobian(fn, ov, ("omch2",), device="cpu")[..., 0]
    om = torch.tensor(0.12, dtype=torch.float64, requires_grad=True)
    rev = torch.autograd.grad(fn({"omch2": om, "As": 2.2e-9})[1, 10], om)[0]
    assert bool(torch.isfinite(fwd).all())
    assert abs(float(rev) / float(fwd[1, 10]) - 1.0) <= 1e-10


def test_unknown_mode_raises():
    with pytest.raises(NotImplementedError):
        tmf.mass_function_grid(T(SIGMA2), T(ZQ), T(MS), 1.0, "bogus", ST)
