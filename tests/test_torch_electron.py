"""PyTorch port, the config-2 electron path against the JAX package on the
CPU: the bisection solvers, the M200 conversion, the Battaglia gas
profile, the sine transform and the profile transform, make_electron_fn
and its Jacobian, and the golden file that the JAX package wrote at
config 2's full width (tools/gen_torch_golden.py --config 2)."""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_jax import jacobian_columns, jax_jvp, jvp_value
from hmvec_tpu import pipeline as jpipe
from hmvec_tpu.models import mass_conversion as jmc
from hmvec_tpu.models import profiles as jprof
from hmvec_tpu.ops import rootfind as jroot
from hmvec_tpu.ops import sine_transform as jst
from hmvec_tpu.params import battaglia_defaults
from hmvec_tpu_torch import pipeline as tpipe
from hmvec_tpu_torch.models import mass_conversion as tmc
from hmvec_tpu_torch.models import profiles as tprof
from hmvec_tpu_torch.ops import rootfind as troot
from hmvec_tpu_torch.ops import sine_transform as tst

F64 = torch.float64
ZS = np.array([0.5, 1.0, 2.0])      # tests/test_limber_variants.py's grid
KS = np.geomspace(1e-3, 10, 48)
MS = np.geomspace(1e11, 1e16, 20)
NXS, XMAX = 256, 10
P0 = {"omch2": 0.1198, "As": 2.2e-9}
NAMES = ("omch2", "As")
GOLDEN = (pathlib.Path(tpipe.__file__).parent / "data"
          / "electron_config2_golden.npz")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) / np.asarray(want) - 1.0)))


def test_bisection_solvers_match_jax():
    """solve_bisection_root and invert_monotone (both directions), 90
    halvings each: rtol 1e-13."""
    a = np.geomspace(0.13, 970.0, 37)     # no root at 0
    got = troot.solve_bisection_root(lambda y: _t(a) - y**3, _t(0 * a),
                                     _t(0 * a + 20.0))
    want = jroot.solve_bisection_root(lambda y: jnp.asarray(a) - y**3,
                                      jnp.zeros(37), jnp.full(37, 20.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)
    np.testing.assert_allclose(got.numpy(), np.cbrt(a), rtol=1e-13)
    for inc in (True, False):
        sign = 1.0 if inc else -1.0
        got = troot.invert_monotone(lambda y: sign * torch.exp(y),
                                    _t(sign * a), -5.0, 10.0,
                                    increasing=inc)
        want = jroot.invert_monotone(lambda y: sign * jnp.exp(y),
                                     jnp.asarray(sign * a), -5.0, 10.0,
                                     increasing=inc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)


def _mass_inputs():
    rng = np.random.default_rng(5)
    m1 = np.geomspace(1e11, 1e16, 11)
    c1 = rng.uniform(2.0, 15.0, (4, 11))
    dr1 = rng.uniform(1e13, 5e13, 4)
    dr2 = rng.uniform(2e13, 8e13, 4)
    return m1, c1, dr1, dr2


def test_mdelta_from_mdelta_matches_jax():
    """The (z, m) grid solve and its broadcast variant: rtol 1e-13."""
    m1, c1, dr1, dr2 = _mass_inputs()
    got = tmc.mdelta_from_mdelta(_t(m1), _t(c1), _t(dr1), _t(dr2))
    # the JAX side in one compiled program
    want, want_u = jax.jit(lambda: (
        jmc.mdelta_from_mdelta(jnp.asarray(m1), jnp.asarray(c1),
                               jnp.asarray(dr1), jnp.asarray(dr2)),
        jmc.mdelta_from_mdelta_unvectorized(
            m1[None, :], c1, dr1[:, None], dr2[:, None])))()
    assert got.shape == (4, 11)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)
    got_u = tmc.mdelta_from_mdelta_unvectorized(
        _t(m1)[None, :], _t(c1), _t(dr1)[:, None], _t(dr2)[:, None])
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), rtol=1e-13)
    np.testing.assert_allclose(got_u.numpy(), got.numpy(), rtol=1e-13)


def test_mdelta_from_mdelta_passes_no_derivative():
    """As in the JAX package, the bisection passes no derivative to M2:
    d M2 / d C1 is exactly 0 on both sides (ROADMAP C5)."""
    m1, c1, dr1, dr2 = _mass_inputs()
    tc = np.ones_like(c1)
    _, got = torch.func.jvp(
        lambda c: tmc.mdelta_from_mdelta(_t(m1), c, _t(dr1), _t(dr2)),
        (_t(c1),), (_t(tc),))
    _, want = jax.jit(lambda: jax.jvp(
        lambda c: jmc.mdelta_from_mdelta(jnp.asarray(m1), c,
                                         jnp.asarray(dr1), jnp.asarray(dr2)),
        (jnp.asarray(c1),), (jnp.asarray(tc),)))()
    assert np.all(np.asarray(want) == 0.0)
    assert torch.all(got == 0.0)


def _gas_args(nz=3, nm=9):
    rng = np.random.default_rng(7)
    m200 = rng.uniform(1e12, 1e15, (nz, nm))
    zs = np.linspace(0.2, 2.0, nz)
    rhocritz = rng.uniform(1.2e11, 3e11, nz)
    return m200, zs, rhocritz, battaglia_defaults["AGN"]


def _rho_gas(mod, xs, m200, zs, rhocritz, fit):
    return mod.rho_gas_x(xs[None, None, :], m200[..., None],
                         zs[:, None, None], 0.049, 0.31,
                         rhocritz[:, None, None], -0.2, fit)


def test_rho_gas_x_matches_jax():
    """float64 samples: rtol 1e-13; float32 samples (exponent formed in
    float64, one rounding to float32) against the JAX float64 samples:
    rtol 1e-6."""
    xs = np.linspace(0.0, 20.0, 513)[1:]
    m200, zs, rhocritz, fit = _gas_args()
    want = np.asarray(jax.jit(lambda: _rho_gas(
        jprof, jnp.asarray(xs), jnp.asarray(m200), jnp.asarray(zs),
        jnp.asarray(rhocritz), fit))())
    got = _rho_gas(tprof, _t(xs), _t(m200), _t(zs), _t(rhocritz), fit)
    assert got.dtype == F64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13)
    got32 = _rho_gas(tprof, _t(xs).float(), _t(m200), _t(zs), _t(rhocritz),
                     fit)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.double().numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("method", ["fft", "matmul"])
def test_sine_dft_matches_jax(method):
    """Both methods in float64 against the JAX package's: 1e-12 of the
    peak."""
    rng = np.random.default_rng(3)
    y = rng.standard_normal((5, 256)) * np.exp(-np.linspace(0, 5, 256))
    want = np.asarray(jst.sine_dft(jnp.asarray(y), 0.05, method=method))
    got = tst.sine_dft(_t(y), 0.05, method=method)
    assert got.shape == (5, 129) and got.dtype == F64
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()
    with pytest.raises(NotImplementedError):
        tst.sine_dft(_t(y), 0.05, method="mixed")


def test_fft_integral_matches_jax_and_closed_form():
    """Against JAX: 1e-12 absolute.  Against the Gaussian's closed form on
    0.1 < k < 5: 5e-3 absolute, the check of tests/test_api_parity.py on
    the same grid (the reference's step = extent/N costs ~1e-3)."""
    x = np.arange(0.002, 50.0, 0.002)
    y = np.exp(-(x**2) / 2.0)
    ks, uk = tst.fft_integral(_t(x), _t(y))
    jks, juk = jst.fft_integral(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(ks.numpy(), np.asarray(jks), rtol=1e-14)
    assert np.abs(uk.numpy() - np.asarray(juk)).max() <= 1e-12
    exact = tst.analytic_fft_integral(ks)
    np.testing.assert_allclose(exact.numpy(),
                               np.asarray(jst.analytic_fft_integral(jks)),
                               rtol=1e-14, atol=1e-300)
    sel = (ks > 0.1) & (ks < 5.0)
    assert (uk - exact)[sel].abs().max().item() < 5e-3


def _profile_inputs():
    rng = np.random.default_rng(9)
    nz, nm = 3, 12
    zs = np.linspace(0.2, 2.0, nz)
    cs = rng.uniform(2.0, 15.0, (nz, nm))
    rss = rng.uniform(0.02, 0.5, (nz, nm))
    m200 = rng.uniform(1e12, 1e15, (nz, nm))
    rhocritz = rng.uniform(1.2e11, 3e11, nz)
    return zs, cs, rss, m200, rhocritz, np.geomspace(1e-3, 50, 70)


def _profile(mod, arr, sample_dtype=None):
    zs, cs, rss, m200, rhocritz, ks = _profile_inputs()
    fit = battaglia_defaults["AGN"]
    m200, zsa, rhocritz = arr(m200), arr(zs), arr(rhocritz)

    def rhofunc(xs):
        return mod.rho_gas_x(xs[None, None, :], m200[..., None],
                             zsa[:, None, None], 0.049, 0.31,
                             rhocritz[:, None, None], -0.2, fit)

    kw = {} if sample_dtype is None else {"sample_dtype": sample_dtype}
    return mod.generic_profile_fft(rhofunc, arr(cs), arr(rss), zs, ks, 20.0,
                                   2048, **kw)[1]


def test_generic_profile_fft_matches_jax():
    """float64: <= 1e-12 of the peak against JAX on the CPU.  float32
    samples (complex64 FFT, float32 table, the float32-storage resample)
    against the JAX float64 transform: <= 2e-6 absolute on u, the gate of
    tests/test_fast_sampling.py."""
    class J:  # the JAX side, seen through one interface
        rho_gas_x = staticmethod(jprof.rho_gas_x)
        generic_profile_fft = staticmethod(jst.generic_profile_fft)

    class T:
        rho_gas_x = staticmethod(tprof.rho_gas_x)
        generic_profile_fft = staticmethod(tst.generic_profile_fft)

    want = np.asarray(jax.jit(lambda: _profile(J, jnp.asarray))())
    got = _profile(T, _t)
    assert got.shape == want.shape == (3, 12, 70) and got.dtype == F64
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()
    got32 = _profile(T, _t, sample_dtype=torch.float32)
    assert got32.dtype == F64
    assert np.abs(got32.numpy() - want).max() <= 2e-6


@pytest.fixture(scope="module")
def jax_electron_jvp():
    """JAX's make_electron_fn(growth="closed") at P0 and its Jacobian
    over NAMES there, from one compile."""
    fn = jpipe.make_electron_fn(ZS, KS, MS, nxs=NXS, xmax=XMAX, jit=False,
                                growth="closed")
    jvp = jax_jvp(fn, NAMES)
    theta = [P0[k] for k in NAMES]
    return ([np.asarray(o) for o in jvp_value(jvp, theta)],
            jacobian_columns(jvp, theta, len(NAMES)))


@pytest.fixture(scope="module")
def jax_electron(jax_electron_jvp):
    return jax_electron_jvp[0]


@pytest.mark.parametrize("fast, gate", [(False, 1e-10), (True, 1e-5)],
                         ids=["plain", "fast"])
def test_electron_matches_jax(jax_electron, fast, gate):
    """Pee and Pme against JAX make_electron_fn(growth="closed"): <= 1e-10
    relative with float64 sampling, <= 1e-5 (bench config 2's gate) with
    the float32 sampling of fast=True."""
    fn = tpipe.make_electron_fn(ZS, KS, MS, nxs=NXS, xmax=XMAX, device="cpu",
                                fast=fast)
    pee, pme = fn(P0)
    for got, want in zip((pee, pme), jax_electron):
        assert got.dtype == F64 and got.shape == (ZS.size, KS.size)
        assert _rel(got.numpy(), want) <= gate


def test_electron_grid_from_parameters(jax_electron):
    """nxs and xmax default to the electron profile parameters, read from
    the overrides as Python numbers; a tensor there is refused."""
    fn = tpipe.make_electron_fn(ZS, KS, MS, device="cpu")
    ov = {**P0, "electron_density_profile_integral_numxs": NXS,
          "electron_density_profile_integral_xmax": float(XMAX)}
    for got, want in zip(fn(ov), jax_electron):
        assert _rel(got.numpy(), want) <= 1e-10
    with pytest.raises(TypeError):
        fn({**ov, "electron_density_profile_integral_xmax":
            torch.tensor(10.0, dtype=F64)})
    with pytest.raises(TypeError):
        tpipe.make_electron_fn(ZS, KS, MS)          # the device is required
    with pytest.raises(ValueError):
        tpipe.make_electron_fn(ZS, KS, MS, device="cpu", fast="exact")


@pytest.fixture(scope="module")
def torch_electron_jac():
    fn = tpipe.make_electron_fn(ZS, KS, MS, nxs=NXS, xmax=XMAX, device="cpu")
    return [j.numpy() for j in
            tpipe.fisher_jacobian(fn, P0, NAMES, device="cpu")]


def test_electron_fisher_jacobian_matches_jax(torch_electron_jac,
                                              jax_electron_jvp):
    """Forward mode on both sides, float64: <= 1e-9 relative, per column
    (d/d omch2 and d/d As) of both spectra."""
    for got, w in zip(torch_electron_jac, jax_electron_jvp[1]):
        w = np.asarray(w)
        assert got.shape == w.shape == (ZS.size, KS.size, 2)
        for col in range(2):
            assert _rel(got[..., col], w[..., col]) <= 1e-9


def test_electron_reverse_gradient_matches_forward(torch_electron_jac):
    """d sum(Pee + Pme) / d omch2 by reverse mode (through the resample
    Function's backward) equals the Jacobian's column sum."""
    fn = tpipe.make_electron_fn(ZS, KS, MS, nxs=NXS, xmax=XMAX, device="cpu")
    om = torch.tensor(P0["omch2"], dtype=F64, requires_grad=True)
    pee, pme = fn({"omch2": om, "As": P0["As"]})
    g, = torch.autograd.grad(pee.sum() + pme.sum(), om)
    want = sum(j[..., 0].sum() for j in torch_electron_jac)
    assert abs(float(g) / want - 1.0) <= 1e-10


def test_config2_full_width_matches_golden():
    """The port at config 2's full width (20 z x 200 m x 1001 k, nxs 4096)
    on the CPU against the JAX package's golden Pee and Pme: <= 1e-10
    relative for the bench cosmology."""
    g = np.load(GOLDEN)
    fn = tpipe.make_electron_fn(g["zs"], g["ks"], g["ms"], nxs=int(g["nxs"]),
                                xmax=float(g["xmax"]), device="cpu")
    ov = dict(zip(g["param_names"].tolist(), g["param_values"][0]))
    pee, pme = fn(ov)
    assert pee.shape == pme.shape == (20, 1001)
    assert _rel(pee.numpy(), g["pee"][0]) <= 1e-10
    assert _rel(pme.numpy(), g["pme"][0]) <= 1e-10
