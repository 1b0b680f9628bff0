"""PyTorch port, the resample kernel's plain version and wrappers.

On the CPU the wrappers compute the plain version, which is held against
the JAX package: its gather form of resample_uniform_source, its Pallas
pair-selection kernel run in interpret mode and composed with the lerp,
and jax.jvp / jax.vjp of the gather form.  The JAX imports sit inside
those tests so that the card test below also runs where there is no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_resample_kernels.py

(``--noconftest``: the repository's conftest.py configures JAX.)
"""

import numpy as np
import pytest
import torch

from hmvec_tpu_torch.ops import resample_kernels as rk
from hmvec_tpu_torch.ops import sine_transform as st

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _case(name):
    """(u, scales, ks, dkt) as numpy: the shapes of
    tests/test_pallas_resample.py (13 x 275 -> 97, deliberately unaligned,
    and a 3-d batch (3, 5, 130) -> 33), with targets below the first kt
    (p < 1) and above Nyquist (p > nkt - 1), and a case whose positions
    land exactly on integers."""
    rng = np.random.default_rng({"2d": 1, "3d": 2, "integer": 3}[name])
    if name == "2d":
        batch, nkt, nk, dkt = (13,), 275, 97, 0.3
    elif name == "3d":
        batch, nkt, nk, dkt = (3, 5), 130, 33, 0.3
    else:
        batch, nkt, nk, dkt = (7,), 64, 80, 0.25
    u = rng.standard_normal((*batch, nkt))
    if name == "integer":
        # k s / dkt = integer exactly: ks on a grid of quarters, s = 1
        scales = np.ones(batch)
        ks = np.arange(nk) * 0.25
    else:
        scales = rng.uniform(0.1, 2.0, batch)
        # p from ~1e-3 to ~2 nkt: both boundary branches fire
        ks = np.geomspace(1e-3 * dkt / 2.0, 2.0 * nkt * dkt / 0.1, nk)
    return u, scales, ks, dkt


CASES = ("2d", "3d", "integer")


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _both_boundaries(u, scales, ks, dkt):
    p = ks * scales[..., None] / dkt
    return bool((p < 1).any()) and bool((p > u.shape[-1] - 1).any())


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_gather(name):
    """pair_lerp_plain vs the JAX gather form of resample_uniform_source:
    rtol 1e-14 (the same float64 operations)."""
    import jax.numpy as jnp
    from hmvec_tpu.ops.sine_transform import resample_uniform_source

    u, scales, ks, dkt = _case(name)
    if name != "integer":
        assert _both_boundaries(u, scales, ks, dkt)
    import jax

    # the JAX side compiled once (op by op it takes seconds)
    want = np.asarray(jax.jit(lambda: resample_uniform_source(
        jnp.asarray(u), dkt, jnp.asarray(scales), jnp.asarray(ks),
        method="gather"))())
    got = rk.pair_lerp_plain(_t(u), _t(scales), _t(ks), dkt)
    assert got.dtype == F64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)
    # and resample_uniform_source's gather method is the plain version
    assert torch.equal(st.resample_uniform_source(_t(u), dkt, _t(scales),
                                                  _t(ks), method="gather"),
                       got)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", CASES)
def test_plain_matches_pallas_selection(name, dtype):
    """The pair selection of JAX select_pairs (Pallas, interpret mode)
    composed with the lerp and the boundaries in float64: exact for
    float32 u; for float64 u rtol 1e-14 on the selected samples, and on
    the lerp rtol 1e-14 plus 2^-52 max|u| absolute, since the kernel's
    hi/lo split rounds each sample at 2^-53 of its size and the lerp's
    cancellation carries that to values much smaller than u."""
    import jax.numpy as jnp
    from hmvec_tpu.ops.pallas_resample import select_pairs

    u, scales, ks, dkt = _case(name)
    u = u.astype(dtype)
    nkt = u.shape[-1]
    p = ks * scales[..., None] / dkt
    i0f = np.clip(np.floor(p), 1, nkt - 2)
    j0, j1 = select_pairs(jnp.asarray(u), jnp.asarray(i0f.astype(np.int32)),
                          interpret=True)
    u0, u1 = np.asarray(j0, np.float64), np.asarray(j1, np.float64)
    want = u0 + (p - i0f) * (u1 - u0)
    want = np.where(p < 1.0, u[..., 1:2].astype(np.float64), want)
    want = np.where(p > nkt - 1.0, 0.0, want)
    got = rk.pair_lerp_plain(_t(u), _t(scales), _t(ks), dkt).numpy()
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        i0 = i0f.astype(np.int64)
        np.testing.assert_allclose(u0, np.take_along_axis(u, i0, -1),
                                   rtol=1e-14, atol=0)
        np.testing.assert_allclose(u1, np.take_along_axis(u, i0 + 1, -1),
                                   rtol=1e-14, atol=0)
        np.testing.assert_allclose(got, want, rtol=1e-14,
                                   atol=2.0**-52 * np.abs(u).max())


def _jax_resample(u, scales, ks, dkt):
    from hmvec_tpu.ops.sine_transform import resample_uniform_source
    return lambda u_, s_: resample_uniform_source(u_, dkt, s_, ks,
                                                  method="gather")


@pytest.mark.parametrize("name", CASES)
def test_function_derivatives_match_jax(name):
    """The autograd.Function's jvp and backward (recomputed through the
    plain version) against jax.jvp and jax.vjp of the gather form, rtol
    1e-14, in u and in the row scales."""
    import jax
    import jax.numpy as jnp

    u, scales, ks, dkt = _case(name)
    rng = np.random.default_rng(11)
    du = rng.standard_normal(u.shape)
    ds = rng.standard_normal(scales.shape)
    g = rng.standard_normal((*scales.shape, ks.size))
    f = _jax_resample(u, scales, ks, dkt)

    @jax.jit
    def jax_side(u_, s_, du_, ds_, g_):
        # the JAX jvp and vjp in one compiled program
        _, jvp_out = jax.jvp(f, (u_, s_), (du_, ds_))
        _, vjp = jax.vjp(f, u_, s_)
        return jvp_out, vjp(g_)

    want_t, (want_gu, want_gs) = jax_side(
        jnp.asarray(u), jnp.asarray(scales), jnp.asarray(du),
        jnp.asarray(ds), jnp.asarray(g))
    want_gu, want_gs = np.asarray(want_gu), np.asarray(want_gs)

    ks_t = _t(ks)
    fn = lambda a, b: rk.pair_lerp_f64(a, b, ks_t, dkt)  # noqa: E731
    _, got_t = torch.func.jvp(fn, (_t(u), _t(scales)), (_t(du), _t(ds)))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-14,
                               atol=1e-14 * np.abs(want_t).max())
    ur, sr = _t(u).requires_grad_(), _t(scales).requires_grad_()
    gu, gs = torch.autograd.grad((fn(ur, sr) * _t(g)).sum(), (ur, sr))
    np.testing.assert_allclose(gu.numpy(), want_gu, rtol=1e-14,
                               atol=1e-14 * np.abs(want_gu).max())
    np.testing.assert_allclose(gs.numpy(), want_gs, rtol=1e-14,
                               atol=1e-14 * np.abs(want_gs).max())


def test_function_under_vmap():
    """torch.func.vmap over the wrapper and over its jvp: the same as
    one call per mapped element (the vmap rule folds the mapped dimension
    into the rows)."""
    u, scales, ks, dkt = _case("2d")
    rng = np.random.default_rng(12)
    U = _t(rng.standard_normal((4, *u.shape)))
    TS = _t(rng.standard_normal((4, *scales.shape)))
    s, ks_t = _t(scales), _t(ks)
    fn = lambda a, b: rk.pair_lerp_f64(a, b, ks_t, dkt)  # noqa: E731
    got = torch.func.vmap(lambda a: fn(a, s))(U)
    want = torch.stack([fn(a, s) for a in U])
    assert torch.equal(got, want)
    u_t = _t(u)
    got_t = torch.func.vmap(
        lambda tu, ts: torch.func.jvp(fn, (u_t, s), (tu, ts))[1])(U, TS)
    want_t = torch.stack([torch.func.jvp(fn, (u_t, s), (tu, ts))[1]
                          for tu, ts in zip(U, TS)])
    torch.testing.assert_close(got_t, want_t, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wrapper_on_cpu_is_the_plain_version(dtype):
    u, scales, ks, dkt = _case("3d")
    u_t = _t(u).to(dtype)
    before = (rk.pair_lerp_f64.launches, rk.pair_lerp_f32.launches)
    got = rk.pair_lerp(u_t, _t(scales), _t(ks), dkt)
    assert got.dtype == F64
    assert torch.equal(got, rk.pair_lerp_plain(u_t, _t(scales), _t(ks), dkt))
    assert torch.equal(got, st.resample_uniform_source(u_t, dkt, _t(scales),
                                                       _t(ks)))
    # no kernel ran, so no launch is counted
    assert (rk.pair_lerp_f64.launches, rk.pair_lerp_f32.launches) == before


def test_wrapper_rejects_what_it_does_not_take():
    u, scales, ks, dkt = (_t(a) if isinstance(a, np.ndarray) else a
                          for a in _case("2d"))
    with pytest.raises(TypeError):
        rk.pair_lerp_f64(u.float(), scales, ks, dkt)       # dtype
    with pytest.raises(TypeError):
        rk.pair_lerp_f32(u, scales, ks, dkt)
    with pytest.raises(TypeError):
        rk.pair_lerp(u, scales.float(), ks, dkt)
    with pytest.raises(TypeError):
        rk.pair_lerp(u, scales, ks, torch.tensor(dkt))     # dkt a tensor
    with pytest.raises(ValueError):
        rk.pair_lerp(u, scales, ks[None, :], dkt)          # rank of ks
    with pytest.raises(ValueError):
        rk.pair_lerp(u, scales[:-1], ks, dkt)              # batch shape
    with pytest.raises(ValueError):
        rk.pair_lerp(u[..., :2], scales, ks, dkt)          # nkt < 3
    with pytest.raises(ValueError):
        rk.pair_lerp(u.to("meta"), scales.to("meta"), ks.to("meta"), dkt)
    with pytest.raises(ValueError):                        # the device
        st.resample_uniform_source(u, dkt, scales, ks, method="kernel")
    with pytest.raises(ValueError):
        st.resample_uniform_source(u, dkt, scales, ks, method="pallas")


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    """Both kernels against the plain version on the card, bit for bit,
    on the cases above and at the config-2 shape (4,000 rows x 2,049 kt
    -> 1,001 k), with one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    cases = [_case(name) for name in CASES]
    cases.append((rng.standard_normal((4000, 2049)),
                  rng.uniform(0.003, 12.0, 4000),
                  np.geomspace(1e-4, 100, 1001), 2 * np.pi / 20.0))
    for u, scales, ks, dkt in cases:
        s, k = _t(scales).to(dev), _t(ks).to(dev)
        for wrapper, dtype in ((rk.pair_lerp_f64, F64),
                               (rk.pair_lerp_f32, torch.float32)):
            u_t = _t(u).to(dev, dtype)
            n0 = wrapper.launches
            got = wrapper(u_t, s, k, dkt)
            torch.cuda.synchronize()
            assert got.is_cuda and wrapper.launches == n0 + 1
            assert torch.equal(got, rk.pair_lerp_plain(u_t, s, k, dkt))
