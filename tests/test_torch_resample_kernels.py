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


def _row_col(e, nk):
    """The kernel's (row, column) of flat output index e and of e + 1 (a
    pair's second target: the next column, or the next row's first)."""
    b, j = np.divmod(e, nk)
    j2 = j + 1
    b2 = np.where(j2 == nk, b + 1, b)
    return b, j, b2, np.where(j2 == nk, 0, j2)


@pytest.mark.parametrize("occupancy", [{"rows": 8, "flat": 5},
                                       {"rows": 1, "flat": 1}])
@pytest.mark.parametrize("rows,nk", [(1, 1), (1, 2), (3, 3), (4001, 1),
                                     (3, 101), (4001, 101), (500, 101),
                                     (2000, 101), (1, 4097), (3, 1001),
                                     (4000, 1001)])
def test_launch_geometry_covers_the_output(rows, nk, occupancy):
    """pair_lerp_geometry's launch, walked as the kernels walk it.  Whole
    rows a block (rows per block R > 0): thread (c, r) of block x, on a
    block nk rounded up to whole warps wide and R high, on column c of row
    x R + r, idle past nk or the last row.  The flat kernel: block x takes
    the pair ranges x, x + blocks, ... of 512 pairs each, thread t pairs t
    and 256 + t of a range, pair q the flat targets 2q and 2q + 1.  Every
    target of rows x nk is written exactly once and none past the end; at
    odd nk some pairs straddle two rows and their second target is the
    next row's first; whole rows where nk <= 256 and one wave holds their
    blocks, as many a block as 256 threads hold; the flat kernel on at
    most one wave of blocks."""
    n_sm = 132
    blocks, per_block_rows = rk.pair_lerp_geometry(rows, nk, n_sm,
                                                   occupancy)
    total = rows * nk
    width = -(-nk // 32) * 32
    packed = nk <= 256 and -(-rows // (256 // width)) <= n_sm * occupancy[
        "rows"]
    if per_block_rows:
        assert packed and per_block_rows == 256 // width
        assert blocks == -(-rows // per_block_rows)
        x, y = np.arange(width), np.arange(per_block_rows)
        b = (np.arange(blocks)[:, None, None] * per_block_rows
             + y[None, :, None])
        j = np.broadcast_to(x[None, None, :], b.shape[:2] + x.shape)
        b = np.broadcast_to(b, j.shape)
        live = (j < nk) & (b < rows)
        written = (b * nk + j)[live]
        assert np.array_equal(np.sort(written), np.arange(total))
        return
    assert not packed
    assert 1 <= blocks <= n_sm * occupancy["flat"]
    assert blocks == min(-(-total // 1024), n_sm * occupancy["flat"])
    per_block = 256 * rk.PAIRS
    npairs = -(-total // 2)
    starts = np.concatenate([np.arange(x * per_block, npairs,
                                       blocks * per_block)
                             for x in range(blocks)])
    assert np.array_equal(np.sort(starts), np.arange(0, npairs, per_block))
    e = 2 * (starts[:, None] + np.arange(per_block)[None, :]).reshape(-1)
    written = np.concatenate([e[e < total], e[e + 1 < total] + 1])
    assert written.size == total
    assert np.array_equal(np.sort(written), np.arange(total))
    b, j, b2, j2 = _row_col(e[e + 1 < total], nk)
    assert np.array_equal(b2 * nk + j2, e[e + 1 < total] + 1)
    assert np.all((b < rows) & (b2 < rows) & (j < nk) & (j2 < nk))
    seams = b2 != b
    if nk % 2 and rows > 2:
        assert seams.any() and np.all(j2[seams] == 0)
    elif nk % 2 == 0:
        assert not seams.any()


def _edge_cases():
    """(name, u, scales, ks, dkt) as numpy at the shapes that break a
    tiled, vectorised or row-packed kernel: nk 1, 2, 3, 101, 1,001 and
    4,097 against 1, 3 and 4,001 rows, nkt odd and even down to 3; dkt a
    power of two and targets on a grid of quarters, so that positions land
    exactly on 1 and nkt - 1; targets unsorted and repeated, below 1 and
    above Nyquist; and one nkt of 40,001."""
    rng = np.random.default_rng(21)
    cases = []
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
        cases.append((f"{rows}x{nkt}->{nk}", rng.standard_normal((rows, nkt)),
                      scales, m * 0.25, 0.25))
    cases.append(("3x40001->101", rng.standard_normal((3, 40001)),
                  np.array([1.0, 3.0, 7.0]),
                  np.sort(rng.uniform(0.0, 40001.0, 101)) * 0.25, 0.25))
    return cases


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    """Both kernels against the plain version on the card, bit for bit
    (torch.equal), with one launch each: the cases above, the config-2
    shape (4,000 rows x 2,049 kt -> 1,001 k), the edge cases, a 3-d batch
    and a vmapped call (one launch for the mapped batch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    cases = [_case(name) for name in CASES]
    cases.append((rng.standard_normal((4000, 2049)),
                  rng.uniform(0.003, 12.0, 4000),
                  np.geomspace(1e-4, 100, 1001), 2 * np.pi / 20.0))
    cases += [c[1:] for c in _edge_cases()]
    cases.append((rng.standard_normal((2, 3, 7)), np.full((2, 3), 1.0),
                  np.arange(33) * 0.25, 0.25))
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
    u, scales, ks, dkt = _case("2d")
    s, k = _t(scales).to(dev), _t(ks).to(dev)
    U = _t(rng.standard_normal((5, *u.shape))).to(dev)
    for wrapper, dtype in ((rk.pair_lerp_f64, F64),
                           (rk.pair_lerp_f32, torch.float32)):
        n0 = wrapper.launches
        got = torch.func.vmap(lambda a: wrapper(a, s, k, dkt))(U.to(dtype))
        torch.cuda.synchronize()
        assert wrapper.launches == n0 + 1
        assert torch.equal(got, torch.stack([
            rk.pair_lerp_plain(a, s, k, dkt) for a in U.to(dtype)]))


def _wide_case(dev, dtype):
    """(u, scales, ks, dkt) on the card whose offsets into u pass 2^31
    elements: (rows + 1) x nkt just above 2^31 at nkt = 2,049 (8.6 GB of
    float32, 17.2 GB of float64), nk = 5 (odd: pairs straddle rows), so
    that the flat kernel takes its 64-bit instantiation; targets on
    quarters with dkt = 1/4 and scales 1/2, 1, 2, so that positions land
    on 1 and nkt - 1, below 1 and above Nyquist."""
    nkt, nk = 2049, 5
    rows = 2**31 // nkt + 64
    g = torch.Generator(device=dev).manual_seed(23)
    u = torch.randn((rows, nkt), generator=g, dtype=dtype, device=dev)
    scales = 2.0 ** torch.randint(-1, 2, (rows,), generator=g, device=dev)
    ks = torch.tensor([0.25, (nkt - 1) * 0.25, 0.1, nkt * 0.25, 300.125],
                      dtype=F64, device=dev)
    return u, scales.to(F64), ks, 0.25


@pytest.mark.gpu
def test_kernels_match_plain_past_32_bit_offsets():
    """Both kernels where an offset into u passes 2^31 elements (the flat
    kernel's 64-bit instantiation, which a batch of ~210 cosmologies at
    2,049 kt reaches) against the plain version, bit for bit, 2^17 rows at
    a time, with one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for wrapper, dtype in ((rk.pair_lerp_f32, torch.float32),
                           (rk.pair_lerp_f64, F64)):
        u, scales, ks, dkt = _wide_case(dev, dtype)
        rows, nkt = u.shape
        assert (rows + 1) * nkt > 2**31
        n0 = wrapper.launches
        got = wrapper(u, scales, ks, dkt)
        torch.cuda.synchronize()
        assert wrapper.launches == n0 + 1
        step = 2**17
        for a in range(0, rows, step):
            assert torch.equal(got[a:a + step], rk.pair_lerp_plain(
                u[a:a + step], scales[a:a + step], ks, dkt))
        del u, got
        torch.cuda.empty_cache()
