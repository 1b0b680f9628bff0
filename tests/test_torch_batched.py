"""PyTorch port, batch serving: ``pipeline.make_batched_fn`` against a loop
of the port's own single calls and against the JAX package's
``make_batched_fn`` on the CPU, and the ``torch.func.vmap`` rules of the
NFW kernels' wrappers against their plain versions.

On the CPU the kernel tiers run the plain versions, so a batched call and
its single calls do the same float64 arithmetic per element."""

import warnings

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from hmvec_tpu import pipeline as jpipe
except ImportError:    # a machine with the card and no JAX: the tests
    jnp = None         # marked gpu need none of it (run them with -m gpu)

from hmvec_tpu_torch import pipeline as tpipe
from hmvec_tpu_torch.models import background as tbg
from hmvec_tpu_torch.ops import nfw_kernels as nk

ZS = np.linspace(0.1, 3.0, 3)
MS = np.geomspace(2e10, 1e17, 24)
KS = np.geomspace(1e-4, 100, 64)
NAMES = ("omch2", "As")
RNG = np.random.default_rng(5)
THETA = np.column_stack([RNG.uniform(0.11, 0.13, 3),
                         RNG.uniform(2.0e-9, 2.4e-9, 3)])
# make_pmm_fn options by tier; "serving" is bench.py's bN line
TIERS = {
    "plain": {},
    "fast": {"fast": True},
    "exact": {"fast": "exact"},
    "fused": {"fused_serving": True},
    "serving": {"fast": True, "static_params": {"sigma2_numks": 1250},
                "uk_subsample": (0.2, 4)},
}
F64 = torch.float64


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _no_vmap_fallback():
    """A tensor operation without a batching rule falls back to a loop
    over the batch (B times the launches) with a warning: an error here."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*batching rule.*")
        yield


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got, dtype=np.float64)
                               / np.asarray(want, dtype=np.float64) - 1.0)))


def _loop(fn, names, theta):
    outs = [fn(dict(zip(names, row))) for row in np.asarray(theta).tolist()]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


@pytest.fixture(scope="module")
def jax_batched_pmm():
    """hmvec_tpu.pipeline.make_batched_fn of the float64 Pmm on THETA."""
    fn = jpipe.make_pmm_fn(ZS, KS, MS, jit=False, growth="closed")
    bf = jpipe.make_batched_fn(fn, NAMES)
    return np.asarray(bf(jnp.asarray(THETA)))


@pytest.mark.parametrize("tier", list(TIERS))
def test_batched_equals_loop_of_single_calls(tier):
    fn = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu", **TIERS[tier])
    out = tpipe.make_batched_fn(fn, NAMES)(THETA)
    assert out.shape == (3, ZS.size, KS.size) and out.dtype == F64
    assert _rel(out, _loop(fn, NAMES, THETA)) <= 1e-12


@pytest.mark.parametrize("tier", ["plain", "fast", "exact", "fused"])
def test_batched_matches_jax_batched(jax_batched_pmm, tier):
    """Against hmvec_tpu.pipeline.make_batched_fn (float64 on the CPU,
    where the JAX kernel tiers also run the analytic profile): 1e-10."""
    fn = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu", **TIERS[tier])
    out = tpipe.make_batched_fn(fn, NAMES)(THETA)
    assert _rel(out, jax_batched_pmm) <= 1e-10


def test_serving_options_match_jax_batched():
    """bench.py's bN line (sigma^2 on 1,250 k, thinned u(k), float32 out)
    against the JAX package's: both cast the same float64 numbers, so they
    agree to float32 rounding, 1.2e-7.  The bNf line (the same through the
    fused tier, which fills in S1 and S2 rather than u) against the JAX
    fused tier with its contraction kernel in Pallas interpret mode, whose
    u is float32: 1e-5, the gate of tests/test_fast_sampling.py."""
    ks = np.geomspace(1e-4, 100, 301)
    kw = {"static_params": {"sigma2_numks": 1250}, "uk_subsample": (0.2, 4)}
    old = jpipe._FUSED_INTERPRET
    jpipe._FUSED_INTERPRET = True
    try:
        for extra, gate in (({"fast": True}, 1.2e-7),
                            ({"fused_serving": True}, 1e-5)):
            jfn = jpipe.make_pmm_fn(
                ZS, ks, MS, jit=False, growth="closed", **kw,
                fused_serving=extra.get("fused_serving", False))
            want = np.asarray(jpipe.make_batched_fn(
                jfn, NAMES, out_dtype=jnp.float32)(jnp.asarray(THETA)))
            fn = tpipe.make_pmm_fn(ZS, ks, MS, device="cpu", **kw, **extra)
            out = tpipe.make_batched_fn(fn, NAMES,
                                        out_dtype=torch.float32)(THETA)
            assert out.dtype == torch.float32 and want.dtype == np.float32
            assert _rel(out, want) <= gate
    finally:
        jpipe._FUSED_INTERPRET = old


def test_array_tensor_and_dict_input():
    fn = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu")
    bf = tpipe.make_batched_fn(fn, NAMES)
    out = bf(THETA)
    assert torch.equal(bf(torch.as_tensor(THETA)), out)
    assert torch.equal(bf({"omch2": THETA[:, 0], "As": THETA[:, 1]}), out)
    assert torch.equal(bf({"As": torch.as_tensor(THETA[:, 1]),
                           "omch2": THETA[:, 0].tolist()}), out)
    with pytest.raises(ValueError):
        bf(THETA[:, :1])                    # one column short


def test_base_overrides_apply_to_every_element():
    fn = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu")
    base = {"ns": 0.95, "H0": 70.0}
    out = tpipe.make_batched_fn(fn, NAMES, base=base)(THETA)
    want = _loop(lambda ov: fn({**base, **ov}), NAMES, THETA)
    assert _rel(out, want) <= 1e-12
    assert _rel(out, tpipe.make_batched_fn(fn, NAMES)(THETA)) > 1e-3


def test_out_dtype_casts_every_leaf():
    fn = tpipe.make_electron_fn(ZS, KS, MS, device="cpu", nxs=256, xmax=20.0)
    out = tpipe.make_batched_fn(fn, NAMES, out_dtype=torch.float32)(THETA[:2])
    want = _loop(fn, NAMES, THETA[:2])
    assert isinstance(out, tuple) and len(out) == 2
    for o, w in zip(out, want):
        assert o.dtype == torch.float32 and o.shape == (2, ZS.size, KS.size)
        assert _rel(o, w) <= 1.2e-7          # float32 rounding of the cast


def test_static_parameters_are_refused():
    fn = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu")
    for name in ("sigma2_numks", "hod_bisection_num_iter",
                 "electron_density_profile_integral_numxs"):
        with pytest.raises(ValueError, match="shape a grid"):
            tpipe.make_batched_fn(fn, ("omch2", name))


@pytest.mark.parametrize("tier", ["plain", "fast", "fused"])
def test_reverse_mode_through_a_batched_call(tier):
    """tests/test_pipeline.py::test_batched_grad: d sum(log Pmm) / d theta
    is finite and non-zero, and equals the gradient through single calls."""
    fn = tpipe.make_pmm_fn(ZS, KS[::2], MS, device="cpu", **TIERS[tier])
    bf = tpipe.make_batched_fn(fn, ("omch2",))
    theta = torch.tensor([[0.11], [0.13]], dtype=F64, requires_grad=True)
    torch.log(bf(theta)).sum().backward()
    g = theta.grad
    assert g.shape == (2, 1) and bool(torch.isfinite(g).all())
    assert bool((g != 0).all())
    theta2 = torch.tensor([[0.11], [0.13]], dtype=F64, requires_grad=True)
    sum(torch.log(fn({"omch2": row[0]})).sum() for row in theta2).backward()
    assert _rel(g, theta2.grad) <= 1e-10
    # the functional transform composes with the batch as well
    g2 = torch.func.grad(lambda th: torch.log(bf(th)).sum())(theta.detach())
    assert _rel(g2, theta2.grad) <= 1e-10


def test_forward_mode_jacobian_of_a_batched_call():
    """fisher_jacobian (vectorized forward mode) over a base parameter of a
    batched fused call: the tangents pass the kernel's vmap rule."""
    fn = tpipe.make_pmm_fn(ZS, KS[::2], MS, device="cpu", fused_serving=True)

    def batched(ov):
        return tpipe.make_batched_fn(fn, ("omch2",), base=ov)(THETA[:2, :1])

    jac = tpipe.fisher_jacobian(batched, {"As": 2.2e-9, "ns": 0.96},
                                ("As", "ns"), device="cpu")
    assert jac.shape == (2, ZS.size, KS[::2].size, 2)
    for i, om in enumerate(THETA[:2, 0]):
        single = tpipe.fisher_jacobian(
            lambda ov: fn({**ov, "omch2": om}), {"As": 2.2e-9, "ns": 0.96},
            ("As", "ns"), device="cpu")
        assert _rel(jac[i], single) <= 1e-10


BATCH_H0_MNU = np.array([[64.0, 0.0], [67.3, 0.06], [72.0, 0.3]])


def test_batch_over_H0_and_mnu():
    """A batched H0 makes omnu0 a batched tensor, which has no one value
    to read: the neutrino ratio is taken (it is exactly 1 at mnu = 0), as
    the JAX package does for a traced value."""
    names = ("H0", "mnu")
    fn = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu")
    out = tpipe.make_batched_fn(fn, names)(BATCH_H0_MNU)
    assert _rel(out, _loop(fn, names, BATCH_H0_MNU)) <= 1e-12
    jfn = jpipe.make_pmm_fn(ZS, KS, MS, jit=False, growth="auto")
    want = jpipe.make_batched_fn(jfn, names)(jnp.asarray(BATCH_H0_MNU))
    assert _rel(out, want) <= 1e-10


def test_batch_over_w0_and_wa_takes_the_integrated_growth():
    """growth='auto' with a batched w0 or wa is 'ode' for every element,
    the LCDM one included (tests/test_robustness.py batches so)."""
    names = ("w0", "wa")
    theta = np.array([[-1.0, 0.0], [-0.9, 0.0], [-1.1, 0.3]])
    fn = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu")            # auto
    out = tpipe.make_batched_fn(fn, names)(theta)
    ode = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu", growth="ode")
    assert _rel(out, _loop(ode, names, theta)) <= 1e-12
    jfn = jpipe.make_pmm_fn(ZS, KS, MS, jit=False, growth="auto")
    want = jpipe.make_batched_fn(jfn, names)(jnp.asarray(theta))
    assert _rel(out, want) <= 1e-10
    # w0 alone batched, and the resolution itself
    out_w0 = tpipe.make_batched_fn(fn, ("w0",))(theta[:, :1])
    assert _rel(out_w0[:2], out[:2]) <= 1e-12


def test_varies_knows_a_batched_tensor():
    seen = []

    def probe(x):
        seen.append((tbg._varies(x), tbg.growth_mode_for({"w0": x}),
                     tpipe._growth_mode_from({"wa": x}, "auto")))
        return x

    torch.func.vmap(probe)(torch.tensor([-1.0, -1.0], dtype=F64))
    assert seen == [(True, "ode", "ode")]
    x = torch.tensor(-1.0, dtype=F64)
    assert not tbg._varies(x) and not tbg._varies(-1.0)
    assert tbg.growth_mode_for({"w0": x}) == "closed"
    assert tbg._varies(x.clone().requires_grad_())


def test_electron_batched_at_two():
    for fast in (False, True):
        fn = tpipe.make_electron_fn(ZS, KS, MS, device="cpu", nxs=256,
                                    xmax=20.0, fast=fast)
        out = tpipe.make_batched_fn(fn, NAMES)(THETA[:2])
        for o, w in zip(out, _loop(fn, NAMES, THETA[:2])):
            assert _rel(o, w) <= 1e-12
    jfn = jpipe.make_electron_fn(ZS, KS, MS, nxs=256, xmax=20, jit=False,
                                 growth="closed")
    want = jpipe.make_batched_fn(jfn, NAMES)(jnp.asarray(THETA[:2]))
    fn = tpipe.make_electron_fn(ZS, KS, MS, device="cpu", nxs=256, xmax=20.0)
    for o, w in zip(tpipe.make_batched_fn(fn, NAMES)(THETA[:2]), want):
        assert _rel(o, w) <= 1e-10


# ---- the vmap rules of the kernels' wrappers --------------------------------

def _rows(seed, *shape):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=F64)
    return (t(np.exp(rng.uniform(np.log(0.003), np.log(3.0), shape))),
            t(rng.uniform(2.0, 15.0, shape)))


@pytest.mark.parametrize("tier", nk.TIERS)
def test_nfw_uk_vmap_rule_matches_plain(tier):
    ks = torch.as_tensor(KS)
    scales, cs = _rows(0, 4, 10)
    want = torch.stack([nk.nfw_uk_plain(ks, s, c)
                        for s, c in zip(scales, cs)])
    call = lambda s, c: nk.nfw_uk(ks, s, c, tier=tier)
    assert torch.equal(torch.func.vmap(call)(scales, cs), want)
    # one argument mapped, the other shared; a mapped dimension that is
    # not the first; a vmap inside a vmap
    got = torch.func.vmap(call, in_dims=(0, None))(scales, cs[0])
    assert torch.equal(got[2], nk.nfw_uk_plain(ks, scales[2], cs[0]))
    got = torch.func.vmap(call, in_dims=(1, 1))(scales.T.contiguous(),
                                                cs.T.contiguous())
    assert torch.equal(got, want)
    s3, c3 = _rows(1, 2, 3, 5)
    got = torch.func.vmap(torch.func.vmap(call))(s3, c3)
    assert got.shape == (2, 3, 5, KS.size)
    assert torch.equal(got[1, 2], nk.nfw_uk_plain(ks, s3[1, 2], c3[1, 2]))
    with pytest.raises(NotImplementedError, match="one ks"):
        torch.func.vmap(lambda k: nk.nfw_uk(k, scales[0], cs[0], tier=tier))(
            torch.stack([ks, ks]))


def test_nfw_contract_vmap_rule_matches_plain():
    ks = torch.as_tensor(KS)
    scales, cs = _rows(2, 3, 4, 10)
    a, b = _rows(3, 3, 4, 10)
    want = [torch.stack(x) for x in zip(*(
        nk.nfw_contract_plain(ks, *row) for row in zip(scales, cs, a, b)))]
    call = lambda *row: nk.nfw_contract(ks, *row)
    got = torch.func.vmap(call)(scales, cs, a, b)
    for x, w in zip(got, want):
        assert x.shape == (3, 4, KS.size) and _rel(x, w) <= 1e-14
    got = torch.func.vmap(call, in_dims=(0, 0, None, None))(
        scales, cs, a[0], b[0])
    for x, w in zip(got, nk.nfw_contract_plain(ks, scales[1], cs[1], a[0],
                                               b[0])):
        assert _rel(x[1], w) <= 1e-14
    with pytest.raises(NotImplementedError, match="one ks"):
        torch.func.vmap(lambda k: nk.nfw_contract(
            k, scales[0], cs[0], a[0], b[0]))(torch.stack([ks, ks]))


def test_vmap_rules_under_both_autodiff_modes():
    """Reverse mode through a vmapped wrapper call, and batched tangents
    (torch.autograd.functional.jacobian, vectorized forward mode)."""
    ks = torch.as_tensor(KS)
    scales, cs = _rows(4, 3, 6)
    a, b = _rows(5, 3, 6)

    def loss(fn):
        def f(s, c):
            u = fn(s, c)
            s1, s2 = nk.nfw_contract(ks, s, c, a, b)
            return (u**2).sum() + s1.sum() + (s2**2).sum()
        return f

    kernel = loss(lambda s, c: torch.func.vmap(
        lambda s_, c_: nk.nfw_uk(ks, s_, c_, tier="exact"))(s, c))
    plain = loss(lambda s, c: nk.nfw_uk_plain(ks, s.reshape(-1),
                                              c.reshape(-1)))
    s_k, c_k = scales.clone().requires_grad_(), cs.clone().requires_grad_()
    s_p, c_p = scales.clone().requires_grad_(), cs.clone().requires_grad_()
    kernel(s_k, c_k).backward()
    plain(s_p, c_p).backward()
    assert _rel(s_k.grad, s_p.grad) <= 1e-10
    assert _rel(c_k.grad, c_p.grad) <= 1e-10
    # reverse mode with the contraction itself under vmap
    def batched_contract(s, c):
        s1, s2 = torch.func.vmap(
            lambda s_, c_, a_, b_: nk.nfw_contract(ks, s_[None], c_[None],
                                                   a_[None], b_[None]))(
            s, c, a, b)
        return s1.sum() + (s2**2).sum()

    g = torch.func.grad(batched_contract, argnums=(0, 1))(scales, cs)
    u = nk.nfw_uk_plain(ks, s_p.reshape(-1), c_p.reshape(-1)).reshape(3, 6, -1)
    want = torch.autograd.grad(
        ((a[..., None] * u**2).sum() + ((b[..., None] * u).sum(1) ** 2).sum()),
        (s_p, c_p))
    for x, w in zip(g, want):
        assert _rel(x, w) <= 1e-10
    jac = torch.autograd.functional.jacobian(
        lambda s: torch.func.vmap(
            lambda s_, c_: nk.nfw_uk(ks, s_, c_, tier="fast"))(s, cs),
        scales, vectorize=True, strategy="forward-mode")
    want = torch.autograd.functional.jacobian(
        lambda s: nk.nfw_uk_plain(ks, s.reshape(-1), cs.reshape(-1)).reshape(
            3, 6, -1), scales, vectorize=True)
    assert jac.shape == want.shape and _rel(jac[want != 0],
                                            want[want != 0]) <= 1e-10


def test_row_count_above_the_old_grid_limit():
    """Rows ride on gridDim.x: 524,281 rows (one more than 8 x 65,535, the
    limit while they rode on gridDim.y) and B = 132 at bench width pass
    the launch's checks, and the wrapper takes that many rows."""
    nk._check_uk_grid(524_281, 1001)
    nk._check_uk_grid(132 * 4000, 589)
    nk._check_uk_grid(2**31 - 1, 128 * 65535)
    with pytest.raises(ValueError, match="at most"):
        nk._check_uk_grid(2**31, 64)
    with pytest.raises(ValueError, match="at most"):
        nk._check_uk_grid(8, 128 * 65535 + 1)
    ks = torch.as_tensor([0.01, 1.0], dtype=F64)
    scales, cs = _rows(6, 524_281)
    u = nk.nfw_uk_fast(ks, scales, cs)
    assert u.shape == (524_281, 2)
    assert torch.equal(u[-3:], nk.nfw_uk_plain(ks, scales[-3:], cs[-3:]))


@pytest.mark.gpu
def test_batched_call_launches_each_kernel_once_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for kw, wrapper in (({"fast": True}, nk.nfw_uk_fast),
                        ({"fast": "exact"}, nk.nfw_uk_exact),
                        ({"fused_serving": True}, nk.nfw_contract)):
        fn = tpipe.make_pmm_fn(ZS, KS, MS, device="cuda", **kw)
        bf = tpipe.make_batched_fn(fn, NAMES)
        bf(THETA)
        wrapper.launches = 0
        out = bf(THETA)
        torch.cuda.synchronize()
        assert wrapper.launches == 1
        assert _rel(out.cpu(), _loop(fn, NAMES, THETA).cpu()) <= 1e-12
