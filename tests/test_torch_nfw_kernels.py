"""PyTorch port, the NFW kernels' plain versions and wrappers.

On the CPU the wrappers compute the plain versions, which are held against
the JAX package: its analytic f64 profile, and its Pallas kernels run in
interpret mode (or, for the double-single kernel, through its pure-jnp
math) at each kernel's own gate.  The JAX imports sit inside those tests so
that the card test below also runs where there is no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_nfw_kernels.py

(``--noconftest``: the repository's conftest.py configures JAX.)
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from hmvec_tpu_torch.ops import nfw_kernels as nk

F64 = torch.float64


def _chip_smoke():
    """The repository's chip_smoke.py as a module (its bounds, SASS counts
    and adversarial cases run on the CPU too)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _emulator():
    """tools/emulate_torch_nfw_fast.py as a module: the kernels' arithmetic
    in numpy."""
    path = (pathlib.Path(__file__).resolve().parents[1] / "tools"
            / "emulate_torch_nfw_fast.py")
    spec = importlib.util.spec_from_file_location("emulate_nfw", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a, device="cpu"):
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)


def _sweeps():
    """(zs, cs, rss, ks) grids of tests/test_pallas_fast.py: the random
    sweep, the padding-edge sizes, phases up to ~800, and the adversarial
    DS sweep with phases up to ~3.7e4."""
    rng = np.random.default_rng(0)
    yield ("random", np.linspace(0.1, 3.0, 3), rng.uniform(2.0, 15.0, (3, 8)),
           rng.uniform(0.01, 1.0, (3, 8)), np.geomspace(1e-4, 100, 130))
    yield ("edges", np.array([0.5]), np.array([[3.0, 7.0, 11.0]]),
           np.array([[0.1, 0.3, 0.6]]), np.geomspace(1e-3, 50, 77))
    yield ("phase800", np.array([3.0]), np.array([[3.0, 8.0]]),
           np.array([[1.5, 2.0]]), np.geomspace(10.0, 100.0, 64))
    rng = np.random.default_rng(0)
    yield ("adversarial", np.linspace(0.1, 3.0, 4),
           rng.uniform(1.2, 30.0, (4, 48)), rng.uniform(0.003, 3.0, (4, 48)),
           np.geomspace(1e-4, 100.0, 201))
    yield ("phase3.7e4", np.array([0.0]), np.array([[25.0, 30.0]]),
           np.array([[8.0, 12.0]]), np.geomspace(10.0, 100.0, 64))


SWEEPS = list(_sweeps())
SWEEP_IDS = [s[0] for s in SWEEPS]


def _rows(zs, cs, rss):
    scales = (rss * (1.0 + zs[:, None])).reshape(-1)
    return scales, cs.reshape(-1)


@pytest.mark.parametrize("sweep", SWEEPS, ids=SWEEP_IDS)
def test_plain_matches_jax_analytic(sweep):
    """nfw_uk_plain vs the JAX float64 profile: <= 1e-12 absolute (u is a
    sum of O(1) terms; both sides run the same float64 algorithm)."""
    _, zs, cs, rss, ks = sweep
    want, take = _analytic_on_union()
    rows, cols = take[sweep[0]]
    scales, c = _rows(zs, cs, rss)
    got = nk.nfw_uk_plain(_t(ks), _t(scales), _t(c)).numpy()
    assert np.abs(got - want[rows][:, cols]).max() <= 1e-12


_FIRST_CALL = """
import sys
import numpy as np
import torch
torch.set_num_threads(int(sys.argv[1]))
from hmvec_tpu_torch.ops import nfw_kernels as nk
a = np.load(sys.argv[2])
u = nk.nfw_uk_plain(*(torch.as_tensor(a[k]) for k in ("ks", "s", "c")))
np.save(sys.argv[3], u.numpy())
"""


def test_plain_is_the_same_in_any_thread_setting(tmp_path):
    """The random sweep's plain u, bit for bit, under 1, 2 and 4 torch
    threads, row by row, among other rows, and as the first math of a
    fresh process with two threads.  Once, in a full run, this sweep came
    out 6.9e-9 from the JAX profile (1e-12 gate): the second OpenMP
    thread's half of the profile's first sin, the process's first call of
    MKL's vector sin, was at MKL's low-accuracy (VML_EP) level
    (tools/vml_ep_repro.py reproduces that run's numbers to the last
    digit).  The plain version now runs in the calling thread.  Each run
    equals the JAX float64 profile within 1e-12."""
    import subprocess
    import sys

    name, zs, cs, rss, ks = SWEEPS[0]
    scales, c = _rows(zs, cs, rss)
    want, take = _analytic_on_union()
    rows, cols = take[name]
    old = torch.get_num_threads()
    try:
        runs = {}
        for n in (1, 2, 4):
            torch.set_num_threads(n)
            runs[f"threads{n}"] = nk.nfw_uk_plain(_t(ks), _t(scales),
                                                  _t(c)).numpy()
    finally:
        torch.set_num_threads(old)
    runs["by row"] = np.concatenate([
        nk.nfw_uk_plain(_t(ks), _t(scales[i:i + 1]), _t(c[i:i + 1])).numpy()
        for i in range(c.size)])
    big = nk.nfw_uk_plain(_t(ks), _t(np.tile(scales, 9)), _t(np.tile(c, 9)))
    runs["among others"] = big.numpy()[-c.size:]
    np.savez(tmp_path / "in.npz", ks=ks, s=scales, c=c)
    root = pathlib.Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", _FIRST_CALL, "2",
                    str(tmp_path / "in.npz"), str(tmp_path / "u.npy")],
                   check=True, cwd=root, timeout=120,
                   env={**__import__("os").environ, "PYTHONPATH": str(root)})
    runs["fresh process"] = np.load(tmp_path / "u.npy")
    ref = runs["threads1"]
    for what, u in runs.items():
        np.testing.assert_array_equal(u, ref, err_msg=what)
    assert np.abs(ref - want[rows][:, cols]).max() <= 1e-12

def _union(sweeps):
    """The rows of several sweeps stacked, on the union of their ks, and
    for each sweep the slices that take its own rows and ks back out: one
    call of a JAX kernel serves every sweep (each element of u depends on
    its row and its k alone), so JAX compiles it once."""
    rows = [_rows(zs, cs, rss) for _, zs, cs, rss, _ in sweeps]
    ks = np.unique(np.concatenate([sw[4] for sw in sweeps]))
    scales = np.concatenate([r[0] for r in rows])
    c = np.concatenate([r[1] for r in rows])
    ends = np.cumsum([0] + [r[0].size for r in rows])
    take = {sw[0]: (slice(lo, hi), np.searchsorted(ks, sw[4]))
            for sw, lo, hi in zip(sweeps, ends[:-1], ends[1:])}
    return ks, scales, c, take


@functools.lru_cache(maxsize=None)
def _analytic_on_union():
    """The JAX float64 profile (profiles.nfw_uk_analytic) on every sweep
    at once, the rows as one redshift of scale r_s (1+z), in one compiled
    program (op by op its first call takes seconds)."""
    import jax
    import jax.numpy as jnp
    from hmvec_tpu.models.profiles import nfw_uk_analytic

    ks, scales, c, take = _union(SWEEPS)
    want = jax.jit(nfw_uk_analytic)(jnp.asarray(ks), jnp.zeros(1),
                                    jnp.asarray(c[None, :]),
                                    jnp.asarray(scales[None, :]))
    return np.asarray(want)[0], take


@functools.lru_cache(maxsize=None)
def _pallas_fast_on_union():
    """JAX nfw_uk_fast (the f32 Pallas kernel B1, interpret mode) on the
    first three sweeps at once."""
    from hmvec_tpu.ops.pallas_kernels import nfw_uk_pallas

    ks, scales, c, take = _union(SWEEPS[:3])
    return np.asarray(nfw_uk_pallas(ks, scales, c, interpret=True)), take


@pytest.mark.parametrize("sweep", SWEEPS[:3], ids=SWEEP_IDS[:3])
def test_plain_within_fast_gate_of_pallas_interpret(sweep):
    """nfw_uk_plain vs JAX nfw_uk_fast (the f32 Pallas kernel B1, interpret
    mode): <= 5e-6 absolute, B1's own gate (tests/test_pallas_fast.py)."""
    _, zs, cs, rss, ks = sweep
    fast, take = _pallas_fast_on_union()
    rows, cols = take[sweep[0]]
    scales, c = _rows(zs, cs, rss)
    got = nk.nfw_uk_plain(_t(ks), _t(scales), _t(c)).numpy()
    assert np.abs(got - fast[rows][:, cols]).max() <= 5e-6


@functools.lru_cache(maxsize=None)
def _ds_math_on_union():
    """The JAX double-single kernel math (B3,
    pallas_kernels._nfw_uk_ds_math, as tests/test_pallas_fast.py runs it)
    on the last two sweeps at once."""
    import jax
    import jax.numpy as jnp
    from hmvec_tpu.ops.pallas_kernels import _nfw_uk_ds_math
    from hmvec_tpu.ops.sine_transform import _split_hi_lo

    ks, scales, c, take = _union(SWEEPS[3:])
    sj, cj, kj = jnp.asarray(scales), jnp.asarray(c), jnp.asarray(ks)
    ln1pc = jnp.log1p(cj)
    mc = ln1pc - cj / (1.0 + cj)

    def pb(v):
        h, lo = _split_hi_lo(v)
        return h[:, None], lo[:, None]

    def pk(v):
        h, lo = _split_hi_lo(v)
        return h[None, :], lo[None, :]

    args = (*pb(sj), *pb((1.0 + cj) * sj), *pb(ln1pc), *pb(1.0 / mc),
            *pb(jnp.log(sj)), *pb(cj / (1.0 + cj)), *pk(kj), *pk(jnp.log(kj)))
    with jax.enable_x64(False):
        return np.asarray(_nfw_uk_ds_math(*args)), take


@pytest.mark.parametrize("sweep", SWEEPS[3:], ids=SWEEP_IDS[3:])
def test_plain_within_exact_gate_of_ds_math(sweep):
    """nfw_uk_plain vs the JAX double-single kernel math (B3,
    pallas_kernels._nfw_uk_ds_math, as tests/test_pallas_fast.py runs it):
    <= 2e-7 absolute, B3's own gate."""
    _, zs, cs, rss, ks = sweep
    ds, take = _ds_math_on_union()
    rows, cols = take[sweep[0]]
    scales, c = _rows(zs, cs, rss)
    got = nk.nfw_uk_plain(_t(ks), _t(scales), _t(c)).numpy()
    assert np.abs(got - ds[rows][:, cols]).max() <= 2e-7


def test_contract_plain_within_gate_of_pallas_interpret():
    """nfw_contract_plain vs JAX nfw_contract_pallas (B2, interpret mode,
    f32 sums): <= 2e-5 relative, B2's own gate, with padded m rows
    (nm = 37)."""
    import jax.numpy as jnp
    from hmvec_tpu.ops.pallas_kernels import nfw_contract_pallas

    rng = np.random.default_rng(3)
    nz, nm = 3, 37
    cs = rng.uniform(2.0, 15.0, (nz, nm))
    scales = rng.uniform(0.02, 1.5, (nz, nm))
    a = rng.lognormal(0.0, 2.0, (nz, nm))
    b = rng.lognormal(0.0, 2.0, (nz, nm))
    ks = np.geomspace(1e-3, 50, 90)
    s1, s2 = nk.nfw_contract_plain(_t(ks), _t(scales), _t(cs), _t(a), _t(b))
    j1, j2 = nfw_contract_pallas(ks, jnp.asarray(scales), jnp.asarray(cs),
                                 jnp.asarray(a), jnp.asarray(b),
                                 interpret=True)
    assert np.abs(s1.numpy() / np.asarray(j1) - 1.0).max() <= 2e-5
    assert np.abs(s2.numpy() / np.asarray(j2) - 1.0).max() <= 2e-5


def _inputs(seed=5, nz=3, nm=7, nk=11):
    rng = np.random.default_rng(seed)
    return (_t(np.geomspace(1e-3, 60.0, nk)),
            _t(rng.uniform(0.01, 3.0, (nz, nm))),
            _t(rng.uniform(1.5, 25.0, (nz, nm))),
            _t(rng.lognormal(0.0, 1.0, (nz, nm))),
            _t(rng.lognormal(0.0, 1.0, (nz, nm))))


@pytest.mark.parametrize("tier", nk.TIERS)
def test_wrapper_on_cpu_is_the_plain_version(tier):
    ks, s, c, a, b = _inputs()
    counters = (nk.nfw_uk_fast, nk.nfw_uk_exact, nk.nfw_contract)
    before = [f.launches for f in counters]
    u = nk.nfw_uk(ks, s.reshape(-1), c.reshape(-1), tier=tier)
    assert u.dtype == F64
    assert torch.equal(u, nk.nfw_uk_plain(ks, s.reshape(-1), c.reshape(-1)))
    s1, s2 = nk.nfw_contract(ks, s, c, a, b)
    p1, p2 = nk.nfw_contract_plain(ks, s, c, a, b)
    assert torch.equal(s1, p1) and torch.equal(s2, p2)
    # no kernel ran, so no launch is counted
    assert [f.launches for f in counters] == before


def test_wrapper_rejects_what_it_does_not_take():
    ks, s, c, a, b = _inputs()
    s1d, c1d = s.reshape(-1), c.reshape(-1)
    with pytest.raises(TypeError):
        nk.nfw_uk(ks, s1d.float(), c1d)
    with pytest.raises(ValueError):
        nk.nfw_uk(ks, s1d, c1d[:-1])
    with pytest.raises(ValueError):
        nk.nfw_uk(ks[None, :], s1d, c1d)
    with pytest.raises(ValueError):
        nk.nfw_uk(ks, s1d, c1d, tier="bf16")
    with pytest.raises(ValueError):
        nk.nfw_contract(ks, s, c, a[:, :-1], b)
    with pytest.raises(ValueError):
        nk.nfw_uk(ks.to("meta"), s1d.to("meta"), c1d.to("meta"))


@pytest.mark.parametrize("tier", nk.TIERS)
def test_nfw_uk_function_derivatives(tier):
    """The autograd.Function's backward and jvp (recomputed through the
    plain version) agree with autograd through the plain version."""
    ks, s, c, _, _ = _inputs()
    s, c = s.reshape(-1), c.reshape(-1)
    g = torch.as_tensor(np.random.default_rng(1).normal(size=(s.numel(),
                                                               ks.numel())))

    def vjp(f):
        sr, cr = s.clone().requires_grad_(), c.clone().requires_grad_()
        return torch.autograd.grad((f(ks, sr, cr) * g).sum(), (sr, cr))

    want = vjp(nk.nfw_uk_plain)
    got = vjp(lambda k_, s_, c_: nk.nfw_uk(k_, s_, c_, tier=tier))
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-14)
    ts, tc = torch.ones_like(s), 0.1 * torch.ones_like(c)
    _, want_t = torch.func.jvp(lambda s_, c_: nk.nfw_uk_plain(ks, s_, c_),
                               (s, c), (ts, tc))
    _, got_t = torch.func.jvp(
        lambda s_, c_: nk.nfw_uk(ks, s_, c_, tier=tier), (s, c), (ts, tc))
    torch.testing.assert_close(got_t, want_t, rtol=1e-12, atol=1e-14)


def test_nfw_contract_function_derivatives():
    ks, s, c, a, b = _inputs()
    rng = np.random.default_rng(2)
    g1 = _t(rng.normal(size=(3, 11)))
    g2 = _t(rng.normal(size=(3, 11)))

    def vjp(f):
        xs = [t.clone().requires_grad_() for t in (s, c, a, b)]
        o1, o2 = f(ks, *xs)
        return torch.autograd.grad((o1 * g1).sum() + (o2 * g2).sum(), xs)

    for x, y in zip(vjp(nk.nfw_contract), vjp(nk.nfw_contract_plain)):
        torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-14)
    tangents = tuple(0.1 * torch.ones_like(t) for t in (s, c, a, b))
    _, want = torch.func.jvp(lambda *x: nk.nfw_contract_plain(ks, *x),
                             (s, c, a, b), tangents)
    _, got = torch.func.jvp(lambda *x: nk.nfw_contract(ks, *x),
                            (s, c, a, b), tangents)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-14)


def test_nfw_ops_counts_no_clenshaw_above_40(monkeypatch):
    """chip_smoke's operation count of Si/Ci: an argument above x = 40
    costs the asymptotic tail alone, whatever the series' length; one at
    or below 40 pays an FMA (2 operations) per term of each of its two
    series."""
    from hmvec_tpu_torch.kernels import _build

    cs = _chip_smoke()
    x = _t([0.5, 4.0, 7.0, 10.0, 39.0, 40.0, 40.5, 1e3])
    for prec in ("f32", "f64"):
        tag = prec.upper()
        base = cs._sici_ops(x, prec)
        monkeypatch.setitem(_build.NCOEF, tag,
                            tuple(n + 100 for n in _build.NCOEF[tag]))
        longer = cs._sici_ops(x, prec)
        above = x > 40.0
        assert torch.equal(longer[above], base[above])
        assert torch.all(longer[~above] - base[~above] == 400)
        assert torch.all(base[above] == cs.RCP_OPS[prec] + 3
                         + 4 * (_build.NASY[tag] - 1))


def test_nfw_ops_splits_f32_and_f64_by_tier():
    """The fast tier counts its phases (x, x2 and their quadrant reduction)
    and the row constants as float64 and the rest as float32; the exact
    tier counts everything as float64, and more of it."""
    cs = _chip_smoke()
    ks, s, c, _, _ = _inputs()
    s, c = s.reshape(-1), c.reshape(-1)
    n_el = s.numel() * ks.numel()
    fast = cs.nfw_ops(ks, s, c, "fast")
    exact = cs.nfw_ops(ks, s, c, "exact")
    assert set(fast) == {"f32", "f64"} and set(exact) == {"f64"}
    # x, x2 and per sin/cos an FMA, a subtraction and an FMA (an FMA
    # counts 2)
    assert fast["f64"] == (2 + 2 * 5) * n_el + cs.ROW_OPS_F64 * s.numel()
    assert exact["f64"] > fast["f64"] + fast["f32"]


def test_domain_edges_case_hits_every_edge_in_one_warp():
    """chip_smoke's domain_edges case puts x and x2 = (1+c) x on 4, 10 and
    40, and 1 ulp to either side in float32 and in float64, all inside one
    32-wide warp of k per edge."""
    cs = _chip_smoke()
    ks, scales, cs_ = cs.domain_edges()
    assert ks.size % 32 == 0 and np.all(np.diff(ks) > 0)
    x = ks[None, :] * scales[:, None]
    x2 = ks[None, :] * ((1.0 + cs_) * scales)[:, None]
    for e in (4.0, 10.0, 40.0):
        f = np.float32(e)
        for v in (x, x2):
            hit = np.zeros(v.shape, bool)
            for want in (e, np.nextafter(e, 0.0), np.nextafter(e, np.inf)):
                assert np.count_nonzero(v == want) >= 1
                hit |= v == want
            for want in (np.nextafter(f, np.float32(0)),
                         np.nextafter(f, np.float32(np.inf))):
                assert np.count_nonzero(v.astype(np.float32) == want) >= 1
            # each row's hits of this edge lie in one warp
            for row in hit:
                assert len(set(np.flatnonzero(row) // 32)) <= 1


def test_sass_counts_splits_body_and_cold_subroutines():
    """chip_smoke's SASS counter: instructions by class per kernel; the
    subroutines reached by CALL (from the first CALL target on) count as
    cold; NOPs and the trap loop (a BRA to itself) are not counted."""
    text = """
        Function : _ZN12_GLOBAL__N_113nfw_uk_kernelIfEEvPKdS2_S2_PT_ii
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
        /*0010*/              @!P0 FFMA R2, R3, c[0x3][0x10], R4 ;
        /*0020*/                   DFMA R2, R4, R6, R8 ;
        /*0030*/              @P6 BRA 0x50 ;
        /*0040*/                   CALL.REL.NOINC 0x90 ;
        /*0050*/                   MUFU.RCP R5, R4 ;
        /*0060*/                   IMAD.MOV.U32 R5, RZ, RZ, R4 ;
        /*0070*/                   EXIT ;
        /*0080*/                   NOP;
        /*0090*/                   DMUL R4, R4, R6 ;
        /*00a0*/                   RET.REL.NODEC R10 0x0 ;
        /*00b0*/                   BRA 0xb0;
        Function : _ZN12_GLOBAL__N_119nfw_contract_kernelEPKdS1_S1_S1_S1_PdS2_ii
        /*0000*/                   STG.E.64 desc[UR4][R2.64], R4 ;
        /*0010*/                   EXIT ;
        /*0020*/                   BRA 0x20;
"""
    got = _chip_smoke().sass_counts(text)
    assert set(got) == {"nfw_uk_kernel<float>", "nfw_contract_kernel"}
    uk = got["nfw_uk_kernel<float>"]
    assert dict(uk["body"]) == {"memory": 1, "fp32": 1, "fp64": 1,
                                "control": 3, "mufu": 1, "int": 1}
    assert dict(uk["cold"]) == {"fp64": 1, "control": 1}
    contract = got["nfw_contract_kernel"]
    assert dict(contract["body"]) == {"memory": 1, "control": 1}
    assert not contract["cold"]


EMULATED_CASES = ("config1", "adversarial", "phase3.7e4", "phase3.7e7",
                  "edges", "domain_edges")


@pytest.mark.parametrize("case", EMULATED_CASES)
def test_exact_tier_emulation_within_budget(case):
    """The float64 kernel's arithmetic, repeated in numpy (two-part pi/2
    reduction, sin/cos polynomials, seeded Newton reciprocal, each series
    cut at its table's noise floor), stays within 1e-12 on u of the plain
    version and of a u assembled from scipy's sici, at the config-1 inputs
    and on every adversarial case that the card run checks."""
    em = _emulator()
    if case == "config1":
        ks, scales, cs, _, _ = em.config1_inputs()
        rows = ks, scales.reshape(-1), cs.reshape(-1)
    else:
        rows = {name: arrays for name, *arrays in em.adversarial_cases()}[case]
    err = em.exact_errors(*rows)
    assert err["vs_plain"] <= em.EXACT_BUDGET
    assert err["vs_scipy"] <= em.EXACT_BUDGET
    assert err["sincos"] <= 2.5e-16


def test_exact_tier_emulation_parts():
    """sin/cos of the reduction stay at float64 rounding far beyond the
    pipeline's phases; the reciprocal is good to an ulp over the whole
    range of x; and the log branch holds about a tenth of config 1."""
    em = _emulator()
    rng = np.random.default_rng(11)
    for top in (1e2, 1e5, 1e9, 1e12):
        x = rng.uniform(0.0, top, 50_000)
        s, c = em.sincos_phase_f64(x)
        assert np.abs(s - np.sin(x)).max() <= 2.5e-16
        assert np.abs(c - np.cos(x)).max() <= 2.5e-16
    x = np.exp(rng.uniform(np.log(1e-300), np.log(1e300), 50_000))
    assert np.abs(em.rcp_newton(x) * x - 1.0).max() <= 2.5e-16
    x = np.array([[1.0, 3.0, 5.0] + [9.0] * 30])
    el, warps = em.log_branch_share(x, 2.0 * x)
    assert el == 1.0 / 33.0 and warps == 0.5


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    """Each CUDA kernel against its plain version on the card, on the
    sweeps above, the Si/Ci domain edges (chip_smoke.domain_edges) and at
    the config-1 shape (4,000 rows x 1,001 k): exact <= 2e-7 and fast
    <= 5e-6 absolute on u; the exact tier, float64 throughout, is also
    held to the 1e-12 it is designed to, up to phases of 3.7e7
    (chip_smoke.adversarial_rows).  The contraction computes u in float32, as the
    TPU kernel it ports does, and sums in float64: <= 2e-5 relative on S1
    and S2 (that kernel's own gate), and the same bits on a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    cases = [(_t(ks, dev), *(_t(v, dev) for v in _rows(zs, cs, rss)))
             for _, zs, cs, rss, ks in SWEEPS]
    cases.append(tuple(_t(v, dev) for v in _chip_smoke().domain_edges()))
    cases += [row[1:] for row in _chip_smoke().adversarial_rows(dev)
              if row[0].startswith("phase")]
    cases.append((_t(np.geomspace(1e-4, 100, 1001), dev),
                  _t(rng.uniform(0.003, 12.0, 4000), dev),
                  _t(rng.uniform(1.2, 30.0, 4000), dev)))
    for ks, scales, cs in cases:
        ref = nk.nfw_uk_plain(ks, scales, cs)
        for wrapper, gate in ((nk.nfw_uk_exact, 2e-7), (nk.nfw_uk_fast, 5e-6)):
            n0 = wrapper.launches
            u = wrapper(ks, scales, cs)
            torch.cuda.synchronize()
            assert u.is_cuda and wrapper.launches == n0 + 1
            err = (u.double() - ref).abs().max().item()
            assert err <= gate
            if wrapper is nk.nfw_uk_exact:
                assert err <= 1e-12
    ks = _t(np.geomspace(1e-4, 100, 1001), dev)
    shape = (20, 200)
    s, c = _t(rng.uniform(0.003, 12.0, shape), dev), \
        _t(rng.uniform(1.2, 30.0, shape), dev)
    a, b = _t(rng.lognormal(0, 2, shape), dev), _t(rng.lognormal(0, 2, shape), dev)
    n0 = nk.nfw_contract.launches
    got = nk.nfw_contract(ks, s, c, a, b)
    torch.cuda.synchronize()
    assert nk.nfw_contract.launches == n0 + 1
    for x, y in zip(got, nk.nfw_contract_plain(ks, s, c, a, b)):
        assert ((x - y).abs() / y.abs()).max().item() <= 2e-5
    again = nk.nfw_contract(ks, s, c, a, b)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
