"""PyTorch port, the map-level group: every function of
models/flatsky.py against the JAX package on the CPU at n = 64-96, with
spectra made by numpy from a seed.  Synthesis is fed the JAX package's own
draws: the test makes them with ``jax.random.split`` / ``normal`` from the
key the JAX function takes, and hands them to the port's private
from-noise functions.  The JAX side runs under one ``jax.jit`` per set of
inputs.  Both sides are complex128 FFTs with the same algorithm: 1e-12 of
each array's largest value; bin counts equal.  The Monte-Carlo response
checks are the JAX suite's (tests/test_flatsky.py) and are not repeated.

The card test (``-m gpu``) holds the module on the card against the same
calls on CPU tensors:

    python -m pytest --noconftest -m gpu tests/test_torch_flatsky.py
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from hmvec_tpu.models import flatsky as jfs
    from _torch_jax import Prefetch
except ImportError:    # a machine with the card and no JAX: the tests
    jnp = None         # marked gpu need none of it (run them with -m gpu)

import hmvec_tpu_torch
from hmvec_tpu_torch.models import flatsky as tfs

N, PIX = 64, 3.0                  # l_Nyquist 3,600, |l| up to 5,091
N2 = 96                           # a second grid size
GATE = 1e-12
RNG = np.random.default_rng(131)
T = torch.as_tensor


def _spec(lmax, amp, scale, wiggle):
    """A smooth positive spectrum on l = 0..lmax with a seeded wiggle."""
    l = np.arange(lmax + 1, dtype=np.float64)
    c = amp * np.exp(-(l / scale) ** 2) / (l + 30.0) ** 2 \
        * (1.0 + 0.3 * np.sin(l / 40.0 + wiggle))
    c[:2] = 0.0
    return c


# tables end below the grid's largest |l|, so C = 0 beyond (right=0.0)
CL_TT = _spec(4000, 3e3, 2500.0, RNG.uniform(0, 6))
CL_EE = _spec(4000, 60.0, 2200.0, RNG.uniform(0, 6))
CL_BB = _spec(4000, 4.0, 1500.0, RNG.uniform(0, 6))
CL_TE = 0.5 * np.sqrt(CL_TT * CL_EE) * np.cos(np.arange(4001) / 70.0)
# a Planck-like C_phiphi (examples/lensing_qe_sim.py): ~2.5' deflections
_LP = np.arange(3001, dtype=np.float64)
CL_PP = 2.0 * np.pi * (1.5e-7 * (np.maximum(_LP, 1.0) / 50.0)
                       / (1.0 + (np.maximum(_LP, 1.0) / 50.0) ** 3.2) ** 0.8) \
    / (np.maximum(_LP, 1.0) * (_LP + 1.0)) ** 2
CL_PP[:2] = 0.0
NL = np.full(4001, 2e-4)
N0 = 1e-7 * (1.0 + np.arange(3001) / 500.0) ** 2     # L = 0..3000
EDGES = np.linspace(100.0, 4000.0, 9)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    # ROADMAP C14: a thread's first MKL vector-math call once came out at
    # low accuracy; each one is made here, on both threads, and discarded
    x = torch.linspace(0.1, 10.0, 1 << 14, dtype=torch.float64)
    for f in (torch.sin, torch.cos, torch.exp, torch.log, torch.sqrt,
              torch.tanh):
        f(x)
    yield
    torch.set_num_threads(old)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _to_max(got, want):
    """Max abs difference over the largest |want|."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _draws(key, k):
    """The JAX package's k normal draws of a split key, as its synthesis
    makes them (k = 1: the key itself)."""
    keys = [key] if k == 1 else jax.random.split(key, k)
    return [jax.random.normal(kk, (N, N)) for kk in keys]


# ---- the grid and the spectra on it -------------------------------------------

GRIDS = ((N, PIX), (N2, 1.5), (65, 2.0))


def _bin_edges(lx, lmod):
    """Edges on grid |l| values (a right-sided search counts those modes
    in the bin above), and EDGES."""
    lx = np.asarray(lx).ravel()
    return (np.concatenate([[0.0], np.sort(np.abs(lx[[2, 5, 9, 14]])),
                            [float(np.max(lmod)) + 1.0]]), EDGES)


def _jax_grids():
    """For each grid: the JAX package's grid, spectra on it, spin-2
    phases, its right-sided bin index of each set of edges and the binned
    power of unit fields; one compiled program."""
    edges = {}
    for n, pix in GRIDS:
        f = np.fft.fftfreq(n, d=pix * np.pi / 10800.0) * 2.0 * np.pi
        edges[n] = _bin_edges(f, np.sqrt(f[None, :] ** 2 + f[:, None] ** 2))

    def body():
        out = {}
        for n, pix in GRIDS:
            grid = jfs.fourier_grid(n, pix)
            ones = jnp.ones((n, n), jnp.complex128)
            out[n] = {"grid": grid,
                      "cl": [jfs._cl_on_grid(cl, grid[2])
                             for cl in (CL_TT, CL_PP, N0)],
                      "spin2": jfs._spin2_phases(n, pix),
                      "idx": [jnp.digitize(grid[2].ravel(), e) - 1
                              for e in edges[n]],
                      "power": [jfs.fourier_power(ones, ones, pix, e)
                                for e in edges[n]]}
        return out

    return edges, jax.jit(body)()


def test_fourier_grid_and_cl_on_grid_match_jax(jax_grids):
    for n, pix in GRIDS:
        want = jax_grids[1][n]
        got = tfs.fourier_grid(n, pix, device="cpu")
        assert all(g.device.type == "cpu" for g in got)
        # lx, ly equal (numpy's fftfreq on both sides); |l| within an ulp
        assert np.array_equal(_np(got[0]), np.asarray(want["grid"][0]))
        assert np.array_equal(_np(got[1]), np.asarray(want["grid"][1]))
        assert _to_max(got[2], want["grid"][2]) <= GATE
        for cl, w in zip((CL_TT, CL_PP, N0), want["cl"]):
            assert _to_max(tfs._cl_on_grid(cl, got[2]), w) <= GATE
        for g, w in zip(tfs._spin2_phases(n, pix, "cpu"), want["spin2"]):
            assert _to_max(g, w) <= GATE


def test_bin_counts_equal_jax_digitize(jax_grids):
    """The annuli are a right-sided search (jnp.digitize): edges placed on
    grid |l| values count those modes in the bin above."""
    edges, want = jax_grids
    for n, pix in GRIDS:
        for e, idx, (jm, jc) in zip(edges[n], want[n]["idx"],
                                    want[n]["power"]):
            idx = np.asarray(idx)
            counts = np.bincount(idx[(idx >= 0) & (idx < e.size - 1)],
                                 minlength=e.size - 1)
            got = tfs._bin_counts(n, pix, e, device="cpu")
            assert np.array_equal(_np(got), counts.astype(float)), (n, e)
            ones = torch.ones((n, n), dtype=torch.complex128)
            mids, chat = tfs.fourier_power(ones, ones, pix, e)
            assert np.array_equal(_np(mids), np.asarray(jm))
            assert _to_max(chat, jc) <= GATE


def test_fourier_grid_runs_on_the_card_for_host_data():
    """Given host data alone, the map functions run on the card (on a
    machine without one, making the first tensor fails); a tensor's own
    device wins."""
    if torch.cuda.is_available():
        assert tfs.fourier_grid(N, PIX)[2].is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tfs.fourier_grid(N, PIX)
        with pytest.raises((RuntimeError, AssertionError)):
            tfs.map_power(np.zeros((N, N)), np.zeros((N, N)), PIX, EDGES)
    t = T(RNG.standard_normal((N, N)))
    assert not tfs.map_power(t, t, PIX, EDGES)[1].is_cuda


# ---- synthesis, fed the JAX package's draws ---------------------------------

def _jax_synth():
    key = jax.random.PRNGKey(17)

    @jax.jit
    def jax_side(key):
        return {"draws": [_draws(key, k) for k in (1, 2, 3)],
                "t": jfs.synth_gaussian(key, N, PIX, CL_TT),
                "qu": jfs.synth_pol(key, N, PIX, CL_EE),
                "qu_b": jfs.synth_pol(key, N, PIX, CL_EE, CL_BB),
                "tqu": jfs.synth_tqu(key, N, PIX, CL_TT, CL_EE, CL_TE),
                "tqu_b": jfs.synth_tqu(key, N, PIX, CL_TT, CL_EE, CL_TE,
                                       CL_BB)}

    return key, jax_side(key)


def test_synthesis_matches_jax_on_its_draws(synth):
    _, want = synth
    (w,), (we, wb), (w1, w2, w3) = [[np.array(x) for x in d]
                                    for d in want["draws"]]
    assert _to_max(tfs._synth_from_noise(T(w), PIX, CL_TT), want["t"]) \
        <= GATE
    for k, bb in (("qu", None), ("qu_b", CL_BB)):
        got = tfs._synth_pol_from_noise(T(we), T(wb), PIX, CL_EE, bb)
        for g, w_ in zip(got, want[k]):
            assert _to_max(g, w_) <= GATE, k
    for k, bb in (("tqu", None), ("tqu_b", CL_BB)):
        got = tfs._synth_tqu_from_noise(T(w1), T(w2), T(w3), PIX, CL_TT,
                                        CL_EE, CL_TE, bb)
        for g, w_ in zip(got, want[k]):
            assert _to_max(g, w_) <= GATE, k


def test_synthesis_draws_from_its_generator():
    """The public synthesis: draws from the given generator on its device,
    the same map for the same seed, the from-noise map of its draws."""
    gen = lambda: torch.Generator().manual_seed(5)
    t = tfs.synth_gaussian(gen(), N, PIX, CL_TT)
    assert t.device.type == "cpu" and t.shape == (N, N)
    assert torch.equal(t, tfs.synth_gaussian(gen(), N, PIX, CL_TT))
    w = torch.randn((N, N), generator=gen(), dtype=torch.float64)
    assert torch.equal(t, tfs._synth_from_noise(w, PIX, CL_TT))
    q, u = tfs.synth_pol(gen(), N, PIX, CL_EE, CL_BB)
    g = gen()
    we = torch.randn((N, N), generator=g, dtype=torch.float64)
    wb = torch.randn((N, N), generator=g, dtype=torch.float64)
    want = tfs._synth_pol_from_noise(we, wb, PIX, CL_EE, CL_BB)
    assert torch.equal(q, want[0]) and torch.equal(u, want[1])
    tqu = tfs.synth_tqu(gen(), N, PIX, CL_TT, CL_EE, CL_TE, device="cpu")
    g = gen()
    ws = [torch.randn((N, N), generator=g, dtype=torch.float64)
          for _ in range(2)]
    want = tfs._synth_tqu_from_noise(*ws, None, PIX, CL_TT, CL_EE, CL_TE)
    assert all(torch.equal(a, b) for a, b in zip(tqu, want))


# ---- maps, binned power, lensing, the estimators ----------------------------

def _maps():
    """Seeded maps: T, Q, U and phi (the JAX package's synthesis of
    C_phiphi), keyed by their grid size."""
    out = {}
    for n, pix in ((N, PIX),):
        r = np.random.default_rng(n)
        out[n] = {"t": r.standard_normal((n, n)) * 80.0,
                  "q": r.standard_normal((n, n)) * 5.0,
                  "u": r.standard_normal((n, n)) * 5.0,
                  "phi": np.asarray(jax.jit(
                      lambda k: jfs.synth_gaussian(k, n, pix, CL_PP))(
                          jax.random.PRNGKey(n))),
                  "pix": pix}
    return out


def _calls(m, d):
    """Every map function of module m on the maps d, in one dict."""
    pix = d["pix"]
    t, q, u, phi = d["t"], d["q"], d["u"], d["phi"]
    out = {"power_tt": m.map_power(t, t, pix, EDGES),
           "power_tq": m.map_power(t, q, pix, EDGES),
           "first_order": m.lens_map_first_order(t, phi, pix),
           "lens_o1": m.lens_map(t, phi, pix, oversample=1),
           "lens_o2": m.lens_map(t, phi, pix),
           "lens_o3": m.lens_map(t, 3.0 * phi, pix, oversample=3),
           "qe_tt": m.qe_tt(t, pix, CL_TT, CL_TT + NL, N0),
           "qe_tt_band": m.qe_tt(t, pix, CL_TT, CL_TT + NL, N0[:1500],
                                 lmin=200, lmax=2500),
           "eb": m.eb_from_qu(q, u, pix),
           "qe_ee": m.qe_ee(q, u, pix, CL_EE, CL_EE + NL, N0),
           "qe_te": m.qe_te(t, q, u, pix, CL_TE, CL_TT + NL, CL_EE + NL,
                            N0, lmin=50, lmax=3500),
           "qe_eb": m.qe_eb(q, u, pix, CL_EE, CL_EE + NL, CL_BB + NL, N0)}
    return out


def _maps_and_jax_maps():
    maps = _maps()
    out = {}
    for n, d in maps.items():
        pix = d["pix"]
        arrays = {k: v for k, v in d.items() if k != "pix"}

        def body(a, pix=pix):
            res = _calls(jfs, {**a, "pix": pix})
            tk = jnp.fft.fft2(a["t"])
            res["fourier_power"] = jfs.fourier_power(tk, jnp.fft.fft2(
                a["q"]), pix, EDGES)
            res["fft_pad"] = jfs._fft_pad(tk, 2)
            res["grad"] = jfs._grad_maps(tk, *jfs.fourier_grid(n, pix)[:2])
            return res

        out[n] = jax.jit(body)(arrays)
    return maps, out


@pytest.fixture(autouse=True, scope="module")
def _jax_refs():
    """The file's JAX references, three compiled programs, computed by
    two worker threads from the module's start, beside each other and the
    torch side (``_torch_jax.Prefetch``)."""
    if jnp is None:      # the card test needs no JAX
        yield None
        return
    pre = Prefetch()
    yield {"grids": pre.submit(_jax_grids), "synth": pre.submit(_jax_synth),
           "maps": pre.submit(_maps_and_jax_maps)}
    pre.close()


@pytest.fixture(scope="module")
def jax_grids(_jax_refs):
    return _jax_refs["grids"].result()


@pytest.fixture(scope="module")
def synth(_jax_refs):
    return _jax_refs["synth"].result()


@pytest.fixture(scope="module")
def maps(_jax_refs):
    return _jax_refs["maps"].result()[0]


@pytest.fixture(scope="module")
def jax_maps(_jax_refs):
    return _jax_refs["maps"].result()[1]


def _flat(res):
    """(name, array) of every array of a result dict, tuples unpacked."""
    for k, v in res.items():
        if isinstance(v, (tuple, list)):
            for i, x in enumerate(v):
                yield f"{k}[{i}]", x
        else:
            yield k, v


def test_map_functions_match_jax(maps, jax_maps):
    for n, d in maps.items():
        pix = d["pix"]
        td = {k: (T(v) if k != "pix" else v) for k, v in d.items()}
        got = _calls(tfs, td)
        tk = torch.fft.fft2(td["t"])
        got["fourier_power"] = tfs.fourier_power(tk, torch.fft.fft2(td["q"]),
                                                 pix, EDGES)
        got["fft_pad"] = tfs._fft_pad(tk, 2)
        got["grad"] = tfs._grad_maps(tk, *tfs.fourier_grid(
            n, pix, device="cpu")[:2])
        want = dict(_flat(jax_maps[n]))
        for k, g in _flat(got):
            assert g.device.type == "cpu", k
            e = _to_max(g, want[k])
            assert e <= GATE, (n, k, e)


def test_a_batch_equals_its_maps_one_at_a_time(maps):
    """Leading batch dimensions: a (3, n, n) batch through each function
    equals its maps one by one (1e-12 of the largest value), and an
    unbatched map broadcasts against a batched one."""
    d = maps[N]
    r = np.random.default_rng(3)
    tb = T(r.standard_normal((3, N, N)) * 80.0)
    qb = T(r.standard_normal((3, N, N)) * 5.0)
    ub = T(r.standard_normal((3, N, N)) * 5.0)
    phib = T(np.stack([d["phi"], 2.0 * d["phi"], -d["phi"]]))
    batched = {
        "lens": lambda t, q, u, p: tfs.lens_map(t, p, PIX),
        "first": lambda t, q, u, p: tfs.lens_map_first_order(t, p, PIX),
        "qe_tt": lambda t, q, u, p: tfs.qe_tt(t, PIX, CL_TT, CL_TT + NL,
                                              N0),
        "qe_te": lambda t, q, u, p: tfs.qe_te(t, q, u, PIX, CL_TE,
                                              CL_TT + NL, CL_EE + NL, N0),
        "qe_eb": lambda t, q, u, p: tfs.qe_eb(q, u, PIX, CL_EE, CL_EE + NL,
                                              CL_BB + NL, N0),
        "power": lambda t, q, u, p: tfs.map_power(t, q, PIX, EDGES)[1],
        "synth": lambda t, q, u, p: tfs._synth_tqu_from_noise(
            t, q, u, PIX, CL_TT, CL_EE, CL_TE, CL_BB)[2],
    }
    for k, fn in batched.items():
        whole = fn(tb, qb, ub, phib)
        for i in range(3):
            assert _to_max(whole[i], fn(tb[i], qb[i], ub[i], phib[i])) \
                <= GATE, (k, i)
    # one map, three deflection fields
    whole = tfs.lens_map(tb[0], phib, PIX)
    for i in range(3):
        assert _to_max(whole[i], tfs.lens_map(tb[0], phib[i], PIX)) <= GATE


# ---- on the card ---------------------------------------------------------------

@pytest.mark.gpu
def test_flatsky_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = np.random.default_rng(7)
    cpu = {"t": T(r.standard_normal((2, N, N)) * 80.0),
           "q": T(r.standard_normal((2, N, N)) * 5.0),
           "u": T(r.standard_normal((2, N, N)) * 5.0), "pix": PIX}
    w = T(r.standard_normal((N, N)))
    cpu["phi"] = tfs._synth_from_noise(w, PIX, CL_PP)
    gpu = {k: (v.cuda() if isinstance(v, torch.Tensor) else v)
           for k, v in cpu.items()}
    got, want = dict(_flat(_calls(tfs, gpu))), dict(_flat(_calls(tfs, cpu)))
    for k, g in got.items():
        assert g.is_cuda and _to_max(g.cpu(), want[k]) <= GATE, k
    gen = torch.Generator(device="cuda").manual_seed(3)
    tq = tfs.synth_tqu(gen, N, PIX, CL_TT, CL_EE, CL_TE, CL_BB)
    gen = torch.Generator(device="cuda").manual_seed(3)
    ws = [torch.randn((N, N), generator=gen, dtype=torch.float64,
                      device="cuda") for _ in range(3)]
    want = tfs._synth_tqu_from_noise(*[x.cpu() for x in ws], PIX, CL_TT,
                                     CL_EE, CL_TE, CL_BB)
    for g, w_ in zip(tq, want):
        assert g.is_cuda and _to_max(g.cpu(), w_) <= GATE
    assert hmvec_tpu_torch.flatsky.fourier_grid(N, PIX)[2].is_cuda
