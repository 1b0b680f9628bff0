"""PyTorch port, the Boltzmann group's solve and the "boltz" engine on the
CPU (the kernels' plain versions), against the JAX package.

* The solve against a JAX golden file
  (hmvec_tpu_torch/data/boltz_small_golden.npz, written by ``python
  tools/gen_torch_golden.py --config boltz_small``): solve_perturbations on
  6 k in [1e-4, 0.1]/Mpc at n_a 300, n_b 210 x 4, n_c 120 x 11 (~3,200
  RK4 steps with the curvature mode) on a recombination table of 4,096
  rows, massless and with the massive-nu fluid at mnu = 0.06,
  compute_sources and matter_power_slices on it.
  The ``slow``-marked test regenerates those numbers with JAX in a
  process of its own, so the file cannot go stale unseen.
* The refusal of a non-finite slice (ROADMAP C3): the JAX package returns
  P(k, z) through recombination where ln|Delta_m| has non-finite nodes;
  the port raises.
* BoltzEngine serving, live against the JAX package: both packages'
  _TABLE_CACHE seeded with the golden slices (module state; no JAX code
  changes), both engines built without a solve, plin / pzk_grid with
  closed and ode growth, z-resolved and not, EH99 at mnu > 0, the fluid
  table, the shape_response term, the Jacobian over (omch2, ombh2, H0,
  As) by torch.func.jacfwd against jax.jacfwd, make_engine("boltz", ...),
  Cosmology(engine="boltz") and a small HaloModel on the engine against
  the JAX class on its tables (``_torch_jax.jax_halo_model_of``).

Gates.  Serving: 1e-10 element by element (``_close``); the Jacobian
1e-6.  The solve: 1e-6 of each state vector's largest component, and
1e-6 on the sources and slices by the same rule, measured 2.4e-8
(massless) and 3.3e-7 (fluid).  1e-10 is out of reach for any two
evaluation orders: the tight-coupling era amplifies rounding, a 1e-15
relative change of the initial state grows to ~1e-8 by the end of
segment A (``test_the_solve_amplifies_rounding`` measures it), and the
JAX package's own segment-by-segment and whole-solve programs differ by
as much.  zeta_unit, read after the amplified era decays, stays at
1e-10.
"""

import pathlib

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from hmvec_tpu.models import background as jbg
    from hmvec_tpu.models import boltz_engine as jbe
    from hmvec_tpu.models import cosmology as jcos
    from hmvec_tpu.params import merge_params as jmerge
    from _torch_jax import JaxSubprocess, Prefetch, jax_halo_model_of
except ImportError:
    jnp = None

from hmvec_tpu_torch.models import background as tbg
from hmvec_tpu_torch.models import boltz_engine as tbe
from hmvec_tpu_torch.models import boltzlite as tbl
from hmvec_tpu_torch.models import cosmology as tcos
from hmvec_tpu_torch.models import halo_model as thm
from hmvec_tpu_torch.models import linear_power as tlp
from hmvec_tpu_torch.models import recomb as trec
from hmvec_tpu_torch.ops import boltz_kernels as bk
from hmvec_tpu_torch.params import merge_params as tmerge

GOLDEN = (pathlib.Path(__file__).resolve().parents[1] / "hmvec_tpu_torch"
          / "data" / "boltz_small_golden.npz")
G = dict(np.load(GOLDEN))
GRID = dict(zip(G["grid_names"].tolist(), map(int, G["grid_values"])))
KS = G["ks"]
Z_SLICES = tuple(float(z) for z in G["z_slices"])
COSMOS = {"massless": {}, "fluid": {"mnu": 0.06}}
GATE = 1e-10
SOLVE_GATE = 1e-6
JAC_GATE = 1e-6
# the engine on the golden grid: the graft below its largest k
SOLVER_OPTS = {k: v for k, v in GRID.items() if k != "n_c_inner"}
ENGINE_OPTS = {"ks": KS, "k_graft": 0.1, "n_c_inner": GRID["n_c_inner"],
               "solver_opts": SOLVER_OPTS}
# the engines served: (params, massive_nu, component, golden slices)
ENGINES = {"eh99": ({}, "eh99", "total", "massless_slices"),
           "eh99_mnu": ({"mnu": 0.06}, "eh99", "total", "eh99_slices"),
           "fluid": ({"mnu": 0.06}, "fluid", "total", "fluid_slices"),
           "fluid_cb": ({"mnu": 0.06}, "fluid", "cb", "fluid_slices_cb")}
SERVE_ZS = np.array([0.0, 0.3, 1.5, 7.0, 25.0])
SERVE_KS = np.geomspace(1e-5, 50.0, 120)
JAC_NAMES = ("omch2", "ombh2", "H0", "As")


def T(v):
    return torch.as_tensor(v, dtype=torch.float64)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    x = torch.linspace(0.1, 10.0, 1 << 14, dtype=torch.float64)
    for f in (torch.sin, torch.cos, torch.exp, torch.log, torch.sqrt,
              torch.tanh, torch.log1p):
        f(x)
    yield
    torch.set_num_threads(old)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want):
    """Max error along the last axis, row by row: relative element by
    element on a row of one sign without zeros, else relative to the
    row's largest |want|."""
    got, want = _np(got).astype(float), np.asarray(want, dtype=float)
    assert got.shape == want.shape, (got.shape, want.shape)
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    err = np.abs(got - want)
    one_sign = np.all(want > 0.0, -1) | np.all(want < 0.0, -1)
    row_max = np.max(np.abs(want), -1)
    scale = np.where(one_sign[..., None], np.abs(want),
                     np.where(row_max > 0.0, row_max, 1.0)[..., None])
    return float(np.max(err / scale))


# ---- the port's solves -----------------------------------------------------

@pytest.fixture(scope="module")
def solved():
    """(ctx, solution, sources, recombination) of each cosmology, the
    plain versions."""
    out = {}
    before = (bk.recomb_rk4.launches, bk.hierarchy_rk4.launches)
    for name, p in COSMOS.items():
        bg = tbg.background(tmerge(p), "cpu")
        rec = trec.recombination(bg, n=int(G["n_rec"]),
                                 massive_nu=name == "fluid")
        ctx = tbl.make_ctx(bg, rec, massive_nu=True)
        sol = tbl.solve_perturbations(ctx, KS, **GRID)
        out[name] = (ctx, sol, tbl.compute_sources(ctx, sol), rec)
    assert (bk.recomb_rk4.launches, bk.hierarchy_rk4.launches) == before
    return out


@pytest.mark.parametrize("name", sorted(COSMOS))
def test_solve_matches_jax_golden(name, solved):
    _, sol, src, _ = solved[name]
    assert _close(sol.xs, G[f"{name}_xs"]) <= 1e-14
    assert sol.states.shape == (KS.size, sol.xs.numel(), bk.NSTATE)
    assert bool(torch.isfinite(sol.states).all())
    assert _close(sol.states[:, ::3], G[f"{name}_states_every3"]) \
        <= SOLVE_GATE
    assert abs(float(sol.zeta_unit) / float(G[f"{name}_zeta_unit"]) - 1.0) \
        <= GATE
    for key in ("s_t", "s_e", "s_p"):
        assert _close(getattr(src, key), G[f"{name}_{key}"]) <= SOLVE_GATE
    assert _close(src.chi, G[f"{name}_chi"]) <= 1e-12
    assert abs(float(src.chi_star) / float(G[f"{name}_chi_star"]) - 1.0) \
        <= 1e-12


def test_the_solve_amplifies_rounding(solved):
    """The conditioning that sets SOLVE_GATE: a 1e-15 relative change of
    the initial state grows by more than 1e7 through segment A (measured
    3.2e7: to 3.2e-8 of a row's largest value)."""
    ctx = solved["massless"][0]
    ks = T(KS)
    s0 = tbl._initial_state(ctx, ks, T(-18.0))
    bump = 1.0 + 1e-15 * T(np.random.default_rng(3).standard_normal(
        s0.shape))
    dx = (-9.2 + 18.0) / GRID["n_a"]
    a, _, _ = tbl._segment(ctx, ks, s0, -18.0, dx, 30, GRID["n_a"] // 30,
                           False)
    b, _, _ = tbl._segment(ctx, ks, s0 * bump, -18.0, dx, 30,
                           GRID["n_a"] // 30, False)
    growth = float(((a - b).abs().amax(1) / a.abs().amax(1)).max()) / 1e-15
    assert growth > 1e7, growth


@pytest.mark.parametrize("which", ["massless", "fluid", "fluid_cb"])
def test_matter_power_slices_matches_jax_golden(which, solved,
                                                monkeypatch):
    """matter_power_slices on the fixture's solve (the recombination and
    the solve are the ones above, handed back by stand-ins that check
    their arguments)."""
    name = "massless" if which == "massless" else "fluid"
    ctx, sol, _, rec = solved[name]

    def recombination(bg, zre, massive_nu):
        assert zre == 7.7 and massive_nu == (name == "fluid")
        return rec

    def solve(ctx_, ks, **kw):
        assert kw == GRID and np.array_equal(np.asarray(ks), KS)
        assert torch.equal(ctx_.tau_t, ctx.tau_t)
        return sol

    monkeypatch.setattr(tbe, "recombination", recombination)
    monkeypatch.setattr(tbl, "solve_perturbations", solve)
    ks, pzk = tbe.matter_power_slices(
        COSMOS[name], ks=KS, zs=Z_SLICES, n_c_inner=GRID["n_c_inner"],
        solver_opts=SOLVER_OPTS, massive_nu=name == "fluid",
        component="cb" if which == "fluid_cb" else "total", device="cpu")
    assert np.array_equal(ks, KS) and pzk.device.type == "cpu"
    key = {"massless": "massless_slices", "fluid": "fluid_slices",
           "fluid_cb": "fluid_slices_cb"}[which]
    assert _close(pzk, G[key]) <= SOLVE_GATE
    if which == "massless":
        _, p0 = tbe.matter_power_z0(
            {}, ks=KS, n_c_inner=GRID["n_c_inner"], solver_opts=SOLVER_OPTS,
            device="cpu")
        assert torch.equal(p0, pzk[0])


def test_slices_through_recombination_are_refused(solved):
    """ROADMAP C3: through recombination the matter contrast oscillates
    through zero, ln|Delta_m| is no interpolant there and the JAX package
    returns whatever comes out (non-finite on a node where Delta_m is
    0); the port raises ValueError for every slice whose bracket of
    stored nodes holds a sign change or that is not finite.  A z earlier
    than the stored trajectory raises as in the JAX package."""
    ctx, sol, _, _ = solved["massless"]
    late = tbe.slices_from_solution(ctx, sol, (0.0, 20.0))
    assert bool(torch.isfinite(late).all())
    # on this grid the contrast of the largest modes changes sign at
    # z ~ 500 (k = 1e-4) and z ~ 9,000 (k = 4e-4)
    hp = tbl._hp(ctx, sol.xs)
    gau = 3.0 * hp[None, :] / sol.ks[:, None]
    st = sol.states
    dm = ctx.omc * (st[..., tbl.I_DC] - gau * st[..., tbl.I_VC]) \
        + ctx.omb * (st[..., tbl.I_DB] - gau * st[..., tbl.I_VB])
    rows, cols = torch.nonzero(dm[:, :-1] * dm[:, 1:] <= 0.0, as_tuple=True)
    assert rows.numel() >= 2
    for c in cols.tolist():
        z_mid = float(np.expm1(-0.5 * float(sol.xs[c] + sol.xs[c + 1])))
        with pytest.raises(ValueError, match="across a zero"):
            tbe.slices_from_solution(ctx, sol, (0.0, z_mid))
    # a node where Delta_m is exactly 0: non-finite in the JAX package
    states = sol.states.clone()
    states[2, 150, tbl.I_DC] = states[2, 150, tbl.I_DB] = 0.0
    states[2, 150, tbl.I_VC] = states[2, 150, tbl.I_VB] = 0.0
    z_node = float(np.expm1(-float(sol.xs[150])))
    with pytest.raises(ValueError, match="finite"):
        tbe.slices_from_solution(ctx, sol._replace(states=states),
                                 (z_node,))
    with pytest.raises(ValueError, match="earlier than the stored"):
        tbe.slices_from_solution(ctx, sol, (0.0, 2e4))


@pytest.mark.slow
def test_golden_file_is_what_jax_writes_now(tmp_path):
    """Regenerates boltz_small_golden.npz with JAX (three processes of its
    own, ~2 min) and holds every array to the committed file."""
    script = tmp_path / "regen.py"
    out = tmp_path / "regen.npz"
    repo = pathlib.Path(__file__).resolve().parents[1]
    script.write_text(
        "import sys, numpy as np\n"
        f"sys.path.insert(0, {str(repo / 'tools')!r})\n"
        "import gen_torch_golden as g\n"
        "files = g.write_boltz_golden('boltz_small')\n"
        f"np.savez({str(out)!r}, **files[g.OUT['boltz_small']])\n")
    JaxSubprocess(str(script), timeout=1200).start().wait()
    new = np.load(out)
    assert sorted(new.files) == sorted(G)
    for key in G:
        if G[key].dtype.kind == "f":
            np.testing.assert_allclose(new[key], G[key], rtol=1e-12,
                                       atol=0.0, err_msg=key)
        else:
            assert np.array_equal(new[key], G[key]), key


# ---- the engine -------------------------------------------------------------

ENGINE_NAMES = sorted(ENGINES) + ["shape", "flat_z"]
# the served backgrounds: an As / ns away from the ctor cosmology (the
# exact rescale), w0 / wa for the ode growth, and for the shape-response
# engine a shape away from it (the first-order term)
SERVED = {"closed": {"As": 2.4e-9, "ns": 0.95},
          "ode": {"As": 2.4e-9, "ns": 0.95, "w0": -0.9, "wa": 0.1},
          "shape": {"As": 2.4e-9, "ns": 0.95, "omch2": 0.122,
                    "ombh2": 0.0224, "H0": 68.0}}
HALO = (np.array([0.2, 0.8]), np.geomspace(1e-3, 10.0, 40),
        np.geomspace(1e11, 1e15, 30))


def _seed(module, params, massive_nu, component, slices, z_slices=Z_SLICES):
    """Put the golden slices into ``module``'s table cache under the key
    its BoltzEngine(params, **ENGINE_OPTS) asks for; returns the key."""
    p = (jmerge if module is jbe else tmerge)(params)
    so = tuple(sorted(SOLVER_OPTS.items()))
    key = module._shape_key(p, 0.65, 7.7, GRID["n_c_inner"], KS,
                            massive_nu + ":" + component, z_slices) + (so,)
    module._TABLE_CACHE[key] = (KS, np.asarray(slices, dtype=np.float64),
                                float(p["As"]), float(p["ns"]),
                                float(p["pivot_scalar"]))
    return key


def _shape_variants():
    """The +-h re-solves that shape_response asks for: the massless
    slices times a smooth k-dependent factor of each step's sign (both
    packages read the same numbers; the arithmetic is what is held)."""
    out = []
    for i, (name, h) in enumerate(tbe.SHAPE_STEPS.items()):
        for sgn in (1.0, -1.0):
            tilt = 1.0 + sgn * 0.02 * (i + 1) * np.log(KS / 0.01) / 10.0
            out.append(({name: tbe.merge_params({})[name] + sgn * h},
                        G["massless_slices"] * tilt[None, :] ** 2))
    return out


def _seed_all(module):
    keys = [_seed(module, params, mnu, comp, G[gkey])
            for params, mnu, comp, gkey in ENGINES.values()]
    keys += [_seed(module, params, "eh99", "total", slices)
             for params, slices in _shape_variants()]
    return keys


def _build_engines(module, **kw):
    """Every engine of ENGINE_NAMES from the seeded cache."""
    built = {}
    for name, (params, mnu, comp, _) in ENGINES.items():
        built[name] = module.BoltzEngine(params, **ENGINE_OPTS, **kw,
                                         massive_nu=mnu, component=comp)
    built["shape"] = module.BoltzEngine({}, shape_response=True,
                                        **ENGINE_OPTS, **kw)
    built["flat_z"] = module.BoltzEngine({}, z_resolved=False,
                                         **ENGINE_OPTS, **kw)
    return built


def _served_params(name, mode):
    return dict(ENGINES.get(name, ({},))[0], **SERVED[mode])


def _jacobian_theta():
    base = tmerge({})
    return np.array([base[n] for n in JAC_NAMES])


def _jax_engine_refs():
    """The JAX side of every engine test, from seeded caches (no solve):
    the engines' tables, plin served at each background, pzk_grid, the
    Jacobian, Cosmology(engine="boltz").P_lin and its engine's pzk_grid
    on the HaloModel's grid."""
    keys = _seed_all(jbe)
    try:
        engines = _build_engines(jbe)
        jc = jcos.Cosmology(engine="boltz", engine_opts=ENGINE_OPTS)
    finally:
        for key in keys:
            jbe._TABLE_CACHE.pop(key, None)
    zs, ks = jnp.asarray(SERVE_ZS), jnp.asarray(SERVE_KS)
    out = {name: {a: np.asarray(getattr(eng, a))
                  for a in ("ks_t", "p0_t", "_lnratio", "_slope")}
           for name, eng in engines.items()}
    calls = {}
    for name, eng in engines.items():
        for mode in ("closed", "ode"):
            eng._resid(mode)      # built on the host at first use
        for mode in ("closed", "ode") + (("shape",) if name == "shape"
                                         else ()):
            calls[name, mode] = (eng, _served_params(name, mode),
                                 "ode" if mode == "ode" else "closed")
        calls[name, "pzk_grid"] = (eng, _served_params(name, "closed"), None)

    def serve(ps):
        # every served spectrum in one compiled program
        res = {}
        for key, (eng, _, growth) in calls.items():
            bg = jbg.background(jmerge(ps[key]))
            res[key] = (eng.pzk_grid(bg, zs, ks) if growth is None
                        else eng.plin(bg, zs, ks, growth_mode=growth))
        return res

    served = jax.jit(serve)({key: p for key, (_, p, _) in calls.items()})
    for (name, mode), val in served.items():
        out[name][mode] = np.asarray(val)
    eng = engines["shape"]

    def f(th):
        p = jmerge(dict(zip(JAC_NAMES, th)))
        return eng.plin(jbg.background(p), zs, ks)

    out["jacobian"] = np.asarray(jax.jit(jax.jacfwd(f))(
        jnp.asarray(_jacobian_theta())))
    jc.engine._resid("closed")
    out["P_lin"] = np.asarray(jax.jit(lambda: jc.P_lin(SERVE_KS,
                                                       SERVE_ZS))())
    bg = jbg.background(jmerge({}))
    out["halo_pzk"] = np.asarray(jax.jit(lambda: jc.engine.pzk_grid(
        bg, jnp.asarray(HALO[0]), jnp.asarray(HALO[1])))())
    return out


@pytest.fixture(autouse=True, scope="module")
def _jax_refs():
    """The JAX engine references, computed by a worker thread from the
    module's start beside the port's solves (``_torch_jax.Prefetch``)."""
    if jnp is None:
        yield None
        return
    pre = Prefetch(1)
    yield pre.submit(_jax_engine_refs)
    pre.close()


@pytest.fixture(scope="module")
def engines(_jax_refs):
    """The port's engines from its seeded cache, and the JAX
    references."""
    keys = _seed_all(tbe)
    try:
        built = _build_engines(tbe, device="cpu")
    finally:
        for key in keys:
            tbe._TABLE_CACHE.pop(key, None)
    return built, _jax_refs.result()


@pytest.mark.parametrize("name", ENGINE_NAMES)
def test_engine_tables_and_plin_match_jax(name, engines):
    built, ref = engines
    eng, want = built[name], ref[name]
    for attr in ("ks_t", "p0_t", "_lnratio", "_slope"):
        assert _close(getattr(eng, attr), want[attr]) <= GATE, attr
    for mode in ("closed", "ode") + (("shape",) if name == "shape" else ()):
        bg = tbg.background(tmerge(_served_params(name, mode)), "cpu")
        got = eng.plin(bg, SERVE_ZS, SERVE_KS,
                       growth_mode="ode" if mode == "ode" else "closed")
        assert got.device.type == "cpu"
        assert _close(got, want[mode]) <= GATE, mode
    bg = tbg.background(tmerge(_served_params(name, "closed")), "cpu")
    assert _close(eng.pzk_grid(bg, SERVE_ZS, SERVE_KS),
                  want["pzk_grid"]) <= GATE
    with pytest.raises(NotImplementedError):
        eng.pzk_grid(bg, SERVE_ZS, SERVE_KS, nonlinear=True)


def test_engine_jacobian_matches_jax(engines):
    """d P(k, z) / d (omch2, ombh2, H0, As) through the shape-response
    engine: torch.func.jacfwd against jax.jacfwd; and a vmapped batch of
    backgrounds equal to single calls."""
    built, ref = engines
    eng = built["shape"]

    def f(th):
        p = tmerge(dict(zip(JAC_NAMES, th.unbind(0))))
        return eng.plin(tbg.background(p, "cpu"), SERVE_ZS, SERVE_KS)

    theta = _jacobian_theta()
    got = torch.func.jacfwd(f)(T(theta))
    for i, name in enumerate(JAC_NAMES):
        assert _close(got[..., i], ref["jacobian"][..., i]) <= JAC_GATE, name
    th = T(np.stack([theta, theta * np.array([1.02, 0.99, 1.01, 1.1])]))
    rows = torch.func.vmap(f)(th)
    for b in range(2):
        assert _close(rows[b], f(th[b])) <= 1e-12


def test_make_engine_and_the_classes(engines):
    """make_engine("boltz", params=, engine_opts=) and Cosmology(engine=
    "boltz") against the JAX class; a small HaloModel on the engine
    against the JAX class on its tables."""
    built, ref = engines
    keys = _seed_all(tbe)
    try:
        eng = tlp.make_engine("boltz", params={}, engine_opts=ENGINE_OPTS,
                              device="cpu")
        tc = tcos.Cosmology(engine="boltz", engine_opts=ENGINE_OPTS,
                            device="cpu")
        zs, ks, ms = HALO
        th = thm.HaloModel(zs, ks, ms=ms, engine="boltz",
                           engine_opts=ENGINE_OPTS, device="cpu")
    finally:
        for key in keys:
            tbe._TABLE_CACHE.pop(key, None)
    assert isinstance(eng, tbe.BoltzEngine) and tc.engine.name == "boltz"
    bt = tbg.background(tmerge({}), "cpu")
    assert torch.equal(eng.plin(bt, SERVE_ZS, SERVE_KS),
                       built["eh99"].plin(bt, SERVE_ZS, SERVE_KS))
    assert _close(tc.P_lin(SERVE_KS, SERVE_ZS), ref["P_lin"]) <= GATE
    assert _close(th.Pzk, ref["halo_pzk"]) <= GATE
    jhm = jax_halo_model_of(th)
    assert _close(th.get_power("nfw"), jhm.get_power("nfw")) <= GATE
