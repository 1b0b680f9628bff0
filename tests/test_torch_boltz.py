"""PyTorch port, the Boltzmann group (recomb, boltzlite, boltz_engine): the
functions whose JAX programs are cheap, held live against the JAX package
on the CPU, inputs made by numpy from a seed.

* recombination at n = 4,096, massless and with mnu = 0.06 (the
  Fermi-Dirac background), on xe, tau, tau_x, the visibility, eta, eta0;
* the Fermi-Dirac background pieces, make_ctx, the closed forms (H_p,
  its slope, tau_x, tau_xx, eta at 300 x) and the right-hand sides
  (_initial_state, _rhs_full, _rhs_tc, _with_slaved, _tc_active) at (k, x)
  pairs on both sides of the tight-coupling switch with the massive-nu
  fluid on, both packages on the same recombination table;
* the Catmull-Rom k interpolation and the C_l / C_phiphi projections on a
  synthetic SourceTable;
* the host helpers (l nodes, the segment-C step rule, the engine's k
  grid, the drag-epoch sound horizon, the EH tail graft);
* the wiring of get_cmb_cls(approx=True) with compute_cls and the Limber
  C_phiphi stubbed in both packages alike, for both lens methods.

Every JAX side runs under one jax.jit where the function allows, in
worker threads from the module's start (``_torch_jax.Prefetch``).  Gate:
1e-10, element by element, relative to a row's largest value on a row
that changes sign or holds zeros (``_close``).  The solve itself is held
against a JAX golden file by tests/test_torch_boltz_solve.py.

The card test (``-m gpu``) holds both kernels (ops/boltz_kernels.py) on the
card against their plain versions:

    python -m pytest --noconftest -m gpu tests/test_torch_boltz.py
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from hmvec_tpu.models import background as jbg
    from hmvec_tpu.models import boltz_engine as jbe
    from hmvec_tpu.models import boltzlite as jbl
    from hmvec_tpu.models import recomb as jrec
    from hmvec_tpu.params import merge_params as jmerge
    from _torch_jax import Prefetch
except ImportError:    # a machine with the card and no JAX: the tests
    jnp = None         # marked gpu need none of it (run them with -m gpu)

from hmvec_tpu_torch.models import background as tbg
from hmvec_tpu_torch.models import boltz_engine as tbe
from hmvec_tpu_torch.models import boltzlite as tbl
from hmvec_tpu_torch.models import lensed_cls as tlc
from hmvec_tpu_torch.models import recomb as trec
from hmvec_tpu_torch.ops import boltz_kernels as bk
from hmvec_tpu_torch.params import merge_params as tmerge

GATE = 1e-10
N_REC = 4096
COSMOS = {"massless": {}, "mnu": {"mnu": 0.06}}
RNG = np.random.default_rng(41)
# (k, x) pairs: both sides of the tight-coupling switch (x = ln(1/1630))
PAIR_KS = np.array([1e-4, 3e-3, 0.05, 0.3])
PAIR_XS = np.array([-16.0, -12.0, -8.0, -7.45, -7.3, -6.0, -3.0, -0.2])
STATES = RNG.standard_normal((PAIR_KS.size * PAIR_XS.size, bk.NSTATE))
CLOSED_XS = np.sort(RNG.uniform(-17.9, -0.01, 300))
# a synthetic SourceTable: 10 coarse k, 80 x, smooth random sources
SRC_KS = np.geomspace(1e-4, 0.2, 10)
SRC_XS = np.linspace(-7.5, 0.0, 80)
SRC_CHI = 14000.0 * (-SRC_XS / 7.5) ** 0.7
SRC_ROWS = {k: RNG.standard_normal((SRC_KS.size, 4)) @ np.stack(
    [np.ones_like(SRC_XS), SRC_XS, np.sin(3 * SRC_XS), np.cos(2 * SRC_XS)])
    for k in ("s_t", "s_e", "s_p")}
SRC_LS = np.array([2, 5, 20, 60, 150, 300])
SRC_KF = np.linspace(2e-4, 0.18, 300)
JL_U = RNG.uniform(0.0, 45.0, (7, 11))     # past the table's end too
WIRING_LMAX = 200


def T(v):
    return torch.as_tensor(v, dtype=torch.float64)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    # ROADMAP C14: a thread's first MKL vector-math call once came out at
    # low accuracy; each one is made here, on both threads, and discarded
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
    """Max error of got against want along the last axis, row by row:
    relative, element by element, on a row that keeps one sign and holds
    no zero; relative to the row's largest |want| on a row that changes
    sign or holds exact zeros."""
    got, want = _np(got).astype(float), np.asarray(want, dtype=float)
    assert got.shape == want.shape, (got.shape, want.shape)
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    err = np.abs(got - want)
    one_sign = np.all(want > 0.0, -1) | np.all(want < 0.0, -1)
    row_max = np.max(np.abs(want), -1)
    scale = np.where(one_sign[..., None], np.abs(want),
                     np.where(row_max > 0.0, row_max, 1.0)[..., None])
    return float(np.max(err / scale))


# ---- the JAX references ---------------------------------------------------

def _jax_rec(name):
    bg = jbg.background(jmerge(COSMOS[name]))
    rec = jrec.recombination(bg, n=N_REC, massive_nu=name == "mnu")
    return {f: np.asarray(getattr(rec, f)) for f in rec._fields}


def _jax_ctx(rec, massive_nu=True):
    bg = jbg.background(jmerge(COSMOS["mnu"]))
    return jbl.make_ctx(bg, jrec.RecombTable(
        **{k: jnp.asarray(v) for k, v in rec.items()}), massive_nu)


def _jax_functions(rec):
    """The closed forms at CLOSED_XS, the right-hand sides at the (k, x)
    pairs, the initial states, and the Fermi-Dirac background: one
    compiled program."""
    ctx = _jax_ctx(rec)
    ks = np.repeat(PAIR_KS, PAIR_XS.size)
    xs = np.tile(PAIR_XS, PAIR_KS.size)

    def run():
        c = jax.vmap(lambda x: (jbl._hp(ctx, x), jbl._dlnhp(ctx, x),
                                jbl._taux(ctx, x), jbl._tauxx(ctx, x),
                                jbl._eta(ctx, x)))(jnp.asarray(CLOSED_XS))
        pair = jax.vmap(lambda k, x, s: (
            jbl._rhs_full(ctx, k, x, s), jbl._rhs_tc(ctx, k, x, s),
            jbl._with_slaved(ctx, k, x, s), jbl._tc_active(ctx, k, x),
            jbl._initial_state(ctx, k, x), jbl._initial_state(ctx, k, -18.0),
            jbl.energy_constraint_residual(ctx, x, k, s, s[0])))(
                jnp.asarray(ks), jnp.asarray(xs), jnp.asarray(STATES))
        bg = ctx.bg
        fd = (jbl.fd_background_pieces(bg),
              jbl.e_of_z_fd(bg, jnp.asarray(np.geomspace(0.01, 3e4, 50))))
        return c, pair, fd

    c, pair, fd = jax.jit(run)()
    out = {"closed": [np.asarray(v) for v in c],
           "pair": [np.asarray(v) for v in pair],
           "fd": [np.asarray(v) for v in fd[0]] + [np.asarray(fd[1])]}
    for massive_nu in (True, False):
        ctx = _jax_ctx(rec, massive_nu)
        out[f"ctx_{massive_nu}"] = {f: np.asarray(getattr(ctx, f))
                                    for f in ctx._fields if f != "bg"}
    return out


def _jax_sources():
    """cls_from_sources and clpp_from_sources on the synthetic table (op
    by op), the Catmull-Rom interpolation (one program)."""
    bg = jbg.background(jmerge({}))
    src = jbl.SourceTable(
        ks=jnp.asarray(SRC_KS), xs=jnp.asarray(SRC_XS),
        chi=jnp.asarray(SRC_CHI), s_t=jnp.asarray(SRC_ROWS["s_t"]),
        s_e=jnp.asarray(SRC_ROWS["s_e"]), zeta_unit=jnp.asarray(1.4),
        s_p=jnp.asarray(SRC_ROWS["s_p"]), chi_star=jnp.asarray(13800.0))
    kf = jnp.asarray(SRC_KF)
    # op by op: the projections read the grid's extent on the host
    cl = jbl.cls_from_sources(src, bg, SRC_LS, kf)
    pp = jbl.clpp_from_sources(src, bg, SRC_LS, kf)
    cr = jax.jit(jbl._catmull_rom_k)(src.s_t, src.ks, kf)
    us, tab = jbl._jl_table(SRC_LS, 40.0, 0.05)
    jl = jax.jit(jbl._jl_interp)(us, tab, jnp.asarray(JL_U))
    return {k: np.asarray(v) for k, v in cl.items()} | {
        "pp": np.asarray(pp["pp"]), "cr": np.asarray(cr),
        "jl": np.asarray(jl)}


def _wiring_cls(lmax, lens_potential=False, **kw):
    """The stand-in of compute_cls for the wiring test (numpy)."""
    ells = np.arange(lmax + 1, dtype=np.float64)
    out = np.zeros((lmax + 1, 4))
    out[2:, 0] = 2e3 / (ells[2:] * (ells[2:] + 1.0)) * np.exp(-ells[2:] / 900)
    out[2:, 1] = 0.02 * out[2:, 0]
    out[2:, 3] = 0.1 * out[2:, 0] * np.cos(ells[2:] / 60.0)
    if lens_potential:
        pp = np.zeros(lmax + 1)
        pp[2:] = 1e-8 / (ells[2:] ** 2 * (ells[2:] + 1.0) ** 2) * 40.0
        return out, pp
    return out


def _wiring_limber(self, lmax, nonlinear=False):
    ls = np.arange(2, lmax + 1, dtype=np.float64)
    return ls, 2.5e-9 / (1.0 + (ls / 60.0) ** 2) * (1.2 if nonlinear else 1.0)


def _wiring_lens(unl, clpp, lmax_out):
    """The stand-in of the resummed lensing (its own tests are in
    tests/test_torch_cmb_lensing.py; at the padded lmax it takes a minute
    on the CPU): a function of both its inputs, numpy or torch."""
    return unl[:lmax_out + 1] * 2.0 + clpp[:lmax_out + 1, None] * 1e3


def _jax_wiring():
    """get_cmb_cls(approx=True) of the JAX class with compute_cls and the
    Limber C_phiphi stubbed, for both lens methods."""
    from hmvec_tpu.models import lensed_cf as jlcf
    from hmvec_tpu.models.cosmology import Cosmology
    old = (jbl.compute_cls, Cosmology.cmb_lensing_limber,
           jlcf.lens_cls_flat_sky_resummed)
    jbl.compute_cls = lambda params, lmax, **kw: _wiring_cls(lmax, **kw)
    Cosmology.cmb_lensing_limber = _wiring_limber
    jlcf.lens_cls_flat_sky_resummed = _wiring_lens
    try:
        cos = Cosmology()
        return {m: {k: np.asarray(v) for k, v in cos.get_cmb_cls(
            lmax=WIRING_LMAX, approx=True, lens_method=m).items()
            if k != "approx"} for m in ("resummed", "first_order")}
    finally:
        (jbl.compute_cls, Cosmology.cmb_lensing_limber,
         jlcf.lens_cls_flat_sky_resummed) = old


@pytest.fixture(autouse=True, scope="module")
def _jax_refs():
    if jnp is None:
        yield None
        return
    pre = Prefetch(2)
    recs = {n: pre.submit(_jax_rec, n) for n in COSMOS}
    refs = {"rec": recs, "src": pre.submit(_jax_sources),
            "wiring": pre.submit(_jax_wiring)}
    refs["fn"] = pre.submit(lambda: _jax_functions(recs["mnu"].result()))
    yield refs
    pre.close()


@pytest.fixture(scope="module")
def jax_refs(_jax_refs):
    return _jax_refs


def _port_ctx(rec, massive_nu=True):
    """The port's context on the JAX package's recombination arrays."""
    bg = tbg.background(tmerge(COSMOS["mnu"]), "cpu")
    return tbl.make_ctx(bg, trec.RecombTable(
        **{k: T(np.array(v)) for k, v in rec.items()}), massive_nu)


# ---- recombination ----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(COSMOS))
def test_recombination_matches_jax(name, jax_refs):
    """recombination at n = 4,096 (measured 4e-13 on xe, the largest)."""
    bg = tbg.background(tmerge(COSMOS[name]), "cpu")
    before = bk.recomb_rk4.launches
    got = trec.recombination(bg, n=N_REC, massive_nu=name == "mnu")
    assert bk.recomb_rk4.launches == before     # the CPU: the plain loop
    want = jax_refs["rec"][name].result()
    for field in ("xs", "xe", "tau_x", "eta", "eta0"):
        assert _close(getattr(got, field), want[field]) <= GATE, field
    # tau and the visibility end in 0 and inf-free zeros: row-max rule
    for field in ("tau", "gvis"):
        assert _close(getattr(got, field)[:-1], want[field][:-1]) <= GATE
    assert got.xe.device.type == "cpu" and got.xe.dtype == torch.float64


def test_recombination_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        tbe.rs_drag_integral()


def test_recomb_parts_match_jax():
    """The Peebles rate, both Saha solutions and the reionization step on
    the same points."""
    nh = np.geomspace(1e-2, 1e6, 40)
    tb = np.geomspace(0.05, 5.0, 40)
    xe = RNG.uniform(1e-4, 1.0, 40)
    hs = np.geomspace(1e-18, 1e-10, 40)
    want = jax.jit(lambda: (
        jrec._peebles_rates(xe, nh, tb, hs), jrec._saha_xe(nh, tb),
        jrec._saha_coupled(nh, tb, 0.079), jrec._reio_xe(
            jnp.linspace(0.0, 30.0, 40), 7.7, 0.079)))()
    got = (trec._peebles_rates(T(xe), T(nh), T(tb), T(hs)),
           trec._saha_xe(T(nh), T(tb)),
           trec._saha_coupled(T(nh), T(tb), 0.079),
           trec._reio_xe(torch.linspace(0.0, 30.0, 40, dtype=torch.float64),
                         7.7, 0.079))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert _close(g, w) <= GATE


# ---- the solver's pieces ------------------------------------------------------

def test_fd_background_and_ctx_match_jax(jax_refs):
    want = jax_refs["fn"].result()
    rec = jax_refs["rec"]["mnu"].result()
    bg = tbg.background(tmerge(COSMOS["mnu"]), "cpu")
    got = list(tbl.fd_background_pieces(bg)) + [
        tbl.e_of_z_fd(bg, np.geomspace(0.01, 3e4, 50))]
    for g, w in zip(got, want["fd"]):
        assert _close(g, w) <= GATE
    for massive_nu in (True, False):
        ctx = _port_ctx(rec, massive_nu)
        for field, w in want[f"ctx_{massive_nu}"].items():
            assert _close(getattr(ctx, field), w) <= GATE, field


def test_closed_forms_match_jax(jax_refs):
    want = jax_refs["fn"].result()["closed"]
    ctx = _port_ctx(jax_refs["rec"]["mnu"].result())
    x = T(CLOSED_XS)
    got = (tbl._hp(ctx, x), tbl._dlnhp(ctx, x), tbl._taux(ctx, x),
           tbl._tauxx(ctx, x), tbl._eta(ctx, x))
    for g, w in zip(got, want):
        assert _close(g, w) <= GATE


def test_right_hand_sides_match_jax(jax_refs):
    """_rhs_full, _rhs_tc, _with_slaved, _tc_active, _initial_state (at x
    and at x0 = -18) and the energy-constraint residual at 32 (k, x)
    pairs, the massive-nu fluid on."""
    want = jax_refs["fn"].result()["pair"]
    ctx = _port_ctx(jax_refs["rec"]["mnu"].result())
    ks = T(np.repeat(PAIR_KS, PAIR_XS.size))
    xs = T(np.tile(PAIR_XS, PAIR_KS.size))
    s = T(STATES)
    got = (tbl._rhs_full(ctx, ks, xs, s), tbl._rhs_tc(ctx, ks, xs, s),
           tbl._with_slaved(ctx, ks, xs, s), tbl._tc_active(ctx, ks, xs),
           tbl._initial_state(ctx, ks, xs),
           tbl._initial_state(ctx, ks, T(-18.0)),
           tbl.energy_constraint_residual(ctx, xs, ks, s, s[:, 0]))
    tc = _np(got[3])
    assert np.array_equal(tc, want[3]) and tc.any() and not tc.all()
    for i in (0, 1, 2, 4, 5):
        assert _close(got[i], want[i]) <= GATE, i
    assert _close(got[6][:, None], want[6][:, None]) <= GATE


def test_projections_match_jax(jax_refs):
    """Catmull-Rom in ln k, the C_l / C_phiphi Bessel projections on a
    synthetic SourceTable (10 k x 80 x, 6 l nodes, 300 fine k) and the
    Bessel table's interpolation."""
    want = jax_refs["src"].result()
    bg = tbg.background(tmerge({}), "cpu")
    src = tbl.SourceTable(
        ks=T(SRC_KS), xs=T(SRC_XS), chi=T(SRC_CHI),
        s_t=T(SRC_ROWS["s_t"]), s_e=T(SRC_ROWS["s_e"]),
        zeta_unit=T(1.4), s_p=T(SRC_ROWS["s_p"]), chi_star=T(13800.0))
    cl = tbl.cls_from_sources(src, bg, SRC_LS, SRC_KF)
    pp = tbl.clpp_from_sources(src, bg, SRC_LS, SRC_KF)
    assert np.array_equal(_np(cl["ls"]), want["ls"])
    for key in ("tt", "ee", "te"):
        assert _close(cl[key], want[key]) <= GATE, key
    assert _close(pp["pp"], want["pp"]) <= GATE
    cr = tbl._catmull_rom_k(src.s_t, src.ks, T(SRC_KF))
    assert _close(cr.T, want["cr"].T) <= GATE
    us, tab = tbl._jl_table(SRC_LS, 40.0, 0.05, torch.device("cpu"))
    assert _close(tbl._jl_interp(us, tab, T(JL_U)), want["jl"]) <= GATE


def test_host_helpers_match_jax(jax_refs):
    for lmax in (2, 7, 300, 301, 1500, 3400):
        assert np.array_equal(tbl.default_l_nodes(lmax),
                              jbl.default_l_nodes(lmax))
    assert tlc.default_l_nodes is tbl.default_l_nodes
    for kmax in (0.2325, 0.5, 0.65, 1.0):
        assert tbl.segment_c_inner_steps(kmax, 67.3) == \
            jbl.segment_c_inner_steps(kmax, 67.3)
    for kmax in (0.3, 0.65):
        assert np.array_equal(tbe.default_k_grid(kmax),
                              jbe.default_k_grid(kmax))
    nodes = np.array([2.0, 10.0, 40.0, 120.0, 400.0])
    vals = RNG.uniform(1.0, 2.0, 5)
    ells = np.arange(2.0, 400.0)
    assert np.array_equal(tbl._interp_l_nodes(nodes, vals, ells),
                          jbl._interp_l_nodes(nodes, vals, ells))
    # the drag-epoch sound horizon on each package's own recombination
    rec_j = jax_refs["rec"]["massless"].result()
    bg_t = tbg.background(tmerge({}), "cpu")
    rec_t = trec.recombination(bg_t, n=N_REC)
    got = tbe.rs_drag_integral(rec=rec_t, bg=bg_t)
    want = jbe.rs_drag_integral(
        rec=jrec.RecombTable(**{k: jnp.asarray(v) for k, v in rec_j.items()}),
        bg=jbg.background(jmerge({})))
    assert all(abs(g / w - 1.0) <= GATE for g, w in zip(got, want))
    # the EH tail graft on the engine's grid and a wiggly spectrum
    ks_b = tbe.default_k_grid(0.65)
    p0_b = 2e4 * (ks_b / 0.02) / (1.0 + (ks_b / 0.02) ** 2.6) \
        * (1.0 + 0.05 * np.sin(ks_b * 147.0))
    got = tbe._graft_eh_tail(bg_t, ks_b, p0_b, 0.55, 2100.0)
    want = jbe._graft_eh_tail(jbg.background(jmerge({})), ks_b, p0_b, 0.55,
                              2100.0)
    assert np.array_equal(got[0], want[0])
    assert _close(got[1], want[1]) <= GATE
    assert abs(got[2] / want[2] - 1.0) <= GATE


# ---- get_cmb_cls(approx=True) wiring ------------------------------------------

@pytest.mark.parametrize("method", ["resummed", "first_order"])
def test_get_cmb_cls_approx_wiring_matches_jax(method, jax_refs,
                                               monkeypatch):
    """compute_cls and the Limber C_phiphi stubbed alike in both packages
    (as tests/_boltzlite_suite.py stubs them), and for 'resummed' the lens
    function too: the blend over L in [80, 130], the lens method, the
    padding and the marker."""
    from hmvec_tpu_torch.models import lensed_cf as tlcf
    from hmvec_tpu_torch.models.cosmology import Cosmology
    want = jax_refs["wiring"].result()[method]
    monkeypatch.setattr(tlcf, "lens_cls_flat_sky_resummed", _wiring_lens)
    monkeypatch.setattr(
        tbl, "compute_cls",
        lambda params, lmax, device=None, **kw: tuple(
            T(a) for a in _wiring_cls(lmax, **kw)))
    monkeypatch.setattr(Cosmology, "cmb_lensing_limber", _wiring_limber)
    out = Cosmology(device="cpu").get_cmb_cls(lmax=WIRING_LMAX, approx=True,
                                              lens_method=method)
    assert out["approx"] is True
    assert set(out) == set(want) | {"approx"}
    for key, w in want.items():
        assert out[key].device.type == "cpu"
        assert _close(out[key].T, w.T) <= GATE, key
    with pytest.raises(ValueError, match="lens_method"):
        Cosmology(device="cpu").get_cmb_cls(lmax=WIRING_LMAX, approx=True,
                                            lens_method="exact")


# ---- the kernels' wrappers ------------------------------------------------------

def _kernel_inputs(device):
    """The recombination kernel's inputs at n = 4,096 with the
    Fermi-Dirac background, and the background."""
    bg = tbg.background(tmerge({"mnu": 0.06}), device)
    xs = trec._linspace(-18.0, 0.0, N_REC, device)
    dx = xs[1] - xs[0]
    tab, sn, xe0 = trec.recomb_tables(bg, xs, dx, massive_nu=True)
    return bg, (tab[None], sn[None], xe0.reshape(1), float(dx))


def test_kernel_wrappers_check_their_inputs():
    bg, (tab, sn, xe0, dx) = _kernel_inputs("cpu")
    with pytest.raises(ValueError, match="requires grad"):
        bk.recomb_rk4(tab.clone().requires_grad_(), sn, xe0, dx)
    with pytest.raises(ValueError):
        bk.recomb_rk4(tab[:, :, :2], sn, xe0, dx)
    with pytest.raises(TypeError):
        bk.recomb_rk4(tab.float(), sn, xe0, dx)
    ks = T([1e-3, 0.1])
    s0 = torch.zeros(2, bk.NSTATE, dtype=torch.float64)
    xtab = torch.zeros(6, 3, len(bk.XCOLS), dtype=torch.float64)
    consts = torch.ones(5, dtype=torch.float64)
    with pytest.raises(ValueError, match="xtab"):
        bk.hierarchy_rk4(xtab, ks, consts, s0, 0.01, 2, 2)
    with pytest.raises(ValueError, match="requires grad"):
        bk.hierarchy_rk4(xtab, ks.clone().requires_grad_(), consts, s0,
                         0.01, 2, 3)


@pytest.mark.gpu
def test_kernels_on_the_card_match_their_plain_versions():
    """recomb_rk4 at n = 4,096 with the Fermi-Dirac background and
    hierarchy_rk4 through segments A and B of the CPU tests' reduced
    grid for 8 k, on the card against the plain versions on the same card
    tensors: the kernels keep every multiply and add unfused
    (-fmad=false), so they agree to the last bit or nearly (gate 1e-12
    of a row's largest value)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bg, args = _kernel_inputs("cuda")
    before = bk.recomb_rk4.launches
    got = bk.recomb_rk4(*args)
    assert bk.recomb_rk4.launches == before + 1
    want = bk.recomb_rk4_plain(*args)
    assert bool(torch.isfinite(got).all())
    assert _close(got.cpu(), want.cpu().numpy()) <= 1e-12
    rec = trec.recombination(bg)
    ctx = tbl.make_ctx(bg, rec)
    ks = torch.as_tensor(np.geomspace(1e-4, 0.1, 8), device="cuda")
    s0 = tbl._initial_state(ctx, ks, torch.tensor(-18.0, device="cuda",
                                                  dtype=torch.float64))
    for x_start, dx, n_outer, n_inner in ((-18.0, 8.8 / 300, 30, 10),
                                          (-9.2, 0.005, 40, 4)):
        i = torch.arange(n_outer, dtype=torch.float64, device="cuda")
        j = torch.arange(n_inner, dtype=torch.float64, device="cuda")
        x = ((x_start + i * (n_inner * dx))[:, None] + j * dx).reshape(-1)
        xtab = tbl._x_table(ctx, trec.rk4_subpoints(x, dx)).contiguous()
        consts = torch.stack([ctx.h0m, ctx.omg, ctx.omnu, ctx.omb, ctx.omc])
        end_k, kept_k = bk.hierarchy_rk4(xtab, ks, consts, s0, dx, n_outer,
                                         n_inner, True)
        end_p, kept_p = bk.hierarchy_rk4_plain(xtab, ks, consts, s0, dx,
                                               n_outer, n_inner, True)
        assert bool(torch.isfinite(kept_k).all())
        assert _close(kept_k.cpu(), kept_p.cpu().numpy()) <= 1e-12
        s0 = end_k
