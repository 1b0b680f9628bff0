"""PyTorch port, the redshift-space group: the rest of models/rsd.py,
models/spt.py, models/_tns_kernels.py with models/tns.py and
models/rsd_obs.py, with Cosmology.P_mm_1loop, Cosmology.get_rsd_multipoles
and HaloModel.get_galaxy_rsd_multipoles, against the JAX package on the
CPU at small sizes (nk 16, n_q 64, n_x 32, n_q13 128, n_mu 16; the class
tests on 2 z x 80 m), with inputs made by numpy from a seed.  The JAX side
of each test runs under one ``jax.jit``.  Both sides are float64 with the
same algorithm: 1e-10, element by element relative (``_close``: relative
to the row's largest value only along a row that changes sign or holds
exact zeros).

The TNS A/B integrals are the exception.  Their reduced kernels cancel
catastrophically (terms ~r^10 at r = q/k ~ 1e3 summing to O(1)), so
below k ~ 1/Mpc they carry the rounding of the order that evaluates
them: the JAX package compiled against the same package op by op
differs by as much as the port does (tools/tns_spread.py).  The
free-function test holds the port to ten times that spread, measured
in the test (the reference's kernels evaluated in numpy); the class
tests hold the TNS rows below k = 1/Mpc to
``TNS_LOW_K_GATE``, the largest spread measured there with a margin.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hmvec_tpu import params as jpar
from hmvec_tpu.models import background as jbg
from hmvec_tpu.models import cosmology as jcos
from hmvec_tpu.models import linear_power as jlp
from hmvec_tpu.models import rsd as jrsd
from hmvec_tpu.models import rsd_obs as jro
from hmvec_tpu.models import spt as jspt
from hmvec_tpu.models import tns as jtns
from _torch_jax import Prefetch

import hmvec_tpu_torch
from hmvec_tpu_torch.models import cosmology as tcos
from hmvec_tpu_torch.models import halo_model as thm
from hmvec_tpu_torch.models import rsd as trsd
from hmvec_tpu_torch.models import rsd_obs as tro
from hmvec_tpu_torch.models import spt as tspt
from hmvec_tpu_torch.models import tns as ttns

RNG = np.random.default_rng(83)
PARAMS = {"omch2": 0.1198, "As": 2.2e-9}
KT = np.geomspace(1e-5, 1e3, 400)
# a linear-looking table with BAO-like wiggles
PT = (2.2e4 * (KT / 0.02) / (1.0 + (KT / 0.02) ** 2.6)
      * (1.0 + 0.04 * np.sin(KT * 147.0) * np.exp(-(KT * 6.0) ** 2)))
PT_NW = 2.2e4 * (KT / 0.02) / (1.0 + (KT / 0.02) ** 2.6)
KS = np.geomspace(0.004, 0.5, 16)
NODES = dict(n_q=64, n_x=32)
LOOP = dict(NODES, n_q13=128)
ZS = np.array([0.4, 1.5])
MS = np.geomspace(2e10, 1e17, 80)
HKS = np.geomspace(1e-4, 100.0, 16)
T = torch.as_tensor
GATE = 1e-10
# the TNS rows below k = 1/Mpc in the class tests: the JAX package's own
# op-by-op vs compiled spread there reaches 3.1e-3 (tools/tns_spread.py)
TNS_LOW_K_GATE = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want):
    """Max error of got against want along the last axis, row by row:
    relative, element by element, on a row that keeps one sign and holds
    no zero; relative to the row's largest |want| on a row that changes
    sign or holds exact zeros (an all-zero row: the largest |got|)."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    err = np.abs(got - want)
    one_sign = np.all(want > 0.0, -1) | np.all(want < 0.0, -1)
    row_max = np.max(np.abs(want), -1)
    scale = np.where(one_sign[..., None], np.abs(want),
                     np.where(row_max > 0.0, row_max, 1.0)[..., None])
    return float(np.max(err / scale))


def _tns_close(got, want, ks):
    """``_close`` on the rows' ks of 1/Mpc and above (GATE there) and
    below it (TNS_LOW_K_GATE there), as one ratio to its gate."""
    lo = np.asarray(ks) < 1.0
    got, want = _np(got), np.asarray(want)
    err_lo = _close(got[..., lo], want[..., lo]) if lo.any() else 0.0
    err_hi = _close(got[..., ~lo], want[..., ~lo]) if (~lo).any() else 0.0
    return max(err_lo / TNS_LOW_K_GATE, err_hi / GATE)


def _jit(fn, *args):
    """fn(*args) as one compiled JAX program; what the JAX package forms on
    the host from a grid it made is evaluated while tracing."""
    def body(*a):
        with jax.ensure_compile_time_eval():
            return fn(*a)
    return jax.jit(body)(*args)


TNS_POWER_KS = np.geomspace(1.0, 5.0, 6)
TNS_POWER_KW = dict(b=1.6, f=0.65, n_q=32, n_x=16, n_mu=16, qmin=1e-4,
                    qmax=1e2)


def _multipole_case(model):
    """(ks, keywords, sigma_v) of test_get_rsd_multipoles_matches_jax: a
    given sigma_v with the Kaiser model, the linear-theory one with the
    loop models."""
    ks = np.geomspace(0.01, 3.0, 14)
    kw = dict(LOOP, model=model, n_mu=16, b=np.array([1.3, 2.2]))
    return ks, kw, (dict(sigma_v=2.5) if model == "kaiser" else {})


def _jax_a(jc):
    out = {("p1loop", ir): _jit(lambda: jc.P_mm_1loop(
        ZS, KS, **dict(LOOP, ir_resum=ir))) for ir in (False, True)}
    out["grad"] = _jax_p1loop_jvp()
    return out


def _jax_b(jc):
    out = {}
    for model in ("kaiser", "scoccimarro", "tns"):
        ks, kw, sv = _multipole_case(model)
        out["multipoles", model] = _jit(
            lambda: jc.get_rsd_multipoles(ZS, ks, **sv, **kw))
    out["tns_power"] = _jit(lambda pt: jtns.tns_power(
        TNS_POWER_KS, KT, pt, one_loop=False, **TNS_POWER_KW), PT)
    return out


@pytest.fixture(autouse=True, scope="module")
def _jax_refs():
    """The JAX sides of the class tests and of tns_power (one compiled
    program each, ~45 s of compile together), computed by two worker
    threads from the module's start, beside each other and the file's
    other tests (``_torch_jax.Prefetch``)."""
    jc = jcos.Cosmology(PARAMS)
    pre = Prefetch()
    yield {"jc": jc, "a": pre.submit(_jax_a, jc), "b": pre.submit(_jax_b, jc)}
    pre.close()


# ---- models/rsd.py ------------------------------------------------------------

def test_kaiser_and_scoccimarro_match_jax():
    pk = np.abs(RNG.standard_normal((3, KS.size))) * 1e4 + 100.0
    b = RNG.uniform(1.0, 2.5, 3)
    f = RNG.uniform(0.4, 0.9, 3)
    sv = RNG.uniform(1.0, 6.0, 3)
    mus = np.linspace(-1.0, 1.0, 7)
    pdt, ptt = pk * 0.9, pk * 0.8

    def calls(m, pk, pdt, ptt, b, f, sv):
        # host data alone runs on the card unless the port is told the CPU
        cpu = {} if m is jrsd else {"device": "cpu"}
        return [m.kaiser_pk_mu(KS, mus, pk, b, f, sv),
                m.kaiser_pk_mu(KS, mus, pk[0], 1.5, 0.6, 4.0, "lorentzian"),
                *m.rsd_multipoles(KS, pk, b, f, sv, n_mu=16).values(),
                *m.rsd_multipoles(KS, pk[0], 1.2, 0.7, fog="lorentzian",
                                  ells=(0, 2), n_mu=8).values(),
                m.sigma_v_lin(KT, PT, **cpu),
                m.scoccimarro_pk_mu(KS, mus, pk, pdt, ptt, b, f, sv),
                *m.scoccimarro_multipoles(KS, pk, pdt, ptt, b, f, sv,
                                          n_mu=16).values(),
                *m.scoccimarro_multipoles(KS, pk[0], pdt[0], ptt[0], 2.0,
                                          0.5, 3.0, fog="lorentzian",
                                          n_mu=12).values()]

    want = _jit(lambda *a: calls(jrsd, *a), pk, pdt, ptt, b, f, sv)
    got = calls(trsd, T(pk), T(pdt), T(ptt), T(b), T(f), T(sv))
    assert len(got) == len(want)
    for i, (gv, wv) in enumerate(zip(got, want)):
        assert _close(gv, wv) <= GATE, (i, _close(gv, wv))
    fac = trsd.kaiser_multipole_factors(1.7, 0.55)
    assert fac == jrsd.kaiser_multipole_factors(1.7, 0.55)
    # no FoG: the multipoles are the closed-form factors
    mp = trsd.rsd_multipoles(KS, T(pk[0]), 1.7, 0.55)
    for ell in (0, 2, 4):
        assert _close(mp[ell], fac[ell] * pk[0]) <= 1e-12
    for fn in (lambda: trsd.kaiser_pk_mu(KS, mus, T(pk), 1.0, 0.5, fog="x"),
               lambda: trsd._legendre(6, T(mus))):
        with pytest.raises(ValueError):
            fn()


def test_correlation_multipoles_match_jax():
    ks = np.geomspace(1e-4, 1e2, 512)
    base = 2e4 * (ks / 0.02) / (1.0 + (ks / 0.02) ** 2.6)
    pk_ells = {0: 1.3 * base, 2: 0.6 * base, 4: 0.05 * base}
    ws, wxi = _jit(lambda p: jrsd.correlation_multipoles(ks, p), pk_ells)
    gs, gxi = trsd.correlation_multipoles(ks, {k: T(v)
                                               for k, v in pk_ells.items()})
    assert _close(gs, ws) <= 1e-15
    for ell in pk_ells:
        # a transform's rounding is set by its row's scale
        err = np.max(np.abs(_np(gxi[ell]) - np.asarray(wxi[ell]))
                     * np.asarray(ws) ** 1.5)
        assert err / np.max(np.abs(np.asarray(wxi[ell]) * np.asarray(ws)
                                   ** 1.5)) <= 1e-13


# ---- models/spt.py ------------------------------------------------------------

def test_f13_family_and_its_gradient_match_jax():
    """The three angular kernels across their switch zones, and their
    derivative (finite everywhere, the guarded direct branch).  The
    derivative of the direct form's cancellation near r = 1 carries
    ~1e-7 of rounding on either side (6.6e-8 measured), hence 1e-6."""
    r = np.concatenate([[1e-5, 5e-3, 0.0099, 0.0101, 0.3, 0.99995, 1.0,
                         1.00004, 1.0002, 9.99, 10.01, 40.0],
                        np.geomspace(1e-3, 1e3, 60)])
    fns = ("f13", "f13_dt", "f13_tt")
    want = jax.jit(lambda x: [
        (getattr(jspt, n)(x), jax.vmap(jax.grad(getattr(jspt, n)))(x))
        for n in fns])(r)
    rt = T(r).requires_grad_(True)
    for n, (wv, wd) in zip(fns, want):
        gv = getattr(tspt, n)(rt)
        (gd,) = torch.autograd.grad(gv.sum(), rt)
        assert _close(gv, wv) <= GATE, n
        assert np.all(np.isfinite(_np(gd)))
        assert _close(gd, wd) <= 1e-6, (n, _close(gd, wd))


SPT_CALLS = {
    "p13": lambda m, pt: m.p13(KS, KT, pt, n_q=128),
    "p13_dt": lambda m, pt: m.p13_dt(KS, KT, pt, n_q=128, qmin=1e-3,
                                     qmax=50.0),
    "p13_tt": lambda m, pt: m.p13_tt(KS, KT, pt, n_q=128),
    "p22": lambda m, pt: m.p22(KS, KT, pt, **NODES),
    "p22_velocity": lambda m, pt: m.p22_velocity(KS, KT, pt, **NODES,
                                                 qmin=1e-4, qmax=1e2),
    "pk_velocity_1loop": lambda m, pt: m.pk_velocity_1loop(KS, KT, pt,
                                                           **LOOP),
    "pt_bias_integrals": lambda m, pt: m.pt_bias_integrals(KS, KT, pt,
                                                           **NODES),
    "pgg_1loop": lambda m, pt: m.pgg_1loop(KS, KT, pt, 1.8, 0.4, shot=50.0,
                                           **LOOP),
    "pgm_1loop": lambda m, pt: m.pgm_1loop(KS, KT, pt, 1.8, 0.4, bs2=-0.2,
                                           **LOOP),
    "p1loop": lambda m, pt: m.p1loop(KS, KT, pt, **LOOP, qmin=1e-4,
                                     qmax=1e2, return_parts=True),
}


@pytest.mark.parametrize("name", list(SPT_CALLS))
def test_spt_spectra_match_jax(name):
    want = _jit(lambda pt: SPT_CALLS[name](jspt, pt), PT)
    got = SPT_CALLS[name](tspt, T(PT))
    flat_w, _ = jax.tree_util.tree_flatten(want)
    flat_g = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(_np, got, is_leaf=lambda x:
                               isinstance(x, torch.Tensor)))
    assert len(flat_g) == len(flat_w)
    for gv, wv in zip(flat_g, flat_w):
        assert _close(gv, wv) <= GATE, name


def test_panel_chunks_leave_each_k_unchanged(monkeypatch):
    """The k axis in chunks of one k: the same P22 and velocity spectra."""
    whole = (tspt.p22(KS, KT, T(PT), **NODES),
             tspt.p22_velocity(KS, KT, T(PT), **NODES)["tt"])
    monkeypatch.setattr(tspt, "PANEL_ELEMENTS", 1)
    chunked = (tspt.p22(KS, KT, T(PT), **NODES),
               tspt.p22_velocity(KS, KT, T(PT), **NODES)["tt"])
    for a, b in zip(chunked, whole):
        assert _close(a, b) <= 1e-15


def test_wiggle_split_and_ir_resummation_match_jax():
    ell_bao = 102.3

    def calls(m, pt, nw):
        p_nw, p_w = m.split_wiggle(KT, pt, nw)
        return [p_nw, p_w, m.bao_damping_sigma2(KT, p_nw, ell_bao),
                m.bao_damping_sigma2(KT, p_nw, 1e-3, n_q=64),
                m.p1loop_ir(KS, KT, pt, nw, ell_bao, **LOOP,
                            return_parts=True),
                m.p1loop_ir(KS, KT, nw, nw, ell_bao, **LOOP)]

    want = _jit(lambda *a: calls(jspt, *a), PT, PT_NW)
    got = calls(tspt, T(PT), T(PT_NW))
    flat_w = jax.tree_util.tree_leaves(want)
    flat_g = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(_np, got, is_leaf=lambda x:
                               isinstance(x, torch.Tensor)))
    assert len(flat_g) == len(flat_w)
    for i, (gv, wv) in enumerate(zip(flat_g, flat_w)):
        assert _close(gv, wv) <= GATE, (i, _close(gv, wv))
    # a wiggle-free input: the resummed spectrum is the plain one
    plain = tspt.p1loop(KS, KT, T(PT_NW), **LOOP)
    assert _close(got[-1], plain) <= 1e-12


# ---- models/tns.py --------------------------------------------------------------

def _ab_in_numpy(ks, pt, pdt, ptt, n_q, n_x, qmin, qmax, r_max=1000.0):
    """tns_ab_integrals with the JAX package's own reduced kernels
    (hmvec_tpu.models._tns_kernels, plain arithmetic) evaluated on numpy
    arrays: the reference's kernels in a second order of evaluation (no
    fused multiply-adds), for its rounding spread."""
    from hmvec_tpu.models import _tns_kernels as jk
    from hmvec_tpu.utils.weights import leggauss_cached as lg
    lnk = np.log(KT)

    def pk(lnp, k):
        lnq = np.log(k)
        lo = lnp[0] + (lnp[1] - lnp[0]) / (lnk[1] - lnk[0]) * (lnq - lnk[0])
        hi = lnp[-1] + ((lnp[-1] - lnp[-2]) / (lnk[-1] - lnk[-2])
                        * (lnq - lnk[-1]))
        out = np.where(lnq < lnk[0], lo, np.interp(lnq, lnk, lnp))
        return np.exp(np.where(lnq > lnk[-1], hi, out))

    lp, ldt, ltt = np.log(pt), np.log(pdt), np.log(ptt)
    t, w = lg(n_q // 2)
    tq, wq0 = 0.5 * (t + 1.0), 0.5 * w
    x, wx = lg(n_x)
    tx, wx = 0.5 * (x + 1.0), 0.5 * wx
    lo = np.full(ks.shape, np.log(qmin))
    hi = np.minimum(np.log(qmax), np.log(ks) + np.log(r_max))
    mid = np.clip(np.log(ks), lo, hi)
    out = {"A": {}, "B": {}}
    for a, b in ((lo, mid), (mid, hi)):
        wq = (b - a)[:, None] * wq0[None, :]
        q = np.exp(a[:, None] + (b - a)[:, None] * tq[None, :])
        r = (q / ks[:, None])[..., None]
        ymin = np.maximum(np.abs(1.0 - r), (qmin / ks)[:, None, None])
        y = np.exp(np.log(ymin) + (np.log(1.0 + r) - np.log(ymin)) * tx)
        wy = np.log((1.0 + r) / ymin) * wx
        ky = ks[:, None, None] * y
        Pr, Py, Pk = pk(lp, q), pk(lp, ky), pk(lp, ks)
        base = {"ry": Pr[..., None] * Py, "rk": (Pr * Pk[:, None])[..., None],
                "yk": Py * Pk[:, None, None],
                "dd": pk(ldt, q)[..., None] * pk(ldt, ky),
                "dt": pk(ldt, q)[..., None] * pk(ltt, ky),
                "td": pk(ltt, q)[..., None] * pk(ldt, ky),
                "tt": pk(ltt, q)[..., None] * pk(ltt, ky)}
        for t_, kern in (("A", jk.a_kernels(r, y)), ("B", jk.b_kernels(r, y))):
            for (m, n, j), C in kern.items():
                val = np.sum(wq * np.sum(wy * C * base[j], -1), -1)
                out[t_][m, n] = out[t_].get((m, n), 0.0) + val
    norm = ks**3 / (4.0 * np.pi**2)
    return {t_: {k: norm * v for k, v in d.items()} for t_, d in out.items()}


def test_tns_matches_jax_within_its_own_spread():
    """The A/B integrals against the compiled JAX package, each element
    within 1e-10 of it plus ten times the reference's own largest spread
    along that integral's k (its kernels evaluated in numpy against
    compiled), and every TNS assembly on the JAX package's own integrals
    at 1e-10."""
    ks = np.geomspace(1e-3, 20.0, 10)
    pdt, ptt = PT * 0.93, PT * 0.85
    kw = dict(NODES, qmin=1e-4, qmax=1e2)
    want = jax.jit(lambda *a: jtns.tns_ab_integrals(ks, KT, *a, **kw))(
        PT, pdt, ptt)
    other = _ab_in_numpy(ks, PT, pdt, ptt, **kw)
    got = ttns.tns_ab_integrals(ks, KT, T(PT), T(pdt), T(ptt), **kw)
    for t in "AB":
        assert list(got[t]) == list(want[t]) == list(other[t])
        for key in want[t]:
            w, o, g = (np.asarray(want[t][key]), other[t][key],
                       _np(got[t][key]))
            spread = np.max(np.abs(o - w))
            assert np.all(np.abs(g - w) <= 1e-10 * np.abs(w)
                          + 10.0 * spread), (t, key)
    # the assemblies on the JAX package's own integrals: 1e-10
    pv = {k: PT[:ks.size] * s for k, s in (("dd", 1.0), ("dt", 0.9),
                                           ("tt", 0.8))}
    mus = np.linspace(-1.0, 1.0, 5)
    ab_t = {t: {k: T(np.array(v)) for k, v in want[t].items()}
            for t in "AB"}

    def calls(m, abd, pv):
        return [m.tns_a_term(ks, mus, 0.7, abd, b=1.8),
                m.tns_b_term(ks, 0.3, 0.7, abd, b=1.8),
                m.tns_pk_mu(ks, mus, pv["dd"], pv["dt"], pv["tt"], 1.8, 0.7,
                            abd, sigma_v=4.0),
                *m.tns_multipoles(ks, pv["dd"], pv["dt"], pv["tt"], 1.8,
                                  0.7, abd, sigma_v=4.0, fog="lorentzian",
                                  n_mu=16).values()]

    want_m = jax.jit(lambda a, p: calls(jtns, a, p))(want, pv)
    got_m = calls(ttns, ab_t, {k: T(v) for k, v in pv.items()})
    for i, (gv, wv) in enumerate(zip(got_m, want_m)):
        assert _close(gv, wv) <= GATE, (i, _close(gv, wv))


def test_tns_power_matches_jax(_jax_refs):
    """The end-to-end convenience at tree level against JAX, on ks of
    1/Mpc and above (below it, the A/B spread of the test above), and at
    one loop as the composition of the pieces held above.  At 32 q nodes
    the A/B integrals' rounding reaches the multipoles at 7.1e-9 even
    there (measured), hence 5e-8."""
    ks, kw = TNS_POWER_KS, TNS_POWER_KW
    want = _jax_refs["b"].result()["tns_power"]
    got = ttns.tns_power(ks, KT, T(PT), one_loop=False, **kw)
    for ell in (0, 2, 4):
        assert _close(got[0][ell], want[0][ell]) <= 5e-8, ell
    assert _close(got[1]["sigma_v"], want[1]["sigma_v"]) <= GATE
    lin = tspt._pk_eval(torch.log(T(KT)), torch.log(T(PT)), T(ks))
    for ab in ("dd", "dt", "tt"):
        assert torch.equal(got[1]["pk_velocity"][ab], lin)
    mp, parts = ttns.tns_power(ks, KT, T(PT), **kw)
    pv = tspt.pk_velocity_1loop(ks, KT, T(PT), n_q=32, n_x=16, qmin=1e-4,
                                qmax=1e2)
    ab = ttns.tns_ab_integrals(ks, KT, T(PT), n_q=32, n_x=16, qmin=1e-4,
                               qmax=1e2)
    ref = ttns.tns_multipoles(ks, pv["dd"], pv["dt"], pv["tt"], 1.6, 0.65,
                              ab, sigma_v=parts["sigma_v"], n_mu=16)
    for ell in (0, 2, 4):
        assert torch.equal(mp[ell], ref[ell])


# ---- models/rsd_obs.py ------------------------------------------------------------

def test_rsd_obs_matches_jax():
    ks = np.geomspace(0.01, 0.4, 14)
    # A/B integrals of the right keys and a smooth k dependence
    ab = {t: {key: RNG.uniform(-50.0, 50.0) * (ks / 0.1) ** RNG.uniform(
        0.5, 1.5) for key in keys} for t, keys in (("A", ttns._A_KEYS),
                                                     ("B", ttns._B_KEYS))}
    pdd = 1e4 * (ks / 0.02) / (1.0 + (ks / 0.02) ** 2.6)
    pdt, ptt = 0.9 * pdd, 0.8 * pdd
    kpts = RNG.uniform(0.012, 0.38, (5, 4))
    mupts = RNG.uniform(-1.0, 1.0, (5, 4))
    args = (pdd, pdt, ptt, ab)

    def calls(m, pdd, pdt, ptt, ab, lib):
        def model(k, mu):
            return m.tns_pk_mu_points(k, mu, ks, pdd, pdt, ptt, 1.7, 0.6,
                                      ab, sigma_v=3.5)
        cov = m.multipole_covariance(lib(ks), model, 3e-4, 1e9, n_mu=24)
        mp = m.ap_multipoles(lib(ks), model, 1.02, 0.97, n_mu=24)
        return [m._interp_rows(ks, pdd, lib(kpts)),
                model(lib(kpts), lib(mupts)),
                *m.ap_shift(lib(ks), lib(mupts[0]), 1.03, 0.98),
                *mp.values(), cov,
                m.multipole_covariance(lib(ks), model, 1e-3, 5e8,
                                       dk=lib(0.01 * ks), ells=(0, 2),
                                       n_mu=16),
                m.multipole_snr(mp, cov)]

    want = _jit(lambda *a: calls(jro, *a, jnp.asarray), *args)
    got = calls(tro, T(pdd), T(pdt), T(ptt),
                {t: {k: T(v) for k, v in ab[t].items()} for t in "AB"}, T)
    assert len(got) == len(want)
    for i, (gv, wv) in enumerate(zip(got, want)):
        assert _close(gv, wv) <= GATE, (i, _close(gv, wv))


def test_window_coupling_and_convolution_match_jax():
    for ls in ((0, 0, 0), (2, 2, 2), (4, 2, 2), (3, 2, 1), (6, 4, 8),
               (1, 1, 4), (10, 6, 4)):
        assert tro.threej000_sq(*ls) == jro.threej000_sq(*ls)
    np.testing.assert_array_equal(tro.window_coupling(),
                                  jro.window_coupling())
    np.testing.assert_array_equal(
        tro.window_coupling((0, 2), (0, 2, 4), (0, 2)),
        jro.window_coupling((0, 2), (0, 2, 4), (0, 2)))
    # the package root's threej000_sq is lensing_noise's (the JAX root
    # imports rsd_obs's first and lensing_noise's over it); rsd_obs keeps
    # its exact form for the window coupling
    from hmvec_tpu_torch.models import lensing_noise as tln
    assert hmvec_tpu_torch.threej000_sq is tln.threej000_sq
    ks = np.geomspace(1e-4, 1e2, 384)
    base = 2e4 * (ks / 0.02) / (1.0 + (ks / 0.02) ** 2.6)
    pk_ells = {0: 1.4 * base, 2: 0.7 * base, 4: 0.06 * base}
    ss_win = np.geomspace(0.1, 3e3, 200)
    q_ells = {0: np.exp(-ss_win / 900.0), 2: -0.1 * (ss_win / 2e3) ** 2
              * np.exp(-ss_win / 900.0)}
    ks_out = np.geomspace(0.005, 0.5, 20)
    want = _jit(lambda p, q: jro.window_convolve_multipoles(
        ks, p, ss_win, q, ks_out=ks_out), pk_ells, q_ells)
    got = tro.window_convolve_multipoles(
        ks, {k: T(v) for k, v in pk_ells.items()}, ss_win,
        {k: T(v) for k, v in q_ells.items()}, ks_out=ks_out)
    for ell in (0, 2, 4):
        assert _close(got[ell], want[ell]) <= GATE, ell


# ---- the class methods --------------------------------------------------------------

@pytest.fixture(scope="module")
def cosmos(_jax_refs):
    return (_jax_refs["jc"], tcos.Cosmology(PARAMS, device="cpu"))


@pytest.mark.parametrize("ir_resum", [False, True])
def test_P_mm_1loop_matches_jax(cosmos, _jax_refs, ir_resum):
    _, tc = cosmos
    kw = dict(LOOP, ir_resum=ir_resum)
    want = _jax_refs["a"].result()["p1loop", ir_resum]
    got = tc.P_mm_1loop(ZS, KS, **kw)
    assert got.shape == (ZS.size, KS.size)
    assert _close(got, want) <= GATE


@pytest.mark.parametrize("model", ["kaiser", "scoccimarro", "tns"])
def test_get_rsd_multipoles_matches_jax(cosmos, _jax_refs, model):
    _, tc = cosmos
    ks, kw, sv = _multipole_case(model)
    want = _jax_refs["b"].result()["multipoles", model]
    got = tc.get_rsd_multipoles(T(ZS), T(ks), **sv, **kw)
    for ell in (0, 2, 4):
        for g, w in ((got[ell], want[ell]),):
            assert g.shape == (ZS.size, ks.size)
            err = (_tns_close(g, w, ks) if model == "tns"
                   else _close(g, w) / GATE)
            assert err <= 1.0, (ell, err)
    with pytest.raises(ValueError, match="model"):
        tc.get_rsd_multipoles(ZS, ks, model="lpt")


def test_galaxy_rsd_multipoles_match_jax(cosmos):
    """The last method of HaloModel.DEFERRED, TNS over the model's ks (to
    k = 100/Mpc) and Kaiser on given ks, against the JAX class's
    get_rsd_multipoles fed with the instance's own HOD bias b_g(z) (held
    against the JAX package by tests/test_torch_hod.py), as the JAX
    HaloModel method feeds it."""
    jc, _ = cosmos
    th = thm.HaloModel(ZS, HKS, ms=MS, params=PARAMS, device="cpu")
    th.add_hod("g", ngal=np.full(ZS.size, 1e-4))
    assert thm.DEFERRED == {}
    bg = _np(th.hods["g"]["bg"])
    kw = dict(LOOP, n_mu=16)
    want = (_jit(lambda: jc.get_rsd_multipoles(ZS, HKS, b=bg, **kw)),
            _jit(lambda: jc.get_rsd_multipoles(ZS, KS, b=bg,
                                               model="kaiser")))
    got = (th.get_galaxy_rsd_multipoles("g", **kw),
           th.get_galaxy_rsd_multipoles("g", ks=KS, model="kaiser"))
    for ell in (0, 2, 4):
        assert got[0][ell].shape == (ZS.size, HKS.size)
        assert _tns_close(got[0][ell], want[0][ell], HKS) <= 1.0, ell
        assert _close(got[1][ell], want[1][ell]) <= GATE, ell


GRAD_KW = dict(n_q=32, n_x=16, n_q13=64)


def _jax_p1loop_jvp():
    """The formula of Cosmology.P_mm_1loop on the JAX package's free
    functions (its class reads omch2 back to the host) and its forward
    derivative in omch2."""
    ks_tab = np.geomspace(1e-5, 1e3, 1200)
    kw = GRAD_KW

    def jax_fn(x):
        bg = jbg.background(jpar.merge_params({**PARAMS, "omch2": x}))
        eng = jlp.make_engine("eh")
        pk0 = eng.plin(bg, jnp.zeros(1), jnp.asarray(ks_tab))[0]
        loops0 = (jspt.p22(KS, ks_tab, pk0, n_q=kw["n_q"], n_x=kw["n_x"],
                           qmin=1e-4, qmax=1e2)
                  + jspt.p13(KS, ks_tab, pk0, n_q=kw["n_q13"], qmin=1e-4,
                             qmax=1e2))
        D = jbg.d_growth(bg, 1.0 / (1.0 + jnp.asarray(ZS)))
        D0 = jbg.d_growth(bg, jnp.asarray(1.0))
        return (eng.plin(bg, jnp.asarray(ZS), jnp.asarray(KS))
                + ((D / D0) ** 4)[:, None] * loops0[None, :])

    return _jit(lambda x: jax.jvp(jax_fn, (x,), (1.0,)),
                jnp.asarray(PARAMS["omch2"]))


def test_P_mm_1loop_gradient_matches_jax_jvp(_jax_refs):
    """d/d(omch2) of Cosmology.P_mm_1loop (the linear table, the loops and
    the growth all move) against JAX's forward mode of the same formula
    on the JAX package's free functions (its class reads omch2 back to
    the host)."""
    x0 = PARAMS["omch2"]
    kw = GRAD_KW
    want, dwant = _jax_refs["a"].result()["grad"]
    x = torch.tensor(x0, dtype=torch.float64, requires_grad=True)
    got = tcos.Cosmology({**PARAMS, "omch2": x}, device="cpu").P_mm_1loop(
        ZS, KS, **kw)
    assert _close(got, want) <= GATE
    # reverse mode: the sum of the elements' derivatives
    (dgot,) = torch.autograd.grad(got, x, torch.ones_like(got))
    assert abs(float(dgot) / float(np.sum(dwant)) - 1.0) <= 1e-8
    # forward mode: each element's derivative
    _, jac = torch.func.jvp(
        lambda t: tcos.Cosmology({**PARAMS, "omch2": t},
                                 device="cpu").P_mm_1loop(ZS, KS, **kw),
        (x.detach(),), (torch.ones((), dtype=torch.float64),))
    assert _close(jac, dwant) <= 1e-8
