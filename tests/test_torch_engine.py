"""PyTorch port, the linear-power engines: ``TabulatedEngine`` (every
accuracy tier, the nonlinear table, extrapolation beyond the table in k
and z, a one-z table) against the JAX package's at 1e-12, ``make_engine``,
and ``engine=`` on every ``make_*_fn``, with ``make_pmm_fn`` on a table
against the JAX pipeline at 1e-10.  Tables are made by numpy from a
seed."""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hmvec_tpu import pipeline as jpipe
from hmvec_tpu.models import background as jbg
from hmvec_tpu.models import linear_power as jlp
from hmvec_tpu.params import merge_params as jmerge
from hmvec_tpu_torch import pipeline as tpipe
from hmvec_tpu_torch.models import background as tbg
from hmvec_tpu_torch.models import linear_power as tlp
from hmvec_tpu_torch.params import merge_params

ZS = np.linspace(0.1, 3.0, 3)
MS = np.geomspace(2e10, 1e17, 24)
KS = np.geomspace(1e-4, 100, 64)
RNG = np.random.default_rng(23)
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


def _table(nz=12):
    """A (z, k) table shaped like a linear power spectrum (k^ns on large
    scales, k^(ns-4) ln^2 k on small ones, a growth-like fall in z) with a
    random ripple, on an uneven z grid."""
    zs_t = np.sort(RNG.uniform(0.0, 4.0, nz)) if nz > 1 else np.array([0.5])
    ks_t = np.geomspace(1e-5, 300.0, 200)
    q = ks_t / 0.015
    shape = 2e4 * q**0.965 * np.log(np.e + 1.8 * q) ** 2 / (1.0 + q**2) ** 2
    p = shape[None, :] / (1.0 + zs_t[:, None]) ** 2
    return zs_t, ks_t, p * (1.0 + 0.05 * RNG.standard_normal(p.shape))


def _bgs(ov=None):
    ov = ov or {}
    return (tbg.background({**merge_params(), **ov}, "cpu"),
            jbg.background({**jmerge(), **ov}))


@pytest.mark.parametrize("nz", (12, 1))
def test_tabulated_engine_matches_jax(nz):
    """plin at 'high', 'medium', 'low' and pzk_grid on the linear and the
    nonlinear table, at z and k inside, below and beyond the table."""
    zs_t, ks_t, p_t = _table(nz)
    teng = tlp.TabulatedEngine(zs_t, ks_t, p_t, p_nl_t=1.5 * p_t)
    jeng = jlp.TabulatedEngine(zs_t, ks_t, p_t, p_nl_t=1.5 * p_t)
    ov = {"omch2": 0.125, "As": 2.05e-9, "as8": 1.02}
    tb = tbg.background({**merge_params(), **ov}, "cpu")
    zs = np.array([-0.2, 0.0, 0.37, 2.2, 4.0, 5.5])
    ks = np.concatenate([np.geomspace(1e-7, 1e-5, 3), ks_t[50:53],
                         np.geomspace(0.2, 3e3, 9)])

    @jax.jit
    def jax_side(zs, ks):
        jb = jbg.background({**jmerge(), **ov})
        return ([jeng.plin(jb, zs, ks, accuracy=acc)
                 for acc in ("high", "medium", "low")]
                + [jeng.pzk_grid(jb, zs, ks, nonlinear=nl)
                   for nl in (False, True)])

    want = jax_side(jnp.asarray(zs), jnp.asarray(ks))
    got = ([teng.plin(tb, T(zs), T(ks), accuracy=acc)
            for acc in ("high", "medium", "low")]
           + [teng.pzk_grid(tb, T(zs), T(ks), nonlinear=nl)
              for nl in (False, True)])
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-12
    assert teng.name == "tabulated"
    for t, j in zip(tlp._hermite_weights(T(0.3, dtype=torch.float64)),
                    jlp._hermite_weights(0.3)):
        assert abs(float(t) - float(j)) <= 1e-16


def test_make_engine():
    zs_t, ks_t, p_t = _table()
    assert isinstance(tlp.make_engine("eh"), tlp.EHEngine)
    assert isinstance(tlp.make_engine("class"), tlp.EHEngine)
    eng = tlp.make_engine("camb", pk_table=(zs_t, ks_t, p_t))
    assert isinstance(eng, tlp.TabulatedEngine)
    assert tlp.make_engine(eng) is eng
    # the boltzlite engine solves on the card unless asked for the CPU
    # (tests/test_torch_boltz_solve.py builds it there)
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            tlp.make_engine("boltz")
    with pytest.raises(ValueError):
        tlp.make_engine("halofit")
    with pytest.raises(ValueError):
        tlp.TabulatedEngine(zs_t, ks_t, p_t).pzk_grid(
            _bgs()[0], T(ZS), T(KS), nonlinear=True)


def test_every_factory_takes_engine():
    for name in ("make_pmm_fn", "make_electron_fn", "make_hod_fn",
                 "make_lensing_cls_fn", "make_ksz_snr_fn",
                 "make_ksz_survey_fn", "nfw_stage_inputs"):
        par = inspect.signature(getattr(tpipe, name)).parameters
        assert "engine" in par and par["engine"].default is None, name


def test_make_pmm_fn_on_a_table_matches_jax():
    """make_pmm_fn(engine=TabulatedEngine) at 'medium' and 'high'
    against the JAX pipeline on the same table: 1e-10; and engine=None is
    the analytic engine."""
    zs_t, ks_t, p_t = _table()
    ov = {"omch2": 0.117, "As": 2.1e-9}
    accs = ("medium", "high")
    jfns = [jpipe.make_pmm_fn(ZS, KS, MS, accuracy=acc, jit=False,
                              engine=jlp.TabulatedEngine(zs_t, ks_t, p_t))
            for acc in accs]
    want = jax.jit(lambda o: [f(o) for f in jfns])(
        {k: jnp.asarray(v) for k, v in ov.items()})
    for acc, w in zip(accs, want):
        got = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu", accuracy=acc,
                                engine=tlp.TabulatedEngine(zs_t, ks_t, p_t))
        assert _rel(got(ov), w) <= 1e-10
    eh = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu", engine=tlp.EHEngine())
    assert torch.equal(eh(ov), tpipe.make_pmm_fn(ZS, KS, MS,
                                                 device="cpu")(ov))
