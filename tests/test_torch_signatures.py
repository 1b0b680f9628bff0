"""PyTorch port, the call signatures: every public function of each port
module that has a counterpart of the same name in the JAX package's module
of the same path (and every public method of a class both modules define)
takes the JAX function's parameter names, in the JAX function's order.

What may differ, each on an explicit list:
  * the TPU knobs the port drops on purpose (``DROPPED``: compile and
    precision switches of the TPU program, and flatsky's ``key``, a
    ``torch.Generator`` in the port);
  * the parameters only the port has (``PORT_ONLY``: the device a call
    runs on, the growth table a call shares, a JAX-made initial net);
  * the one function the port renames (``RENAMED``).
The multi-device layer, parallel/sharding.py, is held the same way, and
to the JAX module's nine public names.
"""

import importlib
import inspect
import pkgutil

import pytest

import hmvec_tpu_torch

DROPPED = {"jit", "unroll", "fast_assembly", "fast_f32", "compute_dtype",
           "matmul", "mixed_chunks", "dt", "as_jax"}
DROPPED_IN = {"hmvec_tpu_torch.models.flatsky": {"key"}}
PORT_ONLY = {
    "device": "the device a call runs on (the card by default)",
    "devices": "make_mesh's slots given explicitly (a card repeated, or "
               "the CPU)",
    "growth_table": "the integrated-growth table one call shares",
    "init_net": "fit_emulator's initial net (the JAX package's own, for "
                "one)",
    "generator": "flatsky's torch.Generator, in place of a jax.random key",
}
RENAMED = {("hmvec_tpu_torch.utils.profiling", "torch_trace"): "xla_trace"}
SHARDING_NAMES = ("make_mesh", "make_sharded_pmm_fn",
                  "make_sharded_galaxy_electron_fn", "make_fisher_step_fn",
                  "make_sharded_batched_fn", "make_sharded_ksz_survey_fn",
                  "sharded_solve_perturbations", "sharded_cls_from_sources",
                  "make_sharded_matter_bispectrum_fn")
MODULES = ["hmvec_tpu_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(hmvec_tpu_torch.__path__,
                                          "hmvec_tpu_torch."))


def _jax_module(name):
    try:
        return importlib.import_module(
            name.replace("hmvec_tpu_torch", "hmvec_tpu", 1))
    except ModuleNotFoundError:
        return None


def _params(fn):
    try:
        return list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return None


def _pairs(tmod, jmod):
    """(label, port callable, JAX callable) for every public function of
    tmod defined there, its renamed ones, and the public methods (and
    __init__) of the classes tmod defines, that jmod also has (a class of
    the JAX package's own)."""
    for attr, obj in vars(tmod).items():
        jname = RENAMED.get((tmod.__name__, attr), attr)
        if attr.startswith("_") or getattr(obj, "__module__", None) \
                != tmod.__name__:
            continue
        jobj = getattr(jmod, jname, None)
        if inspect.isfunction(obj) and callable(jobj):
            yield attr, obj, jobj
        elif inspect.isclass(obj) and inspect.isclass(jobj) \
                and jobj.__module__.startswith("hmvec_tpu"):
            for meth, f in vars(obj).items():
                jf = getattr(jobj, meth, None)
                if (meth == "__init__" or not meth.startswith("_")) \
                        and inspect.isfunction(f) and callable(jf):
                    yield f"{attr}.{meth}", f, jf


def _mismatch(module, tp, jp):
    """Why the port's parameter names tp do not stand for the JAX
    function's jp, or None."""
    dropped = DROPPED | DROPPED_IN.get(module, set())
    want = [p for p in jp if p not in dropped]
    missing = [p for p in want if p not in tp]
    extra = [p for p in tp if p not in jp and p not in PORT_ONLY]
    if missing or extra:
        return f"missing {missing}, not in the JAX function {extra}"
    if [p for p in tp if p in want] != want:
        return f"order {tp} against {jp}"
    return None


@pytest.mark.parametrize("module", MODULES)
def test_parameter_names_match_jax(module):
    tmod = importlib.import_module(module)
    jmod = _jax_module(module)
    if jmod is None:
        # a module of the port alone (the kernels' wrappers and their build)
        assert module.endswith(("_kernels", "_build", ".kernels")), module
        return
    bad = {}
    for label, f, jf in _pairs(tmod, jmod):
        tp, jp = _params(f), _params(jf)
        if tp is not None and jp is not None:
            why = _mismatch(module, tp, jp)
            if why:
                bad[label] = why
    assert not bad, bad


def test_the_exceptions_are_used():
    """Each dropped knob, port-only parameter and rename is still needed
    somewhere: a list entry that nothing uses would hide a new mismatch."""
    used = set()
    for module in MODULES:
        jmod = _jax_module(module)
        if jmod is None:
            continue
        for label, f, jf in _pairs(importlib.import_module(module), jmod):
            tp, jp = _params(f), _params(jf)
            if tp is None or jp is None:
                continue
            used |= {p for p in jp if p not in tp}
            used |= {p for p in tp if p not in jp}
            if f.__name__ != getattr(jf, "__name__", f.__name__):
                used.add(f.__name__)
    assert DROPPED | set().union(*DROPPED_IN.values()) <= used, \
        (DROPPED | set().union(*DROPPED_IN.values())) - used
    assert set(PORT_ONLY) <= used, set(PORT_ONLY) - used
    assert "torch_trace" in used


def test_sharding_exports_the_jax_modules_public_names():
    from hmvec_tpu.parallel import sharding as jsh
    from hmvec_tpu_torch.parallel import sharding as tsh

    public = {n for n, v in vars(jsh).items() if not n.startswith("_")
              and inspect.isfunction(v) and v.__module__ == jsh.__name__}
    assert public == set(SHARDING_NAMES)
    for name in SHARDING_NAMES:
        assert inspect.isfunction(getattr(tsh, name)), name
        assert _mismatch(tsh.__name__, _params(getattr(tsh, name)),
                         _params(getattr(jsh, name))) is None, name
    assert set(tsh.__all__) == set(SHARDING_NAMES) | {"Mesh"}


# ---- the repaired signatures against the JAX functions (ROADMAP C16) -------

def test_power_total_takes_large_scale_biases_as_jax_does():
    """power_total(b1_in=, b2_in=) passes each leg's large-scale bias to
    the 2-halo term, as the JAX package's does: 1e-12 on random tables."""
    import jax.numpy as jnp
    import numpy as np
    import torch
    from hmvec_tpu.models import power as jpw
    from hmvec_tpu_torch.models import power as tpw

    rng = np.random.default_rng(16)
    nz, nm, nk = 3, 12, 9
    ms = np.geomspace(1e11, 1e15, nm)
    ks = np.geomspace(1e-3, 5.0, nk)
    nzm, bh = rng.uniform(0.1, 1.0, (2, nz, nm))
    pzk = rng.uniform(1e2, 1e4, (nz, nk))
    u1, u2 = rng.uniform(0.2, 1.0, (2, nz, nm, nk))
    b1, b2 = rng.uniform(1.0, 3.0, (2, nz))
    args = (nzm, bh, ms, ks, pzk, np.float64(8.5e10))
    for kw in ({}, {"b1_in": b1}, {"b2_in": b2}, {"b1_in": b1, "b2_in": b2}):
        want = np.asarray(jpw.power_total(
            jpw.MatterTracer(uk=jnp.asarray(u1)),
            jpw.MatterTracer(uk=jnp.asarray(u2)),
            *(jnp.asarray(a) for a in args), 0.01,
            **{k: jnp.asarray(v) for k, v in kw.items()}))
        got = tpw.power_total(
            tpw.MatterTracer(uk=torch.as_tensor(u1)),
            tpw.MatterTracer(uk=torch.as_tensor(u2)),
            *(torch.as_tensor(a) for a in args), 0.01,
            **{k: torch.as_tensor(v) for k, v in kw.items()}).numpy()
        assert np.max(np.abs(got / want - 1.0)) <= 1e-12, kw


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_trapz_and_gradient_take_axis_as_jax_does(axis):
    import jax.numpy as jnp
    import numpy as np
    import torch
    from hmvec_tpu.ops import quadrature as jq
    from hmvec_tpu_torch.ops import quadrature as tq

    rng = np.random.default_rng(17)
    y = rng.standard_normal((7, 7))
    x = np.sort(rng.uniform(0.0, 2.0, 7))
    got = tq.trapz(torch.as_tensor(y), x, axis=axis).numpy()
    assert np.max(np.abs(got - np.asarray(jq.trapz(jnp.asarray(y), x,
                                                   axis=axis)))) <= 1e-13
    got = tq.gradient(torch.as_tensor(y), torch.as_tensor(x),
                      axis=axis).numpy()
    want = np.asarray(jq.gradient(jnp.asarray(y), jnp.asarray(x), axis=axis))
    assert np.max(np.abs(got - want)) <= 1e-12
