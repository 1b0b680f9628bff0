"""PyTorch port, numeric base: parameters, coefficient tables, special
functions and quadrature, held against the JAX package on the CPU."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hmvec_tpu import params as jparams
from hmvec_tpu.ops import _hyp_coeffs as jhc
from hmvec_tpu.ops import _sici_coeffs as jsc
from hmvec_tpu.ops import special as jspecial
from hmvec_tpu.ops.quadrature import gradient as jgradient
from hmvec_tpu_torch import params as tparams
from hmvec_tpu_torch.kernels import _build
from hmvec_tpu_torch.ops import _hyp_coeffs as thc
from hmvec_tpu_torch.ops import _sici_coeffs as tsc
from hmvec_tpu_torch.ops import special as tspecial
from hmvec_tpu_torch.ops.quadrature import gradient as tgradient
from hmvec_tpu_torch.ops.quadrature import trapz as ttrapz

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def test_default_params_equal_jax():
    assert tparams.default_params == jparams.default_params
    assert tparams.battaglia_defaults == jparams.battaglia_defaults
    assert tparams.merge_params({"omch2": 0.11}) == \
        jparams.merge_params({"omch2": 0.11})


def test_to_torch_params():
    out = tparams.to_torch_params(
        {"omch2": 0.11, "As": np.float64(2e-9), "ns": np.asarray(0.96),
         "H0": torch.tensor(70.0, dtype=torch.float32),
         "sigma2_numks": 1250, "battaglia_gas_family": "AGN"}, "cpu")
    for key in ("omch2", "As", "ns", "H0"):
        assert out[key].dtype == F64 and out[key].device.type == "cpu"
    assert float(out["omch2"]) == 0.11 and float(out["As"]) == 2e-9
    assert out["sigma2_numks"] == 1250
    assert out["battaglia_gas_family"] == "AGN"
    # a tensor keeps its autograd history
    x = torch.tensor(0.12, dtype=F64, requires_grad=True)
    assert tparams.to_torch_params({"omch2": x}, "cpu")["omch2"] is x
    with pytest.raises(TypeError):
        tparams.to_torch_params({"omch2": object()}, "cpu")


@pytest.mark.parametrize("tmod, jmod", [(tsc, jsc), (thc, jhc)],
                         ids=["sici", "hyp"])
def test_coefficient_tables_bit_identical(tmod, jmod):
    names = [n for n in dir(jmod) if n.isupper()]
    assert names and names == [n for n in dir(tmod) if n.isupper()]
    for name in names:
        a, b = getattr(tmod, name), getattr(jmod, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), name
        else:
            assert a == b, name


def test_generated_cuda_header_round_trips_tables():
    """sici_coeffs.cuh is generated from the port's table copy.  For each
    precision, each of the three domains and both series it holds the
    power-series form (in the Chebyshev variable t) of the table cut at the
    precision's length for that domain (zeros after it): numpy's cheb2poly in float64, printed so that it
    parses back to that value exactly (float64) or to its float32 rounding
    (float32), and evaluated it gives the Chebyshev series to the
    precision's rounding.  Then both asymptotic tails and Euler's gamma."""
    import math
    import re

    from numpy.polynomial import chebyshev as C

    text = _build.sici_header()
    t = np.linspace(-1.0, 1.0, 2001)
    for ctype, dtype, lens, na in (("double", np.float64, (12, 17, 15), 13),
                                   ("float", np.float32, (16, 16, 16), 7)):
        n = max(lens)
        # the float64 tables sit in constant memory, ahead of their struct
        block = re.search(rf"struct SiciTables<{ctype}> {{(.*?)\n}};", text,
                          re.S).group(1)
        block += text[:text.index("struct SiciTables<double>")]
        ints = dict(re.findall(r"static constexpr int (\w+) = (\d+);", block))
        assert int(ints["nasy"]) == na
        assert re.search(r"static constexpr int len\[3\] = \{([0-9, ]+)\};",
                         block).group(1) == ", ".join(map(str, lens))
        tabs = {name: np.array([float(v) for v in re.findall(
                    r"[-+0-9.e]+", body.replace("{", " ").replace("}", " "))])
                for name, body in re.findall(
                    rf"static (?:constexpr|__constant__) {ctype} (\w+)\[[^=]*= "
                    rf"(\{{.*?\}});", block, re.S)}
        if dtype == np.float64:
            tabs["poly"] = tabs["kSiciPoly"]
            tabs["fasy"], tabs["gasy"] = tabs["kSiciAsy"].reshape(2, na)
        poly = tabs["poly"].reshape(2, 3, n)
        for s_, ab in enumerate("AB"):
            for d, length in enumerate(lens):
                table = np.asarray(getattr(tsc, f"SICI_{ab}{d}"))
                cheb = table[:length]
                want = C.cheb2poly(cheb).astype(dtype)
                got = poly[s_, d, :length]
                assert not poly[s_, d, length:].any()
                assert np.array_equal(got.astype(dtype), want)
                assert np.array_equal(got, want.astype(np.float64))
                err = np.abs(np.polynomial.polynomial.polyval(t, got)
                             - C.chebval(t, cheb)).max()
                assert err <= (1e-14 if dtype == np.float64 else 1e-6)
                # the terms left out are the fit's noise floor (float64)
                # or below float32's resolution
                cut = np.abs(C.chebval(t, cheb) - C.chebval(t, table)).max()
                assert cut <= (3e-14 if dtype == np.float64 else 1e-8)
        for name, first in (("fasy", 0), ("gasy", 1)):
            want = [(-1.0) ** i * math.factorial(2 * i + first)
                    for i in range(na)]
            assert np.array_equal(tabs[name],
                                  np.asarray(want, dtype).astype(np.float64))
    gamma = re.search(r"#define SICI_EULER_GAMMA (\S+)", text).group(1)
    assert float(gamma) == tsc.EULER_GAMMA


def test_sici_matches_jax():
    x = np.concatenate([np.geomspace(1e-6, 400.0, 3001),
                        [4.0, 4.0 + 1e-12, 10.0, 10.0 + 1e-12, 40.0,
                         40.0 + 1e-12]])
    si_t, ci_t = tspecial.sici(_t(x))
    # the JAX side compiled once (op by op it takes seconds)
    si_j, ci_j = jax.jit(jspecial.sici)(jnp.asarray(x))
    # absolute tolerance 1e-13: both evaluate the same tables in float64
    np.testing.assert_allclose(si_t.numpy(), np.asarray(si_j), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(ci_t.numpy(), np.asarray(ci_j), rtol=0,
                               atol=1e-13)


def test_hyp2f1_growth_matches_jax():
    y = np.concatenate([[0.0], np.geomspace(1e-8, 60.0, 2001)])
    got = tspecial.hyp2f1_growth(_t(y)).numpy()
    want = np.asarray(jax.jit(jspecial.hyp2f1_growth)(jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


def test_wkr_matches_jax():
    k = np.geomspace(1e-5, 1e3, 701)
    R = np.geomspace(0.05, 30.0, 9)
    got = tspecial.Wkr(_t(k)[None, :], _t(R)[:, None]).numpy()
    want = np.asarray(jspecial.Wkr(jnp.asarray(k)[None, :],
                                   jnp.asarray(R)[:, None]))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


def test_special_gradients_are_finite():
    x = torch.tensor([1e-8, 0.5, 4.0, 7.0, 25.0, 90.0], dtype=F64,
                     requires_grad=True)
    si, ci = tspecial.sici(x)
    gs, = torch.autograd.grad(si.sum() + ci.sum(), x)
    assert torch.isfinite(gs).all()
    # d Si / dx = sin x / x away from the domain seams
    np.testing.assert_allclose(
        torch.autograd.grad(tspecial.sici(x)[0].sum(), x)[0][1:].numpy(),
        (torch.sin(x) / x)[1:].detach().numpy(), rtol=1e-9, atol=1e-12)


def test_quadrature_matches_numpy_and_jax():
    rng = np.random.default_rng(4)
    x = np.sort(rng.uniform(0.0, 3.0, 41))
    f = rng.normal(size=(3, 41))
    np.testing.assert_allclose(tgradient(_t(f), _t(x)).numpy(),
                               np.asarray(jax.jit(jgradient)(
                                   jnp.asarray(f), jnp.asarray(x))),
                               rtol=1e-14, atol=1e-12)
    np.testing.assert_allclose(tgradient(_t(f), _t(x)).numpy(),
                               np.gradient(f, x, axis=-1), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(ttrapz(_t(f), x).numpy(),
                               np.trapezoid(f, x, axis=-1), rtol=1e-13,
                               atol=1e-14)


def test_port_imports_without_jax():
    """Every module of hmvec_tpu_torch, found by walking the package,
    imports with jax made unimportable, and none of them pulls in the JAX
    package."""
    code = ("import importlib, pkgutil, sys; sys.modules['jax'] = None; "
            "import hmvec_tpu_torch as p; "
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "'hmvec_tpu_torch.')]; "
            "[importlib.import_module(n) for n in names]; "
            "assert 'hmvec_tpu_torch.ops.resample_kernels' in names, names; "
            "assert not any(m == 'hmvec_tpu' or m.startswith('hmvec_tpu.') "
            "for m in sys.modules); print('ok', len(names))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.startswith("ok "), r.stderr
