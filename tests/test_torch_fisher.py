"""PyTorch port, differentiation of the Pmm pipeline: the forward-mode
fisher_jacobian against the JAX package's, and reverse-mode gradients
through the plain path and through the kernels' autograd.Functions."""

import numpy as np
import pytest
import torch

from _torch_jax import jacobian_columns, jax_jvp
from hmvec_tpu import pipeline as jpipe
from hmvec_tpu_torch import pipeline as tpipe

ZS = np.linspace(0.1, 2.0, 4)
MS = np.geomspace(2e10, 1e17, 64)[::4]   # test_pipeline.py's jacobian grid
KS = np.geomspace(1e-4, 100, 128)[::4]
P0 = {"omch2": 0.1198, "As": 2.2e-9}
NAMES = ("omch2", "As")


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def torch_jac():
    fn = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu")
    return tpipe.fisher_jacobian(fn, P0, NAMES, device="cpu").numpy()


def test_fisher_jacobian_matches_jax(torch_jac):
    """Forward mode on both sides, float64: <= 1e-8 relative."""
    jfn = jpipe.make_pmm_fn(ZS, KS, MS, jit=False, growth="closed")
    want, = jacobian_columns(jax_jvp(jfn, NAMES), [P0[k] for k in NAMES], 2)
    assert torch_jac.shape == want.shape == (ZS.size, KS.size, 2)
    assert np.all(np.isfinite(torch_jac))
    assert np.max(np.abs(torch_jac / want - 1.0)) <= 1e-8


@pytest.mark.parametrize("kw", [{"fast": "exact"}, {"fast": True},
                                {"fused_serving": True}],
                         ids=["exact", "fast", "fused"])
def test_kernel_paths_differentiate_like_plain(torch_jac, kw):
    """Through the kernels' autograd.Functions (their jvp recomputes the
    plain version's partials): the same jacobian to <= 1e-10."""
    fn = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu", **kw)
    jac = tpipe.fisher_jacobian(fn, P0, NAMES, device="cpu").numpy()
    assert np.max(np.abs(jac / torch_jac - 1.0)) <= 1e-10


@pytest.mark.parametrize("kw", [{}, {"fast": "exact"},
                                {"fused_serving": True}],
                         ids=["plain", "exact", "fused"])
def test_reverse_gradient_matches_forward(torch_jac, kw):
    """d sum(Pmm) / d omch2 by reverse mode equals the jacobian's column
    sum (test_pipeline.py::test_pipeline_grad's check, made exact)."""
    fn = tpipe.make_pmm_fn(ZS, KS, MS, device="cpu", **kw)
    om = torch.tensor(P0["omch2"], dtype=torch.float64, requires_grad=True)
    g, = torch.autograd.grad(fn({"omch2": om, "As": P0["As"]}).sum(), om)
    want = torch_jac[..., 0].sum()
    assert np.isfinite(float(g)) and float(g) != 0.0
    assert abs(float(g) / want - 1.0) <= 1e-10
