"""hmvec_tpu_torch: the PyTorch / CUDA port of hmvec_tpu.

Module names mirror the JAX package (``hmvec_tpu_torch.models.profiles``
is the counterpart of ``hmvec_tpu.models.profiles``).  The port imports
torch, numpy and scipy, never jax.  Everything runs in float64 tensors on
one explicit device; the NFW profile stage and the resample step of the
numeric profile transform have hand-written CUDA kernels for Hopper
(``ops.nfw_kernels``, ``ops.resample_kernels``; sources in ``csrc/``),
built with nvcc at first use.

Entry points: ``hmvec_tpu_torch.pipeline.make_pmm_fn`` and
``make_electron_fn``.
"""
