"""The JAX side of the PyTorch port's tests: a pipeline of the JAX package
and its Jacobian from one compile.

Imported by the tests/test_torch_*.py files that hold a whole pipeline
against the JAX package; those that also run on a card without JAX import
it inside their ``try: import jax`` block."""

import jax
import jax.numpy as jnp
import numpy as np


def jax_jvp(fn, names):
    """The JAX package's fn(overrides) as jvp(theta, tangent) over the
    named parameters, compiled once: each call gives fn at theta and its
    derivative along the tangent (a unit tangent gives one column of
    jacfwd's Jacobian, as hmvec_tpu.pipeline.fisher_jacobian takes it).
    A traced w0/wa takes the integrated growth, as growth='auto' does for
    a w0/wa override or derivative."""
    return jax.jit(lambda t, v: jax.jvp(
        lambda x: fn(dict(zip(names, x))), (t,), (v,)))


def jvp_value(jvp, theta):
    """fn at theta from a ``jax_jvp`` product (a zero tangent)."""
    return jvp(jnp.asarray(theta), jnp.zeros(len(theta)))[0]


def jacobian_columns(jvp, theta, n):
    """The Jacobian at theta over its first n parameters: a list with one
    (..., n) array per output of fn."""
    cols = [jvp(jnp.asarray(theta), jnp.asarray(e))[1]
            for e in np.eye(len(theta))[:n]]
    cols = [c if isinstance(c, (tuple, list)) else (c,) for c in cols]
    return [np.stack([np.asarray(c[i]) for c in cols], axis=-1)
            for i in range(len(cols[0]))]
