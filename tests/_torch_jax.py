"""The JAX side of the PyTorch port's tests: a pipeline of the JAX package
and its Jacobian from one compile.

Imported by the tests/test_torch_*.py files that hold a whole pipeline
against the JAX package; those that also run on a card without JAX import
it inside their ``try: import jax`` block.  ``JaxSubprocess`` runs a
script of JAX programs in a fresh process of its own."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch


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


class JaxSubprocess:
    """A script of tests/ run by a fresh Python process in the background,
    for the JAX programs that a test process must not compile (XLA:CPU
    crashes natively on large ones once a process holds a few hundred
    compiled programs, tests/_isolation.py): ``start`` launches it,
    ``wait`` waits for it, runs it once more if it died of a native
    crash, as ``_isolation.run_isolated`` does, and raises on any other
    failure."""

    def __init__(self, script, *args, timeout=600):
        here = pathlib.Path(__file__).resolve().parent
        self.cmd = [sys.executable, str(here / script), *map(str, args)]
        self.env = dict(os.environ)
        self.env["PYTHONPATH"] = (str(here.parent) + os.pathsep
                                  + self.env.get("PYTHONPATH", ""))
        self.cwd = str(here.parent)
        self.timeout = timeout
        self.proc = None

    def start(self):
        self.proc = subprocess.Popen(
            self.cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=self.cwd, env=self.env)
        return self

    def wait(self):
        for attempt in (1, 2):
            try:
                out, _ = self.proc.communicate(timeout=self.timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.communicate()
                raise
            rc = self.proc.returncode
            if rc == 0:
                return
            crashed = rc < 0 or "Fatal Python error" in out
            if not crashed or attempt == 2:
                raise AssertionError(f"{self.cmd[1:]} rc={rc} (attempt "
                                     f"{attempt})\n{out[-4000:]}")
            self.start()

    def kill(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def jax_halo_model_of(th, params=None):
    """The JAX package's HaloModel on a port instance's grids, holding the
    port instance's tables (linear power, sigma^2, n(z, m), b(z, m), the
    profiles u(k) and <u^2>, the HOD grids), for a test of what reads
    those tables.  It is made by the JAX Cosmology constructor (at
    ``params``) and these tables, not by the HaloModel constructor, whose
    stages run op by op and compile each operation on first use (seconds);
    the tables themselves are held against the JAX class by
    tests/test_torch_halo_model.py."""
    from hmvec_tpu.models import cosmology as jcos
    from hmvec_tpu.models import halo_model as jhm

    def arr(x):
        return jnp.asarray(x.detach().cpu().numpy())

    hm = object.__new__(jhm.HaloModel)
    jcos.Cosmology.__init__(hm, params=params)
    hm.mdef, hm.mode, hm.concmode = th.mdef, th.mode, th.concmode
    hm.tinker_delta = th.tinker_delta
    for key in ("zs", "ks", "ms", "Pzk", "sigma2", "nzm", "bh"):
        setattr(hm, key, arr(getattr(th, key)))
    hm.uk_profiles = {k: arr(v) for k, v in th.uk_profiles.items()}
    hm.uk2_profiles = {k: arr(v) for k, v in th.uk2_profiles.items()}
    hm.pk_profiles = {k: arr(v) for k, v in th.pk_profiles.items()}
    hm.cib_tracers = {}
    hm.hods = {name: {**{k: arr(v) for k, v in h.items()
                         if isinstance(v, torch.Tensor)},
                      "satellite_profile": h["satellite_profile"],
                      "central_profile": h["central_profile"]}
               for name, h in th.hods.items()}
    return hm


def compiled(jvp, theta):
    """A ``jax_jvp`` product after one call at theta, which compiles it:
    a task for a worker thread (see ``Prefetch``)."""
    jvp_value(jvp, theta)
    return jvp


class Prefetch:
    """JAX references computed by worker threads from a test module's
    start, while its torch side runs in the main thread: XLA compiles
    without holding the GIL, so two compiles, or a compile and the torch
    side, overlap instead of running one after the other.  ``submit``
    schedules fn(*args) and returns its future (``result()`` raises what
    fn raised); ``close`` waits for every task."""

    def __init__(self, workers=2):
        import concurrent.futures
        self.pool = concurrent.futures.ThreadPoolExecutor(
            workers, thread_name_prefix="jax-reference")

    def submit(self, fn, *args, **kwargs):
        return self.pool.submit(fn, *args, **kwargs)

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)
