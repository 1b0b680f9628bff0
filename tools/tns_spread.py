"""The rounding spread of the TNS A/B integrals, per k: the port against
the JAX package, and the JAX package against itself under two
evaluation orders (one compiled program, where XLA fuses multiply-adds
and turns divisions by constants into products, against op-by-op
evaluation).  The reduced A/B kernels cancel catastrophically (their
terms grow like r^10 at r = q/k ~ 1e3 while the sum stays O(1)), so
their integrals at the lowest ks carry the rounding of whichever order
evaluates them; this script measures how much.

    JAX_PLATFORMS=cpu python tools/tns_spread.py [--nk 20] [--n-q 64]
        [--n-x 32] [--n-mu 16]

Prints, per k, the largest relative difference over the A and B
integrals and over the TNS multipoles (b = 2, f = 0.7, sigma_v = 3 Mpc)
for port vs JAX (compiled) and JAX (op by op) vs JAX (compiled).  CPU
only; about a minute at the defaults.
"""

import argparse
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402
from hmvec_tpu.models import cosmology as jcos  # noqa: E402
from hmvec_tpu.models import spt as jspt  # noqa: E402
from hmvec_tpu.models import tns as jtns  # noqa: E402
from hmvec_tpu_torch.models import tns as ttns  # noqa: E402


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-300)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nk", type=int, default=20)
    ap.add_argument("--n-q", type=int, default=64)
    ap.add_argument("--n-x", type=int, default=32)
    ap.add_argument("--n-mu", type=int, default=16)
    a = ap.parse_args()
    torch.set_num_threads(2)
    cosmo = jcos.Cosmology({"omch2": 0.1198, "As": 2.2e-9})
    kt = np.geomspace(1e-5, 1e3, 1200)
    pt = np.asarray(cosmo.P_lin(jnp.asarray(kt), np.array([0.0]))[0])
    ks = np.geomspace(1e-4, 100.0, a.nk)
    kw = dict(n_q=a.n_q, n_x=a.n_x, qmin=1e-4, qmax=1e2)

    def ab():
        return jtns.tns_ab_integrals(ks, kt, pt, **kw)

    jit = jax.jit(ab)()
    with jax.disable_jit():
        eager = ab()
    port = ttns.tns_ab_integrals(ks, kt, torch.as_tensor(pt), **kw)
    pv = jax.jit(lambda: jspt.pk_velocity_1loop(ks, kt, pt, n_q13=2 * a.n_q,
                                                **kw))()

    def mp(abd, lib):
        if lib == "torch":
            p = {k: torch.as_tensor(np.asarray(v)) for k, v in pv.items()}
            m = ttns.tns_multipoles(ks, p["dd"], p["dt"], p["tt"], 2.0, 0.7,
                                    abd, sigma_v=3.0, n_mu=a.n_mu)
            return {k: v.numpy() for k, v in m.items()}
        m = jtns.tns_multipoles(ks, pv["dd"], pv["dt"], pv["tt"], 2.0, 0.7,
                                abd, sigma_v=3.0, n_mu=a.n_mu)
        return {k: np.asarray(v) for k, v in m.items()}

    def worst_ab(x, y):
        return np.max([_rel(_np(x[t][key]), y[t][key])
                       for t in "AB" for key in y[t]], axis=0)

    def worst_mp(x, y):
        return np.max([_rel(x[ell], y[ell]) for ell in y], axis=0)

    _np = lambda v: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    mjit = mp(jit, "jax")
    rows = [("A/B port vs jit", worst_ab(port, jit)),
            ("A/B eager vs jit", worst_ab(eager, jit)),
            ("P_l port vs jit", worst_mp(mp(port, "torch"), mjit)),
            ("P_l eager vs jit", worst_mp(mp(eager, "jax"), mjit))]
    print("k [1/Mpc]        " + " ".join(f"{k:9.2e}" for k in ks))
    for name, row in rows:
        print(f"{name:17s}" + " ".join(f"{v:9.1e}" for v in row))


if __name__ == "__main__":
    main()
