"""How far H0 from theta100 moves with the 128-node Gauss-Legendre weights.

The background's distances integrate 1/E(z) with numpy's
``polynomial.legendre.leggauss(128)``, whose weights carry an error of
order 1e-10 that differs between numpy versions.  H0 from theta100 is
a bisection on theta(H0), which depends on the distance to z*, and
carries that error to H0 amplified by 1 / (dln theta / dln H0).  This
prints, as one JSON line:

  * numpy's version and the largest relative difference between its
    128-node weights and scipy's ``roots_legendre`` (exact to rounding);
  * the port's z*, r_s, chi(z*), D_A(z*) and theta at the golden file's H0
    and at H0 = 60 on the CPU (and on the card when there is one), and its
    H0 from theta100 (the extensions golden file's cosmology);
  * with ``--jax``: the JAX package's H0 from theta100 with numpy's
    weights and with scipy's, and their relative spread.

Run from the repository root (the ``--jax`` part needs the JAX package):

    python tools/theta100_spread.py [--jax]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "hmvec_tpu_torch" / "data" / "extensions_config1_golden.npz"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jax", action="store_true",
                    help="also solve with the JAX package on both weights")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import scipy.special
    import torch
    from hmvec_tpu_torch.models import background as bgmod
    from hmvec_tpu_torch.models import distances_ext as dx
    from hmvec_tpu_torch.params import merge_params

    g = np.load(GOLDEN)
    cosmo = dict(zip(g["param_names"].tolist(), map(float, g["param_values"])))
    theta100, h0_golden = float(g["theta100"]), float(g["h0_theta100"])
    _, w_np = np.polynomial.legendre.leggauss(128)
    _, w_sp = scipy.special.roots_legendre(128)
    out = {"numpy": np.__version__, "torch": torch.__version__,
           "weights_max_rel_diff": float(np.max(np.abs(w_np / w_sp - 1.0)))}
    p = merge_params(cosmo)
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    for dev in devices:
        for h0 in (h0_golden, 60.0):
            bg = bgmod.background({**p, "H0": h0}, torch.device(dev))
            zstar = dx.z_star_hu_sugiyama(bg)
            out[f"{dev} H0={h0!r}"] = {
                "zstar": float(zstar), "rs": float(dx.rs_drag_eh(bg)),
                "chi": float(bgmod.comoving_radial_distance(bg, zstar)),
                "da": float(bgmod.angular_diameter_distance(bg, zstar)),
                "theta": float(dx.theta_star_approx(bg))}
    h0_port = dx.solve_h0_from_theta100(p, theta100)
    out["h0_port"] = h0_port
    out["h0_golden"] = h0_golden
    out["h0_port_vs_golden"] = h0_port / h0_golden - 1.0
    if args.jax:
        import jax

        jax.config.update("jax_platforms", "cpu")
        from hmvec_tpu.models import background as jbg
        from hmvec_tpu.models import distances_ext as jdx
        from hmvec_tpu.params import merge_params as jmerge

        jp = jmerge(cosmo)
        h_np = jdx.solve_h0_from_theta100(jp, theta100)
        xs, ws = scipy.special.roots_legendre(128)
        saved = jbg._GL_NODES, jbg._GL_WEIGHTS
        jbg._GL_NODES, jbg._GL_WEIGHTS = (xs + 1.0) / 2.0, ws / 2.0
        try:
            h_sp = jdx.solve_h0_from_theta100(jp, theta100)
        finally:
            jbg._GL_NODES, jbg._GL_WEIGHTS = saved
        out["jax_h0_numpy_weights"] = h_np
        out["jax_h0_scipy_weights"] = h_sp
        out["jax_h0_spread"] = h_sp / h_np - 1.0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
