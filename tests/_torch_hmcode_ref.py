"""The JAX side of the HMcode tests of tests/test_torch_nonlinear.py, run in
a fresh process of its own:

    python tests/_torch_hmcode_ref.py OUT.npz

XLA:CPU crashes natively on HMcode programs once a process holds a few
hundred compiled programs (tests/_isolation.py), so the test process
compiles none of them: this script computes every HMcode reference of the
test file, at the shapes and inputs below, and writes them to OUT.npz.
The test file imports the constants of this module, which imports no
JAX at the top.
"""

import sys

import numpy as np

ZS = np.array([0.3, 1.5])
KS = np.geomspace(1e-3, 20.0, 40)
# massive neutrinos: the cold (cb) branch of the sigma machinery
PARAMS = {"omch2": 0.117, "As": 2.1e-9, "H0": 68.5, "mnu": 0.06}
# the integrated growth (and the Dolag factor), without neutrinos
ODE = {**PARAMS, "mnu": 0.0, "w0": -0.9, "wa": 0.2}
# key: (params, the class's halofit version, hmcode_power keywords); the
# keys that end in a value rerun their version at that A_bary or T_AGN
CASES = {
    "mead": (PARAMS, "mead", {}),
    "mead2015": (PARAMS, "mead2015", {"version": "2015"}),
    "mead2020": (PARAMS, "mead2020", {"version": "2020"}),
    "mead2020_feedback": (PARAMS, "mead2020_feedback",
                          {"version": "2020_feedback"}),
    "mead_A2.5": (PARAMS, None, {"A_bary": 2.5}),
    "feedback_logT8": (PARAMS, None, {"version": "2020_feedback",
                                      "logT_AGN": 8.0}),
    "ode_mead": (ODE, "mead", {}),
}
# (A_bary, log T_AGN) of the rerun, and which version each rerun key is
RERUN = (2.5, 8.0)
RERUN_OF = {"mead_A2.5": "mead", "feedback_logT8": "mead2020_feedback"}


def unit_inputs():
    """Inputs of the module's small functions, made from a seed."""
    rng = np.random.default_rng(17)
    kg = np.geomspace(1e-4, 1e3, 1536)
    shape = 2e4 * kg / (1.0 + (kg / 0.02) ** 2.6)
    delta2 = (shape[None, :] * kg[None, :] ** 3 / (2.0 * np.pi**2)
              * np.exp(rng.uniform(-0.1, 0.1, (2, kg.size))))
    return {
        "x": np.concatenate([[0.0, 1e-3, 0.049, 0.051],
                             rng.uniform(0.0, 30.0, 40)]),
        "nu": rng.uniform(0.1, 5.0, 30),
        "delta2": delta2,
        "R1": rng.uniform(0.5, 10.0, 2),
        "R2": rng.uniform(0.1, 20.0, (2, 5)),
    }


def main(out):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from hmvec_tpu.models import cosmology as jcos
    from hmvec_tpu.models import hmcode as jhm

    # the versions of one cosmology under one jax.jit, with A_bary and
    # log T_AGN as its arguments: one compile per cosmology, in which the
    # versions share their linear power and sigma machinery, run at the
    # defaults and (for PARAMS) again at RERUN
    res = {}
    for params in (PARAMS, ODE):
        cj = jcos.Cosmology(params)
        keys = [k for k, case in CASES.items()
                if case[0] is params and k not in RERUN_OF]
        run = jax.jit(lambda a_bary, logt: {
            k: jhm.hmcode_power(cj, ZS, KS, A_bary=a_bary, logT_AGN=logt,
                                **CASES[k][2]) for k in keys})
        res.update(run(3.13, 7.8))
        if params is PARAMS:
            again = run(*RERUN)
            res.update({k: again[v] for k, v in RERUN_OF.items()})
    u = unit_inputs()
    d2 = jnp.asarray(u["delta2"])
    res.update(jax.jit(lambda: {
        "xwprime": jhm._xwprime(jnp.asarray(u["x"])),
        "st_gnu": jhm._st_gnu(jnp.asarray(u["nu"])),
        "tophat1": jhm._tophat_moments(d2, jnp.asarray(u["R1"])),
        "tophat2": jhm._tophat_moments(d2, jnp.asarray(u["R2"])),
        "sigma_v2_0": jhm._sigma_v2(d2, 0.0),
        "sigma_v2_100": jhm._sigma_v2(d2, 146.0),
    })())
    flat = {}
    for key, val in res.items():
        if isinstance(val, tuple):
            for i, v in enumerate(val):
                flat[f"{key}_{i}"] = np.asarray(v)
        else:
            flat[key] = np.asarray(val)
    np.savez(out, **flat)


if __name__ == "__main__":
    main(sys.argv[1])
