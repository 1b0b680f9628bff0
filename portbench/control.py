"""The control of a cell's check: the configuration's reference, computed
one precision below the configuration's (its ``control``), put in the
program's place, on the rows a run of ``calls`` calls would check.  It has
to come out as not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--calls N] [--control precision|stages]

prints, per seed, each number the check compares (the widest relative gap
of the control against the reference, over the whole output and over its
low-k band) beside its limit, and exits 1 if the control passes the check
on any seed.  ``precision`` lowers every stage one step (float32, u(k)
bfloat16); ``stages`` lowers only the stages and mass integrals, stated in
float64, to float32, and leaves u(k) in the float32 it is stated in.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the controls, by the reference's function that computes each
CONTROLS = {"precision": "control", "stages": "control_stages"}


def control_errors(bench, cell_name, seed, n_calls, config=None,
                   traffic=None, kind="precision"):
    """The per-row gaps (whole output, low-k band) of the control ``kind``
    on the rows a run of n_calls calls with this seed checks."""
    from portbench.lib import harness
    from portbench.lib import traffic as traffic_mod

    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    cfg = config or harness.load_json("configs", cell["config"])
    spec = traffic or harness.load_json("traffic", cell["traffic"])
    reference = harness.load_module("reference", cfg["reference"])
    _, call_rng, check_rng = traffic_mod.streams(seed, 3)
    calls = traffic_mod.Traffic(spec, call_rng)
    checker = harness.Checker(calls.batch, int(spec["check_rows_per_quarter"]),
                              check_rng)
    index = list(range(calls.batch))
    for _ in range(n_calls):
        checker.on_call(calls.next_batch(), index)
    control = getattr(reference, CONTROLS[kind])
    rows = [(theta, control(calls.row(theta), cfg))
            for theta, _ in checker.rows()]
    return harness.compare(rows, reference, cfg, calls.row), cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--control", choices=sorted(CONTROLS),
                    default="precision")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.lib import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    passed = False
    for seed in args.seeds:
        errs, cfg = control_errors(bench, args.workload, seed, args.calls,
                                   kind=args.control)
        limits = harness.limits_of(cfg)
        worst = [max(e[i] for e in errs) for i in range(len(limits))]
        correct = all(w <= lim for w, lim in zip(worst, limits))
        passed |= correct
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control,
                          **{name: {"value": w, "limit": lim} for name, w, lim
                             in zip(harness.CHECKED, worst, limits)},
                          "correct": correct}))
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
