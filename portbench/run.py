"""The benchmark of hmvec_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

reads ``BENCHMARK.json`` at the root of the checkout, runs the cell on the
first ``chips`` cards of this machine and prints one JSON line last on
standard output: with ``--trace 0`` the cell's end-to-end metrics over a
window of ``--seconds``, with ``--trace 1`` its per-layer metrics over a
profiled window of the traffic's ``trace_calls`` calls.  Either way the
window's outputs are checked against the configuration's reference, and
the numbers compared are printed beside their limits, last on standard
error and last in the result line.  Without the cards the cell asks for,
the run exits 2 and prints no result; it never falls back to the CPU.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / ".portbench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[var] = str(CACHE / sub)
# JAX and the JAX package are never loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "hmvec_tpu")


def forbidden_modules() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def power_limit_w():
    """The first card's power limit by nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}; the cells are "
              f"{sorted(cells)}", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from portbench.lib import harness

    result = harness.run(bench, args.workload, seed=args.seed,
                         seconds=args.seconds, trace=bool(args.trace),
                         devices=[f"cuda:{i}" for i in range(chips)],
                         t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"modules that must never load were loaded: {found}",
              file=sys.stderr)
        return 3
    result["device"]["power_limit_w"] = power_limit_w()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
