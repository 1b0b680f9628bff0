"""Measure the port's two serial integrators, K6 (recomb_rk4) and K7
(hierarchy_rk4), on a CUDA card, checkout against checkout.

    python3 tools/measure_torch_boltz.py --roots PARENT . . PARENT [--out F]

The inputs are the main path's, made once on the card by this checkout:
K6 on the recombination tables at n = 16,384 of the default cosmology (as
chip_smoke.py's boltz phase makes them), K7 on the four launches of
``Cosmology().get_cmb_cls(approx=True)`` at lmax 3,000 (192 / 192 / 191 /
1 rows, 1,500 / 4,200 / 6,080 / 3,283 steps), recorded with
chip_smoke.recorded(boltzlite, "hierarchy_rk4") from a call stopped right
after its solve (the sources, C_l and lensing that follow launch neither
kernel).  K6 is held against recomb_rk4_plain here, once.

For each checkout in the order given, one process builds that checkout's
csrc/boltz_kernels.cu (kernels/_build.py) and times, by CUDA events, one
call of each kernel at each shape, SAMPLES times after a warm-up call, in
turns (K6, K7 launch 1 .. 4, then again); it keeps each output and its
registers and spills (ptxas -v).  Give a parent and a change as parent,
change, change, parent (unpack the parent with git archive into the
git-ignored _trees/): all runs share the one card, the inputs and this
checkout's timing code.  Prints per checkout each shape's median and
spread, K7's four launches summed, and whether every checkout's outputs
equal the first checkout's bit for bit (torch.equal).

Run from the repository root on a machine with a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SAMPLES = 7


class _Stop(Exception):
    """Raised in place of the sources once the solve has run."""


def _chip_smoke():
    """This checkout's chip_smoke.py as a module (its helpers), whichever
    checkout's package is being measured."""
    spec = importlib.util.spec_from_file_location("chip_smoke_tools",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs(dev, cs_mod) -> dict:
    """{"recomb_rk4": args, "hierarchy_rk4": [args of each launch]} on the
    card, from this checkout's package."""
    sys.path.insert(0, str(ROOT))
    from hmvec_tpu_torch import Cosmology
    from hmvec_tpu_torch.models import background as bgmod
    from hmvec_tpu_torch.models import boltzlite as tbl
    from hmvec_tpu_torch.models import recomb as trec
    from hmvec_tpu_torch.params import merge_params

    bg = bgmod.background(merge_params({}), dev)
    xs = trec._linspace(-18.0, 0.0, 16384, dev)
    dx = xs[1] - xs[0]
    tab, sn, xe0 = trec.recomb_tables(bg, xs, dx)
    k6 = (tab[None].contiguous(), sn[None].contiguous(), xe0.reshape(1),
          float(dx))

    def stop(*args, **kw):
        raise _Stop

    real = tbl.compute_sources
    tbl.compute_sources = stop
    try:
        with cs_mod.recorded(tbl, "hierarchy_rk4") as segs:
            try:
                Cosmology(device=dev).get_cmb_cls(approx=True)
            except _Stop:
                pass
    finally:
        tbl.compute_sources = real
    torch.cuda.synchronize()
    if len(segs) != 4:
        raise RuntimeError(f"get_cmb_cls launched hierarchy_rk4 {len(segs)} "
                           "times before its sources, expected 4")
    return {"recomb_rk4": k6, "hierarchy_rk4": [tuple(a) for a in segs]}


def shape_of(name, args) -> str:
    if name == "recomb_rk4":
        return f"{args[0].shape[0]} x {args[0].shape[1]} steps"
    return f"{args[1].numel()} rows x {args[5] * args[6]} steps"


def time_root(root: pathlib.Path, inputs_path: pathlib.Path,
              outputs_path: pathlib.Path) -> dict:
    """Device times of the two kernels of the checkout at root (run in a
    process of its own) on the saved inputs; its outputs saved beside."""
    sys.path.insert(0, str(root))
    from hmvec_tpu_torch.kernels import _build
    from hmvec_tpu_torch.ops import boltz_kernels as bk

    cs_mod = _chip_smoke()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    inputs = torch.load(inputs_path, map_location=dev)
    calls = [("recomb_rk4", lambda a=inputs["recomb_rk4"]: bk.recomb_rk4(*a))]
    for n, a in enumerate(inputs["hierarchy_rk4"]):
        calls.append((f"hierarchy_rk4[{n}]",
                      lambda a=a: bk.hierarchy_rk4(*a)))
    outputs = {}
    for name, fn in calls:
        outputs[name] = fn()
    torch.cuda.synchronize()
    times = {name: [] for name, _ in calls}
    for _ in range(SAMPLES):
        for name, fn in calls:
            times[name].append(cs_mod.event_ms(fn, n=1, warmup=0))
    torch.save(outputs, outputs_path)
    res = cs_mod.ptxas_resources(_build.build_info.get("log", ""))
    resources = {name: res[name] for name in ("recomb_rk4_kernel",
                                              "hierarchy_rk4_kernel")
                 if name in res}
    return {"root": str(root), "card": cs_mod.card_line(), "times": times,
            "resources": resources}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--roots", nargs="+", type=pathlib.Path,
                        default=[pathlib.Path(".")])
    parser.add_argument("--out", help="write the results as JSON here")
    parser.add_argument("--time-root", nargs=3, type=pathlib.Path,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("measure_torch_boltz: needs a CUDA card", file=sys.stderr)
        return 2
    if args.time_root:
        print(json.dumps(time_root(*(p.resolve() for p in args.time_root))))
        return 0
    cs_mod = _chip_smoke()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    inputs = make_inputs(dev, cs_mod)
    card = cs_mod.card_line()
    print(card)
    from hmvec_tpu_torch.ops import boltz_kernels as bk

    want6 = bk.recomb_rk4_plain(*inputs["recomb_rk4"])
    shapes = {"recomb_rk4": shape_of("recomb_rk4", inputs["recomb_rk4"])}
    for n, a in enumerate(inputs["hierarchy_rk4"]):
        shapes[f"hierarchy_rk4[{n}]"] = shape_of("hierarchy_rk4", a)
    results = {"card": card, "shapes": shapes, "roots": []}
    with tempfile.TemporaryDirectory() as tmp:
        saved = pathlib.Path(tmp) / "inputs.pt"
        torch.save(inputs, saved)
        first = None
        for n, root in enumerate(args.roots):
            out_path = pathlib.Path(tmp) / f"outputs{n}.pt"
            proc = subprocess.run(
                [sys.executable, __file__, "--time-root", str(root),
                 str(saved), str(out_path)], capture_output=True, text=True,
                timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"{root} failed:\n{proc.stderr}")
            run = json.loads(proc.stdout.strip().splitlines()[-1])
            outs = torch.load(out_path, map_location=dev)
            run["recomb_rk4_equals_plain"] = torch.equal(outs["recomb_rk4"],
                                                         want6)
            if first is None:
                first = outs
            run["equals_first_root"] = all(
                all(torch.equal(g, w) for g, w in zip(
                    v if isinstance(v, tuple) else (v,),
                    first[k] if isinstance(first[k], tuple)
                    else (first[k],)) if g is not None)
                for k, v in outs.items())
            results["roots"].append(run)
            print(f"[check] {root}: recomb_rk4 equal to its plain version "
                  f"{run['recomb_rk4_equals_plain']}; every output equal to "
                  f"{args.roots[0]}'s bit for bit {run['equals_first_root']};"
                  f" {run['resources']}")
    by_root = {}
    for run in results["roots"]:
        for name, ms in run["times"].items():
            by_root.setdefault(run["root"], {}).setdefault(name, []).extend(ms)
        k7 = [sum(s) for s in zip(*(run["times"][f"hierarchy_rk4[{n}]"]
                                    for n in range(4)))]
        by_root[run["root"]].setdefault("hierarchy_rk4 (sum of 4)",
                                        []).extend(k7)
    results["summary"] = {}
    for root, names in by_root.items():
        for name, ms in names.items():
            med = statistics.median(ms)
            results["summary"].setdefault(root, {})[name] = {
                "median_ms": med, "min_ms": min(ms), "max_ms": max(ms),
                "samples": len(ms)}
            print(f"[time] {root}: {name} ({shapes.get(name, '4 launches')})"
                  f" median {med!r} ms, spread {min(ms)!r}-{max(ms)!r} "
                  f"({len(ms)} calls, CUDA events; {card})")
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
