"""Check and time the port's multi-device layer (parallel/sharding.py) on
the CUDA cards of this machine, without the rest of chip_smoke.py.

    python3 tools/measure_torch_sharding.py [--out FILE]

Builds the kernels, makes the unsharded references that chip_smoke.py's
earlier phases make (config 1's plain Pmm, the bN / bNf / exact B = 16
batches through make_batched_fn, the fast electron tier, the four-bin kSZ
survey, the float32 emulator fit of examples/emulator_pk.py), and runs
chip_smoke.phase_sharded on a mesh of four slots on cuda:0 and, where more
than one card is visible, on a mesh of every card: every gate of the phase
holds or the script exits non-zero.  With one slot a card, the slots'
device work overlaps; the script prints each sharded call's latency beside
the unsharded call's and, for the four-slot mesh, each kernel at the shard
shapes with its bound.  It then checks that the caller's current device is
cuda:0 after the phases.  --out writes the phases' numbers as JSON.

Run from the repository root on a machine with a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys
import time
import types

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def references(cs, dev):
    """The unsharded references of chip_smoke.phase_sharded on ``dev``."""
    from hmvec_tpu_torch import pipeline as pl
    from hmvec_tpu_torch.models import emulator as tem

    g, gb, gh, gl, gk, ge = (np.load(p) for p in (
        cs.GOLDEN, cs.GOLDEN_B, cs.GOLDEN_H, cs.GOLDEN_L, cs.GOLDEN_K,
        cs.GOLDEN_EM))
    zs, ks_np, ms = g["zs"], g["ks"], g["ms"]
    cosmos = [dict(zip(g["param_names"].tolist(), map(float, row)))
              for row in g["param_values"]]
    names_b = tuple(gb["param_names"].tolist())
    fns = {"plain": pl.make_pmm_fn(zs, ks_np, ms, device=dev)}
    batch = {}
    for line in ("bN", "bNf", "b16_exact"):
        tkey, kw = cs.BATCH_LINES[line][:2]
        fn = pl.make_pmm_fn(zs, ks_np, ms, device=dev, **kw)
        theta = gb[f"theta_{tkey}"]
        batch[line] = (fn, theta, pl.make_batched_fn(fn, names_b)(theta))
    ge2 = np.load(cs.GOLDEN_E)
    efns = {"electron_fast": pl.make_electron_fn(
        zs, ks_np, ms, device=dev, nxs=int(ge2["nxs"]),
        xmax=float(ge2["xmax"]), fast=True)}
    kcfg = {k: int(gk[k]) for k in ("num_kL_bins", "num_kS_bins",
                                     "num_mu_bins")}
    sfn = pl.make_ksz_survey_fn(gk["zcents"].size, device=dev, ms=gk["ms"],
                                nxs=int(gk["survey_nxs"]),
                                xmax=float(gk["xmax"]), growth="closed",
                                **kcfg)
    n_train, n_val, steps, chunk, seed = map(int, ge["fit"])
    fit = dict(n_train=n_train, n_val=n_val,
               widths=tuple(map(int, ge["widths"])),
               learning_rate=float(ge["learning_rate"]), log_y=True,
               chunk=chunk, seed=seed)
    n_w = sum(1 for k in ge.files if k[0] == "W" and k[1:].isdigit())
    init = {"W": [ge[f"W{i}"] for i in range(n_w)],
            "b": [np.zeros(ge[f"W{i}"].shape[1]) for i in range(n_w)]}
    target = tem.pipeline_target(pl.make_pmm_fn(ge["zs"], ge["ks"], ge["ms"],
                                                device=dev),
                                 tuple(ge["names"].tolist()))
    t0 = time.perf_counter()
    em, info = tem.fit_emulator(target, ge["lo"], ge["hi"], steps=steps,
                                init_net=init, **fit)
    torch.cuda.synchronize()
    t_fit = (time.perf_counter() - t0) * 1e3
    return types.SimpleNamespace(
        zs=zs, ks_np=ks_np, ms=ms, cosmos=cosmos, g=g, fns=fns,
        pmm_plain=fns["plain"](cosmos[0]), gl=gl, gh=gh, gb=gb,
        names_b=names_b, batch=batch, efns=efns, gk=gk, kcfg=kcfg,
        cls_k=torch.as_tensor(gk["cls"], device=dev),
        cosmos_k=[dict(zip(gk["param_names"].tolist(), map(float, row)))
                  for row in gk["param_values"]],
        survey_fn=sfn,
        emulator={"target": target, "lo": ge["lo"], "hi": ge["hi"],
                  "init": init, "fit": fit, "steps": steps, "em": em,
                  "info": info, "val": ge["val_thetas"], "ms": t_fit})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the phases' numbers as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("measure_torch_sharding: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from hmvec_tpu_torch.kernels import _build
    from hmvec_tpu_torch.ops import boltz_kernels as bk
    from hmvec_tpu_torch.ops import nfw_kernels as nk
    from hmvec_tpu_torch.ops import resample_kernels as rk
    from hmvec_tpu_torch.parallel import sharding as tsh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = cs.card_line()
    print(card)
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
    _build.load_library()
    modules = {"nfw_kernels": nk, "resample_kernels": rk,
               "boltz_kernels": bk}
    wrappers = {name: getattr(modules[mod], name)
                for name, mod, _, _ in cs.KERNEL_ROWS}

    def reset():
        for w in wrappers.values():
            w.launches = 0

    counts = types.SimpleNamespace(
        reset=reset, read=lambda: {n: w.launches for n, w in wrappers.items()})
    t0 = time.perf_counter()
    ref = references(cs, dev)
    print(f"[sharded] the unsharded references in "
          f"{time.perf_counter() - t0:.1f} s")
    rows = collections.defaultdict(list)
    out = {"card": card, "device_count": torch.cuda.device_count()}
    out["launches"], out["stats"] = cs.phase_sharded(
        tsh.make_mesh(devices=[dev] * 4), ref, card, counts, wrappers,
        kernel_rows=rows)
    out["shard_kernels"] = rows
    if torch.cuda.device_count() > 1:
        out["launches_cards"], out["stats_cards"] = cs.phase_sharded(
            tsh.make_mesh(), ref, card, counts, wrappers)
    cs.check(torch.cuda.current_device() == 0,
             "the current device is cuda:0 after the sharded phases")
    print("[sharded] " + json.dumps(out["stats"]))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({"ok": True, "device_count":
                      torch.cuda.device_count()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
