"""A cell's configuration and traffic cut to a size the CPU tests hold."""

import copy

from portbench.lib import harness


def small(cell_name: str, batch: int = 8):
    bench = harness.load_bench()
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    cfg = copy.deepcopy(harness.load_json("configs", cell["config"]))
    for axis, num in (("zs", 3), ("ms", 24), ("ks", 64)):
        cfg["grids"][axis]["num"] = num
    spec = copy.deepcopy(harness.load_json("traffic", cell["traffic"]))
    spec["batch"] = batch
    return bench, cell, cfg, spec
