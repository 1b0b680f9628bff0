"""BENCHMARK.json against the harness's files and the benchmark's rules:
every name resolves to its file, names and units keep to their
characters, every configuration keeps a cell, at most one cell asks for
four cards, and nothing the harness imports is JAX or the JAX package.
The cases that need the cards skip here, decided inside a fixture."""

import json
import re
import subprocess
import sys

import pytest

from portbench.lib import harness

BENCH = harness.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_cell_resolves_by_name(cell):
    w = CELLS[cell]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and _line(w["why"])
    cfg = harness.load_json("configs", w["config"])
    spec = harness.load_json("traffic", w["traffic"])
    assert cfg["name"] == w["config"] and spec["name"] == w["traffic"]
    assert (harness.BENCH / "reference" / f"{cfg['reference']}.py").is_file()
    assert spec["batch"] % (4 * w["chips"]) == 0
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            if cell in m.get("workloads", [cell]):
                assert hasattr(harness.load_module("metrics", m["name"]),
                               "read")


def test_names_units_and_metric_keys():
    names = [c["name"] for c in BENCH["configs"]] + list(CELLS)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            names.append(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
            extra = {"bound"} if kind == "end_to_end" else {"layer", "moves"}
            assert set(m) - {"workloads"} == METRIC_KEYS | extra
            assert set(m.get("workloads", CELLS)) <= set(CELLS)
            if kind == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert m["moves"] in e2e and _line(m["layer"])
    for w in CELLS.values():
        names += [w["config"], w["traffic"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in BENCH["configs"])) == len(
        BENCH["configs"])
    assert "setup_s" in e2e


def test_every_configuration_keeps_a_cell_and_one_cell_takes_four_cards():
    used = {w["config"] for w in CELLS.values()}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert json.loads((harness.ROOT / c["file"]).read_text())[
            "source"] == c["source"]
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg.get("reduced_from_source", {})) == set(c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
    assert sum(w["chips"] == 4 for w in CELLS.values()) <= 1
    pairs = [(w["config"], w["traffic"]) for w in CELLS.values()]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if cell in m.get("workloads", [cell])]
    layers = [m for m in BENCH["per_layer"]
              if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    assert all(m["moves"] in e2e for m in layers)


def test_a_full_check_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_nothing_loads_jax_or_the_jax_package():
    code = ("import sys; import portbench.lib.harness, portbench.lib.system, "
            "portbench.lib.trace, portbench.control, "
            "portbench.reference.halo_pmm, portbench.reference.halo_electron, "
            "hmvec_tpu_torch.pipeline, "
            "hmvec_tpu_torch.parallel.sharding; "
            "[portbench.lib.harness.load_module('metrics', m['name']) for k "
            "in ('end_to_end', 'per_layer') for m in "
            "portbench.lib.harness.load_bench()[k]]; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=harness.ROOT)
    tops = set(eval(out.stdout))
    assert "hmvec_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "hmvec_tpu"}


@pytest.fixture
def cards():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the benchmark runs only on the card")
    return torch.cuda.device_count()


def test_without_a_card_a_run_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "pmm_fast.b128",
         "--seed", "7", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT)
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(cards, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "pmm_fast.b128",
         "--seed", str(2**31 + 3), "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"
