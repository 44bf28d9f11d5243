"""BENCHMARK.json against the benchmark's contract, and every file of a
cell found by name."""

import importlib
import json
import re

import pytest

from _tiny import ROOT  # noqa: F401  (puts the checkout on sys.path)
from benchmark import run

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def four_chip_cells_allowed(chips) -> bool:
    """Each cell asks for 1 or 4 chips, and at most a quarter of the
    cells, rounded down, ask for 4; one always may."""
    chips = list(chips)
    fours = sum(c == 4 for c in chips)
    return (all(c in (1, 4) for c in chips)
            and fours <= max(1, len(chips) // 4))


def test_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    cmd = MANIFEST["command"]
    assert len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert cmd[1].startswith(MANIFEST["paths"][0] + "/")
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_names_units_and_lines():
    seen = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[kind]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (kind, entry["name"]) not in seen
            seen.add((kind, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert _line(entry[key]), (entry["name"], key)
    metrics = [m["name"] for k in ("end_to_end", "per_layer")
               for m in MANIFEST[k]]
    assert len(metrics) == len(set(metrics))


def test_configs_and_cells():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == set(configs)
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for c in configs.values():
        assert c["file"].startswith("benchmark/")
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert four_chip_cells_allowed(w["chips"] for w in MANIFEST["workloads"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert _line(w["why"])
        workload, config = run.load_cell(w["name"])
        assert workload["config"] == w["config"]
        assert workload["chips"] == w["chips"]


@pytest.mark.parametrize("chips,ok", [
    ([1], True), ([4], True), ([1, 4], True), ([1, 1, 1, 4], True),
    ([1, 4, 4], False), ([1] * 6 + [4, 4], True), ([1] * 5 + [4] * 3, False),
    ([1, 2], False), ([1, 1, 1, 8], False)])
def test_the_four_chip_share(chips, ok):
    assert four_chip_cells_allowed(chips) is ok


def test_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m.get("workloads", []):
            assert cell in CELLS
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(_line(name) for name in layers)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    """Each cell's workload, configuration, system (a module named by its
    family that defines ``Cell``) and every per-layer metric it reports
    are found by name; every cell reports a per-layer metric."""
    workload, config = run.load_cell(cell)
    family = config["family"]
    assert NAME.match(family)
    assert (ROOT / "benchmark" / "systems" / f"{family}.py").exists()
    system = importlib.import_module(f"benchmark.systems.{family}")
    assert isinstance(system.Cell, type)
    names = run.layer_metrics(cell)
    assert names
    for name in names:
        read, unit = run.load_reader(name)
        entry = next(m for m in MANIFEST["per_layer"] if m["name"] == name)
        assert unit == entry["unit"] and callable(read)
    assert set(workload["limits"])
