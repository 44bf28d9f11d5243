"""A model family joins the benchmark as new files and new entries alone:
in a copy of the benchmark, a family is added with a system module, a
tiny module, a configuration, a workload and their ``BENCHMARK.json``
entries, no file of the benchmark edited, and the benchmark's own tests
are run there on its cell: the manifest's contract and the lookup by
name, a tiny CPU run with ``correct`` true, and the check tests' planted
faults coming out not correct."""

import json
import os
import shutil
import subprocess
import sys

from _tiny import ROOT

FAMILY, CONFIG, CELL = "wanlike", "wanlike-t2v-1.3b", "wanlike-480p-carved"
BASE_CELL = "wan13b-480p-carved"

SYSTEM = '''"""A family made of new files: Wan's cell under its own name."""

from .wan import Cell as WanCell


class Cell(WanCell):
    """The Wan T2V cell, as a family of its own would define one."""
'''

TINY = '''"""The new family's tiny size and planted faults: Wan's."""

import _tiny

_wan = _tiny.module("wan")
tiny, state_unchanged, wrap_output = (_wan.tiny, _wan.state_unchanged,
                                      _wan.wrap_output)
'''


def _add_family(tree):
    bench = tree / "benchmark"
    (bench / "systems" / f"{FAMILY}.py").write_text(SYSTEM)
    (bench / "tests" / "tiny" / f"{FAMILY}.py").write_text(TINY)
    workload = json.loads((bench / "workloads" / f"{BASE_CELL}.json")
                          .read_text())
    config = json.loads((bench / "configs" / f"{workload['config']}.json")
                        .read_text())
    config["family"] = FAMILY
    workload["config"] = CONFIG
    (bench / "configs" / f"{CONFIG}.json").write_text(json.dumps(config))
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps(workload))
    manifest = json.loads((tree / "BENCHMARK.json").read_text())
    base = next(w for w in manifest["workloads"] if w["name"] == BASE_CELL)
    entry = next(c for c in manifest["configs"]
                 if c["name"] == base["config"])
    manifest["configs"].append(dict(entry, name=CONFIG,
                                    file=f"benchmark/configs/{CONFIG}.json"))
    manifest["workloads"].append(dict(base, name=CELL, config=CONFIG))
    for metric in manifest["per_layer"]:
        if BASE_CELL in metric.get("workloads", []):
            metric["workloads"].append(CELL)
    (tree / "BENCHMARK.json").write_text(json.dumps(manifest, indent=2))


def _same_files(a, b):
    """Every file of tree ``a`` is in ``b`` with the same bytes."""
    for path in a.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert (b / path.relative_to(a)).read_bytes() == \
                path.read_bytes(), path


def test_a_family_of_new_files_is_found_run_and_checked(tmp_path):
    tree = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", tree / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tree)
    (tree / "jenga_tpu_torch").symlink_to(ROOT / "jenga_tpu_torch")
    _add_family(tree)
    _same_files(ROOT / "benchmark", tree / "benchmark")
    tests = "benchmark/tests"
    ids = [f"{tests}/test_bench_manifest.py",
           f"{tests}/test_bench_check.py::test_reference_agrees_with_the_port"
           f"[{CELL}]",
           f"{tests}/test_bench_check.py::test_state_unchanged_fails[{CELL}]",
           f"{tests}/test_bench_check.py::test_one_token_altered_fails"
           f"[{CELL}]"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-rA", *ids], cwd=tree, capture_output=True,
        text=True, env=env, timeout=600)
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-2000:]
    for test in ("test_bench_manifest.py::test_configs_and_cells",
                 f"test_bench_manifest.py::test_cell_files_found_by_name"
                 f"[{CELL}]", *(i.split("/")[-1] for i in ids[1:])):
        assert f"PASSED {tests}/{test}" in p.stdout, test
