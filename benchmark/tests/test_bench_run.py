"""The harness's entry: no result without a card or without the program,
and no module of JAX or the JAX package loaded by a whole run."""

import json
import os
import shutil
import subprocess
import sys

from _tiny import ROOT
from benchmark import run

ARGS = ["--workload", "wan13b-480p-carved", "--seed", "3000000001",
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          env={**os.environ, **(env or {})}, timeout=300)


def test_fails_without_a_card():
    p = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    before = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jenga_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like.sub", sys)
    assert set(run.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jenga_tpu.fake", sys)
    assert "jenga_tpu" in run.forbidden_modules()


def test_build_clock_times_nvcc_alone(tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nsleep 0.2\n")
    nvcc.chmod(0o755)
    original = subprocess.run
    clock = run._BuildClock()
    try:
        subprocess.run([str(nvcc), "-O3"], check=True)
        subprocess.run([sys.executable, "-c", "pass"], check=True)
    finally:
        clock.stop()
    assert subprocess.run is original
    assert clock.builds == 1 and 0.2 <= clock.seconds < 10


SCRIPT = """
import json, sys
sys.path.insert(0, {tests!r})
import _tiny
for cell in _tiny.CELLS:
    _tiny.run_tiny(cell, trace=True)
from benchmark import run
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
print(json.dumps(run.forbidden_modules()))
"""


def test_a_whole_run_loads_no_jax():
    """Every module a traced run of each cell of ``BENCHMARK.json`` loads,
    compared by its top-level name with jax, jaxlib, flax and jenga_tpu:
    jenga_tpu_torch is loaded and is not matched."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", SCRIPT.format(
        tests=str(ROOT / "benchmark" / "tests"))], cwd=ROOT,
        capture_output=True, text=True, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded, bad = (json.loads(x) for x in p.stdout.strip().splitlines()[-2:])
    assert "jenga_tpu_torch" in loaded and "benchmark" in loaded
    assert bad == []
    assert not set(loaded) & {"jax", "jaxlib", "flax", "jenga_tpu"}
