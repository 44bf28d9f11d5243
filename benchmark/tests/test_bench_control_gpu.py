"""The precision control of every cell, at the cell's own size, on the
card: it must come out as not correct against the cell's limits, on
three seeds each.

A bf16 configuration's control is fp8: the reference computed with every
GEMM operand and the attention's q, k and v rounded to e4m3, put in the
program's place (``--control fp8ref``), and, for a family whose sampler
has an fp8 weight path of its own (HunyuanVideo), the program with that
path switched on (``--control fp8``): each cell of ``BENCHMARK.json``
with every control its family's ``Cell.controls`` names. Each run is the
harness's own command with a short window. Run on the card with ``python -m pytest
benchmark/tests -m gpu``; the readings the limits were set from are in
PERF.md.
"""

import importlib
import json
import subprocess
import sys

import pytest

import _tiny
from _tiny import ROOT

CONTROLS = [(cell, control) for cell in _tiny.CELLS
            for control in importlib.import_module(
                f"benchmark.systems.{_tiny.family(cell)}").Cell.controls]
SEEDS = (2100000001, 2200000002, 2300000003)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the cells run the port's kernels")


@pytest.mark.gpu
@pytest.mark.parametrize("cell,control", CONTROLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(card, cell, control, seed):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "3", "--trace", "0", "--control", control],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is False, result["checks"]
