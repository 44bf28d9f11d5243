"""The port's own copies of the JAX package's numpy host modules (curves,
skip schedules, option validation, video output) against the originals,
and the rule that no module of the port imports ``jenga_tpu`` or JAX.

Curve orders, block adjacency and skip schedules must stay index for
index equal to ``jenga_tpu``'s: fidelity against JAX depends on it.
"""

import ast
import dataclasses
import functools
import importlib
import pathlib
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest

import jenga_tpu_torch
from jenga_tpu.configs import validate as jax_validate
from jenga_tpu.curves import blocks as jax_blocks
from jenga_tpu.curves import gilbert as jax_gilbert
from jenga_tpu.diffusion import skip as jax_skip
from jenga_tpu_torch.configs import validate as pt_validate
from jenga_tpu_torch.configs.presets import get_hy_preset, get_wan_preset
from jenga_tpu_torch.curves import blocks as pt_blocks
from jenga_tpu_torch.curves import gilbert as pt_gilbert
from jenga_tpu_torch.diffusion import skip as pt_skip

ROOT = pathlib.Path(__file__).resolve().parent.parent
COPIES = ["curves/gilbert.py", "curves/blocks.py", "diffusion/skip.py",
          "configs/validate.py", "utils/video.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_original_but_its_note(rel):
    """Each copy is its original plus a first-line note naming it, with
    the reference's paths in docstrings written as names: no line of code
    differs."""
    orig = (ROOT / "jenga_tpu" / rel).read_text()
    copy = (ROOT / "jenga_tpu_torch" / rel).read_text().split("\n", 1)
    assert copy[0] == (f"# Copy of jenga_tpu/{rel}, kept so that the port "
                       f"never imports it.")
    assert copy[1] == re.sub(r"`/\w+/reference/", "the reference's `", orig)


@pytest.mark.parametrize("kind,grid", [
    ("gilbert", (3, 5, 7)), ("gilbert", (2, 9, 4)), ("gilbert", (5, 6, 10)),
    ("gilbert", (1, 7, 13)), ("sliced", (3, 5, 7)), ("sliced", (4, 6, 9)),
    ("sliced", (5, 11, 3)), ("transposed", (3, 4, 10))])
def test_curve_plan_equals_jax(kind, grid):
    """Curve order, linear-to-curve map and block adjacency, index for
    index, at small and ragged grids (16-token blocks, so adjacency has
    several blocks)."""
    a = jax_blocks.build_curve_plan(grid, kind, 16)
    b = pt_blocks.build_curve_plan(grid, kind, 16)
    assert b.grid == a.grid and b.block_size == a.block_size
    for field in ("linear_to_curve", "curve_order", "block_neighbors"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field
    t, h, w = grid
    assert np.array_equal(pt_gilbert.gilbert3d(w, h, t),
                          jax_gilbert.gilbert3d(w, h, t))
    for rates in ([0.5, 1.0], [0.75, 1.0]):
        for pa, pb in zip(jax_blocks.build_multi_curve(grid, rates, "gilbert",
                                                       16),
                          pt_blocks.build_multi_curve(grid, rates, "gilbert",
                                                      16)):
            assert np.array_equal(pa.block_neighbors, pb.block_neighbors)


@pytest.mark.parametrize("num_steps,stage_starts", [
    (50, ()), (50, (25,)), (30, (5, 9)), (8, (5,))])
def test_fixed_compute_schedule_equals_jax(num_steps, stage_starts):
    for steps in (jax_skip.HYVIDEO_NON_SKIP_STEPS, (0, 1, 3, 5)):
        a = jax_skip.fixed_compute_schedule(num_steps, steps, stage_starts)
        b = pt_skip.fixed_compute_schedule(num_steps, steps, stage_starts)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert pt_skip.HYVIDEO_NON_SKIP_STEPS == jax_skip.HYVIDEO_NON_SKIP_STEPS


@pytest.mark.parametrize("seed,stage_starts", [(0, ()), (1, (12,)),
                                               (2, (7, 20))])
def test_teacache_compute_schedule_equals_jax(seed, stage_starts):
    metrics = np.random.default_rng(seed).uniform(0.0, 0.3, 30)
    assert pt_skip.TEACACHE_COEFFS == jax_skip.TEACACHE_COEFFS
    for name, coeffs in jax_skip.TEACACHE_COEFFS.items():
        for thresh in (0.05, 0.2):
            a = jax_skip.teacache_compute_schedule(metrics, thresh, coeffs, 2,
                                                   28, stage_starts)
            b = pt_skip.teacache_compute_schedule(metrics, thresh, coeffs, 2,
                                                  28, stage_starts)
            assert np.array_equal(a, b), (name, thresh)


def _raised(fn, opts):
    try:
        fn(opts)
    except ValueError as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("bad", [
    dict(size=(1000, 720)), dict(video_length=10),
    dict(num_inference_steps=0), dict(sa_drop_rates=()),
    dict(sa_drop_rates=(1.0,)), dict(p_remain=0.0), dict(txt_block_num=0),
    dict(res_rate_list=(0.75, 0.9), step_rate_list=(0.5, 1.0),
         scheduler_shift_list=(7.0, 7.0)), None])
def test_validate_hy_raises_as_jax(bad):
    opts = get_hy_preset("base", size=(1280, 720), video_length=33,
                         num_inference_steps=8)
    if bad is not None:
        opts = dataclasses.replace(opts, **bad)
    got = _raised(pt_validate.validate_hy_options, opts)
    assert got == _raised(jax_validate.validate_hy_options, opts)
    assert (got is None) == (bad is None)


@pytest.mark.parametrize("bad", [
    dict(size=(832, 470)), dict(frame_num=80), dict(sampling_steps=0),
    dict(sa_drop_rates=(1.2,)), dict(p_remain=1.5), dict(guide_scale=-1.0),
    dict(teacache_thresh=-0.1), None])
def test_validate_wan_raises_as_jax(bad):
    opts = get_wan_preset("1.3b-base", size=(832, 480), frame_num=81,
                          sampling_steps=6)
    if bad is not None:
        opts = dataclasses.replace(opts, **bad)
    got = _raised(pt_validate.validate_wan_options, opts)
    assert got == _raised(jax_validate.validate_wan_options, opts)
    assert (got is None) == (bad is None)


@functools.lru_cache(maxsize=1)
def _modules_after_importing_the_port():
    """Every module of the port (the tools included) imported in a fresh
    interpreter: (their names, the modules then loaded)."""
    names = [m.name for m in pkgutil.walk_packages(jenga_tpu_torch.__path__,
                                                   "jenga_tpu_torch.")]
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "print(sorted(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return names, ast.literal_eval(res.stdout.strip())


def _loaded(prefixes):
    return sorted(m for m in _modules_after_importing_the_port()[1]
                  if m in prefixes or m.startswith(tuple(
                      p + "." for p in prefixes)))


def test_port_imports_neither_jenga_tpu_nor_jax():
    """A fresh interpreter imports every module of the port (the tools
    included) and finds no module of jenga_tpu or JAX loaded."""
    names = _modules_after_importing_the_port()[0]
    assert "jenga_tpu_torch.tools.kernel_split_probe" in names
    assert _loaded(("jax", "jenga_tpu")) == []
    assert importlib.import_module("jenga_tpu_torch.curves.blocks") \
        is pt_blocks


def test_port_imports_no_transformers_or_safetensors():
    """The same import of every module loads neither ``transformers`` nor
    ``safetensors`` (the card machine has neither; the tokenizer adapter
    imports ``transformers`` on first use), and no file of the port uses
    ``safetensors``: the reader is the port's own."""
    names = _modules_after_importing_the_port()[0]
    assert {"jenga_tpu_torch.text.llava", "jenga_tpu_torch.convert.encoders",
            "jenga_tpu_torch.runtime"} <= set(names)
    assert _loaded(("transformers", "safetensors", "tokenizers")) == []
    for path in (ROOT / "jenga_tpu_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        imported = {a.name.split(".")[0] for node in ast.walk(tree)
                    if isinstance(node, ast.Import) for a in node.names} | {
            (node.module or "").split(".")[0] for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.level == 0}
        assert "safetensors" not in imported, path
