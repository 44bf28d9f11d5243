# Frozen copy of jenga_tpu_torch/curves/blocks.py (itself a copy of jenga_tpu/curves/blocks.py), kept so that the reference imports neither package.
"""Block geometry on top of gilbert curves: coloring, adjacency, plans.

Tokens in curve order are partitioned into fixed-size blocks (default 128,
matching the TPU MXU tile). Every voxel is "colored" by the block that its
curve position falls into, and two blocks are *neighbors* when any of their
voxels touch in the 26-neighborhood of the 3-D grid. The resulting boolean
``[num_blocks, num_blocks]`` adjacency is OR-ed into the per-step importance
mask so that geometrically adjacent content is always attended to, matching
the reference ``gilbert_block_neighbor_mapping``
(the reference's `gilbert.py:597-766`) but computed with vectorized numpy
(the reference triple-loops over voxels and is ~100x slower).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from . import gilbert

__all__ = [
    "block_color_map",
    "block_neighbor_tensor",
    "CurvePlan",
    "build_curve_plan",
    "build_multi_curve",
]


def block_color_map(linear_to_curve: np.ndarray, grid: tuple[int, int, int],
                    block_size: int) -> np.ndarray:
    """Color every voxel of the (t, h, w) grid with its curve-block id."""
    t, h, w = grid
    colors = (np.asarray(linear_to_curve) // block_size).astype(np.int32)
    return colors.reshape(t, h, w)


def block_neighbor_tensor(linear_to_curve: np.ndarray,
                          grid: tuple[int, int, int],
                          block_size: int = 128) -> np.ndarray:
    """Boolean ``[nb, nb]`` adjacency: 26-neighborhood block contacts.

    ``nb = ceil(t*h*w / block_size)``; entry ``[i, j]`` is True when block i
    contains a voxel whose 26-neighborhood touches a voxel of block j (the
    relation is symmetric because every offset is visited in both signs).
    The diagonal is always True.
    """
    t, h, w = grid
    total = t * h * w
    nb = -(-total // block_size)
    colors = block_color_map(linear_to_curve, grid, block_size)

    adj = np.zeros((nb, nb), dtype=bool)
    adj[np.arange(nb), np.arange(nb)] = True

    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dz == 0 and dy == 0 and dx == 0:
                    continue
                zs = slice(max(0, dz), t + min(0, dz))
                ys = slice(max(0, dy), h + min(0, dy))
                xs = slice(max(0, dx), w + min(0, dx))
                zd = slice(max(0, -dz), t + min(0, -dz))
                yd = slice(max(0, -dy), h + min(0, -dy))
                xd = slice(max(0, -dx), w + min(0, -dx))
                a = colors[zd, yd, xd].ravel()
                b = colors[zs, ys, xs].ravel()
                adj[a, b] = True
    return adj


@dataclasses.dataclass(frozen=True)
class CurvePlan:
    """A static carving plan for one latent grid at one resolution stage.

    First-class replacement for the reference's per-run class attributes
    (``curve_sels`` stashed on the transformer class,
    the reference's `jenga_hyvideo.py:264-287`): the plan is an immutable
    value threaded through the pipeline, and its arrays are host numpy so
    each jit specialization can close over them as constants.

    Attributes:
      grid:            latent token grid (t, h, w) after patchification.
      block_size:      tokens per curve block (128).
      linear_to_curve: [S] curve position of each linear token.
      curve_order:     [S] linear token at each curve position (gather with
                       ``tokens[curve_order]`` to reorder into curve order).
      block_neighbors: [nb, nb] bool 26-neighborhood block adjacency.
    """

    grid: tuple[int, int, int]
    block_size: int
    linear_to_curve: np.ndarray
    curve_order: np.ndarray
    block_neighbors: np.ndarray

    @property
    def seq_len(self) -> int:
        t, h, w = self.grid
        return t * h * w

    @property
    def num_blocks(self) -> int:
        return self.block_neighbors.shape[0]


@functools.lru_cache(maxsize=64)
def _build_curve_plan_cached(grid, kind, block_size, transpose_order):
    t, h, w = grid
    if kind == "gilbert":
        l2c, order = gilbert.gilbert_mapping(t, h, w, transpose_order)
    elif kind == "sliced":
        l2c, order = gilbert.sliced_gilbert_mapping(t, h, w, transpose_order)
    elif kind == "linear":
        n = t * h * w
        l2c = np.arange(n, dtype=np.int32)
        order = np.arange(n, dtype=np.int32)
    else:
        raise ValueError(f"unknown curve kind: {kind!r}")
    neighbors = block_neighbor_tensor(l2c, grid, block_size)
    return CurvePlan(
        grid=grid,
        block_size=block_size,
        linear_to_curve=l2c,
        curve_order=order,
        block_neighbors=neighbors,
    )


def build_curve_plan(grid: tuple[int, int, int], kind: str = "gilbert",
                     block_size: int = 128,
                     transpose_order: tuple[int, int, int] | None = None
                     ) -> CurvePlan:
    """Build (and cache) the carving plan for one latent grid.

    ``kind``: "gilbert" (3-D curve, HunyuanVideo), "sliced" (per-frame 2-D
    curve with corner continuation, Wan), "transposed" (gilbert with axes
    reversed — the reference ``transpose_gilbert_mapping``,
    the reference's `gilbert.py:274-330`), or "linear" (identity, for
    debugging/ablation).
    """
    if kind == "transposed":
        kind = "gilbert"
        if transpose_order is None:
            transpose_order = (2, 1, 0)
    return _build_curve_plan_cached(
        tuple(int(g) for g in grid), kind, int(block_size),
        None if transpose_order is None else tuple(transpose_order))


def build_multi_curve(grid: tuple[int, int, int], res_rates: list[float],
                      kind: str = "gilbert", block_size: int = 128
                      ) -> list[CurvePlan]:
    """Per-ProRes-stage plans: one CurvePlan per resolution rate.

    Stage grids shrink spatially only — ``(t, h*rate, w*rate)`` rounded down,
    time is never reduced — matching the reference ``build_multi_curve``
    (the reference's `jenga_hyvideo.py:43-58`). Duplicate rates share the
    cached plan.
    """
    t, h, w = grid
    plans = []
    for rate in res_rates:
        stage_grid = (t, int(h * rate), int(w * rate))
        plans.append(build_curve_plan(stage_grid, kind, block_size))
    return plans
