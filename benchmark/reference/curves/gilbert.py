# Frozen copy of jenga_tpu_torch/curves/gilbert.py (itself a copy of jenga_tpu/curves/gilbert.py), kept so that the reference imports neither package.
"""Generalized Hilbert ("gilbert") space-filling curves for arbitrary cuboids.

This is the curve layer of the token-carving pipeline: 3D video latents are
reordered along a gilbert curve so that spatio-temporally local tokens become
contiguous in the 1-D token sequence, which makes fixed-size token blocks
geometrically compact and lets block-sparse attention skip most block pairs.

The curve itself is the public-domain generalized Hilbert curve algorithm of
Jakub Cerveny (github.com/jakubcerveny/gilbert, BSD-2-Clause), implemented
here in its *generator* form: we enumerate the whole curve once in O(N)
instead of answering per-voxel O(log N) index queries (the reference
implementation, the reference's `gilbert.py:12-272`, uses the per-voxel
`gilbert_xyz2d` query form and is orders of magnitude slower for large
grids).  Both forms produce the identical curve ordering.

Conventions (matching the reference so carving plans are interchangeable):
  * A video latent grid is indexed ``(t, h, w)`` with linear (row-major)
    index ``z*h*w + y*w + x`` where ``z`` runs over ``t``, ``y`` over ``h``
    and ``x`` over ``w`` (reference ``gilbert_mapping``,
    the reference's `gilbert.py:442-488`).
  * The curve is traced over the cuboid ``(w, h, t)``: coordinate x is the
    fastest/"width" axis of the curve.
  * ``linear_to_curve[linear] = curve_index`` and
    ``curve_order[curve_index] = linear`` (the reference calls these
    ``linear_to_hilbert`` and ``hilbert_order``).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "gilbert2d",
    "gilbert3d",
    "gilbert_mapping",
    "transpose_gilbert_mapping",
    "sliced_gilbert_mapping",
]


def _sgn(v: int) -> int:
    return (v > 0) - (v < 0)


def _generate3d(x, y, z, ax, ay, az, bx, by, bz, cx, cy, cz, out):
    """Append curve coordinates for the cuboid spanned by vectors a/b/c.

    ``(x, y, z)`` is the corner where the curve enters; ``a`` is the major
    ("width") axis along which the curve exits, ``b`` and ``c`` are the two
    orthogonal axes. Vectors are signed; their L1 norms are the side lengths.
    """
    w = abs(ax + ay + az)
    h = abs(bx + by + bz)
    d = abs(cx + cy + cz)

    dax, day, daz = _sgn(ax), _sgn(ay), _sgn(az)
    dbx, dby, dbz = _sgn(bx), _sgn(by), _sgn(bz)
    dcx, dcy, dcz = _sgn(cx), _sgn(cy), _sgn(cz)

    # Degenerate cases: a straight run along a single axis.
    if h == 1 and d == 1:
        for _ in range(w):
            out.append((x, y, z))
            x, y, z = x + dax, y + day, z + daz
        return
    if w == 1 and d == 1:
        for _ in range(h):
            out.append((x, y, z))
            x, y, z = x + dbx, y + dby, z + dbz
        return
    if w == 1 and h == 1:
        for _ in range(d):
            out.append((x, y, z))
            x, y, z = x + dcx, y + dcy, z + dcz
        return

    # Halve each axis, preferring even step counts.
    ax2, ay2, az2 = ax // 2, ay // 2, az // 2
    bx2, by2, bz2 = bx // 2, by // 2, bz // 2
    cx2, cy2, cz2 = cx // 2, cy // 2, cz // 2

    w2 = abs(ax2 + ay2 + az2)
    h2 = abs(bx2 + by2 + bz2)
    d2 = abs(cx2 + cy2 + cz2)

    if (w2 % 2) and (w > 2):
        ax2, ay2, az2 = ax2 + dax, ay2 + day, az2 + daz
    if (h2 % 2) and (h > 2):
        bx2, by2, bz2 = bx2 + dbx, by2 + dby, bz2 + dbz
    if (d2 % 2) and (d > 2):
        cx2, cy2, cz2 = cx2 + dcx, cy2 + dcy, cz2 + dcz

    if (2 * w > 3 * h) and (2 * w > 3 * d):
        # Wide case: split along the major axis only.
        _generate3d(x, y, z,
                    ax2, ay2, az2, bx, by, bz, cx, cy, cz, out)
        _generate3d(x + ax2, y + ay2, z + az2,
                    ax - ax2, ay - ay2, az - az2, bx, by, bz, cx, cy, cz, out)
    elif 3 * h > 4 * d:
        # Tall-in-b case: three sub-cuboids, do not split along c.
        _generate3d(x, y, z,
                    bx2, by2, bz2, cx, cy, cz, ax2, ay2, az2, out)
        _generate3d(x + bx2, y + by2, z + bz2,
                    ax, ay, az, bx - bx2, by - by2, bz - bz2, cx, cy, cz, out)
        _generate3d(x + (ax - dax) + (bx2 - dbx),
                    y + (ay - day) + (by2 - dby),
                    z + (az - daz) + (bz2 - dbz),
                    -bx2, -by2, -bz2, cx, cy, cz,
                    -(ax - ax2), -(ay - ay2), -(az - az2), out)
    elif 3 * d > 4 * h:
        # Deep-in-c case: three sub-cuboids, do not split along b.
        _generate3d(x, y, z,
                    cx2, cy2, cz2, ax2, ay2, az2, bx, by, bz, out)
        _generate3d(x + cx2, y + cy2, z + cz2,
                    ax, ay, az, bx, by, bz, cx - cx2, cy - cy2, cz - cz2, out)
        _generate3d(x + (ax - dax) + (cx2 - dcx),
                    y + (ay - day) + (cy2 - dcy),
                    z + (az - daz) + (cz2 - dcz),
                    -cx2, -cy2, -cz2,
                    -(ax - ax2), -(ay - ay2), -(az - az2), bx, by, bz, out)
    else:
        # Regular case: split along all three axes into five sub-cuboids.
        _generate3d(x, y, z,
                    bx2, by2, bz2, cx2, cy2, cz2, ax2, ay2, az2, out)
        _generate3d(x + bx2, y + by2, z + bz2,
                    cx, cy, cz, ax2, ay2, az2, bx - bx2, by - by2, bz - bz2,
                    out)
        _generate3d(x + (bx2 - dbx) + (cx - dcx),
                    y + (by2 - dby) + (cy - dcy),
                    z + (bz2 - dbz) + (cz - dcz),
                    ax, ay, az, -bx2, -by2, -bz2,
                    -(cx - cx2), -(cy - cy2), -(cz - cz2), out)
        _generate3d(x + (ax - dax) + bx2 + (cx - dcx),
                    y + (ay - day) + by2 + (cy - dcy),
                    z + (az - daz) + bz2 + (cz - dcz),
                    -cx, -cy, -cz,
                    -(ax - ax2), -(ay - ay2), -(az - az2),
                    bx - bx2, by - by2, bz - bz2, out)
        _generate3d(x + (ax - dax) + (bx2 - dbx),
                    y + (ay - day) + (by2 - dby),
                    z + (az - daz) + (bz2 - dbz),
                    -bx2, -by2, -bz2, cx2, cy2, cz2,
                    -(ax - ax2), -(ay - ay2), -(az - az2), out)


def gilbert3d(width: int, height: int, depth: int) -> np.ndarray:
    """Trace the gilbert curve over a ``width x height x depth`` cuboid.

    Returns an int32 array of shape ``[width*height*depth, 3]`` holding the
    ``(x, y, z)`` coordinate visited at each curve step. The entry axis is
    the longest cuboid side, mirroring the reference dispatch
    (the reference's `gilbert.py:12-38`).
    """
    out: list[tuple[int, int, int]] = []
    if width >= height and width >= depth:
        _generate3d(0, 0, 0, width, 0, 0, 0, height, 0, 0, 0, depth, out)
    elif height >= width and height >= depth:
        _generate3d(0, 0, 0, 0, height, 0, width, 0, 0, 0, 0, depth, out)
    else:
        _generate3d(0, 0, 0, 0, 0, depth, width, 0, 0, 0, height, 0, out)
    return np.asarray(out, dtype=np.int32)


def gilbert2d(width: int, height: int) -> np.ndarray:
    """2-D gilbert curve: ``[width*height, 2]`` of (x, y) in curve order."""
    return gilbert3d(width, height, 1)[:, :2]


def _mapping_from_coords(coords: np.ndarray, t: int, h: int, w: int,
                         perm: tuple[int, int, int] | None = None):
    """Build (linear_to_curve, curve_order) from curve-ordered coordinates.

    ``coords[k] = (x, y, z)`` is the voxel visited at curve step ``k``; the
    linear index convention is ``z*h*w + y*w + x`` over the ``(t, h, w)``
    grid. ``perm`` optionally permutes curve coords back into grid coords.
    """
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    if perm is not None:
        axes = np.empty((3, coords.shape[0]), dtype=np.int64)
        axes[perm[2]] = x
        axes[perm[1]] = y
        axes[perm[0]] = z
        z, y, x = axes[0], axes[1], axes[2]
    linear = z.astype(np.int64) * (h * w) + y * w + x
    n = t * h * w
    curve_order = linear.astype(np.int32)
    linear_to_curve = np.empty(n, dtype=np.int32)
    linear_to_curve[linear] = np.arange(n, dtype=np.int32)
    return linear_to_curve, curve_order


def gilbert_mapping(t: int, h: int, w: int, transpose_order=None):
    """Map the ``(t, h, w)`` grid onto a 3-D gilbert curve.

    Returns ``(linear_to_curve, curve_order)``: ``linear_to_curve[i]`` is the
    curve position of linear token ``i``; ``curve_order[k]`` is the linear
    token at curve position ``k`` (so ``tokens[curve_order]`` reorders a
    token sequence into curve order). Semantics match the reference
    ``gilbert_mapping`` (the reference's `gilbert.py:442-488`).
    """
    if transpose_order is not None:
        return transpose_gilbert_mapping([t, h, w], transpose_order)
    coords = gilbert3d(w, h, t)
    return _mapping_from_coords(coords, t, h, w)


def transpose_gilbert_mapping(dims, order):
    """Gilbert mapping with a permuted axis order.

    ``order`` is a permutation of (0, 1, 2) over ``dims = (d0, d1, d2)``; the
    curve is traced over the cuboid whose width/height/depth are
    ``dims[order[2]], dims[order[1]], dims[order[0]]`` and coordinates are
    scattered back through the permutation, matching the reference
    ``transpose_gilbert_mapping`` (the reference's `gilbert.py:274-330`).
    """
    dims = tuple(int(d) for d in dims)
    order = tuple(int(o) for o in order)
    if len(dims) != 3:
        raise ValueError("dims must be three-dimensional")
    if sorted(order) != [0, 1, 2]:
        raise ValueError("order must be a permutation of 0,1,2")
    t, h, w = dims
    cw, ch, ct = dims[order[2]], dims[order[1]], dims[order[0]]
    coords = gilbert3d(cw, ch, ct)
    return _mapping_from_coords(coords, t, h, w, perm=order)


def sliced_gilbert_mapping(t: int, h: int, w: int, transpose_order=None):
    """Per-frame 2-D gilbert curve with corner continuation across frames.

    Each time slice is traced by a 2-D gilbert curve over ``(w, h)``; every
    subsequent slice is mirrored in x and/or y so that it starts at the
    corner nearest to where the previous slice ended, keeping the stitched
    1-D order spatially continuous across frames. Matches the reference
    ``sliced_gilbert_mapping`` (the reference's `gilbert.py:332-440`).
    """
    if transpose_order is not None:
        return transpose_gilbert_mapping([t, h, w], transpose_order)

    base = gilbert2d(w, h)  # [h*w, 2] coords in curve order
    hw = h * w

    linear_to_curve = np.empty(t * hw, dtype=np.int32)
    curve_order = np.empty(t * hw, dtype=np.int32)
    steps = np.arange(hw, dtype=np.int32)

    flip_x = flip_y = False
    for z in range(t):
        x = (w - 1) - base[:, 0] if flip_x else base[:, 0]
        y = (h - 1) - base[:, 1] if flip_y else base[:, 1]
        local_linear = y.astype(np.int64) * w + x
        linear_to_curve[z * hw + local_linear] = z * hw + steps
        curve_order[z * hw + steps] = z * hw + local_linear

        end_x, end_y = int(x[-1]), int(y[-1])
        flip_x = end_x >= w / 2
        flip_y = end_y >= h / 2

    return linear_to_curve, curve_order
