"""Spatial (Morton) triangle-soup reordering — a scene-prep pass (a numpy
copy of ``ascii_renderer_tpu/geom/reorder.py``).

Reordering a soup by the Morton code of each triangle's centroid makes
spatially adjacent triangles adjacent in the channel tables, so the
raster walks' per-bin gathers read nearby rows under any camera.

Triangle submission order is also the raster z-tie tie-break (the first
submitted wins, as GL_LESS draw order does), so reordering changes which
triangle wins where two triangles rasterize to exactly equal depth at a
pixel. The output is deterministic either way; the pass is explicit scene
prep that the caller opts in to.
"""

from __future__ import annotations

import numpy as np


def _spread3(x: np.ndarray) -> np.ndarray:
    """Interleave the low 21 bits of x with two zero bits each (u64)."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def morton_codes(points: np.ndarray, bits: int = 21) -> np.ndarray:
    """points f32/f64 [N, 3] -> u64 Morton (Z-order) codes.

    Coordinates are normalized to the point cloud's bounding box and
    quantized to `bits` bits per axis (21 fits u64 exactly)."""
    p = np.asarray(points, np.float64)
    lo = p.min(axis=0)
    span = np.maximum(p.max(axis=0) - lo, 1e-12)
    q = ((p - lo) / span * ((1 << bits) - 1)).astype(np.uint64)
    return (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << np.uint64(1))
            | (_spread3(q[:, 2]) << np.uint64(2)))


def morton_tri_order(positions: np.ndarray) -> np.ndarray:
    """Soup positions [3T, 3] -> tri permutation i64 [T] in Morton order
    of the triangle centroids (stable: equal codes keep original order)."""
    pos = np.asarray(positions)
    T = pos.shape[0] // 3
    cent = pos[: 3 * T].reshape(T, 3, 3).mean(axis=1)
    return np.argsort(morton_codes(cent), kind="stable")


def reorder_soup(positions, normals, colors):
    """Returns (positions, normals, colors, perm) with triangles permuted
    to Morton order. Inputs are numpy arrays or CPU tensors [3T, 3];
    outputs are numpy (static scene prep, done once)."""
    pos = np.asarray(positions)
    nrm = np.asarray(normals)
    col = np.asarray(colors)
    perm = morton_tri_order(pos)
    T = pos.shape[0] // 3

    def ap(a):
        return a[: 3 * T].reshape(T, 3, -1)[perm].reshape(3 * T, -1)

    return ap(pos), ap(nrm), ap(col), perm
