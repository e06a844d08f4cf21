"""Procedural benchmark meshes (BASELINE.json configs).

The benchmark configs name a spinning cube, a ~1k-tri Utah-teapot-class
mesh and a 69k-tri Stanford-bunny-class mesh. The canonical scans are not
downloaded; these generators make *workload-equivalent* meshes:
matched triangle count, comparable screen-space triangle size distribution,
smooth normals. Benchmarks measure rasterizer throughput, which depends on
those properties, not on the silhouette being a literal bunny.
"""

from __future__ import annotations

import numpy as np


def cube(size: float = 1.0):
    """12-tri cube centered at origin. Returns (positions [V,3], indices [T,3])."""
    s = size * 0.5
    v = np.array([[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)],
                 np.float32)
    # faces as CCW seen from outside
    quads = [
        (0, 1, 3, 2),  # -x
        (4, 6, 7, 5),  # +x
        (0, 4, 5, 1),  # -y
        (2, 3, 7, 6),  # +y
        (0, 2, 6, 4),  # -z
        (1, 5, 7, 3),  # +z
    ]
    idx = []
    for a, b, c, d in quads:
        idx += [(a, b, c), (a, c, d)]
    return v, np.asarray(idx, np.int32)


def uv_sphere(lat: int, lon: int, radius: float = 1.0, center=(0, 0, 0)):
    """Indexed UV sphere: 2*lat*lon triangles."""
    c = np.asarray(center, np.float32)
    verts, idx = [], []
    for iy in range(lat + 1):
        phi = iy / lat * np.pi
        for ix in range(lon + 1):
            th = ix / lon * 2 * np.pi
            n = np.array([np.cos(th) * np.sin(phi), np.cos(phi),
                          np.sin(th) * np.sin(phi)], np.float32)
            verts.append(c + radius * n)
    stride = lon + 1
    for iy in range(lat):
        for ix in range(lon):
            i0 = iy * stride + ix
            i1, i2, i3 = i0 + 1, i0 + stride, i0 + stride + 1
            idx += [(i0, i2, i1), (i1, i2, i3)]
    return np.asarray(verts, np.float32), np.asarray(idx, np.int32)


def _fbm_displace(verts: np.ndarray, center, amp: float, seed: int) -> np.ndarray:
    """Deterministic multi-octave sinusoidal displacement along the radial
    direction — produces an organic, bunny-class triangle size distribution."""
    c = np.asarray(center, np.float32)
    p = verts - c
    r = np.linalg.norm(p, axis=1, keepdims=True)
    n = p / np.maximum(r, 1e-9)
    rng = np.random.default_rng(seed)
    disp = np.zeros(len(verts), np.float32)
    for octave in range(4):
        freq = 2.0 ** octave * 1.5
        a = amp / (2.0 ** octave)
        ph = rng.uniform(0, 2 * np.pi, size=3)
        w = rng.normal(size=(3, 3)).astype(np.float32)
        disp += a * (np.sin(freq * (n @ w[0]) + ph[0])
                     * np.cos(freq * (n @ w[1]) + ph[1])
                     + 0.5 * np.sin(freq * (n @ w[2]) + ph[2]))
    return c + p * (1.0 + disp[:, None] / np.maximum(r, 1e-9))


def teapot_like(target_tris: int = 1024):
    """~1k-tri organic blob (teapot-class workload): displaced UV sphere with
    a handle torus."""
    lat = max(4, int(np.sqrt(target_tris / 4)))
    lon = 2 * lat
    v, i = uv_sphere(lat, lon, 1.0)
    v = _fbm_displace(v, (0, 0, 0), 0.12, seed=7)
    v[:, 1] *= 0.75  # squash vertically, teapot-ish proportions
    return v, i


def bunny_like(target_tris: int = 69000):
    """~69k-tri organic mesh (bunny-class workload): heavily displaced dense
    UV sphere. 2*lat*lon tris with lon = 2*lat."""
    lat = max(8, int(round(np.sqrt(target_tris / 4))))
    lon = 2 * lat
    v, i = uv_sphere(lat, lon, 1.0)
    v = _fbm_displace(v, (0, 0, 0), 0.25, seed=13)
    return v, i


def mesh_to_soup(verts: np.ndarray, idx: np.ndarray, color=(0.73, 0.73, 0.73),
                 smooth: bool = True):
    """Indexed mesh -> unindexed (positions, normals, colors) triangle soup
    matching tessellate_scene's output contract."""
    tri = verts[idx]  # [T, 3, 3]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    fn = np.cross(e1, e2)
    ln = np.linalg.norm(fn, axis=1, keepdims=True)
    fn = fn / np.maximum(ln, 1e-12)
    if smooth:
        vn = np.zeros_like(verts)
        for k in range(3):
            np.add.at(vn, idx[:, k], fn)
        vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)
        normals = vn[idx].reshape(-1, 3)
    else:
        normals = np.repeat(fn, 3, axis=0)
    positions = tri.reshape(-1, 3).astype(np.float32)
    colors = np.broadcast_to(np.asarray(color, np.float32),
                             positions.shape).copy()
    return positions, normals.astype(np.float32), colors
