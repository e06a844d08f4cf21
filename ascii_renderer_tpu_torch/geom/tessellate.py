"""Scene -> triangle-soup tessellation for the raster backend
(ref: raster.js:148-266 _rebuildGeometry). A numpy copy of
``ascii_renderer_tpu/geom/tessellate.py`` reading the port's tensor
``SceneData`` on the host.

Policies reproduced from the reference:
  - triangles pass through verbatim with face normals;
  - planes become 20-unit half-size quads (2 tris) spanned by an orthobasis
    of the normal (raster.js:177-193);
  - spheres become 12x16 lat/long UV meshes with smooth normals and the
    reference's exact winding (raster.js:196-219: (i0,i2,i1), (i1,i2,i3));
  - per-vertex color = material albedo (we read the packed unified table;
    the reference mis-indexed it and fell back to gray — deliberate fix).
Quads additionally tessellate into two tris (a,b,c)+(a,c,d) — the reference
raster never read quads at all (SURVEY quirk, fixed so the demo scene
renders).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ascii_renderer_tpu_torch.scene.builder import SceneData

PLANE_HALF_SIZE = 20.0
SPHERE_LAT = 12
SPHERE_LON = 16


def _face_normal(a, b, c):
    n = np.cross(b - a, c - a)
    ln = np.linalg.norm(n)
    return n / ln if ln > 1e-8 else np.array([0.0, 1.0, 0.0])


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def tessellate_scene(scene: SceneData) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (positions f32 [V,3], normals f32 [V,3], colors f32 [V,3])
    as an UNINDEXED triangle list (V = 3*T). Host-side, once per scene —
    the analog of the reference's VBO rebuild on setScene."""
    alb = _np(scene.mat_albedo)
    positions, normals, colors = [], [], []

    def push_tri(a, b, c, col, na=None, nb=None, nc=None):
        n = _face_normal(a, b, c)
        positions.extend([a, b, c])
        normals.extend([na if na is not None else n,
                        nb if nb is not None else n,
                        nc if nc is not None else n])
        colors.extend([col, col, col])

    def mat_color(mid):
        return np.clip(alb[int(mid)], 0.0, 1.0)

    n_tri = int(scene.n_tri)
    ta, tb, tc = (_np(x) for x in (scene.tri_a, scene.tri_b, scene.tri_c))
    tm = _np(scene.tri_mat)
    for i in range(n_tri):
        push_tri(ta[i], tb[i], tc[i], mat_color(tm[i]))

    # Quads are emitted DOUBLE-SIDED (both windings). The tracers treat all
    # geometry double-sided by flipping the normal toward the ray
    # (shader_utils.js:54-56); the reference raster never consumed quads at
    # all, so visibility from either side is the consistent extension.
    n_quad = int(scene.n_quad)
    qa, qb, qc, qd = (_np(x) for x in
                      (scene.quad_a, scene.quad_b, scene.quad_c, scene.quad_d))
    qm = _np(scene.quad_mat)
    for i in range(n_quad):
        col = mat_color(qm[i])
        push_tri(qa[i], qb[i], qc[i], col)
        push_tri(qa[i], qc[i], qd[i], col)
        push_tri(qa[i], qc[i], qb[i], col)
        push_tri(qa[i], qd[i], qc[i], col)

    n_pln = int(scene.n_pln)
    pn = _np(scene.pln_n)
    pdist = _np(scene.pln_d)
    pm = _np(scene.pln_mat)
    for i in range(n_pln):
        n = pn[i] / (np.linalg.norm(pn[i]) or 1.0)
        p0 = -pdist[i] * n
        tmp = np.array([0.0, 1.0, 0.0]) if abs(n[1]) < 0.99 else np.array([1.0, 0.0, 0.0])
        b1 = np.cross(n, tmp)
        b1 /= np.linalg.norm(b1)
        b2 = np.cross(n, b1)
        b2 /= np.linalg.norm(b2)
        s = PLANE_HALF_SIZE
        col = mat_color(pm[i])
        v0 = p0 - s * b1 - s * b2
        v1 = p0 + s * b1 - s * b2
        v2 = p0 + s * b1 + s * b2
        v3 = p0 - s * b1 + s * b2
        push_tri(v0, v1, v2, col)
        push_tri(v0, v2, v3, col)

    n_sph = int(scene.n_sph)
    sp = _np(scene.sph_pos)
    sr = _np(scene.sph_rad)
    sm = _np(scene.sph_mat)
    for i in range(n_sph):
        c, r, col = sp[i], sr[i], mat_color(sm[i])
        grid_v = []  # [(pos, normal)] on the (LAT+1)x(LON+1) grid
        for iy in range(SPHERE_LAT + 1):
            phi = iy / SPHERE_LAT * np.pi
            spv, cpv = np.sin(phi), np.cos(phi)
            for ix in range(SPHERE_LON + 1):
                th = ix / SPHERE_LON * 2 * np.pi
                n = np.array([np.cos(th) * spv, cpv, np.sin(th) * spv])
                grid_v.append((c + r * n, n))
        stride = SPHERE_LON + 1
        for iy in range(SPHERE_LAT):
            for ix in range(SPHERE_LON):
                i0 = iy * stride + ix
                i1, i2, i3 = i0 + 1, i0 + stride, i0 + stride + 1
                for (x, y, z) in ((i0, i2, i1), (i1, i2, i3)):
                    push_tri(grid_v[x][0], grid_v[y][0], grid_v[z][0], col,
                             grid_v[x][1], grid_v[y][1], grid_v[z][1])

    if not positions:
        z = np.zeros((0, 3), np.float32)
        return z, z.copy(), z.copy()
    return (np.asarray(positions, np.float32),
            np.asarray(normals, np.float32),
            np.asarray(colors, np.float32))
