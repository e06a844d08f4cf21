"""Deterministic single-bounce Whitted ray tracer (torch port of
``ascii_renderer_tpu/backends/raytrace.py``; ref: raytrace.js +
raytrace_shader.js).

Semantics reproduced exactly:
  - brute-force nearest hit over spheres, then planes, then triangles with
    the first-listed primitive winning ties (argmin over the concatenated
    candidates, raytrace_shader.js:129-150);
  - diffuse shading = directional + point lights with hard shadows; shadow
    rays test spheres and triangles, not planes (raytrace_shader.js:
    152-166); the environment adds ZERO to diffuse (the shader's
    ``uEnv * max(N.y*0.0, 0.0)``);
  - point-light attenuation 1/(1 + d^2*0.05), shadow tmax = d - 2*EPS;
  - mirrors get exactly one reflection bounce, whose hit is shaded diffuse;
  - miss -> clamp(env color * intensity, 0, 1); EPS = 1e-4;
  - quads are split into two triangles, (a, b, c) + (a, c, d).

Rounding follows the reference's jitted program (``RaytraceBackend``
renders under ``jax.jit``): the helpers of ``backends/rt_core`` fuse
products where XLA's CPU code does, and the primary grid is the jitted one
(``core/camera.ndc_grid_jit`` and ``ray_dirs_jit``). Divisions are tensor
by tensor and roots go through ``core/fp.sqrt32``.

Every function takes a batch of V views: a ray channel is [V, R] (R rays
a view), a camera origin [V, 1]. ``render_rgb`` renders one camera or a
batch of cameras (``parallel.mesh.batch_cameras``) in one call.

On the card one CUDA kernel computes every primary ray of every view from
the views' bases and traces it (``ops/rt_trace``'s grid form): a frame,
a band or a farm is one launch. ``trace_rgb`` over the plain grid is its
plain version, the CPU's route.

Profiler ranges: ``rt.grid`` (the host's camera bases; on the CPU the
primary directions too), ``rt.trace`` (the kernel: rays, hits, shading
and the bounce in one launch); on the CPU ``rt.hit`` (the primary
nearest hit), ``rt.shade`` (direct light and shadow rays, both hits),
``rt.bounce`` (the mirror ray's nearest hit).
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ascii_renderer_tpu_torch.backends import rt_core as RC
from ascii_renderer_tpu_torch.backends.pt_core import BIG, V3
from ascii_renderer_tpu_torch.core.camera import (SCALAR_VIEWS, Camera,
                                                  band_of, camera_bases,
                                                  view_trig)
from ascii_renderer_tpu_torch.core.fp import fma32, sqrt32
from ascii_renderer_tpu_torch.core.frame import Frame
from ascii_renderer_tpu_torch.ops import rt_trace
from ascii_renderer_tpu_torch.scene.builder import SceneData

EPS = 1e-4


def _all_tris(scene: SceneData):
    """Scene tris followed by the quads split into (a, b, c) + (a, c, d):
    (a, b, c f32 [T, 3], mat int32 [T], valid bool [T])."""
    va = torch.cat([scene.tri_a, scene.quad_a, scene.quad_a])
    vb = torch.cat([scene.tri_b, scene.quad_b, scene.quad_c])
    vc = torch.cat([scene.tri_c, scene.quad_c, scene.quad_d])
    mat = torch.cat([scene.tri_mat, scene.quad_mat, scene.quad_mat])
    valid = torch.cat([scene.tri_valid(), scene.quad_valid(),
                       scene.quad_valid()])
    return va, vb, vc, mat, valid


class ScenePrims:
    """A scene's primitives as [P, 1] channels against [V, 1, R] rays and
    its set-light counts: made once per scene and passed to the functions
    below as ``prims`` (reading the light counts syncs a CUDA scene)."""

    def __init__(self, scene: SceneData):
        def col(x):
            return x[:, None]

        def v3(a):
            return V3(col(a[:, 0]), col(a[:, 1]), col(a[:, 2]))

        self.scene = scene
        self.sph_c, self.sph_r = v3(scene.sph_pos), col(scene.sph_rad)
        self.sph_valid = col(scene.sph_valid())
        self.pln_n, self.pln_d = v3(scene.pln_n), col(scene.pln_d)
        self.pln_valid = col(scene.pln_valid())
        va, vb, vc, self.tri_mat, tvalid = _all_tris(scene)
        self.tri_a, self.tri_e1, self.tri_e2 = va, vb - va, vc - va
        self.tri_valid = col(tvalid)
        self.ta, self.te1, self.te2 = v3(va), v3(vb - va), v3(vc - va)
        self.n_sph, self.n_pln = scene.sph_pos.shape[0], scene.pln_n.shape[0]
        self.n_tri = va.shape[0]
        # the lights that are set (the rest add exactly zero)
        self.n_dl, self.n_pt = int(scene.n_dl), int(scene.n_pt)


def _against_prims(v: V3) -> V3:
    """Ray channels [V, R] (or [V, 1] origins) -> [V, 1, R] for the
    candidate matrices; constants stay as they are."""
    return V3(*(c if c.dim() == 0 else c.unsqueeze(-2) for c in v))


def closest_hit(ro: V3, rd: V3, scene: SceneData, prims: ScenePrims = None):
    """Nearest hit over spheres / planes / tris (+ quads). ro, rd: V3 of
    [V, R] rays (ro may be [V, 1]: one origin a view). Returns (t [V, R],
    mat int32 [V, R], n V3 [V, R], hit bool [V, R])."""
    pr = prims or ScenePrims(scene)
    rob, rdb = _against_prims(ro), _against_prims(rd)
    t_s = RC.spheres_t(rob, rdb, pr.sph_c, pr.sph_r, pr.sph_valid, EPS)
    t_p = RC.planes_t(rob, rdb, pr.pln_n, pr.pln_d, pr.pln_valid, EPS)
    t_t = RC.tris_t(rob, rdb, pr.ta, pr.te1, pr.te2, pr.tri_valid, EPS)
    shp = torch.broadcast_shapes(rd.x.shape, ro.x.shape)
    V, R = shp[0], shp[-1]
    t_all = torch.cat([torch.broadcast_to(t_s, (V, pr.n_sph, R)),
                       torch.broadcast_to(t_p, (V, pr.n_pln, R)),
                       torch.broadcast_to(t_t, (V, pr.n_tri, R))], dim=1)
    k = torch.argmin(t_all, dim=1)  # the first minimum: sphere < plane < tri
    t = t_all.gather(1, k[:, None])[:, 0]
    hit = t < BIG * 0.5

    ns, np_ = pr.n_sph, pr.n_pln
    is_s = k < ns
    is_p = (k >= ns) & (k < ns + np_)
    ks = torch.clamp(k, 0, ns - 1)
    kp = torch.clamp(k - ns, 0, np_ - 1)
    kt = torch.clamp(k - ns - np_, 0, pr.n_tri - 1)

    pos = V3(*(RC._mul_add(t, d, o) for o, d in zip(ro, rd)))  # fma(t, rd, ro)
    c = scene.sph_pos[ks]
    rsel = torch.clamp(scene.sph_rad[ks], min=1e-6)
    n_sph = V3((pos.x - c[..., 0]) / rsel, (pos.y - c[..., 1]) / rsel,
               (pos.z - c[..., 2]) / rsel)
    n_pln = V3.of(scene.pln_n[kp])
    n_tri, _b0, _b1, _b2 = RC.tri_hit_info(
        ro, rd, V3.of(pr.tri_a[kt]), V3.of(pr.tri_e1[kt]),
        V3.of(pr.tri_e2[kt]))
    n = n_tri.where(~(is_s | is_p), n_sph.where(is_s, n_pln))
    mat = torch.where(is_s, scene.sph_mat[ks],
                      torch.where(is_p, scene.pln_mat[kp], pr.tri_mat[kt]))
    return t, mat, n, hit


def occluded(ro: V3, rd: V3, tmax, scene: SceneData, prims: ScenePrims = None):
    """Any hit closer than tmax over the spheres and triangles; planes are
    skipped (raytrace_shader.js:152-166). ro [V, R]; rd [V, R] or a
    constant direction (0-d channels); tmax a tensor broadcasting to
    [V, R]. Returns bool [V, R]."""
    pr = prims or ScenePrims(scene)
    rob, rdb = _against_prims(ro), _against_prims(rd)
    t_s = RC.spheres_t(rob, rdb, pr.sph_c, pr.sph_r, pr.sph_valid, EPS)
    t_t = RC.tris_t(rob, rdb, pr.ta, pr.te1, pr.te2, pr.tri_valid, EPS)
    tm = tmax.unsqueeze(-2) if tmax.dim() else tmax
    return (t_s < tm).any(dim=-2) | (t_t < tm).any(dim=-2)


def gi_V3(arr: torch.Tensor, R: int) -> V3:
    """[..., 3] -> flat V3 channels [R]."""
    return V3.of(arr.reshape(R, 3))


def shade_diffuse(pos: V3, n: V3, albedo, scene: SceneData,
                  prims: ScenePrims = None):
    """Direct lighting with hard shadows (raytrace_shader.js:168-196):
    albedo f32 [V, R, 3] -> rgb V3 [V, R]. Each light adds
    (albedo * colour) * w. The reference sums over every light slot,
    directional then point: XLA drops the sum's initial zero, so the
    first two slots' products meet in one add (the left one fused,
    fma(a0, w0, a1 * w1)) and each later one fuses into the sum. A slot
    that holds no light adds exactly zero, so only the set lights are
    traced."""
    pr = prims or ScenePrims(scene)
    terms = []  # (slot, albedo * colour channels, w) of the set lights
    # a shadow ray leaves from pos + n * EPS (the product fuses)
    sro = V3(*(RC._mul_add(nc, EPS, p) for nc, p in zip(n, pos)))

    def add(slot, col, w):
        terms.append((slot, [albedo[..., i] * col[i] for i in range(3)], w))

    # directional lights: L = normalize(-dir), the shader's negation
    for i in range(pr.n_dl):
        d = V3.of(scene.dl_dir[i])
        nd = torch.clamp(RC.norm(d), min=1e-20)
        L = V3(-d.x / nd, -d.y / nd, -d.z / nd)
        ndl = torch.clamp(RC.rdot(n, L), min=0.0)
        occ = occluded(sro, L, torch.tensor(1e5, device=ndl.device), scene,
                       pr)
        add(i, scene.dl_col[i], torch.where((ndl > 0.0) & ~occ, ndl, 0.0))

    for i in range(pr.n_pt):
        lp = scene.pt_pos[i]
        lvec = V3(lp[0] - pos.x, lp[1] - pos.y, lp[2] - pos.z)
        d2 = torch.clamp(RC.rdot(lvec, lvec), min=1e-6)
        dist = sqrt32(d2)
        L = V3(lvec.x / dist, lvec.y / dist, lvec.z / dist)
        ndl = torch.clamp(RC.rdot(n, L), min=0.0)
        occ = occluded(sro, L, dist - 2.0 * EPS, scene, pr)
        att = torch.reciprocal(RC._mul_add(d2, 0.05, 1.0))  # 1 + d2*0.05
        add(scene.dl_dir.shape[0] + i, scene.pt_col[i],
            torch.where((ndl > 0.0) & ~occ, ndl * att, 0.0))
    lo = [torch.zeros_like(pos.x) for _ in range(3)]
    rest = terms
    if len(terms) >= 2 and (terms[0][0], terms[1][0]) == (0, 1):
        (_s0, a0, w0), (_s1, a1, w1), rest = terms[0], terms[1], terms[2:]
        lo = [fma32(a0[i], w0, a1[i] * w1) for i in range(3)]
    for _slot, a, w in rest:
        lo = [fma32(a[i], w, lo[i]) for i in range(3)]
    return V3(*lo)


def _camera_batch(camera: Camera):
    """(pos f32 [V, 3], yaw, pitch, fov_y f32 [V]) of one camera or a
    batch of them."""
    return (camera.pos.reshape(-1, 3), camera.yaw.reshape(-1),
            camera.pitch.reshape(-1), camera.fov_y.reshape(-1))


def render_rgb(scene: SceneData, camera: Camera, rows: int, cols: int,
               pixel_aspect: float, row_lo=0, n_rows: int | None = None,
               prims: ScenePrims = None) -> torch.Tensor:
    """Full deterministic trace -> linear RGB f32 [rows, cols, 3] in [0, 1]
    on the scene's device; for a batch of V cameras, [V, rows, cols, 3]
    from one batched call. ``row_lo`` / ``n_rows`` render the row band
    [row_lo, row_lo + n_rows) of the global grid ([n_rows, cols, 3], the
    hook of ``parallel.mesh.render_rows_sharded``): the shading is per
    pixel, so a band equals those rows of the full frame bit for bit.
    On the CPU the plain grid, then ``trace_rgb``; on any other device
    one launch of ``ops/rt_trace``'s kernel in its grid form, which
    raises where it cannot run (above ``SCALAR_VIEWS`` views its trig
    form: the views' trig from the host, their bases formed on the
    card)."""
    dev = scene.sph_pos.device
    pr = prims or ScenePrims(scene)
    pos_c, yaw, pitch, fov = _camera_batch(camera)
    rows_out = band_of(rows, row_lo, n_rows)
    V, R = pos_c.shape[0], rows_out * cols
    with record_function("rt.grid"):
        if dev.type != "cpu" and V > SCALAR_VIEWS:
            grid = rt_trace.Grid(None, rows, cols, pixel_aspect, row_lo,
                                 rows_out, view_trig(pos_c, yaw, pitch, fov))
        else:
            grid = rt_trace.Grid(camera_bases(yaw, pitch, fov), rows, cols,
                                 pixel_aspect, row_lo, rows_out)
        rd3 = rt_trace.grid_rays(grid, dev) if dev.type == "cpu" else None
    if rd3 is None:
        rgb = rt_trace.trace(scene, pr, pos_c, None, _fuse(pr, V, R),
                             grid=grid)
    else:
        rgb = trace_rgb(scene, pr, pos_c.to(dev, torch.float32), rd3)
    rgb = rgb.reshape(V, rows_out, cols, 3)
    return rgb if camera.yaw.dim() else rgb[0]


def _fuse(pr: ScenePrims, V: int, R: int):
    """The kernel's sphere decisions (primary, other rays) for V views of
    R rays: one origin a view, then one a ray."""
    return (RC.sphere_c_fused((V, 1, 1), pr.n_sph),
            RC.sphere_c_fused((V, 1, R), pr.n_sph))


def trace(scene: SceneData, pr: ScenePrims, cam: torch.Tensor,
          rd3: torch.Tensor) -> torch.Tensor:
    """Everything ``render_rgb`` does after its grid, for ``cam`` f32
    [V, 3] origins and ``rd3`` f32 [V, R, 3] primary directions -> RGB f32
    [V, R, 3]: ``trace_rgb`` on CPU tensors; on any other device
    ``ops/rt_trace``'s kernel, one launch for every view, which raises
    where it cannot run."""
    if rd3.device.type == "cpu":
        return trace_rgb(scene, pr, cam, rd3)
    return rt_trace.trace(scene, pr, cam, rd3,
                          _fuse(pr, rd3.shape[0], rd3.shape[1]))


def trace_rgb(scene: SceneData, pr: ScenePrims, cam: torch.Tensor,
              rd3: torch.Tensor) -> torch.Tensor:
    """The plain version of ``ops/rt_trace``'s kernel: everything
    ``render_rgb`` does after its grid, for ``cam`` f32 [V, 3] origins and
    ``rd3`` f32 [V, R, 3] primary directions -> RGB f32 [V, R, 3]."""
    rd = V3.of(rd3)
    ro = V3(cam[:, 0:1], cam[:, 1:2], cam[:, 2:3])
    env_raw = scene.env_color * scene.env_intensity
    env = torch.clamp(env_raw, 0.0, 1.0)

    with record_function("rt.hit"):
        t, mat, n, hit = closest_hit(ro, rd, scene, pr)
        pos = V3(*(RC._mul_add(t, d, o) for o, d in zip(ro, rd)))
        albedo = scene.mat_albedo[mat.long()]
        refl = scene.mat_reflective[mat.long()]
    with record_function("rt.shade"):
        col_diff = shade_diffuse(pos, n, albedo, scene, pr)

    # one deterministic mirror bounce (raytrace_shader.js:228-239)
    with record_function("rt.bounce"):
        rdir = RC.reflect(rd, n)
        ro2 = V3(*(RC._mul_add(nc, EPS, p) for nc, p in zip(n, pos)))
        t2, mat2, n2, hit2 = closest_hit(ro2, rdir, scene, pr)
        pos2 = V3(*(RC._mul_add(t2, d, o) for o, d in zip(ro2, rdir)))
        alb2 = scene.mat_albedo[mat2.long()]
    with record_function("rt.shade"):
        col_refl_hit = shade_diffuse(pos2, n2, alb2, scene, pr).stack()
        col_refl = torch.where(hit2[..., None], col_refl_hit, env_raw)
        col = torch.where(refl[..., None], col_refl, col_diff.stack())
        col = torch.where(hit[..., None], col, env)
        return torch.clamp(col, 0.0, 1.0)


class RaytraceBackend:
    """Backend-protocol wrapper: set_scene / render / dispose (contract 5),
    on ``device`` (CUDA unless the caller asks for the CPU)."""

    name = "raytrace"

    def __init__(self, cfg=None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self._scene: SceneData | None = None
        self._prims = None

    def set_scene(self, scene: SceneData):
        dev = scene.sph_pos.device
        if dev.type != self.device.type or self.device.index not in (
                None, dev.index):
            raise ValueError(f"RaytraceBackend on {self.device} got a scene "
                             f"on {dev}")
        self.device = dev
        self._scene = scene
        self._prims = ScenePrims(scene)

    def render(self, time_sec, camera: Camera, rows: int, cols: int,
               pixel_aspect: float = 1.0) -> Frame:
        if self._scene is None:
            return Frame.blank(rows, cols, device=self.device)
        rgb = render_rgb(self._scene, camera, rows, cols, pixel_aspect,
                         prims=self._prims)
        with record_function("frame.from_float"):
            return Frame.from_float(rgb)

    def dispose(self):
        self._scene = None
        self._prims = None
