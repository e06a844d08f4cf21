"""The ray tracer's frame: the CUDA kernel of ``csrc/rt_trace.cu``, every
view of a batch in one launch. It reads its primary rays from ``rd3``, or,
in its grid form (``trace(..., grid=Grid(...))``, the render path's),
computes them itself from each view's camera basis with the jitted grid's
rounding (``csrc/ray_dir.cuh``, which ``csrc/ray_grid.cu``'s jitted grid
shares), so that a frame, a band or a farm is one launch and its rays
make no round trip through device memory; ``grid_rays`` is the plain
version of those rays (``core/camera.ndc_grid_jit`` and
``ray_dirs_jit``). Above ``core/camera.SCALAR_VIEWS`` views the render
path hands it each view's origin and trig (``core/camera.view_trig``,
libm on the host, one call a distinct angle) and the launch forms the
bases too, once a block in shared memory (``trig_views_ref`` is their
plain version), so a farm's host work is its trig and one copy. A tile of
L lanes (1-32) shares a ray and splits its loops over the scene's valid
slots, which each block either stages in shared memory (compacted in slot
order) or reads from the global arrays in the same order. The launch
picks its own form from timed variants (``tools/rt_variants.py``): L from
the ray count, so that a 96x36 frame fills the card (32 lanes) and the
farm keeps one thread a ray, and staged slots only below 4 lanes. Its
bound is the operations the valid slots need (``chip_smoke._rt_ops``).
Its plain version is ``backends/raytrace.trace_rgb`` (of ``grid_rays``
in the grid form)
(``closest_hit``, ``occluded``, ``shade_diffuse`` and the mirror bounce,
rounded as the reference's jitted program by ``backends/rt_core``), and
``backends/raytrace.trace`` picks between the two by the rays' device.

Stands for XLA code, not a Pallas kernel: ``closest_hit``, ``occluded``,
``shade_diffuse`` and the bounce of ``render_rgb`` in
``ascii_renderer_tpu/backends/raytrace.py`` (:68, :115, :136, :166),
under ``jax.jit``.

Where the reference's compiler fuses a product into an add depends on the
operands' shapes (``rt_core._mul_add``). ``FUSE`` is the kernel's
decision at every fuse site of ``rt_core``'s intersection helpers, for the
four kinds of ray: primary rays (one origin a view), bounce rays, and
shadow rays toward a directional light (one direction for every ray) and
toward a point light. Each string holds one letter per helper call of
the function, in the order the calls begin: "F" where the product fuses
(for ``dot`` and ``_diff``: where the left product fuses), "-" where it
is rounded apart; ``HELPERS`` names the calls. The table holds for a
frame of more than one ray a view and more than one sphere slot; the
caller passes the one decision that varies, the sphere's
``dot(oc, oc) - r*r``, as ``rt_core.sphere_c_fused`` takes it from the
shapes of each call.
Every fuse site of ``backends/raytrace`` itself (the hit points, the
offset origins, the lights' dots and attenuation) fuses in every case.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ascii_renderer_tpu_torch.core.camera import (band_of, bases_from_trig,
                                                  jit_grid_consts,
                                                  ndc_grid_jit, ray_dirs_jit)
from ascii_renderer_tpu_torch.ops import _build

launches = 0  # kernel launches by trace
LAUNCHES_PER_CALL = {"trace": 1}  # kernels a call launches

_DOT = "dot _mul_add"
_CROSS = "_diff _diff _diff"
HELPERS = {
    "spheres_t": f"{_DOT} {_DOT} _sub_mul _mul_sub",
    "planes_t": f"{_DOT} {_DOT}",
    "tris_t": f"{_CROSS} {_DOT} {_DOT} {_CROSS} {_DOT} {_DOT}",
    "tri_hit_info": f"{_CROSS} {_DOT} {_DOT} {_CROSS} {_DOT} {_CROSS} "
                    f"{_DOT} {_DOT}",
    "reflect": "_mul_add _mul_add _sub_mul _sub_mul",
}
_HIT = {"spheres_t": "FFFFFF", "planes_t": "FFFF", "tris_t": "F" * 14,
        "tri_hit_info": "F" * 19}
FUSE = {
    "primary": _HIT,
    "bounce": {**_HIT, "spheres_t": "FFFF-F", "reflect": "FFFF"},
    "shadow_dir": {"spheres_t": "FFFF-F", "tris_t": "F" * 14},
    "shadow_point": {"spheres_t": "FFFF-F", "tris_t": "F" * 14},
}


def light_pair(scene, n_dl: int, n_pt: int) -> bool:
    """Whether the first two set light slots are 0 and 1, so that their
    terms meet in one fused add (``raytrace.shade_diffuse``)."""
    slots = list(range(n_dl)) + [scene.dl_dir.shape[0] + i
                                 for i in range(n_pt)]
    return slots[:2] == [0, 1]


LANES = (1, 2, 4, 8, 16, 32)  # the lanes a ray the kernel takes
STAGES = {"auto": 0, "staged": 1, "global": 2}  # the C entry's stage


def launch_form(n_rays: int, pr) -> tuple[int, bool]:
    """(lanes a ray, staged) that a launch of ``n_rays`` rays over the
    scene ``pr`` takes by its own choice (the C entry's rt_trace_lanes and
    rt_trace_staged; builds the kernels)."""
    lib = _build.lib()
    lanes = lib.rt_trace_lanes(n_rays)
    return lanes, bool(lib.rt_trace_staged(lanes, pr.n_sph, pr.n_pln,
                                           pr.n_tri))


class Grid(NamedTuple):
    """The primary rays of ``trace``'s grid form: the row band [row_lo,
    row_lo + band) of the rows x cols cell grid of every view, rounded as
    the reference's jitted grid; ``bases`` is ``core/camera.camera_bases``'
    tuple (uu, vv, ww f32 [V, 3], focal f32 [V]) on the host, or None with
    ``trig``, ``core/camera.view_trig``'s f32 [V, 8] (each view's origin
    and its trig: the kernel forms the bases, ``trig_views_ref``)."""
    bases: tuple | None
    rows: int
    cols: int
    pixel_aspect: float
    row_lo: int
    band: int
    trig: np.ndarray | None = None


def trig_bases(trig: np.ndarray):
    """``camera_bases``' tuple of the views of a ``view_trig`` table: the
    plain chain ``bases_from_trig`` (CPU tensors)."""
    uu, vv, ww, focal = bases_from_trig(*np.asarray(trig)[:, 3:].T)
    return (*(torch.from_numpy(np.ascontiguousarray(v.T))
              for v in (uu, vv, ww)), torch.from_numpy(focal))


def trig_views_ref(trig: np.ndarray) -> torch.Tensor:
    """The plain version of the bases the grid form forms on the card from
    a ``view_trig`` table: each view's 12 floats, f32 [V, 12] on the host,
    its origin, uu, vv and focal * ww (``bases_from_trig``)."""
    uu, vv, ww, focal = trig_bases(trig)
    return torch.cat([torch.from_numpy(np.asarray(trig)[:, :3]), uu, vv,
                      focal[:, None] * ww], dim=1)


def grid_rays(grid: Grid, device) -> torch.Tensor:
    """The plain version of the grid form's rays: f32 [V, band * cols, 3]
    on ``device`` (``ndc_grid_jit`` and ``ray_dirs_jit``; a trig grid's
    bases through ``trig_bases``), bit for bit the directions the kernel
    computes."""
    px, py = ndc_grid_jit(grid.rows, grid.cols, grid.pixel_aspect, device,
                          grid.row_lo, grid.band)
    bases = grid.bases if grid.trig is None else trig_bases(grid.trig)
    rd = ray_dirs_jit(px, py, tuple(b.to(device, torch.float32)
                                    for b in bases))
    return rd.reshape(rd.shape[0], grid.band * grid.cols, 3)


def _grid_views(grid: Grid, cam) -> torch.Tensor:
    """Each view's floats of the grid form on the host: f32 [V, 12], its
    origin, uu, vv and focal * ww (rounded here, as the plain grid rounds
    it), or a trig grid's table f32 [V, 8]."""
    if grid.rows < 1 or grid.cols < 1:
        raise ValueError(f"trace: a {grid.rows} x {grid.cols} grid")
    band_of(grid.rows, grid.row_lo, grid.band)
    if grid.trig is not None:
        views = torch.from_numpy(np.ascontiguousarray(grid.trig,
                                                      np.float32))
        if views.dim() != 2 or views.shape[1] != 8:
            raise ValueError(f"trace: a trig table [V, 8], got "
                             f"{tuple(views.shape)}")
        V = views.shape[0]
    else:
        uu, vv, ww, focal = (b.to("cpu", torch.float32) for b in grid.bases)
        V = uu.shape[0]
    if tuple(cam.shape) != (V, 3):
        raise ValueError(f"trace: expected cam [V, 3] for the grid's {V} "
                         f"views, got {tuple(cam.shape)}")
    if grid.trig is not None:
        return views
    return torch.cat([cam.to("cpu", torch.float32), uu, vv,
                      focal[:, None] * ww], dim=1)


def trace(scene, pr, cam, rd3, sphere_c, *, grid: Grid | None = None,
          lanes: int = 0, stage: str = "auto") -> torch.Tensor:
    """Linear RGB f32 [V, R, 3] in [0, 1] of R primary rays a view, one
    launch for every view: ``cam`` f32 [V, 3] the views' origins, ``rd3``
    f32 [V, R, 3] their directions, or None with ``grid`` (the grid form:
    the kernel computes the rays of ``grid`` itself, R = band * cols;
    ``cam`` may lie on the host, and the views' origins and bases reach
    the card as launch arguments for one view, in one copy for a batch),
    ``pr`` the scene's ``raytrace.ScenePrims``, ``sphere_c`` (primary,
    other rays) whether the sphere's c fuses. ``lanes`` (one of LANES; 0:
    the launch's own choice) and ``stage`` ("staged", "global"; "auto":
    the launch's own choice) force a form of the kernel, for its tests and
    timings; every form gives the same bits. A trig grid's bases are formed
    on the card, once a block in shared memory (a block spanning more views
    than that forms them a ray). CUDA tensors only: the CPU's route is
    ``raytrace.trace`` (``raytrace.render_rgb``'s for a grid)."""
    global launches
    if (lanes and lanes not in LANES) or stage not in STAGES:
        raise ValueError(f"trace: lanes {lanes} (0 or one of {LANES}), "
                         f"stage {stage!r} (one of {tuple(STAGES)})")
    if (rd3 is None) == (grid is None):
        raise ValueError("trace: give one of the rays (rd3) and their "
                         "grid")
    if grid is None:
        V, R = rd3.shape[0], rd3.shape[1]
        if tuple(rd3.shape) != (V, R, 3) or tuple(cam.shape) != (V, 3):
            raise ValueError(f"trace: expected cam [V, 3] and rd3 "
                             f"[V, R, 3], got {tuple(cam.shape)} and "
                             f"{tuple(rd3.shape)}")
        rays = (cam, rd3)
    else:
        views = _grid_views(grid, cam)
        V, R = views.shape[0], grid.band * grid.cols
        one = None
        if V == 1 and grid.trig is None:  # launch arguments
            one = (ctypes.c_float * 12)(*views[0].tolist())
            rays = ()
        else:  # one copy
            rays = (views.to(scene.sph_pos.device),)
    floats = (*rays, scene.sph_pos, scene.sph_rad, scene.pln_n,
              scene.pln_d, pr.tri_a, pr.tri_e1, pr.tri_e2, scene.mat_albedo,
              scene.dl_dir, scene.dl_col, scene.pt_pos, scene.pt_col,
              scene.env_color, scene.env_intensity)
    flags = (pr.sph_valid, pr.pln_valid, pr.tri_valid, scene.mat_reflective)
    ints = (scene.sph_mat, scene.pln_mat, pr.tri_mat)
    _build.require_cuda(*floats, *flags, *ints, what="trace")
    if any(t.dtype != torch.float32 for t in floats) or any(
            t.dtype != torch.bool for t in flags) or any(
            t.dtype != torch.int32 for t in ints):
        raise ValueError("trace: expected float32 geometry, bool flags and "
                         "int32 materials")
    if min(pr.n_sph, pr.n_pln, pr.n_tri) < 1:
        raise ValueError("trace: every primitive kind needs a slot")
    if V * R >= 2 ** 31:
        raise ValueError(f"trace: {V * R} rays, at most 2^31 - 1")
    dev = scene.sph_pos.device
    out = torch.empty((V, R, 3), dtype=torch.float32, device=dev)
    if V * R == 0:
        return out
    if grid is None:
        ray_args = (cam.data_ptr(), rd3.data_ptr(), None, None, 0, 0, 0, 0,
                    0.0, 0.0, 0.0)
    else:
        ray_args = (None, None, rays[0].data_ptr() if rays else None, one,
                    int(grid.trig is not None),
                    grid.rows, grid.cols, grid.row_lo,
                    *jit_grid_consts(grid.rows, grid.cols,
                                     grid.pixel_aspect))
    with record_function("rt.trace"):
        err = _build.lib().rt_trace_launch(
            *ray_args, out.data_ptr(), V, R,
            scene.sph_pos.data_ptr(), scene.sph_rad.data_ptr(),
            pr.sph_valid.data_ptr(), scene.sph_mat.data_ptr(), pr.n_sph,
            scene.pln_n.data_ptr(), scene.pln_d.data_ptr(),
            pr.pln_valid.data_ptr(), scene.pln_mat.data_ptr(), pr.n_pln,
            pr.tri_a.data_ptr(), pr.tri_e1.data_ptr(), pr.tri_e2.data_ptr(),
            pr.tri_valid.data_ptr(), pr.tri_mat.data_ptr(), pr.n_tri,
            scene.mat_albedo.data_ptr(), scene.mat_reflective.data_ptr(),
            scene.dl_dir.data_ptr(), scene.dl_col.data_ptr(), pr.n_dl,
            scene.pt_pos.data_ptr(), scene.pt_col.data_ptr(), pr.n_pt,
            int(light_pair(scene, pr.n_dl, pr.n_pt)),
            scene.env_color.data_ptr(), scene.env_intensity.data_ptr(),
            *(int(f) for f in sphere_c), lanes, STAGES[stage],
            _build.stream_ptr(dev))
        launches += 1
        _build.check(err, "rt_trace_launch")
    return out
