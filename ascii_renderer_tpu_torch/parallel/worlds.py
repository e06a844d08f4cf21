"""Programs that run on every rank of a world (``parallel.mesh.run_world``)
and return numpy results: a train trajectory over a (dp, sp) mesh, and one
scene's sharded view farm, row-band frames and row-band raster. Each rank
renders on its own device (``cuda:<rank>`` or the CPU); ``run_world``
spawns the ranks, which import this module and nothing of JAX.
``local_renders`` renders what the sharded renders must equal, in one
process.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def rank_device(device_type: str) -> torch.device:
    """The device of this rank: its card for "cuda", else the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", dist.get_rank())
    return torch.device("cpu")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def train_trajectory(device_type: str, axis_sizes, verts, colors, faces,
                     cameras, targets, rows: int, cols: int, *,
                     lr: float = 5e-2, n_single: int = 3, n_scan: int = 0,
                     opt_state=None, pixel_aspect: float = 1.0) -> dict:
    """``n_single`` calls of ``make_train_step`` on a ("dp", "sp") mesh of
    ``axis_sizes``, then, from the same first state, one call of
    ``make_train_steps(n_steps=n_scan)`` when n_scan > 0. The first state
    is fresh, or carried (``utils.from_jax.train_state_from_numpy``) when
    ``opt_state`` (a dict mu, nu, count of numpy arrays) is given.
    Returns numpy: losses [n_single] and the verts / colors after each
    step; scan_losses, scan_verts and scan_colors."""
    from ascii_renderer_tpu_torch.parallel import train as T
    from ascii_renderer_tpu_torch.parallel.mesh import make_mesh
    from ascii_renderer_tpu_torch.utils.from_jax import (
        train_state_from_numpy)
    dev = rank_device(device_type)
    mesh = make_mesh(axis_sizes, ("dp", "sp"), device_type)
    if opt_state is None:
        state0 = T.init_train_state(verts, colors, device=dev)
    else:
        state0 = train_state_from_numpy(verts, colors, opt_state["mu"],
                                        opt_state["nu"], opt_state["count"],
                                        dev)
    faces = torch.as_tensor(np.asarray(faces), device=dev)
    opt = T.adam(lr)
    kw = dict(optimizer=opt, pixel_aspect=pixel_aspect)
    step = T.make_train_step(mesh, faces, rows, cols, **kw)
    out = {"losses": [], "verts": [], "colors": []}
    state = state0
    for _ in range(n_single):
        state, loss = step(state, cameras, targets)
        out["losses"].append(float(loss))
        out["verts"].append(_np(state.verts))
        out["colors"].append(_np(state.colors))
    out = {k: np.asarray(v) for k, v in out.items()}
    if n_scan:
        steps = T.make_train_steps(mesh, faces, rows, cols, n_steps=n_scan,
                                   **kw)
        s2, losses = steps(state0, cameras, targets)
        out.update(scan_losses=_np(losses), scan_verts=_np(s2.verts),
                   scan_colors=_np(s2.colors))
    return out


def mesh_facts(device_type: str, axis_sizes, axis_names) -> dict:
    """A mesh's shape, names and this rank's coordinates, the world's
    backend, why a mesh of the other device type was refused, and the
    modules of JAX or of the JAX package this rank has loaded (none)."""
    import sys
    from ascii_renderer_tpu_torch.parallel.mesh import make_mesh, mesh_axis
    mesh = make_mesh(axis_sizes, axis_names, device_type)
    other = "cpu" if device_type == "cuda" else "cuda"
    try:
        make_mesh(axis_sizes, axis_names, other)
        refused = ""
    except RuntimeError as e:
        refused = str(e)
    return {"rank": dist.get_rank(), "backend": dist.get_backend(),
            "names": tuple(mesh.mesh_dim_names),
            "axes": {a: mesh_axis(mesh, a)[:2] for a in axis_names},
            "refused": refused,
            "jax_modules": sorted(
                m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "optax",
                                        "ascii_renderer_tpu"))}


def soup_scene(device):
    """The row-band raster fixture (the reference's band test): a 12 x 16
    sphere soup, a lit scene and a camera above it."""
    from ascii_renderer_tpu_torch.core.camera import Camera
    from ascii_renderer_tpu_torch.geom import meshes
    from ascii_renderer_tpu_torch.scene.builder import SceneBuilder
    v, i = meshes.uv_sphere(12, 16, radius=1.2, center=(0.0, 1.0, 0.0))
    soup = tuple(torch.from_numpy(x).to(device) for x in meshes.mesh_to_soup(
        v, i, color=(0.8, 0.5, 0.4)))
    sb = SceneBuilder().set_env_light([0.2, 0.22, 0.25], 1.0)
    sb.add_dir_light([-0.5, -0.7, -0.6], [1, 1, 1], 0.9)
    cam = Camera.create(pos=(2.5, 1.5, 3.0), yaw=-2.3, pitch=-0.3)
    T = soup[0].shape[0] // 3
    caps = dict(big_cap=64, r_cap=64 * 32, pair_cap=8 * T + 4096)
    return soup, sb.build(device=device), cam, caps


def pt_fixture(device):
    """The row-band path-tracer fixture: the demo room with its atlas at
    the poster pose, and render_pt's keywords (spp 2, 2 bounces)."""
    import math

    from ascii_renderer_tpu_torch.atlas.io import demo_atlas
    from ascii_renderer_tpu_torch.core.camera import Camera
    from ascii_renderer_tpu_torch.scene.demo import create_demo_scene
    sb = create_demo_scene()
    sb.set_atlas(demo_atlas())
    cam = Camera.create(pos=(0, 2.5, 6), yaw=-math.pi / 2)
    kw = dict(pixel_aspect=0.5, spp=2, bounces=2,
              light_color=(16.86, 10.76, 8.2))
    return sb.build(min_pad=1, device=device), cam, kw


# the grouped generations the sharded raster runs: B9d, B9f and the
# headline's B1
KERNELS = ("subtile3", "subtile6", "subtile8")


def sharded_renders(device_type: str, rows: int, cols: int) -> dict:
    """One scene of each renderer over meshes of every rank: the rt_demo
    farm of 2 n orbit views (``render_views_sharded``), its scene camera's
    frame in row bands (``render_rows_sharded``), the PT fixture's frame
    in row bands (frame seed 3; rgb and alpha; every band pixel marked
    active, B5's compacted stream), and the raster fixture through
    ``render_soup_rows_sharded`` for each of KERNELS (rgb and overflow).
    Returns numpy arrays, whole on every rank."""
    from ascii_renderer_tpu_torch.backends.pathtrace import render_pt
    from ascii_renderer_tpu_torch.backends.raster import (
        render_soup_rows_sharded)
    from ascii_renderer_tpu_torch.backends.raytrace import render_rgb
    from ascii_renderer_tpu_torch.parallel.mesh import (
        make_mesh, orbit_cameras, render_rows_sharded, render_views_sharded)
    from ascii_renderer_tpu_torch.scene.demo import create_rt_demo_scene
    n = dist.get_world_size()
    dev = rank_device(device_type)
    vmesh = make_mesh((n,), ("views",), device_type)
    rmesh = make_mesh((n,), ("rows",), device_type)
    scene = create_rt_demo_scene().build(min_pad=1, device=dev)
    cams = orbit_cameras(2 * n, center=(0, 1.0, 1.0))
    out = {"views": _np(render_views_sharded(
        lambda sc, c: render_rgb(sc, c, rows, cols, 0.5), scene, cams,
        vmesh))}
    out["rt_rows"] = _np(render_rows_sharded(
        lambda sc, c, lo, nr: render_rgb(sc, c, rows, cols, 0.5, row_lo=lo,
                                         n_rows=nr),
        scene, scene.camera, rmesh, rows, cols))
    pscene, pcam, pkw = pt_fixture(dev)

    def pt_band(sc, c, lo, nr):
        pa = torch.ones((nr, cols), dtype=torch.bool, device=dev)
        return render_pt(sc, c, 0.0, 3, rows=rows, cols=cols, row_lo=lo,
                         n_rows=nr, pixel_active=pa, **pkw)

    rgb, a = render_rows_sharded(pt_band, pscene, pcam, rmesh, rows, cols)
    out["pt_rows"], out["pt_alpha"] = _np(rgb), _np(a)
    soup, rscene, rcam, caps = soup_scene(dev)
    for kernel in KERNELS:
        rgb, over = render_soup_rows_sharded(*soup, rscene, rcam, rows, cols,
                                             0.5, rmesh, kernel=kernel,
                                             **caps)
        out[f"raster_{kernel}"], out[f"over_{kernel}"] = _np(rgb), _np(over)
    return out


def local_renders(device, n: int, rows: int, cols: int) -> dict:
    """What ``sharded_renders`` over n ranks must return, rendered whole
    on ``device`` in this process: the farm's 2 n views, the ray-traced
    and path-traced frames and the raster fixture's frame for each
    kernel. Returns numpy arrays under sharded_renders' keys."""
    from ascii_renderer_tpu_torch.backends.pathtrace import render_pt
    from ascii_renderer_tpu_torch.backends.raster import render_soup_diag
    from ascii_renderer_tpu_torch.backends.raytrace import render_rgb
    from ascii_renderer_tpu_torch.parallel.mesh import orbit_cameras
    from ascii_renderer_tpu_torch.scene.demo import create_rt_demo_scene
    scene = create_rt_demo_scene().build(min_pad=1, device=device)
    cams = orbit_cameras(2 * n, center=(0, 1.0, 1.0))
    out = {"views": render_rgb(scene, cams, rows, cols, 0.5),
           "rt_rows": render_rgb(scene, scene.camera, rows, cols, 0.5)}
    pscene, pcam, pkw = pt_fixture(device)
    out["pt_rows"], out["pt_alpha"] = render_pt(pscene, pcam, 0.0, 3,
                                                rows=rows, cols=cols, **pkw)
    soup, rscene, rcam, caps = soup_scene(device)
    for kernel in KERNELS:
        out[f"raster_{kernel}"], _d = render_soup_diag(
            *soup, rscene, rcam, rows, cols, 0.5, v_cap=4096, kernel=kernel,
            **caps)
    return {k: _np(x) for k, x in out.items()}
