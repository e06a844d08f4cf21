"""Device mesh, view sharding and row bands (torch port of
``ascii_renderer_tpu/parallel/mesh.py``), over ``torch.distributed``.

The reference vmaps a one-view render over a batch of cameras and shards
the batch over a device mesh (BASELINE config 4, the 1,024-camera render
farm), or shards one frame's rows (``render_rows_sharded``). Here:

- on one card the views are the leading batch axis of one batched call
  (``render_views``): the renderers of the port take a batched camera
  (``batch_cameras``) and run every view together;
- across processes, ``make_mesh`` names the dimensions of the world
  (a ``DeviceMesh``: NCCL for "cuda", gloo for "cpu");
  ``render_views_sharded`` renders each rank's contiguous shard of the
  views and ``render_rows_sharded`` each rank's band of rows, and an
  all-gather along the mesh axis gives every rank the whole result;
- ``run_world`` starts a world: ranks spawned with ``torch.multiprocessing``
  (a ``FileStore`` rendezvous in a temporary directory), or one rank in
  this process. The training path (``parallel/train.py``) all-reduces
  gradients over such a mesh.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ascii_renderer_tpu_torch.core.camera import Camera

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
WORLD_TIMEOUT_S = 120.0  # a rank stuck in a collective fails after this


def batch_cameras(positions, yaws, pitches, fov_y_deg=80.0) -> Camera:
    """Stack per-view camera parameters into a batched Camera (leading
    axis = views), float32 on the host like every camera of the port."""
    n = len(positions)
    f32 = np.float32

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=f32))

    return Camera(
        pos=t(np.asarray(positions, f32).reshape(n, 3)),
        yaw=t(np.asarray(yaws, f32)),
        pitch=t(np.asarray(pitches, f32)),
        fov_y=t(np.full((n,), fov_y_deg * np.pi / 180.0, f32)),
        speed=t(np.full((n,), 2.5, f32)),
        sensitivity=t(np.full((n,), 1.5, f32)),
    )


def orbit_cameras(n: int, center=(0.0, 1.5, 0.0), radius: float = 6.0,
                  height: float = 2.5, fov_y_deg: float = 80.0) -> Camera:
    """n cameras orbiting a point, looking inward: the many-view farm
    fixture of BASELINE config 4 (numpy float64, then float32, as the
    reference computes it)."""
    angles = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    pos = np.stack([center[0] + radius * np.cos(angles),
                    np.full(n, height),
                    center[2] + radius * np.sin(angles)], axis=1)
    look = np.asarray(center)[None, :] - pos
    yaw = np.arctan2(look[:, 2], look[:, 0])
    pitch = np.arcsin(np.clip(look[:, 1] / np.linalg.norm(look, axis=1),
                              -1, 1))
    return batch_cameras(pos, yaw, pitch, fov_y_deg)


def render_views(render_one: Callable, scene, cameras: Camera):
    """Render every view of ``cameras`` in one batched call:
    ``render_one(scene, cameras)`` must take a batched Camera (as
    ``backends.raytrace.render_rgb`` and ``ascii.glyph_decide`` do) and
    return results with the views leading. The counterpart of the
    reference's ``render_views_sharded`` on a one-device mesh."""
    if cameras.yaw.dim() != 1:
        raise ValueError("render_views: cameras must be a batch "
                         "(batch_cameras / orbit_cameras)")
    return render_one(scene, cameras)


# --------------------------------------------------------------------------
# The mesh and its collectives
# --------------------------------------------------------------------------
def make_mesh(axis_sizes: Sequence[int] | None = None,
              axis_names: Sequence[str] = ("views",),
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of named dimensions over the world of an
    initialised process group (default: one axis over every rank), called
    on every rank. The group's backend must be the device's: NCCL for
    "cuda", gloo for "cpu"; another raises, as does "cuda" without a
    card."""
    from torch.distributed.device_mesh import init_device_mesh
    if device_type not in BACKENDS:
        raise ValueError(f"make_mesh: device_type {device_type!r}, not one "
                         f"of {tuple(BACKENDS)}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (start one with "
                           "run_world or init_process_group)")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA is not available")
    backend = dist.get_backend()
    if backend != BACKENDS[device_type]:
        raise RuntimeError(f"make_mesh: a {device_type} mesh needs a "
                           f"{BACKENDS[device_type]} group, not {backend}")
    if axis_sizes is None:
        axis_sizes = (dist.get_world_size(),)
    if int(np.prod(axis_sizes)) != dist.get_world_size():
        raise ValueError(f"make_mesh: axes {tuple(axis_sizes)} over a world "
                         f"of {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(int(n) for n in axis_sizes),
                            mesh_dim_names=tuple(axis_names))


def mesh_axis(mesh, axis: str):
    """(size, this rank's index, process group) of the mesh axis."""
    return mesh.size(mesh.mesh_dim_names.index(axis)), \
        mesh.get_local_rank(axis), mesh.get_group(axis)


def all_gather_cat(t: torch.Tensor, n: int, group) -> torch.Tensor:
    """The n ranks' tensors of ``group`` concatenated along dim 0, in
    rank order, on every rank (bool travels as uint8)."""
    if t.dtype == torch.bool:
        return all_gather_cat(t.to(torch.uint8), n, group).bool()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def _map(out, fn):
    if isinstance(out, (tuple, list)):
        return type(out)(fn(t) for t in out)
    return fn(out)


def make_views_sharded_fn(render_one: Callable, mesh,
                          axis: str = "views") -> Callable:
    """``fn(scene, cameras) -> results`` over the views of a batch of
    cameras: each rank of the mesh axis renders its contiguous shard of
    the views (``render_one(scene, cameras)`` takes a batched Camera and
    returns a tensor, or a tuple of tensors, with the views leading), and
    the shards are gathered, so every rank returns every view. The view
    count must divide over the axis."""
    n, i, group = mesh_axis(mesh, axis)

    def fn(scene, cameras: Camera):
        V = cameras.yaw.shape[0]
        if V % n:
            raise ValueError(f"{V} views do not divide over {n} ranks")
        per = V // n
        out = render_one(scene, cameras[i * per:(i + 1) * per])
        return _map(out, lambda t: all_gather_cat(t, n, group))

    return fn


def render_views_sharded(render_one: Callable, scene, cameras: Camera,
                         mesh, axis: str = "views"):
    """Shard a camera batch over ``mesh[axis]`` and render every view
    (``make_views_sharded_fn`` for one call)."""
    return make_views_sharded_fn(render_one, mesh, axis)(scene, cameras)


def render_rows_sharded(render_rows_fn: Callable, scene, camera: Camera,
                        mesh, rows: int, cols: int, axis: str = "rows"):
    """Row-band (spatial) sharding of one frame: rank i of the mesh axis
    renders rows [i * band, (i + 1) * band) with ``render_rows_fn(scene,
    camera, row_lo, n_rows)``, and the bands are gathered along rows, so
    every rank returns the whole frame (a tensor, or a tuple of them)."""
    n, i, group = mesh_axis(mesh, axis)
    assert rows % n == 0, f"rows {rows} must divide over {n} devices"
    band = rows // n
    out = render_rows_fn(scene, camera, i * band, band)
    return _map(out, lambda t: all_gather_cat(t, n, group))


# --------------------------------------------------------------------------
# Worlds of ranks
# --------------------------------------------------------------------------
def _init_rank(rank: int, world_size: int, device_type: str, store_path,
               timeout_s: float):
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    store = dist.FileStore(str(store_path), world_size)
    dist.init_process_group(
        BACKENDS[device_type], store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def _rank_main(fn, rank, world_size, device_type, tmp, args, kwargs,
               timeout_s):
    """A spawned rank: join the world, run fn(*args, **kwargs), save its
    result."""
    torch.set_num_threads(1)  # many ranks share the host's cores
    try:
        _init_rank(rank, world_size, device_type,
                   os.path.join(tmp, "store"), timeout_s)
        try:
            out = fn(*args, **kwargs)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise SystemExit(1)


def run_world(fn: Callable, world_size: int, device_type: str = "cuda",
              *args, timeout: float = WORLD_TIMEOUT_S, **kwargs) -> list:
    """Run ``fn(*args, **kwargs)`` on every rank of a new world of
    ``world_size`` ranks (NCCL over the cards, one a rank, for "cuda";
    gloo for "cpu") and return the ranks' results in rank order (a
    spawned rank's moved to the CPU).

    A world of 1 runs in this process. A larger one spawns its ranks
    (``torch.multiprocessing``, start method "spawn", so no rank inherits
    this process's CUDA state): ``fn`` and its arguments must pickle (``fn`` a
    function at a module's top level) and each rank imports only what
    ``fn``'s module imports. Every collective fails after ``timeout``
    seconds, and the ranks are stopped if they have not all returned by
    then; a rank's exception is raised here with its traceback."""
    if device_type not in BACKENDS:
        raise ValueError(f"run_world: device_type {device_type!r}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("run_world: CUDA is not available")
        if world_size > torch.cuda.device_count():
            raise ValueError(f"run_world: {world_size} ranks on "
                             f"{torch.cuda.device_count()} cards")
    if world_size < 1:
        raise ValueError(f"run_world: world_size {world_size}")
    if dist.is_initialized():
        raise RuntimeError("run_world: this process is in a process group "
                           "already")
    with tempfile.TemporaryDirectory(prefix="ascii_world_") as tmp:
        if world_size == 1:
            _init_rank(0, 1, device_type, os.path.join(tmp, "store"),
                       timeout)
            try:
                return [fn(*args, **kwargs)]
            finally:
                dist.destroy_process_group()
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, device_type, tmp, args,
                                   kwargs, timeout), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_world: ranks still running "
                                       f"after {timeout} s")
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        errs = []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as fh:
                    errs.append(f"rank {r}:\n{fh.read()}")
            elif p.exitcode != 0:
                errs.append(f"rank {r}: exit code {p.exitcode}")
        if errs:
            raise RuntimeError("run_world: " + "\n".join(errs))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world_size)]
