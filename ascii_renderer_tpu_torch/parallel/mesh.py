"""Many-view rendering on one device (torch port of the views part of
``ascii_renderer_tpu/parallel/mesh.py``).

The reference vmaps a one-view render over a batch of cameras and shards
the batch over a device mesh (``render_views_sharded``; BASELINE config 4,
the 1,024-camera render farm). On one card the views are the leading batch
axis of one batched call: the renderers of the port take a batched camera
(``batch_cameras``) and run every view together, so a farm is one pass of
launches, not a loop of renders.

The mesh, sharding and row bands (``make_mesh``, ``render_rows_sharded``)
are ROADMAP A12.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ascii_renderer_tpu_torch.core.camera import Camera


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
