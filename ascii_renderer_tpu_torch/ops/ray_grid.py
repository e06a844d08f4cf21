"""The path tracer's primary ray directions: the CUDA kernel
``csrc/ray_grid.cu`` and its plain version ``core/camera.ray_dirs``.

Stands for XLA code of the reference, not a Pallas kernel: the ray grid of
``ascii_renderer_tpu/backends/pathtrace.py`` (``primary_ray_grid``,
``render_pt``'s centre rays and ``batch_rays``). The plain version
rounds as the reference's eager grid, the norm's sum of squares fused;
on CUDA tensors its fused sums are float64 emulations (``core/fp.fma32``)
of ~27 launches each over every ray, which the kernel replaces with one
launch that calls ``fmaf``. Both are correctly rounded at every step, so
kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ascii_renderer_tpu_torch.core.camera import ray_dirs
from ascii_renderer_tpu_torch.ops import _build

launches = 0   # kernel launches by ray_grid


def ray_grid(px: torch.Tensor, py: torch.Tensor, basis) -> torch.Tensor:
    """normalize(px*uu + py*vv + focal*ww) -> f32 [*shape, 3], ``shape``
    the broadcast shape of px and py (f32); ``basis`` is
    ``camera_basis``'s tuple (host tensors). CPU tensors run the plain
    version (``core/camera.ray_dirs``); CUDA tensors launch the kernel
    once."""
    if px.device.type == "cpu":
        return ray_dirs(px, py, basis)
    if px.dtype != torch.float32 or py.dtype != torch.float32:
        raise ValueError("ray_grid: expected float32 px and py")
    global launches
    px, py = (t.contiguous() for t in torch.broadcast_tensors(px, py))
    _build.require_cuda(px, py, what="ray_grid")
    if px.numel() >= 2 ** 31:
        raise ValueError(f"ray_grid: {px.numel()} rays, at most 2^31 - 1")
    uu, vv, ww, focal = basis
    host = torch.cat([uu, vv, focal * ww]).to("cpu", torch.float32)
    basis9 = (ctypes.c_float * 9)(*host.tolist())
    out = torch.empty((*px.shape, 3), dtype=torch.float32, device=px.device)
    err = _build.lib().ray_grid_launch(px.data_ptr(), py.data_ptr(),
                                       out.data_ptr(), px.numel(), basis9,
                                       _build.stream_ptr(px.device))
    launches += 1
    _build.check(err, "ray_grid_launch")
    return out
