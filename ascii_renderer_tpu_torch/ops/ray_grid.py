"""Primary ray directions: the CUDA kernels of ``csrc/ray_grid.cu`` and
their plain versions, ``core/camera.ray_dirs`` (the path tracer's grid,
rounded as the reference's eager call) and ``core/camera.ray_dirs_jit``
over ``ndc_grid_jit`` (the ray tracer's grid, rounded as its jitted
program, for a batch of views in one launch). No render path launches the
jitted grid: the ray tracer's frame kernel (``ops/rt_trace``, its grid
form) computes the same rays itself, through the same device code
(``csrc/ray_dir.cuh``); ``ray_grid_jit`` stays as the source of device
rays for that kernel's ``rd3`` form in the tools and tests.

Stands for XLA code of the reference, not a Pallas kernel: the ray grid of
``ascii_renderer_tpu/backends/pathtrace.py`` (``primary_ray_grid``,
``render_pt``'s centre rays and ``batch_rays``). The plain version
rounds as the reference's eager grid, the norm's sum of squares fused;
on CUDA tensors it is a dozen torch and ``core/fp.fma32`` launches over
every ray, which the kernel replaces with one launch that calls
``fmaf``. Both are correctly rounded at every step, so
kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ascii_renderer_tpu_torch.core.camera import (band_of, jit_grid_consts,
                                                  ndc_grid_jit, ray_dirs,
                                                  ray_dirs_jit)
from ascii_renderer_tpu_torch.ops import _build

launches = 0       # kernel launches by ray_grid
jit_launches = 0   # kernel launches by ray_grid_jit


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


def ray_grid_jit(bases, rows: int, cols: int, pixel_aspect: float,
                 device, row_lo: int = 0,
                 n_rows: int | None = None) -> torch.Tensor:
    """The ray tracer's primary directions for V views, f32 [V, band,
    cols, 3] on ``device``, rounded as the reference's jitted grid (the
    cell centres fused, then fma(px, uu, py*vv) + focal*ww over the fused
    norm): the row band [row_lo, row_lo + n_rows) of the rows x cols grid
    (all rows by default), equal to those rows of the full grid bit for
    bit. ``bases``: ``core/camera.camera_bases``' tuple (host tensors).
    On the CPU the plain version (``ndc_grid_jit`` and ``ray_dirs_jit``);
    on a CUDA device one launch for every view."""
    device = torch.device(device)
    uu, vv, ww, focal = (b.to("cpu", torch.float32) for b in bases)
    band = band_of(rows, row_lo, n_rows)
    if device.type == "cpu":
        px, py = ndc_grid_jit(rows, cols, pixel_aspect, device, row_lo, band)
        return ray_dirs_jit(px, py, (uu, vv, ww, focal))
    global jit_launches
    views = uu.shape[0]
    host = torch.cat([uu, vv, focal[:, None] * ww], dim=1).contiguous()
    dev_bases = host.to(device)
    out = torch.empty((views, band, cols, 3), dtype=torch.float32,
                      device=device)
    _build.require_cuda(dev_bases, out, what="ray_grid_jit")
    if views * band * cols * 3 >= 2 ** 31:
        raise ValueError(f"ray_grid_jit: {views} views of {band} x {cols}, "
                         "at most 2^31 - 1 outputs")
    err = _build.lib().ray_grid_jit_launch(
        dev_bases.data_ptr(), out.data_ptr(), rows, cols, row_lo, band,
        views, *jit_grid_consts(rows, cols, pixel_aspect),
        _build.stream_ptr(device))
    jit_launches += 1
    _build.check(err, "ray_grid_jit_launch")
    return out
