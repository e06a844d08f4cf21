"""Primary ray directions: the CUDA kernels of ``csrc/ray_grid.cu`` and
their plain versions, ``core/camera.ray_dirs`` (the path tracer's grid,
rounded as the reference's eager call) and ``core/camera.ray_dirs_jit``
over ``ndc_grid_jit`` (the ray tracer's grid, rounded as its jitted
program, for a batch of views in one launch). No render path launches the
jitted grid: the ray tracer's frame kernel (``ops/rt_trace``, its grid
form) computes the same rays itself, through the same device code
(``csrc/ray_dir.cuh``); ``ray_grid_jit`` stays as the source of device
rays for that kernel's ``rd3`` form in the tools and tests.

``pt_rays`` (X7) is the form the path tracer's render paths launch: the
rays of one sample batch, or of the probe, from each pixel's uid (cell
centre, hash jitter, direction) into the megakernel's padded ray block,
one launch; its plain version ``pt_rays_ref`` is the torch chain of
``ndc_grid``, the gather of the compacted order, ``batch_ray_dirs`` and
``pt_kernel.blockify``, bit for bit the same.

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

from ascii_renderer_tpu_torch.core.camera import (HostBasis, band_of,
                                                  grid_aspect,
                                                  jit_grid_consts, ndc_grid,
                                                  ndc_grid_jit, ray_dirs,
                                                  ray_dirs_jit)
from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.ops import pt_kernel as PK

launches = 0       # kernel launches by ray_grid
jit_launches = 0   # kernel launches by ray_grid_jit
pt_launches = 0    # kernel launches by pt_rays (X7)
LAUNCHES_PER_CALL = {"ray_grid": 1, "ray_grid_jit": 1, "pt_rays": 1}
JITTER_X, JITTER_Y = 0x40000001, 0x40000002  # the jitter's hash counters
# X7's threads that fill an H100: 132 SMs x 2,048 resident threads. A
# launch with slots enough takes every sample of a slot in one thread
FILL_THREADS = 132 * 2048


def samples_per_thread(pc: int, samples: int) -> int:
    """X7's own choice of the samples a thread takes (the launch's
    ``per``): as many as keep FILL_THREADS threads busy, 1 to samples."""
    return max(1, min(samples, pc * samples // FILL_THREADS))


def _basis9(basis):
    """uu, vv and focal * ww as 9 host floats for a launch: a HostBasis's
    own floats (no tensor operation), or camera_basis's tensors'."""
    if isinstance(basis, HostBasis):
        return (ctypes.c_float * 9)(*basis.nine)
    uu, vv, ww, focal = basis
    host = torch.cat([uu, vv, focal * ww]).to("cpu", torch.float32)
    return (ctypes.c_float * 9)(*host.tolist())


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
    out = torch.empty((*px.shape, 3), dtype=torch.float32, device=px.device)
    err = _build.lib().ray_grid_launch(px.data_ptr(), py.data_ptr(),
                                       out.data_ptr(), px.numel(),
                                       _basis9(basis),
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


def batch_ray_dirs(basis, px, py, aspect, fetched, uid_sp, bs: int, s_idx,
                   rows: int | None = None):
    """Directions f32 [B, band, cols, 3] of one sample batch (px, py f32
    [band, cols]), the plain chain: sample s > 0 of a pixel that fetched
    no texel is jittered inside its cell by (2 (u - 0.5) / rows) *
    (aspect, 1), u the hash draws of the (sample, pixel) uid ``uid_sp``
    (int32 [B, band * cols]) at counters 0x40000001 / 0x40000002; the
    rest trace the cell centre. ``rows``: the full grid's rows (default:
    the band's)."""
    B = uid_sp.shape[0]
    band, cols = px.shape
    rows_t = torch.tensor(float(rows or band), device=px.device)
    jxu = PK.hash_unit(uid_sp, bs, JITTER_X)
    jyu = PK.hash_unit(uid_sp, bs, JITTER_Y)
    jx = (2.0 * (jxu - 0.5)) / rows_t * aspect
    jy = (2.0 * (jyu - 0.5)) / rows_t
    use_jit = (s_idx > 0)[:, None] & ~fetched.reshape(1, band * cols)
    jx = torch.where(use_jit, jx, 0.0).reshape(B, band, cols)
    jy = torch.where(use_jit, jy, 0.0).reshape(B, band, cols)
    return ray_dirs(px[None] + jx, py[None] + jy, basis)


def pt_rays_ref(basis, rows: int, cols: int, pixel_aspect: float, *,
                row_lo: int = 0, n_rows: int | None = None, pix_uid=None,
                fet0=None, samples: int = 1, s0: int = 0,
                seed: int | None = None, device="cuda") -> torch.Tensor:
    """Plain version of ``pt_rays``: the cell centres of the band
    (``ndc_grid``), gathered into stream order by ``pix_uid``; without
    ``fet0`` the centre rays (``ray_dirs``), with it ``batch_ray_dirs``
    of samples s0 .. s0 + samples - 1 (uids s * rows * cols + pix_uid,
    jitter where not fet0 > 0.5); blocked by ``pt_kernel.blockify``."""
    if isinstance(basis, HostBasis):
        basis = basis.tensors()
    band = band_of(rows, row_lo, n_rows)
    px, py, aspect = ndc_grid(rows, cols, pixel_aspect, device, row_lo,
                              band)
    pc = band * cols
    if pix_uid is None:
        pix_uid = (torch.arange(pc, dtype=torch.int32, device=device)
                   + row_lo * cols)
    else:  # compacted: stream slot p holds pixel pix_uid[p]
        local = pix_uid.long() - row_lo * cols
        px = px.reshape(pc)[local].reshape(band, cols)
        py = py.reshape(pc)[local].reshape(band, cols)
    if fet0 is None:
        n, rd = pc, ray_dirs(px, py, basis)
    else:
        uid_sp = (torch.arange(samples, dtype=torch.int32,
                               device=device)[:, None] * (rows * cols)
                  + pix_uid[None, :])
        s_idx = s0 + torch.arange(samples, device=device)
        fetched = fet0.reshape(-1)[:pc] > 0.5
        n = samples * pc
        rd = batch_ray_dirs(basis, px, py, aspect, fetched, uid_sp, seed,
                            s_idx, rows)
    return PK.blockify(rd, n, -(-n // PK.BLOCK))


def pt_rays(basis, rows: int, cols: int, pixel_aspect: float, *,
            row_lo: int = 0, n_rows: int | None = None, pix_uid=None,
            fet0=None, samples: int = 1, s0: int = 0,
            seed: int | None = None, device="cuda") -> torch.Tensor:
    """The path tracer's rays in the megakernel's ray block, f32 [nblk, 8,
    128, 3] (nblk * 1,024 >= samples * pc rays, pc = band * cols, the pad
    rays 0): ray s * pc + p is sample s0 + s of the pixel in stream slot
    p of the row band [row_lo, row_lo + n_rows) of the rows x cols grid.
    ``pix_uid`` (int32 [pc]): the global uid of each slot's pixel
    (compacted order), default row_lo * cols + p. Without ``fet0``: the
    probe, one sample of centre rays. With ``fet0`` (the probe's fetch
    output, f32, pc or more) and ``seed`` (the batch's seed): a sample
    batch, jittered as ``batch_ray_dirs`` jitters. ``basis`` is
    ``camera_basis``'s tuple (host tensors) or its floats
    (``core/camera.HostBasis``, passed by value with no tensor operation;
    the render paths'). On the CPU the plain version
    (``pt_rays_ref``); on a CUDA device one launch (X7), a thread taking
    ``samples_per_thread`` samples of its slot."""
    device = torch.device(device)
    if device.type == "cpu":
        return pt_rays_ref(basis, rows, cols, pixel_aspect, row_lo=row_lo,
                           n_rows=n_rows, pix_uid=pix_uid, fet0=fet0,
                           samples=samples, s0=s0, seed=seed, device=device)
    global pt_launches
    band = band_of(rows, row_lo, n_rows)
    pc = band * cols
    jitter = fet0 is not None
    if jitter and seed is None:
        raise ValueError("pt_rays: a sample batch needs its seed")
    if not jitter and (samples != 1 or s0 != 0):
        raise ValueError("pt_rays: the probe (no fet0) is one sample, s0 0")
    if pix_uid is not None and (pix_uid.dtype != torch.int32
                                or pix_uid.numel() != pc):
        raise ValueError(f"pt_rays: pix_uid must be int32 [{pc}]")
    if jitter:
        fet0 = fet0.reshape(-1)
        if fet0.dtype != torch.float32 or fet0.numel() < pc:
            raise ValueError(f"pt_rays: fet0 must be float32 [>= {pc}]")
    n = samples * pc
    nblk = -(-n // PK.BLOCK)
    if pc == 0:
        raise ValueError("pt_rays: an empty band")
    if nblk * PK.BLOCK * 3 >= 2 ** 31 or rows * cols >= 2 ** 31:
        raise ValueError(f"pt_rays: {n} rays, at most 2^31 / 3")
    out = torch.empty((nblk, PK.BH, PK.BW, 3), dtype=torch.float32,
                      device=device)
    _build.require_cuda(out, *(t for t in (pix_uid, fet0) if t is not None),
                        what="pt_rays")
    err = _build.lib().pt_rays_launch(
        pix_uid.data_ptr() if pix_uid is not None else None,
        fet0.data_ptr() if jitter else None, out.data_ptr(), pc, samples,
        samples_per_thread(pc, samples), nblk * PK.BLOCK, rows, cols,
        row_lo * cols,
        grid_aspect(rows, cols, pixel_aspect), s0,
        PK.hash_key(seed, JITTER_X) if jitter else 0,
        PK.hash_key(seed, JITTER_Y) if jitter else 0, int(jitter),
        _basis9(basis), _build.stream_ptr(device))
    pt_launches += 1
    _build.check(err, "pt_rays_launch")
    return out
