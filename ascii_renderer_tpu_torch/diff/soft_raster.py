"""Differentiable soft rasterizer (torch port of
``ascii_renderer_tpu/diff/soft_raster.py``; BASELINE config 5): gradients
through luminance -> glyph assignment for inverse ASCII rendering.

The hard rasterizer (``backends/raster``) decides coverage and depth by
comparisons, which carry no gradient. This variant relaxes them as soft
rasterizers do:

  - coverage: sigmoid(sign(m) * m^2 / sigma) per triangle and pixel, m
    the smallest barycentric (> 0 inside);
  - occlusion: a softmax over the triangles and a background slot, each
    triangle's logit its inverse depth over gamma plus log coverage;
  - glyph assignment: a softmax over the ramp indices around the hard
    quantization rule (``core/quantize``), temperature tau.

Barycentrics are clamped to the simplex and renormalised (attributes stay
in the hull of the vertex values), with no perspective correction and no
near clipping: every vertex is assumed in front of the camera.

The projection and the gathers are torch, differentiated by autograd.
After them, CPU tensors take the plain chain (``ops/soft_raster
.soft_raster_chain``) under autograd; CUDA tensors take X5, two
hand-written kernels behind ``ops/soft_raster.SoftRaster`` (the forward
writes rgb and each pixel's softmax statistics, the backward recomputes
each (triangle, pixel) term from them). The loss takes X5b on CUDA
tensors (``ops/soft_raster.SoftLoss``: the losses and their gradient in
one launch); ``soft_glyph_probs`` stays torch. The JAX package computes
all of it outside any Pallas kernel, as XLA code. Each view's MVP is the
host matrix of ``backends/raster.camera_mvp``; a batch of cameras renders
every view in one pass over [views, triangles, rows, cols].
"""

from __future__ import annotations

import numpy as np
import torch

from ascii_renderer_tpu_torch.backends.raster import camera_mvp
from ascii_renderer_tpu_torch.core.camera import Camera
from ascii_renderer_tpu_torch.ops.soft_raster import (SoftLoss, SoftRaster,
                                                      soft_raster_chain)


def camera_mvps(cam: Camera, rows: int, cols: int,
                pixel_aspect: float = 1.0) -> torch.Tensor:
    """The MVP of each view, f32 [V, 4, 4] on the host (V = 1 for one
    camera): one ``camera_mvp`` a view, stacked."""
    if cam.yaw.dim() == 0:
        return camera_mvp(cam, rows, cols, pixel_aspect)[None]
    return torch.stack([camera_mvp(cam[i], rows, cols, pixel_aspect)
                        for i in range(cam.yaw.shape[0])])


def soft_triangles(verts, colors, faces, mvp):
    """The projection and the gathers of ``soft_render_mvp``, torch on
    every device (autograd carries the kernels' gradients back through
    them): (tv f32 [V, T, 3, 3], each view's vertices' NDC x, y, z; tc f32
    [T, 3, 3], their colours)."""
    dev = verts.device
    faces = torch.as_tensor(faces, device=dev).long()
    mvp = mvp.to(device=dev, dtype=torch.float32)
    v4 = torch.cat([verts, torch.ones_like(verts[:, :1])], dim=1)
    clip = v4 @ mvp.transpose(-1, -2)                  # [V, N, 4]
    w = torch.clamp(clip[..., 3:4], min=1e-6)
    ndc = clip[..., :3] / w                            # [V, N, 3]
    return ndc[:, faces], colors[faces]


def soft_render_mvp(verts, colors, faces, mvp, rows: int, cols: int, *,
                    sigma: float = 1e-2, gamma: float = 1e-2,
                    bg_color=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """soft_render from the views' MVPs f32 [V, 4, 4]: rgb f32 [V, rows,
    cols, 3] on verts' device (the chain on the CPU, X5 on the card)."""
    tv, tc = soft_triangles(verts, colors, faces, mvp)
    if tv.device.type == "cpu":
        return soft_raster_chain(tv, tc, rows, cols, sigma=sigma,
                                 gamma=gamma, bg_color=bg_color)[0]
    return SoftRaster.apply(tv, tc, rows, cols, sigma, gamma,
                            tuple(bg_color))


def soft_render(verts, colors, faces, cam: Camera, rows: int, cols: int,
                pixel_aspect: float = 1.0, *, sigma: float = 1e-2,
                gamma: float = 1e-2, bg_color=(0.0, 0.0, 0.0)):
    """Render [rows, cols, 3] differentiably ([V, rows, cols, 3] for a
    batch of V cameras) on verts' device.

    Args:
      verts: f32 [N, 3] world positions (differentiable).
      colors: f32 [N, 3] per-vertex colours (differentiable).
      faces: int [T, 3] triangle indices.
      sigma: edge softness in NDC^2 units; gamma: depth softmax temperature.
    """
    rgb = soft_render_mvp(verts, colors, faces,
                          camera_mvps(cam, rows, cols, pixel_aspect), rows,
                          cols, sigma=sigma, gamma=gamma, bg_color=bg_color)
    return rgb[0] if cam.yaw.dim() == 0 else rgb


def _channel_mean(rgb):
    """The mean over the last axis as the reference's compiled mean
    rounds it: the sum times the float32 reciprocal of the count."""
    return rgb.sum(dim=-1) * float(np.float32(1.0) / np.float32(
        rgb.shape[-1]))


def soft_glyph_probs(rgb, ramp_len: int, tau: float = 0.05):
    """Differentiable glyph assignment: probabilities over ramp indices.

    Relaxes the hard rule idx = round(intensity/255*(L-1)) (core/quantize)
    into softmax(-(x*(L-1) - k)^2 / tau); argmax at any tau equals the hard
    rule away from bin boundaries."""
    lum = _channel_mean(rgb)  # [0, 1]
    x = torch.clamp(lum, 0.0, 1.0 - 1e-6) * (ramp_len - 1)
    k = torch.arange(ramp_len, dtype=torch.float32, device=rgb.device)
    d2 = (x[..., None] - k) ** 2
    return torch.softmax(-d2 / tau, dim=-1)


def soft_luminance_loss(rgb, target_rgb, ramp_len: int = 10,
                        tau: float = 0.05, glyph_weight: float = 0.1):
    """Inverse-ASCII-rendering loss: pixel MSE + the cross-entropy of the
    soft glyph distribution against the target's HARD glyph assignment.
    On CUDA tensors X5b's launch, its pixels ``rgb``'s in order."""
    if rgb.device.type != "cpu":
        return SoftLoss.apply(rgb.reshape(1, -1, 1, 3),
                              target_rgb.reshape(1, -1, 1, 3), 0, ramp_len,
                              tau, glyph_weight)[0]
    mse = torch.mean((rgb - target_rgb) ** 2)
    probs = soft_glyph_probs(rgb, ramp_len, tau)
    tx = torch.clamp(_channel_mean(target_rgb), 0.0, 1.0 - 1e-6) \
        * (ramp_len - 1)
    tidx = torch.clamp(torch.floor(tx + 0.5), 0, ramp_len - 1).long()
    logp = torch.log(torch.clamp(probs, 1e-12, 1.0))
    ce = -torch.mean(logp.gather(-1, tidx[..., None])[..., 0])
    return mse + glyph_weight * ce


def soft_band_losses(img, targets, row_lo: int, ramp_len: int = 10,
                     tau: float = 0.05, glyph_weight: float = 0.1):
    """Each view's ``soft_luminance_loss`` over its row band: ``img`` f32
    [V, rows, cols, 3], ``targets`` f32 [V, band, cols, 3] for rows row_lo
    to row_lo + band; losses f32 [V]. The chain a view on the CPU; one
    launch of X5b for every view on the card."""
    if img.device.type != "cpu":
        return SoftLoss.apply(img, targets, row_lo, ramp_len, tau,
                              glyph_weight)
    band_img = img[:, row_lo:row_lo + targets.shape[1]]
    return torch.stack([soft_luminance_loss(band_img[k], targets[k], ramp_len,
                                            tau, glyph_weight)
                        for k in range(band_img.shape[0])])
