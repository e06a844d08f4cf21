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

Plain torch, differentiated by autograd; the JAX package computes it
outside any Pallas kernel, so there is no kernel here. Each view's MVP is
the host matrix of ``backends/raster.camera_mvp``; a batch of cameras
renders every view in one pass over [views, triangles, rows, cols].
"""

from __future__ import annotations

import numpy as np
import torch

from ascii_renderer_tpu_torch.backends.raster import camera_mvp
from ascii_renderer_tpu_torch.core.camera import Camera


def camera_mvps(cam: Camera, rows: int, cols: int,
                pixel_aspect: float = 1.0) -> torch.Tensor:
    """The MVP of each view, f32 [V, 4, 4] on the host (V = 1 for one
    camera): one ``camera_mvp`` a view, stacked."""
    if cam.yaw.dim() == 0:
        return camera_mvp(cam, rows, cols, pixel_aspect)[None]
    return torch.stack([camera_mvp(cam[i], rows, cols, pixel_aspect)
                        for i in range(cam.yaw.shape[0])])


def soft_render_mvp(verts, colors, faces, mvp, rows: int, cols: int, *,
                    sigma: float = 1e-2, gamma: float = 1e-2,
                    bg_color=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """soft_render from the views' MVPs f32 [V, 4, 4]: rgb f32 [V, rows,
    cols, 3] on verts' device."""
    dev = verts.device
    faces = torch.as_tensor(faces, device=dev).long()
    mvp = mvp.to(device=dev, dtype=torch.float32)
    v4 = torch.cat([verts, torch.ones_like(verts[:, :1])], dim=1)
    clip = v4 @ mvp.transpose(-1, -2)                  # [V, N, 4]
    w = torch.clamp(clip[..., 3:4], min=1e-6)
    ndc = clip[..., :3] / w                            # [V, N, 3]
    tv = ndc[:, faces]                                 # [V, T, 3, 3]
    tc = colors[faces]                                 # [T, 3, 3]

    # pixel centres in NDC
    xs = (torch.arange(cols, dtype=torch.float32, device=dev) + 0.5) \
        / cols * 2.0 - 1.0
    ys = 1.0 - (torch.arange(rows, dtype=torch.float32, device=dev) + 0.5) \
        / rows * 2.0
    px = xs[None, :]                                   # [1, W]
    py = ys[:, None]                                   # [H, 1]

    def at(k, c):  # vertex k's coordinate c, [V, T, 1, 1]
        return tv[:, :, k, c, None, None]

    def edge(a, b):
        # cross(b - a, p - a) over the pixel grid -> [V, T, H, W]
        ax, ay, bx, by = at(a, 0), at(a, 1), at(b, 0), at(b, 1)
        return (bx - ax) * (py - ay) - (by - ay) * (px - ax)

    w0, w1, w2 = edge(1, 2), edge(2, 0), edge(0, 1)
    area = w0 + w1 + w2
    area_safe = torch.where(area.abs() < 1e-9, 1e-9, area)
    b0, b1, b2 = w0 / area_safe, w1 / area_safe, w2 / area_safe

    inside_margin = torch.minimum(torch.minimum(b0, b1), b2)  # > 0 inside
    cov = torch.sigmoid(torch.sign(inside_margin) * inside_margin ** 2
                        / sigma)

    # screen-space interpolation with the barycentrics clamped to the
    # simplex, so attributes stay in the hull of the vertex values
    c0 = torch.clamp(b0, 0.0, 1.0)
    c1 = torch.clamp(b1, 0.0, 1.0)
    c2 = torch.clamp(b2, 0.0, 1.0)
    norm = torch.clamp(c0 + c1 + c2, min=1e-6)
    c0, c1, c2 = c0 / norm, c1 / norm, c2 / norm
    zpix = c0 * at(0, 2) + c1 * at(1, 2) + c2 * at(2, 2)   # ndc z
    cpix = (c0[..., None] * tc[None, :, None, None, 0]
            + c1[..., None] * tc[None, :, None, None, 1]
            + c2[..., None] * tc[None, :, None, None, 2])  # [V, T, H, W, 3]

    # softmax over the triangles and a background slot at the far plane
    zinv = (1.0 - torch.clamp(zpix, -1.0, 1.0)) * 0.5      # 1 near, 0 far
    logits = zinv / gamma + torch.log(torch.clamp(cov, 1e-12, 1.0))
    V = logits.shape[0]
    all_logits = torch.cat([logits, torch.zeros_like(logits[:, :1])], dim=1)
    wgt = torch.softmax(all_logits, dim=1)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    all_colors = torch.cat([cpix, bg.expand(V, 1, rows, cols, 3)], dim=1)
    # the reference's einsum("thw,thwc->hwc") as a product and a sum over
    # the slots: one reduction, where einsum's batched product runs a
    # 1 x (T + 1) matrix product a pixel
    return (wgt[..., None] * all_colors).sum(dim=1)


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
    soft glyph distribution against the target's HARD glyph assignment."""
    mse = torch.mean((rgb - target_rgb) ** 2)
    probs = soft_glyph_probs(rgb, ramp_len, tau)
    tx = torch.clamp(_channel_mean(target_rgb), 0.0, 1.0 - 1e-6) \
        * (ramp_len - 1)
    tidx = torch.clamp(torch.floor(tx + 0.5), 0, ramp_len - 1).long()
    logp = torch.log(torch.clamp(probs, 1e-12, 1.0))
    ce = -torch.mean(logp.gather(-1, tidx[..., None])[..., 0])
    return mse + glyph_weight * ce
