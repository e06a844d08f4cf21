"""Temporal accumulation + per-pixel adaptive sampling (torch port of
``ascii_renderer_tpu/sim/accum.py``; ref: js/render/renderer.js:65-210,
js/render/targets.js, config.ADAPTIVE).

  - Welford per-pixel statistics (count k, mean, M2) over path-traced
    sample batches, a batch's mean counting as ONE sample;
  - convergence: the 95% interval 1.96 * sigma / sqrt(k) against a
    RELATIVE tolerance of the mean, capped at max_samples;
  - two statistics modes: "rgb" (per-channel linear RGB, a mean-of-channels
    interval) and "perceptual" (the reference's scalar 0.3 / 0.59 / 0.11
    luminance with its max(mean, 1e-8) floor);
  - an active-pixel mask gating further accumulation: converged pixels
    freeze;
  - camera-motion reset: any pose change clears the statistics.

Rounding follows the reference's jitted step (``ProgressivePathTracer``
compiles it): the Welford updates fuse their products into the adds
(``m2 + delta * (x - mean')`` -> fma), the perceptual weights fuse left to
right, and XLA's division of a sum by the channel count is a product with
its reciprocal (core/fp.py has the rules).

``ProgressivePathTracer`` takes the megakernel path (B5: the CUDA kernel on
the card, its plain version on the CPU) and, with adaptive_skip, feeds it
the pre-batch active mask as ``render_pt(pixel_active=)``: the active
pixels are compacted to the front of the ray stream, so the kernel's block
gate skips the converged tail. The kernel's RNG is a pure function of
(pixel uid, seed), so the accumulator's trajectory is bit-identical to a
full render. Profiler range: ``accum.step`` (the statistics update).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from ascii_renderer_tpu_torch.backends import pathtrace as PT
from ascii_renderer_tpu_torch.core import threefry as TF
from ascii_renderer_tpu_torch.core.camera import Camera
from ascii_renderer_tpu_torch.core.config import Config
from ascii_renderer_tpu_torch.core.fp import fma32, sqrt32

_THIRD = float(np.float32(1.0) / np.float32(3.0))  # XLA's 1/3 for mean/3


@dataclasses.dataclass(frozen=True)
class AccumState:
    count: torch.Tensor  # f32 [H, W]: samples accumulated per pixel
    mean: torch.Tensor  # f32 [H, W, 3]
    m2: torch.Tensor  # f32 [H, W, 3]: sum of squared deviations
    cam_sig: torch.Tensor  # f32 [5]: (pos, yaw, pitch), on the host
    mean_y: torch.Tensor  # f32 [H, W]: perceptual-luminance Welford mean
    m2_y: torch.Tensor  # f32 [H, W]
    # cached alpha plane: a frozen pixel keeps the byte of its last ACTIVE
    # batch, which is what a full render gives (the override decision is
    # a function of the pose), so a render that skipped it stays exact
    alpha: torch.Tensor  # u8 [H, W]

    @staticmethod
    def create(rows: int, cols: int, device="cuda") -> "AccumState":
        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return AccumState(
            count=z(rows, cols), mean=z(rows, cols, 3), m2=z(rows, cols, 3),
            cam_sig=torch.full((5,), float("inf"), dtype=torch.float32),
            mean_y=z(rows, cols), m2_y=z(rows, cols),
            alpha=torch.full((rows, cols), 255, dtype=torch.uint8,
                             device=device))

    def replace(self, **kw) -> "AccumState":
        return dataclasses.replace(self, **kw)


def _signature(cam: Camera) -> torch.Tensor:
    """(pos, yaw, pitch) f32 [5] on the host."""
    return torch.cat([cam.pos.reshape(3), cam.yaw.reshape(1),
                      cam.pitch.reshape(1)]).to("cpu", torch.float32)


def _moved(cam: Camera, state: AccumState) -> bool:
    return bool(((_signature(cam) - state.cam_sig).abs() > 1e-7).any())


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Mean of the channels: their sum times XLA's float32 1/3."""
    return (rgb[..., 0] + rgb[..., 1] + rgb[..., 2]) * _THIRD


def perceptual_luminance(rgb: torch.Tensor) -> torch.Tensor:
    """The reference's adaptive-sampling channel (renderer.js:183):
    0.3 r + 0.59 g + 0.11 b, the left product of the first add fused, then
    the third: fma(0.11, b, fma(0.3, r, 0.59 g))."""
    return fma32(rgb[..., 2], 0.11,
                 fma32(rgb[..., 0], 0.3, rgb[..., 1] * 0.59))


def _ci(var, k):
    """1.96 * sqrt(max(var, 0) / k)."""
    return 1.96 * sqrt32(torch.clamp(var, min=0.0) / k)


def active_mask(state: AccumState, *, max_tolerance: float,
                max_samples: int, stats_mode: str = "rgb") -> torch.Tensor:
    """Pixels still needing samples: CI(95%) > tol * mean, k < cap
    (renderer.js:179-199). "rgb" tests the mean of the channel variances;
    "perceptual" the scalar luminance with its 1e-8 mean floor."""
    k = torch.clamp(state.count, min=1.0)
    km1 = torch.clamp(k - 1.0, min=1.0)
    if stats_mode == "perceptual":
        ci = _ci(state.m2_y / km1, k)
        ref = torch.clamp(state.mean_y, min=1e-8)
    else:
        ci = _ci(luminance(state.m2 / km1[..., None]), k)
        ref = torch.clamp(luminance(state.mean.abs()), min=1e-3)
    unconverged = ci > max_tolerance * ref
    warmup = state.count < 2.0  # a variance needs >= 2 samples
    return (warmup | unconverged) & (state.count < max_samples)


def accumulate(state: AccumState, sample_rgb: torch.Tensor, cam: Camera,
               *, max_tolerance: float, max_samples: int,
               reset_on_camera_change: bool = True, stats_mode: str = "rgb",
               sample_alpha=None):
    """Fold one sample batch. Returns (state', display_rgb, active_mask).
    sample_alpha (optional u8 [H, W]) is folded into state.alpha for
    ACTIVE pixels only; frozen pixels keep their cached byte."""
    with record_function("accum.step"):
        sig = _signature(cam)
        if reset_on_camera_change and _moved(cam, state):
            rows, cols = state.count.shape
            state = AccumState.create(rows, cols, state.count.device)
        state = state.replace(cam_sig=sig)

        act = active_mask(state, max_tolerance=max_tolerance,
                          max_samples=max_samples, stats_mode=stats_mode)
        k1 = state.count + 1.0
        delta = sample_rgb - state.mean
        mean1 = state.mean + delta / k1[..., None]
        m21 = fma32(delta, sample_rgb - mean1, state.m2)
        y = perceptual_luminance(sample_rgb)
        delta_y = y - state.mean_y
        mean_y1 = state.mean_y + delta_y / k1
        m2_y1 = fma32(delta_y, y - mean_y1, state.m2_y)

        upd = act[..., None]
        new = state.replace(
            count=torch.where(act, k1, state.count),
            mean=torch.where(upd, mean1, state.mean),
            m2=torch.where(upd, m21, state.m2),
            mean_y=torch.where(act, mean_y1, state.mean_y),
            m2_y=torch.where(act, m2_y1, state.m2_y),
            alpha=(state.alpha if sample_alpha is None
                   else torch.where(act, sample_alpha.to(torch.uint8),
                                    state.alpha)))
        display = torch.where(new.count[..., None] > 0, new.mean, sample_rgb)
    return new, display, act


class ProgressivePathTracer:
    """Progressive refinement over the path tracer: each ``step`` adds one
    spp batch to the accumulator; ``done`` when every pixel converged.

    The kernel path (``use_kernel``, the default where the scene's atlas
    fits the megakernel) traces through B5: the CUDA kernel on the card,
    its plain version on the CPU. With ``adaptive_skip`` (and the config's
    adaptive sampling on) the pre-batch active mask, or every pixel after
    a camera move, goes to ``render_pt(pixel_active=)``, which compacts the
    active pixels to the front of the ray stream so the kernel's block gate
    skips the converged tail; the trajectory stays bit-identical to a full
    render, only the work drops. The frozen pixels' alpha bytes persist in
    AccumState.alpha.

    ``poll_done`` reads a bounded queue (64) of any-active flags, each
    copied without blocking to pinned host memory behind a CUDA event when
    its batch is stepped, so polling never synchronises the stream."""

    def __init__(self, cfg: Config, scene, rows: int | None = None,
                 cols: int | None = None, use_kernel: bool | None = None,
                 adaptive_skip: bool = True, device=None):
        self.cfg = cfg
        self.rows = rows or cfg.grid_height
        self.cols = cols or cfg.grid_width
        self.scene = scene
        self.device = torch.device(device) if device is not None else \
            scene.sph_pos.device
        if use_kernel is None:
            use_kernel = PT.atlas_ok(scene)
        self.use_kernel = bool(use_kernel)
        self._packed = PT.pack_scene_entries(scene) if use_kernel else None
        self._light = PT.light_sphere_host(scene)
        self.skip = bool(adaptive_skip and cfg.adaptive.enabled
                         and use_kernel)
        self.state = AccumState.create(self.rows, self.cols, self.device)
        self._batch = 0
        # bounded: a caller that never polls must not grow the queue; the
        # oldest probe can go, convergence being monotone between moves
        self._inflight = collections.deque(maxlen=64)
        self._pinned = self.device.type == "cuda"

    def _adaptive(self):
        ad = self.cfg.adaptive
        return dict(max_tolerance=ad.max_tolerance,
                    max_samples=ad.max_samples, stats_mode=ad.stats_mode)

    def step(self, camera: Camera, time_sec: float = 0.0):
        """One refinement batch. Returns (display_rgb, alpha, active_mask)."""
        pt, ad = self.cfg.path_tracer, self.cfg.adaptive
        key = TF.key_data(self._batch)
        self._batch += 1
        pa = None
        if self.skip:
            if _moved(camera, self.state):
                pa = torch.ones((self.rows, self.cols), dtype=torch.bool,
                                device=self.device)
            else:
                pa = active_mask(self.state, **self._adaptive())
        rgb, a = PT.render_pt(
            self.scene, camera, time_sec, key=key, rows=self.rows,
            cols=self.cols, pixel_aspect=self.cfg.pixel_aspect,
            spp=pt.samples_per_batch, bounces=pt.max_bounces,
            light_color=pt.light_color, nee=pt.direct_light_sampling,
            use_kernel=self.use_kernel, pixel_active=pa, packed=self._packed,
            light_host=self._light, device=self.device)
        self.state, display, act = accumulate(
            self.state, rgb, camera,
            reset_on_camera_change=ad.reset_on_camera_change,
            sample_alpha=a, **self._adaptive())
        # the convergence probe: start the one-flag readback now, read it
        # `lag` batches later (poll_done), by when it has landed
        any_act = act.any()
        if self._pinned:
            host = torch.empty((), dtype=torch.bool, pin_memory=True)
            host.copy_(any_act, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._inflight.append((self._batch, host, ev))
        else:
            self._inflight.append((self._batch, any_act, None))
        return display, self.state.alpha, act

    def poll_done(self, lag: int = 2) -> bool:
        """True once a probe at least ``lag`` batches old saw no active
        pixel. The loop runs at most ``lag`` batches past convergence; those
        are no-ops for the output. A probe whose copy has not landed yet is
        left for the next poll: nothing here waits on the card."""
        while self._inflight and self._inflight[0][0] <= self._batch - lag:
            _b, v, ev = self._inflight[0]
            if ev is not None and not ev.query():
                return False
            self._inflight.popleft()
            if not bool(v):
                return True
        return False

    @property
    def done(self) -> bool:
        """Whether every pixel has converged (reads the mask: a sync)."""
        return not bool(active_mask(self.state, **self._adaptive()).any())
