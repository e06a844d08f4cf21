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
full render. Profiler range: ``accum.step`` (the statistics update: one
launch of K1b, ``ops/accum``, on the card; its plain chain on the CPU).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from ascii_renderer_tpu_torch.backends import pathtrace as PT
from ascii_renderer_tpu_torch.core import threefry as TF
from ascii_renderer_tpu_torch.core.camera import Camera, camera_floats
from ascii_renderer_tpu_torch.core.config import Config
from ascii_renderer_tpu_torch.ops import accum as K
from ascii_renderer_tpu_torch.ops.accum import (  # noqa: F401  (re-exported)
    luminance, perceptual_luminance)

_F32_1EM7 = np.float32(1e-7)


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
        count, mean, m2, mean_y, m2_y, alpha = K.zero_state((rows, cols),
                                                            device)
        return AccumState(
            count=count, mean=mean, m2=m2,
            cam_sig=torch.full((5,), float("inf"), dtype=torch.float32),
            mean_y=mean_y, m2_y=m2_y, alpha=alpha)

    def replace(self, **kw) -> "AccumState":
        return dataclasses.replace(self, **kw)

    def fields(self) -> tuple:
        """The six tensors ``ops/accum`` takes (``ops.accum.FIELDS``)."""
        return tuple(getattr(self, f) for f in K.FIELDS)


def _signature(cam: Camera) -> np.ndarray:
    """(pos, yaw, pitch) f32 [5] on the host, from one read of the camera
    (``camera_floats``)."""
    return np.array(camera_floats(cam)[:5], dtype=np.float32)


def _moved(sig: np.ndarray, cam_sig: torch.Tensor) -> bool:
    """Whether any of the 5 float32 components moved by more than 1e-7:
    the float32 difference, as the reference tests it."""
    with np.errstate(invalid="ignore"):
        return bool((np.abs(sig - cam_sig.cpu().numpy())
                     > _F32_1EM7).any())


def active_mask(state: AccumState, *, max_tolerance: float,
                max_samples: int, stats_mode: str = "rgb") -> torch.Tensor:
    """Pixels still needing samples: CI(95%) > tol * mean, k < cap
    (renderer.js:179-199). "rgb" tests the mean of the channel variances;
    "perceptual" the scalar luminance with its 1e-8 mean floor. The plain
    chain, ``ops/accum.active_mask_ref``, on the state's device (the
    progressive step reads the mask K1b wrote instead)."""
    return K.active_mask_ref(*state.fields()[:5], max_tolerance=max_tolerance,
                             max_samples=max_samples, stats_mode=stats_mode)


def _fold(state: AccumState, sig: np.ndarray, sample_rgb, reset: bool,
          sample_alpha, flags=None, slot: int = 0, **adaptive):
    """One batch through ``ops/accum.accumulate`` (K1b on the card): (the
    new state with cam_sig ``sig``, display, act, skip)."""
    with record_function("accum.step"):
        new, display, act, skip = K.accumulate(
            state.fields(), sample_rgb, sample_alpha, reset=reset,
            flags=flags, slot=slot, **adaptive)
        new = AccumState(*new[:3], torch.from_numpy(sig), *new[3:])
    return new, display, act, skip


def accumulate(state: AccumState, sample_rgb: torch.Tensor, cam: Camera,
               *, max_tolerance: float, max_samples: int,
               reset_on_camera_change: bool = True, stats_mode: str = "rgb",
               sample_alpha=None):
    """Fold one sample batch. Returns (state', display_rgb, active_mask).
    sample_alpha (optional u8 [H, W]) is folded into state.alpha for
    ACTIVE pixels only; frozen pixels keep their cached byte. A camera
    move (with reset_on_camera_change) folds into a zero state. On the
    card one launch of K1b (``ops/accum``)."""
    sig = _signature(cam)
    reset = reset_on_camera_change and _moved(sig, state.cam_sig)
    new, display, act, _skip = _fold(
        state, sig, sample_rgb, reset, sample_alpha,
        max_tolerance=max_tolerance, max_samples=max_samples,
        stats_mode=stats_mode)
    return new, display, act


class ProgressivePathTracer:
    """Progressive refinement over the path tracer: each ``step`` adds one
    spp batch to the accumulator; ``done`` when every pixel converged.

    The kernel path (``use_kernel``, the default where the scene's atlas
    fits the megakernel) traces through B5: the CUDA kernel on the card,
    its plain version on the CPU. With ``adaptive_skip`` (and the config's
    adaptive sampling on) the pre-batch active mask goes to
    ``render_pt(pixel_active=)``, which compacts the active pixels to the
    front of the ray stream so the kernel's block gate skips the converged
    tail (after a camera move the batch is a full render, no mask); the
    trajectory stays bit-identical to a full render, only the work drops.
    That mask is the one the last batch's fold wrote (K1b's skip output),
    so a step forms none. The frozen pixels' alpha bytes persist in
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
        self._folds = 0  # batches folded: the any-active flag slot in turn
        # bounded: a caller that never polls must not grow the queue; the
        # oldest probe can go, convergence being monotone between moves
        self._inflight = collections.deque(maxlen=64)
        self._pinned = self.device.type == "cuda"
        # the any-active flags, two slots in turn: a batch's launch sets its
        # slot and clears the other for the next batch
        self._flags = torch.zeros(2, dtype=torch.int32, device=self.device) \
            if self._pinned else None
        # the next batch's skip mask, written by the last fold, and the
        # state it belongs to: a caller that replaces ``state`` gets
        # active_mask of its own state
        self._skip_of = self._skip_mask = None

    def _adaptive(self):
        ad = self.cfg.adaptive
        return dict(max_tolerance=ad.max_tolerance,
                    max_samples=ad.max_samples, stats_mode=ad.stats_mode)

    def _mask(self):
        """active_mask of ``state``: the last fold's skip mask while the
        state is that fold's, else the plain chain."""
        if self._skip_of is self.state:
            return self._skip_mask
        return active_mask(self.state, **self._adaptive())

    def step(self, camera: Camera, time_sec: float = 0.0):
        """One refinement batch. Returns (display_rgb, alpha, active_mask).
        The camera is read once (``camera_floats``); after a move the
        batch traces every pixel (``pixel_active=None``), else the skip
        mask the last fold wrote; the fold is one launch of K1b on the
        card."""
        pt, ad = self.cfg.path_tracer, self.cfg.adaptive
        key = TF.key_data(self._batch)
        self._batch += 1
        sig = _signature(camera)
        moved = _moved(sig, self.state.cam_sig)
        pa = self._mask() if self.skip and not moved else None
        rgb, a = PT.render_pt(
            self.scene, camera, time_sec, key=key, rows=self.rows,
            cols=self.cols, pixel_aspect=self.cfg.pixel_aspect,
            spp=pt.samples_per_batch, bounces=pt.max_bounces,
            light_color=pt.light_color, nee=pt.direct_light_sampling,
            use_kernel=self.use_kernel, pixel_active=pa, packed=self._packed,
            light_host=self._light, device=self.device)
        # the slot the last completed fold cleared (a batch that raised
        # before its fold leaves the turn where it was)
        slot = self._folds % 2
        self.state, display, act, self._skip_mask = _fold(
            self.state, sig, rgb, ad.reset_on_camera_change and moved, a,
            self._flags, slot, **self._adaptive())
        self._folds += 1
        self._skip_of = self.state
        # the convergence probe: start the one-flag readback now, read it
        # `lag` batches later (poll_done), by when it has landed
        if self._pinned:
            host = torch.empty((), dtype=torch.int32, pin_memory=True)
            host.copy_(self._flags[slot], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._inflight.append((self._batch, host, ev))
        else:
            self._inflight.append((self._batch, act.any(), None))
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
        return not bool(self._mask().any())
