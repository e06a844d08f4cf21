"""The progressive tracer's statistics step: the kernel of ``csrc/accum.cu``
(K1b, one launch a batch) and its plain version, the torch chain of
``sim/accum``'s ``accumulate`` and ``active_mask``.

Stands for XLA code, not a Pallas kernel: the reference jits its
``accumulate`` (``ascii_renderer_tpu/sim/accum.py:110``) and
``active_mask`` (:90) into the progressive step's one program. The launch
reads the old state (or a zero state after a camera move: no fill) and the
batch's samples, and writes the new state into new tensors (the old one
stays readable), the display rgb, the pre-update active mask, the next
batch's skip mask (``active_mask`` of the new state) and, given a
ping-pong pair of int32 flags, the batch's any-active flag in one slot
while it clears the other for the next batch. Both versions round site by
site alike (``fmaf`` where the chain takes ``fma32``, IEEE division, the
correctly rounded root of ``sqrt32``), so they agree bit for bit.

``accumulate`` is the wrapper: CPU tensors take ``accumulate_ref``, CUDA
tensors the kernel, which raises where it cannot run.
"""

from __future__ import annotations

import numpy as np
import torch

from ascii_renderer_tpu_torch.core.fp import fma32, sqrt32
from ascii_renderer_tpu_torch.ops import _build

launches = 0  # kernel launches by accumulate
LAUNCHES_PER_CALL = {"accumulate": 1}  # kernels a call launches
# the state's fields in the order the functions take and return them
FIELDS = ("count", "mean", "m2", "mean_y", "m2_y", "alpha")
_THIRD = float(np.float32(1.0) / np.float32(3.0))  # XLA's 1/3 for mean/3


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


def active_mask_ref(count, mean, m2, mean_y, m2_y, *, max_tolerance: float,
                    max_samples: int, stats_mode: str = "rgb"):
    """Pixels still needing samples: CI(95%) > tol * mean, k < cap
    (renderer.js:179-199). "rgb" tests the mean of the channel variances;
    "perceptual" the scalar luminance with its 1e-8 mean floor."""
    k = torch.clamp(count, min=1.0)
    km1 = torch.clamp(k - 1.0, min=1.0)
    if stats_mode == "perceptual":
        ci = _ci(m2_y / km1, k)
        ref = torch.clamp(mean_y, min=1e-8)
    else:
        ci = _ci(luminance(m2 / km1[..., None]), k)
        ref = torch.clamp(luminance(mean.abs()), min=1e-3)
    unconverged = ci > max_tolerance * ref
    warmup = count < 2.0  # a variance needs >= 2 samples
    return (warmup | unconverged) & (count < max_samples)


def zero_state(shape, device):
    """The statistics of no sample: zeros, alpha 255 (``FIELDS``' order)."""
    def z(*s):
        return torch.zeros(s, dtype=torch.float32, device=device)

    return (z(*shape), z(*shape, 3), z(*shape, 3), z(*shape), z(*shape),
            torch.full(shape, 255, dtype=torch.uint8, device=device))


def accumulate_ref(state, sample_rgb, sample_alpha=None, *, reset: bool,
                   max_tolerance: float, max_samples: int,
                   stats_mode: str = "rgb", flags=None, slot: int = 0):
    """The plain chain of one batch's fold: ``state`` the six tensors of
    ``FIELDS`` (ignored where ``reset``: the zero state), ``sample_rgb``
    f32 [..., 3], ``sample_alpha`` u8 [...] or None. Returns (the new
    state's six tensors, display rgb, act, skip): act the pre-update
    active mask, skip ``active_mask_ref`` of the new state. ``flags``
    (int32 [2]) or None: flags[slot] set to 1 where a pixel was active
    (else left as it was: the last batch cleared it), flags[1 - slot]
    cleared."""
    if reset:
        state = zero_state(tuple(sample_rgb.shape[:-1]), sample_rgb.device)
    count, mean, m2, mean_y, m2_y, alpha = state
    kw = dict(max_tolerance=max_tolerance, max_samples=max_samples,
              stats_mode=stats_mode)
    act = active_mask_ref(count, mean, m2, mean_y, m2_y, **kw)
    k1 = count + 1.0
    delta = sample_rgb - mean
    mean1 = mean + delta / k1[..., None]
    m21 = fma32(delta, sample_rgb - mean1, m2)
    y = perceptual_luminance(sample_rgb)
    delta_y = y - mean_y
    mean_y1 = mean_y + delta_y / k1
    m2_y1 = fma32(delta_y, y - mean_y1, m2_y)
    upd = act[..., None]
    new = (torch.where(act, k1, count), torch.where(upd, mean1, mean),
           torch.where(upd, m21, m2), torch.where(act, mean_y1, mean_y),
           torch.where(act, m2_y1, m2_y),
           alpha if sample_alpha is None else torch.where(
               act, sample_alpha.to(torch.uint8), alpha))
    display = torch.where(new[0][..., None] > 0, new[1], sample_rgb)
    if flags is not None:
        if act.any():
            flags[slot] = 1
        flags[1 - slot] = 0
    return new, display, act, active_mask_ref(*new[:5], **kw)


def _contig(t, what, dtype, shape, dev):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
        raise ValueError(f"accumulate: {what} must be {dtype} {list(shape)} "
                         f"on {dev}, got {t.dtype} {list(t.shape)} on "
                         f"{t.device}")
    return t if t.is_contiguous() else t.contiguous()


def accumulate(state, sample_rgb, sample_alpha=None, *, reset: bool,
               max_tolerance: float, max_samples: int,
               stats_mode: str = "rgb", flags=None, slot: int = 0):
    """Twin of ``accumulate_ref``: CPU tensors run it; CUDA tensors launch
    the kernel once (the new state's five float planes and the display
    are views of one new float buffer, alpha, act and skip of one byte
    buffer)."""
    if sample_rgb.device.type == "cpu":
        return accumulate_ref(state, sample_rgb, sample_alpha, reset=reset,
                              max_tolerance=max_tolerance,
                              max_samples=max_samples, stats_mode=stats_mode,
                              flags=flags, slot=slot)
    global launches
    dev = sample_rgb.device
    _build.require_device(sample_rgb, what="accumulate")
    if sample_rgb.dim() < 1 or sample_rgb.shape[-1] != 3:
        raise ValueError(f"accumulate: sample_rgb must be [..., 3], got "
                         f"{list(sample_rgb.shape)}")
    shape = tuple(sample_rgb.shape[:-1])
    rgb = _contig(sample_rgb, "sample_rgb", torch.float32, shape + (3,), dev)
    old = [None] * 6
    if not reset:
        old = [_contig(t, f, torch.uint8 if f == "alpha" else torch.float32,
                       shape + (3,) if f in ("mean", "m2") else shape, dev)
               for f, t in zip(FIELDS, state)]
    sa = None
    if sample_alpha is not None:
        if sample_alpha.dtype not in (torch.uint8, torch.bool):
            sample_alpha = sample_alpha.to(torch.uint8)
        sa = _contig(sample_alpha.view(torch.uint8), "sample_alpha",
                     torch.uint8, shape, dev)
    if flags is not None and (flags.dtype != torch.int32 or flags.numel() != 2
                              or flags.device != dev or slot not in (0, 1)):
        raise ValueError("accumulate: flags must be int32 [2] on the "
                         "samples' device, slot 0 or 1")
    n = rgb.numel() // 3
    f = torch.empty(12 * n, dtype=torch.float32, device=dev)
    b = torch.empty(3 * n, dtype=torch.uint8, device=dev)
    new = (f[:n].view(shape), f[n:4 * n].view(shape + (3,)),
           f[4 * n:7 * n].view(shape + (3,)), f[7 * n:8 * n].view(shape),
           f[8 * n:9 * n].view(shape), b[:n].view(shape))
    display = f[9 * n:].view(shape + (3,))
    act, skip = (b[n * k:n * (k + 1)].view(torch.bool).view(shape)
                 for k in (1, 2))
    fp = 0 if flags is None else flags.data_ptr()
    err = _build.lib().accum_launch(
        *(0 if t is None else t.data_ptr() for t in old), rgb.data_ptr(),
        0 if sa is None else sa.data_ptr(),
        *(t.data_ptr() for t in new[:5]), display.data_ptr(),
        new[5].data_ptr(), act.data_ptr(), skip.data_ptr(),
        fp and fp + 4 * slot, fp and fp + 4 * (1 - slot), n, int(reset),
        float(np.float32(max_tolerance)), float(np.float32(max_samples)),
        int(stats_mode == "perceptual"), _build.stream_ptr(dev))
    launches += 1
    _build.check(err, "accum_launch")
    return new, display, act, skip
