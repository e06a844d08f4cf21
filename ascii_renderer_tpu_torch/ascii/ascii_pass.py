"""The ASCII pass: cell grid -> glyph grid (torch port of
``ascii_renderer_tpu/ascii/ascii_pass.py``).

Outputs:
  chars u8 [H, W]    — the glyph grid (ASCII codes);
  tint  u8 [H, W, 3] — per-cell glyph color (cell color, or black if
                       grayscale).
The glyph-bitmap expansion (``expand_pixels``) is ROADMAP A3 and not here.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ascii_renderer_tpu_torch.core import quantize
from ascii_renderer_tpu_torch.core.config import Config
from ascii_renderer_tpu_torch.core.frame import Frame
from ascii_renderer_tpu_torch.ops import ascii_kernel


def glyph_decide(frame: Frame, *, ramp: str, mode_on: bool, mode_radius: int,
                 mode_thresh: int, grayscale: bool):
    """Per-cell glyph decision (ascii_pass_shader.js:140-188).
    Returns (chars u8 [H,W], tint u8 [H,W,3])."""
    ramp_len = len(ramp) if ramp else len(quantize.DEFAULT_RAMP)
    with record_function("glyph"):
        base_idx = quantize.quantize_index(frame.rgb, ramp_len)
        return glyph_from_index(base_idx, frame.a, frame.rgb, ramp=ramp,
                                mode_on=mode_on, mode_radius=mode_radius,
                                mode_thresh=mode_thresh, grayscale=grayscale)


def glyph_from_index(base_idx: torch.Tensor, a_plane: torch.Tensor,
                     tint_rgb_u8, *, ramp: str, mode_on: bool,
                     mode_radius: int, mode_thresh: int, grayscale: bool):
    """Image-space tail of the glyph decision, starting from a
    pre-quantized ramp-index plane (i32 [H, W]) — what
    ``render_soup_diag(emit="idx")`` assembles. The modal vote is the
    CUDA kernel B4 for a CUDA plane (``ops/ascii_kernel``)."""
    codes = torch.as_tensor(quantize.ramp_codes(ramp), device=base_idx.device)
    override = quantize.is_override(a_plane)
    idx = base_idx
    if mode_on:
        idx = ascii_kernel.modal_filter_kernel(base_idx, override,
                                               mode_radius, mode_thresh)
    ramp_chars = codes[idx.long()]
    chars = torch.where(override, a_plane.to(torch.uint8), ramp_chars)

    if tint_rgb_u8 is None:
        tint = None
    elif grayscale:
        tint = torch.zeros_like(tint_rgb_u8)
    else:
        tint = tint_rgb_u8
    return chars, tint


class AsciiPass:
    """Config-specialised ASCII pass: ``AsciiPass(cfg)(frame)`` ->
    (chars, tint)."""

    def __init__(self, cfg: Config | None = None):
        self.cfg = cfg or Config()

    def __call__(self, frame: Frame):
        c = self.cfg
        return glyph_decide(frame, ramp=c.ascii_ramp,
                            mode_on=c.ascii_mode_filter,
                            mode_radius=c.mode_radius,
                            mode_thresh=c.ascii_mode_thresh,
                            grayscale=c.use_grayscale)
