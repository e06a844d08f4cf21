"""The ASCII pass: cell grid -> glyph grid (+ optional pixel expansion)
(torch port of ``ascii_renderer_tpu/ascii/ascii_pass.py``).

Outputs:
  chars  u8 [H, W]    — the glyph grid (ASCII codes);
  tint   u8 [H, W, 3] — per-cell glyph color (cell color, or black if
                        grayscale);
  pixels u8 [H*ch, W*cw, 3 or 4] — the glyph-bitmap expansion over white
                        (``expand_pixels``, plain torch on the frame's
                        device: no TPU kernel computes it).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.profiler import record_function

from ascii_renderer_tpu_torch.ascii import glyphs as glyphs_mod
from ascii_renderer_tpu_torch.core import quantize
from ascii_renderer_tpu_torch.core.config import Config
from ascii_renderer_tpu_torch.core.frame import Frame
from ascii_renderer_tpu_torch.ops import ascii_kernel


def glyph_decide(frame: Frame, *, ramp: str, mode_on: bool, mode_radius: int,
                 mode_thresh: int, grayscale: bool):
    """Per-cell glyph decision (ascii_pass_shader.js:140-188).
    Returns (chars u8 [H,W], tint u8 [H,W,3]); a frame of V views
    ([V, H, W]) is voted a view at a time. On a CUDA frame one launch from
    the bytes to the chars (``ops/ascii_kernel.glyph_chars``, B4's chars
    form); on the CPU its plain version, the torch chain of quantize, vote
    and ramp."""
    with record_function("glyph"):
        chars = ascii_kernel.glyph_chars(frame.rgb, frame.a, ramp,
                                         mode_on=mode_on, radius=mode_radius,
                                         thresh=mode_thresh)
        return chars, _tint(frame.rgb, grayscale)


def glyph_from_index(base_idx: torch.Tensor, a_plane: torch.Tensor,
                     tint_rgb_u8, *, ramp: str, mode_on: bool,
                     mode_radius: int, mode_thresh: int, grayscale: bool):
    """Image-space tail of the glyph decision, starting from a
    pre-quantized ramp-index plane (i32 [H, W]) — what
    ``render_soup_diag(emit="idx")`` assembles. On a CUDA plane one launch
    (the index form of ``ops/ascii_kernel.glyph_chars``)."""
    chars = ascii_kernel.glyph_chars(base_idx.to(torch.int32), a_plane, ramp,
                                     mode_on=mode_on, radius=mode_radius,
                                     thresh=mode_thresh)
    return chars, _tint(tint_rgb_u8, grayscale)


def _tint(rgb_u8, grayscale: bool):
    """The glyphs' colour: the cell's bytes, or black when grayscale."""
    if rgb_u8 is None:
        return None
    return torch.zeros_like(rgb_u8) if grayscale else rgb_u8


def expand_pixels(chars: torch.Tensor, tint: torch.Tensor,
                  atlas: torch.Tensor, alpha_gamma: float,
                  transparent_background: bool = False) -> torch.Tensor:
    """Glyph-bitmap expansion: composite tinted coverage over white
    (ascii_pass_shader.js:223-230). atlas: u8 [256, ch, cw] on the
    device of chars.

    transparent_background reproduces the shader's
    `if (uTransparentBG && texelIsTransparent(cov)) discard;`: the output
    grows an alpha channel, u8 [H*ch, W*cw, 4] with A = 0 exactly where
    coverage is zero (RGB stays the white composite); plain RGB
    [H*ch, W*cw, 3] otherwise.

    The atlas was already gamma-shaped at bake; applying alpha_gamma here
    again reproduces the reference's double application (glyphs.py). The
    power is taken in float64 and rounded once, so the CPU and the card
    agree; every other step is one float32 operation, and the divisions
    are IEEE (``quantize.fdiv``)."""
    h, w = chars.shape
    ch, cw = atlas.shape[1], atlas.shape[2]
    with record_function("glyph.expand"):
        cov = atlas[chars.long()]  # [H, W, ch, cw] u8
        cov = torch.pow(quantize.fdiv(cov.to(torch.float32), 255.0).double(),
                        alpha_gamma).float()
        t = quantize.fdiv(tint.to(torch.float32), 255.0)  # [H, W, 3]
        out = (1.0 - cov)[..., None] + cov[..., None] * t[:, :, None, None, :]
        out = quantize.float_rgb_to_u8(out)  # [H, W, ch, cw, 3]
        if transparent_background:
            a = (cov > 0.0).to(torch.uint8) * 255
            out = torch.cat([out, a[..., None]], dim=-1)
        n_chan = out.shape[-1]
        return out.permute(0, 2, 1, 3, 4).reshape(h * ch, w * cw, n_chan)


class AsciiPass:
    """Config-specialised ASCII pass: ``AsciiPass(cfg)(frame)`` ->
    (chars, tint); ``.pixels(frame)`` -> the glyph bitmap. ``.atlas`` is
    the glyph atlas (``glyph_atlas``, else the checked-in 8x16 asset) as a
    u8 tensor [256, ch, cw] on ``device``, moved there on first use."""

    def __init__(self, cfg: Config | None = None,
                 glyph_atlas: np.ndarray | None = None, device="cuda"):
        self.cfg = cfg or Config()
        self.device = torch.device(device)
        self._glyph_atlas = glyph_atlas
        self._atlas = None
        c = self.cfg
        self._expand = functools.partial(
            expand_pixels, alpha_gamma=c.alpha_gamma,
            transparent_background=c.transparent_background)

    @property
    def atlas(self) -> torch.Tensor:
        if self._atlas is None:
            src = (self._glyph_atlas if self._glyph_atlas is not None
                   else glyphs_mod.load_default_atlas())
            self._atlas = torch.tensor(np.asarray(src, np.uint8),
                                       device=self.device)
        return self._atlas

    def __call__(self, frame: Frame):
        c = self.cfg
        return glyph_decide(frame, ramp=c.ascii_ramp,
                            mode_on=c.ascii_mode_filter,
                            mode_radius=c.mode_radius,
                            mode_thresh=c.ascii_mode_thresh,
                            grayscale=c.use_grayscale)

    def pixels(self, frame: Frame) -> torch.Tensor:
        chars, tint = self(frame)
        return self._expand(chars, tint, self.atlas)
