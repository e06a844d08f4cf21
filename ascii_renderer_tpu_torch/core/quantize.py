"""The glyph quantization rule and the alpha-byte protocol (torch port of
``ascii_renderer_tpu/core/quantize.py``; the contract is bit-exact).

Quantization rule (positive-half-up rounding, NOT banker's rounding):
  intensity = (r + g + b) / 3            # r,g,b as 0..255 ints
  x   = clamp(intensity / 255, 0, 1 - 1e-6)
  idx = clamp(floor(x * (ramp_len - 1) + 0.5), 0, ramp_len - 1)
Rounding is always ``floor(x + 0.5)``: ``torch.round`` rounds half to even
and would move every .5 boundary.
"""

from __future__ import annotations

import numpy as np
import torch

# Frame alpha protocol (ref: js/main.js:352-358).
OVERRIDE_MIN = 2
OVERRIDE_MAX = 254

# Atlas alpha protocol (ref: atlas_paint.py:18-23).
ATLAS_CLEAR = 0
ATLAS_SOLID = 1
ATLAS_GLYPH_MIN = 32
ATLAS_GLYPH_MAX = 126

DEFAULT_RAMP = "@%#*+=-:. "


def ramp_codes(ramp: str) -> np.ndarray:
    """ASCII codes of a ramp string as a uint8 numpy array (host constant)."""
    if not ramp:
        ramp = DEFAULT_RAMP
    return np.frombuffer(ramp.encode("ascii"), dtype=np.uint8).copy()


def fdiv(a: torch.Tensor, b: float) -> torch.Tensor:
    """IEEE float32 ``a / b``. On CUDA, PyTorch computes ``tensor / python
    scalar`` as ``a * (1/b)``, which is not the correctly rounded quotient
    (e.g. for b = 3 or 255); dividing by a 0-d tensor on ``a``'s device
    keeps the true division on every device."""
    return torch.div(a, torch.tensor(b, dtype=a.dtype, device=a.device))


def intensity_u8(rgb_u8: torch.Tensor) -> torch.Tensor:
    """Average-of-bytes intensity in 0..255 as float32: integer sum first,
    one float divide (the CPU oracle's order, text_overlay.js:142)."""
    s = rgb_u8.to(torch.int32).sum(dim=-1, dtype=torch.int32)
    return fdiv(s.to(torch.float32), 3.0)


def quantize_index(rgb_u8: torch.Tensor, ramp_len: int) -> torch.Tensor:
    """RGB bytes [..., 3] -> ramp index [...] (int32). Bit-exact contract 3."""
    n = float(max(1, ramp_len) - 1)
    x = fdiv(intensity_u8(rgb_u8), 255.0)
    x = torch.clamp(x, 0.0, 1.0 - 1e-6)
    idx = torch.floor(x * n + 0.5)
    return torch.clamp(idx, 0.0, n).to(torch.int32)


def is_override(a_u8: torch.Tensor) -> torch.Tensor:
    """Mask of cells whose alpha byte encodes an ASCII override."""
    a = a_u8.to(torch.int32)
    return (a >= OVERRIDE_MIN) & (a <= OVERRIDE_MAX)


def quantize_index_np(rgb_u8: np.ndarray, ramp_len: int) -> np.ndarray:
    """Pure-numpy twin of :func:`quantize_index` (the host decode of
    ``ascii.overlay.TextOverlay.set_frame``)."""
    n = np.float32(max(1, ramp_len) - 1)
    s = rgb_u8.astype(np.int64).sum(axis=-1)
    x = s.astype(np.float32) / np.float32(3.0) / np.float32(255.0)
    x = np.clip(x, 0.0, 1.0 - 1e-6)
    idx = np.floor(x * n + np.float32(0.5))
    return np.clip(idx, 0, n).astype(np.int32)


def float_rgb_to_u8(rgb: torch.Tensor) -> torch.Tensor:
    """Linear [0,1] float RGB -> bytes, matching GL RGBA8 UNORM conversion
    (round-half-up of clamp(v,0,1)*255)."""
    v = torch.clamp(rgb, 0.0, 1.0) * 255.0
    return torch.floor(v + 0.5).to(torch.uint8)
