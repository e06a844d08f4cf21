"""Cell-grid frame (torch port of ``ascii_renderer_tpu/core/frame.py``):

  rgb : uint8 [rows, cols, 3]  — cell colors
  a   : uint8 [rows, cols]     — alpha byte carrying the override protocol

Row 0 is the TOP row.
"""

from __future__ import annotations

import dataclasses

import torch

from ascii_renderer_tpu_torch.core import quantize


@dataclasses.dataclass(frozen=True)
class Frame:
    rgb: torch.Tensor  # uint8 [H, W, 3]
    a: torch.Tensor  # uint8 [H, W]

    @property
    def rows(self) -> int:
        return self.rgb.shape[0]

    @property
    def cols(self) -> int:
        return self.rgb.shape[1]

    @staticmethod
    def blank(rows: int, cols: int, device="cpu") -> "Frame":
        return Frame(
            rgb=torch.zeros((rows, cols, 3), dtype=torch.uint8, device=device),
            a=torch.ones((rows, cols), dtype=torch.uint8, device=device),
        )

    @staticmethod
    def from_float(rgb: torch.Tensor, a: torch.Tensor | None = None) -> "Frame":
        """Build from linear [0,1] float RGB with GL UNORM byte conversion;
        ``a`` may be a uint8 alpha plane or None (=1)."""
        rgb_u8 = quantize.float_rgb_to_u8(rgb)
        if a is None:
            a_u8 = torch.ones(rgb.shape[:-1], dtype=torch.uint8,
                              device=rgb.device)
        else:
            a_u8 = a.to(torch.uint8)
        return Frame(rgb=rgb_u8, a=a_u8)

    def with_overrides(self, chars: torch.Tensor, mask: torch.Tensor) -> "Frame":
        """Burn a char plane into the frame where ``mask`` is set: RGB <- black,
        A <- char code (ref: applyUIToFrameRGBA, js/main.js:342-361)."""
        rgb = torch.where(mask[..., None], torch.zeros_like(self.rgb), self.rgb)
        a = torch.where(mask, chars.to(torch.uint8), self.a)
        return Frame(rgb=rgb, a=a)
