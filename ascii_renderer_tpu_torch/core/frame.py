"""Cell-grid frame (torch port of ``ascii_renderer_tpu/core/frame.py``):

  rgb : uint8 [rows, cols, 3]  — cell colors
  a   : uint8 [rows, cols]     — alpha byte carrying the override protocol

Row 0 is the TOP row.
"""

from __future__ import annotations

import dataclasses

import torch


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
    def blank(rows: int, cols: int, device="cuda") -> "Frame":
        return Frame(
            rgb=torch.zeros((rows, cols, 3), dtype=torch.uint8, device=device),
            a=torch.ones((rows, cols), dtype=torch.uint8, device=device),
        )

    @staticmethod
    def from_float(rgb: torch.Tensor, a: torch.Tensor | None = None,
                   overrides=None, ui=None) -> "Frame":
        """Build from linear [0,1] float RGB with GL UNORM byte conversion;
        ``a`` may be a uint8 alpha plane or None (=1); ``overrides``, a UI
        plane (chars u8, mask bool), is burnt in as ``with_overrides``
        burns it, or ``ui``, the frame step's UI layer by value
        (``sim/ui.UiParams``), drawn and burnt in. Any leading shape (a
        batch of views [V, H, W, 3] too; one frame with ``ui``). On a CUDA
        tensor one launch of the kernel of ``ops/frame_bytes`` (X12a; its
        UI form with ``ui``), on the CPU its plain version (the torch
        chain, ``with_overrides``' route)."""
        from ascii_renderer_tpu_torch.ops.frame_bytes import frame_bytes
        chars, mask = overrides if overrides is not None else (None, None)
        return Frame(*frame_bytes(rgb, a, chars, mask, ui=ui))

    def with_overrides(self, chars: torch.Tensor, mask: torch.Tensor) -> "Frame":
        """Burn a char plane into the frame where ``mask`` is set: RGB <- black,
        A <- char code (ref: applyUIToFrameRGBA, js/main.js:342-361)."""
        rgb = torch.where(mask[..., None], torch.zeros_like(self.rgb), self.rgb)
        a = torch.where(mask, chars.to(torch.uint8), self.a)
        return Frame(rgb=rgb, a=a)

    def interleaved(self) -> torch.Tensor:
        """RGBA-interleaved uint8 [H, W, 4] (the reference's wire format,
        for IO / preview compatibility)."""
        return torch.cat([self.rgb, self.a[..., None]], dim=-1)

    @staticmethod
    def from_interleaved(rgba: torch.Tensor) -> "Frame":
        return Frame(rgb=rgba[..., :3].to(torch.uint8),
                     a=rgba[..., 3].to(torch.uint8))
