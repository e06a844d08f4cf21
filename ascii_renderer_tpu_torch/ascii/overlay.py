"""Text overlay: incremental text mirror of the glyph grid (torch port of
``ascii_renderer_tpu/ascii/overlay.py``; ref: js/text_overlay.js).

The reference maintains an invisible selectable DOM text layer refreshed one
row per frame (or all rows every N frames) so the rendered image is
copy-pasteable text. Terminal-side, the capability is an incrementally
refreshed row-string cache + cell-coordinate hit testing:

  - `refresh_row(y)` / `refresh_all()` recompute row strings from the
    latest frame with the SAME quantization as the device pass (here:
    decoded from the device chars grid, in sync by construction);
  - cadence helpers mirror the 'row' / 'interval' / 'off' update modes
    (js/main.js:316-339);
  - `cell_at(px_x, px_y)` maps pixel coordinates to cell coordinates
    (text_overlay.js:89-96) for click handling.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ascii_renderer_tpu_torch.core.config import Config
from ascii_renderer_tpu_torch.core.frame import Frame
from ascii_renderer_tpu_torch.core import quantize


class TextOverlay:
    def __init__(self, cfg: Config | None = None, *, cell_w: float = 8.0,
                 cell_h: float = 16.0, mode: str = "row", interval_n: int = 60):
        self.cfg = cfg or Config()
        self.cols = self.cfg.grid_width
        self.rows = self.cfg.grid_height
        self.cell_w = cell_w
        self.cell_h = cell_h
        assert mode in ("row", "interval", "off")
        self.mode = mode
        self.interval_n = max(1, interval_n)
        self._rows: List[str] = [" " * self.cols for _ in range(self.rows)]
        self._chars: Optional[np.ndarray] = None
        self._cursor = 0
        self._frame_count = 0

    # ------------------------------ data feed ------------------------------
    def set_chars(self, chars) -> None:
        """Latest device glyph grid (u8 [rows, cols], tensor or array)."""
        if hasattr(chars, "detach"):
            chars = chars.detach().cpu().numpy()
        a = np.asarray(chars)
        if a.shape != (self.rows, self.cols):
            self.rows, self.cols = a.shape
            self._rows = [" " * self.cols for _ in range(self.rows)]
            self._cursor = 0
        self._chars = a

    def set_frame(self, frame: Frame) -> None:
        """Feed a raw frame instead: decode with the canonical rule
        (_computeRowString parity, text_overlay.js:128-148)."""
        rgb = frame.rgb.cpu().numpy()
        a = frame.a.cpu().numpy()
        codes = quantize.ramp_codes(self.cfg.ascii_ramp)
        idx = quantize.quantize_index_np(rgb, len(codes))
        chars = codes[idx]
        ov = (a >= quantize.OVERRIDE_MIN) & (a <= quantize.OVERRIDE_MAX)
        self.set_chars(np.where(ov, a, chars))

    # ------------------------------ refresh -------------------------------
    def _row_string(self, y: int) -> str:
        if self._chars is None:
            return " " * self.cols
        return "".join(chr(c) if 32 <= c <= 126 else "?"
                       for c in self._chars[y])

    def refresh_row(self, y: int) -> str:
        s = self._row_string(y % self.rows)
        self._rows[y % self.rows] = s
        return s

    def refresh_all(self) -> List[str]:
        self._rows = [self._row_string(y) for y in range(self.rows)]
        return self._rows

    def update(self) -> None:
        """Per-frame cadence driver (updateDomOverlay, js/main.js:316-339)."""
        self._frame_count += 1
        if self.mode == "off":
            return
        if self.mode == "row":
            self.refresh_row(self._cursor)
            self._cursor = (self._cursor + 1) % self.rows
            return
        if self._frame_count % self.interval_n == 0:
            self.refresh_all()

    @property
    def text(self) -> str:
        return "\n".join(self._rows)

    # ----------------------------- hit testing ----------------------------
    def cell_at(self, px_x: float, px_y: float):
        """Pixel coords -> (cell_x, cell_y), clamped to the grid."""
        cx = int(px_x // self.cell_w)
        cy = int(px_y // self.cell_h)
        return (min(max(cx, 0), self.cols - 1), min(max(cy, 0), self.rows - 1))
