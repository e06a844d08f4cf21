"""Text emission: glyph grids -> Python strings (torch port of
``ascii_renderer_tpu/ascii/text.py``).

The chars grid is the source of truth, so text output is a host-side
decode of the device result, in sync by construction.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ascii_renderer_tpu_torch.ascii import ascii_pass as _pass
from ascii_renderer_tpu_torch.core.config import Config
from ascii_renderer_tpu_torch.core.frame import Frame


def chars_to_strings(chars) -> List[str]:
    """u8 [H, W] ASCII codes (tensor or array) -> list of row strings.
    Bytes outside 32..126 render as '?'."""
    if hasattr(chars, "detach"):
        chars = chars.detach().cpu().numpy()
    a = np.asarray(chars)
    return ["".join(chr(c) if 32 <= c <= 126 else "?" for c in row) for row in a]


def frame_to_strings(frame: Frame, cfg: Config | None = None) -> List[str]:
    """One-call convenience: frame -> glyph decision -> row strings
    (the TextOverlay capability, js/text_overlay.js:288-292)."""
    cfg = cfg or Config()
    chars, _ = _pass.glyph_decide(
        frame, ramp=cfg.ascii_ramp, mode_on=cfg.ascii_mode_filter,
        mode_radius=cfg.mode_radius, mode_thresh=cfg.ascii_mode_thresh,
        grayscale=cfg.use_grayscale)
    return chars_to_strings(chars)
