"""Text emission: glyph grids -> Python strings."""

from __future__ import annotations

from typing import List

import numpy as np


def chars_to_strings(chars) -> List[str]:
    """u8 [H, W] ASCII codes (tensor or array) -> list of row strings.
    Bytes outside 32..126 render as '?'."""
    if hasattr(chars, "detach"):
        chars = chars.detach().cpu().numpy()
    a = np.asarray(chars)
    return ["".join(chr(c) if 32 <= c <= 126 else "?" for c in row) for row in a]
