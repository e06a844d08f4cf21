"""Glyph atlas: per-character coverage bitmaps for pixel output (torch
port of ``ascii_renderer_tpu/ascii/glyphs.py``; numpy and PIL only).

The reference bakes a 256-glyph atlas from the page's monospace font at
device-pixel cell size, with an alpha-gamma pre-shaping pass
(js/ascii_pass.js:20-86). Here the atlas is a dense uint8 coverage array
``[256, cell_h, cell_w]``: the checked-in 8x16 asset
(``assets/glyph_atlas_8x16.npz``, shared with the JAX package, which
baked it) or one baked on demand at another cell size (``--cell``).
``load_default_atlas`` only reads the asset; it never bakes or writes it.

Note the reference applies alpha-gamma TWICE — once at bake
(ascii_pass.js:65-74) and again in the shader (`pow(cov, uAlphaGamma)`,
ascii_pass_shader.js:224) — so the effective exponent is gamma^2. The
bake here applies it once and ``ascii_pass.expand_pixels`` again.
"""

from __future__ import annotations

import os

import numpy as np

DEFAULT_CELL_W = 8
DEFAULT_CELL_H = 16
_ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets", "glyph_atlas_8x16.npz")


def bake_glyph_atlas(cell_w: int = DEFAULT_CELL_W, cell_h: int = DEFAULT_CELL_H,
                     gamma: float = 1.32, font_path: str | None = None) -> np.ndarray:
    """Rasterize chr(0..255) into a uint8 coverage atlas [256, cell_h, cell_w].

    Mirrors buildAtlas's metric policy (js/ascii_pass.js:41-61): alphabetic
    baseline, glyph box vertically centered from measured ascent/descent.
    Non-printable codes bake to empty tiles (canvas fillText of control chars
    is likewise blank).
    """
    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError:
        return _fallback_atlas(cell_w, cell_h)

    # Pick the largest font size whose advance fits the cell width.
    font = None
    for size in range(cell_h, 4, -1):
        try:
            if font_path:
                f = ImageFont.truetype(font_path, size)
            else:
                f = ImageFont.truetype("DejaVuSansMono.ttf", size)
        except OSError:
            return _fallback_atlas(cell_w, cell_h)
        if f.getlength("M") <= cell_w:
            font = f
            break
    if font is None:
        return _fallback_atlas(cell_w, cell_h)

    ascent, descent = font.getmetrics()
    glyph_h = ascent + descent
    baseline_y = (cell_h - glyph_h) // 2 + ascent

    atlas = np.zeros((256, cell_h, cell_w), dtype=np.uint8)
    pad = 2  # supersample margin like the reference's 2px tile pad
    for code in range(32, 127):
        img = Image.new("L", (cell_w + 2 * pad, cell_h + 2 * pad), 0)
        d = ImageDraw.Draw(img)
        d.text((pad, pad + baseline_y - ascent), chr(code), fill=255, font=font)
        a = np.asarray(img, dtype=np.float32)[pad:pad + cell_h, pad:pad + cell_w]
        atlas[code] = np.clip(np.round(np.power(a / 255.0, gamma) * 255.0), 0, 255)
    return atlas


def _fallback_atlas(cell_w: int, cell_h: int) -> np.ndarray:
    """Crude procedural coverage (density proportional to code class) used only
    when no TrueType font is available; keeps the pipeline functional."""
    atlas = np.zeros((256, cell_h, cell_w), dtype=np.uint8)
    yy, xx = np.mgrid[0:cell_h, 0:cell_w]
    interior = ((yy > 1) & (yy < cell_h - 2) & (xx > 0) & (xx < cell_w - 1))
    for code in range(33, 127):
        level = 1 + (code % 9)
        tile = ((yy * cell_w + xx) * 7 % 10 < level) & interior
        atlas[code] = tile.astype(np.uint8) * 255
    return atlas


def load_default_atlas() -> np.ndarray:
    """The checked-in 8x16 atlas asset, u8 [256, 16, 8]. Raises if the
    asset is missing: it is part of the repository."""
    if not os.path.exists(_ASSET):
        raise FileNotFoundError(
            f"glyph atlas asset {_ASSET} is missing (it is checked in; "
            "restore it from the repository)")
    with np.load(_ASSET) as z:
        return z["atlas"]
