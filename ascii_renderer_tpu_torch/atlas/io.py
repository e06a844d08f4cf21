"""ASCII-texture atlas IO (numpy copy of ``ascii_renderer_tpu/atlas/io.py``)
— the "Special RGBA Atlas" file format.

Format (ref: atlas_paint.py:5-66):
  - container: raw, headerless byte stream; RGBA8; row-major,
    top-to-bottom, left-to-right; (0,0) = top-left; length = w*h*4.
  - alpha semantics:
      A == 0        -> clear texel (RGB ignored)
      A == 1        -> solid color texel (RGB opaque)
      32 <= A <= 126-> ASCII glyph texel, A = character code, RGB = tint
      anything else -> invalid.

This module provides the loader / validator and the editing primitives
of the reference's AtlasModel (set_pixel / set_char / clear / ASCII-art
stamping), so atlases can be authored programmatically. The atlas stays a
host array until ``SceneBuilder.build`` moves it to the device.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ascii_renderer_tpu_torch.core.quantize import (
    ATLAS_CLEAR, ATLAS_GLYPH_MAX, ATLAS_GLYPH_MIN, ATLAS_SOLID,
)


def load_atlas(path: str, width: int, height: int, *,
               strict: bool = False) -> np.ndarray:
    """Load a raw atlas file -> u8 [height, width, 4], (0,0) top-left.

    Dimensions are out-of-band (the format is headerless). A size mismatch
    raises; invalid alpha content raises only if ``strict``."""
    data = np.fromfile(path, dtype=np.uint8)
    expected = width * height * 4
    if data.size != expected:
        raise ValueError(
            f"atlas size mismatch: expected {expected} bytes, got {data.size}")
    arr = data.reshape(height, width, 4)
    if strict and not valid_mask(arr).all():
        bad = int((~valid_mask(arr)).sum())
        raise ValueError(f"atlas has {bad} invalid texels")
    return arr


def save_atlas(path: str, arr: np.ndarray) -> None:
    """Write u8 [H, W, 4] as the raw headerless RGBA stream."""
    arr = np.asarray(arr, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 4:
        raise ValueError(f"save_atlas: expected [H, W, 4], got {arr.shape}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr.tofile(path)


def valid_mask(arr: np.ndarray) -> np.ndarray:
    """Per-texel content validity (ref: atlas_paint.py:124-126)."""
    a = np.asarray(arr)[..., 3]
    return (a == ATLAS_CLEAR) | (a == ATLAS_SOLID) | (
        (a >= ATLAS_GLYPH_MIN) & (a <= ATLAS_GLYPH_MAX))


def stamp_ascii_art(arr: np.ndarray, x: int, y: int, art: str,
                    rgb: Tuple[int, int, int] = (255, 255, 255),
                    space_clears: bool = False) -> np.ndarray:
    """Stamp multiline ASCII art as glyph texels at (x, y) (top-left of the
    stamp). Spaces are skipped (or clear the texel if ``space_clears``).
    Returns the mutated array (in place)."""
    h, w = arr.shape[:2]
    for dy, line in enumerate(art.splitlines()):
        yy = y + dy
        if not (0 <= yy < h):
            continue
        for dx, ch in enumerate(line):
            xx = x + dx
            if not (0 <= xx < w):
                continue
            code = ord(ch)
            if ch == " ":
                if space_clears:
                    arr[yy, xx] = (0, 0, 0, ATLAS_CLEAR)
                continue
            if ATLAS_GLYPH_MIN <= code <= ATLAS_GLYPH_MAX:
                arr[yy, xx, :3] = rgb
                arr[yy, xx, 3] = code
    return arr


class AtlasImage:
    """Editable atlas (the reference AtlasModel capability,
    atlas_paint.py:82-172)."""

    def __init__(self, width: int, height: int):
        self.arr = np.zeros((height, width, 4), dtype=np.uint8)

    @property
    def width(self) -> int:
        return self.arr.shape[1]

    @property
    def height(self) -> int:
        return self.arr.shape[0]

    @classmethod
    def load(cls, path: str, width: int, height: int) -> "AtlasImage":
        out = cls(width, height)
        out.arr = load_atlas(path, width, height)
        return out

    def save(self, path: str) -> None:
        save_atlas(path, self.arr)

    def set_pixel(self, x: int, y: int, rgb) -> None:
        """Solid color texel (A=1)."""
        self.arr[y, x, :3] = rgb
        self.arr[y, x, 3] = ATLAS_SOLID

    def set_char(self, x: int, y: int, ch: str, rgb) -> None:
        """Glyph texel (A=ord(ch)); ch must be visible ASCII."""
        if len(ch) != 1:
            raise ValueError("set_char requires a single character")
        code = ord(ch)
        if not (ATLAS_GLYPH_MIN <= code <= ATLAS_GLYPH_MAX):
            raise ValueError("character is not visible ASCII (32..126)")
        self.arr[y, x, :3] = rgb
        self.arr[y, x, 3] = code

    def clear(self, x: int, y: int) -> None:
        self.arr[y, x] = (0, 0, 0, ATLAS_CLEAR)

    def valid_mask(self) -> np.ndarray:
        return valid_mask(self.arr)

    def stamp(self, x: int, y: int, art: str, rgb=(255, 255, 255)) -> None:
        stamp_ascii_art(self.arr, x, y, art, rgb)

    def preview_image(self, scale: int = 16):
        """PNG-able PIL preview for human inspection (clear = checkerboard,
        solid = fill, glyph = drawn character, invalid = red X). Needs
        PIL, imported here."""
        from PIL import Image, ImageDraw, ImageFont
        h, w = self.height, self.width
        img = Image.new("RGBA", (w * scale, h * scale), (0, 0, 0, 0))
        d = ImageDraw.Draw(img)
        c1, c2 = (200, 200, 200, 255), (160, 160, 160, 255)
        ck = max(4, scale // 2)
        for yy in range(0, h * scale, ck):
            for xx in range(0, w * scale, ck):
                d.rectangle([xx, yy, xx + ck - 1, yy + ck - 1],
                            fill=c1 if ((xx // ck + yy // ck) % 2 == 0)
                            else c2)
        try:
            font = ImageFont.truetype("DejaVuSansMono.ttf", int(scale * 0.75))
        except OSError:
            font = ImageFont.load_default()
        for y in range(h):
            for x in range(w):
                r, g, b, a = (int(v) for v in self.arr[y, x])
                box = [x * scale, y * scale, (x + 1) * scale - 1,
                       (y + 1) * scale - 1]
                if a == ATLAS_CLEAR:
                    continue
                if a == ATLAS_SOLID:
                    d.rectangle(box, fill=(r, g, b, 255))
                elif ATLAS_GLYPH_MIN <= a <= ATLAS_GLYPH_MAX:
                    d.text((box[0] + scale // 5, box[1]), chr(a),
                           fill=(r, g, b, 255), font=font)
                else:
                    d.rectangle(box, outline=(255, 0, 0, 255), width=2)
                    d.line(box, fill=(255, 0, 0, 255), width=2)
        return img


def demo_atlas_wide(width: int = 32, height: int = 16) -> np.ndarray:
    """A non-square (32x16 by default) demo atlas — the shape class of the
    reference's ``atlas3.bin`` (checked in as
    ``assets/atlas_wide_32x16.bin``)."""
    img = AtlasImage(width, height)
    art = r"""
 ><(((*>  ~~~
   ~~  ><(((*>
""".strip("\n")
    img.stamp(1, 5, art, rgb=(120, 200, 240))
    for x in range(width):  # sea floor: solid texels
        img.set_pixel(x, height - 1, (180, 150, 90))
        img.set_pixel(x, height - 2, (60, 90, 160))
    for y in range(0, 3):  # sky band
        img.set_pixel(0, y, (40, 60, 120))
        img.set_pixel(width - 1, y, (40, 60, 120))
    return img.arr


def demo_atlas(width: int = 32, height: int = 32) -> np.ndarray:
    """The 32x32 demo ASCII-art atlas (the role of the reference's
    atlas.bin poster texture)."""
    img = AtlasImage(width, height)
    art = r"""
   _____
  /     \
 | () () |
  \  ^  /
   |||||
   |||||
  TPU CAT
""".strip("\n")
    img.stamp(2, 4, art, rgb=(240, 220, 80))
    # solid border frame
    for x in range(width):
        img.set_pixel(x, 0, (60, 80, 200))
        img.set_pixel(x, height - 1, (60, 80, 200))
    for y in range(height):
        img.set_pixel(0, y, (60, 80, 200))
        img.set_pixel(width - 1, y, (200, 80, 60))
    return img.arr
