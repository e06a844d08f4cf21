"""UI text layer: pi-digit border, FPS readout, click ripples (torch port of
``ascii_renderer_tpu/sim/ui.py``; ref: js/renderer.js renderUI:125-159).

The layer is a (chars u8 [H, W], mask bool [H, W]) pair that the frame step
burns into the frame's alpha plane (``Frame.with_overrides``). It depends
only on host state (the grid, the FPS value, the ripple pool and the
clock). The frame step passes it by value, ``ui_params`` (the pi digits,
the FPS readout's digits, each live ripple's centre and radius): on a CUDA
device X12a's UI form draws it in the frame's byte launch, with no copy
and no march on the host (``ops/frame_bytes``); on the CPU its plain
version builds the planes (``UiParams.planes``). ``ui_char_plane`` builds
the same planes on the host, as numpy, and copies them to the device once.
The static border is built once per grid and cached, as the reference
bakes it into its compiled program.

Draw order matches the reference exactly: border, then FPS (overwrites the
border bottom-right), then ripples on top.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ascii_renderer_tpu_torch.core.config import Config

MAX_RIPPLES = 16
_MAX_BRESENHAM_STEPS = 128  # covers radius <= ~180 (max radius is 100)
FPS_MAX_DIGITS = 7  # int32-safe; the reference prints String(fps) unbounded


@functools.lru_cache(maxsize=16)
def _border(pi: str, rows: int, cols: int):
    chars = np.zeros((rows, cols), np.uint8)
    mask = np.zeros((rows, cols), bool)
    n = len(pi)
    for x in range(cols):
        c = ord(pi[x % n])
        chars[0, x] = chars[rows - 1, x] = c
        mask[0, x] = mask[rows - 1, x] = True
    for y in range(rows):
        c = ord(pi[y % n])
        chars[y, 0] = chars[y, cols - 1] = c
        mask[y, 0] = mask[y, cols - 1] = True
    chars.flags.writeable = False
    mask.flags.writeable = False
    return chars, mask


def border_plane(cfg: Config, rows: int, cols: int):
    """Static pi-digit border (renderUI:130-137), host tensors; built once
    per grid size."""
    chars, mask = _border(cfg.pi_digits, rows, cols)
    return torch.from_numpy(chars.copy()), torch.from_numpy(mask.copy())


def _fps_digits(fps, cols: int):
    """(start_x, the digits' codes) of the readout: round(fps) in float32,
    half to even, NaN 0, clamped to [0, 10^FPS_MAX_DIGITS - 1]."""
    nd = FPS_MAX_DIGITS
    f = np.round(np.float32(fps))  # half to even, as the reference's round
    f = 0 if np.isnan(f) else int(np.clip(f, 0, 10 ** nd - 1))
    pows = 10 ** np.arange(nd - 1, -1, -1, dtype=np.int64)
    digits = (f // pows) % 10
    ndig = 1 + int((f >= pows[:-1]).sum())
    return cols - ndig - 1, tuple(int(ord("0") + d)
                                  for d in digits[nd - ndig:])


def _fps_plane_np(start_x: int, codes, rows: int, cols: int):
    chars = np.zeros((rows, cols), np.uint8)
    mask = np.zeros((rows, cols), bool)
    xg = np.arange(cols)
    sel = (xg >= start_x) & (xg < start_x + len(codes))
    chars[rows - 1, sel] = np.asarray(codes, np.uint8)[xg[sel] - start_x]
    mask[rows - 1] = sel
    return chars, mask


def _fps_np(fps, rows: int, cols: int):
    return _fps_plane_np(*_fps_digits(fps, cols), rows, cols)


def fps_plane(fps, rows: int, cols: int):
    """FPS counter bottom-right (renderUI:140-147): the decimal digits of
    round(fps), right-aligned at x = cols - len - 1, y = rows - 1; clamped
    at 10^FPS_MAX_DIGITS - 1. Host tensors."""
    chars, mask = _fps_np(fps, rows, cols)
    return torch.from_numpy(chars), torch.from_numpy(mask)


def _bresenham_np(cx, cy, r):
    M = cx.shape[0]
    steps = _MAX_BRESENHAM_STEPS
    pxb = np.zeros((steps, 8, M), np.int32)
    pyb = np.zeros((steps, 8, M), np.int32)
    onb = np.zeros((steps, 8, M), bool)
    x, y = r.astype(np.int32), np.zeros(M, np.int32)
    err = np.zeros(M, np.int32)
    octants = ((1, 1, False), (1, 1, True), (-1, 1, True), (-1, 1, False),
               (-1, -1, False), (-1, -1, True), (1, -1, True), (1, -1, False))
    for i in range(steps):
        active = x >= y
        for o, (sx, sy, swap) in enumerate(octants):
            dx, dy = (y, x) if swap else (x, y)
            pxb[i, o] = cx + sx * dx
            pyb[i, o] = cy + sy * dy
        onb[i] = active
        if not active.any():  # every march has ended: the rest repeats
            pxb[i + 1:], pyb[i + 1:] = pxb[i], pyb[i]
            break
        # JS: if (err <= 0) { y++; err += 2*y+1; }  — err uses the NEW y
        #     if (err > 0)  { x--; err -= 2*x+1; }  — err uses the NEW x
        y2 = np.where(err <= 0, y + 1, y)
        err2 = np.where(err <= 0, err + 2 * y2 + 1, err)
        x2 = np.where(err2 > 0, x - 1, x)
        err3 = np.where(err2 > 0, err2 - 2 * x2 - 1, err2)
        x = np.where(active, x2, x)
        y = np.where(active, y2, y)
        err = np.where(active, err3, err)
    return pxb, pyb, onb


def _bresenham_circle_points(cx, cy, r):
    """Midpoint-circle cells of drawCircleOnBuffer (renderer.js:108-123),
    all ripples marched together: cx/cy/r int32 [M] -> (px, py, on), each
    [steps, 8, M] (``on``: the cell was emitted while the march was
    active). Host tensors."""
    out = _bresenham_np(*(np.asarray(v, np.int32) for v in (cx, cy, r)))
    return tuple(torch.from_numpy(a) for a in out)


def _ripple_circles(ripples, n_ripples, time_ms, ripple_speed, max_radius):
    """The live ripples' (cx, cy, r), int32 [L] each, in pool order: radius
    (time_ms - start) * speed in float32, live for the first n_ripples
    slots with 0 <= radius <= max_radius; centre and radius rounded half to
    even."""
    rip = np.asarray(ripples, np.float32)
    radius = (np.float32(time_ms) - rip[:, 2]) * np.float32(ripple_speed)
    live = ((np.arange(MAX_RIPPLES) < int(n_ripples))
            & (radius >= 0.0) & (radius <= np.float32(max_radius)))
    cx = np.round(rip[:, 0]).astype(np.int32)
    cy = np.round(rip[:, 1]).astype(np.int32)
    r = np.round(radius).astype(np.int32)
    return cx[live], cy[live], r[live]


def _circles_mask(cx, cy, r, rows: int, cols: int):
    """The cells the circles' marches emit inside the grid (each march on
    its own: a ripple's cells do not depend on the others)."""
    mask = np.zeros((rows, cols), bool)
    if len(cx):  # nothing to draw otherwise
        px, py, on = _bresenham_np(cx, cy, r)
        ok = on & (px >= 0) & (px < cols) & (py >= 0) & (py < rows)
        mask[py[ok], px[ok]] = True
    return mask


def ripple_cells(dx, dy, r: int):
    """X12a's UI form's rule for a ripple of radius ``r`` (csrc/
    frame_bytes.cu ``ripple_cell``), over int arrays of offsets dx, dy from
    its centre, a = max(|dx|, |dy|), b = min(|dx|, |dy|): only cells on the
    ring r^2 - 3 r - 1 <= a^2 + b^2 <= r^2 can be emitted. Where b + r - a
    < _MAX_BRESENHAM_STEPS the march's rows in closed form: at row b it
    holds x from M(b) = isqrt(r^2 + 1 - (b + 1)^2) up to max(M(b), M(b - 1)
    - 1), at row 0 x = r only, which is r^2 - 2 (a + b) <= a^2 + b^2 <= r^2
    - 2 b. Elsewhere the march, replayed until y >= b and x <= a, must
    stand at (a, b) there, active and within _MAX_BRESENHAM_STEPS steps (it
    does not depend on the cell, so it is replayed once for all of
    them)."""
    ax, ay = np.abs(dx).astype(np.int64), np.abs(dy).astype(np.int64)
    a, b = np.maximum(ax, ay), np.minimum(ax, ay)
    d, rr = a * a + b * b, r * r
    ring = (a <= r) & (d <= rr) & (d >= rr - 3 * r - 1)
    short = b + r - a < _MAX_BRESENHAM_STEPS
    hit = ring & short & (d >= rr - 2 * (a + b)) & (d <= rr - 2 * b)
    todo = ring & ~short
    x, y, err = r, 0, 0
    for _ in range(_MAX_BRESENHAM_STEPS):
        if x < y or not todo.any():
            break
        there = todo & (y >= b) & (x <= a)
        hit |= there & (x == a) & (y == b)
        todo &= ~there
        if err <= 0:
            y += 1
            err += 2 * y + 1
        if err > 0:
            x -= 1
            err -= 2 * x + 1
    return hit


class UiParams(NamedTuple):
    """The UI layer by value (X12a's UI form, ``ops/frame_bytes``): the
    grid, the pi digits, the FPS readout's first column and digit codes,
    and the live ripples' (cx, cy, r)."""
    rows: int
    cols: int
    pi: str
    fps_x: int
    fps_codes: tuple
    circles: tuple  # ((cx, cy, r), ...), at most MAX_RIPPLES

    def values(self) -> list:
        """The kernel's ints: rows, cols, len(pi), fps_x, the digits, the
        ripples, then FPS_MAX_DIGITS codes and MAX_RIPPLES cx, cy and r
        (zero past the ones given)."""
        pad = list(self.circles) + [(0, 0, 0)] * (MAX_RIPPLES
                                                  - len(self.circles))
        codes = list(self.fps_codes) + [0] * (FPS_MAX_DIGITS
                                              - len(self.fps_codes))
        return [self.rows, self.cols, len(self.pi), self.fps_x,
                len(self.fps_codes), len(self.circles), *codes,
                *(c[0] for c in pad), *(c[1] for c in pad),
                *(c[2] for c in pad)]

    def planes_np(self):
        """(chars u8 [H, W], mask bool [H, W]) as numpy, in the reference's
        order: border, then FPS, then ripples on top."""
        bc, bm = _border(self.pi, self.rows, self.cols)
        fc, fm = _fps_plane_np(self.fps_x, self.fps_codes, self.rows,
                               self.cols)
        rm = _circles_mask(*(np.array([c[k] for c in self.circles],
                                      np.int32) for k in range(3)),
                           self.rows, self.cols)
        chars = np.where(rm, np.uint8(ord("*")),
                         np.where(fm, fc, np.where(bm, bc, 0)))
        return chars.astype(np.uint8), bm | fm | rm

    def planes(self, device="cpu"):
        """The planes as tensors on ``device`` (one copy)."""
        chars, mask = self.planes_np()
        both = torch.from_numpy(np.stack([chars, mask.astype(np.uint8)]))
        both = both.to(device, non_blocking=False)
        return both[0], both[1].view(torch.bool)  # 0 / 1 bytes: no conversion


def _ripples_np(ripples, n_ripples, time_ms, ripple_speed, max_radius,
                rows: int, cols: int):
    mask = _circles_mask(*_ripple_circles(ripples, n_ripples, time_ms,
                                          ripple_speed, max_radius),
                         rows, cols)
    return np.where(mask, np.uint8(ord("*")), np.uint8(0)), mask


def ripples_plane(ripples, n_ripples, time_ms, ripple_speed, max_radius,
                  rows: int, cols: int):
    """Expanding '*' circles (renderUI:150-157): radius = age * speed.
    ripples f32 [MAX_RIPPLES, 3] = (x, y, start_time_ms). Effects whose
    radius exceeds ``max_radius`` are skipped (the reference never expires
    them). Host tensors."""
    chars, mask = _ripples_np(ripples, n_ripples, time_ms, ripple_speed,
                              max_radius, rows, cols)
    return torch.from_numpy(chars), torch.from_numpy(mask)


def ui_params(cfg: Config, rows: int, cols: int, fps, ripples, n_ripples,
              time_ms) -> UiParams:
    """The UI layer by value, from host state alone: no march, no copy."""
    cx, cy, r = _ripple_circles(ripples, n_ripples, time_ms,
                                cfg.ripple_speed, cfg.max_ripple_radius)
    return UiParams(rows, cols, cfg.pi_digits, *_fps_digits(fps, cols),
                    tuple(zip(cx.tolist(), cy.tolist(), r.tolist())))


def ui_char_plane(cfg: Config, rows: int, cols: int, fps, ripples,
                  n_ripples, time_ms, device="cuda"):
    """Full UI layer -> (chars u8 [H, W], mask bool [H, W]) on ``device``:
    built on the host, copied once."""
    return ui_params(cfg, rows, cols, fps, ripples, n_ripples,
                     time_ms).planes(device)
