"""UI text layer: pi-digit border, FPS readout, click ripples (torch port of
``ascii_renderer_tpu/sim/ui.py``; ref: js/renderer.js renderUI:125-159).

The layer is a (chars u8 [H, W], mask bool [H, W]) pair that the frame step
burns into the frame's alpha plane (``Frame.with_overrides``). It is a few
hundred cells of integer work that depends only on host state (the grid,
the FPS value, the ripple pool and the clock), so it is built on the host,
as numpy, and ``ui_char_plane`` copies the finished planes to the render
device once. The static border is built once per grid and cached, as the
reference bakes it into its compiled program.

Draw order matches the reference exactly: border, then FPS (overwrites the
border bottom-right), then ripples on top.
"""

from __future__ import annotations

import functools

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


def _fps_np(fps, rows: int, cols: int):
    nd = FPS_MAX_DIGITS
    f = np.round(np.float32(fps))  # half to even, as the reference's round
    f = 0 if np.isnan(f) else int(np.clip(f, 0, 10 ** nd - 1))
    pows = 10 ** np.arange(nd - 1, -1, -1, dtype=np.int64)
    digits = (f // pows) % 10
    ndig = 1 + int((f >= pows[:-1]).sum())
    start_x = cols - ndig - 1
    chars = np.zeros((rows, cols), np.uint8)
    mask = np.zeros((rows, cols), bool)
    xg = np.arange(cols)
    sel = (xg >= start_x) & (xg < start_x + ndig)
    di = np.clip(nd - ndig + (xg - start_x), 0, nd - 1)
    chars[rows - 1] = np.where(sel, ord("0") + digits[di], 0)
    mask[rows - 1] = sel
    return chars, mask


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


def _ripples_np(ripples, n_ripples, time_ms, ripple_speed, max_radius,
                rows: int, cols: int):
    rip = np.asarray(ripples, np.float32)
    mask = np.zeros((rows, cols), bool)
    radius = (np.float32(time_ms) - rip[:, 2]) * np.float32(ripple_speed)
    live = ((np.arange(MAX_RIPPLES) < int(n_ripples))
            & (radius >= 0.0) & (radius <= np.float32(max_radius)))
    if live.any():  # nothing to draw otherwise
        cx = np.round(rip[:, 0]).astype(np.int32)
        cy = np.round(rip[:, 1]).astype(np.int32)
        r = np.round(radius).astype(np.int32)
        px, py, on = _bresenham_np(cx, cy, np.where(live, r, 0))
        ok = (on & live[None, None, :] & (px >= 0) & (px < cols)
              & (py >= 0) & (py < rows))
        mask[py[ok], px[ok]] = True
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


def ui_char_plane(cfg: Config, rows: int, cols: int, fps, ripples,
                  n_ripples, time_ms, device="cuda"):
    """Full UI layer -> (chars u8 [H, W], mask bool [H, W]) on ``device``:
    built on the host, copied once."""
    bc, bm = _border(cfg.pi_digits, rows, cols)
    fc, fm = _fps_np(fps, rows, cols)
    rc, rm = _ripples_np(ripples, n_ripples, time_ms, cfg.ripple_speed,
                         cfg.max_ripple_radius, rows, cols)
    chars = np.where(rm, rc, np.where(fm, fc, np.where(bm, bc, 0)))
    mask = bm | fm | rm
    both = torch.from_numpy(np.stack([chars.astype(np.uint8),
                                      mask.astype(np.uint8)]))
    both = both.to(device, non_blocking=False)
    return both[0], both[1].view(torch.bool)  # 0 / 1 bytes: no conversion
