"""Modal (majority-vote) glyph smoothing — order-exact Boyer-Moore (torch
port of ``ascii_renderer_tpu/ascii/modal.py``).

Reproduces the reference shader's two-pass neighborhood vote
(js/ascii_pass_shader.js:77-138) bit-for-bit:

  pass 1: Boyer-Moore majority candidate over the K x K neighborhood
          (center excluded, UI-override neighbors excluded, out-of-grid
          neighbors CLAMPED to the edge), scanning dy then dx ascending.
  pass 2: count true votes for the candidate.
  adopt:  candidate replaces the center's ramp index iff
          cand >= 0 and votes >= thresh and cand != baseIdx.

Boyer-Moore is order-dependent when no strict majority exists, so the scan
order here must never change.
"""

from __future__ import annotations

import torch

_PAD = 3  # MAX_MODE_RADIUS


def _edge_pad(x: torch.Tensor) -> torch.Tensor:
    """Edge-replicate pad by _PAD on both spatial axes (clampCell,
    ascii_pass_shader.js:71-73), as an index gather: works for every dtype."""
    h, w = x.shape
    ri = torch.arange(-_PAD, h + _PAD, device=x.device).clamp_(0, h - 1)
    ci = torch.arange(-_PAD, w + _PAD, device=x.device).clamp_(0, w - 1)
    return x[ri][:, ci]


def _shifted(padded: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    h = padded.shape[0] - 2 * _PAD
    w = padded.shape[1] - 2 * _PAD
    return padded[_PAD + dy:_PAD + dy + h, _PAD + dx:_PAD + dx + w]


def _offsets(radius: int):
    # Scan order matches the GLSL loops: dy -3..3 outer, dx -3..3 inner,
    # entries outside `radius` or at the center skipped.
    out = []
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            if abs(dy) > radius or abs(dx) > radius:
                continue
            if dy == 0 and dx == 0:
                continue
            out.append((dy, dx))
    return out


def modal_candidate(idx: torch.Tensor, override: torch.Tensor, radius: int):
    """Per-cell Boyer-Moore candidate + true vote count.

    idx int32 [H, W] ramp indices; override bool [H, W] (excluded as
    voters); radius 1..3. Returns (cand int32 [H,W] with -1 = none,
    votes int32 [H,W])."""
    idx_p = _edge_pad(idx)
    ovr_p = _edge_pad(override)
    neigh = [(_shifted(idx_p, dy, dx), ~_shifted(ovr_p, dy, dx))
             for dy, dx in _offsets(radius)]

    cand = torch.full(idx.shape, -1, dtype=torch.int32, device=idx.device)
    cnt = torch.zeros(idx.shape, dtype=torch.int32, device=idx.device)
    for ni, valid in neigh:
        zero = cnt == 0
        match = ni == cand
        new_cand = torch.where(valid & zero, ni, cand)
        step = torch.where(zero, torch.ones_like(cnt),
                           torch.where(match, cnt + 1, cnt - 1))
        cnt = torch.where(valid, step, cnt)
        cand = new_cand

    votes = torch.zeros(idx.shape, dtype=torch.int32, device=idx.device)
    for ni, valid in neigh:
        votes = votes + (valid & (ni == cand)).to(torch.int32)
    return cand, votes


def modal_filter(idx: torch.Tensor, override: torch.Tensor, radius: int,
                 thresh: int) -> torch.Tensor:
    """Apply the smoothing decision (ascii_pass_shader.js:169-185).
    Override cells are never modified."""
    cand, votes = modal_candidate(idx, override, radius)
    adopt = (cand >= 0) & (votes >= thresh) & (cand != idx) & ~override
    return torch.where(adopt, cand, idx)
