"""Shared raster infrastructure: tile geometry, deferred row shading and
the int32 cumsum (torch port of
``ascii_renderer_tpu/backends/raster_common.py``). The row shading
``_shade_rows`` lives beside its kernel in ``ops/raster_shade``."""

from __future__ import annotations

import torch

from ascii_renderer_tpu_torch.ops import raster_shade as RSH
from ascii_renderer_tpu_torch.ops.raster_shade import (  # noqa: F401
    _DEFAULT_AMBIENT, _DEFAULT_DIR, _DEFAULT_DIR_COL, _dot3, _shade_rows)
from ascii_renderer_tpu_torch.scene.builder import SceneData

NEAR, FAR = 0.05, 100.0

TILE_H, TILE_W = 8, 128

MAX_V_CAP = (1 << 19) - 4096  # packed sort key leaves 19 bits for tri ids


def _round_up(x, q):
    return -(-x // q) * q


def _cumsum_i32(mask: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum of a bool / 0-1 [N] tensor as int32 (the
    reference blocks it onto the TPU's matrix unit; the counts are
    exact either way)."""
    return torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)


def shade_from_table(tid, table, scene: SceneData, rows: int, cols: int,
                     n_attrs: int = 9):
    """Per-pixel plane evaluation + reference fragment lighting. tid i32
    [rows, cols] indexes rows of ``table`` [N+1, W] (plane-table rows + one
    trailing all-zero background row); -1 = background. n_attrs = 6 when
    the table was built without world-position planes. One launch of
    ``ops/raster_shade``'s kernel on a CUDA device."""
    dev = table.device
    px = (torch.arange(cols, dtype=torch.float32, device=dev) + 0.5)[None]
    py = (torch.arange(rows, dtype=torch.float32, device=dev) + 0.5)[:, None]
    return RSH.shade(table, tid.reshape(rows, cols), px, py, scene,
                     n_attrs)
