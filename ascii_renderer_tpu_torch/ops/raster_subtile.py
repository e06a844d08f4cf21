"""Subtile bin geometry and the 16-channel walk-entry layout shared by the
setup, pack and grouped-walk stages (constants of
``ascii_renderer_tpu/ops/raster_subtile.py``).

A screen tile is TILE_H x TILE_W pixels and splits into N_SUB column
subtiles ("bins") of SUB_W pixels. Pair sort keys are
``bin << SUB_SHIFT | tri``. A walk entry row holds, per triangle:
    CH_A/CH_B/CH_G  x, y and constant coefficients of the 3 edge planes
                    (inside <=> every plane <= 0)
    CH_ZX/ZY/ZC     the screen-depth plane
    CH_PAIR         the triangle id as f32 (exact below 2^24)
    13..15          zero padding
"""

TILE_H, TILE_W = 8, 128
SUB_W = 16          # subtile width in px; 8 subtiles per tile
N_SUB = TILE_W // SUB_W
N_CHAN = 16
SUB_SHIFT = 18      # sort key: (tile*8 + subtile) << 18 | tri
MAX_TRI = 1 << SUB_SHIFT

CH_A = (0, 3, 6)
CH_B = (1, 4, 7)
CH_G = (2, 5, 8)
CH_ZX, CH_ZY, CH_ZC = 9, 10, 11
CH_PAIR = 12
