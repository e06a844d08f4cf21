"""Port parity for the exact-bin walks B6 (``tile_eval_bins_mm``) and B6'
(``tile_eval_bins``): the plain-torch versions against JAX's Pallas kernels
run in interpret mode under ``jax.jit`` (as the JAX suite runs them on the
CPU), z bit for bit and the winner ids exactly.

The inputs are random plane entries over a 3 x 2 tile grid: bins that are
empty, that cross the 128- and 256-entry chunk boundaries, huge edge
coefficients (near-clip triangles reach 1e10), depth planes repeated for
ties (inside a chunk and across a chunk boundary) and, for B6', entries
whose valid flag is 0. The CUDA kernel is held against the plain version
on the card by ``tests/test_torch_build.py`` (marked ``cuda``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.ops import raster_bins as JRB
from ascii_renderer_tpu_torch.ops import raster_bins as RB

torch.set_num_threads(2)

TILES_X, TILES_Y = 3, 2
N_TILES = TILES_X * TILES_Y
SIZES = (0, 300, 129, 1, 256, 57)  # tile 0 empty; 300 spans 3 chunks


def make_entries(seed, sizes=SIZES, invalid_frac=0.0, edge_frac=0.0):
    """Row-major plane entries [P, 16] binned by tile, and the offsets.
    With probability ``edge_frac`` an entry's first two edges run exactly
    through a column and a row of pixel centres (w = 0 there) and its
    depth is exactly 0 or 1: the inclusive tests decide those pixels."""
    rng = np.random.default_rng(seed)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    ent = np.zeros((int(offs[-1]), 16), np.float32)
    for t in range(len(sizes)):
        ty, tx = divmod(t, TILES_X)
        ids = np.sort(rng.choice(100000, sizes[t], replace=False))
        for n, j in enumerate(range(offs[t], offs[t + 1])):
            cx = rng.uniform(tx * 128 - 20, tx * 128 + 148)
            cy = rng.uniform(ty * 8 - 2, ty * 8 + 10)
            for k in range(3):
                ang = rng.uniform(0, 2 * np.pi)
                a = np.cos(ang) * rng.uniform(0.05, 40)
                b = np.sin(ang) * rng.uniform(0.05, 40)
                if rng.random() < 0.15:  # near-clip: huge coefficients
                    a, b = a * 3e8, b * 3e8
                g = -(a * (cx + rng.uniform(-40, 40))
                      + b * (cy + rng.uniform(-6, 6)))
                ent[j, 3 * k:3 * k + 3] = (a, b, g)
            zx, zy = rng.normal() * 2e-3, rng.normal() * 2e-2
            ent[j, 9:12] = (zx, zy, rng.uniform(-0.1, 1.1) - zx * cx - zy * cy)
            if rng.random() < edge_frac:
                for k in range(2):  # x = c, then y = c, through centres
                    a = rng.choice([-1.0, 1.0]) * 2.0 ** rng.integers(-2, 3)
                    c = np.floor(cx if k == 0 else cy) + 0.5
                    ent[j, 3 * k:3 * k + 3] = ((a, 0.0, -a * c) if k == 0
                                               else (0.0, a, -a * c))
                ent[j, 9:12] = (0.0, 0.0, float(rng.integers(0, 2)))
            ent[j, 12] = 0.0 if rng.random() < invalid_frac else 1.0
            ent[j, 13] = ids[n]
            if n and rng.random() < 0.3:  # a depth tie with the previous
                ent[j, 9:12] = ent[j - 1, 9:12]
    # a tie across the chunk boundary at entry 128 (bin of tile 1)
    ent[offs[1] + 128, 9:12] = ent[offs[1] + 127, 9:12]
    return ent, offs


def mm_layout(ent):
    """Channel-major 128-entry chunks with the inert tail of
    visibility_binned_ch (raster_channels.py:682-695)."""
    tail = 2 * 128
    pad = (-(ent.shape[0] + tail)) % 128 + tail
    data = np.concatenate([ent, np.zeros((pad, 16), np.float32)])
    return np.ascontiguousarray(data.reshape(-1, 128, 16).transpose(0, 2, 1))


def loop_layout(ent):
    tail = JRB.CHUNK + 8 * JRB.PACK
    pad = (-(ent.shape[0] + tail)) % JRB.PACK + tail
    return np.concatenate([ent, np.zeros((pad, 16), np.float32)])


def assert_same(got, want):
    (z, t), (jz, jt) = got, want
    z, t = z.numpy(), t.numpy()
    jz, jt = np.asarray(jz), np.asarray(jt)
    assert z.shape == jz.shape == (N_TILES, 8, 128)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(z.view(np.uint32), jz.view(np.uint32))
    return int((t >= 0).sum())


@pytest.mark.parametrize("seed,edge_frac", [(0, 0.0), (1, 0.0), (2, 0.0),
                                            (4, 0.4)])
def test_mm_walk_plain_equals_jax(seed, edge_frac):
    ent, offs = make_entries(seed, edge_frac=edge_frac)
    mm = mm_layout(ent)
    f = jax.jit(lambda d, o: JRB.tile_eval_bins_mm(d, o, TILES_X, N_TILES,
                                                   interpret=True))
    want = f(jnp.asarray(mm), jnp.asarray(offs))
    got = RB.tile_eval_bins_mm(torch.from_numpy(mm), torch.from_numpy(offs),
                               TILES_X, N_TILES)
    hits = assert_same(got, want)
    assert hits > 1000
    assert (got[1][0] == -1).all()  # the empty bin


@pytest.mark.parametrize("seed,edge_frac", [(0, 0.0), (3, 0.0), (5, 0.4)])
def test_loop_walk_plain_equals_jax(seed, edge_frac):
    ent, offs = make_entries(seed, invalid_frac=0.2, edge_frac=edge_frac)
    data = loop_layout(ent)
    f = jax.jit(lambda d, o: JRB.tile_eval_bins(JRB.pack_entries(d), o,
                                                TILES_X, N_TILES,
                                                interpret=True))
    want = f(jnp.asarray(data), jnp.asarray(offs))
    packed = RB.pack_entries(torch.from_numpy(data))
    assert tuple(packed.shape) == (data.shape[0] // 8, 128)
    got = RB.tile_eval_bins(packed, torch.from_numpy(offs), TILES_X, N_TILES)
    assert assert_same(got, want) > 1000


def test_the_two_walks_round_their_planes_differently():
    """B6's dot and B6''s loop contract the plane sums in different
    orders, so z differs in the last bit on some pixels (the winners here
    do not); each plain version follows its own kernel."""
    ent, offs = make_entries(4)
    z_mm, t_mm = RB.tile_eval_bins_mm(torch.from_numpy(mm_layout(ent)),
                                      torch.from_numpy(offs), TILES_X,
                                      N_TILES)
    z_lp, t_lp = RB.tile_eval_bins(
        RB.pack_entries(torch.from_numpy(loop_layout(ent))),
        torch.from_numpy(offs), TILES_X, N_TILES)
    hit = (t_mm >= 0) & (t_lp >= 0)
    assert int(hit.sum()) > 1000
    assert int((z_mm[hit] != z_lp[hit]).sum()) > 0
    assert torch.allclose(z_mm[hit], z_lp[hit], rtol=1e-5, atol=1e-6)


def test_walk_wrappers_reject_bad_inputs():
    ent, offs = make_entries(5)
    mm = torch.from_numpy(mm_layout(ent))
    with pytest.raises(ValueError):
        RB.tile_eval_bins_mm(mm, torch.from_numpy(offs).long(), TILES_X,
                             N_TILES)
    with pytest.raises(ValueError):
        RB.tile_eval_bins_mm(mm.reshape(-1, 16), torch.from_numpy(offs),
                             TILES_X, N_TILES)
    with pytest.raises(ValueError):
        RB.pack_entries(torch.zeros((12, 16)))
    with pytest.raises(ValueError):  # B8 takes [P/2, 128] rows
        RB.tile_eval_bins_shaded(mm, torch.from_numpy(offs),
                                 torch.zeros(64), TILES_X, N_TILES)
    with pytest.raises(ValueError):  # and a light vector of 64 floats
        RB.tile_eval_bins_shaded(mm.reshape(-1, 128), torch.from_numpy(offs),
                                 torch.zeros(10), TILES_X, N_TILES)
    meta = torch.device("meta")
    with pytest.raises(ValueError):  # not a CUDA tensor: no fallback
        RB.tile_eval_bins_mm(torch.empty((4, 16, 128), device=meta),
                             torch.zeros(N_TILES + 1, dtype=torch.int32,
                                         device=meta), TILES_X, N_TILES)
