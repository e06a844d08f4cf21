"""Port parity for the depth-grouped layout build and walk (kernel B1's
plain version) against the JAX package, fed the same arrays.

The build is integer/gather code and must match exactly. The walk is
compared on the JAX build's own outputs: JAX runs its Pallas kernel in
interpret mode, where XLA fuses both products of the edge function
(C + A*x) + B*y into FMAs, and the port fuses the same two (core/fp.py),
so winners and depths are equal bit for bit (the JAX suite allows "tiny
FMA noise" between its own paths, tests/test_raster_group.py:33-35). On
the card the kernel equals this plain version exactly (chip_smoke.py)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.backends import raster as JR
from ascii_renderer_tpu.core.camera import Camera as JCam
from ascii_renderer_tpu.ops import raster_group as JRG
from ascii_renderer_tpu.ops.pack import pack_channels_split_blocked as j_pack
from ascii_renderer_tpu.ops.setup2dh import setup_2dh_fused as j_setup
from ascii_renderer_tpu_torch.ops import raster_group as RG

torch.set_num_threads(2)

ROWS, COLS = 48, 96
TILES_Y, TILES_X = 6, 1
N_TILES = TILES_Y * TILES_X


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _jax_src_keys(T=3000, seed=5, big_cap=64):
    """JAX's walk source rows and sorted pair keys for a random soup."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2, 2, (3 * T, 3)).astype(np.float32)
    nrm = rng.normal(size=(3 * T, 3)).astype(np.float32)
    col = rng.uniform(0.2, 1.0, (3 * T, 3)).astype(np.float32)
    attrs = np.concatenate([nrm, col], axis=1)
    pos9 = JR.positions_to_pos9(jnp.asarray(pos))
    attrs_t = jnp.asarray(attrs.reshape(T, 18).T)
    cam = JCam.create(pos=(2.5, 1.5, 3.0), yaw=-2.3, pitch=-0.3)
    mvp = JR.camera_mvp(cam, ROWS, COLS, 0.5)
    cm, bbox = j_setup(pos9, attrs_t, mvp, ROWS, COLS)
    src16, _table = j_pack(cm, [(0, 16), (16, 40)])
    keys = JR._subtile_pair_keys_bbox(bbox, ROWS, COLS, big_cap=big_cap)
    return np.asarray(src16), np.asarray(keys)


CAPS = {  # (r_cap, pair_cap, grp_cap)
    "generous": (32 * 512, 1 << 16, N_TILES),
    "overflow": (64, 4096, 1),
}
NAMES = ("rows128", "rowptr", "gdepth", "gskip", "xl", "yl", "gbins",
         "n_rows", "n_pairs", "n_used")


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("caps", sorted(CAPS))
def test_kgather_build_equals_jax(k, caps):
    src16, keys = _jax_src_keys()
    r_cap, pair_cap, grp_cap = CAPS[caps]
    want = JRG.build_packed_rows_grouped_kgather(
        jnp.asarray(src16), jnp.asarray(keys), TILES_X, N_TILES, r_cap,
        pair_cap, grp_cap, k)
    got = RG.build_packed_rows_grouped_kgather(
        _t(src16), _t(keys), TILES_X, N_TILES, r_cap, pair_cap, grp_cap, k)
    for nm, w, g in zip(NAMES, want, got):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, nm
        np.testing.assert_array_equal(g.numpy(), w, err_msg=nm)
    if caps == "overflow":  # the counts must report what was dropped
        assert int(got[7]) > r_cap or int(got[9]) > grp_cap * 8


def test_bin_offsets_and_depth_order_equal_jax():
    _src, keys = _jax_src_keys()
    n_bins = N_TILES * 8
    bin_s = keys >> 18
    for p_eff in (keys.shape[0], 5000, 777):
        np.testing.assert_array_equal(
            RG._bin_offsets(_t(bin_s), p_eff, n_bins).numpy(),
            np.asarray(JRG._bin_offsets(jnp.asarray(bin_s), p_eff, n_bins)))
    depth = np.random.default_rng(2).integers(0, 5, n_bins).astype(np.int32)
    for w, g in zip(JRG.depth_group_order(jnp.asarray(depth), n_bins),
                    RG.depth_group_order(_t(depth), n_bins)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("caps", sorted(CAPS))
def test_walk_ref_matches_jax_kernel(caps):
    src16, keys = _jax_src_keys()
    r_cap, pair_cap, grp_cap = CAPS[caps]
    lay = JRG.build_packed_rows_grouped_kgather(
        jnp.asarray(src16), jnp.asarray(keys), TILES_X, N_TILES, r_cap,
        pair_cap, grp_cap, 8)
    z_j, e_j = JRG.tile_eval_grouped_skip(*lay[:6], grp_cap)
    z_t, e_t = RG.tile_eval_grouped_skip(*[_t(x) for x in lay[:6]], grp_cap)
    e_j, z_j = np.asarray(e_j), np.asarray(z_j)
    e_t, z_t = e_t.numpy(), z_t.numpy()
    assert e_t.shape == (grp_cap, 8, 128) and (e_t >= 0).sum() > 100
    np.testing.assert_array_equal(e_t, e_j)
    np.testing.assert_array_equal(z_t.view(np.int32), z_j.view(np.int32))


def test_walk_exact_where_no_fma_can_act():
    """Planes with small dyadic coefficients, where fusing changes no
    rounding: the walk equals JAX's, including tie-breaking by the
    smallest id among depth ties and the skip window."""
    rng = np.random.default_rng(7)
    grp_cap, r_cap = 3, 128
    rows128 = np.zeros((r_cap, 128), np.float32)
    ent = rows128.reshape(r_cap, 8, 16)
    # edge planes w = C + A*x + B*y with A, B in {-1, 0, 1}, C in halves
    ent[:, :, 0:9] = rng.integers(-1, 2, (r_cap, 8, 9))
    ent[:, :, 2:9:3] = rng.integers(-40, 41, (r_cap, 8, 3)) * 0.5
    ent[:, :, 9:11] = 0.0
    ent[:, :, 11] = rng.integers(0, 5, (r_cap, 8)) * 0.25  # depth ties
    ent[:, :, 12] = np.arange(r_cap)[:, None] + 1000 * np.arange(8)
    rowptr = np.asarray([0, 64, 96, 96], np.int32)
    gdepth = rng.integers(0, 60, grp_cap * 8).astype(np.int32)
    gskip = rng.integers(0, 8, grp_cap * 8).astype(np.int32)
    xl = (np.tile(np.arange(16, dtype=np.float32) + 0.5, 8)[None]
          + rng.integers(0, 3, (grp_cap, 1)) * 16).astype(np.float32)
    yl = np.repeat(rng.integers(0, 3, (grp_cap, 8)) * 8.0, 16, 1).astype(
        np.float32)
    args = (rows128, rowptr, gdepth, gskip, xl, yl)
    z_j, e_j = JRG.tile_eval_grouped_skip(*[jnp.asarray(a) for a in args],
                                          grp_cap)
    z_t, e_t = RG.tile_eval_grouped_skip(*[_t(a) for a in args], grp_cap)
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    assert (e_t.numpy() >= 0).sum() > 50


@pytest.mark.parametrize("trail", [(), (3,)])
def test_assemble_group_image_equals_jax(trail):
    tiles_y, tiles_x = 3, 2
    n_tiles = tiles_y * tiles_x
    grp_cap = 5
    rng = np.random.default_rng(0)
    gbins = np.concatenate([rng.permutation(n_tiles * 8)[:36],
                            np.full(4, n_tiles * 8)]).astype(np.int32)
    vals = rng.normal(size=(grp_cap, 8, 128) + trail).astype(np.float32)
    want = JRG.assemble_group_image(jnp.asarray(vals), jnp.asarray(gbins),
                                    n_tiles, tiles_y, tiles_x, 20, 200, -7.0)
    got = RG.assemble_group_image(_t(vals), _t(gbins), n_tiles, tiles_y,
                                  tiles_x, 20, 200, -7.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_assemble_group_image_roundtrip():
    """Mirror of tests/test_raster_group.py:168-190: every bin's 8x16
    block lands at its (tile, subtile) location; uncovered bins take fill."""
    tiles_y, tiles_x = 3, 1
    n_tiles = tiles_y * tiles_x
    n_bins = n_tiles * 8
    grp_cap = 2
    rng = np.random.default_rng(0)
    gbins = rng.permutation(n_bins)[:grp_cap * 8].astype(np.int32)
    vals = rng.normal(size=(grp_cap, 8, 128)).astype(np.float32)
    img = RG.assemble_group_image(_t(vals), _t(gbins), n_tiles, tiles_y,
                                  tiles_x, 24, 128, fill=-7.0).numpy()
    expect = np.full((24, 128), -7.0, np.float32)
    for slot, b in enumerate(gbins):
        t, s = b // 8, b % 8
        ty, tx = t // tiles_x, t % tiles_x
        g, lane = slot // 8, slot % 8
        expect[ty * 8:(ty + 1) * 8,
               tx * 128 + s * 16:tx * 128 + (s + 1) * 16] = \
            vals[g, :, lane * 16:(lane + 1) * 16]
    np.testing.assert_array_equal(img, expect)
