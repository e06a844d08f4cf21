"""The grouped layout build (X10, ``ops/group_build``) on the CPU.

``build_rows`` on CPU tensors is its plain version, the torch chain moved
from ``ops/raster_group`` (which re-exports it): it equals the JAX
package's builds bit for bit (integers exact, float rows and pixel
origins bit for bit) on a seeded soup's JAX-made walk rows and pair keys,
K = 4 and 8 (``build_packed_rows_grouped_kgather``), K = 1
(``build_packed_rows_grouped``) and the two-entry rows of K = 2 and 4,
with generous caps, caps that overflow and a pair cap that truncates the
keys. A Python replay of the kernels (the offsets' binary search; the
one block's depth order, the nonempty bins first, its slots,
skips and row pointers; the gather's row search, clamped pair index and
the layout's addresses) equals the plain version on the same inputs for
every layout X10 serves, with and without the caller's offsets, banded.
The kernels are held to the plain version on the card by
``tests/test_torch_build_xla.py`` (marked ``cuda``)."""

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
from ascii_renderer_tpu_torch.ops import bin_entries as BE
from ascii_renderer_tpu_torch.ops import group_build as GB
from ascii_renderer_tpu_torch.ops import raster_group as RG

torch.set_num_threads(2)

ROWS, COLS = 48, 96
TILES_Y, TILES_X = 6, 1
N_TILES = TILES_Y * TILES_X


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _jax_src_keys(T=3000, seed=7, big_cap=64):
    """JAX's walk source rows, bbox and sorted pair keys for a random
    soup."""
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
    "truncated": (32 * 64, 1500, 3),
    "sentinels": (32 * 256, 1 << 16, 2 * N_TILES),
}
NAMES = ("rows", "rowptr", "gdepth", "gskip", "xl", "yl", "gbins",
         "n_rows", "n_pairs", "n_used")
JAX_BUILDS = {  # (K, rows256) -> the JAX package's build
    (1, False): JRG.build_packed_rows_grouped,
    (2, True): JRG.build_packed_rows_grouped_k2,
    (4, True): JRG.build_packed_rows_grouped_k4,
    (4, False): functools.partial(JRG.build_packed_rows_grouped_kgather,
                                  k=4),
    (8, False): functools.partial(JRG.build_packed_rows_grouped_kgather,
                                  k=8),
}


def _names(k, rows256):
    return [n for n in NAMES if n != "gskip" or k > 1 or rows256]


def _offsets(keys):
    return _t(np.searchsorted(keys, np.arange(N_TILES * 8 + 1) << 18)
              .astype(np.int32))


@pytest.mark.parametrize("gen", sorted(GB.LAYOUTS))
@pytest.mark.parametrize("caps", sorted(CAPS))
def test_build_rows_plain_equals_jax(gen, caps):
    """X10's plain version gives the JAX package's build of the same
    layout bit for bit, with or without the caller's offsets."""
    k, rows256 = GB.LAYOUTS[gen]
    src16, keys = _jax_src_keys()
    r_cap, pair_cap, grp_cap = CAPS[caps]
    if rows256 and caps == "overflow":
        r_cap = 128  # the two-entry rows' r_cap/2 stays a CHUNK_RG/2 multiple
    want = JAX_BUILDS[(k, rows256)](
        jnp.asarray(src16), jnp.asarray(keys), TILES_X, N_TILES, r_cap,
        pair_cap, grp_cap)
    for offsets in (None, _offsets(keys)):
        got = GB.build_rows(_t(src16), _t(keys), TILES_X, N_TILES, r_cap,
                            pair_cap, grp_cap, k=k, rows256=rows256,
                            offsets=offsets)
        assert len(got) == len(want)
        for nm, w, g in zip(_names(k, rows256), want, got):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype, nm
            if w.dtype == np.float32:
                np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                              w.view(np.uint32), err_msg=nm)
            else:
                np.testing.assert_array_equal(g.numpy(), w, err_msg=nm)
    if caps == "overflow":  # the counts must report what was dropped
        assert int(got[-3]) > r_cap or int(got[-1]) > grp_cap * 8


# --------------------------------------------------------------------------
# a replay of csrc/group_build.cu
# --------------------------------------------------------------------------
def replay(src, keys, tiles_x, n_tiles, r_cap, pair_cap, grp_cap, k,
           rows256, y_off=0):
    """build_rows' outputs as the kernels compute them."""
    nb = n_tiles * 8
    P = keys.shape[0]
    p_eff = min(pair_cap, P)
    # group_build_offsets_kernel: a bin's first key
    off = np.array([np.searchsorted(keys, q << 18, side="left")
                    for q in range(nb + 1)])
    d = np.minimum(off[1:], p_eff) - np.minimum(off[:-1], p_eff)
    # group_build_layout_kernel: the nonempty bins compacted in bin order
    # and sorted (a nonempty bin's place: those deeper, or as deep with a
    # smaller id); an empty bin's is after them all, in bin order
    ids = np.arange(nb)
    nz = ids[d > 0]
    before = np.where(
        d > 0,
        ((d[nz][None, :] > d[:, None])
         | ((d[nz][None, :] == d[:, None]) & (nz[None, :] < ids[:, None]))
         ).sum(1),
        len(nz) + ids - np.searchsorted(nz, ids))
    perm = np.empty(nb, np.int64)
    perm[before] = ids
    i = np.arange(grp_cap * 8)
    b = np.where(i < nb, perm[np.minimum(i, nb - 1)], nb)
    dep = np.where(b < nb, d[np.minimum(b, nb - 1)], 0)
    last = nb - 1 if k == 1 else nb
    og = np.minimum(off[np.minimum(b, last)], p_eff)
    sk = np.where(dep > 0, og % k, 0)
    offk = (og - sk) // k
    rbk = (dep + sk + k - 1) // k
    dpad = -(-rbk.reshape(grp_cap, 8).max(1) * k // 32) * 32
    rowptr_u = np.r_[0, np.cumsum(dpad)]
    rowptr = np.minimum(rowptr_u, r_cap) >> int(rows256)
    counts = (rowptr_u[-1], off[nb], int((d > 0).sum()))
    # group_build_gather_kernel
    j = np.arange(r_cap * 8)
    if rows256:
        r2, s = j >> 4, (j >> 1) & 7
        r = 2 * r2 + (j & 1)
        at = r2 * 256 + s * 32 + (j & 1) * 16
    else:
        r, s = j >> 3, j & 7
        at = r * 128 + s * 16
    q = r // k
    t = np.minimum(np.searchsorted(rowptr_u[1:] // k, q, side="right"),
                   grp_cap - 1)
    pek = -(-p_eff // k) * k
    pidx = np.clip(offk[t * 8 + s] + q - rowptr_u[t] // k, 0, pek // k - 1)
    pe = pidx * k + r % k
    rows = np.zeros(r_cap * 128, np.float32)
    vals = np.where((pe < p_eff)[:, None],
                    src[keys[np.minimum(pe, P - 1)] & (2 ** 18 - 1), :16], 0)
    rows[at[:, None] + np.arange(16)] = vals
    lane = np.arange(grp_cap * 128)
    bb = np.minimum(b[(lane >> 7) * 8 + ((lane & 127) >> 4)], nb - 1)
    tile, sub = bb // 8, bb % 8
    xl = ((tile % tiles_x) * 128 + sub * 16).astype(np.float32) + (
        (lane & 15).astype(np.float32) + np.float32(0.5))
    yl = ((tile // tiles_x) * 8).astype(np.float32) + np.float32(y_off)
    shape = (r_cap // 2, 256) if rows256 else (r_cap, 128)
    out = [rows.reshape(shape), rowptr, dep, sk, xl.reshape(grp_cap, 128),
           yl.reshape(grp_cap, 128), b, *counts]
    if k == 1 and not rows256:
        del out[3]
    return out


@pytest.mark.parametrize("gen", sorted(GB.LAYOUTS))
@pytest.mark.parametrize("caps", sorted(CAPS))
def test_kernel_replay_equals_plain(gen, caps):
    """The replay of X10's kernels gives the plain version's layout bit
    for bit, a band's shifted pixel rows included, over 32-wide source
    rows (the B7 pack's stride)."""
    k, rows256 = GB.LAYOUTS[gen]
    src16, keys = _jax_src_keys()
    src32 = np.concatenate([src16, np.ones_like(src16)], 1)
    r_cap, pair_cap, grp_cap = CAPS[caps]
    if rows256 and caps == "overflow":
        r_cap = 128
    for y_off in (0, 16):
        want = GB.build_rows(_t(src32), _t(keys), TILES_X, N_TILES, r_cap,
                             pair_cap, grp_cap, k=k, rows256=rows256,
                             y_off=y_off)
        got = replay(src32, keys.astype(np.int64), TILES_X, N_TILES, r_cap,
                     pair_cap, grp_cap, k, rows256, y_off)
        for nm, g, w in zip(_names(k, rows256), got, want):
            w = w.numpy()
            np.testing.assert_array_equal(np.asarray(g).astype(w.dtype), w,
                                          err_msg=nm)


def test_x10_serves_the_generations_and_cpu_launches_nothing():
    """The generations X10 serves build through ``build_rows`` (subtile4
    keeps its torch chain); on CPU tensors it launches nothing and takes
    X9's offsets; a layout it lacks raises; raster_group re-exports the
    moved builds."""
    seen = []

    def spy(*a, **kw):
        seen.append((kw["k"], kw["rows256"]))
        return "layout"

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(GB, "build_rows", spy)
        for gen in GB.LAYOUTS:
            assert RG.GENERATIONS[gen].build(None, None, 1, 1, 32, 1,
                                             1) == "layout"
    assert seen == [GB.LAYOUTS[gen] for gen in GB.LAYOUTS]
    for name in ("build_packed_rows_grouped_kgather", "_slot_gather",
                 "_group_bins", "depth_group_order", "_bin_offsets",
                 "build_groups_direct", "CHUNK_RG"):
        assert getattr(RG, name) is getattr(GB, name)
    src16, keys = _jax_src_keys()
    n0 = GB.launches
    cap = RG.GENERATIONS["subtile8"].build(_t(src16), _t(keys), TILES_X,
                                           N_TILES, 32 * 64, 1 << 16,
                                           N_TILES, offsets=_offsets(keys),
                                           y_off=8)
    assert GB.launches == n0
    assert float(cap[5].min()) >= 8.0
    with pytest.raises(ValueError):
        GB.build_rows(_t(src16), _t(keys), TILES_X, N_TILES, 64, 4096, 1,
                      k=2)
    # X9's plain offsets are the ones X10 reads
    bb = {nm: torch.zeros(4) for nm in ("bx0", "bx1", "by0", "by1")}
    bb["bx1"] += 40.0
    bb["by1"] += 12.0
    bb["valid"] = torch.tensor([True, False, True, True])
    keys4, offs4, _c = BE.pair_keys_bbox(bb, ROWS, COLS, big_cap=0)
    np.testing.assert_array_equal(offs4.numpy(), _offsets(keys4.numpy()))
