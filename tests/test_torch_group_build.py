"""The grouped layout build (X10, ``ops/group_build``) on the CPU.

``build_rows`` on CPU tensors is its plain version, the torch chain moved
from ``ops/raster_group`` (which re-exports it): it equals the JAX
package's builds bit for bit (integers exact, float rows and pixel
origins bit for bit) on a seeded soup's JAX-made walk rows and pair keys,
K = 4 and 8 (``build_packed_rows_grouped_kgather``), K = 1
(``build_packed_rows_grouped``) and the two-entry rows of K = 2 and 4,
with generous caps, caps that overflow and a pair cap that truncates the
keys. A Python replay of the kernels (the offsets' binary search; the
layout block's ballot compaction, its order of the nonempty bins by
depth buckets and their members ahead, a thread a slot for the slots,
skips and row pointers, each used K-row's group; the gather's clamped
pair index and the layout's addresses) equals the plain version on the
same inputs for every layout X10 serves, with and without the caller's
offsets, banded, and on synthetic keys at the edges: tied depths, every
bin nonempty, one nonempty bin, sentinel slots and 8,184 bins. The
kernels are held to the plain version on the card by
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
         "n_rows", "n_pairs", "n_used", "ginv")
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
    layout bit for bit, with or without the caller's offsets, then each
    bin's place in the depth order (ginv: a permutation of the bins whose
    first 8 grp_cap places are the slots' bins)."""
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
        assert len(got) == len(want) + 1
        ginv, gbins = got[-1].numpy(), got[-5].numpy()
        n_bins = N_TILES * 8
        assert sorted(ginv) == list(range(n_bins))
        real = gbins < n_bins
        np.testing.assert_array_equal(ginv[gbins[real]],
                                      np.arange(gbins.size)[real])
        for nm, w, g in zip(_names(k, rows256), want, got):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype, nm
            if w.dtype == np.float32:
                np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                              w.view(np.uint32), err_msg=nm)
            else:
                np.testing.assert_array_equal(g.numpy(), w, err_msg=nm)
    if caps == "overflow":  # the counts must report what was dropped
        assert int(got[-4]) > r_cap or int(got[-2]) > grp_cap * 8


# --------------------------------------------------------------------------
# a replay of csrc/group_build.cu
# --------------------------------------------------------------------------
def _replay_places(d, n_chunks):
    """The order phase: each nonempty bin's place (``d``: the bins' depths,
    0 for an empty bin, padded to 32 n_chunks). A warp counts its
    contiguous chunks' bins into 1,024 depth buckets (the last for every
    depth from 1023); a bin's place is its bucket's start (the nonempty
    bins in deeper buckets), its warp's first place in the bucket (the
    bucket's bins of earlier warps) and the bucket's bins ahead of it in
    its warp. The last bucket's bins, listed so, are ranked among
    themselves: deeper, or as deep and listed before."""
    cpw = -(-n_chunks // 32)
    g = np.arange(d.shape[0])
    f = d > 0
    b = np.minimum(d, 1023)
    w = (g // 32) // cpw
    cnt = np.zeros((32, 1024), np.int64)
    np.add.at(cnt, (w[f], b[f]), 1)
    first = np.cumsum(cnt, 0) - cnt  # a warp's first place in a bucket
    hist = cnt.sum(0)
    start = np.cumsum(hist[::-1])[::-1] - hist  # deeper buckets' bins
    place = np.full(d.shape[0], -1)
    seen = np.zeros((32, 1024), np.int64)  # the bins of a bucket so far
    for q in g[f]:  # a warp's bins in bin order
        place[q] = start[b[q]] + first[w[q], b[q]] + seen[w[q], b[q]]
        seen[w[q], b[q]] += 1
    last = g[f & (b == 1023)][np.argsort(place[f & (b == 1023)])]
    dl, il = d[last], np.arange(len(last))
    for i, q in enumerate(last):
        place[q] = ((dl > d[q]) | ((dl == d[q]) & (il < i))).sum()
    return place


def replay(src, keys, tiles_x, n_tiles, r_cap, pair_cap, grp_cap, k,
           rows256, y_off=0):
    """build_rows' outputs as the kernels compute them."""
    nb = n_tiles * 8
    P = keys.shape[0]
    p_eff = min(pair_cap, P)
    lg = k.bit_length() - 1
    # group_build_offsets_kernel: a bin's first key
    off = np.array([np.searchsorted(keys, q << 18, side="left")
                    for q in range(nb + 1)])
    # group_build_layout_kernel. depths: the offsets of the first p_eff keys
    offs = np.minimum(off, p_eff)
    # compaction: a ballot a 32 bins, the counts scanned
    n_chunks = -(-nb // 32)
    n_pad = n_chunks * 32
    g = np.arange(n_pad)
    f = np.zeros(n_pad, bool)
    f[:nb] = offs[1:] > offs[:-1]
    ballots = f.reshape(n_chunks, 32)
    pre = np.r_[0, np.cumsum(ballots.sum(1))]
    before = (pre[:-1, None] + np.cumsum(ballots, 1) - ballots).reshape(-1)
    n_used = int(pre[-1])
    n_perm = min(nb, 8 * grp_cap)
    perm = np.full(nb, -1)
    emp = ~f & (g < nb)
    at = n_used + g[emp] - before[emp]
    perm[at[at < n_perm]] = g[emp][at < n_perm]
    # order: the depth buckets' places, a stable sort of the depths
    d = np.zeros(n_pad, np.int64)
    d[:nb] = offs[1:] - offs[:-1]
    place = _replay_places(d, n_chunks)
    assert sorted(place[f]) == list(range(n_used))
    perm[place[f & (place < n_perm)]] = g[f & (place < n_perm)]
    assert (perm[:n_perm] >= 0).all()
    # every bin's place, the dropped ones' too
    ginv = np.zeros(nb, np.int64)
    ginv[g[emp]] = at
    ginv[g[f]] = place[f]
    # slots: a thread a slot, the group's deepest of 8, the rows scanned
    i = np.arange(8 * grp_cap)
    b = np.where(i < nb, perm[np.minimum(i, nb - 1)], nb)
    dep = np.where(b < nb, offs[np.minimum(b, nb - 1) + 1]
                   - offs[np.minimum(b, nb - 1)], 0)
    last = nb - 1 if k == 1 else nb
    og = offs[np.minimum(b, last)]
    sk = np.where(dep > 0, og & (k - 1), 0)
    most = ((dep + sk + k - 1) >> lg).reshape(grp_cap, 8).max(1)
    dpad = ((most << lg) + 31) & ~31
    end = np.cumsum(dpad)
    offr = ((og - sk) >> lg) - (np.repeat(end - dpad, 8) >> lg)
    rowptr_u = np.r_[0, end]
    rowptr = np.minimum(rowptr_u, r_cap) >> int(rows256)
    counts = (rowptr_u[-1], off[nb], n_used)
    # each used K-row's group, a group's K-rows at a time (unwritten: -1)
    rk_cap = r_cap >> lg
    kgrp = np.full(rk_cap, -1)
    for t in range(grp_cap):
        kgrp[min(rowptr_u[t] >> lg, rk_cap):
             min(rowptr_u[t + 1] >> lg, rk_cap)] = t
    rk_end = min(rowptr_u[-1] >> lg, rk_cap)
    assert (kgrp[:rk_end] >= 0).all()
    # group_build_gather_kernel: item j (a row and slot) is the layout's
    # floats 16 j to 16 j + 15 in both layouts
    j = np.arange(r_cap * 8)
    if rows256:
        r, s = ((j >> 4) << 1) | (j & 1), (j >> 1) & 7
    else:
        r, s = j >> 3, j & 7
    q = r >> lg
    t = np.where(q < rk_end, kgrp[q], grp_cap - 1)  # past them the last
    hi = ((p_eff + k - 1) >> lg) - 1
    pidx = np.clip(offr[t * 8 + s] + q, 0, hi)
    pe = (pidx << lg) | (r & (k - 1))
    rows = np.zeros(r_cap * 128, np.float32)
    vals = np.where((pe < p_eff)[:, None],
                    src[keys[np.minimum(pe, P - 1)] & (2 ** 18 - 1), :16], 0)
    rows[16 * j[:, None] + np.arange(16)] = vals
    lane = np.arange(grp_cap * 128)
    bb = np.minimum(b[(lane >> 7) * 8 + ((lane & 127) >> 4)], nb - 1)
    tile, sub = bb // 8, bb % 8
    xl = ((tile % tiles_x) * 128 + sub * 16).astype(np.float32) + (
        (lane & 15).astype(np.float32) + np.float32(0.5))
    yl = ((tile // tiles_x) * 8).astype(np.float32) + np.float32(y_off)
    shape = (r_cap // 2, 256) if rows256 else (r_cap, 128)
    out = [rows.reshape(shape), rowptr, dep, sk, xl.reshape(grp_cap, 128),
           yl.reshape(grp_cap, 128), b, *counts, ginv]
    if k == 1 and not rows256:
        del out[3]
    return out


def _replay_equals_plain(src, keys, tiles_x, n_tiles, caps, gen):
    """The replay against build_rows on CPU tensors (the plain version),
    with and without the caller's offsets, at frame rows and a band's."""
    k, rows256 = GB.LAYOUTS[gen]
    r_cap, pair_cap, grp_cap = caps
    offsets = _t(np.searchsorted(keys, np.arange(n_tiles * 8 + 1) << 18)
                 .astype(np.int32))
    for y_off, offs in ((0, None), (16, offsets)):
        want = GB.build_rows(_t(src), _t(keys), tiles_x, n_tiles, r_cap,
                             pair_cap, grp_cap, k=k, rows256=rows256,
                             y_off=y_off, offsets=offs)
        got = replay(src, keys.astype(np.int64), tiles_x, n_tiles, r_cap,
                     pair_cap, grp_cap, k, rows256, y_off)
        assert len(got) == len(want)
        for nm, g, w in zip(_names(k, rows256), got, want):
            w = w.numpy()
            np.testing.assert_array_equal(np.asarray(g).astype(w.dtype), w,
                                          err_msg=nm)
    return got


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
    _replay_equals_plain(src32, keys, TILES_X, N_TILES,
                         (r_cap, pair_cap, grp_cap), gen)


def _synthetic(depths, seed=0, n_fill=37):
    """Sorted pair keys with the given depth a bin (distinct triangles a
    bin, ascending), then n_fill keys of bin n_bins (the keys' fill), and
    32-wide source rows for their triangles."""
    rng = np.random.default_rng(seed)
    nb = len(depths)
    n_tri = max(64, int(max(depths)) + 1)
    keys = [(b << 18) | np.sort(rng.choice(n_tri, d, replace=False))
            for b, d in enumerate(depths) if d]
    keys.append((nb << 18) | np.sort(rng.integers(0, n_tri, n_fill)))
    src = rng.normal(size=(n_tri, 32)).astype(np.float32)
    return src, np.concatenate(keys).astype(np.int32)


def _depths(case):
    """(tiles_x, n_tiles, depth a bin, (r_cap, pair_cap, grp_cap))."""
    rng = np.random.default_rng(11)
    if case == "ties":  # a few depths over many bins, zeros between
        d = rng.choice([0, 3, 3, 5, 5, 9], 40 * 8)
        return 5, 40, d, (32 * 256, 1 << 16, 40)
    if case == "flat":  # every bin of a 960x540 frame 2 deep: one bucket
        return 8, 544, np.full(544 * 8, 2), (32 * 320, 1 << 16, 60)
    if case == "deep":  # depths from 1023 on, tied: the last bucket
        d = rng.choice([0, 4, 1023, 1200, 1200, 1500], 6 * 8)
        return 3, 6, d, (32 * 256, 1 << 16, 6)
    if case == "all_nonempty":
        return 3, 12, rng.integers(1, 40, 96), (32 * 64, 1 << 16, 12)
    if case == "one_bin":
        d = np.zeros(25 * 8, np.int64)
        d[117] = 50
        return 5, 25, d, (32 * 8, 1 << 16, 3)
    if case == "sentinels":  # more group slots than bins
        return 2, 4, rng.integers(0, 12, 32), (32 * 32, 1 << 16, 10)
    # near n_bins' limit of 8,191: 1,023 tiles, a third of the bins used
    d = np.where(rng.random(1023 * 8) < 0.35, rng.integers(1, 9, 1023 * 8),
                 0)
    return 31, 1023, d, (32 * 512, 1 << 16, 400)


@pytest.mark.parametrize("gen", sorted(GB.LAYOUTS))
@pytest.mark.parametrize("case", ["ties", "flat", "deep", "all_nonempty",
                                  "one_bin", "sentinels", "max_bins"])
def test_kernel_replay_equals_plain_at_edges(gen, case):
    """The replay equals the plain version where the order and the slots
    have their edge cases: depths tied across many bins, every bin of a
    960x540 frame equally deep (one depth bucket), depths from 1023 on
    (the last bucket, ranked by compares) with ties, every bin nonempty, a
    single nonempty bin, more group slots than bins (sentinel slots) and
    8,184 bins (the order's shared memory at its largest)."""
    tiles_x, n_tiles, depths, caps = _depths(case)
    src, keys = _synthetic(depths)
    got = _replay_equals_plain(src, keys, tiles_x, n_tiles, caps, gen)
    n_used = int((np.asarray(depths) > 0).sum())
    assert int(got[-2]) == n_used
    if case == "sentinels":
        assert (np.asarray(got[-5]) == n_tiles * 8).any()


@pytest.mark.parametrize("gen", sorted(GB.LAYOUTS))
def test_layout_buffers_are_two_disjoint_allocations(gen):
    """The kernel path's outputs are views of one int32 and one float32
    buffer of the kernels' shapes, none overlapping, each float view
    16-byte aligned (the gather's float4 stores), ws as long as the
    kernels' own ints."""
    k, rows256 = GB.LAYOUTS[gen]
    n_bins, r_cap, grp_cap = 4352, 10240, 60
    outs, ws = GB.layout_buffers(n_bins, r_cap, grp_cap, k, rows256, "cpu")
    rows, rowptr, gdepth, gskip, xl, yl, gbins, counts, ginv = outs
    assert rows.shape == ((r_cap // 2, 256) if rows256 else (r_cap, 128))
    assert ginv.shape == (n_bins,)
    assert rowptr.shape == (grp_cap + 1,) and counts.shape == (3,)
    assert gdepth.shape == gskip.shape == gbins.shape == (8 * grp_cap,)
    assert xl.shape == yl.shape == (grp_cap, 128)
    assert ws.shape == (n_bins + 1 + 9 * grp_cap + 1 + r_cap // k,)
    spans = []
    for t in (*outs, ws):
        assert t.is_contiguous()
        start = t.data_ptr()
        spans.append((start, start + t.numel() * t.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert len({t.untyped_storage().data_ptr() for t in (*outs, ws)}) == 2
    assert all(t.data_ptr() % 16 == 0 for t in (rows, xl, yl))


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
