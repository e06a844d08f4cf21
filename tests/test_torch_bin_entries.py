"""The small and mid raster paths' bin entries (X9, ``ops/bin_entries``) on
the CPU.

The plain chain (``tile_pairs``, ``plane_entries``, the gather; moved from
``backends/raster_channels``, which re-exports it) gives the same depth
and winner ids as JAX's ``visibility_binned_ch`` under ``jax.jit`` (its
walk in interpret mode) on seeded screen-channel soups: both walk layouts,
more big triangles than the cap, off-screen, degenerate, huge and NaN
triangles, no valid slot, a grid one tile wide and the 544-tile grid of the
mid-scale HD arm. A Python replay of the kernels' algorithm (the
triangles' pass, the sequence pass's rank by a scan of the mask words and
its key order, the counting sort's histograms, scan and stable ranks, the
scatter's addressing and the offsets) equals the chain's entries and
offsets bit for bit on the same soups. CPU tensors launch nothing. The
kernels themselves are held to the chain on the card by
``tests/test_torch_build_xla.py`` (marked ``cuda``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.backends import raster as JR
from ascii_renderer_tpu.backends import raster_channels as JRC
from ascii_renderer_tpu_torch.backends import raster as R
from ascii_renderer_tpu_torch.backends import raster_channels as RC
from ascii_renderer_tpu_torch.core.fp import fma32_f64
from ascii_renderer_tpu_torch.ops import bin_entries as BE
from ascii_renderer_tpu_torch.ops import raster_bins as RB
from ascii_renderer_tpu_torch.tools.xla_inputs import (BIN_SOUPS, bbox_soup,
                                                       bin_soup)

torch.set_num_threads(2)

KERNELS = ("mm", "loop")


def _bits(a) -> np.ndarray:
    """uint32 view, -0.0 folded into +0.0 and NaNs made equal (the
    reference's walk output)."""
    a = np.asarray(a, np.float32) + np.float32(0)
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.uint32)


def _same_bits(got, want) -> None:
    """Bit for bit, NaN in the same places (payloads aside)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))


def _torch_ch(ch):
    return {k: torch.from_numpy(v) for k, v in ch.items()}


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("name", list(BIN_SOUPS))
def test_plain_chain_equals_jax(name, kernel):
    """visibility_binned_ch through the moved chain and the plain walk
    gives JAX's compiled zbuf and ids."""
    ch, rows, cols = bin_soup(name)
    jz, jt = jax.jit(lambda c: JRC.visibility_binned_ch(
        dict(c), rows, cols, kernel=kernel))(
        {k: jnp.asarray(v) for k, v in ch.items()})
    tz, tt = RC.visibility_binned_ch(_torch_ch(ch), rows, cols,
                                     kernel=kernel)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(_bits(tz.numpy()), _bits(jz))
    lit = int((tt >= 0).sum())
    assert (lit == 0) == (name == "all_invalid"), lit


# --------------------------------------------------------------------------
# a replay of csrc/bin_entries.cu
# --------------------------------------------------------------------------
BLOCK_A = 128  # triangles a block of the triangles' pass (4 mask words)


def _wrap(v):
    """int64 -> int32 as the kernel's unsigned sums wrap."""
    return ((np.asarray(v, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(
        np.int64)


def _tile_of(x, d):
    """floor of a true division, clamped (NaN kept), converted; the card
    converts NaN to 0."""
    f = np.floor(x / np.float32(d))
    f = np.where(np.isnan(f), f, np.clip(f, -2147483648.0, 2147483520.0))
    return np.where(np.isnan(f), 0, f).astype(np.int64)


def _nmin(a, b):
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b,
                                             np.fmin(a, b)))


def _nmax(a, b):
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b,
                                             np.fmax(a, b)))


def _fma(a, b, c):
    return fma32_f64(torch.from_numpy(np.asarray(a, np.float32)),
                     torch.from_numpy(np.asarray(b, np.float32)),
                     torch.from_numpy(np.asarray(c, np.float32))).numpy()


def _mask_words(big):
    T = big.shape[0]
    bits = np.zeros(-(-T // 32) * 32, bool)
    bits[:T] = big
    return np.packbits(bits.reshape(-1, 32)[:, ::-1], axis=1).view(
        ">u4")[:, 0].astype(np.uint64)


def _tris_pass(ch, rows, cols, tw):
    """bin_tris_kernel, tile keys: tiles [T, tw^2], span [T, 4], mask
    words, src rows [T + 1, 16], the flags."""
    x = [ch[f"sx{v}"] for v in "abc"]
    y = [ch[f"sy{v}"] for v in "abc"]
    z = [ch[f"sz{v}"] for v in "abc"]
    valid = ch["valid"]
    T = valid.shape[0]
    tiles_y, tiles_x = -(-rows // 8), -(-cols // 128)
    n_tiles = tiles_x * tiles_y
    xmin, xmax = _nmin(_nmin(x[0], x[1]), x[2]), _nmax(_nmax(x[0], x[1]),
                                                       x[2])
    ymin, ymax = _nmin(_nmin(y[0], y[1]), y[2]), _nmax(_nmax(y[0], y[1]),
                                                       y[2])
    tx0, tx1 = _tile_of(xmin, 128), _tile_of(xmax, 128)
    ty0, ty1 = _tile_of(ymin, 8), _tile_of(ymax, 8)
    onscreen = (xmax > 0) & (xmin < cols) & (ymax > 0) & (ymin < rows)
    fits = (_wrap(tx1 - tx0) < tw) & (_wrap(ty1 - ty0) < tw)
    small, big = valid & onscreen & fits, valid & onscreen & ~fits
    tiles = np.empty((T, tw * tw), np.int64)
    for k in range(tw * tw):
        ty, tx = _wrap(ty0 + k // tw), _wrap(tx0 + k % tw)
        ok = (small & (ty >= 0) & (ty < tiles_y) & (tx >= 0)
              & (tx < tiles_x) & (ty <= ty1) & (tx <= tx1))
        tiles[:, k] = np.where(ok, ty * tiles_x + tx, n_tiles)
    a, b, g = [], [], []
    for k in range(3):
        x1, y1 = x[(k + 1) % 3], y[(k + 1) % 3]
        x2, y2 = x[(k + 2) % 3], y[(k + 2) % 3]
        a.append(-(y2 - y1))
        b.append(x2 - x1)
        g.append(_fma(y2 - y1, x1, -((x2 - x1) * y1)))
    area = _fma(x[1] - x[0], y[2] - y[0], -((y[1] - y[0]) * (x[2] - x[0])))
    inv = np.float32(1) / np.where(np.abs(area) < np.float32(1e-12),
                                   np.float32(1e-12), area)
    src = np.zeros((T + 1, 16), np.float32)
    for k in range(3):
        src[:T, 3 * k:3 * k + 3] = np.stack([a[k], b[k], g[k]], -1)
    src[:T, 9] = _fma(a[2], z[2], _fma(a[1], z[1], a[0] * z[0])) * inv
    src[:T, 10] = _fma(b[2], z[2], _fma(b[0], z[0], b[1] * z[1])) * inv
    src[:T, 11] = _fma(g[2], z[2], _fma(g[0], z[0], g[1] * z[1])) * inv
    src[:T, 12] = 1.0
    src[:T, 13] = np.arange(T)
    span = np.stack([tx0, tx1, ty0, ty1], -1)
    return dict(tiles=tiles, span=span, mask=_mask_words(big), src=src,
                nb=n_tiles, gx=tiles_x, ty_off=0, shift=19,
                flags=(small, big, valid))


def _bin_pass(bb, rows, cols, ty_lo=0, band=None):
    """bin_tris_kernel, bin keys: the bins of the 2 x 2 window [T, 4], the
    clamped span [T, 4], mask words, the flags."""
    xmin, xmax, ymin, ymax = (bb[k] for k in ("bx0", "bx1", "by0", "by1"))
    valid = bb["valid"]
    tiles_y, tiles_x = -(-rows // 8), -(-cols // 128)
    sx_n = tiles_x * 8
    ty_eff = tiles_y if band is None else band
    nb = ty_eff * sx_n
    sc0, sc1 = _tile_of(xmin, 16), _tile_of(xmax, 16)
    ty0, ty1 = _tile_of(ymin, 8), _tile_of(ymax, 8)
    lo_px, hi_px = (0, rows) if band is None else (
        ty_lo * 8, min((ty_lo + band) * 8, rows))
    on = (xmax > 0) & (xmin < cols) & (ymax > lo_px) & (ymin < hi_px)
    fits = (_wrap(sc1 - sc0) < 2) & (_wrap(ty1 - ty0) < 2)
    small, big = valid & on & fits, valid & on & ~fits
    tiles = np.empty((valid.shape[0], 4), np.int64)
    for k in range(4):
        ty, sc = _wrap(ty0 + k // 2), _wrap(sc0 + k % 2)
        tyl = _wrap(ty - ty_lo)
        ok = (small & (tyl >= 0) & (tyl < ty_eff) & (sc >= 0) & (sc < sx_n)
              & (ty <= ty1) & (sc <= sc1))
        tiles[:, k] = np.where(ok, tyl * sx_n + sc, nb)
    span = np.stack([np.clip(sc0, 0, sx_n - 1), np.clip(sc1, 0, sx_n - 1),
                     np.clip(ty0, 0, tiles_y - 1),
                     np.clip(ty1, 0, tiles_y - 1)], -1)
    return dict(tiles=tiles, span=span, mask=_mask_words(big), nb=nb,
                gx=sx_n, ty_off=ty_lo, shift=18, flags=(small, big, valid))


def _rank(mask, big_cap, T):
    """The last block's ranks (rank_big): an exclusive scan of the blocks'
    big counts (a block of BLOCK_A triangles is 4 mask words), then each
    block with ranks left takes its words' big triangles in id order; the
    ranked ids in order and the count of all big triangles."""
    words = [int(w) for w in mask]
    per = BLOCK_A // 32
    n_blk = -(-(T + 1) // BLOCK_A)
    counts = [sum(bin(w).count("1") for w in words[j * per:(j + 1) * per])
              for j in range(n_blk)]
    excl = np.cumsum([0] + counts)
    big_idx = np.full(big_cap, -1, np.int64)
    for j in range(n_blk):
        r = int(excl[j])
        for q in range(per):
            wd = j * per + q
            if not counts[j] or r >= big_cap or wd >= len(words):
                break
            w = words[wd]
            while w and r < big_cap:
                big_idx[r] = wd * 32 + (w & -w).bit_length() - 1
                w &= w - 1
                r += 1
    n = min(int(excl[-1]), big_cap)
    assert (big_idx[:n] >= 0).all()
    return big_idx[:n], int(excl[-1])


def _sequence(tp, big_idx, T, big_cap):
    """key_at over every position: a position finds its big segment (seg
    = S (bi + 1) + nb b) by the count of those complete before it, else its
    small key or a fill rank's."""
    tiles, span, nb, gx = tp["tiles"], tp["span"], tp["nb"], tp["gx"]
    shift = tp["shift"]
    S = tiles.shape[1]
    P = S * T + big_cap * nb
    p = np.arange(P)
    nr = big_idx.shape[0]
    seg = S * (big_idx + 1) + nb * np.arange(nr)
    j = np.searchsorted(seg + nb, p, side="right")
    jc = np.minimum(j, max(nr - 1, 0))
    in_big = (j < nr) & (seg[jc] <= p) if nr else np.zeros(P, bool)
    q = p - nb * j
    small = ~in_big & (q < S * T)
    key = np.full(P, (nb << shift) | (T - 1), np.int64)
    qs = q[small]
    key[small] = (tiles.reshape(-1)[qs] << shift) | (qs // S)
    if nr:
        bi = big_idx[jc[in_big]]
        b = p[in_big] - seg[jc[in_big]]
        s = span[bi]
        gy, gxx = b // gx + tp["ty_off"], b % gx
        hit = ((gxx >= s[:, 0]) & (gxx <= s[:, 1]) & (gy >= s[:, 2])
               & (gy <= s[:, 3]))
        key[in_big] = (np.where(hit, b, nb) << shift) | bi
    return key


def _stable_rank(group, bins):
    """Each key's count of earlier keys of the same (group, bin)."""
    n = group.shape[0]
    order = np.lexsort((np.arange(n), bins, group))
    g, b = group[order], bins[order]
    start = np.r_[True, (g[1:] != g[:-1]) | (b[1:] != b[:-1])]
    idx = np.arange(n)
    rank = np.empty(n, np.int64)
    rank[order] = idx - np.maximum.accumulate(np.where(start, idx, 0))
    return rank


def _counting_sort(seq, nb, shift, form):
    """The sort of a form: a chunk's keys (32 W J) split over its W warps,
    each a contiguous span of J steps of 32 keys; a key's rank in
    its warp (the match and the warp's bin counts), the warps'
    exclusive prefix per bin, the chunk's histogram, the columns'
    exclusive scan and the bins' offsets. Returns (places, offsets)."""
    P = seq.shape[0]
    bins = seq >> shift
    w, j = BE.FORMS[form]
    span, chunk = 32 * j, 32 * w * j
    p = np.arange(P)
    c, warp = p // chunk, p // span
    r_warp = _stable_rank(warp, bins)
    n_chunks, n_warps = int(c[-1]) + 1, chunk // span
    cnt = np.zeros((n_chunks, n_warps, nb + 1), np.int64)
    np.add.at(cnt, (c, warp % n_warps, bins), 1)
    pre = np.cumsum(cnt, 1) - cnt
    hist = cnt.sum(1)
    lrank = r_warp + pre[c, warp % n_warps, bins]
    np.testing.assert_array_equal(lrank, _stable_rank(c, bins))
    col = np.cumsum(hist, 0) - hist
    tot = hist.sum(0)
    offsets = np.cumsum(tot) - tot
    pos = offsets[bins] + col[c, bins] + lrank
    np.testing.assert_array_equal(np.sort(pos), p)
    return pos, offsets


def replay(ch, rows, cols, kernel, big_cap=64, tw=2, form=None):
    """binned_entries' data and offsets as the kernels compute them in
    ``form`` (None: the launch's own choice)."""
    with np.errstate(over="ignore", invalid="ignore"):  # huge, NaN slots
        tp = _tris_pass(ch, rows, cols, tw)
    T = ch["valid"].shape[0]
    seq = _sequence(tp, _rank(tp["mask"], big_cap, T)[0], T, big_cap)
    P = seq.shape[0]
    form = form or BE.auto_form(tp["nb"], P)
    pos, offsets = _counting_sort(seq, tp["nb"], 19, form)
    n_rows = P + BE.pad_rows(P, kernel)
    rows_ = np.zeros((n_rows, 16), np.float32)
    rows_[pos] = tp["src"][seq & (2 ** 19 - 1)]
    if kernel == "mm":
        rows_ = rows_.reshape(-1, 128, 16).transpose(0, 2, 1)
    return rows_.reshape(-1), offsets


def replay_keys(bb, rows, cols, big_cap, ty_lo=0, band=None, form=None):
    """pair_keys' keys, offsets and counts as the kernels compute them."""
    with np.errstate(invalid="ignore"):
        tp = _bin_pass(bb, rows, cols, ty_lo, band)
    T = bb["valid"].shape[0]
    cap = min(big_cap, T)
    big_idx, n_big = _rank(tp["mask"], cap, T)
    seq = _sequence(tp, big_idx, T, cap)
    form = form or BE.auto_form(tp["nb"], seq.shape[0])
    pos, offsets = _counting_sort(seq, tp["nb"], 18, form)
    keys = np.empty_like(seq)
    keys[pos] = seq
    small, big, valid = tp["flags"]
    counts = [int(small.sum()), n_big, int(offsets[tp["nb"]]),
              int(valid.sum())]
    assert n_big == int(big.sum())
    return keys, offsets, counts


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("name", list(BIN_SOUPS))
def test_kernel_replay_equals_plain_chain(name, kernel):
    """The replay's entries (in the layout's flat order) and offsets equal
    the plain chain's bit for bit (NaN in the same places), in the
    launch's own form and in every multi-block form."""
    ch, rows, cols = bin_soup(name)
    data, offs, tiles_x, n_tiles = BE.binned_entries_ref(
        _torch_ch(ch), rows, cols, kernel=kernel)
    assert tiles_x == -(-cols // 128) and n_tiles == offs.shape[0] - 1
    for form in (None, 1, 3):
        r_data, r_offs = replay(ch, rows, cols, kernel, form=form)
        np.testing.assert_array_equal(r_offs, offs.numpy())
        _same_bits(r_data, data.reshape(-1).numpy())


def test_replay_ranks_past_a_block_and_the_cap():
    """The last block's rank: big triangles spread over many blocks of
    the triangles' pass, more than the cap; the replay's ranks are the
    first big_cap big ids in order, as the chain's cumsum gives, and every
    key lands in one place of the sequence, each tile's in ascending
    triangle order."""
    T, n_tiles, tiles_x = 40000, 6, 3
    rng = np.random.default_rng(9)
    big = np.zeros(T, bool)
    big[rng.choice(np.arange(9000, T), 70, replace=False)] = True
    mask = _mask_words(big)
    assert mask.shape[0] > 1024
    span = np.tile([0, tiles_x - 1, 0, 1], (T, 1))
    # a triangle's window: distinct tiles, some pairs not emitted; a big
    # triangle emits no small pair
    tiles = (rng.integers(0, n_tiles, (T, 1)) + np.arange(4)) % n_tiles
    tiles[(rng.random((T, 4)) < 0.4) | big[:, None]] = n_tiles
    tp = dict(tiles=tiles, span=span, nb=n_tiles, gx=tiles_x, ty_off=0,
              shift=19)
    for cap in (1, 64, 70, 100):
        big_idx, n_big = _rank(mask, cap, T)
        assert n_big == 70
        np.testing.assert_array_equal(big_idx, np.flatnonzero(big)[:cap])
        seq = _sequence(tp, big_idx, T, cap)
        want = np.concatenate([(tiles.reshape(-1) << 19)
                               | np.repeat(np.arange(T), 4),
                               ((np.arange(n_tiles) << 19)
                                | big_idx[:, None]).reshape(-1),
                               np.full((cap - big_idx.shape[0]) * n_tiles,
                                       (n_tiles << 19) | (T - 1))])
        np.testing.assert_array_equal(np.sort(seq), np.sort(want))
        for g in range(n_tiles + 1):
            tri = seq[(seq >> 19) == g] & (2 ** 19 - 1)
            assert (np.diff(tri) >= 0).all() and (g == n_tiles or (
                np.diff(tri) > 0).all())
        for form in BE.FORMS:  # every form's places sort the keys
            pos, _offs = _counting_sort(seq, n_tiles, 19, form)
            out = np.empty_like(seq)
            out[pos] = seq
            np.testing.assert_array_equal(out, np.sort(seq))


def test_backend_reexports_and_cpu_launches_nothing():
    """backends/raster_channels re-exports the moved chain; CPU tensors
    run the plain version (bit for bit, both layouts) and launch no
    kernel; a kernel name it does not know raises."""
    for name in ("binned_entries", "binned_entries_ref", "tile_pairs",
                 "plane_entries", "_tile_span"):
        assert getattr(RC, name) is getattr(BE, name)
    ch, rows, cols = bin_soup("one_tile")
    tch = _torch_ch(ch)
    n0 = BE.launches
    for kernel in KERNELS:
        got = BE.binned_entries(tch, rows, cols, kernel=kernel)
        want = BE.binned_entries_ref(tch, rows, cols, kernel=kernel)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[2:] == want[2:]
    assert got[0].shape[1] == RB.PACK * RB.N_CHAN
    assert BE.launches == n0
    with pytest.raises(ValueError):
        BE.binned_entries(tch, rows, cols, kernel="scan")


# --------------------------------------------------------------------------
# bin keys: the grouped generations' pair keys
# --------------------------------------------------------------------------
# a band (ty_lo, tiles_y_band) of each soup's grid: inner, and the last
# tile row where the frame's rows end inside it
BANDS = {"one_tile": (4, 1), "hd": (2, 22), "many_big": (3, 4),
         "edge": (1, 3), "all_invalid": (0, 2)}
KEY_CASES = [(name, cap, banded) for name in BIN_SOUPS for cap in (0, 64)
             for banded in (False, True)]


def _band_kw(name, banded):
    if not banded:
        return {}
    ty_lo, band = BANDS[name]
    return dict(ty_lo=ty_lo, tiles_y_band=band)


@functools.lru_cache(maxsize=None)
def _jax_keys(name, cap, banded):
    bb, rows, cols = bbox_soup(name)
    kw = _band_kw(name, banded)
    jb = {k: jnp.asarray(v) for k, v in bb.items()}
    keys = jax.jit(lambda c: JR._subtile_pair_keys_bbox(
        c, rows, cols, big_cap=cap, **kw))(jb)
    small, big = jax.jit(lambda c: JR.count_big_small_bbox(
        c, rows, cols, **kw))(jb)
    return np.asarray(keys), int(small), int(big)


@pytest.mark.parametrize("name,cap,banded", KEY_CASES)
def test_bin_keys_plain_equals_jax(name, cap, banded):
    """The moved key chain (_pair_keys_core, through the backend's
    _subtile_pair_keys_bbox) gives JAX's compiled sorted keys, exact
    integers, unbanded and banded, big_cap 0 and 64, on soups with
    off-screen, near-plane sized, NaN and infinite bounds; pair_keys'
    plain version adds the offsets and JAX's counts."""
    bb, rows, cols = bbox_soup(name)
    kw = _band_kw(name, banded)
    want, n_small, n_big = _jax_keys(name, cap, banded)
    tb = _torch_ch(bb)
    got = R._subtile_pair_keys_bbox(tb, rows, cols, big_cap=cap, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    keys, offs, counts = BE.pair_keys(tb["bx0"], tb["bx1"], tb["by0"],
                                      tb["by1"], tb["valid"], rows, cols,
                                      big_cap=cap, **kw)
    assert torch.equal(keys, got)
    n_bins = offs.shape[0] - 1
    np.testing.assert_array_equal(
        offs.numpy(), np.searchsorted(want >> 18, np.arange(n_bins + 1)))
    assert counts.tolist() == [n_small, n_big, int((want >> 18 < n_bins)
                                                   .sum()),
                               int(bb["valid"].sum())]
    assert [int(c) for c in R.count_big_small_bbox(tb, rows, cols, **kw)] \
        == [n_small, n_big]
    if name != "all_invalid":
        assert int(counts[2]) > 0


@pytest.mark.parametrize("name,cap,banded", KEY_CASES)
def test_bin_keys_replay_equals_plain(name, cap, banded):
    """A replay of X9 in the bin layout (the rank, the key order, the
    counting sort of every form) gives the plain version's keys, offsets
    and counts."""
    bb, rows, cols = bbox_soup(name)
    kw = _band_kw(name, banded)
    keys, offs, counts = BE.pair_keys_ref(
        *(_torch_ch(bb)[k] for k in ("bx0", "bx1", "by0", "by1", "valid")),
        rows, cols, big_cap=cap, **kw)
    for form in [None, *BE.FORMS]:
        r_keys, r_offs, r_counts = replay_keys(
            bb, rows, cols, cap, kw.get("ty_lo", 0), kw.get("tiles_y_band"),
            form=form)
        np.testing.assert_array_equal(r_keys, keys.numpy())
        np.testing.assert_array_equal(r_offs, offs.numpy())
        assert r_counts == counts.tolist()


def test_bin_keys_reexports_and_cpu_launches_nothing():
    """backends/raster re-exports the moved key chain; pair_keys on CPU
    tensors is its plain version and launches nothing; the form rule
    takes 1,024-key chunks for the smallest calls and 4,096-key chunks
    for the largest."""
    for name in ("_bin_span", "_pair_keys_core", "_floor_i32"):
        assert getattr(R, name) is getattr(BE, name)
    bb, rows, cols = bbox_soup("many_big")
    tb = _torch_ch(bb)
    n0 = (BE.launches, BE.launches_keys)
    got = BE.pair_keys_bbox(tb, rows, cols, big_cap=64)
    want = BE.pair_keys_ref(tb["bx0"], tb["bx1"], tb["by0"], tb["by1"],
                            tb["valid"], rows, cols, big_cap=64)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (BE.launches, BE.launches_keys) == n0
    assert [BE.auto_form(5, 6816), BE.auto_form(544, 100352),
            BE.auto_form(4352, 553104)] == [1, 2, 3]
    assert [BE.chunk_of(f) for f in BE.FORMS] == [1024, 2048, 4096]
    # three launches where each scatter block scans a tiny histogram
    # itself; else four
    assert BE.launches_of(1, 5, 6816) == 3
    assert BE.launches_of(2, 4352, 274576) == 4
    with pytest.raises(ValueError):
        BE.chunk_of(4)
