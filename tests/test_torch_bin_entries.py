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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.backends import raster_channels as JRC
from ascii_renderer_tpu_torch.backends import raster_channels as RC
from ascii_renderer_tpu_torch.core.fp import fma32_f64
from ascii_renderer_tpu_torch.ops import bin_entries as BE
from ascii_renderer_tpu_torch.ops import raster_bins as RB
from ascii_renderer_tpu_torch.tools.xla_inputs import BIN_SOUPS, bin_soup

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
CHUNK = BE.CHUNK  # keys a block of the sequence pass and the scatter


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


def _tris_pass(ch, rows, cols, tw):
    """bin_tris_kernel: tiles [T, tw^2], span [T, 4], mask words, src rows
    [T + 1, 16]."""
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
    bits = np.zeros(-(-T // 32) * 32, bool)
    bits[:T] = big
    mask = np.packbits(bits.reshape(-1, 32)[:, ::-1], axis=1).view(
        ">u4")[:, 0].astype(np.uint64)
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
    return tiles, span, mask, src, n_tiles, tiles_x


def _rank(mask, big_cap):
    """bin_seq_kernel's ranks: a block scan of the mask words' bit counts,
    CHUNK words a step, until big_cap big triangles are found; the ranked
    ids in order."""
    big_idx, running, base = [], 0, 0
    while base < mask.shape[0] and running < big_cap:
        words = [int(w) for w in mask[base:base + CHUNK]]
        counts = [bin(w).count("1") for w in words]
        incl = np.cumsum(counts)
        for j, w in enumerate(words):
            r = running + int(incl[j]) - counts[j]
            while w and r < big_cap:
                low = (w & -w).bit_length() - 1
                big_idx.append((base + j) * 32 + low)
                assert len(big_idx) == r + 1  # written at rank r
                w &= w - 1
                r += 1
        running += int(incl[-1])
        base += CHUNK
    return np.asarray(big_idx, np.int64)


def _sequence(tiles, span, big_idx, T, tiles_x, n_tiles, big_cap):
    """bin_seq_kernel's keys in sequence order: position p finds its big
    segment (seg = S (bi + 1) + n_tiles b) by the count of those complete
    before it, else its small key or a fill rank's."""
    S = tiles.shape[1]
    P = S * T + big_cap * n_tiles
    p = np.arange(P)
    nr = big_idx.shape[0]
    seg = S * (big_idx + 1) + n_tiles * np.arange(nr)
    j = np.searchsorted(seg + n_tiles, p, side="right")
    jc = np.minimum(j, max(nr - 1, 0))
    in_big = (j < nr) & (seg[jc] <= p) if nr else np.zeros(P, bool)
    q = p - n_tiles * j
    small = ~in_big & (q < S * T)
    key = np.full(P, (n_tiles << 19) | (T - 1), np.int64)
    qs = q[small]
    key[small] = (tiles.reshape(-1)[qs] << 19) | (qs // S)
    if nr:
        bi = big_idx[jc[in_big]]
        tile = p[in_big] - seg[jc[in_big]]
        s = span[bi]
        gy, gx = tile // tiles_x, tile % tiles_x
        hit = ((gx >= s[:, 0]) & (gx <= s[:, 1]) & (gy >= s[:, 2])
               & (gy <= s[:, 3]))
        key[in_big] = (np.where(hit, tile, n_tiles) << 19) | bi
    return key


def _counting_sort(seq, src, n_tiles, n_rows, mm):
    """bin_seq_kernel's histograms, bin_scan_kernel's tile-major exclusive
    scan and offsets, bin_scatter_kernel's stable ranks within a chunk and
    its row writes, in the layout's flat order."""
    P = seq.shape[0]
    n_chunks = -(-P // CHUNK)
    tile = seq >> 19
    chunk = np.arange(P) // CHUNK
    hist = np.zeros((n_tiles + 1, n_chunks), np.int64)
    np.add.at(hist, (tile, chunk), 1)
    base = (np.cumsum(hist.reshape(-1)) - hist.reshape(-1)).reshape(
        hist.shape)
    offsets = base[:, 0]
    pos = np.empty(P, np.int64)
    for c in range(n_chunks):
        run = base[:, c].copy()
        for i in range(c * CHUNK, min(P, (c + 1) * CHUNK)):
            pos[i] = run[tile[i]]
            run[tile[i]] += 1
    rows = np.zeros((n_rows, 16), np.float32)
    rows[pos] = src[seq & (2 ** 19 - 1)]
    if mm:
        rows = rows.reshape(-1, 128, 16).transpose(0, 2, 1)
    return rows.reshape(-1), offsets


def replay(ch, rows, cols, kernel, big_cap=64, tw=2):
    """binned_entries' data and offsets as the kernels compute them."""
    with np.errstate(over="ignore", invalid="ignore"):  # huge, NaN slots
        tiles, span, mask, src, n_tiles, tiles_x = _tris_pass(ch, rows, cols,
                                                              tw)
    T = ch["valid"].shape[0]
    seq = _sequence(tiles, span, _rank(mask, big_cap), T, tiles_x, n_tiles,
                    big_cap)
    P = seq.shape[0]
    return _counting_sort(seq, src, n_tiles, P + BE.pad_rows(P, kernel),
                          kernel == "mm")


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("name", list(BIN_SOUPS))
def test_kernel_replay_equals_plain_chain(name, kernel):
    """The replay's entries (in the layout's flat order) and offsets equal
    the plain chain's bit for bit (NaN in the same places)."""
    ch, rows, cols = bin_soup(name)
    data, offs, tiles_x, n_tiles = BE.binned_entries_ref(
        _torch_ch(ch), rows, cols, kernel=kernel)
    r_data, r_offs = replay(ch, rows, cols, kernel)
    assert tiles_x == -(-cols // 128) and n_tiles == offs.shape[0] - 1
    np.testing.assert_array_equal(r_offs, offs.numpy())
    _same_bits(r_data, data.reshape(-1).numpy())


def test_replay_ranks_past_a_block_and_the_cap():
    """The sequence pass's rank: big triangles spread over more mask words
    than a block scans in one step, more than the cap; the replay's ranks
    are the first big_cap big ids in order, as the chain's cumsum gives,
    and every key lands in one place of the sequence, each tile's in
    ascending triangle order."""
    T, n_tiles, tiles_x = 40000, 6, 3
    rng = np.random.default_rng(9)
    big = np.zeros(T, bool)
    big[rng.choice(np.arange(9000, T), 70, replace=False)] = True
    bits = big.reshape(-1, 32)[:, ::-1]
    mask = np.packbits(bits, axis=1).view(">u4")[:, 0].astype(np.uint64)
    assert mask.shape[0] > CHUNK
    span = np.tile([0, tiles_x - 1, 0, 1], (T, 1))
    # a triangle's window: distinct tiles, some pairs not emitted; a big
    # triangle emits no small pair
    tiles = (rng.integers(0, n_tiles, (T, 1)) + np.arange(4)) % n_tiles
    tiles[(rng.random((T, 4)) < 0.4) | big[:, None]] = n_tiles
    for cap in (1, 64, 70, 100):
        big_idx = _rank(mask, cap)
        np.testing.assert_array_equal(big_idx, np.flatnonzero(big)[:cap])
        seq = _sequence(tiles, span, big_idx, T, tiles_x, n_tiles, cap)
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
