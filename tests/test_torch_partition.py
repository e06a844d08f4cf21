"""The stable partition (X13, ``ops/partition``) on the CPU, and the mid
raster path's counts from X9.

The plain versions equal the JAX package exactly: the channels form
(``compact_channels_ref``, reached through ``raster_channels
.compact_valid_ch``) against ``jax.jit(compact_valid_ch)`` (the compacted
channels' bits, ``cidx``, ``n_valid``) on every mask of
``tools/xla_inputs.PARTITION_CASES``; the order form
(``stable_order_ref``) against the reference's ``lax.sort`` of the key
``(1 - active) * pc + i`` with its pixel uids (``backends/pathtrace.py``
:524-531), its gates against the gate chain. A Python replay of the
kernel's algorithm equals the plain versions at the sizes the card's
tests take: the count-all launch (the channels form's blocks each owning
a range of output rows, ranking the flags 16 to a lane and staging the
ids ranked in their range, at range sizes that put the edges inside
lanes, warps and tiles; the order form's tiles of 1,024 flags, a warp's 4
ballots, the offsets from the counted flags) and the co-resident one
(runs of tiles a block, the first ranked by ballots and the rest counted,
the offsets from the blocks' counts; grids of one tile a block, of runs
of several and of more blocks than tiles), the fill and the gates'
closed form. X9's counts
(``binned_entries_ref(counts=True)``) equal JAX's ``count_big_small``;
``render_channels_diag``'s ``n_big`` comes from them. The path tracer's
set-up on host floats (``light_floats``, ``camera_floats``,
``camera_basis_floats``) equals the tensor chains it replaced bit for bit.
CPU tensors launch nothing; a failed build or launch raises. The kernel
itself is held to the plain versions on the card by
``tests/test_torch_build_xla.py`` (marked ``cuda``)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.backends import raster as JR
from ascii_renderer_tpu_torch.backends import pathtrace as TPT
from ascii_renderer_tpu_torch.backends import raster as R
from ascii_renderer_tpu_torch.backends import raster_channels as RC
from ascii_renderer_tpu_torch.core import camera as TC
from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.ops import bin_entries as BE
from ascii_renderer_tpu_torch.ops import partition as PTN
from ascii_renderer_tpu_torch.ops import ray_grid as RYG
from ascii_renderer_tpu_torch.scene.demo import create_demo_scene
from ascii_renderer_tpu_torch.tools.xla_inputs import (
    BIN_SOUPS, PARTITION_CASES, bin_soup, front_inputs, partition_channels,
    partition_mask, pixel_order)

torch.set_num_threads(2)

# the card tests' sizes: one flag, a block's edges, the count-all form's
# last and the co-resident form's first, and 2^19 - 4,096 (MAX_V_CAP)
REPLAY_SIZES = (1, 127, 128, 1023, 1024, 1025, 4097, PTN.COUNT_ALL,
                PTN.COUNT_ALL + 1, (1 << 19) - 4096)


def _u32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _torch_ch(ch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in ch.items()}


# --------------------------------------------------------------------------
# the channels form against JAX's compact_valid_ch
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(PARTITION_CASES))
def test_channels_form_equals_jax(case):
    """cch (every channel's bits and valid), cidx and n_valid equal
    jax.jit(compact_valid_ch)'s for the case's mask and cap (overflow:
    the valid slots past v_cap dropped; v_cap above 2T: the fill past
    them)."""
    n, rule, v_cap = PARTITION_CASES[case]
    ch = partition_channels(n, rule, seed=7)
    jc, jidx, jn = jax.jit(lambda c: JR.compact_valid_ch(dict(c), v_cap))(
        {k: jnp.asarray(v) for k, v in ch.items()})
    for got in (PTN.compact_channels_ref(_torch_ch(ch), v_cap),
                RC.compact_valid_ch(_torch_ch(ch), v_cap)):
        cch, cidx, n_valid = got
        assert set(cch) == set(jc)
        for k in PTN.COMPACT_KEYS:
            np.testing.assert_array_equal(_u32(cch[k].numpy()), _u32(jc[k]))
        np.testing.assert_array_equal(cch["valid"].numpy(),
                                      np.asarray(jc["valid"]))
        np.testing.assert_array_equal(cidx.numpy(), np.asarray(jidx))
        assert cidx.dtype == torch.int32 and n_valid.dtype == torch.int32
        assert n_valid.dim() == 0 and int(n_valid) == int(jn) == int(
            ch["valid"].sum())
    if case == "overflow":
        assert int(jn) > v_cap
    if case == "v_cap above 2T":
        assert v_cap > n and not np.asarray(jc["valid"])[n:].any()


def test_channels_form_layout_is_a_row_block():
    """The compacted channels are the columns of one row-major [v_cap, 13]
    block, the layout X3 and X9 read as stride-13 views."""
    ch = _torch_ch(partition_channels(700, 0.5, seed=2))
    cch, _cidx, _n = PTN.compact_channels_ref(ch, 512)
    base = cch["sxa"]
    for i, k in enumerate(PTN.COMPACT_KEYS):
        assert cch[k].shape == (512,) and cch[k].stride() == (13,)
        assert cch[k].data_ptr() == base.data_ptr() + 4 * i


# --------------------------------------------------------------------------
# the order form against the reference's key sort
# --------------------------------------------------------------------------
ORDER_MASKS = ("random", "all", "none", "one", "last")


def _order_mask(rows, cols, kind, seed=3):
    if kind == "random":
        return pixel_order(rows, cols, 0.3, seed=seed)[0]
    m = np.zeros((rows, cols), bool)
    if kind == "all":
        m[:] = True
    elif kind == "one":
        m.reshape(-1)[rows * cols // 3] = True
    elif kind == "last":
        m.reshape(-1)[-1] = True
    return m


def _gates_np(n_act, pc, s):
    live = (np.arange(s * pc) % pc) < n_act
    live = np.concatenate([live, np.zeros(-live.size % 1024, bool)])
    return live.reshape(-1, 1024).any(axis=1).astype(np.int32)


@pytest.mark.parametrize("band", [None, (12, 12)])
@pytest.mark.parametrize("kind", ORDER_MASKS)
def test_order_form_equals_jax_key_sort(kind, band):
    """slot and pix_uid equal the reference's lax.sort of the unique key
    (1 - active) * pc + i carrying the pixel uids (36 x 96's 3,456 pixels,
    and the band of rows 12-23); the gates of 1 and 32 samples equal the
    gate chain and a numpy count."""
    rows, cols = 36, 96
    row_lo, n_rows = band or (0, rows)
    mask = _order_mask(n_rows, cols, kind)
    pc = n_rows * cols
    uid0 = row_lo * cols

    def jax_sort(m):
        mi = m.reshape(-1).astype(jnp.int32)
        key = (1 - mi) * pc + jnp.arange(pc, dtype=jnp.int32)
        uid = jnp.arange(pc, dtype=jnp.int32) + uid0
        return jax.lax.sort((key, uid), dimension=0, is_stable=False,
                            num_keys=1)[1]
    want = np.asarray(jax.jit(jax_sort)(jnp.asarray(mask)))
    slot, pix_uid, gates = PTN.stable_order_ref(torch.from_numpy(mask),
                                                uid0, 32)
    assert slot.dtype == pix_uid.dtype == torch.int32
    np.testing.assert_array_equal(pix_uid.numpy(), want)
    np.testing.assert_array_equal(slot.numpy(), want - uid0)
    n_act = int(mask.sum())
    assert set(gates) == {1, 32}
    for s, g in gates.items():
        live = torch.arange(pc) < n_act
        assert torch.equal(g, TPT._block_gate(live.repeat(s)))
        np.testing.assert_array_equal(g.numpy(), _gates_np(n_act, pc, s))
    # the CPU route is the plain version
    got = PTN.stable_order(torch.from_numpy(mask), uid0, 32)
    assert torch.equal(got[0], slot) and torch.equal(got[1], pix_uid)


def test_frame_rays_takes_the_order_form(monkeypatch):
    """_FrameRays' compacted set-up is one stable_order call (its slot,
    uids and gates, and the ray counters zeroed in it), a full frame's
    none."""
    calls = []
    real = PTN.stable_order
    monkeypatch.setattr(PTN, "stable_order",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    cam = TC.Camera.create(pos=(0.0, 2.5, 6.0))
    act = torch.from_numpy(pixel_order(4, 96, 0.3, seed=5)[0])
    origin = TC.camera_floats(cam)[:3]
    fr = TPT._FrameRays([0.0] * 8, origin, 36, 96, 2, 4, 8, 3, act, "cpu")
    assert len(calls) == 1 and calls[0][1:] == (2 * 96, 8)
    slot, uid, gates = real(act, 2 * 96, 8)
    assert torch.equal(fr.slot, slot) and torch.equal(fr.pix_uid, uid)
    assert set(fr._gates) == {1, 8}
    assert all(torch.equal(fr._gates[s], gates[s]) for s in (1, 8))
    assert fr.counters.dtype == torch.int32 and fr.counters.tolist() == \
        [0] * 4
    full = TPT._FrameRays([0.0] * 8, origin, 36, 96, 0, 36, 8, 3, None,
                          "cpu")
    assert len(calls) == 1 and full.counters.tolist() == [0] * 4


# --------------------------------------------------------------------------
# a replay of the kernel's algorithm
# --------------------------------------------------------------------------
def _gates_closed_form(n, total, samples):
    """The kernel's gates of 1 and ``samples`` samples from n_set alone:
    the slots of gate q's rays run from lo % n for len slots, wrapping."""
    gates = {}
    for smp in {1, samples}:
        lo = np.arange(-(-(smp * n) // 1024), dtype=np.int64) * 1024
        ln = np.minimum(lo + 1024, smp * n) - lo
        r0 = lo % n
        gates[smp] = ((total > 0) & ((ln >= n) | (r0 < total)
                                     | (r0 + ln > n))).astype(np.int32)
    return gates


def _tile_ranks(pad, tile_before, tile):
    """Each flag's rank from its tile's ballots: tiles of ``tile`` flags,
    8 warps of tile / 256 rounds of 32 lanes; a flag's rank is the tile's
    offset, the warps' counts before its warp, its warp's ballots before
    its round and the popcount of its round's ballot below its lane."""
    warps = PTN.THREADS // 32
    fl = pad.reshape(-1, warps, tile // (32 * warps), 32).astype(np.int64)
    wcnt = fl.sum(axis=(2, 3))
    s_warp = tile_before[:, None] + np.cumsum(wcnt, axis=1) - wcnt
    rnd = fl.sum(axis=3)
    s_round = s_warp[..., None] + np.cumsum(rnd, axis=2) - rnd
    below = np.cumsum(fl, axis=3) - fl
    return (s_round[..., None] + below).reshape(-1)


def _replay_coop(flags, grid, tile):
    """The co-resident launch on ``grid`` blocks, tiles of ``tile`` flags:
    block b's run of tiles [b * ntiles // grid, (b + 1) * ntiles // grid),
    its first tile ranked by ballots and the rest counted (16-byte words,
    then the tail), its count; after the grid's barrier its offset (the
    counts before it) and the total. Returns (each flag's rank, n_set)."""
    n = flags.size
    ntiles = -(-n // tile)
    pad = np.zeros(ntiles * tile, bool)
    pad[:n] = flags != 0
    tile_counts = pad.reshape(ntiles, tile).sum(axis=1)
    part = np.zeros(grid, np.int64)
    tile_before = np.zeros(ntiles, np.int64)
    runs = [(b * ntiles // grid, (b + 1) * ntiles // grid)
            for b in range(grid)]
    for b, (t0, t1) in enumerate(runs):
        if t0 < t1:
            part[b] = tile_counts[t0]
        if t0 + 1 < t1:
            lo, hi = (t0 + 1) * tile, min(t1 * tile, n)
            mid = lo + (hi - lo) // 16 * 16
            part[b] += pad[lo:mid].sum() + pad[mid:hi].sum()
    before = np.cumsum(part) - part
    for b, (t0, t1) in enumerate(runs):
        off = before[b]
        for t in range(t0, t1):
            tile_before[t] = off
            off += tile_counts[t]
    return _tile_ranks(pad, tile_before, tile)[:n], int(part.sum())


def _replay_count_all_order(flags):
    """The count-all order form: block b places tile b, its offset the set
    flags before the tile counted by the block itself."""
    n = flags.size
    ntiles = -(-n // PTN.TILE)
    pad = np.zeros(ntiles * PTN.TILE, bool)
    pad[:n] = flags != 0
    tile_before = np.array([pad[:t * PTN.TILE].sum() for t in range(ntiles)],
                           np.int64)
    return _tile_ranks(pad, tile_before, PTN.TILE)[:n], int(pad.sum())


def _replay_rows(flags, v_cap, rows):
    """The count-all channels form with ``rows`` out rows a block: warp w
    holds flags [w * W, (w + 1) * W) (W = 512 a 16-byte word a lane) in
    rounds of 32 lanes x 16 flags; a flag's rank is the warps' counts
    before its warp, its rounds before, the lanes before it in its round
    (a shuffle scan) and its set bytes before it in its word. Block b
    (rows [b * rows, ...)) stages the ids ranked in its rows below the
    total (a lane whose ranks meet the range walks its word); a block past
    n stages none. Returns (cidx, n_set)."""
    n = flags.size
    warps = PTN.ROWS_THREADS // 32
    words = max(1, -(-PTN.COUNT_ALL // (16 * PTN.ROWS_THREADS)))
    assert n <= warps * words * 512
    fl = np.zeros(warps * words * 512, bool)
    fl[:n] = flags != 0
    fl = fl.reshape(warps, words, 32, 16).astype(np.int64)
    c = fl.sum(axis=3)
    wtot = c.sum(axis=(1, 2))
    total = int(wtot.sum())
    s_warp = np.cumsum(wtot) - wtot
    rnd = c.sum(axis=2)
    s_round = s_warp[:, None] + np.cumsum(rnd, axis=1) - rnd
    lane_first = s_round[..., None] + np.cumsum(c, axis=2) - c
    rank = lane_first[..., None] + np.cumsum(fl, axis=3) - fl
    ids = np.arange(fl.size).reshape(fl.shape)
    cidx = np.full(v_cap, n, np.int64)
    for b in range(-(-v_cap // rows)):
        r0, r1 = b * rows, min((b + 1) * rows, v_cap)
        if r0 >= n:
            continue
        hi = min(r1, total)
        meets = (lane_first < hi) & (lane_first + c > r0)
        pick = (fl == 1) & meets[..., None] & (rank >= r0) & (rank < hi)
        staged = np.full(rows, -1, np.int64)
        staged[rank[pick] - r0] = ids[pick]
        assert int(pick.sum()) == max(0, hi - r0)
        cidx[r0:max(r0, hi)] = staged[:max(0, hi - r0)]
    return cidx, total


def _cidx_from_ranks(flags, rank, v_cap):
    """The co-resident channels form's kept ids (set flags ranked below
    v_cap, each written at its rank) and the fill past them."""
    n = flags.size
    keep = (flags != 0) & (rank < v_cap)
    cidx = np.full(v_cap, n, np.int64)
    cidx[rank[keep]] = np.arange(n)[keep]
    return cidx


def _order_from_ranks(flags, rank, total, uid0, samples):
    """slot, pix_uid and the gates from each flag's rank: a set flag at its
    rank, an unset one at total + i - rank."""
    n = flags.size
    i = np.arange(n)
    pos = np.where(flags != 0, rank, total + i - rank)
    slot = np.full(n, -1, np.int64)
    slot[pos] = i
    return slot, slot + uid0, _gates_closed_form(n, total, samples)


def _grids(n, tile):
    """Co-resident grids over tiles of ``tile`` flags: a tile a block, runs
    of several tiles, more blocks than tiles."""
    ntiles = -(-n // tile)
    return sorted({ntiles, max(1, ntiles // 3), ntiles + 5})


@pytest.mark.parametrize("n", REPLAY_SIZES)
def test_replay_of_the_order_form_equals_plain(n):
    """The kernel's tiles, ballots, offsets and gate formula give the plain
    version's slot, pix_uid and gates of 1 and 8 samples, in the count-all
    launch (up to COUNT_ALL flags; tiles of TILE) and the co-resident one
    (tiles of ORDER_TILE, 8 ballots a warp) on grids of a tile a block,
    runs of several tiles and more blocks than tiles."""
    flags = partition_mask(n, 0.4, seed=n)
    slot, uid, gates = PTN.stable_order_ref(torch.from_numpy(flags), 77, 8)
    forms = [_replay_coop(flags, g, PTN.ORDER_TILE)
             for g in _grids(n, PTN.ORDER_TILE)]
    if n <= PTN.COUNT_ALL:
        forms.append(_replay_count_all_order(flags))
    for rank, total in forms:
        assert total == int(flags.sum())
        r_slot, r_uid, r_gates = _order_from_ranks(flags, rank, total, 77, 8)
        np.testing.assert_array_equal(r_slot, slot.numpy())
        np.testing.assert_array_equal(r_uid, uid.numpy())
        for s in (1, 8):
            np.testing.assert_array_equal(r_gates[s], gates[s].numpy())


@pytest.mark.parametrize("n", REPLAY_SIZES)
def test_replay_of_the_channels_form_equals_plain(n):
    """The kernel's kept rows (set flags ranked below v_cap) and fill give
    the plain version's cidx and count at v_cap n, below the valid count
    and above n: the count-all launch's output ranges (ROWS rows a block
    and 37, whose edges fall inside lanes, warps and tiles) up to
    COUNT_ALL flags, the co-resident launch on every grid of _grids."""
    flags = partition_mask(n, 0.6, seed=n + 1)
    ch = {k: torch.zeros(n) for k in PTN.COMPACT_KEYS}
    ch["valid"] = torch.from_numpy(flags)
    ranks = [_replay_coop(flags, g, PTN.TILE) for g in _grids(n, PTN.TILE)]
    for v_cap in {n, max(1, int(flags.sum()) // 2), n + 4096}:
        _cch, cidx, n_valid = PTN.compact_channels_ref(ch, v_cap)
        got = [(_cidx_from_ranks(flags, rank, v_cap), total)
               for rank, total in ranks]
        if n <= PTN.COUNT_ALL:
            got += [_replay_rows(flags, v_cap, rows)
                    for rows in (PTN.ROWS, 37)]
        for r_cidx, total in got:
            np.testing.assert_array_equal(r_cidx, cidx.numpy())
            assert total == int(n_valid)


def test_gate_formula_on_every_small_stream():
    """The gates' closed form (slots from lo % n for len rays, wrapping
    past n) against the gate chain for every active count of streams of
    1-5 samples over 1-2,100 slots, in steps."""
    for n in (1, 2, 3, 511, 1023, 1024, 1025, 1500, 2047, 2100):
        for s in (1, 2, 3, 5):
            for n_act in sorted({0, 1, n // 3, n // 2, n - 1, n}):
                mask = torch.arange(n) < n_act
                want = PTN.block_gate(mask.repeat(s)).numpy()
                nb = -(-(s * n) // 1024)
                lo = np.arange(nb) * 1024
                ln = np.minimum(lo + 1024, s * n) - lo
                r0 = lo % n
                got = ((n_act > 0) & ((ln >= n) | (r0 < n_act)
                                      | (r0 + ln > n))).astype(np.int32)
                np.testing.assert_array_equal(got, want, err_msg=str(
                    (n, s, n_act)))


# --------------------------------------------------------------------------
# X9's counts; the mid path's n_big
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", ["mm", "loop"])
@pytest.mark.parametrize("name", list(BIN_SOUPS))
def test_binned_entries_counts_equal_jax(name, kernel):
    """binned_entries_ref(counts=True) gives the entries it gives without
    them and the counts (n_small, n_big, n_pairs, n_valid): the first two
    JAX's count_big_small, n_pairs the offsets' last, n_valid the valid
    slots."""
    ch, rows, cols = bin_soup(name)
    tch = _torch_ch(ch)
    got = BE.binned_entries_ref(tch, rows, cols, kernel=kernel, counts=True)
    plain = BE.binned_entries_ref(tch, rows, cols, kernel=kernel)
    assert len(got) == 5 and torch.equal(got[0].view(torch.int32),
                                         plain[0].view(torch.int32))
    assert torch.equal(got[1], plain[1]) and got[2:4] == plain[2:]
    js, jb = jax.jit(lambda c: JR.count_big_small(dict(c), rows, cols))(
        {k: jnp.asarray(v) for k, v in ch.items()})
    counts = got[4]
    assert counts.dtype == torch.int32 and counts.shape == (4,)
    assert counts.tolist() == [int(js), int(jb), int(plain[1][-1]),
                               int(ch["valid"].sum())]
    assert BE.binned_entries(tch, rows, cols, kernel=kernel,
                             counts=True)[4].tolist() == counts.tolist()


@pytest.mark.parametrize("kernel", ["mm", "loop"])
def test_mid_path_n_big_from_the_bin_pass(kernel, monkeypatch):
    """render_channels_diag's mm / loop branch takes n_big from the bin
    pass's counts (visibility_binned_ch(counts=True)), no count_big_small
    call: equal to JAX's count_big_small over JAX's compaction, overflow
    (v_cap below the valid count) included."""
    p, attrs, mvp = front_inputs(400, 5, "cpu")
    scene = create_demo_scene().build(device="cpu")
    calls = []
    monkeypatch.setattr(RC, "count_big_small",
                        lambda *a, **k: calls.append(a))
    pos9 = R.positions_to_pos9(p)
    jch = jax.jit(lambda s, m: JR.setup_screen_channels(
        JR.transform_clip_channels9(s, m), 36, 96))(
        jnp.asarray(pos9.numpy()), jnp.asarray(mvp.numpy()))
    n_valid = int(jch["valid"].sum())
    for v_cap in (512, n_valid // 2):
        _rgb, diag = RC.render_channels_diag(
            p, attrs, scene, mvp, 36, 96, v_cap=v_cap, kernel=kernel,
            pos9=pos9)
        jc = jax.jit(lambda c: JR.compact_valid_ch(dict(c), v_cap))(jch)
        _js, jb = jax.jit(lambda c: JR.count_big_small(dict(c), 36, 96))(
            jc[0])
        assert int(diag["n_big"]) == int(jb) and int(diag["n_valid"]) == \
            n_valid
    assert calls == []


# --------------------------------------------------------------------------
# the path tracer's set-up on host floats
# --------------------------------------------------------------------------
def test_camera_floats_and_basis_floats_equal_camera_basis():
    """camera_floats reads the pose's float32 values; camera_basis_floats
    equals camera_basis's tensors bit for bit (and its nine, uu | vv |
    focal * ww, the launch's floats), also at the axis poses with signed
    zeros, each pose asked twice (its cached basis); pt_rays' plain
    version gives the same rays from either."""
    rng = np.random.default_rng(2)
    poses = [dict(pos=rng.uniform(-9, 9, 3).tolist(),
                  yaw=float(rng.uniform(-math.pi, math.pi)),
                  pitch=float(rng.uniform(-1.4, 1.4)),
                  fov_y_deg=float(rng.uniform(20, 120))) for _ in range(300)]
    poses += [dict(yaw=y, pitch=p) for y in (0.0, -0.0, math.pi / 2,
                                             -math.pi / 2)
              for p in (0.0, -0.0)]
    for kw in poses + poses[::-1]:
        cam = TC.Camera.create(**kw)
        pose = TC.camera_floats(cam)
        assert _u32(pose).tolist() == _u32(np.concatenate([
            cam.pos.numpy(), [cam.yaw, cam.pitch, cam.fov_y]])).tolist()
        hb = TC.camera_basis_floats(*pose[3:])
        want = TC.camera_basis(cam.yaw, cam.pitch, cam.fov_y)
        for a, b in zip(hb.tensors(), want):
            assert a.shape == b.shape
            assert _u32(a.numpy()).tolist() == _u32(b.numpy()).tolist(), kw
        uu, vv, ww, focal = want
        assert _u32(hb.nine).tolist() == _u32(torch.cat(
            [uu, vv, focal * ww])).tolist()
    kw = dict(row_lo=12, n_rows=12, device="cpu")
    assert torch.equal(RYG.pt_rays_ref(hb, 36, 96, 0.5, **kw),
                       RYG.pt_rays_ref(want, 36, 96, 0.5, **kw))
    assert list(RYG._basis9(hb)) == list(RYG._basis9(want))


# --------------------------------------------------------------------------
# the wrappers: CPU tensors launch nothing, failures raise
# --------------------------------------------------------------------------
class _FailingLib:
    """A kernel library whose every launch reports a CUDA error."""

    def __getattr__(self, name):
        return lambda *args: 700  # cudaErrorIllegalAddress


def test_cpu_launches_nothing_and_failures_raise(monkeypatch):
    """CPU tensors take the plain versions and count no launch; past the
    device checks, a failed build or launch raises out of both forms (no
    fallback to the plain version); flags that are not a 1-D bool tensor
    raise ValueError."""
    saved = (PTN.launches, PTN.launches_order)
    ch = _torch_ch(partition_channels(300, 0.5))
    PTN.compact_channels(ch, 256)
    PTN.stable_order(ch["valid"], 0, 4)
    assert (PTN.launches, PTN.launches_order) == saved
    meta = torch.device("meta")
    mch = {k: v.to(meta) for k, v in ch.items()}
    plain = []
    monkeypatch.setattr(PTN, "compact_channels_ref",
                        lambda *a: plain.append(a))
    monkeypatch.setattr(PTN, "stable_order_ref", lambda *a: plain.append(a))
    monkeypatch.setattr(_build, "require_cuda", lambda *t, what: None)
    monkeypatch.setattr(_build, "require_device", lambda *t, what: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)

    def no_build():
        raise RuntimeError("nvcc failed")

    runs = (lambda: PTN.compact_channels(mch, 256),
            lambda: PTN.stable_order(mch["valid"], 0, 4),
            lambda: PTN.compact_channels(mch, 256 * 512),
            lambda: PTN.stable_order(mch["valid"].repeat(200), 0, 1))
    for lib, match in ((no_build, "nvcc failed"),
                       (lambda: _FailingLib(), "launch failed")):
        monkeypatch.setattr(_build, "lib", lib)
        for run in runs:
            with pytest.raises(RuntimeError, match=match):
                run()
    assert plain == []
    with pytest.raises(ValueError):  # not bool
        PTN.stable_order(mch["sxa"], 0, 1)
    with pytest.raises(ValueError):  # not 1-D
        PTN.compact_channels(dict(mch, valid=mch["valid"].reshape(30, 10)),
                             256)
    with pytest.raises(ValueError):
        PTN.compact_channels(dict(mch, sxb=mch["sxb"][:10]), 256)
    monkeypatch.setattr(PTN, "launches", saved[0])
    monkeypatch.setattr(PTN, "launches_order", saved[1])


def test_launches_of():
    """One launch at every size, count-all or co-resident."""
    assert [PTN.launches_of(n) for n in (1, 2048, 29768, 32768, 32769,
                                         137288, 518400, 2 ** 31 - 1)] == \
        [1, 1, 1, 1, 1, 1, 1, 1]
