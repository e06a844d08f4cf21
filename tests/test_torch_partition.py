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
kernel's algorithm (tiles of 1,024 flags, a warp's 4 ballots, the tile
offsets from the counts, the fill and the gates' closed form) equals the
plain versions at the sizes the card's tests take. X9's counts
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

# the card tests' sizes: one flag, a block's edges, one launch's last and
# two launches' first, and 2^19 - 4,096 (MAX_V_CAP)
REPLAY_SIZES = (1, 127, 128, 1023, 1024, 1025, 4097, PTN.ONE_LAUNCH,
                PTN.ONE_LAUNCH + 1, (1 << 19) - 4096)


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
    uids and gates), a full frame's none."""
    calls = []
    real = PTN.stable_order
    monkeypatch.setattr(PTN, "stable_order",
                        lambda *a: calls.append(a) or real(*a))
    cam = TC.Camera.create(pos=(0.0, 2.5, 6.0))
    act = torch.from_numpy(pixel_order(4, 96, 0.3, seed=5)[0])
    origin = TC.camera_floats(cam)[:3]
    fr = TPT._FrameRays([0.0] * 8, origin, 36, 96, 2, 4, 8, 3, act, "cpu")
    assert len(calls) == 1 and calls[0][1:] == (2 * 96, 8)
    slot, uid, gates = real(act, 2 * 96, 8)
    assert torch.equal(fr.slot, slot) and torch.equal(fr.pix_uid, uid)
    assert set(fr._gates) == {1, 8}
    assert all(torch.equal(fr._gates[s], gates[s]) for s in (1, 8))
    TPT._FrameRays([0.0] * 8, origin, 36, 96, 0, 36, 8, 3, None, "cpu")
    assert len(calls) == 1


# --------------------------------------------------------------------------
# a replay of the kernel's algorithm
# --------------------------------------------------------------------------
def _replay(flags, *, v_cap=None, uid0=0, samples=1, one_launch=None):
    """partition.cu's algorithm in numpy: (channels form) the kept ids by
    row, the count; (order form, v_cap None) slot, pix_uid and the gates.
    Tiles of TILE flags, 8 warps of TILE / 256 rounds of 32 lanes; the
    tile's offset from counted flags (one launch) or the tile counts."""
    n = flags.size
    f = flags != 0
    ntiles = -(-n // PTN.TILE)
    one = n <= PTN.ONE_LAUNCH if one_launch is None else one_launch
    pad = np.zeros(ntiles * PTN.TILE, bool)
    pad[:n] = f
    tile_counts = pad.reshape(ntiles, PTN.TILE).sum(axis=1)
    total = int(f.sum())
    if not one:
        assert int(tile_counts.sum()) == total
    slot = np.full(n, -1, np.int64)
    rows = {}
    lanes = np.arange(32)
    below = (1 << lanes) - 1
    rounds = PTN.TILE // 256
    for b in range(ntiles):
        # one launch: the flags before the tile counted directly
        before = int(f[:b * PTN.TILE].sum()) if one else int(
            tile_counts[:b].sum())
        ballots = pad[b * PTN.TILE:(b + 1) * PTN.TILE].reshape(8, rounds, 32)
        masks = (ballots * (1 << lanes)).sum(axis=2)  # [warp, round]
        wcnt = ballots.sum(axis=(1, 2))
        for w in range(8):
            s = before + int(wcnt[:w].sum())
            for j in range(rounds):
                i = b * PTN.TILE + w * 32 * rounds + j * 32 + lanes
                m = int(masks[w, j])
                r = s + np.array([bin(m & int(x)).count("1") for x in below])
                setb = ((m >> lanes) & 1).astype(bool)
                ok = i < n
                if v_cap is None:
                    pos = np.where(setb, r, total + (i - r))
                    slot[pos[ok]] = i[ok]
                else:
                    keep = ok & setb & (r < v_cap)
                    rows.update(zip(r[keep].tolist(), i[keep].tolist()))
                s += bin(m).count("1")
    if v_cap is not None:
        kept = min(total, v_cap)
        cidx = np.full(v_cap, n, np.int64)
        for r, i in rows.items():
            cidx[r] = i
        assert sorted(rows) == list(range(kept))
        return cidx, total
    gates = {}
    for smp in {1, samples}:
        nb = -(-(smp * n) // 1024)
        g = np.zeros(nb, np.int32)
        for q in range(nb):  # the kernel's closed form
            lo = q * 1024
            ln = min(lo + 1024, smp * n) - lo
            r0 = lo % n
            g[q] = total > 0 and (ln >= n or r0 < total or r0 + ln > n)
        gates[smp] = g
    return slot, slot + uid0, gates, total


@pytest.mark.parametrize("n", REPLAY_SIZES)
def test_replay_of_the_order_form_equals_plain(n):
    """The kernel's tiles, ballots, offsets and gate formula give the plain
    version's slot, pix_uid and gates of 1 and 8 samples, in the one- and
    the two-launch forms."""
    flags = partition_mask(n, 0.4, seed=n)
    slot, uid, gates = PTN.stable_order_ref(torch.from_numpy(flags), 77, 8)
    for one in {n <= PTN.ONE_LAUNCH, False}:
        r_slot, r_uid, r_gates, total = _replay(flags, uid0=77, samples=8,
                                                one_launch=one)
        assert total == int(flags.sum())
        np.testing.assert_array_equal(r_slot, slot.numpy())
        np.testing.assert_array_equal(r_uid, uid.numpy())
        for s in (1, 8):
            np.testing.assert_array_equal(r_gates[s], gates[s].numpy())


@pytest.mark.parametrize("n", REPLAY_SIZES)
def test_replay_of_the_channels_form_equals_plain(n):
    """The kernel's kept rows (set flags ranked below v_cap) and fill give
    the plain version's cidx and count at v_cap n, below the valid count
    and above n."""
    flags = partition_mask(n, 0.6, seed=n + 1)
    ch = {k: torch.zeros(n) for k in PTN.COMPACT_KEYS}
    ch["valid"] = torch.from_numpy(flags)
    for v_cap in {n, max(1, int(flags.sum()) // 2), n + 4096}:
        _cch, cidx, n_valid = PTN.compact_channels_ref(ch, v_cap)
        r_cidx, total = _replay(flags, v_cap=v_cap)
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
    """One launch up to ONE_LAUNCH flags, two above."""
    assert [PTN.launches_of(n) for n in (1, 2048, 29768, 32768, 32769,
                                         137288, 518400)] == \
        [1, 1, 1, 1, 2, 2, 2]
