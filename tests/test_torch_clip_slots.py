"""The raster front end's launches that took K1's (``fma32``) two largest
call sites, on the CPU.

X4's slots form, ``ops/raster_clip.clip_screen_slots``: the fused-shading
path's clip, screen setup and attribute slots (normals, colors and
positions rotated and lerped as the clip moved each vertex) in one launch
on the card. Its plain version is ``clip_screen_ref`` followed by
``clip_attrs_channel_lists``, and it equals the JAX package's compiled
``setup_screen_channels(transform_clip_channels[9](...))`` and
``clip_attrs_channel_lists`` bit for bit on seeded soups at the near plane
in which every rotation and clip case occurs. ``render_soup(method=
"fused")`` takes it, and its frames stay within JAX's bound.

Generation 2's setup through B2 (``backends/raster_oracles.
subtile2_setup``): the channel dict is row views of B2's padded output cut
to the T slots, equal to JAX's ``setup_2dh`` bit for bit at T = 1,000
(B2 pads to 1,024), and its one pack reads B2's rows in place and equals
the pack of the stacked channels. The kernels themselves are held to
these plain versions on the card (``tests/test_torch_build_xla.py``,
``chip_smoke.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.backends import raster as JR
from ascii_renderer_tpu.core.camera import Camera as JCam
from ascii_renderer_tpu.scene.builder import SceneBuilder as JSB
from ascii_renderer_tpu_torch.backends import raster as R
from ascii_renderer_tpu_torch.backends import raster_oracles as RO
from ascii_renderer_tpu_torch.backends.raster_common import _round_up
from ascii_renderer_tpu_torch.core.camera import Camera
from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.ops import pack as PK
from ascii_renderer_tpu_torch.ops import plane_table as PT
from ascii_renderer_tpu_torch.ops import raster_clip as RCL
from ascii_renderer_tpu_torch.ops import setup2dh as S
from ascii_renderer_tpu_torch.scene.builder import SceneBuilder as TSB
from ascii_renderer_tpu_torch.tools.xla_inputs import (FRONT_CAM,
                                                       front_soup,
                                                       shade_builder)

torch.set_num_threads(2)

ROWS, COLS = 36, 96
SETUP_CAM = dict(pos=(2.5, 1.5, 3.0), yaw=-2.3, pitch=-0.3)


def _same(got, want, what=""):
    """Bit for bit, NaN in the same places (payloads aside)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype != np.float32:
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=what)
        return
    assert got.dtype == np.float32, what
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32), err_msg=what)


def _mvp():
    return R.camera_mvp(Camera.create(**FRONT_CAM), ROWS, COLS, 0.5)


def _soup(T, seed):
    """(positions, normals, colors) f32 numpy of a front_soup of T
    triangles: unit normals and colours in [0, 1] from its attributes."""
    p, a = front_soup(T, _mvp().numpy(), seed=seed)
    n = a[:, :3] / np.linalg.norm(a[:, :3], axis=1, keepdims=True)
    return p, n.astype(np.float32), np.abs(a[:, 3:6])


def _src(p, layout):
    t = torch.from_numpy(p)
    return R.positions_to_pos9(t) if layout == "pos9" else t


# --------------------------------------------------------------------------
# X4's slots form
# --------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["positions", "pos9"])
@pytest.mark.parametrize("T", [1, 255, 300])
def test_slots_form_cpu_is_the_plain_chain(T, layout):
    """On CPU tensors clip_screen_slots is clip_screen_ref, then
    clip_attrs_channel_lists of the uncompacted dict over [normals,
    colors, positions] (pos9's rows turned back into positions exactly):
    the dict and the 3 x 9 slot channels [2T] bit for bit."""
    p, n, c = _soup(T, seed=T)
    src = _src(p, layout)
    mvp = _mvp()
    ch, slots = RCL.clip_screen_slots(src, torch.from_numpy(n),
                                      torch.from_numpy(c), mvp, ROWS, COLS,
                                      pos9=layout == "pos9")
    want_ch = RCL.clip_screen_ref(src, mvp, ROWS, COLS,
                                  pos9=layout == "pos9")
    attrs = torch.from_numpy(np.concatenate([n, c, p], axis=1))
    want = PT.clip_attrs_channel_lists(attrs, want_ch)
    assert list(ch) == list(want_ch)
    for k, v in want_ch.items():
        _same(ch[k].numpy(), v.numpy(), what=k)
    assert [len(s) for s in slots] == [RCL.TABLE_ATTRS] * 3
    for s in range(3):
        for j in range(RCL.TABLE_ATTRS):
            assert tuple(slots[s][j].shape) == (2 * T,)
            _same(slots[s][j].numpy(), want[s][j].numpy(),
                  what=f"slot {s} attribute {j}")


@pytest.fixture(scope="module", params=[300, 1000], ids=["T300", "T1000"])
def jax_slots(request):
    """A near-plane soup of T triangles (2T not a multiple of 128 at 300)
    and the JAX package's compiled clip dicts (both vertex layouts) and
    attribute slots over [normals, colors, positions]."""
    T = request.param
    p, n, c = _soup(T, seed=T + 5)
    mvp_j = jax.jit(lambda cam: JR.camera_mvp(cam, ROWS, COLS, 0.5))(
        JCam.create(**FRONT_CAM))
    np.testing.assert_array_equal(np.asarray(mvp_j), _mvp().numpy())
    attrs = jnp.asarray(np.concatenate([n, c, p], axis=1))

    def clip(src, mm, pos9):
        return JR.setup_screen_channels(
            (JR.transform_clip_channels9 if pos9
             else JR.transform_clip_channels)(src, mm), ROWS, COLS)

    out = {}
    for layout in ("positions", "pos9"):
        src = (JR.positions_to_pos9(jnp.asarray(p)) if layout == "pos9"
               else jnp.asarray(p))
        # compiled as the suite's own front-end tests compile them: the
        # clip, then the slots from its dict
        ch = jax.jit(functools.partial(clip, pos9=layout == "pos9"))(
            src, mvp_j)
        slots = jax.jit(JR.clip_attrs_channel_lists)(attrs, dict(ch))
        out[layout] = ({k: np.array(v) for k, v in ch.items()},
                       [[np.array(x) for x in s] for s in slots])
    return (p, n, c), out


@pytest.mark.parametrize("layout", ["positions", "pos9"])
def test_slots_form_equals_jax(jax_slots, layout):
    """clip_screen_slots' dict and attribute slots equal JAX's compiled
    clip and setup and clip_attrs_channel_lists: keys, dtypes and bits,
    NaN in the same places, no sign of zero folded (the reference's
    transpose of the attributes is an exact copy). Every rotation, every
    count of inside vertices (0: the slot is culled) and both clip outputs
    occur."""
    (p, n, c), out = jax_slots
    jch, jslots = out[layout]
    T = p.shape[0] // 3
    ch, slots = RCL.clip_screen_slots(
        _src(p, layout), torch.from_numpy(n), torch.from_numpy(c), _mvp(),
        ROWS, COLS, pos9=layout == "pos9")
    assert set(ch) == set(jch)
    for k, want in jch.items():
        _same(ch[k].numpy(), want, what=k)
    assert {0, 1, 2, 3} <= set(ch["n_in"].tolist())
    assert {0, 1, 2} <= set(ch["rot"][(ch["n_in"] == 1)].tolist())
    assert {0, 1, 2} <= set(ch["rot"][(ch["n_in"] == 2)].tolist())
    assert 0 < int(ch["valid"][T:].sum()) < int(ch["valid"].sum())
    assert [len(s) for s in jslots] == [len(s) for s in slots] == [9] * 3
    for s in range(3):
        for j in range(9):
            _same(slots[s][j].numpy(), jslots[s][j],
                  what=f"slot {s} attribute {j}")


def _meta_inputs(T=40):
    p, n, c = _soup(T, seed=5)
    meta = torch.device("meta")
    return tuple(torch.from_numpy(x).to(meta) for x in (p, n, c))


@pytest.mark.parametrize("case", ["positions", "pos9", "normals_short",
                                  "colors_f64", "src_f64"])
def test_slots_form_never_falls_back(monkeypatch, case):
    """Tensors that are not on the CPU reach the kernel path, whose checks
    raise ValueError for anything but float32 CUDA tensors of the shapes
    the kernel takes; no call reaches the plain version and nothing
    launches."""
    p, n, c = _meta_inputs()
    calls = []
    monkeypatch.setattr(RCL, "clip_screen_slots_ref",
                        lambda *a, **k: calls.append(a))
    monkeypatch.setattr(RCL, "launches", 0)
    monkeypatch.setattr(RCL, "launches_slots", 0)
    src, pos9 = p, False
    if case == "pos9":
        src, pos9 = R.positions_to_pos9(p), True
    elif case == "normals_short":
        n = n[:-3]
    elif case == "colors_f64":
        c = c.double()
    elif case == "src_f64":
        src = p.double()
    with pytest.raises(ValueError):
        RCL.clip_screen_slots(src, n, c, _mvp(), ROWS, COLS, pos9=pos9)
    assert calls == []
    assert (RCL.launches, RCL.launches_slots) == (0, 0)


class _FailingLib:
    """A kernel library whose every launch reports a CUDA error."""

    def __getattr__(self, name):
        return lambda *args: 700  # cudaErrorIllegalAddress


def test_slots_form_raises_on_build_or_launch_failure(monkeypatch):
    """Past the device checks, a failed build and a failed launch each
    raise out of clip_screen_slots; it never falls back to the plain
    version. The failed launch is counted as X4's and as the slots
    form's."""
    p, n, c = _meta_inputs()
    calls = []
    monkeypatch.setattr(RCL, "clip_screen_slots_ref",
                        lambda *a, **k: calls.append(a))
    monkeypatch.setattr(RCL, "launches", 0)
    monkeypatch.setattr(RCL, "launches_slots", 0)
    monkeypatch.setattr(_build, "require_cuda", lambda *t, what: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)

    def no_build():
        raise RuntimeError("nvcc failed")

    for lib, match in ((no_build, "nvcc failed"),
                       (lambda: _FailingLib(), "launch failed")):
        monkeypatch.setattr(_build, "lib", lib)
        with pytest.raises(RuntimeError, match=match):
            RCL.clip_screen_slots(p, n, c, _mvp(), ROWS, COLS)
    assert calls == []
    assert (RCL.launches, RCL.launches_slots) == (1, 1)


@pytest.mark.parametrize("T", [256, 300], ids=["2T_512", "2T_600"])
def test_fused_frame_takes_the_slots_form_and_equals_jax(monkeypatch, T):
    """render_soup(method="fused") takes its clip, setup and attribute
    slots from one clip_screen_slots call (no clip_screen call), and its
    frame of a near-plane soup under a directional and two point lights
    stays within 1e-5 of JAX's fused frame, the bound
    tests/test_torch_raster_oracles.py holds the demo room's to."""
    p, n, c = _soup(T, seed=T + 7)
    calls = []
    for name in ("clip_screen_slots", "clip_screen", "clip_screen_table"):
        def rec(*a, _real=getattr(RCL, name), _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(RCL, name, rec)
    scene = shade_builder(TSB, True, 2).build(device="cpu")
    got = R.render_soup(torch.from_numpy(p), torch.from_numpy(n),
                        torch.from_numpy(c), scene, Camera.create(
                            **FRONT_CAM), ROWS, COLS, 0.5, method="fused")
    assert calls == ["clip_screen_slots"]
    jscene = shade_builder(JSB, True, 2).build()
    want = np.array(jax.jit(functools.partial(
        JR.render_soup, rows=ROWS, cols=COLS, pixel_aspect=0.5,
        method="fused"))(jnp.asarray(p), jnp.asarray(n), jnp.asarray(c),
                         jscene, JCam.create(**FRONT_CAM)))
    assert tuple(got.shape) == want.shape == (ROWS, COLS, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert (got.numpy().max(-1) > 0).sum() > 100


# --------------------------------------------------------------------------
# generation 2's setup through B2
# --------------------------------------------------------------------------
def _setup_inputs(T, n_attrs, seed=5):
    """(pos9 [9, T], attrs_t [3A, T], mvp [4, 4]) f32 numpy of a random
    soup at SETUP_CAM (48 x 96)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2, 2, (3 * T, 3)).astype(np.float32)
    nrm = rng.normal(size=(3 * T, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    col = rng.uniform(0.2, 1.0, (3 * T, 3)).astype(np.float32)
    attrs = np.concatenate([nrm, col] + ([pos] if n_attrs == 9 else []),
                           axis=1)
    pos9 = np.ascontiguousarray(
        pos.reshape(T, 3, 3).transpose(1, 2, 0).reshape(9, T))
    attrs_t = np.ascontiguousarray(attrs.reshape(T, 3 * n_attrs).T)
    mvp = np.array(JR.camera_mvp(JCam.create(**SETUP_CAM), 48, 96, 0.5))
    return pos9, attrs_t, mvp


@pytest.mark.parametrize("n_attrs", [6, 9])
def test_subtile2_setup_is_b2_views_equal_to_jax(n_attrs):
    """subtile2_setup's dict holds [T] row views of B2's one padded output
    (T = 1,000, padded to 1,024), and equals JAX's compiled setup_2dh bit
    for bit: every plane, the bbox, valid. Its block is B2's first 16 + 3A
    + 3 rows cut to T: the walk planes, the float ids, three zero rows and
    the shade planes."""
    T = 1000
    pos9, attrs_t, mvp = _setup_inputs(T, n_attrs)
    ach, block = RO.subtile2_setup(torch.from_numpy(pos9),
                                   torch.from_numpy(attrs_t),
                                   torch.from_numpy(mvp), 48, 96)
    want = jax.jit(JR.setup_2dh, static_argnums=(3, 4))(
        jnp.asarray(pos9), jnp.asarray(attrs_t), jnp.asarray(mvp), 48, 96)
    assert set(ach) == set(want)
    for k, v in want.items():
        assert tuple(ach[k].shape) == (T,), k
        _same(ach[k].numpy(), np.asarray(v), what=k)
    assert 100 < int(ach["valid"].sum()) < T
    n_g = S.n_channels(n_attrs)
    assert tuple(block.shape) == (n_g, T) and block.stride() == (1024, 1)
    base = block.untyped_storage().data_ptr()
    for k in ("e0a", "zc", "p0a", "dnc"):
        assert ach[k].untyped_storage().data_ptr() == base, k
    for k in ("bx0", "by1"):  # the bbox rows of the same output
        assert ach[k].untyped_storage().data_ptr() == base, k
    np.testing.assert_array_equal(block[12].numpy(),
                                  np.arange(T, dtype=np.float32))
    assert not block[13:16].any() and not torch.signbit(block[13:16]).any()


def _old_subtile2_front(pos9, attrs_t, mvp, A, rows, cols):
    """The generation-2 setup and pack as the port ran them before B2
    took the setup: setup_channels, then one pack of the stacked walk
    planes, ids, zeros and shade planes."""
    ach = S.setup_channels(pos9, attrs_t, mvp, rows, cols)
    T = pos9.shape[1]
    zero = torch.zeros((T,), dtype=torch.float32)
    chans = ([ach[k] for k in RO._WALK_KEYS]
             + [torch.arange(T, dtype=torch.float32), zero, zero, zero]
             + [ach[k] for k in S._plane_keys(A)])
    return ach, PK.pack_channels(chans, width=_round_up(16 + 3 * A + 3, 8))


@pytest.mark.parametrize("n_attrs", [6, 9])
def test_subtile2_pack_keys_and_counts_equal_the_old_chain(n_attrs):
    """Through B2 the generation-2 pack (one pack of B2's rows, read in
    place), the pair keys and the diag counts equal those of the chain it
    replaced
    (setup_channels and a pack of the stacked channels), bit for bit, at
    T = 1,000."""
    T, rows, cols = 1000, 48, 96
    pos9, attrs_t, mvp = (torch.from_numpy(x) for x in _setup_inputs(
        T, n_attrs, seed=7))
    ach, block = RO.subtile2_setup(pos9, attrs_t, mvp, rows, cols)
    g40 = PK.pack_channels(block, width=_round_up(block.shape[0], 8))
    old_ach, old_g40 = _old_subtile2_front(pos9, attrs_t, mvp, n_attrs,
                                           rows, cols)
    assert tuple(g40.shape) == (T, _round_up(16 + 3 * n_attrs + 3, 8))
    _same(g40.numpy(), old_g40.numpy(), what="g40")
    for big_cap in (0, 64):
        assert torch.equal(
            R._subtile_pair_keys_bbox(ach, rows, cols, big_cap=big_cap),
            R._subtile_pair_keys_bbox(old_ach, rows, cols, big_cap=big_cap))
    assert [int(x) for x in R.count_big_small_bbox(ach, rows, cols)] == [
        int(x) for x in R.count_big_small_bbox(old_ach, rows, cols)]
    assert int(ach["valid"].sum()) == int(old_ach["valid"].sum()) > 100


def test_subtile2_frame_takes_b2_and_equals_jax(monkeypatch):
    """render_soup_diag(kernel="subtile2") makes one B2 call
    (setup_2dh_fused, not the plain setup_2dh) and packs B2's row block
    itself (one pack_channels call on a [C, T] tensor, no list of
    channels), and its diag counts equal JAX's and its frame stays within
    1e-5 of JAX's, the bounds tests/test_torch_raster_oracles.py holds
    generation 2 to, at T = 1,000 (B2 pads to 1,024)."""
    T = 1000
    rng = np.random.default_rng(11)
    p = rng.uniform(-2, 2, (3 * T, 3)).astype(np.float32)
    n = rng.normal(size=(3 * T, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    c = rng.uniform(0.2, 1.0, (3 * T, 3)).astype(np.float32)
    calls = []
    real_b2, real_pack = S.setup_2dh_fused, RO.pack_channels

    def b2(*a, **k):
        calls.append("setup_2dh_fused")
        return real_b2(*a, **k)

    def pack(chans, **k):
        calls.append(("pack_channels", type(chans).__name__,
                      tuple(chans.shape)))
        return real_pack(chans, **k)

    def plain(*a, **k):
        raise AssertionError("the plain setup_2dh ran")

    monkeypatch.setattr(S, "setup_2dh_fused", b2)
    monkeypatch.setattr(RO, "pack_channels", pack)
    monkeypatch.setattr(R, "setup_2dh", plain)
    scene = shade_builder(TSB, True, 2).build(device="cpu")
    caps = dict(v_cap=2048, big_cap=1024, r_cap=16384,
                pair_cap=8 * T + 1024 * 48 * 8)
    rgb, diag = R.render_soup_diag(
        torch.from_numpy(p), torch.from_numpy(n), torch.from_numpy(c),
        scene, Camera.create(**SETUP_CAM), 48, 96, 0.5, kernel="subtile2",
        **caps)
    A = 9  # the scene has point lights: world-position planes
    assert calls == ["setup_2dh_fused",
                     ("pack_channels", "Tensor", (16 + 3 * A + 3, T))]
    jscene = shade_builder(JSB, True, 2).build()
    j_rgb, j_diag = jax.jit(functools.partial(
        JR.render_soup_diag, rows=48, cols=96, pixel_aspect=0.5,
        kernel="subtile2", **caps))(jnp.asarray(p), jnp.asarray(n),
                                    jnp.asarray(c), jscene,
                                    JCam.create(**SETUP_CAM))
    keys = ("n_valid", "n_big", "n_rows", "n_pairs", "n_tiles_nz")
    assert {k: int(diag[k]) for k in keys} == {k: int(j_diag[k])
                                               for k in keys}
    np.testing.assert_allclose(rgb.numpy(), np.asarray(j_rgb), rtol=0,
                               atol=1e-5)
    assert (rgb.numpy().max(-1) > 0).sum() > 500


def test_pack_reads_the_rows_of_a_wider_block_in_place():
    """The pack's kernel path takes a [C, T] slice of a [C, Tp] block as
    it lies (rows of unit stride, Tp apart); a transposed or overlapping
    input is copied first. The plain version packs the slice as it packs
    the contiguous copy."""
    blk = torch.arange(37 * 1024, dtype=torch.float32).reshape(37, 1024)
    view = blk[:, :1000]
    got, ld = PK._rows(view)
    assert got.data_ptr() == blk.data_ptr() and ld == 1024
    for odd in (blk.t()[:37], blk[:, ::2]):
        got, ld = PK._rows(odd)
        assert got.is_contiguous() and ld == odd.shape[1]
        assert torch.equal(got, odd)
    one, ld = PK._rows(blk[:1, :1000])
    assert ld == 1000
    _same(PK.pack_channels(view, width=40).numpy(),
          PK.pack_channels(view.contiguous(), width=40).numpy())
