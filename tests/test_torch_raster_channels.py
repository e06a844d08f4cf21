"""Port parity for the small- and mid-scale raster paths
(``backends/raster_channels``, ``render_soup``, the mid-scale
``RasterBackend``) against the JAX package compiled as its own suite runs it
(``jax.jit`` on the CPU backend, Pallas in interpret mode).

The port fuses products into adds where the compiled reference does
(core/fp.py), so the clip channels, screen setup, compaction, plane table
and winner ids are bit-identical, and every quantized byte of the frames
below is equal. Float shading is held to a few ulps: the reference's rsqrt
is a CPU estimate refined by one Newton step (core/fp.rsqrt32)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.backends import raster as JR
from ascii_renderer_tpu.core.camera import Camera as JCam
from ascii_renderer_tpu.geom import meshes as JM
from ascii_renderer_tpu.geom.tessellate import tessellate_scene as j_tess
from ascii_renderer_tpu.scene.builder import SceneBuilder as JSB
from ascii_renderer_tpu.scene.demo import create_demo_scene as j_demo
from ascii_renderer_tpu_torch.ascii import AsciiPass, chars_to_strings
from ascii_renderer_tpu_torch.backends import raster as R
from ascii_renderer_tpu_torch.backends import raster_channels as RC
from ascii_renderer_tpu_torch.core import quantize as Q
from ascii_renderer_tpu_torch.core.camera import Camera
from ascii_renderer_tpu_torch.core.config import Config
from ascii_renderer_tpu_torch.core.frame import Frame
from ascii_renderer_tpu_torch.geom import meshes
from ascii_renderer_tpu_torch.scene.builder import SceneBuilder
from ascii_renderer_tpu_torch.scene.demo import create_demo_scene

torch.set_num_threads(2)

GOLDEN_CUBE = os.path.join(os.path.dirname(__file__), "goldens",
                           "raster_cube.txt")
ROWS, COLS = 36, 96


def bits(a):
    """uint32 view with -0.0 folded into +0.0 (the reference's MXU pack
    transpose drops the sign of zero) and NaNs made equal."""
    a = np.asarray(a, np.float32) + np.float32(0)
    a = np.where(np.isnan(a), np.float32(np.nan), a)
    return a.view(np.uint32)


def assert_channels_equal(jd, td, keys=None):
    for k in keys or jd:
        j, t = np.asarray(jd[k]), td[k].numpy()
        if j.dtype == np.float32:
            np.testing.assert_array_equal(bits(t), bits(j), err_msg=k)
        else:
            np.testing.assert_array_equal(t, j, err_msg=k)


def near_plane_soup(T=400, seed=5):
    """Random triangles around a camera at z = 0.3: many straddle the near
    plane, so all clip cases (1-in, 2-in, 3-in) occur."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-2, 2, (3 * T, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(-1.5, 1.0, 3 * T)
    attrs = rng.uniform(-1, 1, (3 * T, 9)).astype(np.float32)
    return p, attrs


NEAR_CAM = dict(pos=(0.0, 0.2, 0.3), yaw=-np.pi / 2, pitch=-0.1)


@pytest.fixture(scope="module")
def near_scene():
    p, attrs = near_plane_soup()
    mvp_j = jax.jit(lambda c: JR.camera_mvp(c, ROWS, COLS, 0.5))(
        JCam.create(**NEAR_CAM))
    mvp_t = R.camera_mvp(Camera.create(**NEAR_CAM), ROWS, COLS, 0.5)
    np.testing.assert_array_equal(mvp_t.numpy(), np.asarray(mvp_j))
    return p, attrs, mvp_j, mvp_t


@pytest.mark.parametrize("stage", ["channels", "channels9"])
def test_clip_and_screen_channels_equal_jax(near_scene, stage):
    p, _attrs, mvp_j, mvp_t = near_scene
    if stage == "channels":
        src_j, src_t = jnp.asarray(p), torch.from_numpy(p)
        jfn, tfn = JR.transform_clip_channels, RC.transform_clip_channels
    else:
        pos9 = np.asarray(JR.positions_to_pos9(p))
        src_j, src_t = jnp.asarray(pos9), torch.from_numpy(pos9)
        jfn, tfn = JR.transform_clip_channels9, RC.transform_clip_channels9
    jch = jax.jit(jfn)(src_j, mvp_j)
    tch = tfn(src_t, mvp_t)
    assert_channels_equal(jch, tch)
    n_in = tch["n_in"].numpy()
    assert {1, 2, 3} <= set(n_in.tolist())  # every clip case occurs
    jsc = jax.jit(lambda s, m: JR.setup_screen_channels(jfn(s, m), ROWS,
                                                        COLS))(src_j, mvp_j)
    tsc = RC.setup_screen_channels(tfn(src_t, mvp_t), ROWS, COLS)
    assert_channels_equal(jsc, tsc)
    assert int(tsc["valid"].sum()) > 100


def test_compaction_attrs_and_plane_table_equal_jax(near_scene):
    p, attrs, mvp_j, mvp_t = near_scene
    pos9 = np.asarray(JR.positions_to_pos9(p))
    jch = jax.jit(lambda s, m: JR.setup_screen_channels(
        JR.transform_clip_channels9(s, m), ROWS, COLS))(jnp.asarray(pos9),
                                                        mvp_j)
    tch = {k: torch.from_numpy(np.asarray(v)) for k, v in jch.items()}
    jc = jax.jit(lambda ch: JR.compact_valid_ch(dict(ch), 1024))(jch)
    tc = RC.compact_valid_ch(dict(tch), 1024)
    assert_channels_equal(jc[0], tc[0])
    np.testing.assert_array_equal(tc[1].numpy(), np.asarray(jc[1]))
    assert int(tc[2]) == int(jc[2]) > 200
    jat = jax.jit(lambda a, ch, ci: JR.clip_attrs_compact_lists(
        a, dict(ch), ci))(jnp.asarray(attrs), jch, jc[1])
    tat = RC.clip_attrs_compact_lists(torch.from_numpy(attrs), tch, tc[1])
    for js, ts in zip(jat, tat):
        for j, t in zip(js, ts):
            np.testing.assert_array_equal(bits(t.numpy()), bits(j))
    jl = jax.jit(lambda a, ch: JR.clip_attrs_channel_lists(a, dict(ch)))(
        jnp.asarray(attrs), jch)
    tl = RC.clip_attrs_channel_lists(torch.from_numpy(attrs), tch)
    for js, ts in zip(jl, tl):
        for j, t in zip(js, ts):
            np.testing.assert_array_equal(bits(t.numpy()), bits(j))
    tcch = {k: torch.from_numpy(np.asarray(v)) for k, v in jc[0].items()}
    tat_j = [[torch.from_numpy(np.asarray(x)) for x in s] for s in jat]
    for A in (9, 6):  # 1024 rows: the B7 pack path
        jt = jax.jit(lambda ch, at: JR.build_plane_table(dict(ch), at))(
            jc[0], [s[:A] for s in jat])
        tt = RC.build_plane_table(tcch, [s[:A] for s in tat_j])
        assert tuple(tt.shape) == jt.shape == (1024, -(-3 * (A + 1) // 8) * 8)
        np.testing.assert_array_equal(bits(tt.numpy()), bits(jt))
    # a length that is not a multiple of 512: the stacked path
    jt = jax.jit(lambda ch, at: JR.build_plane_table(dict(ch), at))(
        jch, list(jl))
    tt = RC.build_plane_table(tch, tl)
    np.testing.assert_array_equal(bits(tt.numpy()), bits(jt))
    jn = jax.jit(lambda ch: JR.count_big_small(dict(ch), ROWS, COLS))(jc[0])
    assert [int(x) for x in RC.count_big_small(tcch, ROWS, COLS)] == \
        [int(x) for x in jn]


@pytest.mark.parametrize("kernel", ["mm", "loop"])
def test_visibility_binned_ids_equal_jax(near_scene, kernel):
    p, _attrs, mvp_j, mvp_t = near_scene
    pos9 = np.asarray(JR.positions_to_pos9(p))
    jch = jax.jit(lambda s, m: JR.setup_screen_channels(
        JR.transform_clip_channels9(s, m), ROWS, COLS))(jnp.asarray(pos9),
                                                        mvp_j)
    tch = {k: torch.from_numpy(np.asarray(v)) for k, v in jch.items()}
    jz, jt = jax.jit(lambda ch: JR.visibility_binned_ch(
        dict(ch), ROWS, COLS, kernel=kernel))(jch)
    tz, tt = RC.visibility_binned_ch(tch, ROWS, COLS, kernel=kernel)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(bits(tz.numpy()), bits(jz))
    assert int((tt >= 0).sum()) > 1000


def demo_room():
    jsb = j_demo()
    jsb.set_env_light([0.25, 0.27, 0.3], 1.0)
    jscene = jsb.build()
    sb = create_demo_scene()
    sb.set_env_light([0.25, 0.27, 0.3], 1.0)
    scene = sb.build(device="cpu")
    soup = tuple(np.asarray(x) for x in j_tess(jscene))
    return jscene, scene, soup


@pytest.fixture(scope="module")
def room():
    return demo_room()


@pytest.mark.parametrize("kw", [dict(method="scan"), dict(method="scatter"),
                                dict(method="scatter_loop"),
                                dict(method="scatter", v_cap=512)],
                         ids=["scan", "scatter", "scatter_loop", "v_cap"])
def test_render_soup_demo_room_equals_jax(room, kw):
    """The demo room from inside (near-plane clipping active) at 36x96:
    every quantized byte equal, the floats within 2 ulps."""
    jscene, scene, (p, n, c) = room
    f = jax.jit(functools.partial(JR.render_soup, rows=ROWS, cols=COLS,
                                  pixel_aspect=0.5, **kw))
    want = np.asarray(f(jnp.asarray(p), jnp.asarray(n), jnp.asarray(c),
                        jscene, jscene.camera))
    got = R.render_soup(torch.from_numpy(p), torch.from_numpy(n),
                        torch.from_numpy(c), scene, scene.camera, ROWS, COLS,
                        0.5, **kw)
    assert tuple(got.shape) == (ROWS, COLS, 3)
    np.testing.assert_array_equal(Q.float_rgb_to_u8(got).numpy(),
                                  Q.float_rgb_to_u8(torch.from_numpy(want))
                                  .numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.5e-7)
    assert (got.numpy().sum(-1) > 0).all()  # the room covers every cell


def test_render_soup_diag_counts_equal_jax(room):
    jscene, scene, (p, n, c) = room
    for v_cap in (128, 512):
        f = jax.jit(functools.partial(JR.render_soup_diag, rows=ROWS,
                                      cols=COLS, pixel_aspect=0.5,
                                      v_cap=v_cap))
        jrgb, jd = f(jnp.asarray(p), jnp.asarray(n), jnp.asarray(c), jscene,
                     jscene.camera)
        rgb, d = R.render_soup_diag(
            torch.from_numpy(p), torch.from_numpy(n), torch.from_numpy(c),
            scene, scene.camera, ROWS, COLS, 0.5, v_cap=v_cap, kernel="mm")
        assert {k: int(v) for k, v in d.items()} == \
            {k: int(v) for k, v in jd.items()}
        np.testing.assert_array_equal(
            Q.float_rgb_to_u8(rgb).numpy(),
            Q.float_rgb_to_u8(torch.from_numpy(np.asarray(jrgb))).numpy())
    assert int(d["n_valid"]) > 128  # v_cap 128 overflowed, 512 did not
    assert R.suggest_caps(257, 3) == JR.suggest_caps(257, 3)
    assert R.suggest_caps(30000, 100) == JR.suggest_caps(30000, 100)


@pytest.mark.parametrize("method", [None, "scatter", "scatter_loop"])
def test_cube_golden_through_raster_backend(method):
    """bench config 1's frame (cube, 80x24, mode filter off) through the
    port's RasterBackend (24 triangle slots: the scan path) + AsciiPass
    reproduces tests/goldens/raster_cube.txt exactly; so do the binned
    walks B6 and B6' (render_soup methods 'scatter' / 'scatter_loop')."""
    cfg = Config(pixel_aspect=0.5, grid_width=80, grid_height=24,
                 ascii_mode_filter=False)
    v, i = meshes.cube(2.0)
    p, n, c = meshes.mesh_to_soup(v, i, color=(0.85, 0.85, 0.85),
                                  smooth=False)
    sb = SceneBuilder().set_env_light([0.2, 0.22, 0.25], 1.0)
    sb.add_dir_light([-0.5, -0.7, -0.6], [1, 1, 1], 0.9)
    scene = sb.build(device="cpu")
    cam = Camera.create(pos=(2.2, 1.8, 3.2),
                        yaw=float(np.arctan2(-3.2, -2.2)), pitch=-0.42)
    if method is None:
        b = R.RasterBackend(cfg, device="cpu")
        b.set_soup(p, n, c, scene)
        frame = b.render(0.0, cam, 24, 80, 0.5)
    else:
        frame = Frame.from_float(R.render_soup(
            *(torch.from_numpy(x) for x in (p, n, c)), scene, cam, 24, 80,
            0.5, method=method))
    rows = chars_to_strings(AsciiPass(cfg)(frame)[0])
    with open(GOLDEN_CUBE) as fh:
        assert rows == fh.read().splitlines()


def teapot(rows, cols):
    v, i = JM.teapot_like(1024)
    p, n, c = JM.mesh_to_soup(v, i, color=(0.9, 0.9, 0.9))
    calls = [("set_env_light", [0.22, 0.24, 0.28], 1.0),
             ("add_dir_light", [-0.5, -0.7, -0.6], [1, 1, 1], 0.9)]
    jsb, sb = JSB(), SceneBuilder()
    for name, *args in calls:
        getattr(jsb, name)(*args)
        getattr(sb, name)(*args)
    cam = dict(pos=(1.9, 1.3, 2.7), yaw=float(np.arctan2(-2.7, -1.9)),
               pitch=-0.4)
    return (p, n, c), jsb.build(), sb.build(device="cpu"), cam


def test_teapot_mid_scale_backend_equals_jax():
    """bench config 2's scene (teapot-class, >= 2,048 slots: the compacted
    mid-scale path) at its smoke grid 34x60: the port's RasterBackend gives
    JAX's chars, including a forced v_cap overflow and retry."""
    from ascii_renderer_tpu.ascii import AsciiPass as JAsciiPass
    from ascii_renderer_tpu.backends.raster import RasterBackend as JRB
    rows, cols = 34, 60
    (p, n, c), jscene, scene, cam = teapot(rows, cols)
    assert 2048 <= p.shape[0] // 3 * 2 < 32768
    cfg = Config(pixel_aspect=0.5, grid_width=cols, grid_height=rows)
    jb = JRB(cfg)
    jb.set_soup(p, n, c, jscene)
    jchars = np.asarray(JAsciiPass(cfg)(jb.render(0.0, JCam.create(**cam),
                                                  rows, cols, 0.5))[0])
    b = R.RasterBackend(cfg, device="cpu")
    b.set_soup(p, n, c, scene)
    for first_caps in (None, (256, 64)):  # the second overflows v_cap
        b._caps = first_caps
        f = b.render(0.0, Camera.create(**cam), rows, cols, 0.5)
        chars = AsciiPass(cfg)(f)[0].numpy()
        np.testing.assert_array_equal(chars, jchars)
        assert b._caps[0] >= 512 and b._caps[0] % 8192 == 0
    assert (chars != ord("@")).sum() > 100


def test_unported_methods_raise_naming_their_roadmap_items():
    """Every method of the reference's render_soup renders in the port
    (nothing raises NotImplementedError any more): 'fused' (B8) within
    JAX's bound of the scan (tests/test_raster_channels.py:212-226), with
    or without v_cap; the channel-era 'subtile' / 'subtile2' (B9b / B9c)
    and the grouped generations through render_soup_diag with v_cap, and
    without v_cap the scan, as the reference's dispatch does
    (raster.py:716-755). An unknown render_soup_diag kernel raises
    ValueError."""
    p, attrs = near_plane_soup(50)
    scene = SceneBuilder().set_env_light([0.2, 0.2, 0.2], 1.0).build(
        device="cpu")
    args = (torch.from_numpy(p), torch.from_numpy(attrs[:, :3]),
            torch.from_numpy(attrs[:, 3:6]), scene, Camera.create(**NEAR_CAM),
            8, 16, 0.5)
    scan = R.render_soup(*args, method="scan")
    assert (scan.amax(-1) > 0).any()
    for v_cap in (None, 4096):
        fused = R.render_soup(*args, method="fused", v_cap=v_cap)
        assert (np.abs(fused - scan).amax(-1) > 1e-4).sum() == 0
    for method in ("subtile", "subtile2", "subtile3", "subtile7"):
        rgb = R.render_soup(*args, method=method, v_cap=4096, tile_cap=8)
        assert tuple(rgb.shape) == (8, 16, 3) and torch.isfinite(rgb).all()
        assert (np.abs(rgb - scan).amax(-1) > 2e-3).sum() <= 6, method
        assert torch.equal(R.render_soup(*args, method=method), scan)
    rgb, diag = R.render_soup_diag(*args, v_cap=4096, kernel="subtile")
    assert int(diag["n_valid"]) > 0 and int(diag["n_tiles_nz"]) == 1
    with pytest.raises(ValueError):
        R.render_soup_diag(*args, v_cap=4096, kernel="fused")


@pytest.mark.parametrize("band", [dict(row_lo=0, band_rows=8),
                                  dict(row_lo=0), dict(band_rows=8)])
def test_render_soup_diag_row_bands_raise_naming_a12(band):
    """JAX's render_soup_diag takes row_lo / band_rows (the row-band hook
    of ROADMAP A12, ported): a frame is banded iff band_rows is given, as
    in JAX. The grouped kernels render the band, the full frame's rows
    bit for bit (here the band is the whole 8-row frame, or row_lo 0 alone
    and no band); the channel kernels ("mm"), which JAX renders in full
    whatever the band, raise ValueError for a band."""
    p, attrs = near_plane_soup(50)
    scene = SceneBuilder().set_env_light([0.2, 0.2, 0.2], 1.0).build(
        device="cpu")
    args = (torch.from_numpy(p), torch.from_numpy(attrs[:, :3]),
            torch.from_numpy(attrs[:, 3:6]), scene, Camera.create(**NEAR_CAM),
            8, 16, 0.5)
    full, _d = R.render_soup_diag(*args, v_cap=4096, kernel="subtile8")
    got, diag = R.render_soup_diag(*args, v_cap=4096, kernel="subtile8",
                                   **band)
    assert torch.equal(got.view(torch.int32), full.view(torch.int32))
    assert int(diag["n_valid"]) > 0
    if "band_rows" in band:
        with pytest.raises(ValueError, match="grouped kernels"):
            R.render_soup_diag(*args, v_cap=4096, kernel="mm", **band)
    else:
        mm, _d = R.render_soup_diag(*args, v_cap=4096, kernel="mm", **band)
        assert tuple(mm.shape) == (8, 16, 3)
