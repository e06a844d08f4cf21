"""Port parity for the reference's retired raster generations
(``backends/raster_oracles``): the fused-shading walk B8 (``render_soup(
method="fused")``) and the channel-era subtile walks B9a / B9b / B9c
(``visibility_subtile``, ``subtile``, ``subtile2``), against the JAX package
compiled as its own suite runs it (``jax.jit`` on the CPU backend, Pallas in
interpret mode).

Builds and walks are integer / gather code plus the plane tests, written
with the reference compiler's fused multiply-adds (core/fp.py), so on the
same inputs they equal JAX exactly: every layout array, every winner id and
every depth bit. B9a and B9b round their planes differently (one test pins
it). B8's hit mask is exact; its rgb is held to 1e-5, the tolerance of the
path tracer's twins, because the reference's CPU rsqrt is an estimate
refined by one Newton step and the port's is 1 / sqrt. Whole frames are
held to the bounds the JAX suite holds these paths to
(tests/test_raster_channels.py): fused 0 pixels over 1e-4 of the scan
oracle, subtile <= 2 pixels over 1e-4 after the overflow retry, subtile2
<= 6 pixels over 2e-3."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.backends import raster as JR
from ascii_renderer_tpu.core.camera import Camera as JCam
from ascii_renderer_tpu.geom.tessellate import tessellate_scene as j_tess
from ascii_renderer_tpu.ops import raster_bins as JRB
from ascii_renderer_tpu.ops import raster_subtile as JRS
from ascii_renderer_tpu.scene.builder import SceneBuilder as JSB
from ascii_renderer_tpu.scene.demo import create_demo_scene as j_demo
from ascii_renderer_tpu_torch.backends import raster as R
from ascii_renderer_tpu_torch.backends import raster_oracles as RO
from ascii_renderer_tpu_torch.core.camera import Camera
from ascii_renderer_tpu_torch.ops import raster_bins as RB
from ascii_renderer_tpu_torch.ops import raster_subtile as RS
from ascii_renderer_tpu_torch.scene.builder import SceneBuilder
from ascii_renderer_tpu_torch.scene.demo import create_demo_scene

torch.set_num_threads(2)

TILES_X, N_TILES = 4, 8  # tile x offsets 0 .. 384: 384 * A is not exact


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# Builders and walks on random plane entries
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _entries(seed=0, V=400):
    """Random small triangles over a 4 x 2 tile grid as global-coordinate
    walk entries src f32 [V+1, 16] (some depth planes repeated for ties),
    the sorted pair keys of the bins their bboxes overlap (plus dead
    keys), and src32 with the triangle id in channel 12."""
    rng = np.random.default_rng(seed)
    tiles_y = N_TILES // TILES_X
    src = np.zeros((V + 1, 16), np.float32)
    keys = []
    for v in range(V):
        ty, tx = divmod(int(rng.integers(0, N_TILES)), TILES_X)
        cx, cy = tx * 128 + rng.uniform(4, 124), ty * 8 + rng.uniform(1, 7)
        pts = np.stack([cx + rng.uniform(-30, 30, 3),
                        cy + rng.uniform(-9, 9, 3)], 1)
        d1, d2 = pts[1] - pts[0], pts[2] - pts[0]
        if d1[0] * d2[1] - d1[1] * d2[0] > 0:
            pts = pts[::-1]
        plane = []
        for k in range(3):
            (x1, y1), (x2, y2) = pts[(k + 1) % 3], pts[(k + 2) % 3]
            plane += [-(y2 - y1), x2 - x1, (y2 - y1) * x1 - (x2 - x1) * y1]
        zx, zy = rng.normal() * 3e-3, rng.normal() * 2e-2
        src[v, :12] = plane + [zx, zy, rng.uniform(0.05, 0.95) - zx * cx
                               - zy * cy]
        if v and rng.random() < 0.2:
            src[v, 9:12] = src[v - 1, 9:12]
        x0, x1 = (int(np.floor(f(pts[:, 0]) / 16)) for f in (np.min, np.max))
        y0, y1 = (int(np.floor(f(pts[:, 1]) / 8)) for f in (np.min, np.max))
        for ty_ in range(max(y0, 0), min(y1, tiles_y - 1) + 1):
            for sc in range(max(x0, 0), min(x1, TILES_X * 8 - 1) + 1):
                keys.append(((ty_ * TILES_X * 8 + sc) << 18) | v)
    keys += [((N_TILES * 8) << 18) | v for v in range(20)]  # dead pairs
    keys = np.sort(np.asarray(keys, np.int64)).astype(np.int32)
    src32 = np.concatenate([src, np.zeros_like(src)], axis=1)
    src32[:, 12] = np.arange(V + 1)
    return src, keys, src32


CAPS = {"generous": (512, 1 << 30), "overflow": (64, 300)}  # r_cap, pair_cap


def _build(mod, name, caps, entry):
    src, keys, src32 = _entries()
    r_cap, pair_cap = CAPS[caps]
    if mod is JRS:
        src, keys, src32 = (jnp.asarray(x) for x in (src, keys, src32))
    else:
        src, keys, src32 = _t(src), _t(keys), _t(src32)
    if name == "build_packed_rows_pre_id":
        return mod.build_packed_rows_pre_id(src32, keys, TILES_X, N_TILES,
                                            r_cap, pair_cap)
    return getattr(mod, name)(src, keys, TILES_X, N_TILES, r_cap, pair_cap,
                              entry=entry)


BUILDS = [("build_subtile_rows", "tri"), ("build_subtile_rows", "pair"),
          ("build_packed_rows", "tri"), ("build_packed_rows", "pair"),
          ("build_packed_rows_pre_id", None)]


@pytest.mark.parametrize("caps", sorted(CAPS))
@pytest.mark.parametrize("name,entry", BUILDS)
def test_builder_equals_jax(name, entry, caps):
    want = _build(JRS, name, caps, entry)
    got = _build(RS, name, caps, entry)
    assert len(got) == len(want)
    for i, (w, g) in enumerate(zip(want, got)):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, (name, i)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{name}[{i}]")
    n_rows, n_pairs = int(got[-2]), int(got[-1])
    if caps == "overflow":  # the counts report what was dropped
        assert n_rows > CAPS[caps][0] and n_pairs > CAPS[caps][1]


WALKS = {  # walk -> (builder, JAX walk, port walk)
    "B9a": ("build_subtile_rows", JRS.tile_eval_subtile, RS.tile_eval_subtile),
    "B9b": ("build_packed_rows", JRS.tile_eval_packed, RS.tile_eval_packed),
    "B9c": ("build_packed_rows_pre_id", JRS.tile_eval_packed_d,
            RS.tile_eval_packed_d),
}


def _jax_walk(walk, caps):
    name, j_walk, _ = WALKS[walk]
    lay = _build(JRS, name, caps, "tri")
    args = lay[:3] if walk == "B9c" else lay[:2]
    f = jax.jit(lambda *a: j_walk(*a, TILES_X, N_TILES, interpret=True))
    return [np.asarray(x) for x in args], f(*args)


@pytest.mark.parametrize("caps", sorted(CAPS))
@pytest.mark.parametrize("walk", sorted(WALKS))
def test_walk_ref_equals_jax_kernel(walk, caps):
    """Each walk's plain version against JAX's Pallas walk (interpret
    mode) on JAX's layout: winner ids and depth bits equal, at a generous
    r_cap and at one that overflows (clamped chunk starts)."""
    args, (z_j, e_j) = _jax_walk(walk, caps)
    z_t, e_t = WALKS[walk][2](*[_t(a) for a in args], TILES_X, N_TILES)
    assert e_t.shape == (N_TILES, 8, 128)
    assert int((e_t >= 0).sum()) > (5000 if caps == "generous" else 500)
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    np.testing.assert_array_equal(_bits(z_t.numpy()), _bits(z_j))


def test_b9a_and_b9b_round_their_planes_differently():
    """Same winners (tests/test_pallas_kernels.py:215-266), but B9a
    rounds fma(A, x, B*y) + G and B9b the expand dot's A*(l + 0.5) + G
    before the tile offset: z differs in the last bits on many pixels, and
    each plain version follows its own reference."""
    ze, ee = RS.tile_eval_subtile(*_build(RS, "build_subtile_rows",
                                          "generous", "tri")[:2], TILES_X,
                                  N_TILES)
    zp, ep = RS.tile_eval_packed(*_build(RS, "build_packed_rows",
                                         "generous", "tri")[:2], TILES_X,
                                 N_TILES)
    assert torch.equal(ee, ep)
    hit = ee >= 0
    assert int((ze[hit] != zp[hit]).sum()) > 1000
    assert torch.allclose(ze[hit], zp[hit], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# B8, the fused-shading walk
# ---------------------------------------------------------------------------
def _room_scenes(point_light=False):
    jsb, sb = j_demo(), create_demo_scene()
    for b in (jsb, sb):
        b.set_env_light([0.25, 0.27, 0.3], 1.0)
        if point_light:
            b.add_point_light([1.0, 2.0, 1.0], [1.0, 0.9, 0.8], 1.0)
    return jsb.build(), sb.build(device="cpu")


def _rand_soup(T, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2, 2, (3 * T, 3)).astype(np.float32)
    nrm = rng.normal(size=(3 * T, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    col = rng.uniform(0.2, 1.0, (3 * T, 3)).astype(np.float32)
    return pos, nrm, col


CAM = dict(pos=(2.5, 1.5, 3.0), yaw=-2.3, pitch=-0.3)
NEAR_CAM = dict(pos=(0.0, 1.0, 2.0), yaw=-1.57, pitch=-0.5)
DIR_SCENE = [("set_env_light", [0.2, 0.2, 0.25], 1.0),
             ("add_dir_light", [-0.5, -0.7, -0.6], [1, 1, 1], 0.9)]
POINT_SCENE = [("set_env_light", [0.15, 0.15, 0.2], 1.0),
               ("add_point_light", [1.0, 2.0, 1.0], [1.0, 0.9, 0.8], 1.0)]


def build_scene(builder_cls, calls):
    sb = builder_cls()
    for name, *args in calls:
        getattr(sb, name)(*args)
    return sb.build(device="cpu") if builder_cls is SceneBuilder else \
        sb.build()


@functools.lru_cache(maxsize=None)
def _b8_inputs(case):
    """B8's entries, offsets and light vector from the port's builders on
    JAX's clip channels and attribute slots: the demo room at 96x36 (with
    and without a point light), and a random soup with a point light at
    384x48 (three tiles across)."""
    if case == "random_point_light":
        (p, n, c), rows, cols = _rand_soup(1500, 9), 48, 384
        jscene = build_scene(JSB, POINT_SCENE)
        scene, cam = build_scene(SceneBuilder, POINT_SCENE), JCam.create(**CAM)
    else:
        jscene, scene = _room_scenes(case == "room_point_light")
        p, n, c = (np.asarray(x) for x in j_tess(jscene))
        cam, rows, cols = jscene.camera, 36, 96

    def chans(p, n, c, cam):
        mvp = JR.camera_mvp(cam, rows, cols, 0.5)
        ch = JR.setup_screen_channels(JR.transform_clip_channels(p, mvp),
                                      rows, cols)
        return ch, JR.clip_attrs_channel_lists(
            jnp.concatenate([n, c, p], axis=1), ch)

    ch, slots = jax.jit(chans)(p, n, c, cam)
    ch = {k: _t(v) for k, v in ch.items()}
    slots = [[_t(a) for a in s] for s in slots]
    data, offsets, tiles_y, tiles_x = RO.fused_entries(ch, slots, rows, cols)
    return data, offsets, RO.light_params(scene), tiles_x, tiles_y * tiles_x


def _jax_shaded(data, offsets, lp, tiles_x, n_tiles):
    f = jax.jit(lambda d, o, l: JRB.tile_eval_bins_shaded(
        d, o, l, tiles_x, n_tiles, interpret=True))
    return np.asarray(f(data.numpy(), offsets.numpy(), lp.numpy()))


@pytest.mark.parametrize("case", ["room", "room_point_light",
                                  "random_point_light"])
def test_shaded_walk_ref_equals_jax_kernel(case):
    data, offsets, lp, tiles_x, n_tiles = _b8_inputs(case)
    assert float(lp[9]) == (0.0 if case == "room" else 1.0)
    want = _jax_shaded(data, offsets, lp, tiles_x, n_tiles)
    got = RB.tile_eval_bins_shaded(data, offsets, lp, tiles_x, n_tiles)
    assert got.shape == want.shape == (n_tiles, 3, 8, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the hit mask, exactly: with white attributes and an ambient of 4
    # every hit pixel clamps to 1 and every other is 0
    white = data.view(-1, RB.NS_CHAN).clone()
    for slot in range(3):
        white[:, RB.S_ATTR + 9 * slot + 3:RB.S_ATTR + 9 * slot + 6] = 1.0
    white = white.view_as(data)
    lp1 = lp.clone()
    lp1[0:3] = 4.0
    hit_j = _jax_shaded(white, offsets, lp1, tiles_x, n_tiles)
    hit_t = RB.tile_eval_bins_shaded(white, offsets, lp1, tiles_x, n_tiles)
    assert set(np.unique(hit_j)) <= {0.0, 1.0}
    np.testing.assert_array_equal(hit_t.numpy(), hit_j)
    assert (hit_j > 0).sum() > 3000


# ---------------------------------------------------------------------------
# Whole frames on JAX's own scenes, within JAX's own bounds
# ---------------------------------------------------------------------------
def _jax_render(p, n, c, jscene, jcam, rows, cols, fn=None, **kw):
    f = jax.jit(functools.partial(fn or JR.render_soup, rows=rows,
                                  cols=cols, pixel_aspect=0.5, **kw))
    return f(jnp.asarray(p), jnp.asarray(n), jnp.asarray(c), jscene, jcam)


@pytest.mark.parametrize("point_light", [False, True])
def test_fused_frame_matches_scan_and_jax(point_light):
    """tests/test_raster_channels.py:212-226 on the port: the demo room at
    36x96, fused against JAX's scan oracle (0 pixels over 1e-4), and
    against JAX's own fused frame (within 1e-5)."""
    jscene, scene = _room_scenes(point_light)
    p, n, c = (np.asarray(x) for x in j_tess(jscene))
    scan = np.asarray(_jax_render(p, n, c, jscene, jscene.camera, 36, 96,
                                  method="scan"))
    jfused = np.asarray(_jax_render(p, n, c, jscene, jscene.camera, 36, 96,
                                    method="fused"))
    got = R.render_soup(_t(p), _t(n), _t(c), scene, scene.camera, 36, 96,
                        0.5, method="fused")
    assert tuple(got.shape) == (36, 96, 3)
    assert (np.abs(scan - got.numpy()).max(-1) > 1e-4).sum() == 0
    np.testing.assert_allclose(got.numpy(), jfused, rtol=0, atol=1e-5)
    # v_cap does not route 'fused' to the diagnostic pipeline
    assert torch.equal(got, R.render_soup(_t(p), _t(n), _t(c), scene,
                                          scene.camera, 36, 96, 0.5,
                                          method="fused", v_cap=4096))


def _walls():
    """~500 wall-scale triangles: over the default big_cap of 64
    (tests/test_raster_channels.py:152-201)."""
    rng = np.random.default_rng(3)
    n_walls = 500
    base = rng.uniform(-6, 6, (n_walls, 3)).astype(np.float32)
    p = np.zeros((n_walls * 3, 3), np.float32)
    for i in range(n_walls):
        a = base[i]
        p[3 * i:3 * i + 3] = [a, a + [6.0, 0.2 * rng.standard_normal(), 0.0],
                              a + [0.0, 5.0, 0.3 * rng.standard_normal()]]
    n = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (n_walls * 3, 1))
    c = rng.uniform(0.2, 1.0, (n_walls * 3, 3)).astype(np.float32)
    return p, n, c


DIAG = ("n_valid", "n_big", "n_rows", "n_pairs", "n_tiles_nz")


def test_subtile_big_overflow_retry_matches_scan_oracle():
    """The generation-1 subtile pipeline with big_cap overflowing: the
    diag counts equal JAX's and report it, the suggest_caps_subtile retry
    takes every big triangle, its counts equal JAX's again, and the frame
    is within 2 pixels over 1e-4 of the scan oracle."""
    p, n, c = _walls()
    jscene = j_demo().build()
    scene = create_demo_scene().build(device="cpu")
    kw = dict(pos=(0.0, 0.0, 12.0), yaw=-np.pi / 2, pitch=0.0)
    jcam, cam = JCam.create(**kw), Camera.create(**kw)
    oracle = np.asarray(_jax_render(p, n, c, jscene, jcam, 32, 64,
                                    method="scan"))

    def both(**caps):
        j_rgb, j_diag = _jax_render(p, n, c, jscene, jcam, 32, 64,
                                    fn=JR.render_soup_diag, kernel="subtile",
                                    **caps)
        rgb, diag = R.render_soup_diag(_t(p), _t(n), _t(c), scene, cam, 32,
                                       64, 0.5, kernel="subtile", **caps)
        counts = tuple(int(diag[k]) for k in DIAG)
        assert counts == tuple(int(j_diag[k]) for k in DIAG)
        return np.asarray(j_rgb), rgb.numpy(), counts

    _j, _rgb, counts = both(v_cap=1024, big_cap=64, r_cap=4096,
                            pair_cap=8192)
    assert counts[1] > 64, f"fixture must overflow big_cap, got {counts[1]}"
    caps = R.suggest_caps_subtile(*counts[:4])
    assert caps == JR.suggest_caps_subtile(*counts[:4])
    j_rgb, rgb, counts2 = both(v_cap=caps[0], big_cap=caps[1],
                               r_cap=caps[2], pair_cap=caps[3])
    assert counts2[1] <= caps[1] and counts2[2] <= caps[2]
    assert counts2[3] <= caps[3]
    assert (np.abs(oracle - rgb).max(-1) > 1e-4).sum() <= 2
    np.testing.assert_allclose(rgb, j_rgb, rtol=0, atol=1e-5)


def test_subtile_pos9_matches_positions_path():
    """tests/test_raster_channels.py:256-280 on the port: the subtile
    pipeline with pre-transposed pos9 against the positions path (<= 5
    pixels over 1e-3), and each against JAX's frame."""
    pos, nrm, col = _rand_soup(3000, 5)
    scene = build_scene(SceneBuilder, DIR_SCENE)
    kw = dict(method="subtile", v_cap=6000, big_cap=64, r_cap=8192,
              pair_cap=24000)
    args = (_t(pos), _t(nrm), _t(col), scene, Camera.create(**CAM), 48, 96,
            0.5)
    a = R.render_soup(*args, **kw).numpy()
    b = R.render_soup(*args, **kw, pos9=R.positions_to_pos9(_t(pos))).numpy()
    assert (np.abs(a - b).max(-1) > 1e-3).sum() <= 5
    want = np.asarray(_jax_render(pos, nrm, col, build_scene(JSB, DIR_SCENE),
                                  JCam.create(**CAM), 48, 96, **kw))
    np.testing.assert_allclose(a, want, rtol=0, atol=1e-5)
    assert (a.max(-1) > 0).sum() > 500


def _crossers():
    s = 5.0
    floor = [(-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s)]
    wall = [(-s, 0, -s), (-s, 4, -s), (s, 4, -s), (s, 0, -s)]

    def qt(q):
        a, b, c, d = q
        return [a, b, c, a, c, d]
    pos = np.asarray(qt(floor) + qt(wall), np.float32)
    nrm = np.zeros_like(pos)
    nrm[:6] = (0, 1, 0)
    nrm[6:] = (0, 0, 1)
    col = np.tile(np.asarray([[0.7, 0.6, 0.5]], np.float32), (12, 1))
    return pos, nrm, col


SUBTILE2 = {  # tests/test_raster_channels.py:289-375
    "random3000": (_rand_soup(3000, 5), DIR_SCENE, CAM,
                   dict(v_cap=3072, big_cap=2048, r_cap=16384,
                        pair_cap=8 * 3000 + 2048 * 48 * 8)),
    "near_plane": (_crossers(), DIR_SCENE, NEAR_CAM,
                   dict(v_cap=512, big_cap=16, r_cap=8192,
                        pair_cap=16 * 48 * 8 + 64)),
    "point_light": (_rand_soup(2000, 9), POINT_SCENE, CAM,
                    dict(v_cap=2048, big_cap=1024, r_cap=16384,
                         pair_cap=8 * 2000 + 1024 * 48 * 8)),
}


@pytest.mark.parametrize("name", sorted(SUBTILE2))
def test_subtile2_matches_scan_oracle_and_jax(name):
    """Generation 2 against JAX's scan oracle (<= 6 pixels over 2e-3) and
    against JAX's subtile2 frame: render_subtile2_diag's diag counts equal,
    the floats within 1e-5."""
    (p, n, c), calls, cam, caps = SUBTILE2[name]
    jscene, scene = build_scene(JSB, calls), build_scene(SceneBuilder, calls)
    oracle = np.asarray(_jax_render(p, n, c, jscene, JCam.create(**cam), 48,
                                    96, method="scan"))
    got = R.render_soup(_t(p), _t(n), _t(c), scene, Camera.create(**cam), 48,
                        96, 0.5, method="subtile2", **caps).numpy()
    assert (np.abs(oracle - got).max(-1) > 2e-3).sum() <= 6
    j_rgb, j_diag = _jax_render(p, n, c, jscene, JCam.create(**cam), 48, 96,
                                fn=JR.render_soup_diag, kernel="subtile2",
                                **caps)
    rgb, diag = R.render_soup_diag(_t(p), _t(n), _t(c), scene,
                                   Camera.create(**cam), 48, 96, 0.5,
                                   kernel="subtile2", **caps)
    assert {k: int(diag[k]) for k in DIAG} == {k: int(j_diag[k])
                                               for k in DIAG}
    assert torch.equal(rgb, torch.from_numpy(got))
    np.testing.assert_allclose(got, np.asarray(j_rgb), rtol=0, atol=1e-5)
    if name != "near_plane":
        assert (got.max(-1) > 0).sum() > 500


def test_visibility_subtile_equals_jax():
    """B9a's path: visibility_subtile on JAX's compacted clip channels
    gives JAX's depth buffer bit for bit, its pair ids, its pair -> triangle
    map and its counts, at a generous and an overflowing r_cap."""
    pos, _nrm, _col = _rand_soup(1500, 3)

    def cch(p, cam):
        mvp = JR.camera_mvp(cam, 48, 96, 0.5)
        ch = JR.setup_screen_channels(JR.transform_clip_channels(p, mvp), 48,
                                      96)
        return JR.compact_valid_ch(ch, 3072)[0]

    jch = jax.jit(cch)(jnp.asarray(pos), JCam.create(**CAM))
    tch = {k: _t(v) for k, v in jch.items()}
    for r_cap in (4096, 64):
        want = jax.jit(functools.partial(
            JR.visibility_subtile, rows=48, cols=96, big_cap=256,
            r_cap=r_cap))(jch)
        got = R.visibility_subtile(tch, 48, 96, big_cap=256, r_cap=r_cap)
        np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(want[0]))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if r_cap == 4096:
            assert int((got[1] >= 0).sum()) > 500
        else:
            assert int(got[3]) > r_cap
    src = RO._entry_planes_src(tch)
    np.testing.assert_array_equal(_bits(src.numpy()),
                                  _bits(jax.jit(JR._entry_planes_src)(jch)))


def test_suggest_caps_subtile_equals_jax():
    for counts in ((1510, 0, 576, 1361, 5), (43000, 12, 9000, 120000, 400),
                   (250000, 3, 50000, 900000, 544)):
        assert R.suggest_caps_subtile(*counts) == \
            JR.suggest_caps_subtile(*counts)


def test_chip_smoke_gates_are_the_references_own_counts():
    """chip_smoke.py holds each retired generation's bunny frame (960x540,
    golden pose) to the reference's own count of pixels over 2e-3 from its
    subtile8 frame: this renders JAX's four frames and pins those counts
    (fused and subtile take their edges from the clip-expansion setup, so
    the bunny's silhouettes and shared edges round apart from subtile8's;
    subtile2 shares its 2-D homogeneous planes)."""
    import importlib.util
    import os
    from ascii_renderer_tpu.geom import meshes as JM
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    v, i = JM.bunny_like(69000)
    p, n, c = JM.mesh_to_soup(v, i, color=(0.8, 0.78, 0.75))
    calls = [("set_env_light", [0.22, 0.24, 0.28], 1.0),
             ("add_dir_light", [-0.5, -0.7, -0.6], [1, 1, 1], 0.9)]
    jscene = build_scene(JSB, calls)
    jcam = JCam.create(pos=(2.4, 1.4, 2.8), yaw=float(np.arctan2(-2.8, -2.4)),
                       pitch=-0.3)
    caps = dict(v_cap=49152, big_cap=0, r_cap=21504, pair_cap=69632,
                tile_cap=96)  # the caps chip_smoke.py settles on
    golden = smoke._golden_caps(p.shape[0] // 3)
    ref = np.asarray(_jax_render(p, n, c, jscene, jcam, 540, 960,
                                 method="subtile8", **golden))
    for method, kw in (("fused", {}), ("subtile", caps), ("subtile2", caps)):
        rgb = np.asarray(_jax_render(p, n, c, jscene, jcam, 540, 960,
                                     method=method, **kw))
        bad = int((np.abs(rgb - ref).max(-1) > 2e-3).sum())
        assert bad == smoke.ORACLE_REF_DIFF[method], (method, bad)
