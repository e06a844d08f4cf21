"""The port's scene and IO layer against the JAX package's, in one process
on the CPU, from the same numpy-seeded inputs: the scene builder's
unified JSON schema (``to_unified`` / ``from_object`` /
``from_legacy_object``, meshes, materials), the atlas files, Morton
reordering, checkpoints (both directions), the glyph atlas, the glyph
bitmaps (``expand_pixels``), the text overlay, ``core/color``,
``Frame.interleaved`` and the exactness canary.

Every comparison is exact (bit for bit, byte for byte, or ``==`` on the
JSON dicts) unless its test says otherwise."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.ascii import ascii_pass as JAP
from ascii_renderer_tpu.ascii import glyphs as JG
from ascii_renderer_tpu.ascii import overlay as JOV
from ascii_renderer_tpu.ascii import text as JTX
from ascii_renderer_tpu.atlas import io as JIO
from ascii_renderer_tpu.core import color as JCO
from ascii_renderer_tpu.core import quantize as JQ
from ascii_renderer_tpu.core.camera import Camera as JCam
from ascii_renderer_tpu.core.config import Config as JConfig
from ascii_renderer_tpu.core.frame import Frame as JFrame
from ascii_renderer_tpu.geom import reorder as JRE
from ascii_renderer_tpu.scene import builder as JB
from ascii_renderer_tpu.scene import demo as JD
from ascii_renderer_tpu.sim import accum as JAC
from ascii_renderer_tpu.sim import framestep as JFS
from ascii_renderer_tpu.utils import checkpoint as JCK
from ascii_renderer_tpu_torch.ascii import ascii_pass as TAP
from ascii_renderer_tpu_torch.ascii import glyphs as TG
from ascii_renderer_tpu_torch.ascii import overlay as TOV
from ascii_renderer_tpu_torch.ascii import text as TTX
from ascii_renderer_tpu_torch.atlas import io as TIO
from ascii_renderer_tpu_torch.backends.registry import Renderer
from ascii_renderer_tpu_torch.core import color as TCO
from ascii_renderer_tpu_torch.core import quantize as TQ
from ascii_renderer_tpu_torch.core.camera import Camera as TCam
from ascii_renderer_tpu_torch.core.config import Config
from ascii_renderer_tpu_torch.core.frame import Frame
from ascii_renderer_tpu_torch.geom import reorder as TRE
from ascii_renderer_tpu_torch.scene import builder as TB
from ascii_renderer_tpu_torch.scene import demo as TD
from ascii_renderer_tpu_torch.sim import accum as TAC
from ascii_renderer_tpu_torch.sim import framestep as TFS
from ascii_renderer_tpu_torch.utils import checkpoint as TCK
from ascii_renderer_tpu_torch.utils import exactness

torch.set_num_threads(2)

WIDE_ATLAS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "atlas_wide_32x16.bin")


# ---------------------------------------------------------------------------
# scene builder and the unified schema
# ---------------------------------------------------------------------------
def _mesh_scene(mod):
    """Indexed meshes (with an out-of-range and a negative index), u16 UVs
    past both ends, a soup, dict and Material materials, every light kind,
    a plane, a quad, a camera pose and an atlas size."""
    rng = np.random.default_rng(3)
    sb = mod.SceneBuilder()
    sb.add_material(42, {"name": "TEAL", "albedo": (0.1, 1.7, 0.5),
                         "roughness": -2, "unknown": 1})
    sb.add_material("9", mod.Material("X", (0.2, 0.3, 0.4), True,
                                      (3, 2, 1), False, 0.25))
    pos = rng.uniform(-2, 2, 18).astype(np.float32).tolist()
    uvs = [0, 70000, -5, 3, 12, 7, 1, 2, 9, 9, 4, 4]
    sb.add_mesh(pos, [0, 1, 2, 3, 4, 5, 0, 6, 1, 2, -1, 3, 5, 4, 3], uvs,
                material_id=42)
    sb.add_mesh(rng.uniform(-1, 1, 27).astype(np.float32).tolist(),
                material_id=9)
    sb.add_mesh([1, 2, 3, 4], [0, 1, 2])  # not xyz triples: ignored
    sb.add_mesh(pos[:9], [0, 1])  # not index triples: a soup
    sb.add_quad([0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], 7,
                (0, 0), (31, 0), (31, 15), (0, 15))
    sb.add_plane([0, 3, 4], -1.5, 2)
    sb.add_sphere([0, 1, 0], 0.5, 1234)  # unknown id -> WHITE
    sb.add_point_light([1, 2, 3], [1, 0.5, 0.25], 2.0)
    sb.add_dir_light([0, -1, 0.5], [0.9, 0.9, 1], 0.7)
    sb.set_env_light([0.1, 0.2, 0.3], 0.5)
    sb.set_area_light([1, 5, 2], 0.75, auto=False)
    sb.set_camera_pose([1, 2, 8], yaw=-1.2, pitch=0.1, fovy_deg=65)
    sb.set_texture_atlas_size(32, 16)
    return sb


def _builders(name):
    if name == "demo":
        return JD.create_demo_scene(), TD.create_demo_scene()
    if name == "rt_demo":
        return JD.create_rt_demo_scene(), TD.create_rt_demo_scene()
    return _mesh_scene(JB), _mesh_scene(TB)


SCENES = ["demo", "rt_demo", "mesh"]


@pytest.mark.parametrize("name", SCENES)
def test_to_unified_equals_jax(name):
    jb, tb = _builders(name)
    want = jb.to_unified()
    assert tb.to_unified() == want
    assert json.dumps(tb.to_object(), sort_keys=True) == json.dumps(
        want, sort_keys=True)
    assert tb.to_path_tracer() == jb.to_path_tracer()
    if name == "mesh":
        assert len(want["geometry"]["tris"]) == 3 + 3 + 1
        assert want["geometry"]["tris"][0]["uvB"] == [0, 3]


@pytest.mark.parametrize("name", SCENES)
def test_from_object_round_trips(name):
    """from_object(to_unified()) gives the same dict, in the port and from
    JAX's dict, as JAX's own round trip."""
    jb, tb = _builders(name)
    d = tb.to_unified()
    assert TB.from_object(d).to_unified() == d
    jd = json.loads(json.dumps(jb.to_unified()))
    assert TB.from_object(jd).to_unified() == \
        JB.from_object(jd).to_unified()


def test_from_legacy_object_equals_jax():
    legacy = {"camera": {"pos": [0, 1, 5], "yaw": -1.5, "pitch": 0.2},
              "spheres": [{"p": [0, 1, 0], "r": 0.5, "m": 6},
                          {"p": [1, 1, 0], "r": 0.25}],
              "planes": [{"p": [0, 1, 0, 0.5], "m": 3}],
              "tris": [{"a": [0, 0, 0], "b": [1, 0, 0], "c": [0, 1, 0],
                        "m": 2}],
              "envLight": {"color": [0.2, 0.2, 0.3], "intensity": 0.5},
              "dirLight": {"dir": [0, -1, 0], "color": [1, 1, 1],
                           "intensity": 0.8}}
    got = TB.from_legacy_object(legacy).to_unified()
    assert got == JB.from_legacy_object(legacy).to_unified()
    assert got["geometry"]["spheres"][0]["matId"] == 100
    assert TB.from_legacy_object(None).to_unified() == \
        JB.from_legacy_object(None).to_unified()
    assert TB.from_object([]).to_unified() == JB.SceneBuilder().to_unified()


def test_materials_reset_and_factory_equal_jax():
    for mod in (JB, TB):
        assert mod.create_scene_builder(2, 3, 4)._max_t == 3
    jb, tb = _mesh_scene(JB), _mesh_scene(TB)
    for mid in (0, 1, 9, "42", 42.9, 5, -1, None):
        assert tb.has_material(mid) == jb.has_material(mid)
        got, want = tb.get_material(mid), jb.get_material(mid)
        assert (got is None) == (want is None)
        if got is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tb.get_material(42).albedo == (0.1, 1.0, 0.5)
    tb.reset()
    jb.reset()
    assert tb.to_unified() == jb.to_unified()
    assert tb.has_material(42) and not tb.to_unified()["geometry"]["tris"]


def _scene_fields(scene):
    out = {}
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        if f.name == "camera":
            for g in dataclasses.fields(v):
                out["camera." + g.name] = np.asarray(getattr(v, g.name))
        else:
            out[f.name] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", SCENES)
def test_scene_json_across_packages_builds_the_same_scene(tmp_path, name):
    """A scene JSON written by JAX's save_scene_json builds, through the
    port's load_scene_json, a SceneData equal to JAX's field for field
    (dtype and bits); and the port's file loads in JAX to the same dict."""
    jb, tb = _builders(name)
    JCK.save_scene_json(str(tmp_path / "j.json"), jb)
    TCK.save_scene_json(str(tmp_path / "t.json"), tb)
    assert (tmp_path / "j.json").read_text() == \
        (tmp_path / "t.json").read_text()
    got = _scene_fields(TCK.load_scene_json(str(tmp_path / "j.json")).build(
        min_pad=1, device="cpu"))
    want = _scene_fields(JCK.load_scene_json(str(tmp_path / "j.json")).build(
        min_pad=1))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert JCK.load_scene_json(str(tmp_path / "t.json")).to_unified() == \
        jb.to_unified()


# ---------------------------------------------------------------------------
# atlas files and Morton reordering
# ---------------------------------------------------------------------------
def _author(mod):
    img = mod.AtlasImage(24, 10)
    img.stamp(1, 1, "ab c\n~{}", rgb=(10, 20, 30))
    img.set_pixel(0, 9, (200, 100, 50))
    img.set_char(5, 5, "Q", (1, 2, 3))
    img.clear(1, 1)
    img.arr[9, 23, 3] = 200  # an invalid texel
    return img


def test_atlas_image_and_files_equal_jax(tmp_path):
    jimg, timg = _author(JIO), _author(TIO)
    assert (timg.width, timg.height) == (jimg.width, jimg.height) == (24, 10)
    np.testing.assert_array_equal(timg.arr, jimg.arr)
    np.testing.assert_array_equal(timg.valid_mask(), jimg.valid_mask())
    assert not timg.valid_mask()[9, 23]
    timg.save(str(tmp_path / "sub" / "t.bin"))
    jimg.save(str(tmp_path / "j.bin"))
    assert (tmp_path / "sub" / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    TIO.save_atlas(str(tmp_path / "demo.bin"), TIO.demo_atlas())
    JIO.save_atlas(str(tmp_path / "jdemo.bin"), JIO.demo_atlas())
    assert (tmp_path / "demo.bin").read_bytes() == \
        (tmp_path / "jdemo.bin").read_bytes()
    back = TIO.AtlasImage.load(str(tmp_path / "j.bin"), 24, 10)
    np.testing.assert_array_equal(back.arr, jimg.arr)
    with pytest.raises(ValueError):
        TIO.load_atlas(str(tmp_path / "j.bin"), 24, 10, strict=True)
    for ch in ("ab", "\x07"):
        with pytest.raises(ValueError):
            timg.set_char(0, 0, ch, (0, 0, 0))
    with pytest.raises(ValueError):
        TIO.save_atlas(str(tmp_path / "x.bin"), np.zeros((2, 2, 3), np.uint8))
    wide = TIO.load_atlas(WIDE_ATLAS, 32, 16)
    np.testing.assert_array_equal(wide, TIO.demo_atlas_wide())


def test_atlas_preview_image_equals_jax():
    got, want = _author(TIO).preview_image(8), _author(JIO).preview_image(8)
    assert got.size == want.size == (24 * 8, 10 * 8)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_reorder_equals_jax():
    rng = np.random.default_rng(7)
    pos = rng.uniform(-3, 3, (3 * 500, 3)).astype(np.float32)
    nrm = rng.normal(size=(3 * 500, 3)).astype(np.float32)
    col = rng.uniform(0, 1, (3 * 500, 3)).astype(np.float32)
    np.testing.assert_array_equal(TRE.morton_codes(pos), JRE.morton_codes(pos))
    got = TRE.reorder_soup(torch.from_numpy(pos), nrm, col)
    want = JRE.reorder_soup(jnp.asarray(pos), nrm, col)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert not np.array_equal(got[3], np.arange(500))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _stream(rng_words, n=4):
    return [tuple(TFS.fold_in(np.asarray(rng_words, np.uint32), i))
            for i in range(n)]


def _jax_frame_state():
    return JFS.FrameState.create(JCam.create(pos=(1, 2, 3), yaw=0.5,
                                             pitch=-0.2), seed=7).add_ripple(
        3.0, 4.0).replace(time_ms=jnp.float32(123.25),
                          frame_idx=jnp.int32(9))


def _port_frame_state():
    return TFS.FrameState.create(TCam.create(pos=(-1, 0, 2), yaw=1.0),
                                 seed=11).add_ripple(5.0, 6.0)


def test_frame_state_checkpoint_jax_to_port(tmp_path):
    """JAX saves, the port loads: every leaf equal in the like leaf's dtype
    (rng int64 words), and the key gives JAX's fold_in stream."""
    js = _jax_frame_state()
    JCK.save_pytree(str(tmp_path / "j.npz"), js)
    got = TCK.load_pytree(str(tmp_path / "j.npz"), _port_frame_state())
    assert got.rng.dtype == torch.int64
    assert got.rng.tolist() == [int(v) for v in jax.random.key_data(js.rng)]
    for name in ("time_ms", "frame_idx", "ripples", "n_ripples",
                 "raster_overflow"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
        assert getattr(got, name).dtype == getattr(
            _port_frame_state(), name).dtype
    for f in dataclasses.fields(got.camera):
        np.testing.assert_array_equal(getattr(got.camera, f.name).numpy(),
                                      np.asarray(getattr(js.camera, f.name)))
    want = [tuple(int(v) for v in jax.random.key_data(
        jax.random.fold_in(js.rng, i))) for i in range(4)]
    assert _stream(got.rng.numpy()) == want


def test_frame_state_checkpoint_port_to_jax(tmp_path):
    ts = _port_frame_state()
    TCK.save_pytree(str(tmp_path / "t"), ts)  # np.savez adds .npz
    with np.load(tmp_path / "t.npz") as z:
        assert z["__prngkey__/rng"].dtype == np.uint32
        files = sorted(z.files)
    JCK.save_pytree(str(tmp_path / "j.npz"), _jax_frame_state())
    with np.load(tmp_path / "j.npz") as z:
        assert files == sorted(z.files)
    back = JCK.load_pytree(str(tmp_path / "t.npz"),
                           JFS.FrameState.create(JCam.create()))
    assert [int(v) for v in jax.random.key_data(back.rng)] == \
        ts.rng.tolist()
    np.testing.assert_array_equal(np.asarray(back.ripples),
                                  ts.ripples.numpy())
    np.testing.assert_array_equal(np.asarray(back.camera.yaw),
                                  ts.camera.yaw.numpy())
    want = [tuple(int(v) for v in jax.random.key_data(
        jax.random.fold_in(back.rng, i))) for i in range(4)]
    assert _stream(ts.rng.numpy()) == want


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_accum_state_checkpoint_across_packages(tmp_path, direction):
    rng = np.random.default_rng(4)
    fields = {"count": rng.uniform(0, 9, (6, 8)).astype(np.float32),
              "mean": rng.uniform(0, 1, (6, 8, 3)).astype(np.float32),
              "m2": rng.uniform(0, 1, (6, 8, 3)).astype(np.float32),
              "cam_sig": rng.normal(size=5).astype(np.float32),
              "mean_y": rng.uniform(0, 1, (6, 8)).astype(np.float32),
              "m2_y": rng.uniform(0, 1, (6, 8)).astype(np.float32),
              "alpha": rng.integers(0, 256, (6, 8)).astype(np.uint8)}
    path = str(tmp_path / "a.npz")
    if direction == "jax_to_port":
        JCK.save_pytree(path, JAC.AccumState.create(6, 8).replace(
            **{k: jnp.asarray(v) for k, v in fields.items()}))
        got = TCK.load_pytree(path, TAC.AccumState.create(6, 8, "cpu"))
        got = {k: getattr(got, k).numpy() for k in fields}
    else:
        TCK.save_pytree(path, TAC.AccumState.create(6, 8, "cpu").replace(
            **{k: torch.from_numpy(v) for k, v in fields.items()}))
        got = JCK.load_pytree(path, JAC.AccumState.create(6, 8))
        got = {k: np.asarray(getattr(got, k)) for k in fields}
    for k, v in fields.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_checkpoint_sequences_and_dicts_use_jax_paths(tmp_path):
    tree = {"b": [torch.arange(3), (torch.ones(2),)], "a": torch.zeros(1)}
    TCK.save_pytree(str(tmp_path / "t.npz"), tree)
    jtree = {"b": [jnp.arange(3), (jnp.ones(2),)], "a": jnp.zeros(1)}
    JCK.save_pytree(str(tmp_path / "j.npz"), jtree)
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files) == \
            ["['a']", "['b']/0", "['b']/1/0"]
    back = TCK.load_pytree(str(tmp_path / "j.npz"), tree)
    assert torch.equal(back["b"][1][0], torch.ones(2))
    assert isinstance(back["b"][1], tuple)
    with pytest.raises(ValueError, match="missing key"):
        TCK.load_pytree(str(tmp_path / "t.npz"), {"c": torch.zeros(1)})


# ---------------------------------------------------------------------------
# glyph atlas, glyph bitmaps, text
# ---------------------------------------------------------------------------
def test_default_atlas_is_read_never_written(monkeypatch, tmp_path):
    before = os.path.getmtime(TG._ASSET)
    got = TG.load_default_atlas()
    np.testing.assert_array_equal(got, JG.load_default_atlas())
    assert got.shape == (256, 16, 8) and got.dtype == np.uint8
    assert os.path.getmtime(TG._ASSET) == before
    monkeypatch.setattr(TG, "_ASSET", str(tmp_path / "missing.npz"))
    with pytest.raises(FileNotFoundError):
        TG.load_default_atlas()
    assert not (tmp_path / "missing.npz").exists()


@pytest.mark.parametrize("cell", [(16, 32), (5, 7)])
def test_bake_glyph_atlas_equals_jax(cell):
    np.testing.assert_array_equal(TG.bake_glyph_atlas(*cell),
                                  JG.bake_glyph_atlas(*cell))
    np.testing.assert_array_equal(TG._fallback_atlas(*cell),
                                  JG._fallback_atlas(*cell))


def _sweep():
    """Every coverage value (an atlas whose glyph c is one texel of
    coverage c) against every tint value (row i tinted (i, 255 - i,
    7i mod 256)): 256 x 256 cells, 196,608 output bytes."""
    i = np.arange(256)
    atlas = i.astype(np.uint8).reshape(256, 1, 1)
    chars = np.broadcast_to(i[None, :], (256, 256)).astype(np.uint8)
    tint = np.stack([np.broadcast_to(v[:, None], (256, 256))
                     for v in (i, 255 - i, (7 * i) % 256)], -1).astype(
        np.uint8)
    return chars, tint, atlas


@pytest.mark.parametrize("transparent", [False, True])
def test_expand_pixels_full_sweep_equals_jax(transparent):
    chars, tint, atlas = _sweep()
    want = np.asarray(JAP.expand_pixels(jnp.asarray(chars), jnp.asarray(tint),
                                        jnp.asarray(atlas), 1.32,
                                        transparent))
    got = TAP.expand_pixels(torch.from_numpy(chars), torch.from_numpy(tint),
                            torch.from_numpy(atlas), 1.32, transparent)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.shape[-1] == (4 if transparent else 3)


def _random_frame(seed, rows=18, cols=40):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (rows, cols, 3)).astype(np.uint8)
    a = np.where(rng.uniform(size=(rows, cols)) < 0.1,
                 rng.integers(2, 255, (rows, cols)), 1).astype(np.uint8)
    return rgb, a


@pytest.mark.parametrize("radius", [1, 2, 3])
def test_ascii_pass_pixels_equal_jax(radius):
    """AsciiPass(...).pixels on a random frame with overrides, the default
    atlas, mode filter radius 1-3 (and grayscale at radius 3)."""
    rgb, a = _random_frame(radius)
    kw = dict(ascii_mode_kernel=2 * radius + 1, use_grayscale=radius == 3)
    want = np.asarray(JAP.AsciiPass(JConfig(**kw)).pixels(
        JFrame(rgb=jnp.asarray(rgb), a=jnp.asarray(a))))
    p = TAP.AsciiPass(Config(**kw), device="cpu")
    assert p.cfg.mode_radius == radius
    got = p.pixels(Frame(rgb=torch.from_numpy(rgb), a=torch.from_numpy(a)))
    assert p.atlas.device.type == "cpu" and tuple(p.atlas.shape) == (256, 16,
                                                                    8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_frame_to_strings_equals_jax():
    rgb, a = _random_frame(5)
    cfg = dict(ascii_ramp=" .:-=+*#%@", ascii_mode_kernel=5)
    assert TTX.frame_to_strings(Frame(rgb=torch.from_numpy(rgb),
                                      a=torch.from_numpy(a)),
                                Config(**cfg)) == \
        JTX.frame_to_strings(JFrame(rgb=jnp.asarray(rgb), a=jnp.asarray(a)),
                             JConfig(**cfg))


@pytest.mark.parametrize("mode", ["row", "interval", "off"])
def test_text_overlay_equals_jax(mode):
    """The cadence (row / interval / off), set_chars, set_frame (the host
    decode), a grid resize and cell_at: text equal to JAX's each frame."""
    tov = TOV.TextOverlay(Config(grid_width=40, grid_height=18), mode=mode,
                          interval_n=3)
    jov = JOV.TextOverlay(JConfig(grid_width=40, grid_height=18), mode=mode,
                          interval_n=3)
    for f in range(7):
        rgb, a = _random_frame(10 + f)
        if f % 2:
            tov.set_frame(Frame(rgb=torch.from_numpy(rgb),
                                a=torch.from_numpy(a)))
            jov.set_frame(JFrame(rgb=jnp.asarray(rgb), a=jnp.asarray(a)))
        else:
            chars = np.random.default_rng(f).integers(0, 256, (18, 40)).astype(
                np.uint8)
            tov.set_chars(torch.from_numpy(chars))
            jov.set_chars(jnp.asarray(chars))
        tov.update()
        jov.update()
        assert tov.text == jov.text
    assert tov.refresh_all() == jov.refresh_all()
    small = np.full((4, 5), ord("x"), np.uint8)
    tov.set_chars(small)
    jov.set_chars(small)
    assert (tov.rows, tov.cols) == (4, 5) and tov.refresh_row(6) == \
        jov.refresh_row(6)
    for px in ((-5, 3), (17.5, 40.1), (1e4, 1e4)):
        assert tov.cell_at(*px) == jov.cell_at(*px)


def test_quantize_index_np_equals_jax():
    rgb = np.random.default_rng(8).integers(0, 256, (64, 64, 3)).astype(
        np.uint8)
    for n in (1, 2, 10, 70):
        np.testing.assert_array_equal(TQ.quantize_index_np(rgb, n),
                                      JQ.quantize_index_np(rgb, n))


# ---------------------------------------------------------------------------
# core leftovers and the canary
# ---------------------------------------------------------------------------
def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_normalize_equals_jax(n):
    """normalize over a last axis of n (1-4: XLA's fused sum of squares)
    bit for bit; components spread over 8 decades, zero vectors kept."""
    rng = np.random.default_rng(n)
    v = (rng.normal(size=(20000, n)) * 10.0 ** rng.uniform(
        -4, 4, (20000, 1))).astype(np.float32)
    v[:7] = 0.0
    want = JCO.normalize(jnp.asarray(v))
    np.testing.assert_array_equal(_bits(TCO.normalize(torch.from_numpy(v))),
                                  _bits(want))


def test_color_helpers_equal_jax():
    rng = np.random.default_rng(9)
    r, g, b = (rng.integers(0, 256, 50) for _ in range(3))
    packed = TCO.pack_color(torch.from_numpy(r), torch.from_numpy(g),
                            torch.from_numpy(b))
    assert packed.dtype == torch.int32
    np.testing.assert_array_equal(packed.numpy(), np.asarray(
        JCO.pack_color(r, g, b)))
    assert int(TCO.pack_color(255, 128, 1)) == 0xFF8001
    for got, want in zip(TCO.unpack_color(packed),
                         JCO.unpack_color(np.asarray(packed.numpy()))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = rng.normal(size=100).astype(np.float32) * 2
    np.testing.assert_array_equal(TCO.saturate(torch.from_numpy(x)).numpy(),
                                  np.asarray(JCO.saturate(jnp.asarray(x))))


def test_frame_interleaved_equals_jax():
    rgb, a = _random_frame(12)
    jf = JFrame(rgb=jnp.asarray(rgb), a=jnp.asarray(a))
    tf = Frame(rgb=torch.from_numpy(rgb), a=torch.from_numpy(a))
    rgba = tf.interleaved()
    np.testing.assert_array_equal(rgba.numpy(), np.asarray(jf.interleaved()))
    back = Frame.from_interleaved(rgba)
    assert torch.equal(back.rgb, tf.rgb) and torch.equal(back.a, tf.a)
    jb = JFrame.from_interleaved(jf.interleaved())
    np.testing.assert_array_equal(back.a.numpy(), np.asarray(jb.a))


def test_renderer_get_pixels_is_the_interleaved_frame():
    scene = TD.create_rt_demo_scene().build(device="cpu")
    r = Renderer(Config(pixel_aspect=0.5), "rt", device="cpu")
    r.set_scene(scene)
    f = r.render(0.0, scene.camera, 6, 10)
    px = r.get_pixels()
    np.testing.assert_array_equal(px, f.interleaved().numpy())
    np.testing.assert_array_equal(r.get_pixels(flip_y=True), px[::-1])


def test_exactness_canary_ok_on_cpu():
    """run_checks on the CPU (the plain versions): every check True, under
    the JAX package's keys."""
    checks = exactness.run_checks("cpu")
    assert set(checks) == {"pack_blocked", "pack_flat", "xla_select_dot"}
    assert exactness.verdict(checks) == "ok"
    assert exactness.verdict(dict(checks, pack_flat=False)) == \
        "FAIL:pack_flat"
