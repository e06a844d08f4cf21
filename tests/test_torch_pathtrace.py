"""Port parity for the path tracer → glyph slice as users run it: the
camera basis and ray grid, ``render_pt`` on the kernel path,
``PathtraceBackend`` over frames, ``Renderer`` and its registry, and the
glyph grid of the frame, against JAX's kernel path
(``render_pt(use_kernel=True)``, which interprets the Pallas kernel on
the CPU), from the same scene, pose and frame keys.

Tolerances: the alpha plane (overrides) and the glyph grid exactly; rgb
within 1e-5 (the sample sums and XLA's fused products round differently);
rays within 1e-6."""

import functools
import inspect
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.ascii.ascii_pass import glyph_decide as j_glyph
from ascii_renderer_tpu.atlas import io as JIO
from ascii_renderer_tpu.backends import pathtrace as JPT
from ascii_renderer_tpu.core import camera as JC
from ascii_renderer_tpu.core.frame import Frame as JFrame
from ascii_renderer_tpu.scene import demo as JD
from ascii_renderer_tpu.scene.builder import SceneBuilder as JSB
from ascii_renderer_tpu_torch.ascii.ascii_pass import glyph_decide
from ascii_renderer_tpu_torch.atlas import io as TIO
from ascii_renderer_tpu_torch.backends import pathtrace as TPT
from ascii_renderer_tpu_torch.backends import registry as REG
from ascii_renderer_tpu_torch.backends.raster import RasterBackend
from ascii_renderer_tpu_torch.backends.raytrace import RaytraceBackend
from ascii_renderer_tpu_torch.core import camera as TC
from ascii_renderer_tpu_torch.core.config import Config, PathTracerConfig
from ascii_renderer_tpu_torch.core.frame import Frame
from ascii_renderer_tpu_torch.scene.builder import MaterialIds, SceneBuilder
from ascii_renderer_tpu_torch.scene import demo as TD
from ascii_renderer_tpu_torch.utils import from_jax

torch.set_num_threads(2)

LIGHT = (16.86, 10.76, 8.2)
POSE = dict(pos=(0, 2.5, 6), yaw=-np.pi / 2)  # faces the poster


def _scenes():
    jsb, tsb = JD.create_demo_scene(), TD.create_demo_scene()
    jsb.set_atlas(JIO.demo_atlas())
    tsb.set_atlas(TIO.demo_atlas())
    return jsb.build(min_pad=1), tsb.build(min_pad=1, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_render(rows, cols, spp, bounces, sample_batch):
    """JAX's kernel-path frame, jitted once per shape (keys are traced)."""
    js, _ts = _scenes()
    fn = jax.jit(functools.partial(
        JPT.render_pt, rows=rows, cols=cols, pixel_aspect=0.5, spp=spp,
        bounces=bounces, light_color=LIGHT, sample_batch=sample_batch,
        use_kernel=True))
    cam = JC.Camera.create(**POSE)
    return lambda key: [np.asarray(x) for x in fn(
        js, cam, jnp.float32(0), jax.random.key(key))]


def _j_chars(rgb, a):
    cfg = Config()
    f = JFrame.from_float(jnp.asarray(rgb), jnp.asarray(a))
    return np.asarray(j_glyph(f, ramp=cfg.ascii_ramp,
                              mode_on=cfg.ascii_mode_filter,
                              mode_radius=cfg.mode_radius,
                              mode_thresh=cfg.ascii_mode_thresh,
                              grayscale=cfg.use_grayscale)[0])


def _t_chars(frame):
    cfg = Config()
    return glyph_decide(frame, ramp=cfg.ascii_ramp,
                        mode_on=cfg.ascii_mode_filter,
                        mode_radius=cfg.mode_radius,
                        mode_thresh=cfg.ascii_mode_thresh,
                        grayscale=cfg.use_grayscale)[0].numpy()


@pytest.mark.parametrize("yaw,pitch", [(0.3, -0.2), (-np.pi / 2, 0.0),
                                       (2.0, 1.4), (1.0, math.pi / 2)])
def test_camera_basis_and_ray_grid_equal_jax(yaw, pitch):
    jcam = JC.Camera.create(pos=(1, 2, 3), yaw=yaw, pitch=pitch)
    tcam = TC.Camera.create(pos=(1, 2, 3), yaw=yaw, pitch=pitch)
    want = JC.camera_basis(jcam.yaw, jcam.pitch, jcam.fov_y)
    got = TC.camera_basis(tcam.yaw, tcam.pitch, tcam.fov_y)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    j_ro, j_rd, j_px, j_py = JPT.primary_ray_grid(jcam, 20, 44, 0.5)
    t_ro, t_rd, t_px, t_py = TPT.primary_ray_grid(tcam, 20, 44, 0.5,
                                                  device="cpu")
    for w, g in ((j_ro, t_ro), (j_rd, t_rd), (j_px, t_px), (j_py, t_py)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    jit = np.random.default_rng(1).normal(0, 0.01, (20, 44, 2)).astype(
        np.float32)
    np.testing.assert_allclose(
        TC.primary_ray_dirs(tcam, 20, 44, 0.5, torch.from_numpy(jit),
                            device="cpu").numpy(),
        np.asarray(JC.primary_ray_dirs(jcam, 20, 44, 0.5, jnp.asarray(jit))),
        atol=1e-6)


@pytest.mark.parametrize("auto", [True, False])
@pytest.mark.parametrize("time", [0.0, 1.7])
def test_light_sphere_equals_jax(auto, time):
    """The light sphere, read from the scene each call or from the host
    values a backend reads once per scene."""
    jsb, tsb = JD.create_demo_scene(), TD.create_demo_scene()
    for sb in (jsb, tsb):
        sb.set_area_light([1.0, 4.5, -2.0], 0.6, auto=auto)
    js, ts = jsb.build(min_pad=1), tsb.build(min_pad=1, device="cpu")
    want = JPT.get_light_sphere(js, time)
    host = TPT.light_sphere_host(ts)
    assert host[0] is auto
    for got in (TPT.get_light_sphere(ts, time),
                TPT.get_light_sphere(ts, time, host)):
        for w, g in zip(want, got):
            assert g.dtype == torch.float32 and g.device.type == "cpu"
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_render_pt_equals_jax_kernel_path():
    """12x32, spp 4, bounces 3, sample_batch 2 (two batches + the probe)."""
    _js, ts = _scenes()
    j_rgb, j_a = _jax_render(12, 32, 4, 3, 2)(3)
    rgb, a = TPT.render_pt(ts, TC.Camera.create(**POSE), 0.0,
                           TPT.frame_seed_of(3), rows=12, cols=32,
                           pixel_aspect=0.5, spp=4, bounces=3,
                           light_color=LIGHT, sample_batch=2)
    assert rgb.dtype == torch.float32 and a.dtype == torch.uint8
    np.testing.assert_array_equal(a.numpy(), j_a)
    np.testing.assert_allclose(rgb.numpy(), j_rgb, atol=1e-5, rtol=0)
    assert ((j_a >= 2) & (j_a <= 254)).sum() > 5  # poster glyphs


def test_pathtrace_backend_frames_and_glyphs_equal_jax():
    """Two frames of a fresh backend draw with keys 0 and 1, as the JAX
    backend does; the glyph grids of the frames match exactly."""
    _js, ts = _scenes()
    cfg = Config(path_tracer=PathTracerConfig(samples_per_batch=2,
                                              max_bounces=2))
    be = TPT.PathtraceBackend(cfg, device="cpu")
    be.set_scene(ts)
    jr = _jax_render(12, 32, 2, 2, 32)
    cam = TC.Camera.create(**POSE)
    chars = []
    for key in (0, 1):
        frame = be.render(0.0, cam, 12, 32, 0.5)
        j_rgb, j_a = jr(key)
        np.testing.assert_array_equal(frame.a.numpy(), j_a)
        want = Frame.from_float(torch.from_numpy(j_rgb),
                                torch.from_numpy(j_a))
        assert (frame.rgb.int() - want.rgb.int()).abs().max() <= 1
        chars.append(_t_chars(frame))
        np.testing.assert_array_equal(chars[-1], _j_chars(j_rgb, j_a))
    assert be._frame_idx == 2
    be.dispose()
    assert be.render(0.0, cam, 4, 8).a.eq(1).all()  # no scene: blank


def test_renderer_routes_to_the_pathtracer():
    _js, ts = _scenes()
    assert set(REG.list_backends()) >= {"pathtrace", "raster", "raytrace"}
    cfg = Config(path_tracer=PathTracerConfig(samples_per_batch=2,
                                              max_bounces=2),
                 grid_width=24, grid_height=8)
    r = REG.Renderer(cfg, device="cpu")
    assert r.backend_name == "pathtrace"  # the config's default backend
    r.set_scene(ts)
    frame = r.render(0.0, TC.Camera.create(**POSE))
    assert tuple(frame.a.shape) == (8, 24) and frame.a.device.type == "cpu"
    be = TPT.PathtraceBackend(cfg, device="cpu")
    be.set_scene(ts)
    direct = be.render(0.0, TC.Camera.create(**POSE), 8, 24, 0.5)
    assert torch.equal(frame.rgb, direct.rgb) and torch.equal(frame.a,
                                                              direct.a)
    px = r.get_pixels()
    assert px.shape == (8, 24, 4)
    np.testing.assert_array_equal(px[..., 3], frame.a.numpy())
    assert r.set_backend("pt") == "pathtrace"
    assert r.set_backend("rasterizer") == "raster"  # re-pushes the scene
    rframe = r.render(0.0, TC.Camera.create(**POSE))  # a small scene
    rb = RasterBackend(cfg, device="cpu")
    rb.set_scene(ts)
    rdirect = rb.render(0.0, TC.Camera.create(**POSE), 8, 24, 0.5)
    assert tuple(rframe.a.shape) == (8, 24)
    assert torch.equal(rframe.rgb, rdirect.rgb) and rframe.rgb.any()
    # the ray tracer through the router: the frame RaytraceBackend renders
    assert r.set_backend("rt") == "raytrace"  # re-pushes the scene
    tb = RaytraceBackend(cfg, device="cpu")
    tb.set_scene(ts)
    tframe = r.render(0.0, TC.Camera.create(**POSE))
    assert torch.equal(tframe.rgb, tb.render(0.0, TC.Camera.create(**POSE),
                                             8, 24, 0.5).rgb)
    rt_scene = TD.create_rt_demo_scene().build(device="cpu")  # its lights
    r.set_scene(rt_scene)
    tb.set_scene(rt_scene)
    tframe = r.render(0.0, rt_scene.camera)
    tdirect = tb.render(0.0, rt_scene.camera, 8, 24, 0.5)
    assert tuple(tframe.rgb.shape) == (8, 24, 3) and tframe.rgb.any()
    assert torch.equal(tframe.rgb, tdirect.rgb)
    assert torch.equal(tframe.a, tdirect.a)
    assert r.set_backend("ray") == "raytrace"
    with pytest.raises(ValueError, match="Unknown backend"):
        r.set_backend("nope")
    r.dispose()
    assert r.backend_name is None


def test_unported_paths_raise():
    _js, ts = _scenes()
    kw = dict(rows=4, cols=8, pixel_aspect=0.5, spp=1, bounces=1,
              light_color=LIGHT)
    cam = TC.Camera.create(**POSE)
    # the adaptive compaction (A8, ported): at 36 x 96, spp 2 (7 blocks of
    # 1,024 rays), the active pixels of a seeded mask get the full render's
    # rgb and alpha bit for bit, and the gated blocks' pixels come back
    # empty in pixel order
    ckw = dict(kw, rows=36, cols=96, spp=2, bounces=2)
    full_rgb, full_a = TPT.render_pt(ts, cam, 0.0, 3, **ckw)
    act = torch.from_numpy(np.random.default_rng(4).random((36, 96)) < 0.2)
    rgb, a = TPT.render_pt(ts, cam, 0.0, 3, pixel_active=act, **ckw)
    assert torch.equal(rgb[act].view(torch.int32),
                       full_rgb[act].view(torch.int32))
    assert torch.equal(a[act], full_a[act])
    empty = (rgb == 0).all(-1) & (a == 255)
    assert empty[~act].sum() > (~act).sum() // 2
    # row bands (A12, ported): a band is the full frame's rows bit for bit
    # (rgb and alpha), as are the band's centre-ray grid and directions; a
    # row_lo without n_rows raises (the reference ignores it)
    rgb4, a4 = TPT.render_pt(ts, cam, 0.0, 0, **kw)
    brgb, ba = TPT.render_pt(ts, cam, 0.0, 0, row_lo=1, n_rows=2, **kw)
    assert torch.equal(brgb.view(torch.int32), rgb4[1:3].view(torch.int32))
    assert torch.equal(ba, a4[1:3])
    full = TPT.primary_ray_grid(cam, 4, 8, 0.5, device="cpu")
    band = TPT.primary_ray_grid(cam, 4, 8, 0.5, row_lo=2, n_rows=2,
                                device="cpu")
    for f, b in zip(full, band):
        assert torch.equal(b, f[2:4])
    with pytest.raises(ValueError, match="without n_rows"):
        TPT.primary_ray_grid(cam, 4, 8, 0.5, row_lo=2, device="cpu")
    assert torch.equal(TC.primary_ray_dirs(cam, 4, 8, 0.5, n_rows=2,
                                           device="cpu"), full[1][:2])
    with pytest.raises(ValueError, match="scene on"):
        TPT.PathtraceBackend(device="meta").set_scene(ts)


def test_backend_takes_the_device_index_of_its_scene(monkeypatch):
    """A backend on "cuda" takes a scene built on "cuda" (whose tensors
    carry the index, "cuda:0") and renders on that card; a scene on another
    card or device type raises."""
    monkeypatch.setattr(TPT, "pack_scene_entries", lambda scene: "packed")
    monkeypatch.setattr(TPT, "light_sphere_host", lambda scene: "light")
    scene = types.SimpleNamespace(
        sph_pos=types.SimpleNamespace(device=torch.device("cuda", 0)))
    be = TPT.PathtraceBackend(device="cuda")
    be.set_scene(scene)
    assert be.device == torch.device("cuda", 0)
    assert (be._packed, be._light) == ("packed", "light")
    for dev in ("cuda:1", "cpu"):
        with pytest.raises(ValueError, match="scene on cuda:0"):
            TPT.PathtraceBackend(device=dev).set_scene(scene)


def test_entry_points_default_to_the_card():
    """Entry points run on the card unless the caller names the CPU; the
    camera alone stays a host object."""
    def default(fn):
        return inspect.signature(fn).parameters["device"].default

    for fn in (RasterBackend.__init__, TPT.PathtraceBackend.__init__,
               REG.Renderer.__init__, SceneBuilder.build, Frame.blank,
               TC.primary_ray_dirs, TPT.primary_ray_grid):
        assert default(fn) not in ("cpu", None), fn.__qualname__
        assert torch.device(default(fn)).type == "cuda", fn.__qualname__
    for fn in (from_jax.scene_from_numpy, from_jax.camera_from_numpy):
        assert default(fn) is inspect.Parameter.empty, fn.__qualname__
    assert default(TC.Camera.create) == "cpu"


def test_kernel_path_differs_from_the_xla_core_golden():
    """``pt_demo_override_plane`` was rendered by JAX's XLA core, whose
    jitter is threefry; the kernel path (JAX's and the port's) jitters
    with the lowbias32 hash. Both carry 117 overrides, and the port's
    alpha plane differs from the golden in 29 of the 3,456 cells: the
    jittered samples differ, not the centre ray (every override of the
    port's spp-1 frame is in the golden with the same code)."""
    import os
    _js, ts = _scenes()
    golden = open(os.path.join(os.path.dirname(__file__), "goldens",
                               "pt_demo_override_plane.txt")).read()
    golden = golden.rstrip("\n").split("\n")

    def lines(spp):
        _rgb, a = TPT.render_pt(ts, TC.Camera.create(**POSE), 0.0, 0,
                                rows=36, cols=96, pixel_aspect=0.5, spp=spp,
                                bounces=2, light_color=LIGHT)
        a = a.numpy()
        ov = (a >= 2) & (a <= 254)
        return ["".join(chr(c) if o else "." for c, o in zip(r, orow))
                for r, orow in zip(a, ov)], int(ov.sum())

    def n_diff(got):
        return sum(x != y for g, w in zip(got, golden) for x, y in zip(g, w))

    got, n_ov = lines(2)
    assert n_ov == 117 and n_diff(got) == 29
    got1, _ = lines(1)
    centre = {(r, c) for r, row in enumerate(got1)
              for c, ch in enumerate(row) if ch != "."}
    # every override of the centre-ray frame is in the golden, unchanged
    assert centre and all(golden[r][c] == got1[r][c] for r, c in centre)


def test_kernel_path_differs_from_the_wide_atlas_golden():
    """``pt_wide_atlas_overrides.txt`` (tests/test_atlas_wide.py) was
    rendered by JAX's XLA core too: a full-atlas quad 1 texel to 1 cell,
    27 overrides. The kernel path (the port's, byte for byte JAX's
    ``render_pt(use_kernel=True)`` alpha plane) gives 29, and 13 of the
    512 cells differ: the override map does depend on the jittered
    samples. The port's XLA core reproduces the golden
    (tests/test_torch_pt_core.py)."""
    import os
    asset = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "assets", "atlas_wide_32x16.bin")
    golden = open(os.path.join(os.path.dirname(__file__), "goldens",
                               "pt_wide_atlas_overrides.txt")).read()
    golden = golden.rstrip("\n").split("\n")
    kw = dict(rows=16, cols=32, pixel_aspect=1.0, spp=2, bounces=2,
              light_color=LIGHT)
    pose = dict(pos=(0, 0, 2.385), yaw=-np.pi / 2)
    planes = []
    for io, sb, cam in ((TIO, SceneBuilder(), TC.Camera.create(**pose)),
                        (JIO, JSB(), JC.Camera.create(**pose))):
        sb.add_quad([-4, -2, 0], [4, -2, 0], [4, 2, 0], [-4, 2, 0],
                    MaterialIds.WHITE, (0, 16), (32, 16), (32, 0), (0, 0))
        sb.set_area_light([50, 50, 50], 0.1, auto=False)
        sb.set_atlas(io.load_atlas(asset, 32, 16, strict=True))
        if io is TIO:
            _rgb, a = TPT.render_pt(sb.build(device="cpu"), cam, 0.0, 0,
                                    **kw)
        else:
            _rgb, a = JPT.render_pt(sb.build(), cam, jnp.float32(0),
                                    jax.random.key(0), use_kernel=True, **kw)
        planes.append(np.asarray(a))
    np.testing.assert_array_equal(planes[0], planes[1])
    a = planes[0]
    ov = (a >= 2) & (a <= 254)
    lines = ["".join(chr(c) if (32 <= c <= 126 and o) else "."
                     for c, o in zip(row, orow)) for row, orow in zip(a, ov)]
    n_diff = sum(x != y for g, w in zip(lines, golden) for x, y in zip(g, w))
    assert int(ov.sum()) == 29 and n_diff == 13
