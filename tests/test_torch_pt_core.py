"""Port parity for the path tracer's XLA core (``render_pt(use_kernel=
False)``, JAX's default path) and the threefry stream it draws from,
against the JAX package on the same numpy inputs.

Tolerances: every threefry draw, key and alpha plane bit for bit; the
hit records, shadow flags and atlas samples of the core's helpers
exactly, except the unit normals and sampled directions, within 1e-6
(XLA's float32 rsqrt, sin and cos are not correctly rounded, the port's
are); radiance and rgb within 1e-5 (the same ulps, and XLA's jitted
contraction in JAX's backend)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.atlas import io as JIO
from ascii_renderer_tpu.backends import pathtrace as JPT
from ascii_renderer_tpu.backends import pt_core as JPC
from ascii_renderer_tpu.core import camera as JC
from ascii_renderer_tpu.core.config import Config as JConfig
from ascii_renderer_tpu.core.config import PathTracerConfig as JPTConfig
from ascii_renderer_tpu.scene import demo as JD
from ascii_renderer_tpu.sim import framestep as JFS
from ascii_renderer_tpu_torch.atlas import io as TIO
from ascii_renderer_tpu_torch.backends import pathtrace as TPT
from ascii_renderer_tpu_torch.backends import pt_core as TPC
from ascii_renderer_tpu_torch.core import camera as TC
from ascii_renderer_tpu_torch.core import threefry as TF
from ascii_renderer_tpu_torch.core.config import Config, PathTracerConfig
from ascii_renderer_tpu_torch.scene import demo as TD
from ascii_renderer_tpu_torch.scene.builder import MaterialIds, SceneBuilder
from ascii_renderer_tpu_torch.sim import framestep as TFS

torch.set_num_threads(2)

LIGHT = (16.86, 10.76, 8.2)
POSE = dict(pos=(0, 2.5, 6), yaw=-np.pi / 2)  # faces the poster
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
WIDE_ASSET = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "assets", "atlas_wide_32x16.bin")


def _kd(key):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


# --------------------------------------------------------------------------
# core/threefry against jax.random
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1, 2**32 - 1])
def test_threefry_keys_equal_jax(seed):
    key = jax.random.key(seed)
    kd = TF.key_data(seed)
    assert _kd(key) == kd
    for data in (0, 1, 5, 0xC0FFEE, 2**31, 2**32 - 1):
        assert TF.fold_in(kd, data) == _kd(jax.random.fold_in(key, data))
    for n in (2, 3):
        want = np.asarray(jax.random.key_data(jax.random.split(key, n)))
        assert [list(k) for k in TF.split(kd, n)] == want.tolist()
    # keys as numpy words and as tensors
    assert TF.fold_in(np.array(kd, np.uint32), 9) == TF.fold_in(
        torch.tensor(kd, dtype=torch.int64), 9)
    with pytest.raises(ValueError):
        TF.key_data(2**32)


@pytest.mark.parametrize("shape", [(1,), (1000,), (37, 5), (2, 6, 11, 2)])
@pytest.mark.parametrize("seed", [0, 12345])
def test_threefry_uniform_equals_jax(shape, seed):
    """uniform at 1-D, 2-D and the core's (B, band, cols, 2) jitter shape,
    under a derived key, bit for bit."""
    key = jax.random.split(jax.random.fold_in(jax.random.key(seed), 3))[1]
    want = np.asarray(jax.random.uniform(key, shape))
    got = TF.uniform(_kd(key), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert 0.0 <= float(got.min()) and float(got.max()) < 1.0


# --------------------------------------------------------------------------
# the core's helpers against JAX on random rays
# --------------------------------------------------------------------------
def _demo_scenes(atlas=(32, 32)):
    jsb, tsb = JD.create_demo_scene(), TD.create_demo_scene()
    jsb.set_atlas(JIO.demo_atlas(*atlas))
    tsb.set_atlas(TIO.demo_atlas(*atlas))
    return jsb.build(min_pad=1), tsb.build(min_pad=1, device="cpu")


def _rays(n, seed=0):
    """Rays from around the poster pose: ro f32 [n, 3], unit rd [n, 3]."""
    rng = np.random.default_rng(seed)
    ro = (np.array([0.0, 2.5, 6.0]) + rng.normal(0, 0.5, (n, 3))).astype(
        np.float32)
    rd = rng.normal(0, 1, (n, 3)) + np.array([0.0, 0.0, -2.0])
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return ro, rd


def _v3s(ro, rd):
    return (JPC.V3.of(jnp.asarray(ro)), JPC.V3.of(jnp.asarray(rd)),
            TPC.V3.of(torch.from_numpy(ro)), TPC.V3.of(torch.from_numpy(rd)))


def _light(js, ts):
    jl = JPT.get_light_sphere(js, 0.0)
    tl = TPT.get_light_sphere(ts, 0.0)
    np.testing.assert_array_equal(tl[0].numpy(), np.asarray(jl[0]))
    return jl, tl


def _eq(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


def test_intersect_shadow_and_atlas_equal_jax():
    """_intersect's hit record, _shadow's flags and _sample_atlas's texels
    on 4,096 random rays of the demo room (spheres, quads, the poster and
    the light sphere all hit): exact but the unit normal (1e-6)."""
    js, ts = _demo_scenes()
    (jlc, jlr), (tlc, tlr) = _light(js, ts)
    ro, rd = _rays(4096)
    # 256 rays toward the light sphere, 256 from above the room, upward
    to_l = np.asarray(jlc)[None] - ro[:256] + np.random.default_rng(2).normal(
        0, 0.05, (256, 3))
    rd[:256] = to_l / np.linalg.norm(to_l, axis=-1, keepdims=True)
    ro[-256:] += np.float32([0.0, 100.0, 0.0])
    rd[-256:] = [0.0, 1.0, 0.0]
    jro, jrd, tro, trd = _v3s(ro, rd)
    jpk, tpk = JPT._ScenePack(js), TPC._ScenePack(ts)
    jh = JPT._intersect(jro, jrd, jpk, jlc, jlr)
    th = TPC._intersect(tro, trd, tpk, tlc, tlr)
    for k in ("t", "hit", "kind", "mat", "tri_idx"):
        _eq(th[k], jh[k], k)
    for i in range(3):
        _eq(th["pos"][i], jh["pos"][i], "pos")
        _eq(th["bc"][i], jh["bc"][i], "bc")
        np.testing.assert_allclose(th["n"][i].numpy(), np.asarray(jh["n"][i]),
                                   atol=1e-6, rtol=0)
    kinds = set(np.unique(np.asarray(jh["kind"])).tolist())
    assert kinds >= {JPT.KIND_NONE, JPT.KIND_SPHERE, JPT.KIND_TRI,
                     JPT.KIND_LIGHT}, kinds
    jt, jb, js_ = JPT._sample_atlas(jpk, jh)
    tt, tb, ts_ = TPC._sample_atlas(tpk, th)
    for g, w in zip((*tt, tb, ts_), (*jt, jb, js_)):
        _eq(g, w, "atlas sample")
    assert int(ts_.sum()) > 20  # the poster's texels
    # shadow rays from the hits toward the light
    dist = np.random.default_rng(1).uniform(0.5, 9.0, 4096).astype(
        np.float32)
    shadowed = TPC._shadow(tro, trd, torch.from_numpy(dist), tpk)
    _eq(shadowed, JPT._shadow(jro, jrd, jnp.asarray(dist), jpk), "shadow")
    assert 0 < int(shadowed.sum()) < 4096


@pytest.mark.parametrize("seed", [3, 4])
def test_next_direction_and_environment_equal_jax(seed):
    """_next_direction (cosine hemisphere or Fresnel glass, by flag) and
    the environment: directions within 1e-6, the specular flag exact."""
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(2048, 3))
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    n[:8] = [0.0, 1.0, 0.0]  # the up-axis branch of the hemisphere basis
    _ro, rd = _rays(2048, seed)
    spec = rng.random(2048) < 0.5
    key = jax.random.fold_in(jax.random.key(seed), 2)
    jd, jspec = JPT._next_direction(JPC.V3.of(jnp.asarray(n)),
                                    JPC.V3.of(jnp.asarray(rd)),
                                    jnp.asarray(spec), key)
    td, tspec = TPT._next_direction(TPC.V3.of(torch.from_numpy(n)),
                                    TPC.V3.of(torch.from_numpy(rd)),
                                    torch.from_numpy(spec), _kd(key))
    _eq(tspec, jspec, "is_spec")
    for g, w in zip(td, jd):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    je = JPT.environment_ch(JPC.V3.of(jnp.asarray(rd)))
    te = TPC.environment_ch(TPC.V3.of(torch.from_numpy(rd)))
    for g, w in zip(te, je):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


def test_trace_eye_paths_equals_jax():
    """3 bounces with NEE on 16 x 32 poster-pose rays, with stats:
    override and fetched exact, radiance within 1e-5, the ray counts
    exact."""
    js, ts = _demo_scenes()
    (jlc, jlr), (tlc, tlr) = _light(js, ts)
    jcam = JC.Camera.create(pos=(0, 2.5, 5.2), yaw=-np.pi / 2)
    rd = np.asarray(JC.primary_ray_dirs(jcam, 16, 32, 0.5))
    ro = np.broadcast_to(np.asarray(jcam.pos), rd.shape).copy()
    key = jax.random.key(5)
    lcol = np.asarray(LIGHT, np.float32) * np.float32(1.3)
    j = JPT.trace_eye_paths(js, jnp.asarray(ro), jnp.asarray(rd), key, jlc,
                            jlr, bounces=3, light_color=jnp.asarray(lcol),
                            nee=True, with_stats=True)
    t = TPT.trace_eye_paths(ts, torch.from_numpy(ro), torch.from_numpy(rd),
                            _kd(key), tlc, tlr, bounces=3,
                            light_color=torch.from_numpy(lcol), nee=True,
                            with_stats=True)
    _eq(t[1], j[1], "override")
    _eq(t[2], j[2], "fetched")
    assert int(t[2].sum()) > 0 and int((t[1] > 0).sum()) > 0
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=1e-5,
                               rtol=0)
    assert t[3]["segments"] == float(j[3]["segments"])
    assert t[3]["shadow_rays"] == float(j[3]["shadow_rays"])


def test_core_equals_the_kernel_path_at_one_bounce():
    """At one bounce without NEE the core and the megakernel's plain
    version agree (tests/test_pallas_kernels.py does this for JAX):
    override and fetched exact, radiance within 1e-5; the 128x64 atlas."""
    _js, ts = _demo_scenes((128, 64))
    cam = TC.Camera.create(pos=(0, 2.5, 5.2), yaw=-np.pi / 2)
    rd = TC.primary_ray_dirs(cam, 16, 32, 0.5, device="cpu")
    ro = cam.pos.expand(rd.shape)
    lc, lr = TPT.get_light_sphere(ts, 0.0)
    lcol = torch.tensor(LIGHT) * 1.3
    a_lo, a_ov, a_f = TPT.trace_eye_paths(ts, ro, rd, TF.key_data(0), lc, lr,
                                          bounces=1, light_color=lcol,
                                          nee=False)
    k_lo, k_ov, k_f = TPT.trace_eye_paths_kernel(ts, ro, rd, 0, lc, lr,
                                                 bounces=1, light_color=lcol,
                                                 nee=False)
    assert torch.equal(a_ov, k_ov) and torch.equal(a_f, k_f)
    np.testing.assert_allclose(a_lo.numpy(), k_lo.numpy(), atol=1e-5,
                               rtol=0)
    assert int(a_f.sum()) > 0, "poster never hit"


# --------------------------------------------------------------------------
# the goldens, the backend and the frame step through the core
# --------------------------------------------------------------------------
def _override_lines(a):
    ov = (a >= 2) & (a <= 254)
    return (["".join(chr(c) if (32 <= c <= 126 and o) else "."
                     for c, o in zip(row, orow))
             for row, orow in zip(a, ov)], int(ov.sum()))


def _golden(name):
    with open(os.path.join(GOLDENS, name)) as fh:
        return fh.read().rstrip("\n").split("\n")


def test_demo_override_plane_golden_through_the_core():
    """tests/test_headline_goldens.py's call: the demo room with its
    atlas, 96x36, spp 2, 2 bounces, key 0: 117 overrides, exactly."""
    _js, ts = _demo_scenes()
    _rgb, a = TPT.render_pt(ts, TC.Camera.create(**POSE), 0.0,
                            key=np.array([0, 0], np.uint32), rows=36,
                            cols=96, pixel_aspect=0.5, spp=2, bounces=2,
                            light_color=LIGHT, use_kernel=False)
    lines, n_ov = _override_lines(a.numpy())
    assert lines == _golden("pt_demo_override_plane.txt") and n_ov == 117


def _wide_quad_scene(io, sb):
    sb.add_quad([-4, -2, 0], [4, -2, 0], [4, 2, 0], [-4, 2, 0],
                MaterialIds.WHITE, (0, 16), (32, 16), (32, 0), (0, 0))
    sb.set_area_light([50, 50, 50], 0.1, auto=False)
    sb.set_atlas(io.load_atlas(WIDE_ASSET, 32, 16, strict=True))
    return sb


def test_wide_atlas_golden_through_the_core():
    """tests/test_atlas_wide.py's call: the full-atlas quad 1 texel to 1
    cell, 32x16, spp 2: 27 overrides, exactly."""
    sb = _wide_quad_scene(TIO, SceneBuilder())
    _rgb, a = TPT.render_pt(sb.build(device="cpu"),
                            TC.Camera.create(pos=(0, 0, 2.385),
                                             yaw=-np.pi / 2), 0.0,
                            key=(0, 0), rows=16, cols=32, pixel_aspect=1.0,
                            spp=2, bounces=2, light_color=LIGHT,
                            use_kernel=False)
    lines, n_ov = _override_lines(a.numpy())
    assert lines == _golden("pt_wide_atlas_overrides.txt") and n_ov == 27


WIDE = (512, 256)  # 131,072 texels: twice MAX_ATLAS_TEXELS
PT_SMALL = dict(samples_per_batch=3, max_bounces=3)
GRID = (12, 32)


@functools.lru_cache(maxsize=None)
def _jax_wide_backend_frames(n):
    sb = JD.create_demo_scene()
    sb.set_atlas(JIO.demo_atlas(*WIDE))
    be = JPT.PathtraceBackend(JConfig(path_tracer=JPTConfig(**PT_SMALL)))
    be.set_scene(sb.build(min_pad=1))
    cam = JC.Camera.create(**POSE)
    return [[np.asarray(x) for x in (f.rgb, f.a)]
            for f in (be.render(0.0, cam, *GRID, 0.5) for _ in range(n))]


def test_wide_atlas_backend_equals_jax():
    """PathtraceBackend on the demo room with a 512x256 atlas takes the
    core (the kernel's budget is 65,536 texels), as JAX's does: frames 0
    and 1 (keys 0 and 1) have JAX's jitted backend's alpha plane and rgb
    bytes within 1; the core's float rgb under those keys is within 1e-5
    of JAX's jitted core."""
    want = _jax_wide_backend_frames(2)
    js, ts = _demo_scenes(WIDE)
    assert not TPT.atlas_ok(ts)
    packed = TPT.pack_scene_entries(ts)
    assert packed[2:4] == (0, 0)  # the prims alone
    be = TPT.PathtraceBackend(Config(path_tracer=PathTracerConfig(
        **PT_SMALL)), device="cpu")
    be.set_scene(ts)
    n_ov = 0
    for f, (j_rgb, j_a) in enumerate(want):
        frame = be.render(0.0, TC.Camera.create(**POSE), *GRID, 0.5)
        _eq(frame.a, j_a, f"alpha, frame {f}")
        assert np.abs(frame.rgb.numpy().astype(int)
                      - j_rgb.astype(int)).max() <= 1
        n_ov += int(((j_a >= 2) & (j_a <= 254)).sum())
        kw = dict(rows=GRID[0], cols=GRID[1], pixel_aspect=0.5,
                  spp=PT_SMALL["samples_per_batch"],
                  bounces=PT_SMALL["max_bounces"], light_color=LIGHT)
        j_f = jax.jit(functools.partial(JPT.render_pt, use_kernel=False,
                                        **kw))(
            js, JC.Camera.create(**POSE), jnp.float32(0), jax.random.key(f))
        t_f = TPT.render_pt(ts, TC.Camera.create(**POSE), 0.0, key=(0, f),
                            use_kernel=False, **kw)
        _eq(t_f[1], j_f[1], f"core alpha, key {f}")
        np.testing.assert_allclose(t_f[0].numpy(), np.asarray(j_f[0]),
                                   atol=1e-5, rtol=0)
    assert n_ov > 10
    assert be._frame_idx == 2


def test_wide_atlas_frame_step_equals_jax():
    """The "pathtrace" frame step on the wide-atlas room (JAX's jitted
    step takes its core on every device for it): two steps' alpha planes
    (overrides and UI) exactly."""
    jcfg = JConfig(grid_width=GRID[1], grid_height=GRID[0],
                   path_tracer=JPTConfig(**PT_SMALL))
    jsb = JD.create_demo_scene()
    jsb.set_atlas(JIO.demo_atlas(*WIDE))
    jcfg, jscene, jstate, jstep = JFS.demo_setup(jcfg, backend="pathtrace",
                                                 builder=jsb)
    cfg = Config(grid_width=GRID[1], grid_height=GRID[0],
                 path_tracer=PathTracerConfig(**PT_SMALL))
    tsb = TD.create_demo_scene()
    tsb.set_atlas(TIO.demo_atlas(*WIDE))
    cfg, scene, state, step = TFS.demo_setup(cfg, backend="pathtrace",
                                             builder=tsb, device="cpu")
    for f, keys in enumerate(((), ("w",))):
        jstate, _jc, _jt, jframe = jstep(jscene, jstate,
                                         JC.CameraInputs.from_keys(keys),
                                         1.0 / 60, 60.0)
        state, chars, _t, frame = step(scene, state,
                                       TC.CameraInputs.from_keys(keys),
                                       1.0 / 60, 60.0)
        _eq(frame.a, jframe.a, f"alpha, step {f}")
        assert tuple(chars.shape) == GRID
    assert int(state.frame_idx) == 2
