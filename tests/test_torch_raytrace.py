"""Port parity for the ray tracer (``geom/intersect``, ``backends/rt_core``,
``backends/raytrace``, the registry's "rt") against the JAX package, which
renders it under ``jax.jit`` on its CPU backend, from the same seeded numpy
inputs and scenes.

Tolerances: hit flags, materials and glyph grids exactly; ``t``, normals
and rgb bit for bit where stated, else within 1e-5 with the count of values
that are not bit-identical held to the recorded one. The reference's
golden ``tests/goldens/rt_demo.txt`` exactly."""

import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.backends import pt_core as JPC
from ascii_renderer_tpu.backends import raytrace as JRT
from ascii_renderer_tpu.core import camera as JC
from ascii_renderer_tpu.geom import intersect as JG
from ascii_renderer_tpu.scene import demo as JD
from ascii_renderer_tpu.scene.builder import MaterialIds as JM
from ascii_renderer_tpu.scene.builder import SceneBuilder as JSB
from ascii_renderer_tpu_torch.ascii import AsciiPass, chars_to_strings
from ascii_renderer_tpu_torch.ascii.ascii_pass import glyph_decide
from ascii_renderer_tpu_torch.backends import raytrace as TRT
from ascii_renderer_tpu_torch.backends import rt_core as RC
from ascii_renderer_tpu_torch.backends.pt_core import V3
from ascii_renderer_tpu_torch.backends.registry import Renderer
from ascii_renderer_tpu_torch.core import camera as TC
from ascii_renderer_tpu_torch.core.config import Config
from ascii_renderer_tpu_torch.core.frame import Frame
from ascii_renderer_tpu_torch.geom import intersect as TG
from ascii_renderer_tpu_torch.scene import demo as TD
from ascii_renderer_tpu_torch.scene.builder import MaterialIds as TM
from ascii_renderer_tpu_torch.scene.builder import SceneBuilder as TSB

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "rt_demo.txt")
EPS = 1e-4
# values of the helpers, called alone on the seeded rays of
# _helper_counts, that are not bit-identical to jax.jit of the same helper
# alone (JAX 0.9.0 on the CPU): the port rounds as the helpers do inside
# the jitted render_rgb, where XLA hoists a product out of the ray loop
# (the radius squared, the triangle's edge terms) that it keeps in the
# loop, fused, when the helper is compiled by itself. Whole frames are
# held bit for bit below.
HELPERS_APART = {"spheres_t": 99, "planes_t": 0, "tris_t": 25,
                 "spheres_t shared": 0, "planes_t shared": 0,
                 "tris_t shared": 55, "tri_hit_info": 0, "dot": 0}


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _rays(seed, n=4000):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 3, (n, 3)).astype(np.float32),
            _unit(rng.normal(size=(n, 3))), rng)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --------------------------------------------------------------------------
# geom/intersect: the array-form library, against jax.jit of JAX's
# --------------------------------------------------------------------------
def _intersect_inputs():
    ro, rd, rng = _rays(0)
    S = 5
    return dict(
        ro=ro, rd=rd, c=rng.normal(0, 2, (S, 3)).astype(np.float32),
        r=rng.uniform(0.3, 2, S).astype(np.float32),
        valid=np.array([1, 1, 1, 0, 1], bool),
        pn=_unit(rng.normal(size=(S, 3))),
        pd=rng.normal(0, 1, S).astype(np.float32),
        tri=[rng.normal(0, 2, (S, 3)).astype(np.float32) for _ in range(3)],
        n=_unit(rng.normal(size=(ro.shape[0], 3))))


def _intersect_pairs():
    d = _intersect_inputs()
    ro, rd, c, r, v = d["ro"], d["rd"], d["c"], d["r"], d["valid"]
    pos = (ro + 2 * rd)[:, None]
    va, vb, vc = d["tri"]
    eta = np.float32(1 / 1.5)
    return {
        "ray_spheres": (
            TG.ray_spheres(_t(ro), _t(rd), _t(c), _t(r), _t(v), EPS),
            jax.jit(JG.ray_spheres, static_argnums=5)(ro, rd, c, r, v, EPS)),
        "sphere_normal": (
            TG.sphere_normal(_t(pos), _t(c), _t(r)),
            jax.jit(JG.sphere_normal)(pos, c, r)),
        "ray_planes": (
            TG.ray_planes(_t(ro), _t(rd), _t(d["pn"]), _t(d["pd"]), _t(v),
                          EPS),
            jax.jit(JG.ray_planes, static_argnums=5)(ro, rd, d["pn"], d["pd"],
                                                     v, EPS)),
        "ray_triangles": (
            TG.ray_triangles(_t(ro), _t(rd), _t(va), _t(vb), _t(vc), _t(v),
                             EPS),
            jax.jit(JG.ray_triangles, static_argnums=6)(ro, rd, va, vb, vc,
                                                        v, EPS)),
        "reflect": (TG.reflect(_t(rd), _t(d["n"])),
                    jax.jit(JG.reflect)(rd, d["n"])),
        "refract": (TG.refract(_t(rd), _t(d["n"]), eta),
                    jax.jit(JG.refract)(rd, d["n"], eta)),
    }


@pytest.mark.parametrize("name", ["ray_spheres", "sphere_normal",
                                  "ray_planes", "ray_triangles", "reflect",
                                  "refract"])
def test_intersect_equals_jax_jit(name):
    """Every function of geom/intersect, on 4,000 seeded rays against 5
    primitives (one invalid), equals jax.jit of JAX's bit for bit (hit
    flags and total-internal-reflection flags exactly)."""
    got, want = _intersect_pairs()[name]
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        if g.dtype == np.float32:
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert np.float32(TG.BIG) == np.float32(JG.BIG)


# --------------------------------------------------------------------------
# backends/rt_core: the channel-form helpers, alone against jax.jit
# --------------------------------------------------------------------------
def _prim(a):
    t = _t(a)
    return V3(t[:, 0:1], t[:, 1:2], t[:, 2:3])


def _ray(a):
    t = _t(a)
    return V3(t[None, :, 0], t[None, :, 1], t[None, :, 2])


def _jv(a):
    return JPC.V3.of(jnp.asarray(a))


def _helper_counts():
    """Values apart from jax.jit of each pt_core helper (or _planes_t)
    called alone, per-ray origins and one origin shared by every ray."""
    rng = np.random.default_rng(1)
    R, S = 3000, 6
    ro = rng.normal(0, 3, (R, 3)).astype(np.float32)
    rd = _unit(rng.normal(size=(R, 3)))
    c = rng.normal(0, 2, (S, 3)).astype(np.float32)
    r = rng.uniform(0.3, 2, S).astype(np.float32)
    valid = np.array([1, 1, 1, 0, 1, 1], bool)
    pn = _unit(rng.normal(size=(S, 3)))
    pd = rng.normal(0, 1, S).astype(np.float32)
    va, vb, vc = (rng.normal(0, 2, (S, 3)).astype(np.float32)
                  for _ in range(3))
    tv = _t(valid)[:, None]
    out = {}

    def apart(g, w):
        return int((_bits(torch.broadcast_to(g, (S, R)).numpy())
                    != _bits(w)).sum())

    for shared in (False, True):
        sfx = " shared" if shared else ""
        if shared:
            tro = V3(*(_t(ro[0, i]) for i in range(3)))
            jro = JPC.V3(*(jnp.full((R,), ro[0, i]) for i in range(3)))
        else:
            tro, jro = _ray(ro), _jv(ro)
        w = jax.jit(lambda a, b, cc, rr, vv: JPC.spheres_t(
            a, b, cc, rr, vv, EPS))(jro, _jv(rd), _jv(c), r, valid)
        out["spheres_t" + sfx] = apart(RC.spheres_t(
            tro, _ray(rd), _prim(c), _t(r)[:, None], tv, EPS), w)
        w = jax.jit(lambda a, b, n_, d_, vv: JRT._planes_t(
            a, b, n_, d_, vv, EPS))(jro, _jv(rd), pn, pd, valid)
        out["planes_t" + sfx] = apart(RC.planes_t(
            tro, _ray(rd), _prim(pn), _t(pd)[:, None], tv, EPS), w)
        pack = JPC.TriPack.build(jnp.asarray(va), jnp.asarray(vb),
                                 jnp.asarray(vc), jnp.asarray(valid))
        w = jax.jit(lambda a, b, p: JPC.tris_t(a, b, p, EPS))(jro, _jv(rd),
                                                              pack)
        out["tris_t" + sfx] = apart(RC.tris_t(
            tro, _ray(rd), _prim(va), _prim(vb - va), _prim(vc - va), tv,
            EPS), w)
    k = rng.integers(0, S, R)
    sel = (va[k], (vb - va)[k], (vc - va)[k])
    w = jax.jit(JPC.tri_hit_info)(_jv(ro), _jv(rd), *(_jv(x) for x in sel))
    g = RC.tri_hit_info(_ray(ro), _ray(rd), *(_ray(x) for x in sel))
    out["tri_hit_info"] = sum(
        int((_bits(gc[0].numpy()) != _bits(wc)).sum())
        for gc, wc in zip((*g[0], *g[1:]), (*w[0], *w[1:])))
    w = jax.jit(JPC.dot)(_jv(ro), _jv(rd))
    out["dot"] = int((_bits(RC.dot(_ray(ro), _ray(rd))[0].numpy())
                      != _bits(w)).sum())
    return out


def test_rt_core_helpers_against_jax_jit_alone():
    """spheres_t, planes_t, tris_t (per-ray and shared origins),
    tri_hit_info and dot against jax.jit of the reference's helpers called
    alone, on 3,000 seeded rays and 6 primitives: the count of values that
    are not bit-identical is the recorded one (HELPERS_APART) or fewer.
    ``reflect`` is geom/intersect's, held bit for bit above."""
    got = _helper_counts()
    print("values apart from jax.jit of the helper alone:", got)
    for k, n in HELPERS_APART.items():
        assert got[k] <= n, (k, got[k], n)


def test_rt_core_fusion_rule_follows_the_loops():
    """A product fuses into its add where it is formed in the add's loop:
    it varies along a dimension at least as far in as the addend."""
    a = torch.tensor([[1.0 + 2 ** -12], [3.0]])          # [P, 1]
    x = torch.full((1, 4), 1.0 + 2 ** -12)                # [1, R]
    c = torch.full((1, 4), -1.0)
    fused = RC.fma32(x, x, c)
    assert torch.equal(RC._mul_add(x, x, c), fused)       # both ray-level
    assert torch.equal(RC._mul_add(a, a, c), a * a + c)   # hoisted product
    assert torch.equal(RC._mul_add(a, a, torch.tensor(-1.0)),
                       RC.fma32(a, a, -1.0))              # same level
    assert not torch.equal(fused, x * x + c)              # the rule shows


# --------------------------------------------------------------------------
# closest_hit / occluded on random rays
# --------------------------------------------------------------------------
def _tri_scene_builders():
    out = []
    for SB, M in ((JSB, JM), (TSB, TM)):
        sb = SB()
        sb.add_plane([0, 1, 0], 0.0, M.MIRROR)
        sb.add_sphere([0, 1, -1], 0.8, M.RED)
        sb.add_triangle([-2, 0.2, -2], [2, 0.3, -2.5], [0, 2.5, -3], M.GREEN)
        sb.add_quad([-3, 0.1, 1], [-1, 0.1, 1], [-1, 1.5, 0.5],
                    [-3, 1.5, 0.5], M.WHITE)
        sb.add_dir_light([0.3, -1, -0.2], [1, 1, 1], 1.0)
        sb.add_point_light([1, 3, 2], [1, 0.9, 0.8], 2.0)
        sb.set_env_light([0.2, 0.3, 0.5], 1.0)
        sb.set_camera_pose([0.0, 1.5, 5.0], yaw=-1.5707963, pitch=-0.1)
        out.append(sb)
    return tuple(out)


def _scene_pair(name, min_pad=8):
    if name == "tris_quad":
        jsb, tsb = _tri_scene_builders()
    else:
        jsb, tsb = JD.create_rt_demo_scene(), TD.create_rt_demo_scene()
    if name == "two_lights":  # two of each light kind, every slot set
        for sb in (jsb, tsb):
            sb.add_dir_light([-0.5, -0.7, 0.2], [0.5, 0.6, 0.9], 0.7)
            sb.add_point_light([-2.0, 2.5, 3.0], [0.9, 0.5, 0.4], 2.0)
        min_pad = 1
    return jsb.build(min_pad=min_pad), tsb.build(min_pad=min_pad,
                                                  device="cpu")


@pytest.mark.parametrize("name", ["rt_demo", "tris_quad"])
def test_closest_hit_and_occluded_equal_jax(name):
    """closest_hit on 4,000 seeded rays from inside the scene: hit and mat
    exactly, t and n bit for bit against jax.jit of JAX's closest_hit;
    occluded under a per-ray tmax exactly."""
    js, ts = _scene_pair(name)
    rng = np.random.default_rng(7)
    n = 4000
    ro = (rng.uniform(-3, 3, (n, 3)) + [0, 1.5, 0]).astype(np.float32)
    rd = _unit(rng.normal(size=(n, 3)))
    jt, jm, jn, jh = jax.jit(JRT.closest_hit)(ro, rd, js)
    t, m, nn, h = TRT.closest_hit(V3(*(_t(ro[None, :, i]) for i in range(3))),
                                  V3(*(_t(rd[None, :, i]) for i in range(3))),
                                  ts)
    np.testing.assert_array_equal(h[0].numpy(), np.asarray(jh))
    assert 0.2 < float(np.asarray(jh).mean()) < 1.0
    np.testing.assert_array_equal(m[0].numpy(), np.asarray(jm))
    np.testing.assert_array_equal(_bits(t[0].numpy()), _bits(jt))
    np.testing.assert_array_equal(_bits(nn.stack()[0].numpy()), _bits(jn))
    tmax = rng.uniform(0.1, 6, n).astype(np.float32)
    jo = jax.jit(JRT.occluded)(ro, rd, tmax, js)
    to = TRT.occluded(V3(*(_t(ro[None, :, i]) for i in range(3))),
                      V3(*(_t(rd[None, :, i]) for i in range(3))),
                      _t(tmax[None]), ts)
    np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo))


# --------------------------------------------------------------------------
# The semantics of tests/test_raytrace.py, against JAX's values
# --------------------------------------------------------------------------
def _look_down_z(mod):
    return mod.Camera.create(pos=(0, 0, 5), yaw=-np.pi / 2, pitch=0.0)


def _semantic_case(case):
    """(jax builder, port builder, camera kwargs, grid) of a semantics
    case of tests/test_raytrace.py."""
    out = []
    for SB, M in ((JSB, JM), (TSB, TM)):
        sb = SB()
        if case == "miss_env":
            sb.set_env_light([0.2, 0.4, 0.6], 1.0)
            cam, grid = dict(pos=(0, 0, 5), yaw=-np.pi / 2), (4, 4)
        elif case == "no_ambient":
            sb.set_env_light([1, 1, 1], 1.0)
            sb.add_sphere([0, 0, 0], 1.0, M.WHITE)
            cam, grid = dict(pos=(0, 0, 5), yaw=-np.pi / 2), (9, 9)
        elif case == "lambert_shadow":
            sb.add_plane([0, 1, 0], 0.0, M.WHITE)
            sb.add_sphere([0, 1.5, 0], 0.5, M.RED)
            sb.add_dir_light([0, -1, 0], [1, 1, 1], 1.0)
            cam, grid = dict(pos=(0, 3, 4), yaw=-np.pi / 2, pitch=-0.6), \
                (33, 33)
        elif case == "attenuation":
            sb.add_plane([0, 1, 0], 0.0, M.WHITE)
            sb.add_point_light([0, 2, 0], [1, 1, 1], 1.0)
            cam, grid = dict(pos=(0, 4, 0.01), yaw=0.0,
                             pitch=-np.pi / 2 + 0.1), (17, 17)
        else:  # mirror
            sb.add_plane([0, 1, 0], 0.0, M.MIRROR)
            sb.add_sphere([0, 2, -3], 1.0, M.RED)
            sb.add_dir_light([0, -1, 0], [1, 1, 1], 1.0)
            sb.set_env_light([0.1, 0.2, 0.3], 1.0)
            cam, grid = dict(pos=(0, 1.0, 3), yaw=-np.pi / 2, pitch=-0.35), \
                (33, 33)
        out.append(sb)
    return out[0], out[1], cam, grid


@pytest.mark.parametrize("case", ["miss_env", "no_ambient", "lambert_shadow",
                                  "attenuation", "mirror"])
def test_semantics_equal_jax(case):
    """miss -> env, no ambient on diffuse, Lambert with a hard shadow,
    point-light attenuation, one mirror bounce: the port's frame equals
    jax.jit of JAX's render_rgb bit for bit, and shows what
    tests/test_raytrace.py asserts of the reference."""
    jsb, tsb, cam, (rows, cols) = _semantic_case(case)
    js, ts = jsb.build(), tsb.build(device="cpu")
    want = np.asarray(jax.jit(functools.partial(
        JRT.render_rgb, rows=rows, cols=cols, pixel_aspect=1.0))(
            js, JC.Camera.create(**cam)))
    got = TRT.render_rgb(ts, TC.Camera.create(**cam), rows, cols, 1.0).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if case == "miss_env":
        np.testing.assert_allclose(got, np.broadcast_to([0.2, 0.4, 0.6],
                                                        got.shape), atol=1e-6)
    elif case == "no_ambient":
        np.testing.assert_allclose(got[4, 4], 0.0, atol=1e-7)
    elif case == "lambert_shadow":
        assert got[16, 16].max() < 0.05
        np.testing.assert_allclose(got[16, 2], [0.7295, 0.7355, 0.7290],
                                   atol=1e-3)
    elif case == "attenuation":
        np.testing.assert_allclose(
            got[8, 8], np.array([0.7295, 0.7355, 0.7290]) / 1.2, atol=2e-2)
    else:
        np.testing.assert_allclose(got[30, 2], [0.1, 0.2, 0.3], atol=1e-5)
        assert (got[..., 0] - got[..., 1]).max() > 0.2


def test_tie_break_prefers_sphere_over_tri():
    """A sphere surface and a triangle at the same t: the sphere, listed
    first, wins, as in the reference."""
    sb = TSB()
    sb.add_sphere([0, 0, 0], 1.0, TM.RED)
    sb.add_triangle([-1, -1, 1.0], [1, -1, 1.0], [0, 1, 1.0], TM.GREEN)
    ts = sb.build(device="cpu")
    one = torch.ones((1, 1))
    _t_, mat, _n, hit = TRT.closest_hit(V3(0 * one, 0 * one, 5 * one),
                                        V3(0 * one, 0 * one, -one), ts)
    assert bool(hit) and int(mat) == TM.RED


# --------------------------------------------------------------------------
# Frames: the golden, and render_rgb at three poses
# --------------------------------------------------------------------------
def test_rt_demo_golden_through_the_port():
    """Renderer(cfg, "rt") on create_rt_demo_scene() at 96 x 36,
    pixel_aspect 0.5 (the golden's call, tests/test_raytrace.py) gives
    tests/goldens/rt_demo.txt exactly."""
    cfg = Config(pixel_aspect=0.5)
    r = Renderer(cfg, "rt", device="cpu")
    assert r.backend_name == "raytrace"
    scene = TD.create_rt_demo_scene().build(device="cpu")
    r.set_scene(scene)
    rows = chars_to_strings(AsciiPass(cfg)(r.render(0.0, scene.camera))[0])
    with open(GOLDEN) as fh:
        assert rows == fh.read().splitlines()


# render_rgb values at the three poses that are not bit-identical to JAX's
# jitted call (rt_demo scene, 96 x 36; JAX 0.9.0 on the CPU)
POSE_APART = (0, 0, 0)


@pytest.mark.parametrize("pose", range(3))
@pytest.mark.parametrize("name", ["rt_demo", "tris_quad", "two_lights"])
def test_render_rgb_equals_jax_jit_at_three_poses(name, pose):
    """render_rgb at the scene's pose and two off-axis poses against JAX's
    jitted render_rgb: glyphs exactly, rgb within 1e-5, and the count of
    values that are not bit-identical printed and held to POSE_APART."""
    js, ts = _scene_pair(name)
    if pose == 0:
        jc, tc = js.camera, ts.camera
    else:
        yaw, pitch = ((-1.3, -0.15), (-1.9, 0.1))[pose - 1]
        p = np.asarray(js.camera.pos)
        jc = JC.Camera.create(pos=p, yaw=yaw, pitch=pitch)
        tc = TC.Camera.create(pos=p, yaw=yaw, pitch=pitch)
    fn = jax.jit(functools.partial(JRT.render_rgb, rows=36, cols=96,
                                   pixel_aspect=0.5))
    want = np.asarray(fn(js, jc))
    got = TRT.render_rgb(ts, tc, 36, 96, 0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    apart = int((_bits(got.numpy()) != _bits(want)).sum())
    print(f"{name} pose {pose}: {apart} rgb values not bit-identical")
    assert apart <= POSE_APART[pose]
    cfg = Config(pixel_aspect=0.5)
    from ascii_renderer_tpu.ascii.ascii_pass import glyph_decide as jglyph
    from ascii_renderer_tpu.core.frame import Frame as JFrame
    kw = dict(ramp=cfg.ascii_ramp, mode_on=cfg.ascii_mode_filter,
              mode_radius=cfg.mode_radius, mode_thresh=cfg.ascii_mode_thresh,
              grayscale=cfg.use_grayscale)
    jchars = np.asarray(jglyph(JFrame.from_float(jnp.asarray(want)), **kw)[0])
    np.testing.assert_array_equal(
        glyph_decide(Frame.from_float(got), **kw)[0].numpy(), jchars)


def test_backend_protocol_and_row_bands():
    """RaytraceBackend: blank frame before a scene, a scene on another
    device refused, dispose; a row band is the full frame's rows bit for
    bit (A12, ported)."""
    be = TRT.RaytraceBackend(Config(), device="cpu")
    f = be.render(0.0, TC.Camera.create(), 4, 8, 0.5)
    assert tuple(f.rgb.shape) == (4, 8, 3) and not f.rgb.any()
    ts = TD.create_rt_demo_scene().build(device="cpu")
    with pytest.raises(ValueError, match="scene on"):
        TRT.RaytraceBackend(device="meta").set_scene(ts)
    band = TRT.render_rgb(ts, ts.camera, 4, 8, 0.5, row_lo=1, n_rows=2)
    full = TRT.render_rgb(ts, ts.camera, 4, 8, 0.5)
    assert torch.equal(band.view(torch.int32), full[1:3].view(torch.int32))
    be.set_scene(ts)
    assert be.render(0.0, ts.camera, 4, 8, 0.5).rgb.any()
    be.dispose()
    assert not be.render(0.0, ts.camera, 4, 8, 0.5).rgb.any()
    assert math.isclose(TRT.EPS, JRT.EPS)
