"""Port parity for the UI layer and the frame step (``sim/ui``,
``sim/framestep``, ``entry``) against the JAX package compiled as its own
suite runs it (``jax.jit`` on the CPU backend, Pallas in interpret mode),
from the same scene, inputs and keys.

Tolerances: the UI planes, the fold_in key data, the glyph grids, the tint,
the alpha planes, the camera and the clock exactly (bit for bit)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.ascii.ascii_pass import glyph_decide as j_glyph
from ascii_renderer_tpu.atlas import io as JIO
from ascii_renderer_tpu.backends import pathtrace as JPT
from ascii_renderer_tpu.core import camera as JC
from ascii_renderer_tpu.core.config import Config as JConfig
from ascii_renderer_tpu.core.config import PathTracerConfig as JPTConfig
from ascii_renderer_tpu.core.frame import Frame as JFrame
from ascii_renderer_tpu.scene import demo as JD
from ascii_renderer_tpu.sim import framestep as JFS
from ascii_renderer_tpu.sim import ui as JU
from ascii_renderer_tpu_torch import entry as TE
from ascii_renderer_tpu_torch.core import camera as TC
from ascii_renderer_tpu_torch.core.config import Config, PathTracerConfig
from ascii_renderer_tpu_torch.sim import framestep as FS
from ascii_renderer_tpu_torch.sim import ui as U

torch.set_num_threads(2)

ROWS, COLS = 12, 32


def _eq(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype == np.float32:
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("rows,cols", [(10, 20), (36, 96), (3, 200)])
def test_border_plane_equals_jax(rows, cols):
    want = JU.border_plane(JConfig(), rows, cols)
    got = U.border_plane(Config(), rows, cols)
    for g, w in zip(got, want):
        _eq(g.numpy(), w)
    got[0][0, 0] = 0  # the caller's copy: the cached plane is not touched
    _eq(U.border_plane(Config(), rows, cols)[0].numpy(), want[0])


FPS_VALUES = [0.0, 7.0, 7.5, 8.5, 59.94, 60.0, 123.0, 1234.0, 8195.0,
              99999.0, 1234567.0, 9999999.0, 12345678.0, -3.0, float("nan")]


@pytest.mark.parametrize("fps", FPS_VALUES)
def test_fps_plane_equals_jax(fps):
    """Digits of round(fps) right-aligned, up to 9,999,999 (clamped above,
    0 below and for NaN); round half to even."""
    want = JU.fps_plane(jnp.float32(fps), 8, 30)
    got = U.fps_plane(fps, 8, 30)
    for g, w in zip(got, want):
        _eq(g.numpy(), w, f"fps {fps}")


def test_bresenham_points_equal_jax():
    rng = np.random.default_rng(0)
    cx = rng.integers(-20, 60, 16).astype(np.int32)
    cy = rng.integers(-10, 30, 16).astype(np.int32)
    r = rng.integers(0, 101, 16).astype(np.int32)
    r[:3] = (0, 1, 100)
    want = JU._bresenham_circle_points(jnp.asarray(cx), jnp.asarray(cy),
                                       jnp.asarray(r))
    got = U._bresenham_circle_points(cx, cy, r)
    for g, w in zip(got, want):
        _eq(g.numpy(), w)


@pytest.mark.parametrize("time_ms", [0.0, 60.0, 733.3, 1999.9, 2000.1, 1e6])
def test_ripples_and_ui_plane_equal_jax(time_ms):
    """Ripples at every age: drawn, clipped at the grid's edges, unborn
    (start after now) and expired (radius past max_ripple_radius)."""
    rng = np.random.default_rng(1)
    rip = np.stack([rng.uniform(-5, 45, 16), rng.uniform(-3, 23, 16),
                    rng.uniform(0, 1500, 16)], -1).astype(np.float32)
    rip[0] = (37.0, 17.0, 0.0)  # crosses the FPS row and the border
    for n in (0, 5, 16):
        want = JU.ripples_plane(jnp.asarray(rip), jnp.int32(n),
                                jnp.float32(time_ms), 0.05, 100.0, 20, 40)
        got = U.ripples_plane(rip, n, time_ms, 0.05, 100.0, 20, 40)
        for g, w in zip(got, want):
            _eq(g.numpy(), w, f"ripples n={n} t={time_ms}")
        want = JU.ui_char_plane(JConfig(), 20, 40, jnp.float32(60.0),
                                jnp.asarray(rip), jnp.int32(n),
                                jnp.float32(time_ms))
        got = U.ui_char_plane(Config(), 20, 40, 60.0, torch.from_numpy(rip),
                              torch.tensor(n, dtype=torch.int32),
                              torch.tensor(time_ms), device="cpu")
        for g, w in zip(got, want):
            _eq(g.numpy(), w, f"ui n={n} t={time_ms}")


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1, 2**31, 2**32 - 1])
def test_fold_in_equals_jax(seed):
    key = jax.random.key(seed)
    _eq(FS.key_data(seed), jax.random.key_data(key))
    for data in (0, 1, 2, 3, 1000, 2**31, 2**32 - 1):
        _eq(FS.fold_in(FS.key_data(seed), data),
            jax.random.key_data(jax.random.fold_in(key, data)),
            f"seed {seed} data {data}")
    with pytest.raises(ValueError):
        FS.key_data(2**32)


def test_frame_state_and_ripples_equal_jax():
    cam = dict(pos=(0.0, 1.5, 6.0))
    js = JFS.FrameState.create(JC.Camera.create(**cam), seed=5)
    ts = FS.FrameState.create(TC.Camera.create(**cam), seed=5)
    _eq(ts.rng.numpy().astype(np.uint32), jax.random.key_data(js.rng))
    for i in range(U.MAX_RIPPLES + 3):  # the ring wraps
        js = js.add_ripple(3.0 * i, 2.0 + i)
        ts = ts.add_ripple(3.0 * i, 2.0 + i)
    _eq(ts.ripples.numpy(), js.ripples)
    assert int(ts.n_ripples) == int(js.n_ripples) == U.MAX_RIPPLES


def _assert_state_equal(ts, js):
    for f in dataclasses.fields(TC.Camera):
        _eq(getattr(ts.camera, f.name).numpy(), getattr(js.camera, f.name),
            f.name)
    _eq(ts.time_ms.numpy(), js.time_ms, "time_ms")
    assert int(ts.frame_idx) == int(js.frame_idx)


MOVES = [("w",), ("w", "arrowleft", "a"), ("s", "d", " ", "arrowup")]


@pytest.fixture(scope="module")
def raster_setup():
    jcfg = JConfig(grid_width=COLS, grid_height=ROWS)
    jcfg, jscene, jstate, jstep = JFS.demo_setup(jcfg, backend="raster")
    cfg = Config(grid_width=COLS, grid_height=ROWS)
    cfg, scene, state, step = FS.demo_setup(cfg, backend="raster",
                                            device="cpu")
    return (jscene, jstate, jstep), (cfg, scene, state, step)


def test_raster_steps_equal_jax(raster_setup):
    """3 raster steps of demo_setup at 12 x 32, a different held key set
    each frame (the camera turns and moves): chars, tint, camera and clock
    bit-identical to JAX's jitted make_frame_step."""
    (jscene, js, jstep), (_cfg, scene, ts, step) = raster_setup
    for f, keys in enumerate(MOVES):
        ji = JC.CameraInputs.from_keys(keys, mouse_dx=4.0 * f)
        ti = TC.CameraInputs.from_keys(keys, mouse_dx=4.0 * f)
        js, jchars, jtint, _jf = jstep(jscene, js, ji, 1.0 / 60, 60.0)
        ts, chars, tint, frame = step(scene, ts, ti, 1.0 / 60, 60.0)
        _eq(chars.numpy(), jchars, f"chars, frame {f}")
        _eq(tint.numpy(), jtint, f"tint, frame {f}")
        _assert_state_equal(ts, js)
        assert int(ts.raster_overflow) == 0
    a = frame.a.numpy()
    assert (a[0] >= ord("0")).all() and (a[0] <= ord("9")).all()  # border
    assert len(np.unique(chars.numpy())) >= 4


def test_clock_equals_jax_over_many_frames():
    """The frame clock time_ms + dt * 1000 rounds as the jitted step's
    (one fused multiply-add) for 2,000 frames at 60 and 144 FPS."""
    jadd = jax.jit(lambda t, dt: t + jnp.float32(dt) * 1000.0)
    for dt_s in (1.0 / 60, 1.0 / 144):
        jt = jnp.float32(0.0)
        tt = torch.zeros((), dtype=torch.float32)
        dt = torch.tensor(dt_s, dtype=torch.float32)
        for _ in range(2000):
            jt = jadd(jt, dt_s)
            tt = FS.fma32(dt, 1000.0, tt)
        _eq(tt.numpy(), jt)


def test_batched_step_equals_single_steps(raster_setup):
    _j, (cfg, scene, state, step) = raster_setup
    ins = TC.CameraInputs.from_keys(("w", "arrowright"))
    step_n = FS.make_batched_frame_step(cfg, "raster",
                                        soup=_soup(scene))
    seq = FS.broadcast_inputs(ins, 3)
    assert tuple(seq.forward.shape) == (3,)
    s3, chars_n, tint_n = step_n(scene, state, seq,
                                 torch.full((3,), 1.0 / 60), 60.0)
    assert tuple(chars_n.shape) == (3, ROWS, COLS)
    assert tuple(tint_n.shape) == (3, ROWS, COLS, 3)
    s = state
    for i in range(3):
        s, chars, tint, _f = step(scene, s, ins, 1.0 / 60, 60.0)
        _eq(chars_n[i].numpy(), chars.numpy())
        _eq(tint_n[i].numpy(), tint.numpy())
    _eq(s3.camera.pos.numpy(), s.camera.pos.numpy())
    _eq(s3.time_ms.numpy(), s.time_ms.numpy())


def _soup(scene):
    from ascii_renderer_tpu_torch.geom.tessellate import tessellate_scene
    return tuple(torch.from_numpy(x) for x in tessellate_scene(scene))


def test_raster_overflow_flag(raster_setup):
    """Fixed caps cannot retry: a tiny cap tuple flags the frame, a
    generous one leaves the flag clear and the frame equal to the uncapped
    step. The 2-tuple (mid-scale) step with tiny caps gives JAX's capped
    frame too."""
    (jscene, js, _jstep), (cfg, scene, ts, step) = raster_setup
    soup = _soup(scene)
    ins = TC.CameraInputs.from_keys(())
    _s, chars0, _t, _f = step(scene, ts, ins, 1.0 / 60, 60.0)
    n_tiles = -(-ROWS // 8) * -(-COLS // 128)
    for caps, tight in (((4096, 64, 256, 2048, 8), True),
                        ((8192, 256, 16384, 65536, 8 * n_tiles * 8), False),
                        ((128, 64), True), ((8192, 64), False)):
        capped = FS.make_frame_step(cfg, "raster", soup=soup,
                                    raster_caps=caps)
        s1, chars, _t, _f = capped(scene, ts, ins, 1.0 / 60, 60.0)
        assert (int(s1.raster_overflow) > 0) == tight, caps
        if not tight:
            _eq(chars.numpy(), chars0.numpy(), f"caps {caps}")
    jcfg = JConfig(grid_width=COLS, grid_height=ROWS)
    from ascii_renderer_tpu.geom.tessellate import tessellate_scene
    jsoup = tuple(jnp.asarray(x) for x in tessellate_scene(jscene))
    jcapped = JFS.make_frame_step(jcfg, "raster", soup=jsoup,
                                  raster_caps=(128, 64))
    j1, jchars, _jt, _jf = jcapped(jscene, js, JC.CameraInputs.from_keys(()),
                                   1.0 / 60, 60.0)
    capped = FS.make_frame_step(cfg, "raster", soup=soup,
                                raster_caps=(128, 64))
    s1, chars, _t, _f = capped(scene, ts, ins, 1.0 / 60, 60.0)
    assert int(s1.raster_overflow) == int(j1.raster_overflow) > 0
    _eq(chars.numpy(), jchars)


PT_CFG = dict(samples_per_batch=2, max_bounces=2)


def _jax_pt_steps(n, moves=None, outer_jit=True):
    """JAX's frame step with the path tracer's kernel path, by hand: the
    same stages as ``_step_body``, ``render_pt(use_kernel=True)`` with the
    scene pack closed over and the frame key ``fold_in(rng, frame_idx)``
    (JAX's own step takes the XLA core on the CPU). ``moves``: one
    (keys, mouse_dx, mouse_dy) a frame (default MOVES, no mouse).

    ``outer_jit=False`` runs the step without the outer ``jax.jit``, as
    the port rounds it: the camera integrator and the clock jitted (the
    port's ``update_camera`` and clock fuse as they do), the rest of the
    step, the ray grids among it, eager. The caller jits the kernel call
    itself (``trace_blocks_raw``), which is jitted inside the step too."""
    moves = moves or [(keys, 0.0, 0.0) for keys in MOVES]
    jcfg = JConfig(grid_width=COLS, grid_height=ROWS,
                   path_tracer=JPTConfig(**PT_CFG))
    sb = JD.create_demo_scene()
    sb.set_atlas(JIO.demo_atlas())
    scene = sb.build(min_pad=1)
    packed = JPT.pack_scene_entries(scene)
    pt = jcfg.path_tracer

    @jax.jit
    def advance(state, inputs, dt_s):
        return (JC.update_camera(state.camera, inputs, dt_s),
                state.time_ms + dt_s * 1000.0)

    def step(scene, state, inputs, dt_s, fps):
        dt_s = jnp.float32(dt_s)
        if outer_jit:
            cam = JC.update_camera(state.camera, inputs, dt_s)
            time_ms = state.time_ms + dt_s * 1000.0
        else:
            cam, time_ms = advance(state, inputs, dt_s)
        key = jax.random.fold_in(state.rng, state.frame_idx)
        rgb, a = JPT.render_pt(scene, cam, time_ms / 1000.0, key, rows=ROWS,
                               cols=COLS, pixel_aspect=jcfg.pixel_aspect,
                               spp=pt.samples_per_batch,
                               bounces=pt.max_bounces,
                               light_color=pt.light_color,
                               nee=pt.direct_light_sampling, use_kernel=True,
                               packed=packed)
        frame = JFrame.from_float(rgb, a).with_overrides(*JU.ui_char_plane(
            jcfg, ROWS, COLS, fps, state.ripples, state.n_ripples, time_ms))
        chars, _tint = j_glyph(frame, ramp=jcfg.ascii_ramp,
                               mode_on=jcfg.ascii_mode_filter,
                               mode_radius=jcfg.mode_radius,
                               mode_thresh=jcfg.ascii_mode_thresh,
                               grayscale=jcfg.use_grayscale)
        return (state.replace(camera=cam, time_ms=time_ms,
                              frame_idx=state.frame_idx + 1), chars, frame.a)

    if outer_jit:
        step = jax.jit(step)
    state = JFS.FrameState.create(scene.camera).add_ripple(20.0, 6.0)
    out = []
    for f in range(n):
        keys, dx, dy = moves[f]
        ins = JC.CameraInputs.from_keys(keys, mouse_dx=dx, mouse_dy=dy)
        state, chars, a = step(scene, state, ins, 1.0 / 60, 60.0)
        out.append((np.asarray(chars), np.asarray(a)))
    return out


def test_pathtrace_steps_equal_jax_kernel_path():
    """2 path-traced steps of demo_setup at 12 x 32, spp 2: the alpha
    plane (overrides and UI) equals JAX's kernel-path step exactly."""
    want = _jax_pt_steps(2)
    cfg = Config(grid_width=COLS, grid_height=ROWS,
                 path_tracer=PathTracerConfig(**PT_CFG))
    cfg, scene, state, step = FS.demo_setup(cfg, backend="pathtrace",
                                            device="cpu")
    state = state.add_ripple(20.0, 6.0)
    n_ov = 0
    for f, (_jchars, ja) in enumerate(want):
        ins = TC.CameraInputs.from_keys(MOVES[f])
        state, chars, _tint, frame = step(scene, state, ins, 1.0 / 60, 60.0)
        _eq(frame.a.numpy(), ja, f"alpha, frame {f}")
        assert tuple(chars.shape) == (ROWS, COLS)
        n_ov += int(((ja >= 2) & (ja <= 254)).sum())
    assert n_ov > 2 * (2 * COLS + 2 * ROWS)  # more than the border
    assert int(state.frame_idx) == 2


# mouse-look moves that take the camera off the axis poses from the
# second frame on: (held keys, mouse_dx, mouse_dy) a frame
LOOKS = [((), 0.0, 0.0), (("w",), 37.0, -11.0), (("arrowleft",), -23.0, 5.0),
         (("a", "arrowup"), 14.0, 19.0), (("s",), -51.0, -7.0),
         (("d", "arrowdown"), 8.0, 29.0)]
# alpha cells of the 6 LOOKS steps where JAX's jitted step differs from
# its step without the outer jit (the port's rounding): the override
# plane is too coarse for the fused ray grid to move a cell
JIT_STEP_APART = 0


def test_pathtrace_look_steps_equal_jax_kernel_path(monkeypatch):
    """6 path-traced steps of demo_setup at 12 x 32, spp 2, turning with
    the mouse and the arrow keys: the alpha plane equals JAX's kernel-path
    step without the outer jit at every step (the rounding the port
    targets), and the count of cells where JAX's jitted step differs is
    recorded."""
    from ascii_renderer_tpu.ops import pt_kernel as JPK
    jitted = _jax_pt_steps(len(LOOKS), LOOKS)
    monkeypatch.setattr(JPK, "trace_blocks_raw", jax.jit(
        JPK.trace_blocks_raw, static_argnames=(
            "bounces", "nee", "atlas_w", "atlas_h", "sph_rows", "interpret",
            "layout")))
    eager = _jax_pt_steps(len(LOOKS), LOOKS, outer_jit=False)
    cfg = Config(grid_width=COLS, grid_height=ROWS,
                 path_tracer=PathTracerConfig(**PT_CFG))
    cfg, scene, state, step = FS.demo_setup(cfg, backend="pathtrace",
                                            device="cpu")
    state = state.add_ripple(20.0, 6.0)
    apart = 0
    for f, (keys, dx, dy) in enumerate(LOOKS):
        ins = TC.CameraInputs.from_keys(keys, mouse_dx=dx, mouse_dy=dy)
        state, _chars, _tint, frame = step(scene, state, ins, 1.0 / 60, 60.0)
        _eq(frame.a.numpy(), eager[f][1], f"alpha, frame {f}")
        apart += int((frame.a.numpy() != jitted[f][1]).sum())
        if f > 0:  # off the axis poses
            assert float(state.camera.yaw) != 0.0
            assert float(state.camera.pitch) != 0.0
    assert apart == JIT_STEP_APART
    assert int(state.frame_idx) == len(LOOKS)


def test_raytrace_step_raises():
    """The "raytrace" frame step (ported; the name is the test's from
    before the port): 3 steps of demo_setup at 12 x 32, a different held
    key set each frame, give the chars, tint, camera and clock of JAX's
    jitted step exactly, with no overflow."""
    jcfg = JConfig(grid_width=COLS, grid_height=ROWS)
    _jcfg, jscene, js, jstep = JFS.demo_setup(jcfg, backend="raytrace")
    cfg = Config(grid_width=COLS, grid_height=ROWS)
    cfg, scene, ts, step = FS.demo_setup(cfg, backend="raytrace",
                                         device="cpu")
    for f, keys in enumerate(MOVES):
        ji = JC.CameraInputs.from_keys(keys, mouse_dx=4.0 * f)
        ti = TC.CameraInputs.from_keys(keys, mouse_dx=4.0 * f)
        js, jchars, jtint, _jf = jstep(jscene, js, ji, 1.0 / 60, 60.0)
        ts, chars, tint, _frame = step(scene, ts, ti, 1.0 / 60, 60.0)
        _eq(chars.numpy(), jchars, f"chars, frame {f}")
        _eq(tint.numpy(), jtint, f"tint, frame {f}")
        _assert_state_equal(ts, js)
        assert int(ts.raster_overflow) == 0
    assert len(np.unique(chars.numpy())) >= 4


def test_entry_frames_equal_jax():
    """The port's entry(): 2 frames of its step from its example arguments
    ("w" held, 60 FPS) give the chars and tint of
    ``__graft_entry__.entry()`` jitted, at its full 96 x 36 grid."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "__graft_entry__.py")
    spec = importlib.util.spec_from_file_location("_graft_entry", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jfn, jargs = mod.entry()
    jfn = jax.jit(jfn)
    fn, args = TE.entry(device="cpu")
    jst, st = jargs[1], args[1]
    for f in range(2):
        jst, jchars, jtint = jfn(jargs[0], jst, *jargs[2:])
        st, chars, tint = fn(args[0], st, *args[2:])
        _eq(chars.numpy(), jchars, f"chars, frame {f}")
        _eq(tint.numpy(), jtint, f"tint, frame {f}")
        _assert_state_equal(st, jst)
    assert tuple(chars.shape) == (36, 96)
    assert len(np.unique(chars.numpy())) >= 6
