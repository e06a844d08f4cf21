"""The frame step (torch port of ``ascii_renderer_tpu/sim/framestep.py``).

One frame: camera update -> backend render -> UI char plane -> composite
into the alpha plane -> glyph decision. The reference compiles this as one
jitted program; here it runs eagerly, its kernels on the render device and
its scalar state (camera, clock, frame index, RNG key, ripple pool) on the
host; the UI layer crosses to the device by value, in the frame's byte
launch (``sim/ui.ui_params``, X12a's UI form).

FrameState is the functional analog of the `state` singleton
(js/main.js:18-63). Its RNG is the key data of ``jax.random.key(seed)``
(two uint32 words), and each path-traced frame draws with
``fold_in(rng, frame_idx)`` exactly as the reference's step does
(``core/threefry``, computed on the host: one scalar per frame). The
path-trace kernel's seed is the last word of that key; the XLA core,
which takes atlases above the kernel's budget, draws under the key.

Rounding follows the compiled reference: the camera integrator and the
clock ``time_ms + dt_s * 1000`` fuse their products into the adds
(core/fp.py), so camera and clock stay bit-identical over any number of
frames.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ascii_renderer_tpu_torch.ascii.ascii_pass import glyph_decide
from ascii_renderer_tpu_torch.core.camera import (Camera, CameraInputs,
                                                  update_camera)
from ascii_renderer_tpu_torch.core import threefry
from ascii_renderer_tpu_torch.core.config import Config
from ascii_renderer_tpu_torch.core.fp import fma32
from ascii_renderer_tpu_torch.core.frame import Frame
from ascii_renderer_tpu_torch.core.quantize import fdiv
from ascii_renderer_tpu_torch.scene.builder import SceneData
from ascii_renderer_tpu_torch.sim import ui as ui_mod

def key_data(seed: int) -> np.ndarray:
    """The key data of ``jax.random.key(seed)`` (threefry2x32) for a
    32-bit seed: uint32 [2] = (0, seed)."""
    return np.array(threefry.key_data(seed), np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.fold_in(key, data))`` for a
    threefry key's data ``key`` (uint32 [2]) (core/threefry.py)."""
    return np.array(threefry.fold_in(key, data), np.uint32)


@dataclasses.dataclass(frozen=True)
class FrameState:
    camera: Camera
    time_ms: torch.Tensor  # f32 0-d clock (performance.now analog), host
    frame_idx: torch.Tensor  # i32 0-d, host
    # i64 [2]: the uint32 words of the key data, host; a PRNG key to
    # utils/checkpoint (stored as its key words, as JAX stores a key)
    rng: torch.Tensor = dataclasses.field(metadata={"prng_key": True})
    ripples: torch.Tensor  # f32 [MAX_RIPPLES, 3] (x, y, start_ms), host
    n_ripples: torch.Tensor  # i32 0-d, host
    # i32 0-d, nonzero iff the last raster frame overflowed its fixed
    # raster_caps and geometry was dropped: the caller must rebuild the
    # step with larger caps. On the render device (reading it syncs); 0
    # for the other backends and for capless raster.
    raster_overflow: torch.Tensor

    @staticmethod
    def create(camera: Camera, seed: int = 0) -> "FrameState":
        return FrameState(
            camera=camera,
            time_ms=torch.zeros((), dtype=torch.float32),
            frame_idx=torch.zeros((), dtype=torch.int32),
            rng=torch.from_numpy(key_data(seed).astype(np.int64)),
            ripples=torch.zeros((ui_mod.MAX_RIPPLES, 3), dtype=torch.float32),
            n_ripples=torch.zeros((), dtype=torch.int32),
            raster_overflow=torch.zeros((), dtype=torch.int32),
        )

    def replace(self, **kw) -> "FrameState":
        return dataclasses.replace(self, **kw)

    def add_ripple(self, x, y) -> "FrameState":
        """Register a click ripple (handleGameClickAt, js/main.js:378-386).
        The pool is a ring buffer of MAX_RIPPLES slots."""
        slot = int(self.n_ripples) % ui_mod.MAX_RIPPLES
        ripples = self.ripples.clone()
        ripples[slot] = torch.stack([torch.tensor(float(x)),
                                     torch.tensor(float(y)), self.time_ms])
        return self.replace(ripples=ripples, n_ripples=torch.clamp(
            self.n_ripples + 1, max=ui_mod.MAX_RIPPLES))


def _i32_zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _render_rgb_a(backend: str, scene: SceneData, cam: Camera, time_s,
                  key, cfg: Config, rows: int, cols: int, soup=None,
                  raster_caps=None, pt_packed=None, prep=None):
    """Dispatch to a backend's render function: (rgb f32 [rows, cols, 3],
    alpha u8 [rows, cols] or None, overflow i32 0-d)."""
    if backend == "raytrace":
        from ascii_renderer_tpu_torch.backends.raytrace import render_rgb
        rgb = render_rgb(scene, cam, rows, cols, cfg.pixel_aspect,
                         prims=prep(scene))
        return rgb, None, _i32_zero(rgb.device)
    if backend == "raster":
        from ascii_renderer_tpu_torch.backends import raster as R
        if not raster_caps:
            rgb = R.render_soup(*soup, scene, cam, rows, cols,
                                cfg.pixel_aspect)
            return rgb, None, _i32_zero(rgb.device)
        pos9, attrs_t = prep(scene)
        c = raster_caps
        if len(c) == 5:
            # the grouped pipeline's contract (suggest_caps_grouped; c[4] is
            # the bin capacity): fixed caps cannot retry, so the count of
            # exceeded caps is reported instead
            rgb, diag = R.render_soup_diag(
                *soup, scene, cam, rows, cols, cfg.pixel_aspect,
                kernel=R.HEADLINE_KERNEL, v_cap=c[0], big_cap=c[1],
                r_cap=c[2], pair_cap=c[3], tile_cap=c[4], pos9=pos9,
                attrs_t=attrs_t)
            over = ((diag["n_big"] > c[1]).to(torch.int32)
                    + (diag["n_rows"] > c[2]).to(torch.int32)
                    + (diag["n_pairs"] > c[3]).to(torch.int32)
                    + (diag["n_tiles_nz"] > c[4]).to(torch.int32))
        else:  # (v_cap, big_cap): the mid-scale channel pipeline
            rgb, diag = R.render_soup_diag(
                *soup, scene, cam, rows, cols, cfg.pixel_aspect,
                kernel="mm", v_cap=c[0], big_cap=c[1], pos9=pos9)
            over = ((diag["n_valid"] > c[0]).to(torch.int32)
                    + (diag["n_big"] > c[1]).to(torch.int32))
        return rgb, None, over
    if backend == "pathtrace":
        from ascii_renderer_tpu_torch.backends.pathtrace import (atlas_ok,
                                                                 render_pt)
        pt = cfg.path_tracer
        # the megakernel unless the atlas is above its budget, then the
        # XLA core under the frame's key (the reference's routing)
        rgb, a = render_pt(scene, cam, time_s, key=key, rows=rows, cols=cols,
                           pixel_aspect=cfg.pixel_aspect,
                           spp=pt.samples_per_batch, bounces=pt.max_bounces,
                           light_color=pt.light_color,
                           nee=pt.direct_light_sampling,
                           use_kernel=atlas_ok(scene), packed=pt_packed,
                           light_host=prep(scene))
        return rgb, a, _i32_zero(rgb.device)
    raise ValueError(f"unknown backend {backend!r}")


def _step_body(cfg: Config, backend: str, rows: int, cols: int, soup,
               raster_caps, pt_packed, prep, scene: SceneData,
               state: FrameState, inputs: CameraInputs, dt_s, fps):
    """One frame: update_camera -> backend render -> UI char plane ->
    alpha-protocol composite -> glyph decision."""
    dt = torch.tensor(float(dt_s), dtype=torch.float32)
    cam = update_camera(state.camera, inputs, dt)
    time_ms = fma32(dt, 1000.0, state.time_ms)  # the product fuses
    key = fold_in(state.rng.numpy(), int(state.frame_idx))

    rgb, a, overflow = _render_rgb_a(backend, scene, cam,
                                     fdiv(time_ms, 1000.0), key, cfg, rows,
                                     cols, soup=soup, raster_caps=raster_caps,
                                     pt_packed=pt_packed, prep=prep)
    with record_function("frame.compose"):  # X12a's UI form: one launch
        ui = ui_mod.ui_params(cfg, rows, cols, fps, state.ripples,
                              state.n_ripples, time_ms)
        frame = Frame.from_float(rgb, a, ui=ui)

    chars, tint = glyph_decide(
        frame, ramp=cfg.ascii_ramp, mode_on=cfg.ascii_mode_filter,
        mode_radius=cfg.mode_radius, mode_thresh=cfg.ascii_mode_thresh,
        grayscale=cfg.use_grayscale)

    new_state = state.replace(camera=cam, time_ms=time_ms,
                              frame_idx=state.frame_idx + 1,
                              raster_overflow=overflow)
    return new_state, chars, tint, frame


def _per_scene(fn):
    """fn(scene), computed again only when the step is called with another
    scene (the reference constant-folds such tables into its compiled
    step)."""
    memo = {}

    def get(scene):
        if memo.get("scene") is not scene:
            memo["scene"], memo["value"] = scene, fn(scene)
        return memo["value"]

    return get


def _body(cfg: Config, backend, rows, cols, soup, raster_caps, pt_packed):
    backend = backend or cfg.default_backend
    rows = rows or cfg.grid_height
    cols = cols or cfg.grid_width
    if backend == "raster":  # the static channel-major soup tables
        from ascii_renderer_tpu_torch.backends.raster import soup_static_prep
        prep = _per_scene(lambda s: soup_static_prep(*soup, s))
    elif backend == "raytrace":  # the primitive channels and light counts
        from ascii_renderer_tpu_torch.backends.raytrace import ScenePrims
        prep = _per_scene(ScenePrims)
    else:  # the light sphere's fixed values, read to the host once
        from ascii_renderer_tpu_torch.backends.pathtrace import (
            light_sphere_host)
        prep = _per_scene(light_sphere_host)

    def body(scene, state, inputs, dt_s, fps):
        return _step_body(cfg, backend, rows, cols, soup, raster_caps,
                          pt_packed, prep, scene, state, inputs, dt_s, fps)

    return body


def make_frame_step(cfg: Config, backend: str | None = None,
                    rows: int | None = None, cols: int | None = None,
                    soup=None, raster_caps=None, pt_packed=None) -> Callable:
    """Build the frame step:

      step(scene, state, inputs, dt_s, fps) ->
          (state', chars u8 [H, W], tint u8 [H, W, 3], Frame)

    on the device of ``soup`` (raster) or of ``scene`` (pathtrace).

    raster_caps (backend 'raster' only): a 5-tuple from
    backends.raster.suggest_caps_grouped, (v_cap, big_cap, r_cap, pair_cap,
    bin_cap), runs the grouped headline pipeline; a 2-tuple (v_cap,
    big_cap) the mid-scale channel pipeline. Fixed caps do not retry, so an
    overflowing frame sets state'.raster_overflow to the count of exceeded
    caps, and the caller rebuilds the step with regrown caps. With
    raster_caps=None the uncapped exact path runs (render_soup) and
    raster_overflow is 0.

    pt_packed (backend 'pathtrace'): the scene's pack_scene_entries tuple,
    computed once per scene; it must describe the scene passed at call
    time (as ``soup`` must for raster)."""
    return _body(cfg, backend, rows, cols, soup, raster_caps, pt_packed)


def make_batched_frame_step(cfg: Config, backend: str | None = None,
                            rows: int | None = None, cols: int | None = None,
                            soup=None, raster_caps=None,
                            pt_packed=None) -> Callable:
    """N frames per call (the reference scans the step over a frame
    sequence; here it is a loop):

      step_n(scene, state, inputs_seq, dt_seq, fps) ->
          (state', chars u8 [N, H, W], tint u8 [N, H, W, 3])

    inputs_seq is a CameraInputs with [N]-leading fields (see
    broadcast_inputs); dt_seq f32 [N]. The FPS readout uses the one fps
    value for the whole batch."""
    body = _body(cfg, backend, rows, cols, soup, raster_caps, pt_packed)

    def step_n(scene: SceneData, state: FrameState, inputs_seq, dt_seq, fps):
        chars_n, tint_n = [], []
        for i in range(len(dt_seq)):
            inputs = CameraInputs(**{
                f.name: getattr(inputs_seq, f.name)[i]
                for f in dataclasses.fields(CameraInputs)})
            state, chars, tint, _frame = body(scene, state, inputs,
                                              float(dt_seq[i]), fps)
            chars_n.append(chars)
            tint_n.append(tint)
        return state, torch.stack(chars_n), torch.stack(tint_n)

    return step_n


def broadcast_inputs(inputs: CameraInputs, n: int) -> CameraInputs:
    """Stack one CameraInputs into an [n]-leading trajectory (held keys)."""
    return CameraInputs(**{
        f.name: getattr(inputs, f.name)[None].expand(n).clone()
        for f in dataclasses.fields(CameraInputs)})


def demo_setup(cfg: Config | None = None, backend: str | None = None,
               builder=None, batch: int = 0, device="cuda"
               ) -> Tuple[Config, SceneData, FrameState, Callable]:
    """Scene + initial state + step (init() analog, js/main.js:173-314),
    on ``device``. ``builder`` overrides the demo scene. batch > 0 returns
    the N-frame step (make_batched_frame_step) instead."""
    cfg = cfg or Config()
    backend = backend or cfg.default_backend
    if builder is None:
        from ascii_renderer_tpu_torch.atlas.io import demo_atlas
        from ascii_renderer_tpu_torch.scene.demo import create_demo_scene
        sb = create_demo_scene()
        sb.set_atlas(demo_atlas())
        if backend == "raster":
            sb.set_env_light([0.25, 0.27, 0.3], 1.0)
    else:
        sb = builder
    # exact primitive counts: the tracer streams pay per padded entry
    scene = sb.build(min_pad=1, device=device)
    soup = None
    pt_packed = None
    if backend == "raster":
        from ascii_renderer_tpu_torch.geom.tessellate import tessellate_scene
        soup = tuple(torch.from_numpy(x).to(device)
                     for x in tessellate_scene(scene))
    elif backend == "pathtrace":
        from ascii_renderer_tpu_torch.backends.pathtrace import (
            pack_scene_entries)
        pt_packed = pack_scene_entries(scene)
    state = FrameState.create(scene.camera)
    make = make_batched_frame_step if batch > 0 else make_frame_step
    return cfg, scene, state, make(cfg, backend, soup=soup,
                                   pt_packed=pt_packed)
