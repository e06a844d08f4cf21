"""A/B of the path-trace megakernel B5, the bin walks B6 / B6', the
fused-shading walk B8, the grouped walks B1, B9d, B9e and B9f, the
subtile walks B9a, B9b and B9c, the modal vote B4, the packs B3, B7 and
B7', the raster front end's clip X4 and plane table X3, the ray tracer's
frame K3, the bin walk's entries X9, the frame median and busy time of the
path tracer's frames, and the median, busy time and launches of the paths
the kernels for XLA code serve, between two checkouts of the repo on one
card.

Each side runs in its own process with its own checkout's
``ascii_renderer_tpu_torch`` (kernels built from that checkout's
``ops/csrc``), in turns: other, this, this, other. A side times, by the
profiler's kernel rows over 50 back-to-back calls (``chip_smoke
._device_ms``, whose row count check takes the side's launches per call):

- B5 at every launch shape of the PT runs (``chip_smoke._pt_batch``): the
  reference run's batch (110,592 rays) and probe (3,456), the HD arm's
  probe (518,400) and batch (4,147,200), on rays made in float64 by this
  tool (``_shared_rays``), the same on both sides;
- B6 and B6' at the shapes the binned paths give them
  (``chip_smoke.B6_TIMED``): the entry() room 96x36, the teapot 240x135 and
  the mid-scale HD arm 960x540;
- B8 at the bunny's fused call (``chip_smoke.b8_bunny_inputs``: 544 tiles,
  50,811 bin entries), B1 at the headline's frame 0
  (``chip_smoke.b1_headline_inputs``), B9d, B9e and B9f at the golden
  call's subtile3, subtile4 and K2 (subtile5) layouts
  (``chip_smoke.b9d_golden_inputs``, ``b9e_golden_inputs``,
  ``b9f_golden_inputs``), B9a at the bunny's
  visibility_subtile call (``chip_smoke.b9a_bunny_inputs``), B9b at its
  subtile call and B9c at its subtile2 call (``b9b_bunny_inputs``,
  ``b9c_bunny_inputs``), each with its side's launches per call (two where
  the walk is followed by a merge launch). The profiler rows are matched
  by name: B9d's ``walk_grouped_kernel`` (+ ``_merge``; B1's
  ``walk_grouped_skip_kernel`` does not contain it), B9e's
  ``walk_direct_kernel`` (+ ``_merge``), B9a's
  ``subtile_walk_expanded_kernel`` (+ ``_merge``), B9b's and B9c's
  ``subtile_walk_kernel`` (+ ``_merge``);
- B4 (``modal_kernel``) at 540x960, radius 2, thresh 12, on seeded random
  planes (10 indices, 10% overrides), on the same indices with no
  override and on the headline frame 0's own planes
  (``chip_smoke.b4_headline_inputs``), and at 36x96 (random);
- the span kernel (``pack_span_kernel``, one launch a span): B7 at the
  plane tables of the teapot 240x135 and the mid-scale HD arm
  (``chip_smoke._mid_prep``), B7' at [40, 69632] (spans (0, 16), (16, 40))
  and B3 at the headline frame 0's setup block
  (``chip_smoke.b3_headline_inputs``);
- the ray tracer's jitted grid (``ray_grid_jit_kernel``) over the view
  farm's 1,024 orbit poses at 96x36, the full grid (3,538,944 rays);
- the frame median (wall ms over 20 frames, ``chip_smoke._timed``) and the
  device busy ms a frame (``chip_smoke.profile_frames``, 3 frames) of the
  path tracer's reference run (96x36, spp 64) and HD arm (960x540, spp 8)
  through ``Renderer``: their ray grids are the port's own, so this is
  where a change of the ray-grid arithmetic shows (frames are not
  digested: each side's rays are its own);
- the raster front end of the small and mid paths (``front``): the clip
  with its screen setup (X4, ``ops/raster_clip.clip_screen``) and the
  plane table (X3, ``ops/plane_table.plane_table``) at the calls of the
  entry() room, the teapot 240x135 and the mid-scale HD arm, by CUDA
  events around whole calls (a side without those modules runs the torch
  chain the paths ran before them: ``setup_screen_channels(
  transform_clip_channels[9](...))`` and ``build_plane_table`` of the
  attribute lerps, then the zero row); the dicts and tables are digested;
- the ray tracer's frame after its grid (K3, ``rt_trace_kernel``, one
  launch a call through ``raytrace.trace``) at its five launch sizes on
  the driven paths: the rt_demo golden frame's first 256, 512 and 1,152
  rays and all its 3,456 (its padded slots), and the 1,024-view farm's
  3,538,944 (exact slots), outputs digested;
- the walk's front (``raster_channels.binned_entries``: X9 where the
  side's package has ``ops/bin_entries``, else the torch chain its paths
  ran) at the calls of the entry() room, the teapot 240x135 and the
  mid-scale HD arm, by CUDA events around whole calls and by the
  profiler's ``bin_`` kernel rows (the side's launches a call), outputs
  digested;
- the headline's raster.keys (``raster._subtile_pair_keys_bbox`` at its
  steady frame's bbox and big_cap: X9's bin keys where the side has
  them, else the torch chain and its sort) and raster.build (subtile8's
  ``GENERATIONS`` build at the steady caps: X10, or the torch chain), by
  CUDA events around whole calls and by the profiler's busy ms and
  launches a call, outputs digested;
- the host median, device busy ms and kernel launches a call of the
  paths the kernels for XLA code serve (``paths``): the raster headline
  frame, the entry() step, the teapot 240x135, the mid-scale HD arm, the
  ray tracer's frame and the 1,024-view farm (and its views/s), and the
  launches of the raster paths' ``raster.walk`` stage; the headline's,
  the entry() step's, the teapot's, the mid-scale HD arm's and the
  farm's outputs are digested.

Both sides' outputs must be bit-identical (a digest per kernel and shape);
the inputs are built by the side's own package from this checkout's
``chip_smoke.py``. Run from the repo root on a machine with one NVIDIA GPU,
with the other checkout unpacked in a git-ignored directory:

    python3 -m ascii_renderer_tpu_torch.tools.kernel_ab --other DIR

``--only bins`` times the raster's bins alone (X9 at the room, teapot and
mid HD calls, the headline's raster.keys and raster.build, and the
``paths``), a few minutes less a side. ``--only shade`` times the raster's
deferred shade K2 at its callers' recorded inputs (the headline's grouped
tiles, the mid-scale HD arm's plane table, the entry() room's and the
subtile path's compacted tiles: device ms, the whole call, launches a
call), the headline's shade and assembly as the side runs them (K2's
image form, one launch, or K2 over the groups and the torch assembly:
device ms of every kernel row, the whole call, launches a call; the image
digested) and the grouped layout build X10 at the headline's steady frame
(raster.build's whole call, busy ms and launches, and X10's kernel rows),
then the headline frame (median, busy ms, launches, the host ms and
launches of raster.shade and raster.assemble), ~2 min a side.
``--only rt`` times the ray tracer's render path (``rt_frames``):
``render_rgb`` at K3's five launch sizes on the driven paths (a side
whose K3 has no grid form launches the jitted grid kernel and K3: their
device ms summed; one with it, K3 alone), the whole call, and K3 alone on
the jitted grid kernel's rays (the rd3 form, which both sides have); the
host's ``camera_bases`` at the farm's 1,024 poses, then the ray tracer's
frame and the farm (median, busy ms, launches, rt.grid's host ms,
views/s), and, where the side's grid has a trig form, rt.grid in its parts
at the farm (``rt_grid_parts``), about a minute a side; every rgb
digested, so both sides' frames are the same bits.
``--only glyph`` times the host's camera chains and the glyph tail
(``glyph_tail``): ``camera_mvp`` at the golden camera and
``camera_bases`` at one pose and the farm's 1,024 (host ms, median of
20), and in this checkout each of its two forms at 1, 8, 16 and 1,024
poses (``_bases_forms``); the frame step's ``frame.compose`` in its
parts and whole as the side runs it (the UI layer by value and X12a's UI
form, or the UI plane and X12a with it; no ripple and 16, after a
synchronisation and right after an entry() step: ``_compose_parts``,
frames digested); ``Frame.from_float`` then ``glyph_decide`` (mode filter on, radius
2) at the headline's frame 0 float rgb, a 36x96 frame and the farm's
[1024, 36, 96] (the whole call by CUDA events, busy ms and launches a
call by the profiler; chars digested); B4's int form at the planes the
``all`` mode times; then the headline frame, the entry() step, the ray
tracer's frame, the PT reference run, the "pathtrace" frame step and the
farm (median, busy ms,
launches, and the host ms and launches a frame of the stages
``chip_smoke.TAIL_STAGES``), about 3 minutes a side.
``--only pt`` times the path tracer's kernel-path frames (``pt_frames``):
the PT reference run (96x36, spp 64), the HD arm (960x540, spp 8), the
"pathtrace" frame step (96x36) and the progressive tracer (960x540, spp
8 a batch) twice: the camera moved every batch (every pixel active; a
side whose tracer traces a moved batch in full skips the compaction)
and the camera still (the stream compacted to the active pixels): the
median (wall ms over 20 calls), device busy ms, kernel launches a call,
and the host ms and launches a call of the stages ``pt.setup``,
``pt.rays``, ``pt.trace``, ``pt.reduce`` and ``accum.step`` (and, apart,
the host-to-device copies among them); the reference run's, the HD
arm's and each progressive tracer's first batch's alpha planes
digested (their rgb may differ in the last bits: a side whose fold sums
in another order); then the frame's kernels at the launches its paths
make (``pt_kernels``): X7 at the HD arm's batch and the reference
batch, X14 at the reference run's two launches and the HD arm's, B5 at
110,592 and 4,147,200 rays in the form the side's frames launch (the
light and the origin by value where the side has ``trace_frame``),
each output digested; about 2 minutes a side.
``--only front`` times the raster front end of the small and mid paths
(``front_frames``): the entry() room's clip and plane table as one whole
call (X4's table form where the side has it, else X4 then X3 on the same
attributes: device ms of every kernel row, and CUDA events), X4
(``raster_clip_kernel``) and X3 (``plane_table_kernel``) at each size
their callers give them (the room's 812 slots and 1,624 uncompacted rows,
the teapot's, the mid-scale HD arm's and the bunny's fused and subtile
calls, chip_smoke._front_calls), every output digested; then the entry()
step (median, busy ms, launches a step, and the host ms and launches of
its raster.clip and raster.shade stages), about 2 minutes a side.
``--only k1`` times K1's (``fma32``) two largest call sites as they now
run (``k1_frames``): the bunny's fused clip with its attribute slots as
one whole call (X4's slots form where the side has it, else X4 and the
torch chain of the lerps: device ms of every kernel row, CUDA events,
launches a call), then the fused and subtile2 golden-pose frames
(median, busy ms, launches a frame, and the host ms and launches of
their raster.setup, raster.clip, raster.pack and raster.build stages),
the outputs digested, about 2 minutes a side.
``--only partition`` times X13, the stable partition (``partition_frames``):
its channels form at the teapot's, the mid-scale HD arm's and the
subtile golden call's ``compact_valid_ch`` inputs and its order form at
the progressive tracer's masks at 96x36 and 960x540 and all / none / one
pixel active (``chip_smoke._partition_chan_calls``,
``_partition_masks``): device ms of the side's own launches a call
(``launches_of``; every kernel row named ``partition_``), the whole call
by CUDA events, launches a call, every output digested; then the
progressive HD batch with the camera still (its stream compacted) and the
subtile golden-pose frame: median, busy ms, launches a call, and the host
ms and launches of their ``pt.setup`` and ``raster.compact`` stages,
about 2 minutes a side.
``--only train`` times config 5's train call (``train_frames``:
``make_train_steps(n_steps=32)`` on a ("dp", "sp") mesh of one NCCL rank,
``chip_smoke._config5``'s sphere at 36x96, one view, Adam 5e-2): the
median of 12 calls by CUDA events and its steps a second, then one call
under the profiler (device busy ms and kernel launches a call, the host
ms and launches of ``train.render``, ``train.backward``,
``train.allreduce`` and ``train.adam``). The two sides' losses round
apart (a side with X5 runs hand-written kernels, one without the torch
chain), so they are not digested: their first ``CONFIG5_SAME_STEPS``
losses are held to each other within ``CONFIG5_RTOL``. About a minute a
side.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # this checkout's root
DEVICE = "cuda:0"
PT_SHAPES = ((36, 96, 32, "reference batch"), (36, 96, 1, "reference probe"),
             (540, 960, 1, "HD probe"), (540, 960, 8, "HD arm batch"))
K3_SIZES = (256, 512, 1152, 3456)  # K3's launch sizes below the farm's
# render_rgb's calls on the driven paths at those sizes and the farm's:
# (rays, the rt_demo scene padded or with exact slots, views (0: the
# scene's camera), rows, cols, row band): dryrun_multichip(1)'s band frame
# and two-view farm, the parallel phase's bands of 12 rows, the golden
# frame, the 1,024-view farm
RT_CALLS = ((256, False, 0, 8, 32, {}), (512, False, 2, 8, 32, {}),
            (1152, True, 0, 36, 96, dict(row_lo=12, n_rows=12)),
            (3456, True, 0, 36, 96, {}), (3538944, False, 1024, 36, 96, {}))
# launches per call of a checkout whose wrapper modules predate their
# LAUNCHES_PER_CALL: B6, B6', B8 and B1 walk work items and merge, the
# others launch once. A wrong count fails _device_ms's row check
_PREDATING = {"tile_eval_bins_mm": 2, "tile_eval_bins": 2,
              "tile_eval_bins_shaded": 2, "tile_eval_grouped_skip": 2}


def _per_call(mod, wrapper: str) -> int:
    """Kernels ``mod.<wrapper>`` launches per call, by the module's
    LAUNCHES_PER_CALL."""
    return getattr(mod, "LAUNCHES_PER_CALL", _PREDATING).get(wrapper, 1)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(outs) -> str:
    import torch
    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().view(torch.int32).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _shared_rays(cs, dev, rows: int, cols: int, B: int):
    """B5's ray blocks of a rows x cols batch of B samples at the poster
    pose, made here in float64 and rounded once, so that both sides trace
    the same rays whatever their own ray grids round: the cell centres,
    samples s > 0 jittered by seeded uniform draws as render_pt jitters
    them. Blocked by the side's own ``blockify`` (an older checkout keeps
    it in the backend, as ``_blockify``)."""
    import numpy as np
    import torch
    from ascii_renderer_tpu_torch.backends import pathtrace as PT
    from ascii_renderer_tpu_torch.ops import pt_kernel as PK
    blockify = getattr(PK, "blockify", None) or PT._blockify
    cam = cs._pt_camera()
    yaw, pitch = float(cam.yaw), float(cam.pitch)
    ww = np.array([np.cos(pitch) * np.cos(yaw), np.sin(pitch),
                   np.cos(pitch) * np.sin(yaw)])
    uu = np.cross(ww, [0.0, 1.0, 0.0])
    uu /= np.linalg.norm(uu)
    vv = np.cross(uu, ww)
    focal = 1.0 / np.tan(0.5 * float(cam.fov_y))
    aspect = cols / rows * cs.PIXEL_ASPECT
    px = (-1.0 + 2.0 * (np.arange(cols) + 0.5) / cols) * aspect
    py = -1.0 + 2.0 * (np.arange(rows)[::-1] + 0.5) / rows
    jit = np.random.default_rng(rows * cols + B).random((B, rows, cols, 2))
    jit = 2.0 * (jit - 0.5) / rows
    jit[0] = 0.0
    x = px[None, None, :] + jit[..., 0] * aspect
    y = py[None, :, None] + jit[..., 1]
    rd = (x[..., None] * uu + y[..., None] * vv + focal * ww)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    n = B * rows * cols
    return blockify(torch.from_numpy(rd.astype(np.float32)).to(dev), n,
                    -(-n // 1024))


def worker(root: str, only: str = "all") -> dict:
    """Times the jitted ray grid, B5, B6 / B6', B8, B1, B9d, B9e, B9f, B9a,
    B9b, B9c, B4, B7, B7' and B3, the PT frames' median and busy time,
    the front end of ``front``, K3 and the walk's front
    (``rt_and_walk_front``) and the paths of ``paths``, with the package
    of checkout ``root``."""
    sys.path.insert(0, root)
    import torch

    import ascii_renderer_tpu_torch as pkg
    if not Path(pkg.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {pkg.__file__}, not {root}'s package")
    from ascii_renderer_tpu_torch.ops import ascii_kernel as AK
    from ascii_renderer_tpu_torch.ops import pack as PKS
    from ascii_renderer_tpu_torch.ops import pt_kernel as PK
    from ascii_renderer_tpu_torch.ops import raster_bins as RB
    from ascii_renderer_tpu_torch.ops import raster_group as RG
    from ascii_renderer_tpu_torch.ops import raster_subtile as RS
    from ascii_renderer_tpu_torch.ops import ray_grid as RYG
    from ascii_renderer_tpu_torch.core.camera import camera_bases
    cs = _chip_smoke()
    dev = torch.device(DEVICE)
    out = {"root": root, "jit_grid_ms": {}, "b5_ms": {}, "b6_ms": {},
           "b8_ms": {}, "b1_ms": {}, "b9d_ms": {}, "b9e_ms": {},
           "b9f_ms": {}, "b9a_ms": {}, "b9b_ms": {}, "b9c_ms": {},
           "b4_ms": {}, "b7_ms": {}, "b7s_ms": {}, "b3_ms": {},
           "frame_ms": {}, "busy_ms": {}, "digest": {}}
    if only == "bins":
        mid_preps = _mid_preps(cs, dev)
        rt_and_walk_front(cs, dev, out, mid_preps, k3=False)
        paths(cs, dev, out)
        return out
    if only == "shade":
        shade_and_build(cs, dev, out)
        return out
    if only == "rt":
        rt_frames(cs, dev, out)
        return out
    if only == "glyph":
        glyph_tail(cs, dev, out)
        return out
    if only == "pt":
        pt_frames(cs, dev, out)
        return out
    if only == "front":
        front_frames(cs, dev, out)
        return out
    if only == "k1":
        k1_frames(cs, dev, out)
        return out
    if only == "partition":
        partition_frames(cs, dev, out)
        return out
    if only == "train":
        train_frames(cs, dev, out)
        return out
    orbit = cs._orbit()
    bases = camera_bases(orbit.yaw, orbit.pitch, orbit.fov_y)
    rows, cols = cs.FARM_GRID
    out["digest"]["jitted grid farm"] = _digest([RYG.ray_grid_jit(
        bases, rows, cols, cs.PIXEL_ASPECT, dev)])
    out["jit_grid_ms"][f"farm {cs.FARM_VIEWS} views {rows}x{cols}"] = \
        cs._device_ms(lambda: RYG.ray_grid_jit(bases, rows, cols,
                                               cs.PIXEL_ASPECT, dev),
                      "ray_grid_jit_kernel", 1)
    scene = cs._pt_scene(device=dev)
    for rows, cols, B, label in PT_SHAPES:
        args, kw, _uid, n = cs._pt_batch(dev, scene, rows, cols, B, 1)
        args = (*args[:3], _shared_rays(cs, dev, rows, cols, B), *args[4:])
        out["digest"][f"B5 {label}"] = _digest(PK.trace_blocks_raw(*args,
                                                                   **kw))
        out["b5_ms"][f"{label} ({n} rays)"] = cs._device_ms(
            lambda: PK.trace_blocks_raw(*args, **kw), "pt_trace_kernel",
            _per_call(PK, "trace_blocks_raw"))
    mid_preps = _mid_preps(cs, dev)
    for label, data, offs, tiles_x, n_tiles in cs._walk_inputs(
            dev, cs._room(dev), cs._mesh("cube"), mid_preps):
        if label not in cs.B6_TIMED:
            continue
        for kern, fn in (("mm", RB.tile_eval_bins_mm),
                         ("loop", RB.tile_eval_bins)):
            d, per_call = data[kern], _per_call(RB, fn.__name__)
            out["digest"][f"B6 {kern} {label}"] = _digest(
                fn(d, offs, tiles_x, n_tiles))
            out["b6_ms"][f"{kern} {label}"] = cs._device_ms(
                lambda: fn(d, offs, tiles_x, n_tiles), "bins_walk_kernel",
                per_call)
    b8 = cs.b8_bunny_inputs(dev)
    out["digest"]["B8 bunny"] = _digest([RB.tile_eval_bins_shaded(*b8) + 0.0])
    out["b8_ms"]["bunny fused call"] = cs._device_ms(
        lambda: RB.tile_eval_bins_shaded(*b8), "shaded_walk_kernel",
        _per_call(RB, "tile_eval_bins_shaded"))
    del b8
    lay, grp_cap = cs.b1_headline_inputs(dev)
    out["digest"]["B1 headline"] = _digest(RG.tile_eval_grouped_skip(
        *lay, grp_cap))
    out["b1_ms"]["headline frame 0"] = cs._device_ms(
        lambda: RG.tile_eval_grouped_skip(*lay, grp_cap),
        "walk_grouped_skip_kernel",
        _per_call(RG, "tile_eval_grouped_skip"))
    del lay
    for walk, wrapper, kernel, layout in (
            ("B9d", "tile_eval_grouped", "walk_grouped_kernel", "subtile3"),
            ("B9e", "tile_eval_direct", "walk_direct_kernel", "subtile4"),
            ("B9f", "tile_eval_grouped_k2", "walk_grouped_k2_kernel", "K2")):
        lay, grp_cap = getattr(cs, f"{walk.lower()}_golden_inputs")(dev)
        fn = getattr(RG, wrapper)
        out["digest"][f"{walk} golden {layout}"] = _digest(fn(*lay, grp_cap))
        out[f"{walk.lower()}_ms"][f"golden call {layout}"] = cs._device_ms(
            lambda: fn(*lay, grp_cap), kernel, _per_call(RG, wrapper))
        del lay
    for walk, wrapper, kernel, path in (
            ("B9a", "tile_eval_subtile", "subtile_walk_expanded_kernel",
             "visibility_subtile"),
            ("B9b", "tile_eval_packed", "subtile_walk_kernel", "subtile"),
            ("B9c", "tile_eval_packed_d", "subtile_walk_kernel", "subtile2")):
        args = getattr(cs, f"{walk.lower()}_bunny_inputs")(dev)
        fn = getattr(RS, wrapper)
        out["digest"][f"{walk} bunny"] = _digest(fn(*args))
        out[f"{walk.lower()}_ms"][f"bunny {path}"] = cs._device_ms(
            lambda: fn(*args), kernel, _per_call(RS, wrapper))
        del args
    g = torch.Generator().manual_seed(0)
    planes = {}
    for h, w in ((540, 960), (36, 96)):
        planes[f"random {h}x{w}"] = (
            torch.randint(0, 10, (h, w), generator=g,
                          dtype=torch.int32).to(dev),
            (torch.rand((h, w), generator=g) < 0.1).to(dev))
    planes["headline frame 0 540x960"] = cs.b4_headline_inputs(dev)
    # the random indices with no override: what the valid tests cost
    planes["random, no override, 540x960"] = (
        planes["random 540x960"][0],
        torch.zeros((540, 960), dtype=torch.bool, device=dev))
    for label, (idx, ovr) in planes.items():
        out["digest"][f"B4 {label}"] = _digest(
            [AK.modal_filter_kernel(idx, ovr, 2, 12)])
        out["b4_ms"][label] = cs._device_ms(
            lambda: AK.modal_filter_kernel(idx, ovr, 2, 12), "modal_kernel",
            1)
    for label, _grid, (_c, chans, _caps) in mid_preps:
        out["digest"][f"B7 {label}"] = _digest([PKS.pack_channels(chans)])
        out["b7_ms"][f"{label} [{len(chans)}, {chans[0].numel()}]"] = \
            cs._device_ms(lambda: PKS.pack_channels(chans),
                          "pack_span_kernel", 1)
    cm = torch.randn((40, 544 * 128), generator=g).to(dev)
    spans = [(0, 16), (16, 40)]
    out["digest"]["B7' [40, 69632]"] = _digest(
        PKS.pack_channels_split(cm, spans))
    out["b7s_ms"]["[40, 69632] two spans"] = cs._device_ms(
        lambda: PKS.pack_channels_split(cm, spans), "pack_span_kernel",
        len(spans))
    from ascii_renderer_tpu_torch.core.config import Config, PathTracerConfig
    for label, cfg, rows, cols in (
            ("PT reference run 96x36 spp64", Config(), 36, 96),
            ("PT HD arm 960x540 spp8", Config(path_tracer=PathTracerConfig(
                samples_per_batch=8)), cs.ROWS, cs.COLS)):
        frame = cs.run_pt_path(cfg, rows, cols, 1, 3, label)
        out["frame_ms"][label] = statistics.median(cs._timed(frame, 20))
        out["busy_ms"][label] = cs.profile_frames(
            frame, 3, ("pt.", "frame.", "glyph"), label)[0]
    front(cs, dev, out)
    rt_and_walk_front(cs, dev, out, mid_preps)
    paths(cs, dev, out)
    cm3, spans = cs.b3_headline_inputs(dev)
    out["digest"]["B3 headline"] = _digest(
        PKS.pack_channels_split_blocked(cm3, spans))
    out["b3_ms"][f"headline {list(cm3.shape)} two spans"] = cs._device_ms(
        lambda: PKS.pack_channels_split_blocked(cm3, spans),
        "pack_span_kernel", len(spans))
    return out


def _mid_preps(cs, dev):
    """chip_smoke._mid_prep of the teapot and the mid-scale HD arm."""
    import torch
    preps = []
    for label, name, grid in (("teapot 240x135", "teapot", cs.TEAPOT_GRID),
                              ("mid-scale HD 960x540", "mid", cs.MID_GRID)):
        msoup, mcam = cs._mesh(name)
        preps.append((label, grid, cs._mid_prep(
            tuple(torch.from_numpy(x).to(dev) for x in msoup),
            cs._scene(dev), mcam, *grid)))
    return preps


def _front_fns(R, pos9, src, mvp, grid, attrs, v_cap):
    """(clip, table) of one caller: X4 and X3 where the side's package has
    them, else the torch chain its paths ran; ``v_cap`` None: the table
    uncompacted, else at a compaction to v_cap."""
    import torch
    try:
        from ascii_renderer_tpu_torch.ops import plane_table as PT
        from ascii_renderer_tpu_torch.ops import raster_clip as RCL
    except ImportError:
        PT = RCL = None
    if RCL is not None:
        def clip():
            return RCL.clip_screen(src, mvp, *grid, pos9=pos9)
    else:
        chain = R.transform_clip_channels9 if pos9 else \
            R.transform_clip_channels

        def clip():
            return R.setup_screen_channels(chain(src, mvp), *grid)
    ch = clip()
    cch, cidx = (ch, None) if v_cap is None else R.compact_valid_ch(
        dict(ch), v_cap)[:2]
    if PT is not None:
        def table():
            return PT.plane_table(cch, ch, attrs, cidx)
    else:
        def table():
            slots = (R.clip_attrs_channel_lists(attrs, ch) if cidx is None
                     else R.clip_attrs_compact_lists(attrs, ch, cidx))
            t = R.build_plane_table(cch, slots)
            return torch.cat([t, t.new_zeros((1, t.shape[1]))])
    return clip, table


def front(cs, dev, out) -> None:
    """X4 and X3 (or the side's torch chains) at the calls of the entry()
    room (positions, the table uncompacted, 9 attributes), the teapot and
    the mid-scale HD arm (pos9, the table at the steady cap, 6 attributes:
    chip_smoke._mid_prep's caps): ms a call by CUDA events over 20 calls,
    the outputs digested."""
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    out["x4_ms"], out["x3_ms"] = {}, {}
    scene, (p, n, c) = cs._room(dev)
    runs = {"entry() room 96x36": (
        False, p, R.camera_mvp(scene.camera, *cs.ENTRY_GRID, cs.PIXEL_ASPECT),
        cs.ENTRY_GRID, torch.cat([n, c, p], dim=1), None)}
    for label, name, grid in (("teapot 240x135", "teapot", cs.TEAPOT_GRID),
                              ("mid-scale HD 960x540", "mid", cs.MID_GRID)):
        msoup, mcam = cs._mesh(name)
        mp, mn, mc = (torch.from_numpy(x).to(dev) for x in msoup)
        mscene = cs._scene(dev)
        caps = cs._mid_prep((mp, mn, mc), mscene, mcam, *grid)[2]
        parts = [mn, mc] + ([mp] if mscene.pt_pos.shape[0] else [])
        runs[label] = (True, R.positions_to_pos9(mp), R.camera_mvp(
            mcam, *grid, cs.PIXEL_ASPECT), grid, torch.cat(parts, dim=1),
            caps[0])
    for label, (pos9, src, mvp, grid, attrs, v_cap) in runs.items():
        clip, table = _front_fns(R, pos9, src, mvp, grid, attrs, v_cap)
        ch = clip()
        out["digest"][f"X4 {label}"] = _digest(
            [ch[k] if ch[k].dtype != torch.bool else ch[k].to(torch.int32)
             for k in sorted(ch)])
        out["digest"][f"X3 {label}"] = _digest([table()])
        out["x4_ms"][label] = cs._event_ms(clip, 20)
        out["x3_ms"][label] = cs._event_ms(table, 20)


def front_frames(cs, dev, out) -> None:
    """The raster front end of the small and mid paths (module docstring,
    ``--only front``): the entry() room's clip and table as one call, X4
    and X3 at their callers' sizes, then the entry() step."""
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.ops import plane_table as PT
    from ascii_renderer_tpu_torch.ops import raster_clip as RCL
    for key in ("front_ms", "front_call_ms", "x4_kernel_ms",
                "x3_kernel_ms", "path_ms", "path_busy_ms", "path_launches",
                "stage_ms", "stage_launches"):
        out[key] = {}
    scene, (p, n, c) = cs._room(dev)
    grid = cs.ENTRY_GRID
    mvp = R.camera_mvp(scene.camera, *grid, cs.PIXEL_ASPECT)
    attrs = torch.cat([n, c, p], dim=1)
    if hasattr(RCL, "clip_screen_table"):
        def room():
            return RCL.clip_screen_table(p, n, c, mvp, *grid)
        per_call = 1
    else:
        def room():
            ch = RCL.clip_screen(p, mvp, *grid)
            return ch, PT.plane_table(ch, ch, attrs)
        per_call = 2
    ch, table = room()
    label = f"entry() room {p.shape[0] // 3} slots, clip and table"
    out["digest"][f"front {label}"] = _digest(
        [ch[k] if ch[k].dtype != torch.bool else ch[k].to(torch.int32)
         for k in sorted(ch)] + [table])
    out["front_ms"][label] = cs._device_ms(room, None, per_call)
    out["front_call_ms"][label] = cs._event_ms(room, 20)
    soup, bscene = cs._bunny(), cs._scene(dev)
    caps = {"subtile": cs._oracle_caps(dev, soup, bscene, "subtile")[0]}
    calls = cs._front_calls(dev, soup, bscene, caps)
    room_ch = RCL.clip_screen(p, mvp, *grid)
    clips = {"entry() room": ((p, mvp, *grid), {}),
             **{k: v for k, v in calls["clip_screen"].items()
                if not k.startswith(("entry", "cube"))}}
    tables = {"entry() room, uncompacted": ((room_ch, room_ch, attrs), {}),
              **{k: v for k, v in calls["plane_table"].items()
                 if not k.startswith(("entry", "cube"))}}
    for name, fns, kernel, key in (
            ("X4", {k: (RCL.clip_screen, a, kw)
                    for k, (a, kw) in clips.items()},
             "raster_clip_kernel", "x4_kernel_ms"),
            ("X3", {k: (PT.plane_table, a, kw)
                    for k, (a, kw) in tables.items()},
             "plane_table_kernel", "x3_kernel_ms")):
        for k, (fn, a, kw) in fns.items():
            got = fn(*a, **kw)
            size = (cs._x4_slots(a, kw) if name == "X4"
                    else a[0]["sxa"].shape[0])
            shape = f"{k} ({size} {'slots' if name == 'X4' else 'rows'})"
            outs = ([got[c] if got[c].dtype != torch.bool
                     else got[c].to(torch.int32) for c in sorted(got)]
                    if name == "X4" else [got])
            out["digest"][f"{name} {shape}"] = _digest(outs)
            out[key][shape] = cs._device_ms(lambda: fn(*a, **kw), kernel, 1)
    step = cs.run_entry_path()
    label = "entry step 96x36"
    out["path_ms"][label] = statistics.median(cs._timed(step, 20))
    busy, launches, stages, host = cs.profile_frames(
        step, 5, ("raster.", "frame.", "glyph"), label)
    out["path_busy_ms"][label] = busy
    out["path_launches"][label] = launches
    for k in ("raster.clip", "raster.walk", "raster.shade"):
        out["stage_ms"][f"{label} {k}"] = host.get(k, 0.0)
        out["stage_launches"][f"{label} {k}"] = stages.get(k, 0.0)
    torch.cuda.synchronize()


# the golden-pose frames whose front stages took K1's largest call sites,
# and those stages
K1_METHODS = ("fused", "subtile2")
K1_STAGES = ("raster.setup", "raster.clip", "raster.pack", "raster.build")


def k1_frames(cs, dev, out) -> None:
    """K1's two largest call sites (module docstring, ``--only k1``): the
    bunny's fused clip with its attribute slots as one call (X4's slots
    form where the side has it, else X4 and the torch chain of the lerps),
    then the fused and subtile2 golden-pose frames."""
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.ops import plane_table as PT
    from ascii_renderer_tpu_torch.ops import raster_clip as RCL
    for key in ("k1_clip_ms", "k1_clip_call_ms", "k1_clip_launches",
                "path_ms", "path_busy_ms", "path_launches", "stage_ms",
                "stage_launches"):
        out[key] = {}
    soup, scene = cs._bunny(), cs._scene(dev)
    p, n, c = (torch.as_tensor(x).to(dev) for x in soup)
    mvp = R.camera_mvp(cs._golden_camera(), cs.ROWS, cs.COLS,
                       cs.PIXEL_ASPECT)
    if hasattr(RCL, "clip_screen_slots"):
        def clip():
            return RCL.clip_screen_slots(p, n, c, mvp, cs.ROWS, cs.COLS)
    else:
        def clip():
            ch = RCL.clip_screen(p, mvp, cs.ROWS, cs.COLS)
            return ch, PT.clip_attrs_channel_lists(
                torch.cat([n, c, p], dim=1), ch)
    ch, slots = clip()
    label = f"bunny fused {p.shape[0] // 3} slots, clip and slots"
    out["digest"][f"k1 {label}"] = _digest(
        [ch[k] if ch[k].dtype != torch.bool else ch[k].to(torch.int32)
         for k in sorted(ch)] + [x for s in slots for x in s])
    _b, per_call, _s, _h = cs.profile_frames(clip, 3, ("raster.",), label)
    out["k1_clip_launches"][label] = per_call
    out["k1_clip_ms"][label] = cs._device_ms(clip, None, per_call)
    out["k1_clip_call_ms"][label] = cs._event_ms(clip, 20)
    caps = {"fused": {},
            "subtile2": cs._oracle_caps(dev, soup, scene, "subtile2")[0]}
    for method in K1_METHODS:
        frame = cs._oracle_frame(dev, soup, scene, method, caps[method])
        label = f"{method} golden pose 960x540"
        out["digest"][f"{label} rgb"] = _digest([frame()])
        out["path_ms"][label] = statistics.median(cs._timed(frame, 10))
        busy, launches, stages, host = cs.profile_frames(
            frame, 3, ("raster.",), label)
        out["path_busy_ms"][label] = busy
        out["path_launches"][label] = launches
        for st in K1_STAGES:
            out["stage_ms"][f"{label} {st}"] = host.get(st, 0.0)
            out["stage_launches"][f"{label} {st}"] = stages.get(st, 0.0)
        torch.cuda.synchronize()


def partition_frames(cs, dev, out) -> None:
    """X13 at its driven calls, then the progressive HD still batch and
    the subtile golden-pose frame with their pt.setup and raster.compact
    stages (module docstring, ``--only partition``)."""
    import torch
    from ascii_renderer_tpu_torch.core.config import Config, PathTracerConfig
    from ascii_renderer_tpu_torch.ops import partition as PTN
    for key in ("x13_ms", "x13_call_ms", "x13_launches", "path_ms",
                "path_busy_ms", "path_launches", "stage_ms",
                "stage_launches"):
        out[key] = {}
    soup, scene = cs._bunny(), cs._scene(dev)
    caps = {"subtile": cs._oracle_caps(dev, soup, scene, "subtile")[0]}
    calls = {}
    for label, (ch, v_cap) in cs._partition_chan_calls(
            dev, soup, scene, caps, _mid_preps(cs, dev)).items():
        n = ch["valid"].shape[0]

        def chan(ch=ch, v_cap=v_cap):
            cch, cidx, count = PTN.compact_channels(dict(ch), v_cap)
            return [*(cch[k] for k in PTN.COMPACT_KEYS),
                    cch["valid"].to(torch.int32), cidx, count.reshape(1)]
        calls[f"channels form, {label} ({n} flags, v_cap {v_cap})"] = (
            chan, n)
    for label, (act, uid0, samples) in cs._partition_masks(dev).items():
        flags = act.reshape(-1)

        def order(flags=flags, uid0=uid0, samples=samples):
            slot, uid, gates = PTN.stable_order(flags, uid0, samples)
            return [slot, uid, *(gates[s] for s in sorted(gates))]
        calls[f"order form, {label} ({flags.numel()} flags)"] = (
            order, flags.numel())
    for label, (fn, n) in calls.items():
        out["digest"][f"X13 {label}"] = _digest(fn())
        per_call = PTN.launches_of(n)
        out["x13_launches"][label] = per_call
        out["x13_ms"][label] = cs._device_ms(fn, "partition_", per_call)
        out["x13_call_ms"][label] = cs._event_ms(fn, 20)
    hd_cfg = Config(path_tracer=PathTracerConfig(samples_per_batch=8))
    still = cs._progressive_tracer(dev, hd_cfg, cs.ROWS, cs.COLS, True)
    pose = cs._pt_camera()
    out["digest"]["progressive HD still batch alpha"] = _digest(
        [still.step(pose)[1].to(torch.int32)])
    frame = cs._oracle_frame(dev, soup, scene, "subtile", caps["subtile"])
    out["digest"]["subtile golden pose rgb"] = _digest([frame()])
    for label, fn, n, prefixes in (
            ("progressive HD still batch 960x540 spp8",
             lambda: still.step(pose), 10, ("pt.", "accum.")),
            ("subtile golden pose 960x540", frame, 10, ("raster.",))):
        out["path_ms"][label] = statistics.median(cs._timed(fn, n))
        busy, launches, stages, host = cs.profile_frames(fn, 3, prefixes,
                                                         label)
        out["path_busy_ms"][label] = busy
        out["path_launches"][label] = launches
        for st in ("pt.setup", "raster.compact"):
            if st in stages or st in host:
                out["stage_ms"][f"{label} {st}"] = host.get(st, 0.0)
                out["stage_launches"][f"{label} {st}"] = stages.get(st, 0.0)
        torch.cuda.synchronize()


def _train_rank(cs, v, f, cams, targets) -> dict:
    """Config 5's 32-step call on a mesh of this one rank: median ms of 12
    calls, steps/s, busy ms, launches and stage host ms of one profiled
    call, the first call's losses."""
    import numpy as np
    import torch
    from ascii_renderer_tpu_torch.parallel import train as T
    from ascii_renderer_tpu_torch.parallel.mesh import make_mesh
    dev = torch.device(DEVICE)
    rows, cols = cs.CONFIG5_GRID
    mesh = make_mesh((1, 1), ("dp", "sp"))
    steps = T.make_train_steps(mesh, torch.as_tensor(f, device=dev), rows,
                               cols, n_steps=cs.CONFIG5_STEPS,
                               optimizer=T.adam(cs.CONFIG5_LR))
    state0 = T.init_train_state(v, np.full_like(v, 0.5), device=dev)
    tgt = targets.to(dev)

    def call():
        return steps(state0, cams, tgt)

    losses = call()[1].cpu().tolist()
    ms = [cs._event_once(call)[1] for _ in range(12)]
    busy, launches, stages, host = cs.profile_frames(
        call, 1, ("train.",), f"config 5 train call ({cs.CONFIG5_STEPS} "
        f"steps)")
    med = statistics.median(ms)
    return {"ms": med, "steps_s": 1e3 * cs.CONFIG5_STEPS / med,
            "busy": busy, "launches": launches, "losses": losses,
            "stage_ms": host, "stage_launches": stages}


def train_frames(cs, dev, out) -> None:
    """Config 5's train call (module docstring, ``--only train``)."""
    from ascii_renderer_tpu_torch.parallel.mesh import run_world
    v, f, cams, targets = cs._config5("cpu")
    r = run_world(_train_rank, 1, "cuda", cs, v, f, cams, targets)[0]
    label = f"config 5 {cs.CONFIG5_STEPS}-step call"
    out["path_ms"] = {label: r["ms"]}
    out["path_busy_ms"] = {label: r["busy"]}
    out["path_launches"] = {label: r["launches"]}
    out["steps_s"] = {label: r["steps_s"]}
    out["stage_ms"] = {f"{label} {k}": x for k, x in r["stage_ms"].items()}
    out["stage_launches"] = {f"{label} {k}": x
                             for k, x in r["stage_launches"].items()
                             if not k.endswith(("HtoD", "DtoH"))}
    out["losses"] = r["losses"]


def rt_and_walk_front(cs, dev, out, mid_preps, k3=True) -> None:
    """K3 at its five launch sizes on the driven paths (the golden frame's
    first 256, 512 and 1,152 rays and all its 3,456, and the farm's rays;
    profiler kernel rows; not with ``k3`` False) and the walk's front at
    the entry() room's, the teapot's and the mid-scale HD arm's calls
    (CUDA events over 20 whole calls; X9's ``bin_`` kernel rows)."""
    from ascii_renderer_tpu_torch.backends import raster_channels as RC
    from ascii_renderer_tpu_torch.backends.raytrace import trace
    from ascii_renderer_tpu_torch.scene.demo import create_rt_demo_scene
    out["k3_ms"], out["x9_ms"], out["x9_kernel_ms"] = {}, {}, {}
    try:
        from ascii_renderer_tpu_torch.ops import bin_entries as BE
    except ImportError:
        BE = None
    if not k3:
        runs = []
    else:
        golden = create_rt_demo_scene().build(device=dev)
        farm = create_rt_demo_scene().build(min_pad=1, device=dev)
        g_args = (golden, *cs._rt_inputs(golden, golden.camera,
                                         *cs.FARM_GRID, dev))
        runs = [(f"golden frame's first {n} rays",
                 (*g_args[:3], g_args[3][:, :n].contiguous()))
                for n in K3_SIZES]
        runs.append(("farm 3538944 rays", (farm, *cs._rt_inputs(
            farm, cs._orbit(), *cs.FARM_GRID, dev))))
    for label, args in runs:
        out["digest"][f"K3 {label}"] = _digest([trace(*args)])
        out["k3_ms"][label] = cs._device_ms(lambda: trace(*args),
                                            "rt_trace_kernel", 1)
    for label, grid, ch in cs._walk_chans(dev, cs._room(dev),
                                          cs._mesh("cube"), mid_preps):
        if label not in cs.B6_TIMED:
            continue

        def fn(ch=ch, grid=grid):
            return RC.binned_entries(dict(ch), *grid, kernel="mm")
        out["digest"][f"X9 {label}"] = _digest(fn()[:2])
        out["x9_ms"][label] = cs._event_ms(fn, 20)
        if BE is not None:  # the side's kernels: its launches a call
            out["x9_kernel_ms"][label] = cs._device_ms(
                fn, "bin_", getattr(BE, "last_launches", 4))


def rt_frames(cs, dev, out) -> None:
    """The ray tracer's render path at RT_CALLS: ``render_rgb``'s device
    ms (profiler rows of the jitted grid kernel and K3 over 50 calls, the
    side's launches a call: 2 where its render path launches the grid
    kernel, 1 where K3 computes the rays) and whole call (CUDA events over
    20 calls), rgb digested, and K3's device ms on the grid kernel's rays
    (``raytrace.trace``, the rd3 form); the host ms of ``camera_bases``
    at the farm's 1,024 poses (median of 20); then the ray tracer's frame
    and the farm through chip_smoke's run_rt_path and run_farm_path
    (median, busy ms and launches a call, rt.grid's host ms, views/s)."""
    import time
    import torch
    from ascii_renderer_tpu_torch.backends.raytrace import (ScenePrims,
                                                            render_rgb,
                                                            trace)
    from ascii_renderer_tpu_torch.core.camera import camera_bases
    from ascii_renderer_tpu_torch.ops import rt_trace as RTK
    from ascii_renderer_tpu_torch.parallel.mesh import orbit_cameras
    from ascii_renderer_tpu_torch.scene.demo import create_rt_demo_scene
    per_call = 1 if hasattr(RTK, "Grid") else 2
    for key in ("rt_ms", "rt_call_ms", "rt_launches", "k3_rd3_ms",
                "bases_ms", "path_ms", "path_busy_ms", "path_launches",
                "stage_ms"):
        out[key] = {}
    for rays, padded, views, rows, cols, kw in RT_CALLS:
        scene = create_rt_demo_scene().build(
            **({} if padded else dict(min_pad=1)), device=dev)
        pr = ScenePrims(scene)
        cams = (orbit_cameras(views, center=(0, 1.0, 1.0)) if views
                else scene.camera)

        def call(scene=scene, cams=cams, rows=rows, cols=cols, kw=kw,
                 pr=pr):
            return render_rgb(scene, cams, rows, cols, cs.PIXEL_ASPECT,
                              prims=pr, **kw)

        label = f"render_rgb {rays} rays"
        out["digest"][label] = _digest([call()])
        out["rt_ms"][label] = cs._device_ms(
            call, ("ray_grid_jit_kernel", "rt_trace_kernel"), per_call)
        out["rt_call_ms"][label] = cs._event_ms(call, 20)
        out["rt_launches"][label] = per_call
        rays_of = (scene, *cs._rt_inputs(scene, cams, rows, cols, dev,
                                         **kw))
        out["digest"][f"K3 rd3 form {rays} rays"] = _digest(
            [trace(*rays_of)])
        out["k3_rd3_ms"][f"K3 rd3 form {rays} rays"] = cs._device_ms(
            lambda: trace(*rays_of), "rt_trace_kernel", 1)
    orbit = cs._orbit()
    ts = []
    for _ in range(21):
        t0 = time.perf_counter()
        camera_bases(orbit.yaw, orbit.pitch, orbit.fov_y)
        ts.append((time.perf_counter() - t0) * 1e3)
    out["bases_ms"][f"camera_bases {cs.FARM_VIEWS} poses"] = \
        statistics.median(ts[1:])
    farm = cs.run_farm_path(dev)
    out["digest"]["view farm chars"] = _digest([farm()])
    for label, (fn, n) in {"RT frame 96x36": (cs.run_rt_path(dev), 20),
                           "view farm 1024 x 96x36": (farm, 5)}.items():
        out["path_ms"][label] = statistics.median(cs._timed(fn, n))
        busy, launches, _st, host = cs.profile_frames(fn, 3, ("rt.", "frame.",
                                                       "glyph"), label)
        out["path_busy_ms"][label] = busy
        out["path_launches"][label] = launches
        out["stage_ms"][f"{label} rt.grid"] = host.get("rt.grid", 0.0)
        torch.cuda.synchronize()
    out["path_ms"]["view farm views/s"] = cs.FARM_VIEWS / (
        out["path_ms"]["view farm 1024 x 96x36"] / 1e3)
    if "trig" in getattr(getattr(RTK, "Grid", None), "_fields", ()):
        rt_grid_parts(cs, dev, out)


def rt_grid_parts(cs, dev, out) -> None:
    """The farm's rt.grid (1,024 views) in its parts on the host, median
    ms of 20 calls after one (``grid_parts_ms``, where the side's grid has
    a trig form): the bases form (``camera_bases`` above SCALAR_VIEWS: the
    three .tolist() calls, 5 x V libm calls, the numpy chain
    ``bases_from_trig``; then ``ops/rt_trace``'s [V, 12] cat and its copy
    to the card) and the trig form render_rgb takes on the card
    (``core/camera.view_trig``: libm once a distinct argument; the copy of
    [V, 8])."""
    import math
    import numpy as np
    import torch
    from ascii_renderer_tpu_torch.core import camera as C
    from ascii_renderer_tpu_torch.ops import rt_trace as RTK
    cams = cs._orbit()
    rows, cols = cs.FARM_GRID
    cam = cams.pos.reshape(-1, 3)
    ys, ps, fs = (x.reshape(-1).tolist() for x in (cams.yaw, cams.pitch,
                                                   cams.fov_y))
    f32 = np.float32

    def trig():
        def t(fn, xs):
            return np.fromiter(map(fn, xs), np.float64, len(xs)).astype(f32)
        return (t(math.cos, ps), t(math.sin, ps), t(math.cos, ys),
                t(math.sin, ys),
                t(math.tan, (f32(0.5) * np.array(fs, f32)).tolist()))

    tr = trig()
    grid = RTK.Grid(C.camera_bases(cams.yaw, cams.pitch, cams.fov_y), rows,
                    cols, cs.PIXEL_ASPECT, 0, rows)
    views = RTK._grid_views(grid, cam)
    table = C.view_trig(cam, cams.yaw, cams.pitch, cams.fov_y)

    def copy(x):
        x.to(dev)
        torch.cuda.synchronize()

    out["grid_parts_ms"] = {
        "bases: three .tolist()": _host_ms(lambda: [
            x.reshape(-1).tolist() for x in (cams.yaw, cams.pitch,
                                             cams.fov_y)]),
        "bases: 5 x V libm calls": _host_ms(trig),
        "bases: numpy chain": _host_ms(lambda: C.bases_from_trig(*tr)),
        "bases: camera_bases whole": _host_ms(
            lambda: C.camera_bases(cams.yaw, cams.pitch, cams.fov_y)),
        "bases: _grid_views cat": _host_ms(lambda: RTK._grid_views(grid,
                                                                   cam)),
        "bases: copy [V, 12]": _host_ms(lambda: copy(views)),
        "trig: view_trig": _host_ms(lambda: C.view_trig(
            cam, cams.yaw, cams.pitch, cams.fov_y)),
        "trig: copy [V, 8]": _host_ms(lambda: copy(torch.from_numpy(table))),
    }


def _host_ms(fn, n=21):
    """Median host ms of fn() over n - 1 calls after one warm-up."""
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts[1:])


def _bases_forms(orbit, out) -> None:
    """Both forms of ``camera_bases`` (Python floats, numpy arrays) at the
    first 1, 8 and 16 of the farm's poses and at all 1,024, host ms; a
    checkout that has one form only times nothing."""
    from ascii_renderer_tpu_torch.core import camera as C
    if not hasattr(C, "bases_arrays"):
        return
    out["forms_ms"] = {}
    for n in (1, 8, 16, orbit.yaw.numel()):
        poses = [x[:n].reshape(-1).tolist()
                 for x in (orbit.yaw, orbit.pitch, orbit.fov_y)]
        for name in ("floats", "arrays"):
            fn = getattr(C, f"bases_{name}")
            out["forms_ms"][f"camera_bases on {name}, {n} poses"] = _host_ms(
                lambda fn=fn: fn(*poses), 21 if n > 16 else 101)


def _compose_parts(cs, dev, out) -> None:
    """The frame step's ``frame.compose`` in its parts at the entry()
    step's 36x96 grid, host ms: the UI plane (``ui_char_plane``: built in
    numpy, one blocking copy to the card) and the frame's bytes with the
    UI plane burnt in (the side's own calls: ``from_float`` then
    ``with_overrides``, or ``from_float(overrides=)``), and with an alpha
    plane alone (the path tracer's call), each after a synchronisation;
    and the UI plane right after an entry() step, which
    its copy waits for."""
    import inspect
    import torch
    from ascii_renderer_tpu_torch.core.config import Config
    from ascii_renderer_tpu_torch.core.frame import Frame
    from ascii_renderer_tpu_torch.sim import ui as ui_mod
    rows, cols = cs.ENTRY_GRID
    g = torch.Generator().manual_seed(21)
    rgb = torch.rand((rows, cols, 3), generator=g).to(dev)
    a = torch.ones((rows, cols), dtype=torch.uint8, device=dev)
    ripples = torch.zeros((ui_mod.MAX_RIPPLES, 3), dtype=torch.float32)
    n_rip, t_ms = torch.zeros((), dtype=torch.int32), torch.tensor(16.0)

    def ui():
        return ui_mod.ui_char_plane(Config(), rows, cols, 60.0, ripples,
                                    n_rip, t_ms, device=dev)

    ui_c, ui_m = ui()
    if "overrides" in inspect.signature(Frame.from_float).parameters:
        def frame():
            return Frame.from_float(rgb, a, overrides=(ui_c, ui_m))
    else:
        def frame():
            return Frame.from_float(rgb, a).with_overrides(ui_c, ui_m)

    f = frame()
    out["digest"]["frame with UI plane 36x96"] = _digest(
        [f.rgb.to(torch.int32), f.a.to(torch.int32)])
    rip16 = torch.zeros((ui_mod.MAX_RIPPLES, 3), dtype=torch.float32)
    rip16[:, 0] = torch.linspace(-10.0, 110.0, 16)
    rip16[:, 1] = torch.linspace(-5.0, 40.0, 16)
    rip16[:, 2] = -torch.linspace(0.0, 1900.0, 16)  # radii 0 to 95 at 16 ms
    n16 = torch.tensor(16, dtype=torch.int32)

    def compose(rip, n):
        """The side's whole frame.compose: the UI layer by value and X12a's
        UI form, or the UI plane and X12a with it."""
        if hasattr(ui_mod, "ui_params"):
            return Frame.from_float(rgb, a, ui=ui_mod.ui_params(
                Config(), rows, cols, 60.0, rip, n, t_ms))
        ui_p = ui_mod.ui_char_plane(Config(), rows, cols, 60.0, rip, n,
                                    t_ms, device=dev)
        if "overrides" in inspect.signature(Frame.from_float).parameters:
            return Frame.from_float(rgb, a, overrides=ui_p)
        return Frame.from_float(rgb, a).with_overrides(*ui_p)

    for label, args in (("no ripple", (ripples, n_rip)),
                        ("16 ripples", (rip16, n16))):
        f = compose(*args)
        out["digest"][f"frame.compose 36x96, {label}"] = _digest(
            [f.rgb.to(torch.int32), f.a.to(torch.int32)])
    step = cs.run_entry_path()

    def after_step():
        step()
        t0 = time.perf_counter()
        ui()
        return (time.perf_counter() - t0) * 1e3

    def synced(fn):
        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3
        return run

    def compose_after_step():
        step()
        t0 = time.perf_counter()
        compose(ripples, n_rip)
        return (time.perf_counter() - t0) * 1e3

    for label, fn in (("UI plane 36x96", synced(ui)),
                      ("frame bytes with UI plane 36x96", synced(frame)),
                      ("frame bytes with alpha 36x96",
                       synced(lambda: Frame.from_float(rgb, a))),
                      ("UI plane after an entry() step", after_step),
                      ("whole, 36x96", synced(lambda: compose(ripples,
                                                                n_rip))),
                      ("whole, 36x96, 16 ripples",
                       synced(lambda: compose(rip16, n16))),
                      ("whole, after an entry() step", compose_after_step)):
        out["host_ms"][f"frame.compose: {label}"] = statistics.median(
            fn() for _ in range(41))
    torch.cuda.synchronize()


def glyph_tail(cs, dev, out) -> None:
    """The host's camera chains, the glyph tail at three sizes, B4's int
    form, and the paths' tail stages (module docstring, ``--only
    glyph``)."""
    import torch
    from torch.profiler import record_function
    from ascii_renderer_tpu_torch.ascii.ascii_pass import glyph_decide
    from ascii_renderer_tpu_torch.backends.raster import camera_mvp
    from ascii_renderer_tpu_torch.core.camera import camera_bases
    from ascii_renderer_tpu_torch.core.config import Config
    from ascii_renderer_tpu_torch.core.frame import Frame
    from ascii_renderer_tpu_torch.ops import ascii_kernel as AK
    for key in ("host_ms", "tail_ms", "tail_busy_ms", "tail_launches",
                "chars_ms",
                "b4_ms", "path_ms", "path_busy_ms", "path_launches",
                "stage_ms", "stage_launches"):
        out[key] = {}
    cam = cs._golden_camera()
    out["host_ms"]["camera_mvp golden camera 540x960"] = _host_ms(
        lambda: camera_mvp(cam, cs.ROWS, cs.COLS, cs.PIXEL_ASPECT))
    out["host_ms"]["camera_bases 1 pose"] = _host_ms(
        lambda: camera_bases(cam.yaw.reshape(1), cam.pitch.reshape(1),
                             cam.fov_y.reshape(1)))
    orbit = cs._orbit()
    out["host_ms"][f"camera_bases {cs.FARM_VIEWS} poses"] = _host_ms(
        lambda: camera_bases(orbit.yaw, orbit.pitch, orbit.fov_y))
    out["digest"]["camera_mvp"] = _digest([camera_mvp(cam, cs.ROWS, cs.COLS,
                                                      cs.PIXEL_ASPECT)])
    _bases_forms(orbit, out)
    _compose_parts(cs, dev, out)
    cfg = Config(pixel_aspect=cs.PIXEL_ASPECT)
    soup, scene = cs._bunny(), cs._scene(dev)
    backend, cfg = cs.run_main_path(dev, soup, scene)
    real, seen = Frame.__dict__["from_float"], []  # the float rgb of frame 0
    Frame.from_float = staticmethod(
        lambda *a, **k: seen.append(a[0]) or real.__func__(*a, **k))
    try:
        backend.render(0.0, cam, cs.ROWS, cs.COLS, cs.PIXEL_ASPECT)
    finally:
        Frame.from_float = real
    rgb0 = seen[0]
    g = torch.Generator().manual_seed(21)
    rgbs = {"headline frame 0 540x960": rgb0,
            "random 36x96": torch.rand((36, 96, 3), generator=g).to(dev),
            "random farm 1024x36x96": torch.rand(
                (cs.FARM_VIEWS, 36, 96, 3), generator=g).to(dev)}
    kw = dict(ramp=cfg.ascii_ramp, mode_on=True, mode_radius=2,
              mode_thresh=12, grayscale=False)
    for label, rgb in rgbs.items():
        def tail(rgb=rgb):
            with record_function("frame.from_float"):
                frame = Frame.from_float(rgb)
            return glyph_decide(frame, **kw)[0]

        out["digest"][f"glyph tail {label}"] = _digest(
            [tail().to(torch.int32)])
        out["tail_ms"][label] = cs._event_ms(tail, 50)
        busy, launches, _st, _host = cs.profile_frames(
            tail, 20, ("frame.", "glyph"), f"glyph tail {label}")
        out["tail_busy_ms"][label] = busy
        out["tail_launches"][label] = launches
        if hasattr(AK, "glyph_chars"):  # the chars form's kernel alone
            f = Frame.from_float(rgb)
            out["chars_ms"][label] = cs._device_ms(
                lambda f=f: AK.glyph_chars(f.rgb, f.a, cfg.ascii_ramp,
                                           mode_on=True, radius=2,
                                           thresh=12), "modal_kernel", 1)
    planes = {"random 540x960": (
        torch.randint(0, 10, (540, 960), generator=g,
                      dtype=torch.int32).to(dev),
        (torch.rand((540, 960), generator=g) < 0.1).to(dev)),
        "headline frame 0 540x960": cs.b4_headline_inputs(dev, soup, scene)}
    planes["random 36x96"] = tuple(x[:36, :96].contiguous()
                                   for x in planes["random 540x960"])
    for label, (idx, ovr) in planes.items():
        out["digest"][f"B4 {label}"] = _digest(
            [AK.modal_filter_kernel(idx, ovr, 2, 12)])
        out["b4_ms"][label] = cs._device_ms(
            lambda: AK.modal_filter_kernel(idx, ovr, 2, 12), "modal_kernel",
            1)

    def headline():
        return cs._frame(backend, cfg, cam)[1]

    farm = cs.run_farm_path(dev)
    out["digest"]["headline frame 0 chars"] = _digest([headline()])
    out["digest"]["view farm chars"] = _digest([farm()])
    runs = {"headline frame 960x540": (headline, 20, "raster."),
            "entry step 96x36": (cs.run_entry_path(), 20, "raster."),
            "RT frame 96x36": (cs.run_rt_path(dev), 20, "rt."),
            "PT reference run 96x36 spp64": (cs.run_pt_path(
                Config(), 36, 96, 1, 3, "PT reference run"), 20, "pt."),
            "PT frame step 96x36": (cs.run_pt_step_path(dev), 10, "pt."),
            "view farm 1024 x 96x36": (farm, 5, "rt.")}
    for label, (fn, n, stage) in runs.items():
        out["path_ms"][label] = statistics.median(cs._timed(fn, n))
        busy, launches, stages, host = cs.profile_frames(
            fn, 3, (stage, "frame.", "glyph"), label)
        out["path_busy_ms"][label] = busy
        out["path_launches"][label] = launches
        for k in cs.TAIL_STAGES:
            if k in host:
                out["stage_ms"][f"{label} {k}"] = host[k]
                out["stage_launches"][f"{label} {k}"] = stages.get(k, 0.0)
        torch.cuda.synchronize()
    out["path_ms"]["view farm views/s"] = cs.FARM_VIEWS / (
        out["path_ms"]["view farm 1024 x 96x36"] / 1e3)
    if "trig" in getattr(getattr(RTK, "Grid", None), "_fields", ()):
        rt_grid_parts(cs, dev, out)


def rt_grid_parts(cs, dev, out) -> None:
    """The farm's rt.grid (1,024 views) in its parts on the host, median
    ms of 20 calls after one (``grid_parts_ms``, where the side's grid has
    a trig form): the bases form (``camera_bases`` above SCALAR_VIEWS: the
    three .tolist() calls, 5 x V libm calls, the numpy chain
    ``bases_from_trig``; then ``ops/rt_trace``'s [V, 12] cat and its copy
    to the card) and the trig form render_rgb takes on the card
    (``core/camera.view_trig``: libm once a distinct argument; the copy of
    [V, 8])."""
    import math
    import numpy as np
    import torch
    from ascii_renderer_tpu_torch.core import camera as C
    from ascii_renderer_tpu_torch.ops import rt_trace as RTK
    cams = cs._orbit()
    rows, cols = cs.FARM_GRID
    cam = cams.pos.reshape(-1, 3)
    ys, ps, fs = (x.reshape(-1).tolist() for x in (cams.yaw, cams.pitch,
                                                   cams.fov_y))
    f32 = np.float32

    def trig():
        def t(fn, xs):
            return np.fromiter(map(fn, xs), np.float64, len(xs)).astype(f32)
        return (t(math.cos, ps), t(math.sin, ps), t(math.cos, ys),
                t(math.sin, ys),
                t(math.tan, (f32(0.5) * np.array(fs, f32)).tolist()))

    tr = trig()
    grid = RTK.Grid(C.camera_bases(cams.yaw, cams.pitch, cams.fov_y), rows,
                    cols, cs.PIXEL_ASPECT, 0, rows)
    views = RTK._grid_views(grid, cam)
    table = C.view_trig(cam, cams.yaw, cams.pitch, cams.fov_y)

    def copy(x):
        x.to(dev)
        torch.cuda.synchronize()

    out["grid_parts_ms"] = {
        "bases: three .tolist()": _host_ms(lambda: [
            x.reshape(-1).tolist() for x in (cams.yaw, cams.pitch,
                                             cams.fov_y)]),
        "bases: 5 x V libm calls": _host_ms(trig),
        "bases: numpy chain": _host_ms(lambda: C.bases_from_trig(*tr)),
        "bases: camera_bases whole": _host_ms(
            lambda: C.camera_bases(cams.yaw, cams.pitch, cams.fov_y)),
        "bases: _grid_views cat": _host_ms(lambda: RTK._grid_views(grid,
                                                                   cam)),
        "bases: copy [V, 12]": _host_ms(lambda: copy(views)),
        "trig: view_trig": _host_ms(lambda: C.view_trig(
            cam, cams.yaw, cams.pitch, cams.fov_y)),
        "trig: copy [V, 8]": _host_ms(lambda: copy(torch.from_numpy(table))),
    }


def keys_and_build(cs, dev, out, caps) -> None:
    """The headline's raster.keys and raster.build at its steady frame's
    inputs (the golden pose's bbox and walk rows by the side's own setup
    and pack, ``caps`` the backend's lean caps): whole calls by CUDA
    events over 20 calls, device busy ms and launches a call by the
    profiler, outputs digested."""
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.ops import pack as PKS
    from ascii_renderer_tpu_torch.ops import raster_group as RG
    for key in ("keys_ms", "keys_busy_ms", "keys_launches", "build_ms",
                "build_busy_ms", "build_launches"):
        out[key] = {}
    cm, bb, spans, _T = cs._headline_setup(dev)
    src16 = PKS.pack_channels_split_blocked(cm, spans)[0]
    _v, big_cap, r_cap, pair_cap, bin_cap = caps
    tiles_x = -(-cs.COLS // 128)
    n_tiles = -(-cs.ROWS // 8) * tiles_x

    def keys():
        return R._subtile_pair_keys_bbox(bb, cs.ROWS, cs.COLS,
                                         big_cap=big_cap)

    pair_key = keys()

    def build():
        return RG.GENERATIONS["subtile8"].build(
            src16, pair_key, tiles_x, n_tiles, r_cap, pair_cap,
            bin_cap // 8)

    label = f"headline steady caps {list(caps)}"
    out["digest"]["raster.keys headline"] = _digest([pair_key])
    out["digest"]["raster.build headline"] = _digest(build())
    for name, fn in (("keys", keys), ("build", build)):
        out[f"{name}_ms"][label] = cs._event_ms(fn, 20)
        busy, launches, _st, _host = cs.profile_frames(fn, 5, ("raster.",),
                                                f"raster.{name} {label}")
        out[f"{name}_busy_ms"][label] = busy
        out[f"{name}_launches"][label] = launches
    try:  # X10's kernels, where the side has them
        from ascii_renderer_tpu_torch.ops import group_build as GB
    except ImportError:
        return
    build()
    out.setdefault("x10_ms", {})[label] = cs._device_ms(
        build, "group_build_", GB.last_launches)


def _shade_calls(cs, dev, backend, cfg):
    """{label: shade args} of K2's callers, recorded from their paths: the
    headline's grouped tiles (its steady frame), the mid-scale HD arm's
    plane table, the entry() room's and the subtile path's compacted
    tiles."""
    from ascii_renderer_tpu_torch.backends.raster import RasterBackend
    from ascii_renderer_tpu_torch.entry import entry
    from ascii_renderer_tpu_torch.ops import raster_shade as RSH
    soup, scene = cs._bunny(), cs._scene(dev)
    if hasattr(RSH, "shade_image"):  # the headline's pixels, in groups
        a = cs._capture(RSH, "shade_image", lambda: (
            cs._frame(backend, cfg, cs._golden_camera())))[0]
        calls = {"headline grouped tiles": (
            a[0], a[1], *RSH.group_centres(a[2], a[3]), a[6], a[7])}
    else:
        calls = {"headline grouped tiles": cs._capture(RSH, "shade", lambda: (
            cs._frame(backend, cfg, cs._golden_camera())))[0]}
    msoup, mcam = cs._mesh("mid")
    be = RasterBackend(cfg, device=dev)
    be.set_soup(*msoup, cs._scene(dev))
    be.render(0.0, mcam, *cs.MID_GRID, cs.PIXEL_ASPECT)
    calls["mid HD plane table"] = cs._capture(RSH, "shade", lambda: (
        be.render(0.0, mcam, *cs.MID_GRID, cs.PIXEL_ASPECT)))[0]
    fn, args = entry()
    calls["entry() room"] = cs._capture(RSH, "shade", lambda: fn(*args))[0]
    caps = cs._oracle_caps(dev, soup, scene, "subtile")[0]
    calls["subtile compacted tiles"] = cs._capture(
        RSH, "shade", cs._oracle_frame(dev, soup, scene, "subtile", caps))[0]
    return calls


def _shade_assemble(cs, backend, cfg):
    """The headline's shade and assembly at its steady frame as the side
    runs them, a function of no argument returning the image: K2's image
    form (one launch) where the side has it, else K2's grouped form over
    the groups, then ``assemble_group_image``, each at its captured
    arguments."""
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.ops import raster_group as RG
    from ascii_renderer_tpu_torch.ops import raster_shade as RSH

    def headline():
        return cs._frame(backend, cfg, cs._golden_camera())

    if hasattr(RSH, "shade_image"):
        a, k = cs._capture(RSH, "shade_image", headline)
        return lambda: RSH.shade_image(*a, **k)
    seen = []
    real = RG.assemble_group_image

    def rec(*a, **k):
        seen.append((a, k))
        return real(*a, **k)

    RG.assemble_group_image = rec
    try:
        sa, _sk = cs._capture_all(R, "shade_groups", headline)[-1]
    finally:
        RG.assemble_group_image = real
    aa, ak = seen[-1]
    return lambda: RG.assemble_group_image(R.shade_groups(*sa), *aa[1:],
                                           **ak)


def shade_and_build(cs, dev, out) -> None:
    """K2 at its callers' recorded inputs (``_shade_calls``), the
    headline's shade and assembly as the side runs them
    (``_shade_assemble``: device ms of all its kernel rows, the whole call,
    launches a call) and X10 at the headline's steady frame
    (``keys_and_build``): device ms by the profiler's kernel rows over 50
    calls, the whole call by CUDA events over 20, kernel launches a call;
    outputs digested. Then the headline frame's median, busy time,
    launches, and the host ms and launches of its raster.shade and
    raster.assemble stages."""
    import torch
    from ascii_renderer_tpu_torch.ops import raster_shade as RSH
    for key in ("k2_ms", "k2_call_ms", "k2_launches", "image_ms",
                "image_call_ms", "image_launches", "stage_ms",
                "stage_launches"):
        out[key] = {}
    soup, scene = cs._bunny(), cs._scene(dev)
    backend, cfg = cs.run_main_path(dev, soup, scene)
    keys_and_build(cs, dev, out, backend._caps)
    for label, args in _shade_calls(cs, dev, backend, cfg).items():
        def fn(args=args):
            return RSH.shade(*args)
        n0 = RSH.launches
        out["digest"][f"K2 {label}"] = _digest([fn()])
        out["k2_launches"][label] = RSH.launches - n0
        out["k2_ms"][label] = cs._device_ms(fn, "raster_shade_kernel", 1)
        out["k2_call_ms"][label] = cs._event_ms(fn, 20)
    image = _shade_assemble(cs, backend, cfg)
    label = "headline shade and assembly"
    out["digest"][label] = _digest([image()])
    n = cs.profile_frames(image, 5, ("raster.",), label)[1]
    out["image_launches"][label] = n
    out["image_ms"][label] = cs._device_ms(image, None, n)
    out["image_call_ms"][label] = cs._event_ms(image, 20)

    def headline():
        return cs._frame(backend, cfg, cs._golden_camera())[1]

    out["digest"]["headline frame 0 chars"] = _digest([headline()])
    for key in ("path_ms", "path_busy_ms", "path_launches"):
        out[key] = {}
    label = "headline frame 960x540"
    out["path_ms"][label] = statistics.median(cs._timed(headline, 20))
    busy, launches, stages, host = cs.profile_frames(
        headline, 3, ("raster.", "frame.", "glyph"), label)
    out["path_busy_ms"][label] = busy
    out["path_launches"][label] = launches
    for k in ("raster.shade", "raster.assemble"):
        out["stage_ms"][f"{label} {k}"] = host.get(k, 0.0)
        out["stage_launches"][f"{label} {k}"] = stages.get(k, 0.0)
    torch.cuda.synchronize()


PT_STAGES = ("pt.setup", "pt.rays", "pt.trace", "pt.reduce", "accum.step")


def pt_kernels(cs, dev, out) -> None:
    """The PT frame's kernels at the launches its paths make, each side's
    own form (module docstring, ``--only pt``): X7 at the HD arm's batch
    and the reference batch, X14 at the reference run's two launches and
    the HD arm's, B5 at the reference batch and the HD arm's as the
    side's frames launch it (a side with ``trace_frame``: the light and
    the origin by value; else the per-ray form on the origin block);
    outputs digested."""
    import torch
    from ascii_renderer_tpu_torch.core.camera import camera_basis
    from ascii_renderer_tpu_torch.ops import pt_kernel as PK
    from ascii_renderer_tpu_torch.ops import pt_reduce as PR
    from ascii_renderer_tpu_torch.ops import ray_grid as RYG
    out["x7_ms"], out["x14_ms"] = {}, {}
    cam = cs._pt_camera()
    basis = camera_basis(cam.yaw, cam.pitch, cam.fov_y)
    for label in ("HD arm batch", "reference batch 0"):
        args, kw, n, _pc = cs._pt_rays_call(dev, basis,
                                            *cs.PT_RAY_CALLS[label])
        out["digest"][f"X7 {label}"] = _digest([RYG.pt_rays(*args, **kw)])
        out["x7_ms"][f"{label} ({n} rays)"] = cs._device_ms(
            lambda: RYG.pt_rays(*args, **kw), "pt_rays_kernel", 1)
    for label, ((a, k), n) in cs._fold_timing_calls(dev).items():
        res = PR.fold(*a, **k)
        out["digest"][f"X14 {label}"] = _digest(
            [a[0][0], a[0][1]] if res is None else [res[0],
                                                    res[1].to(torch.int32)])
        out["x14_ms"][f"{label} ({n} rays)"] = cs._device_ms(
            lambda: PR.fold(*a, **k), "pt_reduce_kernel", 1)
    scene = cs._pt_scene(device=dev)
    for rows, cols, B, label in (PT_SHAPES[0], PT_SHAPES[3]):
        args, kw, _uid, n = cs._pt_batch(dev, scene, rows, cols, B, 1)
        args = (*args[:3], _shared_rays(cs, dev, rows, cols, B), *args[4:])
        if hasattr(PK, "trace_frame"):
            light = args[0].tolist()
            origin = cam.pos.to(torch.float32).tolist()

            def fn(args=args, kw=kw, light=light, origin=origin, pc=rows *
                   cols):
                return PK.trace_frame(light, origin, args[1], *args[3:],
                                      **kw, pc=pc, npix=pc)
        else:
            def fn(args=args, kw=kw):
                return PK.trace_blocks_raw(*args, **kw)
        out["digest"][f"B5 frame {label}"] = _digest(fn())
        out["b5_ms"][f"frame {label} ({n} rays)"] = cs._device_ms(
            fn, "pt_trace_kernel", 1)


def pt_frames(cs, dev, out) -> None:
    """The path tracer's kernel-path frames (module docstring, ``--only
    pt``): median, busy ms and launches a call, the PT_STAGES' host ms
    and launches a call (host-to-device copies apart); alpha planes
    digested; then pt_kernels."""
    import math
    import torch
    from ascii_renderer_tpu_torch.backends.registry import Renderer
    from ascii_renderer_tpu_torch.core.camera import Camera
    from ascii_renderer_tpu_torch.core.config import Config, PathTracerConfig
    for key in ("path_ms", "path_busy_ms", "path_launches", "stage_ms",
                "stage_launches"):
        out[key] = {}
    hd_cfg = Config(path_tracer=PathTracerConfig(samples_per_batch=8))
    runs = {}
    for label, cfg, rows, cols in (
            ("PT reference run 96x36 spp64", Config(), 36, 96),
            ("PT HD arm 960x540 spp8", hd_cfg, cs.ROWS, cs.COLS)):
        r = Renderer(cfg, "pathtrace", device=dev)
        r.set_scene(cs._pt_scene(device=dev))
        out["digest"][f"{label} alpha"] = _digest(
            [r.render(0.0, cs._pt_camera(), rows, cols).a.to(torch.int32)])
        runs[label] = (cs.run_pt_path(cfg, rows, cols, 1, 3, label), 20)
    runs["PT frame step 96x36"] = (cs.run_pt_step_path(dev), 20)
    tracer = cs._progressive_tracer(dev, hd_cfg, cs.ROWS, cs.COLS, True)
    poses = [cs._pt_camera(), Camera.create(pos=(0.0, 2.5, 5.9),
                                            yaw=-math.pi / 2)]
    box = {"i": 0}

    def prog():
        box["i"] += 1
        return tracer.step(poses[box["i"] % 2])

    out["digest"]["progressive HD batch alpha"] = _digest(
        [prog()[1].to(torch.int32)])
    runs["progressive HD batch 960x540 spp8"] = (prog, 10)
    still = cs._progressive_tracer(dev, hd_cfg, cs.ROWS, cs.COLS, True)
    out["digest"]["progressive HD still batch alpha"] = _digest(
        [still.step(poses[0])[1].to(torch.int32)])
    runs["progressive HD still batch 960x540 spp8"] = (
        lambda: still.step(poses[0]), 10)
    for label, (fn, n) in runs.items():
        out["path_ms"][label] = statistics.median(cs._timed(fn, n))
        busy, launches, stages, host = cs.profile_frames(
            fn, 3, ("pt.", "frame.", "glyph", "accum."), label)
        out["path_busy_ms"][label] = busy
        out["path_launches"][label] = launches
        for st in PT_STAGES:
            out["stage_ms"][f"{label} {st}"] = host.get(st, 0.0)
            out["stage_launches"][f"{label} {st}"] = stages.get(st, 0.0)
            out["stage_launches"][f"{label} {st} HtoD"] = stages.get(
                f"{st} HtoD", 0.0)
        torch.cuda.synchronize()
    pt_kernels(cs, dev, out)


def paths(cs, dev, out) -> None:
    """The host median (``chip_smoke._timed``), device busy ms and kernel
    launches a call (``chip_smoke.profile_frames``, 3 calls) of the paths
    the kernels for XLA code serve: the raster headline frame (960x540),
    the entry() step (96x36), the teapot (240x135), the mid-scale HD arm
    (960x540), the ray tracer's frame (96x36) and the 1,024-view farm
    (views/s); each driven, and its first frames checked, by chip_smoke's
    own run_* function. The headline's and the farm's glyph grids, the
    entry() step's first chars and the teapot's and the mid-scale HD arm's
    second frames are digested."""
    import torch
    from ascii_renderer_tpu_torch.backends.raster import RasterBackend
    from ascii_renderer_tpu_torch.core.config import Config
    from ascii_renderer_tpu_torch.entry import entry
    for key in ("path_ms", "path_busy_ms", "path_launches",
                "walk_launches"):
        out[key] = {}
    soup, scene = cs._bunny(), cs._scene(dev)
    backend, cfg = cs.run_main_path(dev, soup, scene)
    keys_and_build(cs, dev, out, backend._caps)

    def headline():
        return cs._frame(backend, cfg, cs._golden_camera())[1]

    farm = cs.run_farm_path(dev)
    out["digest"]["headline frame 0 chars"] = _digest([headline()])
    out["digest"]["view farm chars"] = _digest([farm()])
    fn, args = entry()
    out["digest"]["entry step frame 0 chars"] = _digest(
        [fn(*args)[1].to(torch.int32)])
    for name, grid in (("teapot", cs.TEAPOT_GRID), ("mid", cs.MID_GRID)):
        msoup, mcam = cs._mesh(name)
        be = RasterBackend(Config(pixel_aspect=cs.PIXEL_ASPECT), device=dev)
        be.set_soup(*msoup, cs._scene(dev))
        rgb = [be.render(0.0, mcam, *grid, cs.PIXEL_ASPECT).rgb
               for _ in range(2)][-1]
        out["digest"][f"{name} frame 1 rgb"] = _digest([rgb.to(torch.int32)])
    runs = {"headline frame 960x540": (headline, 20, "raster."),
            "entry step 96x36": (cs.run_entry_path(), 20, "raster."),
            "teapot 240x135": (cs.run_raster_mesh_path(
                dev, "teapot", cs.TEAPOT_GRID, 2, 0, 10, "teapot 240x135"),
                20, "raster."),
            "mid-scale HD arm 960x540": (cs.run_raster_mesh_path(
                dev, "mid", cs.MID_GRID, 2, 0, 10, "mid-scale HD 960x540"),
                20, "raster."),
            "RT frame 96x36": (cs.run_rt_path(dev), 20, "rt."),
            "view farm 1024 x 96x36": (farm, 5, "rt.")}
    for label, (fn, n, stage) in runs.items():
        out["path_ms"][label] = statistics.median(cs._timed(fn, n))
        busy, launches, stages, _host = cs.profile_frames(
            fn, 3, (stage, "frame.", "glyph"), label)
        out["path_busy_ms"][label] = busy
        out["path_launches"][label] = launches
        if "raster.walk" in stages:
            out["walk_launches"][label] = stages["raster.walk"]
        torch.cuda.synchronize()
    out["path_ms"]["view farm views/s"] = cs.FARM_VIEWS / (
        out["path_ms"]["view farm 1024 x 96x36"] / 1e3)
    if "trig" in getattr(getattr(RTK, "Grid", None), "_fields", ()):
        rt_grid_parts(cs, dev, out)


def rt_grid_parts(cs, dev, out) -> None:
    """The farm's rt.grid (1,024 views) in its parts on the host, median
    ms of 20 calls after one (``grid_parts_ms``, where the side's grid has
    a trig form): the bases form (``camera_bases`` above SCALAR_VIEWS: the
    three .tolist() calls, 5 x V libm calls, the numpy chain
    ``bases_from_trig``; then ``ops/rt_trace``'s [V, 12] cat and its copy
    to the card) and the trig form render_rgb takes on the card
    (``core/camera.view_trig``: libm once a distinct argument; the copy of
    [V, 8])."""
    import math
    import numpy as np
    import torch
    from ascii_renderer_tpu_torch.core import camera as C
    from ascii_renderer_tpu_torch.ops import rt_trace as RTK
    cams = cs._orbit()
    rows, cols = cs.FARM_GRID
    cam = cams.pos.reshape(-1, 3)
    ys, ps, fs = (x.reshape(-1).tolist() for x in (cams.yaw, cams.pitch,
                                                   cams.fov_y))
    f32 = np.float32

    def trig():
        def t(fn, xs):
            return np.fromiter(map(fn, xs), np.float64, len(xs)).astype(f32)
        return (t(math.cos, ps), t(math.sin, ps), t(math.cos, ys),
                t(math.sin, ys),
                t(math.tan, (f32(0.5) * np.array(fs, f32)).tolist()))

    tr = trig()
    grid = RTK.Grid(C.camera_bases(cams.yaw, cams.pitch, cams.fov_y), rows,
                    cols, cs.PIXEL_ASPECT, 0, rows)
    views = RTK._grid_views(grid, cam)
    table = C.view_trig(cam, cams.yaw, cams.pitch, cams.fov_y)

    def copy(x):
        x.to(dev)
        torch.cuda.synchronize()

    out["grid_parts_ms"] = {
        "bases: three .tolist()": _host_ms(lambda: [
            x.reshape(-1).tolist() for x in (cams.yaw, cams.pitch,
                                             cams.fov_y)]),
        "bases: 5 x V libm calls": _host_ms(trig),
        "bases: numpy chain": _host_ms(lambda: C.bases_from_trig(*tr)),
        "bases: camera_bases whole": _host_ms(
            lambda: C.camera_bases(cams.yaw, cams.pitch, cams.fov_y)),
        "bases: _grid_views cat": _host_ms(lambda: RTK._grid_views(grid,
                                                                   cam)),
        "bases: copy [V, 12]": _host_ms(lambda: copy(views)),
        "trig: view_trig": _host_ms(lambda: C.view_trig(
            cam, cams.yaw, cams.pitch, cams.fov_y)),
        "trig: copy [V, 8]": _host_ms(lambda: copy(torch.from_numpy(table))),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--only", choices=("all", "bins", "shade", "rt",
                                       "glyph", "pt", "front", "k1",
                                       "partition", "train"),
                    default="all",
                    help="bins: the raster's bins and the paths alone; "
                    "shade: K2 at its callers, X10 and the headline; rt: "
                    "the ray tracer's render path; glyph: the camera "
                    "chains, the glyph tail and the paths' tail stages; "
                    "pt: the path tracer's frames and their stages; "
                    "front: the raster's clip and plane table and the "
                    "entry() step; k1: the fused clip with its attribute "
                    "slots and the fused and subtile2 frames; partition: "
                    "X13 at its calls and the progressive HD and subtile "
                    "frames; train: config 5's 32-step call")
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.worker, a.only)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    other = str(Path(a.other).resolve())
    runs = []
    for side, root in (("other", other), ("this", str(HERE)),
                       ("this", str(HERE)), ("other", other)):
        res = subprocess.run([sys.executable, __file__, "--worker", root,
                              "--only", a.only],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"{side} side ({root}) failed:\n"
                               f"{res.stderr[-4000:]}")
        runs.append((side, json.loads(res.stdout.strip().splitlines()[-1])))
        print(f"{side}: {json.dumps(runs[-1][1])}", flush=True)
    digests = {json.dumps(r["digest"], sort_keys=True) for _s, r in runs}
    if len(digests) != 1:
        raise AssertionError("the two checkouts' outputs differ")
    if a.only == "train":
        # the sides' losses round apart: held together for the steps that
        # chip_smoke.py holds the card's run to the CPU's
        cs = _chip_smoke()
        first = runs[0][1]["losses"][:cs.CONFIG5_SAME_STEPS]
        for side, r in runs:
            got = r["losses"][:cs.CONFIG5_SAME_STEPS]
            rel = max(abs(x - y) / y for x, y in zip(got, first))
            print(f"{side}: first losses {got}, within {rel:.2e} of the "
                  f"first run's", flush=True)
            assert rel <= cs.CONFIG5_RTOL, (side, got, first)
    summary = {}
    for key in ("jit_grid_ms", "b5_ms", "b6_ms", "b8_ms", "b1_ms",
                "b9d_ms", "b9e_ms", "b9f_ms", "b9a_ms", "b9b_ms", "b9c_ms",
                "b4_ms", "b7_ms", "b7s_ms", "b3_ms", "x4_ms", "x3_ms",
                "front_ms", "front_call_ms", "x4_kernel_ms", "x3_kernel_ms",
                "k1_clip_ms", "k1_clip_call_ms", "k1_clip_launches",
                "x13_ms", "x13_call_ms", "x13_launches",
                "k3_ms", "x9_ms", "x9_kernel_ms", "x7_ms", "x14_ms",
                "keys_ms", "keys_busy_ms",
                "keys_launches", "build_ms", "build_busy_ms",
                "build_launches", "x10_ms", "k2_ms", "k2_call_ms",
                "k2_launches", "image_ms", "image_call_ms",
                "image_launches", "rt_ms", "rt_call_ms", "rt_launches",
                "k3_rd3_ms", "bases_ms", "frame_ms", "busy_ms", "path_ms",
                "path_busy_ms", "path_launches", "steps_s", "walk_launches",
                "host_ms",
                "tail_ms", "tail_busy_ms", "tail_launches", "chars_ms",
                "stage_ms",
                "stage_launches"):
        for shape in runs[0][1].get(key, {}):
            if not all(shape in r.get(key, {}) for _s, r in runs):
                continue  # timed on one side only
            name = key[:-3] if key.endswith("_ms") else key
            summary[f"{name.capitalize()} {shape}"] = {
                side: statistics.median(r[key][shape] for s, r in runs
                                        if s == side)
                for side in ("other", "this")}
    for shape, ms in summary.items():
        unit = "" if shape.startswith((
            "Path_launches", "Steps_s", "Walk_launches", "Keys_launches",
            "Build_launches", "K2_launches", "Image_launches",
            "Rt_launches", "Tail_launches",
            "Stage_launches", "K1_clip_launches",
            "X13_launches")) or shape.endswith(
                "views/s") else " ms"
        ratio = (f"{ms['other'] / ms['this']:.2f}" if ms["this"]
                 else "n/a")
        print(f"{shape}: other {ms['other']:.5f}{unit}, this "
              f"{ms['this']:.5f}{unit}, other / this {ratio}", flush=True)
    for key in ("forms_ms", "grid_parts_ms"):  # timed in this checkout
        for shape in runs[0][1].get(key, {}) or runs[1][1].get(key, {}):
            ms = statistics.median(r[key][shape] for s, r in runs
                                   if s == "this")
            name = key[:-3].replace("_", " ").capitalize()
            print(f"{name} {shape}: this {ms:.5f} ms", flush=True)
    print("outputs bit-identical in both checkouts", flush=True)
    print(json.dumps({"runs": [dict(side=s, **r) for s, r in runs],
                      "median_ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
