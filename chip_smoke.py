#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (ascii_renderer_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), torch and CUDA.
2. Builds the CUDA kernels of ascii_renderer_tpu_torch/ops/csrc with nvcc
   (one process per source, all at once) and prints each kernel's
   registers, spills and shared memory (-Xptxas -v).
3. Holds each kernel against its plain-torch version on the same CUDA
   inputs, at the shapes its main path gives it:
   - first fma32 (K1, a kernel for XLA code: the fused product-add every
     plain version calls) against its float64 form on 16,777,216 random
     triples, constructed float32 midpoint ties, subnormal and special
     values, broadcast / 5-d / strided / scalar operands, every call of a
     mid-scale HD frame and of the bunny's fused frame: bit for bit (NaN
     in the same places); timed at the largest of those calls beside
     torch.addcmul;
   - raster headline (bunny-class mesh, 68,644 triangles, 960x540):
     setup (B2) valid flags equal and planes bit-exact; pack (B3)
     bit-exact; grouped walk (B1: slab work items, then a merge launch;
     its work list printed) winner ids and depths exactly equal;
   - modal vote (B4) at 540x960 and 36x96, radius 1..3, random override
     masks, and on the headline frame 0's own index and override planes:
     exactly equal; timed at 540x960 radius 2 on random planes (the
     record), on the headline's planes and at 36x96;
   - path-trace megakernel (B5) at every launch shape of the PT runs: the
     reference run's batch (110,592 rays, seed 1) and probe (3,456), the HD
     arm's probe (518,400) and batch (4,147,200): ov / fet and radiance
     bit-identical; then a random block gate and a permuted ray order
     with canonical uids: every live ray bit-identical to the plain run,
     gated blocks zero;
   - the PT ray grid (a kernel for XLA code: no Pallas kernel computes
     it) at the runs' centre grids and jittered batches, 96x36 and
     960x540, at two poses: bit for bit; timed at the HD arm's batch;
   - X7, the path tracer's sample rays (a kernel for XLA code: each ray
     from its pixel's uid, jitter included, into B5's ray block) at the
     reference run's batches 0 and 1 and probe, the HD arm's batch and
     probe, a compacted order and a band, at two poses, against the
     plain chain: bit for bit; timed at the HD arm's and the reference
     batch; X14, the batch fold and the frame's resolve, on seeded
     megakernel outputs (overrides in several samples, NaN radiance, a
     last batch past spp, a compacted order, the HD arm's batch) and on
     a PT reference frame's own outputs: every state and the resolve bit
     for bit; timed at a reference batch and the HD arm's batch with the
     resolve; K1b, the progressive tracer's statistics step (ops/accum,
     one launch a batch), at the progressive shapes 96x36 and 960x540 on
     seeded edge planes (NaN, infinities, subnormals, counts at
     max_samples - 1), both statistics modes, reset or not, a sample
     alpha or not, the any-active flags: bit for bit with accumulate_ref;
     timed at both shapes beside the plain chain;
   - B4 over the view farm's batch of glyph planes [1024, 36, 96] in one
     launch, radius 1..3, random override masks: equal to the plain
     version and to 1,024 one-plane launches; timed at the K the wrapper
     picks and at K = 1 and K = 4;
   - the glyph tail, float rgb to chars in two launches: X12a
     (Frame.from_float, a kernel for XLA code, with the frame step's UI
     plane) and B4's chars form (the bytes' ramp indices formed as the
     vote stages its window, the overrides from the alpha bytes, the
     chars through the ramp's codes; glyph_map_kernel with the mode filter
     off) on seeded float planes (outside [0, 1], at every byte's rounding
     edge and a float32 either side, the alpha protocol's edges, a UI
     plane) at 540x960, 36x96 and [1024, 36, 96], on the headline's frame
     0 and on the entry() step's frame with its UI plane; the chars form
     from the bytes and from the index plane, radius 1-3 and off, ramps of
     1, 10 and 100 codes (each a device copy made once): bit for
     bit; timed at the headline's frame 0, 36x96 and the farm's batch;
   - the ray tracer's jitted ray grid (one launch for every view; no
     render path launches it, K3 computes those rays itself) at the
     farm's 1,024 orbit poses and the rt_demo pose: bit for bit; timed;
   - the ray tracer's frame (K3, a kernel for XLA code: its primary rays
     from the jitted grid (the grid form, render_rgb's) or read from rd3,
     hits, shading, shadow rays and the mirror bounce, one launch for
     every view) on the rt_demo golden's frame and its bands, the farm's
     1,024 views and three more scenes over 16 views, in both ray forms,
     in the launch's own form and in every form it can be asked for (1 to
     32 lanes a ray, the valid slots staged in shared memory or read from
     the global arrays), the batches also in the grid form's trig form
     (render_rgb's above SCALAR_VIEWS views: each view's origin and trig
     from the host, its bases formed on the card): bit for bit
     with the plain grid (ndc_grid_jit + ray_dirs_jit) and trace_rgb, and
     render_rgb on the card one launch a call (one view, a band, the
     farm; no grid kernel, no torch op); timed at the farm's batch in
     every form;
   - the raster's deferred shade (K2, a kernel for XLA code) at each
     caller's inputs, captured on its path (the headline's grouped
     tiles, the mid-scale HD arm's plane table, the subtile path's
     compacted tiles): bit for bit; timed at the headline's;
   Kernel ms is device time (profiler kernel rows over 50 back-to-back
   calls, their count checked against the kernel's launches per call);
   plain ms is CUDA events around whole calls; bound ms is the larger of
   bytes / 3.35 TB/s and operations / 67 TFLOP/s (H100 SXM; B5's unfused
   operations / 33.5 T FP32 instructions/s, B4's integer operations /
   16.7 T INT32 instructions/s), from this run's inputs.
   - bin walks B6 (channel-major chunks) and B6' (row-major entries, the
     valid flag tested) on the inputs the binned paths build
     (raster_channels.binned_entries): the demo room 96x36, the cube
     80x24, the teapot 240x135 and the mid-scale HD arm (bunny-class
     14,884 triangles, 960x540) at their steady caps, and random entries
     with empty bins, bins across the 128 / 256-entry chunks and depth
     ties: z and winner ids exactly equal; each timed (walk and merge)
     at the entry() room's, the teapot's and the mid-scale HD arm's
     shapes;
   - the bin walk's entries (X9, a kernel for XLA code, ops/bin_entries:
     three or four launches, the keys' sort a counting sort) at every call
     the binned paths make (the demo room, the cube, the teapot, the
     mid-scale HD arm) and on a seeded 60,000-triangle soup at the near
     plane, in both walk layouts: entries, offsets and grid bit for bit;
     timed at the entry() room's and the mid-scale HD arm's calls;
   - the plane-table packs B7 (pack_channels) and B7' (pack_channels_split)
     at the teapot's and the HD arm's table widths and lengths, and B7' at
     the reference's exactness shape [40, 69632]: bit-exact;
   - the small and mid raster paths' front end, two kernels for XLA code:
     the clip with its screen setup (X4, ops/raster_clip) and the plane
     table with its attribute lerps (X3, ops/plane_table), on the inputs
     each caller gives them (captured from a call of each path: entry()'s
     room, the cube, the teapot and the mid-scale HD arm at their settled
     caps, the bunny's "fused" clip and "subtile" table) and on a seeded
     60,000-triangle soup at the near plane (both vertex layouts, the
     table uncompacted and compacted): the dict and the table bit for bit
     (NaN in the same places); each timed at the mid-scale HD arm's call;
   - the stable partition (X13, a kernel for XLA code, ops/partition: one
     launch a call at every size) in its channels form at the
     teapot's, the mid-scale HD arm's and the subtile golden call's
     compact_valid_ch inputs (every channel's bits, valid, cidx, n_valid)
     and in its order form at the progressive tracer's masks at 96x36 and
     960x540 and all / none / one pixel active (slot, pix_uid, the block
     gates of 1 and of the batch's samples): bit for bit; timed at each
     call, the order form beside one stable torch.argsort of the same
     flags (its order checked equal);
   - the grouped generations' kernels on the inputs of the golden call's
     bunny frame (render_soup(method=g) at the caps of
     tests/test_headline_goldens.py:49-52) and on a random 48x96 soup at
     generous and overflowing caps (odd CSR offsets, clamped slab starts)
     and with one group far deeper than the rest: the walks B9d
     (subtile3), B9e (subtile4: each slot's strip of the pair-ordered
     table), B9f (subtile5's K2 and subtile6's K4 layouts, both timed, the
     K2 one recorded) and B1 (subtile7's K4 and subtile8's K8 gathers),
     each slab work items, then a merge launch (timed at two launches a
     call, walk / merge split and work lists printed), z and ids bit for
     bit; the fused setup+pack B10 bit for bit against its plain version
     and against B2 then B3 (sign of zero included), and timed beside
     B2 + B3; B7 at the wide pack of subtile3 / subtile4;
   - the retired generations' kernels on the inputs their paths give them
     (captured from one call of each path on the bunny at the golden pose:
     fused, subtile and subtile2 at the caps a diagnostic pass and
     suggest_caps_subtile settle on, visibility_subtile at subtile's):
     the fused-shading walk B8 (chunk work items, then a merge launch that
     shades; its work list printed) rgb bit for bit (also on the demo room
     with its point light and on random deep bins of 1,000 entries and
     more), the subtile walks B9a (expanded rows), B9b (packed rows) and
     B9c (packed rows, depth mask), each chunk work items, then a merge
     launch (timed at two launches a call, walk / merge split and work
     lists printed), z and ids bit for bit (also on a random 64x512 soup,
     4 tiles across, at generous and overflowing caps, and B9b / B9c on a
     tile of 36 items whose boundaries carry +0.0 / -0.0 ties, the +0.0
     kept), and B9a against B9b on the same bunny bins: z within 1e-5
     where the ids agree, ids differing (edges through pixel centres,
     rounded apart) at most at 6 pixels.
4. Drives each main path as a user would, every launch count set to 0
   just before the path and read just after:
   - raster: RasterBackend.set_soup(bunny), render 960x540, glyph_decide
     (B4 in the glyph stage); frame 0 at the golden camera must give the
     reference frame (checksum + the ds20 golden), then 3 moves, then 20
     timed frames; its raster.keys (X9's bin keys) and raster.build (X10)
     held to RASTER_KEYS_LAUNCHES and RASTER_BUILD_LAUNCHES kernel
     launches a frame; X9's bin keys and X10 at a fresh backend's frame 0
     (big_cap 64) and the steady frame (big_cap 0) against their plain
     versions bit for bit, timed at the steady frame (split by kernel);
     then the same at every grouped golden call (check_golden_keys_builds)
     and at the bunny's row bands of subtile8, subtile6 and subtile3
     (check_band_keys_builds, after the parallel phase);
   - every grouped generation through the golden call render_soup(
     method=g) and the glyph pass: subtile8, subtile3 .. subtile7, and
     subtile8 under SETUP_PACKED; each frame 0 must give the checksum and
     an rgb frame bit-identical to subtile8's; then 10 timed frames each;
   - the retired generations at 960x540 on the bunny: render_soup(method=
     "fused"), "subtile" and "subtile2" (at their settled caps) through
     the glyph pass, frame 0's checksum printed and its count of pixels
     over 2e-3 from subtile8's frame within 6 of the reference's own
     count (ORACLE_REF_DIFF), then 10 timed frames each; and
     visibility_subtile (B9a), 10 timed calls;
   - path tracer, reference run: Renderer(cfg, "pathtrace") on the demo
     scene with its atlas, 96x36, spp 64, 5 bounces, NEE; a fresh
     spp-2 / 2-bounce frame 0 at the poster pose must equal the port's
     CPU render's alpha plane and carry 117 overrides; then 4 checked
     frames (the pose, then 3 moves) and 20 timed ones; its profile's
     stage launches must be pt.rays 3 (X7: the probe and 2 batches),
     pt.trace 3 (B5) and pt.reduce 2 (X14), and no PT ray grid launch;
   - path tracer, HD arm: 960x540, spp 8 (one batch): 2 checked frames,
     10 timed; stage launches pt.rays 2, pt.trace 2, pt.reduce 1;
   - the frame step of entry() (the demo room through render_soup, the
     binned walk B6, then the UI composite and the glyph pass) at 96x36:
     frame 0's chars and tint must equal the port's CPU step, then 3
     steps with "w" held, then 20 timed steps;
   - bench config 1, the cube at 80x24 with the mode filter off, through
     RasterBackend (24 slots: the scan path) and through render_soup's
     binned walks B6 and B6': each must give tests/goldens/raster_cube.txt;
   - bench config 2, the teapot at 240x135 through RasterBackend (the
     compacted mid-scale path: B6 and, from the second frame's caps on,
     B7): frames 0 and 1 must equal the CPU render's chars, then 20 timed;
   - the mid-scale HD arm (14,884 triangles, 960x540) through
     RasterBackend: 2 checked frames, 10 timed;
   - the "pathtrace" frame step (demo_setup) at 96x36: frame 0's alpha
     plane (spp 2, 2 bounces) must equal the port's CPU step; then 10
     timed steps at the default spp 64;
   - the path tracer's XLA core (render_pt(use_kernel=False)): both
     path-tracer goldens (tests/goldens/pt_demo_override_plane.txt, 117
     overrides; pt_wide_atlas_overrides.txt, 27) exactly; the core against
     B5 at one bounce without NEE (overrides and fetched flags exact,
     radiance within 1e-5); then the demo room with a 512x256 atlas, above
     the kernel's budget, through Renderer(cfg, "pathtrace") at 96x36,
     spp 64, 5 bounces, NEE: frame 0's alpha plane must equal the port's
     CPU render, then 10 timed frames.
   - the ray tracer: Renderer(Config(pixel_aspect=0.5), "rt") on the
     rt_demo scene at 96x36 must give tests/goldens/rt_demo.txt exactly,
     then 3 moves and 20 timed frames; the "raytrace" frame step's frame
     0 chars must equal the port's CPU step;
   - the view farm, bench config 4 at full size: 1,024 orbit views at
     96x36, render_rgb and the glyph pass (B4 one launch over the views)
     in one batched call; 8 spread views must equal the port's CPU render
     of them; then 5 timed farms (views/s), printed beside the farm's
     rt.grid host ms;
   - the progressive path tracer (sim/accum) at 96x36, the config's path
     tracer and adaptive settings: adaptive_skip=True (B5 with its block
     gate over the compacted stream) bit-identical to adaptive_skip=False
     for 8 batches, then batches until poll_done() or 64 (active pixels,
     gated blocks, ms); a spp-2 frame 0's alpha equal to the CPU run; the
     960x540 spp-8 arm, 8 batches; its pt.setup (X13's order form, the
     counters zeroed in its launch) at most PT_SETUP_COMPACTED_LAUNCHES
     launches a batch and no copy either way in pt.setup or pt.rays; its
     accum.step at most ACCUM_STEP_LAUNCHES (K1b) and no fma32 on the
     path.
   - the app shell: the port's CLI (app/cli.main) in this process at
     96x36: offline raster, raytrace and raster --batch 4 must print the
     text of the CPU run of the same argv; offline pathtrace (spp 2) must
     give the CPU run's alpha plane and its text at the override cells;
     20 timed offline frames of each backend (pathtrace at spp 64);
     --progressive until poll_done (profiled: accum.step at most
     ACCUM_STEP_LAUNCHES a batch, no fma32); --mode pixels --backend
     raytrace, 60
     frames, the first 2 frames' bytes equal to the CPU run's (FPS
     printed); --mode term --backend raster on a pty, "w" held 2 s, then
     "q": exit 0 within 20 s, its FrameStats (fps, p50, p95) printed; the
     exactness canary (utils/exactness.run_checks("cuda"): B3 and B7' at
     [40, 69632], a float32 identity product) must say "ok". B5, B4, B6,
     B3, B7', X7, X14 and K3 must launch in the phase;
     expand_pixels (the pixels mode's glyph bitmap) is profiled.
   - the parallel path: X5's forward and backward and X5b (the soft
     raster and the band loss) against their plain versions at config 5's
     1- and 4-view first-step inputs, timed (check_soft_raster); then
     config 5's train steps held to the CPU's (CONFIG5_*, TRAJ_*), the
     row bands and the sharded renders over an NCCL world of 1, and
     dryrun_multichip(1) (run_parallel_path); a 32-step call launches X5's
     forward, X5b and X5's backward 32 times each, and its launches, busy
     share and steps/s a step are printed beside the parent's.
   Each path's kernels must have launched: the raster paths' shade
   through K2, every frame of the ray tracer and each farm through K3
   (a farm launches K3 once and nothing else of the ray tracer: its
   rt.grid stage launches nothing, and no driven path launches the jitted
   grid kernel), fma32 through K1, the entry() step's, the
   cube's, the teapot's, the mid-scale HD arm's and the subtile path's
   clip and table through X4 and X3 (the fused path's clip through X4),
   the binned paths' entries through X9, the teapot's, the mid-scale HD
   arm's and the subtile path's compaction through X13 (raster.compact at
   most RASTER_COMPACT_LAUNCHES launches a frame, no copy; the mid arm's
   raster.shade at most MID_SHADE_LAUNCHES: its n_big is X9's count),
   the progressive tracer's order through X13's order form; raster.walk
   makes at most RASTER_WALK_LAUNCHES kernel launches a frame of the
   entry() step and the mid-scale HD arm (printed with their fma32
   launches); no PT frame copies either way in pt.setup or pt.rays.
   K3's launches are recorded by size (rays and form) on the driven
   paths, and each size is timed at the end in the launch's own form (its
   lanes a ray, staging and blocks printed): its loss, launches x (kernel
   - bound), goes into K3's record; so are K2's, X10's, X4's, X3's, K1's
   and X13's (both forms), each kernel's summed launches checked against
   its count. Frames of every path are profiled (stage host ms, device
   span and kernel launches, device busy share; tables in smoke_out/,
   git-ignored). The
   headline, entry() step, PT reference run, PT frame step, RT frame and
   farm print raster.mvp, rt.grid, frame.from_float, frame.compose and
   glyph (host ms and launches a frame) and must take float rgb to chars
   in GLYPH_LAUNCHES launches (X12a, then B4's chars form), the glyph
   stage one; the CLI's votes all come through the chars form.
5. Prints the script's total time, {"kernels": [...]} and, as the last
   line, {"ok": true, "device": {...}}.

Exits non-zero (and prints no result) without CUDA or without the
package beside it. Every check is an assert or an explicit raise.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# Keep CUPTI up between profiler sessions: torch tears it down after each
# by default, and the next session then now and then loses kernel rows
# (whole names, or half of a two-kernel call), which _device_ms refuses
os.environ.setdefault("TEARDOWN_CUPTI", "0")
ROWS, COLS, PIXEL_ASPECT = 540, 960, 0.5
# The headline frame's golden (tests/test_headline_goldens.py): the sum of
# all 518,400 glyph codes and a 27 x 48 downsample of the grid.
BUNNY_CHECKSUM = 32392648
GOLDEN_DS20 = os.path.join(ROOT, "tests", "goldens", "bunny_960x540_ds20.txt")
# The path tracer's poster pose (tests/test_headline_goldens.py) and the
# override count of its 36x96 spp-2 frame (JAX kernel path, key 0)
PT_POSE = dict(pos=(0.0, 2.5, 6.0), yaw=-math.pi / 2)
PT_OVERRIDES = 117
# NVIDIA H100 SXM peaks (data sheet, dense): FP32 outside the tensor cores
# and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 instructions: 132 SMs x 128 lanes x 1.98 GHz. B5 is built with
# -fmad=false, so each of its operations is one instruction, an FMA never
# two operations: its bound divides by this rate
PEAK_FP32_INSTR = 33.5e12
# B5 operations per ray, counted from csrc/pt_trace.cu (sqrt, division,
# sin, cos and pow counted as one operation each): one sphere entry and
# one triangle entry of a nearest-hit search, the rest of a bounce, and
# the NEE arithmetic around a shadow search
B5_OPS_SPHERE, B5_OPS_TRI, B5_OPS_BOUNCE, B5_OPS_NEE = 25, 43, 250, 60
# 32-bit integer instructions: 132 SMs x 64 INT32 lanes x 1.98 GHz
PEAK_INT32 = 16.7e12
# B4 integer operations per neighbour and pass that the function needs: the
# override test, the compare, and the vote's select or the count's add.
# Loop control and the centre test are left out: a fixed radius unrolls
# them away. The work depends on the planes (_b4_ops)
B4_OPS = 3
OUT = os.path.join(ROOT, "smoke_out")


def _event_ms(fn, n):
    """Mean ms of fn() over n calls, CUDA events around all n (a warm-up
    call first)."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _spin(n=16):
    """n short spin kernels ("spin_kernel", which _device_ms leaves out),
    then a synchronise."""
    import torch
    for _ in range(n):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


# profiles _device_ms takes before it fails: now and then a whole session
# comes back without kernel rows (twice in a row, once, for B4)
_PROFILES = 5


def _device_ms(fn, kernel, per_call, n=50):
    """Device ms per call of fn: the profiler's CUDA rows whose name holds
    ``kernel`` (one of them, for a tuple of names; every CUDA row if
    None), summed over n back-to-back calls,
    over n. fn launches ``per_call`` such kernels; a profile whose matched
    rows count another number of launches than n * per_call is taken
    again, and the fifth such profile fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = (kernel,) if isinstance(kernel, str) else kernel
    fn()
    torch.cuda.synchronize()
    counts = []
    for _attempt in range(_PROFILES):  # the profiler now and then drops rows
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # records at a session's edge are now and then lost (a session
            # of 100 B6 launches came back with 98, then 99): spin kernels
            # on both sides of the timed calls are what gets lost there
            _spin()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            _spin()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and "spin_kernel" not in e.key
                and (kernel is None or any(k in e.key for k in names))]
        counts.append(sum(e.count for e in rows))
        if counts[-1] == n * per_call:
            return sum(e.self_device_time_total for e in rows) / n / 1e3
        print(f"{kernel}: {counts[-1]} device rows in a profile of {n} "
              f"calls, not {n * per_call}: profiling again", flush=True)
    raise AssertionError(f"{kernel}: {counts} device rows in {_PROFILES} "
                         f"profiles of {n} calls, not {n * per_call}")


def _event_once(fn):
    """(fn(), ms of that one call by CUDA events)."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def _bound(n_bytes, n_ops, ops_rate=PEAK_FP32):
    t_b, t_o = n_bytes / PEAK_BYTES * 1e3, n_ops / ops_rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _nbytes(*ts):
    """Bytes the tensors hold: a dimension of stride 0 (a broadcast) is
    read once, not once an index."""
    return sum(math.prod(n for n, st in zip(t.shape, t.stride()) if st)
               * t.element_size() for t in ts)


def _walk_bound(lay, z, e):
    """The least work of a grouped walk on layout ``lay`` (ops/raster_group
    GENERATIONS): the 16 walk channels of each live (bin, triangle) pair
    read once, 64 bytes, and tested by the bin's 128 pixels at ~20
    operations each; plus the pixel origins in and (z, id) out. Slab
    padding and the dead slots of bins shallower than their group's
    deepest are not work the function needs."""
    live = int(lay[2].sum())  # gdepth of the walked bin slots
    return _bound(64 * live + _nbytes(*lay[-6:-4], z, e), 20 * 128 * live)


def _rec(name, source, replaces, err, ms, plain_ms, bound, library_ms=None):
    return dict(name=name, route="cuda",
                source=f"ascii_renderer_tpu_torch/ops/csrc/{source}",
                replaces=f"ascii_renderer_tpu/ops/{replaces}", launches=0,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=library_ms)


def _bunny():
    from ascii_renderer_tpu_torch.geom import meshes
    v, i = meshes.bunny_like(69000)
    return meshes.mesh_to_soup(v, i, color=(0.8, 0.78, 0.75))


def _scene(device):
    from ascii_renderer_tpu_torch.scene.builder import SceneBuilder
    sb = SceneBuilder().set_env_light([0.22, 0.24, 0.28], 1.0)
    sb.add_dir_light([-0.5, -0.7, -0.6], [1, 1, 1], 0.9)
    return sb.build(device=device)


def _golden_camera():
    import numpy as np
    from ascii_renderer_tpu_torch.core.camera import Camera
    return Camera.create(pos=(2.4, 1.4, 2.8),
                         yaw=float(np.arctan2(-2.8, -2.4)), pitch=-0.3)


def _b1_layout(src16, bbox, T):
    """B1's layout as the headline's first render builds it (subtile8's
    K = 8 slot gather at the first caps RasterBackend tries): (layout,
    grp_cap)."""
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.ops import raster_group as RG
    n2t = 2 * T
    tiles_x = -(-COLS // 128)
    n_tiles = (-(-ROWS // 8)) * tiles_x
    r_cap, pair_cap, grp_cap = R._round_up(n2t, 2048), 4 * n2t, n_tiles
    keys = R._subtile_pair_keys_bbox(bbox, ROWS, COLS, big_cap=64)
    return RG.build_packed_rows_grouped_kgather(
        src16, keys, tiles_x, n_tiles, r_cap, pair_cap, grp_cap, 8), grp_cap


def _headline_setup(dev):
    """The headline frame 0's setup block, by the calling package's own
    setup kernel: (cm [C, R, 128], bbox, B3's spans, T)."""
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.ops import setup2dh as S
    p, n, c = (torch.as_tensor(x).to(dev) for x in _bunny())
    pos9, attrs_t = R.soup_static_prep(p, n, c, _scene(dev))
    mvp = R.camera_mvp(_golden_camera(), ROWS, COLS, PIXEL_ASPECT)
    cm, bb = S.setup_2dh_fused(pos9, attrs_t, mvp, ROWS, COLS)
    tw = R._round_up(3 * (attrs_t.shape[0] // 3) + 3, 8)
    return cm, bb, [(0, 16), (16, 16 + tw)], pos9.shape[1]


def b1_headline_inputs(dev):
    """(layout args, grp_cap) of B1 at the headline's frame 0, built by the
    calling package's own setup and pack (tools/kernel_ab.py)."""
    from ascii_renderer_tpu_torch.ops import pack as PK
    cm, bb, spans, T = _headline_setup(dev)
    src16 = PK.pack_channels_split_blocked(cm, spans)[0]
    lay, grp_cap = _b1_layout(src16, bb, T)
    return lay[:6], grp_cap


def b3_headline_inputs(dev):
    """(cm [C, R, 128], spans) of B3 at the headline's frame 0
    (tools/kernel_ab.py)."""
    cm, _bb, spans, _T = _headline_setup(dev)
    return cm, spans


def _print_slab_work(lay, grp_cap, label, walk="B1"):
    """A slab walk's work list on a layout (B1, B9d: 32-row slabs; B9f: 16
    of its two-entry rows; B9e: 32 entries from each slot's strip): slabs
    per group, items, slots, blocks."""
    from ascii_renderer_tpu_torch.ops import raster_group as RG
    if walk == "B9e":
        n_slots = RG.direct_n_slots(lay[0].shape[0] - RG.CHUNK_RG, grp_cap)
        _first, n = RG.group_slots(RG.direct_rowptr(lay[3], n_slots))
        unit = "8 strips of 32 entries"
    else:
        r_cap = lay[0].shape[0]
        rows = RG.CHUNK_RG // (lay[0].shape[1] // 128)
        n_slots = RG.group_n_slots(r_cap, grp_cap, rows)
        _first, n = RG.group_slots(lay[1].clamp(0, r_cap), rows)
        unit = f"{rows} rows (32 entries)"
    items = int(n.sum())
    print(f"{walk} {label}: {grp_cap} groups, {int((n > 0).sum())} with "
          f"slabs, deepest {int(n.max())} slabs of {unit}; {items} work "
          f"items of one slab in {n_slots} slots, 4 a slab for {4 * items} "
          f"block-items, walked by {min(4 * n_slots, 2048)} blocks",
          flush=True)


def check_kernels(dev, soup, scene):
    """B1-B3 against their plain versions at the main path's shapes (the
    shapes of frame 0's first render). Returns per-kernel records."""
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.ops import pack as PK
    from ascii_renderer_tpu_torch.ops import raster_group as RG
    from ascii_renderer_tpu_torch.ops import setup2dh as S

    p, n, c = (torch.as_tensor(x).to(dev) for x in soup)
    pos9, attrs_t = R.soup_static_prep(p, n, c, scene)
    mvp = R.camera_mvp(_golden_camera(), ROWS, COLS, PIXEL_ASPECT)
    recs = []

    # B2 setup
    cm_k, bb_k = S.setup_2dh_fused(pos9, attrs_t, mvp, ROWS, COLS)
    cm_r, bb_r = S.setup_2dh_fused_ref(pos9, attrs_t, mvp, ROWS, COLS)
    torch.cuda.synchronize()
    valid = bb_r["valid"]
    assert torch.equal(bb_k["valid"], valid), "B2 valid flags differ"
    assert int(valid.sum()) > 30000, int(valid.sum())
    planes = torch.cat([cm_k[:12], cm_k[16:]]).reshape(-1, valid.numel())
    planes_r = torch.cat([cm_r[:12], cm_r[16:]]).reshape(-1, valid.numel())
    a, b = planes[:, valid], planes_r[:, valid]
    assert torch.allclose(a, b, rtol=5e-4, atol=1e-5), "B2 planes differ"
    assert torch.equal(cm_k[12:16], cm_r[12:16]), "B2 id/pad rows differ"
    for k in ("bx0", "bx1", "by0", "by1"):
        assert torch.allclose(bb_k[k][valid], bb_r[k][valid], rtol=1e-4,
                              atol=1e-2), f"B2 {k} differs"
    err = float((a - b).abs().max())
    n_bits = int((cm_k.view(torch.int32) != cm_r.view(torch.int32)).sum())
    assert n_bits == 0, f"B2: {n_bits} values not bit-identical"
    T = pos9.shape[1]
    bound = _bound(_nbytes(pos9, attrs_t, cm_k, *bb_k.values()), 300 * T)
    recs.append(_rec(
        "setup2dh", "setup2dh.cu", "setup2dh.py:43", err,
        _device_ms(lambda: S.setup_2dh_fused(pos9, attrs_t, mvp, ROWS, COLS),
                   "setup2dh_kernel", 1),
        _event_ms(lambda: S.setup_2dh_fused_ref(pos9, attrs_t, mvp, ROWS,
                                                COLS), 5), bound))
    print(f"B2 setup: valid={int(valid.sum())} max_abs_err={err} "
          f"values_not_bit_identical={n_bits}", flush=True)

    # B3 pack (bit-exact)
    tw = R._round_up(3 * (attrs_t.shape[0] // 3) + 3, 8)
    spans = [(0, 16), (16, 16 + tw)]
    outs_k = PK.pack_channels_split_blocked(cm_k, spans)
    outs_r = PK.pack_channels_split_blocked_ref(cm_k, spans)
    torch.cuda.synchronize()
    for o_k, o_r in zip(outs_k, outs_r):
        assert o_k.shape == o_r.shape
        assert torch.equal(o_k.view(torch.int32), o_r.view(torch.int32)), \
            "B3 pack not bit-exact"
    n_pix = cm_k.shape[1] * cm_k.shape[2]
    cm2 = cm_k.reshape(cm_k.shape[0], n_pix)

    def library():  # one torch call per span, as the kernel is per span
        return [cm2[a_:min(b_, cm2.shape[0])].t().contiguous()
                for a_, b_ in spans]

    bound = _bound(4 * n_pix * sum(min(b_, cm2.shape[0]) - a_ + (b_ - a_)
                                   for a_, b_ in spans), 0)
    recs.append(_rec(
        "pack", "pack.cu", "pack.py:170", 0.0,
        _device_ms(lambda: PK.pack_channels_split_blocked(cm_k, spans),
                   "pack_span_kernel", len(spans)),
        _event_ms(lambda: PK.pack_channels_split_blocked_ref(cm_k, spans),
                  20), bound, library_ms=_device_ms(library, None,
                                                    len(spans))))
    print("B3 pack: bit-exact", flush=True)

    # B1 grouped walk, on the layout frame 0's first render builds
    lay, grp_cap = _b1_layout(outs_k[0], bb_k, T)
    _print_slab_work(lay, grp_cap, "headline")
    z_k, e_k = RG.tile_eval_grouped_skip(*lay[:6], grp_cap)
    z_r, e_r = RG.tile_eval_grouped_skip_ref(*lay[:6], grp_cap)
    torch.cuda.synchronize()
    assert torch.equal(e_k, e_r), "B1 winner ids differ"
    assert torch.equal(z_k, z_r), "B1 depths differ"
    hits = int((e_k >= 0).sum())
    assert hits > 20000, hits
    n_rows = int(lay[7])
    bound = _walk_bound(lay, z_k, e_k)
    recs.append(_rec(
        "raster_group_walk", "raster_group.cu", "raster_group.py:256", 0.0,
        _device_ms(lambda: RG.tile_eval_grouped_skip(*lay[:6], grp_cap),
                   "walk_grouped_skip_kernel", 2),
        _event_ms(lambda: RG.tile_eval_grouped_skip_ref(*lay[:6], grp_cap),
                  1), bound))
    merge = _device_ms(lambda: RG.tile_eval_grouped_skip(*lay[:6], grp_cap),
                       "walk_grouped_skip_kernel_merge", 1)
    print(f"B1 walk: exact, {hits} lit pixels, n_rows={n_rows}; kernel "
          f"{recs[-1]['ms']:.5f} ms (walk {recs[-1]['ms'] - merge:.5f}, merge "
          f"{merge:.5f}), bound {bound[0]:.5f} ms ({bound[1]})", flush=True)
    return recs


# --------------------------------------------------------------------------
# The grouped walk generations (B9d, B9e, B9f) and the fused setup+pack B10
# --------------------------------------------------------------------------
# render_soup(method=g) of every grouped generation, subtile8 first (the
# frame the others must equal bit for bit), subtile8 under SETUP_PACKED last
FRAME_RUNS = (("subtile8", False), ("subtile3", False), ("subtile4", False),
              ("subtile5", False), ("subtile6", False), ("subtile7", False),
              ("subtile8", True))


def _golden_caps(T):
    """The golden call's caps (tests/test_headline_goldens.py:49-52)."""
    def up(x, q):
        return -(-x // q) * q
    return dict(v_cap=up(T, 4096), big_cap=0, r_cap=up(2 * T, 2048),
                pair_cap=8 * T, tile_cap=1024)


def _check_b10(pos9, attrs_t, mvp, rows, cols, label):
    """B10 against its plain version and against B2 then B3, bit for bit
    (sign of zero included). Returns (outputs, tw)."""
    import torch
    from ascii_renderer_tpu_torch.ops import pack as PK
    from ascii_renderer_tpu_torch.ops import setup2dh as S
    A = attrs_t.shape[0] // 3
    tw = -(-(3 * A + 3) // 8) * 8
    got = S.setup_2dh_fused_packed(pos9, attrs_t, mvp, rows, cols, tw)
    want = S.setup_2dh_fused_packed_ref(pos9, attrs_t, mvp, rows, cols, tw)
    cm, bb = S.setup_2dh_fused(pos9, attrs_t, mvp, rows, cols)
    two = (bb, *PK.pack_channels_split_blocked(cm, [(0, 16), (16, 16 + tw)]))
    torch.cuda.synchronize()
    for what, other in (("its plain version", want), ("B2 then B3", two)):
        for a, b in [(got[0][k], other[0][k]) for k in got[0]] + list(zip(
                got[1:], other[1:])):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), f"B10 {label}: differs from {what}"
    n_valid = int(got[0]["valid"].sum())
    assert n_valid > 100, n_valid
    print(f"B10 {label}: A={A}, tw={tw}, {n_valid} valid; bit-identical to "
          f"its plain version and to B2 then B3", flush=True)
    return got, tw


# the grouped generations' own walks, by the generation whose layout each
# walks (B9f twice: on the K2 layout and on the K4 one)
GEN_WALKS = {"B9d": "subtile3", "B9e": "subtile4", "B9f K2": "subtile5",
             "B9f K4": "subtile6", "B1 K4": "subtile7", "B1 K8": "subtile8"}


# the walks check_generation_kernels times at the golden frame: (record
# name, profiler name of the walk (its merge adds "_merge"), TPU kernel)
GEN_RECORDS = {
    "B9d": ("raster_group_walk_grouped", "walk_grouped_kernel",
            "raster_group.py:135"),
    "B9e": ("raster_group_walk_direct", "walk_direct_kernel",
            "raster_group.py:586"),
    "B9f K2": ("raster_group_walk_k2", "walk_grouped_k2_kernel",
               "raster_group.py:735"),
    "B9f K4": ("raster_group_walk_k2", "walk_grouped_k2_kernel",
               "raster_group.py:735")}


def _walk_layout(lay):
    """A generation's layout (``ops/raster_group.Generation``) without the
    bins' places, ginv, that end it: a tuple ending (xl, yl, gbins, n_rows,
    n_pairs, n_used), the walk's arguments all but the last four (a
    checkout from before ginv ends its layouts with the 0-d n_used)."""
    return lay[:-1] if lay[-1].dim() == 1 else lay


def _generation_layouts(src32, keys, *caps):
    """{walk: (layout, kernel wrapper, plain version)} of the grouped
    generations' own walks (``_walk_layout``); caps (tiles_x, n_tiles,
    r_cap, pair_cap, grp_cap)."""
    from ascii_renderer_tpu_torch.ops import raster_group as RG
    return {walk: (_walk_layout(RG.GENERATIONS[g].build(src32, keys, *caps)),
                   RG.GENERATIONS[g].walk, RG.GENERATIONS[g].walk_ref)
            for walk, g in GEN_WALKS.items()}


def _setup_and_keys(pos9, attrs_t, mvp, rows, cols, big_cap):
    """B2, the pair keys and subtile3/4's wide pack (B7): (keys, src32).
    Every layout builder reads only the first 16 channels but the direct
    walk's, which takes all 32, so the 32-wide rows serve all of them."""
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.ops import pack as PK
    from ascii_renderer_tpu_torch.ops import setup2dh as S
    cm, bbox = S.setup_2dh_fused(pos9, attrs_t, mvp, rows, cols)
    keys = R._subtile_pair_keys_bbox(bbox, rows, cols, big_cap=big_cap)
    cm2 = cm.view(cm.shape[0], -1)
    width = max(R._round_up(cm2.shape[0], 8), 15)
    g = PK.pack_channels(cm2, width=width)
    g_r = PK.pack_channels_ref(cm2, width=width)
    torch.cuda.synchronize()
    assert torch.equal(g.view(torch.int32), g_r.view(torch.int32)), \
        "B7 wide pack not bit-exact"
    return keys, g[:, :32]


def check_generation_kernels(dev, soup, scene):
    """B9d, B9e, B9f (K2 and K4 layouts) and B10 against their plain
    versions: on the golden call's bunny frame (timed there) and on a
    random 48x96 soup at generous and overflowing caps. Returns the four
    records."""
    import numpy as np
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.core.camera import Camera
    from ascii_renderer_tpu_torch.ops import pack as PK
    from ascii_renderer_tpu_torch.ops import setup2dh as S

    p, n, c = (torch.as_tensor(x).to(dev) for x in soup)
    pos9, attrs_t = R.soup_static_prep(p, n, c, scene)
    mvp = R.camera_mvp(_golden_camera(), ROWS, COLS, PIXEL_ASPECT)
    T = pos9.shape[1]
    caps = _golden_caps(T)
    recs = {}

    # B10 on the golden frame, timed beside B2 + B3 on the same inputs
    got, tw = _check_b10(pos9, attrs_t, mvp, ROWS, COLS, "golden frame")
    spans = [(0, 16), (16, 16 + tw)]

    def b2_b3():
        cm_, _bb = S.setup_2dh_fused(pos9, attrs_t, mvp, ROWS, COLS)
        return PK.pack_channels_split_blocked(cm_, spans)

    ms = _device_ms(lambda: S.setup_2dh_fused_packed(pos9, attrs_t, mvp, ROWS,
                                                     COLS, tw),
                    "setup2dh_packed_kernel", 1)
    ms_b2 = _device_ms(b2_b3, "setup2dh_kernel", 1)
    ms_b3 = _device_ms(b2_b3, "pack_span_kernel", 2)
    print(f"B10 vs B2 + B3 (device ms, same inputs): {ms:.5f} vs "
          f"{ms_b2:.5f} + {ms_b3:.5f} = {ms_b2 + ms_b3:.5f}", flush=True)
    recs["B10"] = _rec(
        "setup2dh_packed", "setup2dh.cu", "setup2dh.py:212", 0.0, ms,
        _event_ms(lambda: S.setup_2dh_fused_packed_ref(pos9, attrs_t, mvp,
                                                       ROWS, COLS, tw), 5),
        _bound(_nbytes(pos9, attrs_t, *got[1:]) + 5 * 4 * got[1].shape[0],
               300 * T))

    # the walks on the golden frame's layouts
    tiles_x = -(-COLS // 128)
    n_tiles = (-(-ROWS // 8)) * tiles_x
    grp_cap = caps["tile_cap"] // 8
    keys, src32 = _setup_and_keys(pos9, attrs_t, mvp, ROWS, COLS,
                                  caps["big_cap"])
    lays = _generation_layouts(src32, keys, tiles_x, n_tiles, caps["r_cap"],
                               caps["pair_cap"], grp_cap)
    for walk, (lay, fn, ref) in lays.items():
        n_rows, n_pairs, n_used = (int(x) for x in lay[-3:])
        assert n_pairs <= caps["pair_cap"] and n_used <= 8 * grp_cap and (
            walk == "B9e" or n_rows <= caps["r_cap"]), (walk, lay[-3:])
        z_k, e_k = fn(*lay[:-4], grp_cap)
        (z_r, e_r), plain = _event_once(lambda: ref(*lay[:-4], grp_cap))
        torch.cuda.synchronize()
        assert torch.equal(e_k, e_r), f"{walk} golden frame: ids differ"
        assert torch.equal(z_k.view(torch.int32), z_r.view(torch.int32)), \
            f"{walk} golden frame: depths differ"
        hits = int((e_k >= 0).sum())
        assert hits > 20000, (walk, hits)
        print(f"{walk} golden frame: exact, {hits} lit pixels, "
              f"n_rows={n_rows}, plain {plain:.1f} ms", flush=True)
        if walk in GEN_RECORDS:  # the walk, then the merge
            name, kname, replaces = GEN_RECORDS[walk]
            _print_slab_work(lay, grp_cap, "golden frame", walk)
            rec = _rec(name, "raster_group.cu", replaces, 0.0,
                       _device_ms(lambda: fn(*lay[:-4], grp_cap), kname, 2),
                       plain, _walk_bound(lay, z_k, e_k))
            merge = _device_ms(lambda: fn(*lay[:-4], grp_cap),
                               kname + "_merge", 1)
            print(f"{walk} golden frame: kernel {rec['ms']:.5f} ms (walk "
                  f"{rec['ms'] - merge:.5f}, merge {merge:.5f}), bound "
                  f"{rec['bound_ms']:.5f} ms ({rec['bound_by']})",
                  flush=True)
            if walk != "B9f K4":  # the record; the K4 layout is also timed
                recs[walk] = rec
    del lays

    # a random 48x96 soup: odd CSR offsets (gskip 0..3), and caps that
    # overflow (clamped slab starts, dropped bins); B10 at A = 6 and 9
    rng = np.random.default_rng(5)
    Tr = 3000
    pos = torch.from_numpy(rng.uniform(-2, 2, (Tr, 9)).astype(np.float32))
    rpos9 = pos.view(Tr, 3, 3).permute(1, 2, 0).reshape(9, Tr).contiguous()
    rmvp = R.camera_mvp(Camera.create(pos=(2.5, 1.5, 3.0), yaw=-2.3,
                                      pitch=-0.3), 48, 96, 0.5)
    rpos9 = rpos9.to(dev)
    rattrs = {A: torch.from_numpy(rng.uniform(-1, 1, (3 * A, Tr)).astype(
        np.float32)).to(dev) for A in (6, 9)}
    for A in (6, 9):
        _check_b10(rpos9, rattrs[A], rmvp, 48, 96, f"random {Tr} tris")
    keys, src32 = _setup_and_keys(rpos9, rattrs[6], rmvp, 48, 96, 1024)
    # the same soup with 1,500 small triangles stacked in front of one spot:
    # one group far deeper than the rest
    stack = (np.repeat(rng.normal(0, 0.1, (1500, 3)), 3, 0)
             + rng.normal(0, 0.05, (4500, 3))).astype(np.float32)
    dpos9 = torch.cat([rpos9, torch.from_numpy(stack).view(1500, 3, 3)
                       .permute(1, 2, 0).reshape(9, 1500).to(dev)], dim=1)
    dkeys, dsrc32 = _setup_and_keys(
        dpos9, torch.cat([rattrs[6], rattrs[6][:, :1500]], dim=1), rmvp, 48,
        96, 1024)
    for label, (r_cap, pair_cap, gcap), (wkeys, wsrc) in (
            ("generous", (32 * 512, 1 << 16, 6), (keys, src32)),
            ("overflow", (64, 4096, 1), (keys, src32)),
            ("deep group", (32 * 512, 1 << 16, 6), (dkeys, dsrc32))):
        for walk, (lay, fn, ref) in _generation_layouts(
                wsrc, wkeys, 1, 6, r_cap, pair_cap, gcap).items():
            _print_slab_work(lay, gcap, f"random 48x96 {label} caps", walk)
            z_k, e_k = fn(*lay[:-4], gcap)
            z_r, e_r = ref(*lay[:-4], gcap)
            torch.cuda.synchronize()
            assert torch.equal(e_k, e_r), f"{walk} random {label}: ids differ"
            assert torch.equal(z_k.view(torch.int32), z_r.view(torch.int32)), \
                f"{walk} random {label}: depths differ"
            skips = (sorted(set(lay[3].tolist()))
                     if walk.startswith(("B9f", "B1")) else "-")
            print(f"{walk} random 48x96 {label} caps: exact, "
                  f"{int((e_k >= 0).sum())} lit pixels, gskip values {skips}",
                  flush=True)
        check_x10_layouts(wsrc, wkeys, (1, 6, r_cap, pair_cap, gcap),
                          f"random 48x96 {label} caps",
                          overflow=label == "overflow")
    return [recs["B9d"], recs["B9e"], recs["B9f K2"], recs["B10"]]


def _same_layout(got, want, what):
    """Every output of a layout build bit for bit (floats as their bits)."""
    import torch
    assert len(got) == len(want), what
    for j, (g, w) in enumerate(zip(got, want)):
        if w.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert g.shape == w.shape and torch.equal(g, w), \
            f"{what}: output {j} differs"


def check_x10_layouts(src32, keys, caps, label, overflow=False):
    """X10 in every layout it serves (GB.LAYOUTS), with and without the
    keys' offsets, against its plain version bit for bit; at overflowing
    caps the counts must report what was dropped."""
    import torch
    from ascii_renderer_tpu_torch.ops import group_build as GB
    tiles_x, n_tiles, r_cap, pair_cap, grp_cap = caps
    offsets = GB._bin_offsets(keys >> 18, keys.shape[0], n_tiles * 8)
    for gen, (k, rows256) in sorted(GB.LAYOUTS.items()):
        rc = 128 if rows256 and overflow else r_cap
        a = (src32, keys, tiles_x, n_tiles, rc, pair_cap, grp_cap)
        want = GB.build_rows_ref(*a, k=k, rows256=rows256)
        for offs in (None, offsets):
            got = GB.build_rows(*a, k=k, rows256=rows256, offsets=offs)
            torch.cuda.synchronize()
            _same_layout(got, want, f"X10 {gen} {label}")
        n_rows, n_pairs, n_used = (int(x) for x in want[-4:-1])
        if overflow:
            assert n_rows > rc or n_used > 8 * grp_cap, (gen, n_rows, n_used)
        print(f"X10 {gen} {label}: exact with and without offsets; n_rows "
              f"{n_rows} (r_cap {rc}), n_pairs {n_pairs}, n_used {n_used} "
              f"(slots {8 * grp_cap})", flush=True)


def _golden_generation_inputs(dev, gen):
    """(walk args, grp_cap) of generation ``gen``'s walk at the golden
    call's bunny frame (its layout at the golden caps), built by the
    calling package (tools/kernel_ab.py)."""
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.ops import raster_group as RG
    p, n, c = (torch.as_tensor(x).to(dev) for x in _bunny())
    pos9, attrs_t = R.soup_static_prep(p, n, c, _scene(dev))
    mvp = R.camera_mvp(_golden_camera(), ROWS, COLS, PIXEL_ASPECT)
    caps = _golden_caps(pos9.shape[1])
    tiles_x = -(-COLS // 128)
    n_tiles = (-(-ROWS // 8)) * tiles_x
    grp_cap = caps["tile_cap"] // 8
    keys, src32 = _setup_and_keys(pos9, attrs_t, mvp, ROWS, COLS,
                                  caps["big_cap"])
    lay = _walk_layout(RG.GENERATIONS[gen].build(
        src32, keys, tiles_x, n_tiles, caps["r_cap"], caps["pair_cap"],
        grp_cap))
    return lay[:-4], grp_cap


def b9d_golden_inputs(dev):
    """B9d at the golden call: subtile3's single-entry layout."""
    return _golden_generation_inputs(dev, "subtile3")


def b9e_golden_inputs(dev):
    """B9e at the golden call: subtile4's pair-ordered table and groups."""
    return _golden_generation_inputs(dev, "subtile4")


def b9f_golden_inputs(dev):
    """B9f at the golden call: subtile5's K2 layout."""
    return _golden_generation_inputs(dev, "subtile5")


def _generation_frame(dev, soup, scene):
    """A function (method, packed) -> (rgb, chars) of the golden call: the
    user's render_soup(method=g) at the golden caps, then the glyph pass."""
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.core.config import Config
    from ascii_renderer_tpu_torch.core.frame import Frame
    cfg = Config(pixel_aspect=PIXEL_ASPECT)
    p, n, c = (torch.as_tensor(x).to(dev) for x in soup)
    caps = _golden_caps(p.shape[0] // 3)
    cam = _golden_camera()

    def frame(method, packed):
        R.SETUP_PACKED = packed
        try:
            rgb = R.render_soup(p, n, c, scene, cam, ROWS, COLS,
                                PIXEL_ASPECT, method=method, **caps)
        finally:
            R.SETUP_PACKED = False
        return rgb, _glyph(Frame.from_float(rgb), cfg)

    return frame


def run_generations_path(dev, soup, scene):
    """Every grouped generation through the golden call and the glyph pass:
    frame 0 must give the checksum and equal subtile8's rgb bit for bit;
    then 10 timed frames each. Returns a function rendering one subtile3
    frame."""
    import numpy as np
    import torch
    frame = _generation_frame(dev, soup, scene)
    ref = None
    for method, packed in FRAME_RUNS:
        label = method + (" SETUP_PACKED" if packed else "")
        box = {}
        (ms,) = _timed(lambda: box.update(zip(("rgb", "chars"),
                                              frame(method, packed))), 1)
        rgb, chars = box["rgb"], box["chars"]
        assert chars.device.type == "cuda" and tuple(chars.shape) == (ROWS,
                                                                      COLS)
        total = int(chars.cpu().numpy().astype(np.uint64).sum())
        assert total == BUNNY_CHECKSUM, (label, total)
        same = ref is not None
        if same:
            assert torch.equal(rgb.view(torch.int32), ref.view(torch.int32)), \
                f"{label}: rgb frame differs from subtile8's"
        else:
            ref = rgb
        print(f"{label} golden call frame 0: {ms:.3f} ms, checksum {total}"
              f"{', rgb bit-identical to subtile8' if same else ''}",
              flush=True)
        _summary(f"{label} steady (golden call)",
                 _timed(lambda: frame(method, packed), 10))
    return lambda: frame("subtile3", False)


# --------------------------------------------------------------------------
# The retired generations: fused shading (B8), subtile (B9b), subtile2
# (B9c) and visibility_subtile (B9a)
# --------------------------------------------------------------------------
# B8 operations per (entry, pixel): three vertex-form edges (2 subtracts, a
# product and a fused multiply-add each), the area, its reciprocal, z, six
# tests and the merge; per pixel the interpolation of a win and the
# lighting of up to 8 point lights
B8_OPS, B8_OPS_PIXEL = 30, 400
# Pixels over 2e-3 between the reference's own frame of each retired
# generation and its subtile8 frame, the bunny at the golden pose, 960x540
# (JAX on the CPU; tests/test_torch_raster_oracles.py pins them): fused and
# subtile take their edges from the clip-expansion screen setup, subtile2
# from the same 2-D homogeneous planes as subtile8. The port's counts must
# stay within ORACLE_SLACK of them, JAX's own frame-to-frame bound (6
# pixels, tests/test_raster_channels.py), which also bounds B9a's winners
# against B9b's.
ORACLE_REF_DIFF = {"fused": 1892, "subtile": 1891, "subtile2": 0}
ORACLE_SLACK = 6
# kernel launches a golden-pose frame makes in its front stages: fused's
# raster.clip (X4's slots form), subtile2's raster.setup (B2 and the
# compare that makes its valid row a bool mask) and raster.pack (B7 over
# B2's rows)
ORACLE_FRONT_LAUNCHES = {("fused", "raster.clip"): 1,
                         ("subtile2", "raster.setup"): 2,
                         ("subtile2", "raster.pack"): 1}


def _capture(mod, name, run):
    """Run ``run()`` with ``mod.name`` recording the arguments of its first
    call: the inputs a path gives a kernel wrapper. Returns (args,
    kwargs)."""
    return _capture_all(mod, name, run)[0]


def _oracle_caps(dev, soup, scene, kernel):
    """A user's caps for render_soup(method=kernel): a diagnostic pass at
    lean caps (which the bunny overflows), then suggest_caps_subtile
    retries until nothing is dropped. Returns (caps dict, tries)."""
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.ops import raster_subtile as RS
    p, n, c = (torch.as_tensor(x).to(dev) for x in soup)
    n2t = p.shape[0] // 3 * 2
    caps = dict(v_cap=min(n2t, RS.MAX_TRI - 4096), big_cap=64,
                r_cap=1024, pair_cap=4096, tile_cap=None)
    for tries in range(1, 5):
        _rgb, diag = R.render_soup_diag(p, n, c, scene, _golden_camera(),
                                        ROWS, COLS, PIXEL_ASPECT,
                                        kernel=kernel, **caps)
        counts = [int(diag[k]) for k in ("n_valid", "n_big", "n_rows",
                                         "n_pairs", "n_tiles_nz")]
        print(f"{kernel} caps {caps}: counts {counts}", flush=True)
        if all(x <= (cap if cap is not None else x) for x, cap in zip(
                counts[1:], (caps["big_cap"], caps["r_cap"],
                             caps["pair_cap"], caps["tile_cap"]))) and (
                kernel == "subtile2" or counts[0] <= caps["v_cap"]):
            return caps, tries
        caps = dict(zip(("v_cap", "big_cap", "r_cap", "pair_cap",
                         "tile_cap"), R.suggest_caps_subtile(*counts)))
    raise AssertionError(f"{kernel}: caps did not settle: {caps}")


def _oracle_frame(dev, soup, scene, method, caps):
    """render_soup(method=...) of the bunny at the golden pose."""
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    p, n, c = (torch.as_tensor(x).to(dev) for x in soup)
    return lambda: R.render_soup(p, n, c, scene, _golden_camera(), ROWS,
                                 COLS, PIXEL_ASPECT, method=method, **caps)


def _visibility_subtile_call(dev, soup, caps):
    """visibility_subtile (B9a) as tools call it: on the bunny's compacted
    clip channels at the subtile path's caps."""
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    p = torch.as_tensor(soup[0]).to(dev)
    mvp = R.camera_mvp(_golden_camera(), ROWS, COLS, PIXEL_ASPECT)
    ch = R.setup_screen_channels(R.transform_clip_channels(p, mvp), ROWS,
                                 COLS)
    cch = R.compact_valid_ch(ch, caps["v_cap"])[0]
    return lambda: R.visibility_subtile(
        cch, ROWS, COLS, big_cap=caps["big_cap"], r_cap=caps["r_cap"],
        pair_cap=caps["pair_cap"])


def _check_walk(label, fn, ref, args, kw=None):
    """A subtile walk against its plain version: ids and depth bits equal.
    Returns (z, e, plain ms)."""
    import torch
    kw = kw or {}
    z_k, e_k = fn(*args, **kw)
    (z_r, e_r), plain = _event_once(lambda: ref(*args, **kw))
    torch.cuda.synchronize()
    assert torch.equal(e_k, e_r), f"{label}: ids differ"
    assert torch.equal(z_k.view(torch.int32), z_r.view(torch.int32)), \
        f"{label}: depths differ"
    print(f"{label}: exact, {int((e_k >= 0).sum())} lit pixels, plain "
          f"{plain:.1f} ms", flush=True)
    return z_k, e_k, plain


def _check_b8(label, args):
    """B8 against its plain version: rgb bit for bit (-0.0 folded).
    Returns (rgb, plain ms)."""
    import torch
    from ascii_renderer_tpu_torch.ops import raster_bins as RB
    rgb = RB.tile_eval_bins_shaded(*args)
    want, plain = _event_once(lambda: RB.tile_eval_bins_shaded_ref(*args))
    torch.cuda.synchronize()
    assert torch.equal((rgb + 0.0).view(torch.int32),
                       (want + 0.0).view(torch.int32)), f"B8 {label}: differs"
    lit = int((rgb.amax(1) > 0).sum())
    assert lit > 1000, (label, lit)
    print(f"B8 {label}: bit-identical, {lit} lit pixels, "
          f"{int(args[1][-1])} bin entries, plain {plain:.1f} ms", flush=True)
    return rgb, plain


def _random_subtile_layouts(dev, caps):
    """A random 64x512 soup (4 tiles across: tile x offsets up to 384) as
    the three walks' layouts: {walk: (args, kernel wrapper, plain)}."""
    import numpy as np
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.core.camera import Camera
    from ascii_renderer_tpu_torch.ops import raster_subtile as RS
    from ascii_renderer_tpu_torch.ops import setup2dh as S
    rows, cols, T = 64, 512, 3000
    rng = np.random.default_rng(5)
    pos = torch.from_numpy(rng.uniform(-2, 2, (T, 9)).astype(np.float32))
    pos9 = pos.view(T, 3, 3).permute(1, 2, 0).reshape(9, T).contiguous()
    attrs_t = torch.from_numpy(rng.uniform(-1, 1, (18, T)).astype(
        np.float32))
    mvp = R.camera_mvp(Camera.create(pos=(2.5, 1.5, 3.0), yaw=-2.3,
                                     pitch=-0.3), rows, cols, PIXEL_ASPECT)
    cm, bbox = S.setup_2dh_fused(pos9.to(dev), attrs_t.to(dev), mvp, rows,
                                 cols)
    src16 = cm.view(cm.shape[0], -1)[:16].t().contiguous()
    keys = R._subtile_pair_keys_bbox(bbox, rows, cols, big_cap=1024)
    out = {}
    for walk, build, name in (("B9a", "build_subtile_rows",
                               "tile_eval_subtile"),
                              ("B9b", "build_packed_rows",
                               "tile_eval_packed"),
                              ("B9c", "build_packed_rows_pre_id",
                               "tile_eval_packed_d")):
        lay = getattr(RS, build)(src16, keys, 4, 32, *caps)
        args = (*lay[:3 if walk == "B9c" else 2], 4, 32)
        out[walk] = (args, getattr(RS, name), getattr(RS, name + "_ref"))
    return out


def b8_bunny_inputs(dev, soup=None, scene=None):
    """B8's arguments at the bunny's fused call (golden pose), captured
    from one render_soup(method="fused") (tools/kernel_ab.py too)."""
    from ascii_renderer_tpu_torch.ops import raster_bins as RB
    args, _kw = _capture(RB, "tile_eval_bins_shaded", _oracle_frame(
        dev, soup or _bunny(), scene or _scene(dev), "fused", {}))
    return args


def _deep_fused_args(dev):
    """B8's arguments on a random soup of 2,000 triangles plus 3,000 small
    ones stacked in front of one spot, lit by a point light, at 48x384
    (6 x 3 tiles): a few bins of a thousand entries and more."""
    import numpy as np
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.backends import raster_oracles as RO
    from ascii_renderer_tpu_torch.core.camera import Camera
    from ascii_renderer_tpu_torch.scene.builder import SceneBuilder
    rng = np.random.default_rng(9)
    spread = rng.uniform(-2, 2, (3 * 2000, 3))
    stack = (np.repeat(rng.normal(0, 0.15, (3000, 3)), 3, 0)
             + rng.normal(0, 0.08, (3 * 3000, 3)))
    p = torch.from_numpy(np.concatenate([spread, stack]).astype(
        np.float32)).to(dev)
    n, c = (torch.from_numpy(rng.uniform(lo, 2, tuple(p.shape)).astype(
        np.float32)).to(dev) for lo in (-1, 0.2))
    scene = (SceneBuilder().set_env_light([0.15, 0.15, 0.2], 1.0)
             .add_point_light([1.0, 2.0, 1.0], [1.0, 0.9, 0.8], 1.0)
             .build(device=dev))
    cam = Camera.create(pos=(2.5, 1.5, 3.0), yaw=-2.3, pitch=-0.3)
    rows, cols = 48, 384
    mvp = R.camera_mvp(cam, rows, cols, PIXEL_ASPECT)
    ch = R.setup_screen_channels(R.transform_clip_channels(p, mvp), rows,
                                 cols)
    slots = R.clip_attrs_channel_lists(torch.cat([n, c, p], dim=1), ch)
    data, offsets, tiles_y, tiles_x = RO.fused_entries(ch, slots, rows, cols)
    deepest = int((offsets[1:] - offsets[:-1]).max())
    assert deepest >= 1000, deepest
    return data, offsets, RO.light_params(scene), tiles_x, tiles_y * tiles_x


def _print_b8_work(args, label):
    """B8's work list on its arguments: chunks per tile, items, blocks."""
    from ascii_renderer_tpu_torch.ops import raster_bins as RB
    data, offs, _lp, _tiles_x, n_tiles = args
    _first, n = RB.shaded_bin_slots(offs)
    items = int(n.sum())
    grid = min(4 * RB.shaded_n_slots(data.numel() // RB.NS_CHAN, n_tiles),
               2048)
    print(f"B8 {label}: {n_tiles} tiles, {int((n > 0).sum())} non-empty, "
          f"{int(offs[-1])} bin entries, deepest bin "
          f"{int((offs[1:] - offs[:-1]).max())} entries in {int(n.max())} "
          f"chunks; {items} work items of one 64-entry chunk, 4 a chunk "
          f"for {4 * items} block-items, walked by {grid} blocks",
          flush=True)


# subtile walk -> (kernel wrapper, render_soup kernel whose caps it takes,
# the path that calls it on the bunny)
SUBTILE_PATHS = {"B9a": ("tile_eval_subtile", "subtile", "visibility_subtile"),
                 "B9b": ("tile_eval_packed", "subtile", "subtile"),
                 "B9c": ("tile_eval_packed_d", "subtile2", "subtile2")}
# the profiler's name of each walk's kernels: walk + merge match it
SUBTILE_KERNELS = {"B9a": "subtile_walk_expanded_kernel",
                   "B9b": "subtile_walk_kernel", "B9c": "subtile_walk_kernel"}


def _print_subtile_work(walk, args, label):
    """A subtile walk's work list on its arguments: rows and items per
    tile, blocks."""
    from ascii_renderer_tpu_torch.ops import raster_subtile as RS
    rows, rowptr, n_tiles = args[0], args[1], args[-1]
    r_cap = rows.shape[0]
    rp = rowptr.clamp(0, r_cap)
    _first, n = RS.subtile_items(rp)
    items = int(n.sum())
    split = 4 if walk == "B9a" else 1  # blocks an item (a quarter tile each)
    print(f"{walk} {label}: {n_tiles} tiles, {int((n > 0).sum())} with "
          f"rows, {int(rp[-1])} rows of r_cap {r_cap}, deepest tile "
          f"{int((rp[1:] - rp[:-1]).max())} rows in {int(n.max())} items; "
          f"{items} work items of up to {RS.ITEM_R} rows, {split} an item "
          f"for {split * items} block-items, walked by "
          f"{min(split * RS.subtile_n_slots(r_cap, n_tiles), 2048)} blocks",
          flush=True)


def _subtile_bunny_inputs(dev, walk, soup=None, scene=None, caps=None):
    """A subtile walk's arguments at its path's call on the bunny (golden
    pose, the caps its render_soup kernel settles on), captured from one
    call of the path."""
    from ascii_renderer_tpu_torch.ops import raster_subtile as RS
    soup, scene = soup or _bunny(), scene or _scene(dev)
    wrapper, kernel, path = SUBTILE_PATHS[walk]
    caps = caps or _oracle_caps(dev, soup, scene, kernel)[0]
    run = (_visibility_subtile_call(dev, soup, caps) if walk == "B9a" else
           _oracle_frame(dev, soup, scene, path, caps))
    args, _kw = _capture(RS, wrapper, run)
    return args


def b9a_bunny_inputs(dev, soup=None, scene=None):
    """B9a's arguments at the bunny's visibility_subtile call
    (tools/kernel_ab.py)."""
    return _subtile_bunny_inputs(dev, "B9a", soup, scene)


def b9b_bunny_inputs(dev, soup=None, scene=None):
    """B9b's arguments at the bunny's subtile call (tools/kernel_ab.py)."""
    return _subtile_bunny_inputs(dev, "B9b", soup, scene)


def b9c_bunny_inputs(dev, soup=None, scene=None):
    """B9c's arguments at the bunny's subtile2 call (tools/kernel_ab.py)."""
    return _subtile_bunny_inputs(dev, "B9c", soup, scene)


def _deep_tie_packed(dev):
    """B9b's and B9c's arguments on a packed layout of eight tiles 4
    across, one of them 1,152 rows deep (36 work items): random planes in
    global pixel centres (coefficients up to 3e8), ids increasing; group
    0's rows across every 32-row item boundary are a depth tie at z = 0,
    the earlier +0.0, the later -0.0 on the same edges; group 1's last
    live row is a backdrop covering its bin at z = 0.995. B9b's dead slots
    hold the inert row (G0 = +1, ZC = 2); B9c's hold the next tile's
    backdrop, which wins wherever the depth mask does not kill it.
    Returns {walk: args}."""
    import numpy as np
    import torch
    rng = np.random.default_rng(21)
    n_rows, tiles_x = (64, 96, 32, 0, 160, 32, 1152, 64), 4
    rowptr = np.concatenate([[0], np.cumsum(n_rows)]).astype(np.int32)
    ent = np.zeros((int(rowptr[-1]), 8, 16), np.float32)
    depth = np.zeros((len(n_rows), 8), np.int32)
    backdrops = {}
    for t, (lo, hi) in enumerate(zip(rowptr[:-1], rowptr[1:])):
        m = int(hi - lo)
        if m == 0:
            continue
        cx = (t % tiles_x * 128 + np.arange(8) * 16
              + rng.uniform(-6, 22, (m, 8)))
        cy = t // tiles_x * 8 + rng.uniform(-3, 11, (m, 8))
        for k in range(3):
            ang = rng.uniform(0, 2 * np.pi, (m, 8))
            r = rng.uniform(0.05, 40, (m, 8)) * np.where(
                rng.random((m, 8)) < 0.15, 3e8, 1.0)
            a, b = np.cos(ang) * r, np.sin(ang) * r
            ent[lo:hi, :, 3 * k:3 * k + 3] = np.stack([a, b, -(
                a * (cx + rng.uniform(-20, 20, (m, 8)))
                + b * (cy + rng.uniform(-5, 5, (m, 8))))], -1)
        zx, zy = rng.normal(0, 2e-3, (m, 8)), rng.normal(0, 2e-2, (m, 8))
        ent[lo:hi, :, 9:12] = np.stack(
            [zx, zy, rng.uniform(-0.1, 1.1, (m, 8)) - zx * cx - zy * cy], -1)
        ent[lo:hi, :, 12] = np.sort(rng.choice(1 << 17, m * 8, replace=False)
                                    ).reshape(8, m).T
        for row in range(lo + 32, hi, 32):  # group 0's item boundaries
            ent[row - 1, 0, 9:12] = 0.0
            ent[row, 0, :9] = ent[row - 1, 0, :9]
            ent[row, 0, 9:12] = -0.0
        depth[t] = rng.integers(m // 2, m + 1, 8)
        depth[t, 0] = m
        ent[lo + depth[t, 1] - 1, 1, :12] = [0, 0, -1] * 3 + [0, 0, 0.995]
        backdrops[t] = ent[lo + depth[t, 1] - 1, 1].copy()
    inert = np.float32([0, 0, 1] + [0] * 8 + [2] + [0] * 4)
    out = {}
    for walk in ("B9b", "B9c"):
        e = ent.copy()
        for t, (lo, hi) in enumerate(zip(rowptr[:-1], rowptr[1:])):
            dead = np.arange(hi - lo)[:, None] >= depth[t]
            e[lo:hi][dead] = inert if walk == "B9b" else backdrops[
                min((u for u in backdrops if u > t), default=0)]
        rows = torch.from_numpy(e.reshape(-1, 128)).to(dev)
        mask = (torch.from_numpy(depth.ravel()).to(dev),) if (
            walk == "B9c") else ()
        out[walk] = (rows, torch.from_numpy(rowptr).to(dev), *mask, tiles_x,
                     len(n_rows))
    return out


def check_oracle_kernels(dev, soup, scene, caps):
    """B8, B9a, B9b and B9c against their plain versions: at the inputs
    their paths give them on the bunny at the golden pose (captured from
    one call of each path), B8 also on the demo room with a point light,
    the subtile walks also on a random 4-tile-wide soup at generous and
    overflowing caps; then B9a against B9b on the same bunny bins. Returns
    the four records, timed at the bunny's shapes."""
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.ops import raster_bins as RB
    from ascii_renderer_tpu_torch.ops import raster_subtile as RS
    recs = {}

    # B8: the bunny's fused frame, the demo room with a point light, and
    # random deep bins
    args = b8_bunny_inputs(dev, soup, scene)
    _print_b8_work(args, "bunny golden pose")
    rgb, plain = _check_b8("bunny golden pose", args)
    entries = int(args[1][-1])
    bound = _bound(160 * entries + _nbytes(args[1], args[2], rgb),
                   B8_OPS * 1024 * entries + B8_OPS_PIXEL * rgb.numel() // 3)
    ms = _device_ms(lambda: RB.tile_eval_bins_shaded(*args),
                    "shaded_walk_kernel", 2)
    recs["B8"] = _rec("raster_bins_walk_shaded", "raster_shaded.cu",
                      "raster_bins.py:292", 0.0, ms, plain, bound)
    merge = _device_ms(lambda: RB.tile_eval_bins_shaded(*args),
                       "shaded_walk_kernel_merge", 1)
    print(f"B8 bunny: kernel {ms:.4f} ms (walk {ms - merge:.4f}, merge "
          f"{merge:.4f}), bound {bound[0]:.5f} ms ({bound[1]})", flush=True)
    del args, rgb
    rscene, rsoup = _room(dev, point_light=True)
    assert int(rscene.n_pt) == 1
    rargs, _kw = _capture(RB, "tile_eval_bins_shaded", lambda: R.render_soup(
        *rsoup, rscene, rscene.camera, 36, 96, PIXEL_ASPECT, method="fused"))
    _print_b8_work(rargs, "demo room 96x36, point light")
    _check_b8("demo room 96x36, point light", rargs)
    dargs = _deep_fused_args(dev)
    _print_b8_work(dargs, "random deep bins 48x384")
    _check_b8("random deep bins 48x384", dargs)

    # B9b and B9c on the bunny's subtile / subtile2 paths, B9a on
    # visibility_subtile's; each a walk, then a merge launch
    for walk in ("B9b", "B9c", "B9a"):
        wrapper, kernel, path = SUBTILE_PATHS[walk]
        wargs = _subtile_bunny_inputs(dev, walk, soup, scene, caps[kernel])
        fn, ref = getattr(RS, wrapper), getattr(RS, wrapper + "_ref")
        z, e, plain = _check_walk(f"{walk} bunny ({path})", fn, ref, wargs)
        depth = (wargs[2] if walk == "B9c" else None)
        live = _live_pairs(wargs[0], wargs[1], depth, walk)
        bound = _bound(64 * live + _nbytes(wargs[1], z, e),
                       20 * 128 * live)
        _print_subtile_work(walk, wargs, f"bunny ({path})")
        name = SUBTILE_KERNELS[walk]
        ms = _device_ms(lambda: fn(*wargs), name, 2)
        merge = _device_ms(lambda: fn(*wargs), name + "_merge", 1)
        recs[walk] = _rec(
            {"B9a": "raster_subtile_walk", "B9b": "raster_subtile_walk_packed",
             "B9c": "raster_subtile_walk_packed_d"}[walk],
            "raster_subtile.cu",
            {"B9a": "raster_subtile.py:60", "B9b": "raster_subtile.py:274",
             "B9c": "raster_subtile.py:433"}[walk], 0.0, ms, plain, bound)
        print(f"{walk} bunny: kernel {ms:.5f} ms (walk {ms - merge:.5f}, "
              f"merge {merge:.5f}), bound {bound[0]:.5f} ms ({bound[1]}), "
              f"{live} live pairs, r_cap {wargs[0].shape[0]}", flush=True)

    # B9a against B9b on the same bunny bins, both reporting triangle ids
    bargs, bkw = _capture(RS, "build_packed_rows", _oracle_frame(
        dev, soup, scene, "subtile", caps["subtile"]))
    lay_p = RS.build_packed_rows(*bargs, **bkw)
    lay_e = RS.build_subtile_rows(*bargs, **bkw)
    z_p, e_p = RS.tile_eval_packed(*lay_p[:2], *bargs[2:4])
    z_e, e_e = RS.tile_eval_subtile(*lay_e[:2], *bargs[2:4])
    torch.cuda.synchronize()
    # the two round their planes differently (ops/raster_subtile.py), so
    # where an edge passes through a pixel centre one may cover it and the
    # other not, and the pixel takes another winner
    same = e_e == e_p
    hit = same & (e_p >= 0)
    err = float((z_e[hit] - z_p[hit]).abs().max())
    both = ~same & (e_e >= 0) & (e_p >= 0)
    n_diff = int((~same).sum())
    gap = float((z_e[both] - z_p[both]).abs().max()) if bool(
        both.any()) else 0.0
    print(f"B9a vs B9b on the bunny's bins: {int(hit.sum())} lit pixels "
          f"with equal ids, z max diff {err}, z words differ "
          f"{int((z_e[hit] != z_p[hit]).sum())}; ids differ at {n_diff} "
          f"pixels ({int(both.sum())} lit by both, depth gap up to {gap}; "
          f"{n_diff - int(both.sum())} lit by one)", flush=True)
    assert err <= 1e-5, f"B9a and B9b: z differs by {err}"
    assert n_diff <= ORACLE_SLACK, f"B9a and B9b: {n_diff} ids differ"
    del lay_p, lay_e

    # the random 4-tile-wide soup at generous and overflowing caps
    for label, wcaps in (("generous", (8192, 1 << 16)),
                         ("overflow", (256, 2048))):
        for walk, (wargs, fn, ref) in _random_subtile_layouts(
                dev, wcaps).items():
            _print_subtile_work(walk, wargs, f"random 64x512 {label} caps")
            _check_walk(f"{walk} random 64x512 {label} caps", fn, ref, wargs)

    # B9b and B9c on a tile of 36 items with +0.0 / -0.0 boundary ties
    for walk, wargs in _deep_tie_packed(dev).items():
        label = f"{walk} deep tile with boundary ties"
        wrapper = SUBTILE_PATHS[walk][0]
        _print_subtile_work(walk, wargs, "deep tile with boundary ties")
        z, _e, _plain = _check_walk(label, getattr(RS, wrapper),
                                    getattr(RS, wrapper + "_ref"), wargs)
        zt = z[6][:, :16]  # the deep tile's group 0
        assert int((zt == 0.0).sum()) > 20, label
        assert not torch.signbit(zt[zt == 0.0]).any(), f"{label}: -0.0 won"
    return [recs["B8"], recs["B9a"], recs["B9b"], recs["B9c"]]


def _live_pairs(rows, rowptr, depth, walk):
    """Live (bin, triangle) pairs a subtile walk tests: B9c's from its
    depth mask, B9a's and B9b's the layout rows' slots whose entry is not
    the inert row (G0 = +1 with A0 = B0 = 0)."""
    import torch
    if depth is not None:
        return int(depth.sum())
    n = int(rowptr[-1])
    if walk == "B9a":  # lane 16 g of each channel
        ent = rows[:n, :, ::16].transpose(1, 2)
    else:
        ent = rows[:n].view(n, 8, 16)
    inert = (ent[..., 2] == 1.0) & (ent[..., 0] == 0.0) & (ent[..., 1] == 0.0)
    return int((~inert).sum())


def run_oracle_paths(dev, soup, scene, caps, counters):
    """The retired generations at 960x540 as a user calls them, each with
    every launch count set to 0 just before and read just after: frame 0
    through the glyph pass (checksum printed; its pixels over 2e-3 from
    subtile8's frame within ORACLE_SLACK of ORACLE_REF_DIFF), then 10 timed
    frames; and visibility_subtile. Returns {path: counts} and {method: a
    function rendering one frame through the glyph pass}."""
    import numpy as np
    import torch
    from ascii_renderer_tpu_torch.core.config import Config
    from ascii_renderer_tpu_torch.core.frame import Frame
    cfg = Config(pixel_aspect=PIXEL_ASPECT)
    p = soup[0]
    ref = _oracle_frame(dev, soup, scene, "subtile8",
                        _golden_caps(p.shape[0] // 3))()
    out, frames = {}, {}
    for method in ("fused", "subtile", "subtile2"):
        frame = _oracle_frame(dev, soup, scene, method, caps.get(method, {}))

        def run(frame=frame, method=method):
            box = {}
            (ms,) = _timed(lambda: box.update(rgb=frame()), 1)
            rgb = box["rgb"]
            chars = _glyph(Frame.from_float(rgb), cfg)
            assert tuple(chars.shape) == (ROWS, COLS) and torch.isfinite(
                rgb).all()
            total = int(chars.cpu().numpy().astype(np.uint64).sum())
            bad = int(((rgb - ref).abs().amax(-1) > 2e-3).sum())
            want = ORACLE_REF_DIFF[method]
            print(f"{method} frame 0: {ms:.3f} ms, checksum {total} "
                  f"({'equals' if total == BUNNY_CHECKSUM else 'differs from'}"
                  f" {BUNNY_CHECKSUM}), {bad} pixels over 2e-3 from "
                  f"subtile8's frame (the reference's own: {want})",
                  flush=True)
            assert abs(bad - want) <= ORACLE_SLACK, (method, bad, want)
            _summary(f"{method} steady (golden pose)", _timed(
                lambda: _glyph(Frame.from_float(frame()), cfg), 10))

        out[method], _ = _path_counts(counters, run)
        print(f"launches on the {method} path: {out[method]}", flush=True)
        frames[method] = lambda frame=frame: _glyph(Frame.from_float(
            frame()), cfg)
    vis = _visibility_subtile_call(dev, soup, caps["subtile"])

    def run_vis():
        zbuf, eidx, _tri, n_rows, _n_pairs = vis()
        assert int(n_rows) <= caps["subtile"]["r_cap"]
        print(f"visibility_subtile: {int((eidx >= 0).sum())} lit pixels",
              flush=True)
        _summary("visibility_subtile (B9a) steady", _timed(vis, 10))

    out["visibility_subtile"], _ = _path_counts(counters, run_vis)
    print(f"launches on visibility_subtile: {out['visibility_subtile']}",
          flush=True)
    return out, frames


def b4_headline_inputs(dev, soup=None, scene=None):
    """B4's inputs at the raster headline's frame 0 (RasterBackend at the
    golden camera): the ramp-index plane and the override plane that
    glyph_decide hands the vote, int32 / bool [540, 960]
    (tools/kernel_ab.py too)."""
    from ascii_renderer_tpu_torch.backends.raster import RasterBackend
    from ascii_renderer_tpu_torch.core import quantize
    from ascii_renderer_tpu_torch.core.config import Config
    cfg = Config(pixel_aspect=PIXEL_ASPECT)
    backend = RasterBackend(cfg, device=dev)
    backend.set_soup(*(soup or _bunny()), scene or _scene(dev))
    frame = backend.render(0.0, _golden_camera(), ROWS, COLS, PIXEL_ASPECT)
    ramp_len = len(cfg.ascii_ramp or quantize.DEFAULT_RAMP)
    return (quantize.quantize_index(frame.rgb, ramp_len),
            quantize.is_override(frame.a))


def _b4_ops(idx, ovr, radius):
    """The integer operations the vote needs on these planes: none at an
    override cell; else B4_OPS a neighbour in the first pass, and again in
    the second where the candidate could be adopted (cand >= 0 and cand !=
    the cell's index), one fewer a neighbour and pass where no cell of the
    window is an override (no override test)."""
    import torch
    import torch.nn.functional as F
    from ascii_renderer_tpu_torch.ascii.modal import modal_candidate
    cand, _votes = modal_candidate(idx, ovr, radius)
    k = 2 * radius + 1
    # the window's cells, the grid edge clamped as the vote clamps it (a
    # batch of planes [V, H, W] each alone)
    planes = ovr.float().reshape(-1, 1, *ovr.shape[-2:])
    near = (F.max_pool2d(F.pad(planes, (radius,) * 4, mode="replicate"), k,
                         stride=1) > 0).reshape(ovr.shape)
    per = (B4_OPS - 1) + near.long()
    passes = 1 + ((cand >= 0) & (cand != idx)).long()
    return int((per * passes * (~ovr).long()).sum()) * (k * k - 1)


def check_modal(dev, soup, scene):
    """B4 against its plain version: 540x960 and 36x96, radius 1..3,
    random indices and override masks, and the headline frame 0's own
    planes; exactly equal. Timed at the raster frame's shape and the
    config's radius 2 / thresh 12, on the random planes (the record) and
    on the headline's."""
    import torch
    from ascii_renderer_tpu_torch.ops import ascii_kernel as AK
    g = torch.Generator().manual_seed(0)
    for h, w in ((540, 960), (36, 96)):
        for radius, thresh in ((1, 5), (2, 12), (3, 24)):
            idx = torch.randint(0, 10, (h, w), generator=g,
                                dtype=torch.int32).to(dev)
            ovr = (torch.rand((h, w), generator=g) < 0.1).to(dev)
            got = AK.modal_filter_kernel(idx, ovr, radius, thresh)
            ref = AK.modal_filter(idx, ovr, radius, thresh)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), f"B4 differs at {h}x{w} r{radius}"
    h, w = ROWS, COLS
    idx = torch.randint(0, 10, (h, w), generator=g, dtype=torch.int32).to(dev)
    ovr = (torch.rand((h, w), generator=g) < 0.1).to(dev)
    real_idx, real_ovr = b4_headline_inputs(dev, soup, scene)
    assert torch.equal(AK.modal_filter_kernel(real_idx, real_ovr, 2, 12),
                       AK.modal_filter(real_idx, real_ovr, 2, 12)), \
        "B4 differs on the headline's planes"
    print(f"B4 modal: exact at 540x960 and 36x96, radius 1-3, and on the "
          f"headline frame 0's planes ({int(real_ovr.sum())} overrides); "
          f"{AK.cells_per_thread(h, w)} cells a thread at {h}x{w}, "
          f"{AK.cells_per_thread(36, 96)} at 36x96", flush=True)
    # each plane's bound from the operations its data needs (_b4_ops)
    bound, real_bound = (
        _bound(h * w * (4 + 1 + 4), _b4_ops(i, o, 2), PEAK_INT32)
        for i, o in ((idx, ovr), (real_idx, real_ovr)))
    every = B4_OPS * 2 * ((2 * 2 + 1) ** 2 - 1) * h * w
    print(f"B4 bound at {h}x{w}, radius 2: random planes {bound[0]:.5f} ms, "
          f"the headline's {real_bound[0]:.5f} ms ({bound[1]}, "
          f"{real_bound[1]}: up to {B4_OPS} integer operations a neighbour "
          f"and pass as the planes need them, at {PEAK_INT32:.3g}/s; "
          f"every cell, both passes {every / PEAK_INT32 * 1e3:.5f} ms; "
          f"bytes alone {h * w * 9 / PEAK_BYTES * 1e3:.5f} ms)", flush=True)
    rec = _rec(
        "modal_vote", "modal.cu", "ascii_kernel.py:41", 0.0,
        _device_ms(lambda: AK.modal_filter_kernel(idx, ovr, 2, 12),
                   "modal_kernel", 1),
        _event_ms(lambda: AK.modal_filter(idx, ovr, 2, 12), 20), bound)
    rec["ops_rate"] = PEAK_INT32
    rec["real_planes_ms"] = _device_ms(
        lambda: AK.modal_filter_kernel(real_idx, real_ovr, 2, 12),
        "modal_kernel", 1)
    rec["ms_36x96"] = _device_ms(
        lambda: AK.modal_filter_kernel(idx[:36, :96].contiguous(),
                                       ovr[:36, :96].contiguous(), 2, 12),
        "modal_kernel", 1)
    # the same grid at one cell a thread, beside the chosen K
    one = _device_ms(lambda: AK.modal_filter_kernel(idx, ovr, 2, 12,
                                                    cells=1),
                     "modal_kernel", 1)
    rec["real_planes_bound_ms"] = real_bound[0]
    print(f"B4 kernel at {h}x{w} r2: random planes {rec['ms']:.5f} ms "
          f"({one:.5f} at 1 cell a thread; "
          f"{100 * bound[0] / rec['ms']:.0f}% of the bound), the headline's "
          f"{rec['real_planes_ms']:.5f} ms "
          f"({100 * real_bound[0] / rec['real_planes_ms']:.0f}%); 36x96 "
          f"{rec['ms_36x96']:.5f} ms", flush=True)
    return rec


def _pt_scene(atlas=(32, 32), **build_kw):
    from ascii_renderer_tpu_torch.atlas.io import demo_atlas
    from ascii_renderer_tpu_torch.scene.demo import create_demo_scene
    sb = create_demo_scene()
    sb.set_atlas(demo_atlas(*atlas))
    return sb.build(min_pad=1, **build_kw)


def _pt_camera():
    from ascii_renderer_tpu_torch.core.camera import Camera
    return Camera.create(**PT_POSE)


def _pt_batch(dev, scene, rows, cols, B, seed):
    """Kernel inputs of sample batch 0 of a rows x cols frame at the poster
    pose, as render_pt builds them (no pixel fetched, so every sample
    s > 0 is jittered)."""
    import torch
    from ascii_renderer_tpu_torch.backends import pathtrace as PT
    from ascii_renderer_tpu_torch.core.camera import camera_basis, ndc_grid
    from ascii_renderer_tpu_torch.core.config import PathTracerConfig
    from ascii_renderer_tpu_torch.ops import pt_kernel as PTK
    from ascii_renderer_tpu_torch.ops import ray_grid as RYG
    cam = _pt_camera()
    basis = camera_basis(cam.yaw, cam.pitch, cam.fov_y)
    px, py, aspect = ndc_grid(rows, cols, PIXEL_ASPECT, dev)
    pc = rows * cols
    uid = (torch.arange(B, dtype=torch.int32, device=dev)[:, None] * pc
           + torch.arange(pc, dtype=torch.int32, device=dev)[None])
    fetched = torch.zeros(pc, dtype=torch.bool, device=dev)
    rd = RYG.batch_ray_dirs(basis, px, py, aspect, fetched, uid, seed,
                            torch.arange(B, device=dev))
    n = B * pc
    nblk = -(-n // 1024)
    ro = cam.pos.to(dev).expand(B, rows, cols, 3)
    lc, lr = PT.get_light_sphere(scene, 0.0)
    lcol = torch.tensor(PathTracerConfig().light_color) * 1.3
    prim, atlas, aw, ah, sph_rows = PT.pack_scene_entries(scene)
    args = (PT._params(lc, lr, lcol, dev), prim, PTK.blockify(ro, n, nblk),
            PTK.blockify(rd, n, nblk), seed, atlas)
    kw = dict(bounces=5, nee=True, atlas_w=aw, atlas_h=ah, sph_rows=sph_rows)
    uid = torch.cat([uid.reshape(-1), uid.new_zeros(nblk * 1024 - n)])
    return args, kw, uid.reshape(nblk, 8, 128), n


def _compare_b5(k, p, n, label):
    import torch
    assert torch.equal(k[3], p[3]), f"B5 {label}: ov differs"
    assert torch.equal(k[4], p[4]), f"B5 {label}: fet differs"
    kr = torch.stack([o.reshape(-1)[:n] for o in k[:3]], -1)
    pr = torch.stack([o.reshape(-1)[:n] for o in p[:3]], -1)
    err = float((kr - pr).abs().max())
    ray_err = (kr - pr).abs().amax(-1)
    within = float((ray_err <= 1e-4).double().mean())
    not_bit = float((kr.view(torch.int32) != pr.view(torch.int32)).any(-1)
                    .double().mean())
    mk, mp = float(kr.double().mean()), float(pr.double().mean())
    rel = abs(mk - mp) / max(abs(mp), 1e-30)
    print(f"B5 {label}: ov/fet exact; radiance max_abs_err {err}, rays not "
          f"bit-identical {not_bit:.6f}"
          f"{' (bit-identical)' if not_bit == 0 else ''}, within 1e-4 "
          f"{within:.6f}, mean {mk:.7f} vs {mp:.7f} (rel {rel:.3g}), "
          f"overrides {int((k[3].reshape(-1)[:n] > 0).sum())}", flush=True)
    assert not_bit == 0, f"B5 {label}: {not_bit} of rays not bit-identical"
    return err


def _b5_ops(stats, prim_rows, sph_rows):
    e_s = 4 * sph_rows
    e_t = 4 * (prim_rows - sph_rows)
    search = e_s * B5_OPS_SPHERE + e_t * B5_OPS_TRI
    return (stats["segments"] * (search + B5_OPS_BOUNCE)
            + stats["shadow_rays"] * (search + B5_OPS_NEE))


def _b5_frame_form(PK, args, kw, pc, npix, uid0=0, pix_uid=None,
                   block_active=None):
    """B5's frame form on a _pt_batch launch's rays (the light and the
    camera position by value, each ray's uid from its stream slot: pc
    slots of npix pixels from uid0, or pix_uid), its plain version, and
    its per-ray form on the same rays: the origin on every ray, the same
    uids (frame_uids). Returns (frame call, plain call, per-ray call)."""
    import torch
    params, prim, _ro, rd, seed, atlas = args
    nblk = rd.shape[0]
    light = params.tolist()
    origin = _pt_camera().pos.to(torch.float32).tolist()
    fkw = dict(kw, pc=pc, npix=npix, uid0=uid0, pix_uid=pix_uid,
               block_active=block_active)
    ro = torch.tensor(origin, device=rd.device).expand(nblk, 8, 128,
                                                       3).contiguous()
    uid = PK.frame_uids(nblk, pc, npix, uid0, pix_uid, device=rd.device)
    return (lambda: PK.trace_frame(light, origin, prim, rd, seed, atlas,
                                   **fkw),
            lambda: PK.trace_frame_ref(light, origin, prim, rd, seed, atlas,
                                       **fkw),
            lambda: PK.trace_blocks_raw(params, prim, ro, rd, seed, atlas,
                                        **kw, uid=uid,
                                        block_active=block_active))


def _b5_same(label, frame, plain, per_ray):
    """Holds B5's frame form to its plain version and to the per-ray form
    on the same rays, every output bit for bit."""
    import torch
    fk, fp, fr = frame(), plain(), per_ray()
    torch.cuda.synchronize()
    for a_, b_, c_ in zip(fk, fr, fp):
        assert torch.equal(a_.view(torch.int32), b_.view(torch.int32)), \
            f"B5 {label}: the frame form differs from the per-ray form"
        assert torch.equal(a_.view(torch.int32), c_.view(torch.int32)), \
            f"B5 {label}: the frame form differs from its plain version"
    return fk


# B5's frame form over a stream that is not a whole frame's: (rows, cols,
# samples, band (row_lo, n_rows) or None, compacted): a band's batch of the
# reference run (uid0 = 12 x 96), the progressive HD batch's compacted
# stream (pix_uid, 30% of its pixels active, the blocks of the rest gated)
B5_STREAM_CALLS = {"band 12-24 batch": (36, 96, 32, (12, 12), False),
                   "compacted HD batch": (540, 960, 8, None, True)}


def check_b5_streams(dev, scene):
    """B5's frame form at B5_STREAM_CALLS against its plain version and
    its per-ray form, bit for bit (a gated block's outputs included)."""
    import torch
    from ascii_renderer_tpu_torch.backends import pathtrace as PT
    from ascii_renderer_tpu_torch.ops import pt_kernel as PK
    from ascii_renderer_tpu_torch.tools.xla_inputs import pixel_order
    for label, (rows, cols, B, band, compacted) in B5_STREAM_CALLS.items():
        row_lo, n_rows = band or (0, rows)
        pc = n_rows * cols
        args, kw, _uid, n = _pt_batch(dev, scene, n_rows, cols, B, 1)
        skw = dict(uid0=row_lo * cols)
        gated = ""
        if compacted:
            act, order = pixel_order(n_rows, cols, 0.3, seed=1)
            skw["pix_uid"] = torch.from_numpy(order + row_lo * cols).to(
                device=dev, dtype=torch.int32)
            skw["block_active"] = PT._block_gate(
                (torch.arange(pc) < int(act.sum())).repeat(B)).to(dev)
            gated = (f", {int(skw['block_active'].sum())}/"
                     f"{skw['block_active'].numel()} blocks live")
        fk = _b5_same(label, *_b5_frame_form(PK, args, kw, pc, rows * cols,
                                             **skw))
        print(f"B5 {label} ({n} rays, uid0 {skw['uid0']}"
              f"{', pix_uid' if compacted else ''}{gated}): frame form "
              f"bit-identical to its plain version and to the per-ray form, "
              f"{int((fk[3].reshape(-1)[:n] > 0).sum())} overrides",
              flush=True)


def check_pt_kernel(dev):
    """B5 against its plain version at every launch shape of the PT runs:
    the reference run's batch (32 x 96x36 rays, seed 1) and probe (1 x
    96x36), the HD arm's probe (1 x 960x540) and batch (8 x 960x540), in
    its per-ray form, and its frame form (the render paths': the light and
    one origin by value) against its plain version and against the
    per-ray form on the same rays, also on a band's and a compacted
    stream (check_b5_streams); then the placement check at the reference
    batch. Returns the record (the frame form timed at the
    reference batch and the HD arm's, beside the per-ray form)."""
    import torch
    from ascii_renderer_tpu_torch.ops import pt_kernel as PK
    scene = _pt_scene(device=dev)
    rec = None
    frame_ms = {}
    for rows, cols, B, label in ((36, 96, 32, "reference batch"),
                                 (36, 96, 1, "reference probe"),
                                 (540, 960, 1, "HD probe"),
                                 (540, 960, 8, "HD arm batch")):
        args, kw, uid, n = _pt_batch(dev, scene, rows, cols, B, 1)
        k = PK.trace_blocks_raw(*args, **kw)
        stats = {}
        p = PK.trace_blocks_raw_ref(*args, **kw, stats=stats)
        torch.cuda.synchronize()
        err = _compare_b5(k, p, n, f"{label} ({n} rays)")
        prim = args[1]
        ops = _b5_ops(stats, prim.shape[0], kw["sph_rows"])
        bound = _bound(_nbytes(*args[:4], args[5]) + 4 * n + 20 * n, ops,
                       PEAK_FP32_INSTR)
        ms = _device_ms(lambda: PK.trace_blocks_raw(*args, **kw),
                        "pt_trace_kernel", 1)
        plain = _event_ms(lambda: PK.trace_blocks_raw_ref(*args, **kw), 3)
        print(f"B5 {label}: kernel {ms:.4f} ms, plain {plain:.3f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]} at the FP32 instruction rate; "
              f"{stats['segments']} segments, alive per bounce "
              f"{stats['alive']}, {stats['shadow_rays']} shadow searches, "
              f"{ops:.4g} ops)", flush=True)
        # the frame form: its plain version and the per-ray form on the
        # same rays (the origin on the pad rays too), bit for bit
        frame, plain_f, per_ray = _b5_frame_form(PK, args, kw, rows * cols,
                                                 rows * cols)
        _b5_same(label, frame, plain_f, per_ray)
        if B > 1:
            frame_ms[label] = (
                _device_ms(frame, "pt_trace_kernel", 1),
                _device_ms(per_ray, "pt_trace_kernel", 1), bound[0])
            print(f"B5 {label}: frame form {frame_ms[label][0]:.4f} ms, "
                  f"per-ray form on the same rays {frame_ms[label][1]:.4f} "
                  f"ms; both bit-identical to each other and to the plain "
                  f"version", flush=True)
        else:
            print(f"B5 {label}: frame form bit-identical to the per-ray "
                  f"form and to its plain version", flush=True)
        if rec is None:
            rec = _rec("pt_megakernel", "pt_trace.cu", "pt_kernel.py:153",
                       err, ms, plain, bound)
            rec["ops_rate"] = PEAK_FP32_INSTR
            # placement: a random block gate and a permuted ray order with
            # canonical uids leave every live ray's output bit-identical
            g = torch.Generator().manual_seed(1)
            nblk = uid.shape[0]
            act = (torch.rand(nblk, generator=g) < 0.6).to(torch.int32)
            act[0] = 1
            perm = torch.randperm(nblk * 1024, generator=g).to(dev)
            ro = args[2].reshape(-1, 3)[perm].reshape(args[2].shape)
            rd = args[3].reshape(-1, 3)[perm].reshape(args[3].shape)
            uid_p = uid.reshape(-1)[perm].reshape(uid.shape)
            kq = PK.trace_blocks_raw(args[0], args[1], ro.contiguous(),
                                     rd.contiguous(), args[4], args[5], **kw,
                                     block_active=act.to(dev), uid=uid_p)
            live = act.to(dev).repeat_interleave(1024).bool()
            for a_, b_ in zip(kq, k):
                a_, b_ = a_.reshape(-1), b_.reshape(-1)[perm]
                assert torch.equal(a_[live].view(torch.int32),
                                   b_[live].view(torch.int32)), \
                    "B5: a live ray changed under the permutation"
                assert not a_[~live].any(), "B5: a gated block is not zero"
            print(f"B5 placement: {int(act.sum())}/{nblk} blocks live, "
                  f"every live ray bit-identical under a permuted order, "
                  f"gated blocks zero", flush=True)
    check_b5_streams(dev, scene)
    # the record: the frame form, the render paths' (the per-ray form's
    # times beside it)
    rec["ms_per_ray"] = rec["ms"]
    rec["ms"], _pr, _b = frame_ms["reference batch"]
    (rec["ms_hd"], rec["ms_hd_per_ray"],
     rec["bound_ms_hd"]) = frame_ms["HD arm batch"]
    return rec


def check_ray_grid(dev):
    """The ray grid kernel against its plain version (core/camera.ray_dirs
    on the same CUDA tensors) at the PT runs' shapes: the centre grids
    96x36 and 960x540, and a jittered batch of each (32 and 8 samples),
    at the poster pose and at a pose off the axes; bit for bit. Returns
    the record (timed at the HD arm's batch)."""
    import torch
    from ascii_renderer_tpu_torch.core.camera import (Camera, camera_basis,
                                                      ndc_grid, ray_dirs)
    from ascii_renderer_tpu_torch.ops import ray_grid as RYG
    g = torch.Generator().manual_seed(2)
    rec = None
    for cam in (_pt_camera(), Camera.create(pos=(0.3, 1.2, 4.0), yaw=-1.234,
                                            pitch=0.321)):
        basis = camera_basis(cam.yaw, cam.pitch, cam.fov_y)
        for rows, cols, B in ((36, 96, 0), (36, 96, 32), (540, 960, 0),
                              (540, 960, 8)):
            px, py, aspect = ndc_grid(rows, cols, PIXEL_ASPECT, dev)
            if B:
                jit = ((torch.rand((B, rows, cols, 2), generator=g) - 0.5)
                       * (2.0 / rows)).to(dev)
                px, py = px[None] + jit[..., 0] * aspect, py[None] + jit[..., 1]
            got = RYG.ray_grid(px, py, basis)
            want = ray_dirs(px, py, basis)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
                f"ray grid differs at {tuple(px.shape)}"
        n = px.numel()
        if rec is None:
            ms = _device_ms(lambda: RYG.ray_grid(px, py, basis),
                            "ray_grid_kernel", 1)
            plain = _event_ms(lambda: ray_dirs(px, py, basis), 5)
            # 8 bytes in and 12 out a ray; ~21 float operations a ray
            bound = _bound(20 * n, 21 * n)
            print(f"ray grid: bit-identical at 96x36 and 960x540, centre "
                  f"and jittered batches, two poses; kernel {ms:.5f} ms, "
                  f"plain {plain:.3f} ms, bound {bound[0]:.5f} ms "
                  f"({bound[1]}) at {n} rays", flush=True)
            rec = _rec("ray_grid", "ray_grid.cu", "", 0.0, ms, plain, bound)
            # the XLA code it stands for: no Pallas kernel computes the grid
            rec["replaces"] = "ascii_renderer_tpu/backends/pathtrace.py:394"
    return rec


# render_pt's sample-ray (X7) calls held to the plain chain: (rows, cols,
# samples a batch (0: the probe), batch index, row band or None, stream
# order compacted): the reference run's batches 0 and 1 and probe, the HD
# arm's batch and probe, a compacted reference batch, a band's batch, a
# compacted band's probe
PT_RAY_CALLS = {"reference batch 0": (36, 96, 32, 0, None, False),
                "reference batch 1": (36, 96, 32, 1, None, False),
                "reference probe": (36, 96, 0, 0, None, False),
                "HD arm batch": (540, 960, 8, 0, None, False),
                "HD probe": (540, 960, 0, 0, None, False),
                "compacted reference batch 1": (36, 96, 32, 1, None, True),
                "band batch 1": (36, 96, 32, 1, (12, 12), False),
                "compacted band probe": (36, 96, 0, 0, (12, 12), True)}


def _pt_rays_call(dev, basis, rows, cols, B, b, band, compacted):
    """(keywords of a pt_rays call, rays, pixels): a mix of fetched,
    unfetched and NaN probe pixels (tools/xla_inputs.pt_outputs), a
    seeded compacted order."""
    import torch
    from ascii_renderer_tpu_torch.backends import pathtrace as PT
    from ascii_renderer_tpu_torch.tools.xla_inputs import (pixel_order,
                                                           pt_outputs)
    row_lo, n_rows = band if band else (0, rows)
    pc = n_rows * cols
    kw = dict(row_lo=row_lo, n_rows=n_rows, device=dev)
    if compacted:
        order = pixel_order(n_rows, cols, 0.3, seed=b)[1] + row_lo * cols
        kw["pix_uid"] = torch.from_numpy(order).to(dev)
    if B:
        kw.update(fet0=torch.from_numpy(pt_outputs(
            -(-pc // 1024) * 1024, seed=rows + b)[4]).to(dev), samples=B,
            s0=b * B, seed=PT.batch_seed_of(7, b))
    return (basis, rows, cols, PIXEL_ASPECT), kw, max(B, 1) * pc, pc


def _x7_bound(kw, n, pc):
    """X7's least time: 12 bytes out a ray; in a pixel, the fetch flag (4)
    where the call jitters and the uid (4) where it is compacted; ~40
    operations a ray (the hash, the jitter, the direction)."""
    n_bytes = 12 * n + 4 * pc * ((kw.get("fet0") is not None)
                                 + (kw.get("pix_uid") is not None))
    return _bound(n_bytes, 40 * n), n_bytes


def check_pt_rays(dev):
    """X7 (ops/ray_grid.pt_rays, the render paths' sample rays) against
    its plain chain (pt_rays_ref) on the same CUDA tensors at
    PT_RAY_CALLS, at the poster pose and a pose off the axes: bit for bit,
    pad rays 0; the launch's own split of the samples among threads (a
    sample a thread at 96x36 and the probes, every sample of a slot at the
    HD arm's batch). Timed at the HD arm's batch and the reference batch
    (the record: the HD arm's)."""
    import torch
    from ascii_renderer_tpu_torch.core.camera import Camera, camera_basis
    from ascii_renderer_tpu_torch.ops import ray_grid as RYG
    rec = None
    for cam in (_pt_camera(), Camera.create(pos=(0.3, 1.2, 4.0), yaw=-1.234,
                                            pitch=0.321)):
        basis = camera_basis(cam.yaw, cam.pitch, cam.fov_y)
        for label, call in PT_RAY_CALLS.items():
            args, kw, n, pc = _pt_rays_call(dev, basis, *call)
            want = RYG.pt_rays_ref(*args, **kw)
            got = RYG.pt_rays(*args, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), f"X7 {label} differs"
            assert not got.reshape(-1, 3)[n:].any(), f"X7 {label}: pad rays"
        if rec is not None:
            continue
        times = {}
        for label in ("HD arm batch", "reference batch 0"):
            args, kw, n, pc = _pt_rays_call(dev, basis,
                                            *PT_RAY_CALLS[label])
            per = RYG.samples_per_thread(pc, kw["samples"])
            ms = _device_ms(lambda: RYG.pt_rays(*args, **kw),
                            "pt_rays_kernel", 1)
            plain = _event_ms(lambda: RYG.pt_rays_ref(*args, **kw), 5)
            bound, n_bytes = _x7_bound(kw, n, pc)
            times[label] = (ms, plain, bound)
            print(f"X7 {label} ({n} rays, {per} samples a thread): kernel "
                  f"{ms:.5f} ms; plain {plain:.3f} ms, bound {bound[0]:.5f} "
                  f"ms ({bound[1]}, {n_bytes / 1e6:.2f} MB)", flush=True)
        ms, plain, bound = times["HD arm batch"]
        rec = _rec("pt_rays", "ray_grid.cu", "", 0.0, ms, plain, bound)
        rec["replaces"] = "ascii_renderer_tpu/backends/pathtrace.py:579"
        rec["ms_reference_batch"], rec["plain_ms_reference_batch"], \
            (rec["bound_ms_reference_batch"], _b) = times["reference batch 0"]
    print(f"X7: bit-identical to the plain chain at {len(PT_RAY_CALLS)} "
          f"calls (batches 0 and 1, probes, 96x36 and 960x540, fetched / "
          f"unfetched / NaN, compacted, a band), two poses", flush=True)
    return rec


# X14's folds held to the plain version: (pixels, samples a batch, spp,
# compacted): the reference run's two batches of 32, a last batch past spp
# (spp 40 at 32), the HD arm's one batch of 8, a compacted order; batches
# of 8 on each side of the size where the kernel changes form (32,400
# slots in the tile form, 129,600 in the slot form)
PT_FOLD_CALLS = {"reference 2 x 32": (3456, 32, 64, False),
                 "spp 40 at 32": (3456, 32, 40, False),
                 "HD arm 1 x 8": (518400, 8, 8, False),
                 "compacted 3 x 4": (3456, 4, 10, True),
                 "240x135 2 x 8": (32400, 8, 16, False),
                 "480x270 2 x 8": (129600, 8, 16, False)}


def _fold_pair(label, probe, batches, B, spp, slot, pc):
    """Folds ``batches`` (the megakernel's outputs a batch) with X14 and
    with its plain version into two states; each state bit for bit after
    each batch (NaN in the same places), then the resolve's rgb and
    alpha. Returns the number of overridden pixels."""
    import torch
    from ascii_renderer_tpu_torch.ops import pt_reduce as PR
    states = [PR.new_state(pc, probe[0].device) for _ in range(2)]
    for b, outs in enumerate(batches):
        last = b == len(batches) - 1
        kw = dict(first=b == 0, probe=probe[:4] if last else None, spp=spp,
                  slot=slot)
        n_valid = min(B, spp - b * B)
        got = PR.fold(states[0], *outs[:4], n_valid, **kw)
        want = PR.fold_ref(states[1], *outs[:4], n_valid, **kw)
        torch.cuda.synchronize()
        if not last:
            for g, w in zip(*states):
                _same_nan_bits(g.view(torch.float32), w.view(torch.float32),
                               f"X14 {label} batch {b} state")
    _same_nan_bits(got[0], want[0], f"X14 {label} rgb")
    assert torch.equal(got[1], want[1]), f"X14 {label}: alpha differs"
    return int((got[1] != 255).sum())


def _same_nan_bits(got, want, what):
    import torch
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), f"{what}: NaN differs"
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32)), f"{what} differs"


def _frame_outputs(dev, rows, cols, cfg):
    """The megakernel's outputs of one render_pt frame of the demo scene
    at the poster pose (probe, then each batch), captured from its calls."""
    from ascii_renderer_tpu_torch.backends.registry import Renderer
    from ascii_renderer_tpu_torch.ops import pt_kernel as PTK
    orig, seen = PTK.trace_frame, []

    def rec(*a, **k):
        out = orig(*a, **k)
        seen.append([o.clone() for o in out])
        return out

    r = Renderer(cfg, "pathtrace", device=dev)
    r.set_scene(_pt_scene(device=dev))
    PTK.trace_frame = rec
    try:
        r.render(0.0, _pt_camera(), rows, cols)
    finally:
        PTK.trace_frame = orig
    return seen[0], seen[1:]


def check_pt_reduce(dev):
    """X14 (ops/pt_reduce.fold) against its plain version on the same
    CUDA tensors: at PT_FOLD_CALLS on seeded megakernel outputs
    (overrides in several samples, NaN radiance, ties of rint), and on the
    real outputs of a PT reference frame (96x36, spp 64: the probe and two
    batches of 32): every state and the resolve bit for bit, in the form
    the size gives (a block a tile of slots below 32,768 slots, a thread a
    slot from there). Timed at the launches the driven paths make
    (_fold_timing_calls; the record: the HD arm's), bound by
    _x14_bound."""
    import torch
    from ascii_renderer_tpu_torch.core.config import Config
    from ascii_renderer_tpu_torch.ops import pt_reduce as PR
    from ascii_renderer_tpu_torch.tools.xla_inputs import (pixel_order,
                                                           pt_outputs)

    def outs(n, seed):
        return [torch.from_numpy(x).to(dev)
                for x in pt_outputs(-(-n // 1024) * 1024, seed=seed,
                                    p_override=0.003)]

    for label, (pc, B, spp, compacted) in PT_FOLD_CALLS.items():
        slot = None
        if compacted:
            slot = torch.from_numpy(pixel_order(36, 96, 0.3, seed=4)[1]).to(
                dev)
        probe = outs(pc, 0)
        batches = [outs(B * pc, 1 + b) for b in range(-(-spp // B))]
        n_ov = _fold_pair(label, probe, batches, B, spp, slot, pc)
        print(f"X14 {label} ({pc} pixels, {PR.form_of(pc)} form): "
              f"bit-identical, {n_ov} overridden pixels", flush=True)
    probe, batches = _frame_outputs(dev, 36, 96, Config())
    n_ov = _fold_pair("PT reference frame", probe, batches, 32, 64, None,
                      3456)
    print(f"X14 on a PT reference frame's megakernel outputs: bit-identical, "
          f"{n_ov} overridden pixels", flush=True)
    # timing: the launches the driven paths make (the reference run, the
    # frame step and the progressive run fold two batches of 32; the HD arm
    # folds and resolves its one batch of 8)
    times = {}
    for label, (fold, real) in _fold_timing_calls(dev).items():
        a, k = fold
        ms = _device_ms(lambda: PR.fold(*a, **k), "pt_reduce_kernel", 1)
        plain = _event_ms(lambda: PR.fold_ref(*a, **k), 3)
        bound, n_bytes = _x14_bound(a, k)
        times[label] = (ms, plain, bound)
        print(f"X14 {label} ({real} rays, {PR.form_of(a[0][1].shape[0])} "
              f"form): kernel {ms:.5f} ms; plain {plain:.3f} ms, bound "
              f"{bound[0]:.5f} ms ({bound[1]}, {n_bytes / 1e6:.2f} MB)",
              flush=True)
    ms, plain, bound = times["HD arm batch with the resolve"]
    rec = _rec("pt_reduce", "pt_reduce.cu", "", 0.0, ms, plain, bound)
    rec["replaces"] = "ascii_renderer_tpu/backends/pathtrace.py:611"
    for i, label in enumerate(("reference batch 0",
                               "reference batch 1 with the resolve")):
        rec[f"ms_reference_batch{i}"], \
            rec[f"plain_ms_reference_batch{i}"], \
            (rec[f"bound_ms_reference_batch{i}"], _b) = times[label]
    return rec


# float operations a pixel of K1b (csrc/accum.cu; a fused product-add
# counted as two, a root or division as one): the active test twice (the
# pre-update mask and the skip mask, ~22 each) and the Welford update
# with the perceptual luminance (~30)
ACCUM_OPS = 74
# K1b's shapes on the driven paths: the progressive tracer's 96x36 and its
# HD batch's 960x540
ACCUM_SHAPES = ((36, 96), (ROWS, COLS))
# kernel launches accum.step may make a batch (46 before K1b)
ACCUM_STEP_LAUNCHES = 2


def _accum_bytes(shape, reset, with_alpha):
    """K1b's least traffic a call: the old state read (37 bytes a pixel:
    count, mean, m2, mean_y, m2_y, alpha) unless reset, the sample's 12
    and its alpha byte, the new state (37), the display (12) and the two
    masks written."""
    n = math.prod(shape)
    return n * ((0 if reset else 37) + 12 + with_alpha + 37 + 12 + 2)


def check_accum(dev):
    """K1b, the progressive tracer's statistics step (ops/accum, one
    launch of csrc/accum.cu a batch), against its plain version
    (accumulate_ref, the torch chain, on CPU copies): seeded planes at the
    progressive shapes ACCUM_SHAPES (counts 0 to max_samples, many at
    max_samples - 1; 2% NaN, infinities, signed zeros, subnormals,
    negative values), in both statistics modes, with and without a reset
    and a sample alpha plane, with the any-active flags: the new state,
    the display, both masks and the flags bit for bit (NaN in the same
    places). Then at the progressive tracer's own second batch at each
    shape (96x36 at the config's spp 64, 960x540 at spp 8; its state,
    samples and flags captured from the step) bit for bit, timed there,
    the plain chain on the same CUDA tensors beside it (its four fma32 are
    K1 launches), and on the edge planes. Returns the record (the HD
    batch's times)."""
    import torch
    from ascii_renderer_tpu_torch.core.config import Config, PathTracerConfig
    from ascii_renderer_tpu_torch.ops import accum as OA
    from ascii_renderer_tpu_torch.tools.xla_inputs import accum_case
    kw = dict(max_tolerance=0.1, max_samples=64)
    n_cases, times = 0, {}
    for shape in ACCUM_SHAPES:
        c = {k: torch.from_numpy(v).to(dev)
             for k, v in accum_case(shape, len(shape) + shape[0],
                                    kw["max_samples"]).items()}
        state = tuple(c[f] for f in OA.FIELDS)
        for mode in ("rgb", "perceptual"):
            for reset in (False, True):
                for sa in (None, c["sample_alpha"]):
                    flags = torch.tensor([3, 5], dtype=torch.int32,
                                         device=dev)
                    got = OA.accumulate(state, c["sample"], sa, reset=reset,
                                        stats_mode=mode, flags=flags,
                                        slot=1, **kw)
                    fl = flags.cpu()
                    want_fl = torch.tensor([3, 5], dtype=torch.int32)
                    want = OA.accumulate_ref(
                        tuple(t.cpu() for t in state), c["sample"].cpu(),
                        None if sa is None else sa.cpu(), reset=reset,
                        stats_mode=mode, flags=want_fl, slot=1, **kw)
                    what = f"K1b {shape} {mode} reset {reset} alpha " \
                        f"{sa is not None}"
                    for g, w, f in zip(got[0], want[0], OA.FIELDS):
                        _same_nan_bits(g.cpu(), w, f"{what}: {f}")
                    _same_nan_bits(got[1].cpu(), want[1], f"{what}: display")
                    for g, w, f in zip(got[2:], want[2:], ("act", "skip")):
                        assert torch.equal(g.cpu(), w), f"{what}: {f}"
                    assert torch.equal(fl, want_fl) and fl[0] == 0, what
                    n_cases += 1
        edge_ms = _device_ms(lambda: OA.accumulate(
            state, c["sample"], c["sample_alpha"], reset=False, **kw),
            "accum_kernel", 1)
        # the tracer's own second batch: its call captured from the step
        cfg = Config(path_tracer=PathTracerConfig(
            samples_per_batch=64 if shape[0] < ROWS else 8))
        tr = _progressive_tracer(dev, cfg, *shape, True)
        a, k = _capture_all(OA, "accumulate", lambda: [
            tr.step(_pt_camera()) for _ in range(2)])[-1]
        assert not k["reset"], k
        k = {**k, "flags": torch.zeros(2, dtype=torch.int32, device=dev)}
        got = OA.accumulate(*a, **k)
        want = OA.accumulate_ref(*(
            tuple(t.cpu() for t in x) if isinstance(x, tuple) else
            (x.cpu() if x is not None else None) for x in a),
            **{**k, "flags": torch.zeros(2, dtype=torch.int32)})
        for g, w in zip((*got[0], *got[1:]), (*want[0], *want[1:])):
            assert torch.equal(g.cpu().view(torch.uint8),
                               w.view(torch.uint8)), f"K1b tracer {shape}"
        ms = _device_ms(lambda: OA.accumulate(*a, **k), "accum_kernel", 1)
        plain = _event_ms(lambda: OA.accumulate_ref(*a, **{
            **k, "flags": None}), 10)
        bound = _bound(_accum_bytes(shape, False, True),
                       ACCUM_OPS * math.prod(shape))
        times[shape] = (ms, plain, bound)
        print(f"K1b accumulate at {list(shape)}, the tracer's second "
              f"batch ({int(got[2].sum())} active pixels): bit-identical, "
              f"kernel {ms:.5f} ms, plain chain on the card {plain:.3f} ms, "
              f"bound {bound[0]:.5f} ms ({bound[1]}); on the edge planes "
              f"{edge_ms:.5f} ms", flush=True)
    print(f"K1b accumulate: bit-identical to its plain version in {n_cases} "
          f"cases (shapes {list(ACCUM_SHAPES)}, both statistics modes, reset "
          f"or not, a sample alpha or not; edge planes)", flush=True)
    ms, plain, bound = times[ACCUM_SHAPES[-1]]
    rec = _rec("accum", "accum.cu", "", 0.0, ms, plain, bound)
    rec["replaces"] = _jax_def_line(os.path.join(
        ROOT, "ascii_renderer_tpu_torch", "sim", "accum.py"), "accumulate")
    small = times[ACCUM_SHAPES[0]]
    rec.update(shape=list(ACCUM_SHAPES[-1]), ms_small=small[0],
               plain_ms_small=small[1], bound_ms_small=small[2][0])
    return rec


def _fold_timing_calls(dev):
    """{label: ((args, keywords) of an X14 fold, its rays)} at the launches
    the driven paths make: the reference run's batch 0 (the first fold)
    and batch 1 (the fold with the resolve), the HD arm's one batch (the
    first fold with the resolve); seeded outputs and state."""
    import torch
    from ascii_renderer_tpu_torch.ops import pt_reduce as PR
    from ascii_renderer_tpu_torch.tools.xla_inputs import pt_outputs

    def outs(n, seed):
        return [torch.from_numpy(x).to(dev)
                for x in pt_outputs(-(-n // 1024) * 1024, seed=seed,
                                    p_override=0.003)]

    calls = {}
    for label, pc, B, first, resolve in (
            ("reference batch 0", 3456, 32, True, False),
            ("reference batch 1 with the resolve", 3456, 32, False, True),
            ("HD arm batch with the resolve", 518400, 8, True, True)):
        state = PR.new_state(pc, dev)
        state[0].zero_()
        state[1].zero_()
        o = outs(B * pc, 5)
        probe = outs(pc, 6)
        kw = dict(first=first, probe=probe[:4] if resolve else None,
                  spp=B if first else 2 * B)
        calls[label] = ((state, *o[:4], B), kw), B * pc
    return calls


def _x14_bound(a, k):
    """X14's least time at a fold's arguments: 16 bytes read a ray of its
    valid samples; a pixel's state, 28 bytes read unless the fold is the
    first and written unless it resolves; the resolve's 16 in (the
    probe's), 13 out and the slot (4) under compaction; 4 operations a
    ray and 12 a pixel."""
    pc, n_valid = a[0][1].shape[0], a[5]
    resolve = k.get("probe") is not None
    n_bytes = 16 * n_valid * pc + (0 if k["first"] else 28) * pc + (
        (16 + 13 + 4 * (k.get("slot") is not None)) if resolve else 28) * pc
    return _bound(n_bytes, 4 * n_valid * pc + 12 * pc), n_bytes


# --------------------------------------------------------------------------
# The ray tracer (Renderer "rt", the "raytrace" step), its 1,024-view farm
# and the progressive path tracer (sim/accum)
# --------------------------------------------------------------------------
FARM_VIEWS, FARM_GRID = 1024, (36, 96)
GOLDEN_RT = os.path.join(ROOT, "tests", "goldens", "rt_demo.txt")
# views of the farm checked against the port's CPU render
FARM_CHECKED = tuple(range(0, FARM_VIEWS, FARM_VIEWS // 8))


def _orbit(n=FARM_VIEWS):
    from ascii_renderer_tpu_torch.parallel.mesh import orbit_cameras
    return orbit_cameras(n, center=(0, 1.0, 1.0), radius=6.0)


def check_modal_batched(dev):
    """B4 over a batch of 1,024 glyph planes [1024, 36, 96] in one launch,
    radius 1..3, random indices and override masks: equal to the plain
    version on the batch and to 1,024 one-plane launches. Timed at the
    farm's radius 2 / thresh 12 with the K the wrapper picks, and at K = 1
    and K = 4 beside it. Returns the record."""
    import torch
    from ascii_renderer_tpu_torch.ops import ascii_kernel as AK
    g = torch.Generator().manual_seed(4)
    V, (h, w) = FARM_VIEWS, FARM_GRID
    for radius, thresh in ((1, 5), (2, 12), (3, 24)):
        idx = torch.randint(0, 10, (V, h, w), generator=g,
                            dtype=torch.int32).to(dev)
        ovr = (torch.rand((V, h, w), generator=g) < 0.1).to(dev)
        got = AK.modal_filter_kernel(idx, ovr, radius, thresh)
        ref = AK.modal_filter(idx, ovr, radius, thresh)
        one = torch.stack([AK.modal_filter_kernel(idx[v], ovr[v], radius,
                                                  thresh) for v in range(V)])
        torch.cuda.synchronize()
        assert torch.equal(got, ref), f"batched B4 differs, radius {radius}"
        assert torch.equal(got, one), \
            f"batched B4 differs from one-plane launches, radius {radius}"
    k = AK.cells_per_thread(h, w, V)
    bound = _bound(V * h * w * (4 + 1 + 4), _b4_ops(idx, ovr, 2), PEAK_INT32)
    ms = _device_ms(lambda: AK.modal_filter_kernel(idx, ovr, 2, 12),
                    "modal_kernel", 1)
    by_k = {c: _device_ms(lambda: AK.modal_filter_kernel(idx, ovr, 2, 12,
                                                         cells=c),
                          "modal_kernel", 1) for c in (1, AK.CELLS)}
    plain = _event_ms(lambda: AK.modal_filter(idx, ovr, 2, 12), 5)
    print(f"B4 batched [{V}, {h}, {w}]: exact against the plain version and "
          f"{V} one-plane launches, radius 1-3; K = {k} chosen; "
          f"r2 {ms:.5f} ms (K=1 {by_k[1]:.5f}, K={AK.CELLS} "
          f"{by_k[AK.CELLS]:.5f}), plain {plain:.3f} ms, bound "
          f"{bound[0]:.5f} ms ({bound[1]})", flush=True)
    rec = _rec("modal_vote_views", "modal.cu", "ascii_kernel.py:41", 0.0,
               ms, plain, bound)
    rec.update(ops_rate=PEAK_INT32, shape=[V, h, w], cells=k,
               ms_k1=by_k[1], ms_k4=by_k[AK.CELLS])
    return rec


# --------------------------------------------------------------------------
# The glyph tail: X12a (Frame.from_float) and B4's chars form
# --------------------------------------------------------------------------
# float rgb to chars on every driven glyph path: X12a, then B4's chars form
GLYPH_LAUNCHES = 2
# FP32 operations of quantize_index a cell in B4's chars form: two
# divisions, the upper clamp, the product, the sum, the floor, the clamp
# to [0, n] (two) and the conversion
QUANT_OPS = 9
# X12a's FP32 operations a channel: two compares, the product, the sum, the
# floor and the conversion
X12A_OPS = 6


def _glyph_bound(n_bytes, int_ops, fp_ops):
    """The larger of the bytes' time and the operations' (integer ones at
    the INT32 rate plus FP32 ones at the FP32 rate)."""
    t_b = n_bytes / PEAK_BYTES * 1e3
    t_o = (int_ops / PEAK_INT32 + fp_ops / PEAK_FP32) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _x12a_bound(rgb, a, ui):
    cells = rgb.numel() // 3
    n_in = _nbytes(rgb) + (cells if a is not None else 0) + (
        2 * cells if ui is not None else 0)
    return _glyph_bound(n_in + 4 * cells, 0, X12A_OPS * 3 * cells)


def _chars_bound(rgb_u8, a_u8, radius, mode_on):
    """B4's chars form on these bytes: 4 bytes in and 1 out a cell,
    quantize_index's FP32 operations, and the vote's integer operations as
    the planes need them (_b4_ops)."""
    from ascii_renderer_tpu_torch.core import quantize as Q
    cells = a_u8.numel()
    int_ops = 0
    if mode_on:
        int_ops = _b4_ops(Q.quantize_index(rgb_u8, 10), Q.is_override(a_u8),
                          radius)
    return _glyph_bound(5 * cells, int_ops, QUANT_OPS * cells)


def _glyph_cases(dev, soup, scene):
    """X12a's inputs (rgb float, a, ui_chars, ui_mask) by label: seeded
    float planes (tools/xla_inputs.glyph_frame: outside [0, 1], at k / 255
    and (k + 0.5) / 255 and a float32 either side, the alpha protocol's
    edges, a UI plane) at 540x960, 36x96 and the farm's [1024, 36, 96];
    the headline's frame 0 (RasterBackend.render at the golden camera) and
    the entry() step's frame with its UI plane, both captured from their
    calls."""
    import torch
    from ascii_renderer_tpu_torch.backends.raster import RasterBackend
    from ascii_renderer_tpu_torch.core.config import Config
    from ascii_renderer_tpu_torch.entry import entry
    from ascii_renderer_tpu_torch.ops import frame_bytes as FB
    from ascii_renderer_tpu_torch.tools.xla_inputs import glyph_frame
    cases = {}
    for seed, shape in enumerate(((ROWS, COLS), FARM_GRID,
                                  (FARM_VIEWS,) + FARM_GRID)):
        rgb, a, c, m = (torch.from_numpy(x).to(dev)
                        for x in glyph_frame(shape, seed))
        label = "x".join(map(str, shape))
        cases[f"random {label}"] = (rgb, None, None, None)
        cases[f"random {label}, alpha + UI"] = (rgb, a, c, m)
    backend = RasterBackend(Config(pixel_aspect=PIXEL_ASPECT), device=dev)
    backend.set_soup(*soup, scene)
    a, k = _capture(FB, "frame_bytes", lambda: backend.render(
        0.0, _golden_camera(), ROWS, COLS, PIXEL_ASPECT))
    cases["headline frame 0"] = (a + (None,) * 4)[:4]
    fn, args = entry()
    a, k = _capture(FB, "frame_bytes", lambda: fn(*args))
    chars, mask = k["ui"].planes(dev)  # the UI form's layer as a plane
    assert bool(mask.any()), "entry(): no UI plane"
    cases["entry() step, UI plane"] = (a[0], a[1], chars, mask)
    return cases


def check_glyph_tail(dev, soup, scene):
    """X12a (Frame.from_float in one launch) and B4's chars form (bytes to
    chars in one launch; glyph_map_kernel without the vote) against their
    plain versions on the same CUDA inputs, bit for bit: every case of
    _glyph_cases; the chars form from the rgb bytes and from the index
    plane, the mode filter at radius 1-3 and off, the default ramp, one of
    one code and one of 100 codes.
    Timed: X12a and the chars form at the headline's frame 0 (the
    records), at 36x96 and the farm's batch; glyph_map at 540x960. Returns
    the three records."""
    import torch
    from ascii_renderer_tpu_torch.core import quantize as Q
    from ascii_renderer_tpu_torch.ops import ascii_kernel as AK
    from ascii_renderer_tpu_torch.ops import frame_bytes as FB
    from ascii_renderer_tpu_torch.tools.xla_inputs import GLYPH_RAMPS
    cases = _glyph_cases(dev, soup, scene)
    small, farm, hd = (f"random {'x'.join(map(str, g))}" for g in (
        FARM_GRID, (FARM_VIEWS,) + FARM_GRID, (ROWS, COLS)))
    frames = {}
    for label, (rgb, a, c, m) in cases.items():
        got = FB.frame_bytes(rgb, a, c, m)
        want = FB.frame_bytes_ref(rgb, a, c, m)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("rgb", "alpha")):
            assert torch.equal(g, w), f"X12a {what} differs: {label}"
        frames[label] = got
    n_checked = 0
    for label, (rgb8, a8) in frames.items():
        for ramp in GLYPH_RAMPS:
            for radius in (0, 1, 2, 3):  # 0: the mode filter off
                kw = dict(mode_on=radius > 0, radius=max(radius, 1),
                          thresh={1: 5, 2: 12, 3: 24}[max(radius, 1)])
                idx = Q.quantize_index(rgb8, len(ramp))
                for src in (rgb8, idx):
                    got = AK.glyph_chars(src, a8, ramp, **kw)
                    want = AK.glyph_chars_ref(src, a8, ramp, **kw)
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), \
                        f"B4 chars form differs: {label}, ramp of " \
                        f"{len(ramp)}, radius {radius}, {src.dtype}"
                    n_checked += 1
    print(f"glyph tail: X12a bit for bit on {len(cases)} inputs "
          f"({', '.join(cases)}); B4's chars form (and glyph_map) bit for "
          f"bit in {n_checked} calls (rgb bytes and index planes, radius "
          f"1-3 and off, ramps of {[len(r) for r in GLYPH_RAMPS]} codes)",
          flush=True)
    recs = []
    rgb = cases["headline frame 0"][0]
    rgb8, a8 = frames["headline frame 0"]
    ms = _device_ms(lambda: FB.frame_bytes(rgb), "frame_bytes_kernel", 1)
    plain = _event_ms(lambda: FB.frame_bytes_ref(rgb), 20)
    bound = _x12a_bound(rgb, None, None)
    rec = _rec("frame_bytes", "frame_bytes.cu", "", 0.0, ms, plain, bound)
    rec["replaces"] = "ascii_renderer_tpu/core/frame.py:44"
    for key, label in (("ms_36x96_ui", f"{small}, alpha + UI"),
                       ("ms_farm", farm)):
        args = cases[label]
        rec[key] = _device_ms(lambda: FB.frame_bytes(*args),
                              "frame_bytes_kernel", 1)
        rec[key.replace("ms", "bound_ms", 1)] = _x12a_bound(
            args[0], args[1], args[2])[0]
    recs.append(rec)
    kw = dict(mode_on=True, radius=2, thresh=12)
    ramp = GLYPH_RAMPS[1]
    ms = _device_ms(lambda: AK.glyph_chars(rgb8, a8, ramp, **kw),
                    "modal_kernel", 1)
    plain = _event_ms(lambda: AK.glyph_chars_ref(rgb8, a8, ramp, **kw), 20)
    bound = _chars_bound(rgb8, a8, 2, True)
    rec = _rec("modal_vote_chars", "modal.cu", "ascii_kernel.py:41", 0.0, ms,
               plain, bound)
    idx8 = Q.quantize_index(rgb8, len(ramp))
    rec.update(ops_rate=PEAK_INT32, shape=list(a8.shape),
               ms_from_index=_device_ms(
                   lambda: AK.glyph_chars(idx8, a8, ramp, **kw),
                   "modal_kernel", 1))
    for key, label in (("ms_36x96", f"{small}, alpha + UI"),
                       ("ms_farm", f"{farm}, alpha + UI")):
        r8, a = frames[label]
        rec[key] = _device_ms(lambda: AK.glyph_chars(r8, a, ramp, **kw),
                              "modal_kernel", 1)
        rec[key.replace("ms", "bound_ms", 1)] = _chars_bound(r8, a, 2,
                                                             True)[0]
    recs.append(rec)
    r8, a = frames[f"{hd}, alpha + UI"]
    kw0 = dict(mode_on=False, radius=1, thresh=5)
    ms = _device_ms(lambda: AK.glyph_chars(r8, a, ramp, **kw0),
                    "glyph_map_kernel", 1)
    plain = _event_ms(lambda: AK.glyph_chars_ref(r8, a, ramp, **kw0), 20)
    rec = _rec("glyph_map", "modal.cu", "", 0.0, ms, plain,
               _chars_bound(r8, a, 1, False))
    rec["replaces"] = "ascii_renderer_tpu/ascii/ascii_pass.py:69"
    recs.append(rec)
    for r in recs:
        extra = {k: v for k, v in r.items() if k.startswith(("ms_", "bound"))}
        print(f"{r['name']}: {r['ms']:.5f} ms, plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}); "
              f"{json.dumps(extra)}", flush=True)
    return recs


# X12a's UI form, integer operations a (cell, live ripple) pair: outside
# the ripple's box (two subtractions, two magnitude tests), inside it (the
# ring's prefilter: the squares, their sum and two compares more), and a
# step of a ring cell's replayed march (its tests, the err update, x, y)
UI_PAIR_OPS, UI_BOX_OPS, UI_STEP_OPS = 4, 12, 8


def _ui_ops(ui):
    """The integer operations X12a's UI form does on these values (no
    plane read): every (cell, live ripple) pair's test, and each ring
    cell's replayed march to its step (the first state with y >= b and x
    <= a, as sim/ui.ripple_cells replays it), counted from the march of
    each ripple's radius on the host; plus the border and FPS tests, 4 a
    cell."""
    import numpy as np
    rows, cols = ui.rows, ui.cols
    ops = 4 * rows * cols
    for cx, cy, r in ui.circles:
        ops += UI_PAIR_OPS * rows * cols
        ys, xs = np.mgrid[max(0, cy - r):min(rows, cy + r + 1),
                          max(0, cx - r):min(cols, cx + r + 1)]
        if ys.size == 0:
            continue
        ops += (UI_BOX_OPS - UI_PAIR_OPS) * ys.size
        ax, ay = np.abs(xs - cx), np.abs(ys - cy)
        a, b = np.maximum(ax, ay), np.minimum(ax, ay)
        d = a * a + b * b
        ring = (d <= r * r) & (d >= r * r - 3 * r - 1)
        states = []  # the march's (x, y) while active, 128 steps at most
        x, y, err = r, 0, 0
        while x >= y and len(states) < 128:
            states.append((x, y))
            if err <= 0:
                y += 1
                err += 2 * y + 1
            if err > 0:
                x -= 1
                err -= 2 * x + 1
        sx = np.array([s[0] for s in states])
        sy = np.array([s[1] for s in states])
        first = np.maximum(np.searchsorted(sy, b[ring], "left"),
                           np.searchsorted(-sx, -a[ring], "left"))
        ops += UI_STEP_OPS * int((np.minimum(first, len(states)) + 1).sum())
    return ops


def _ui_bound(rgb, a, ui):
    """X12a's UI form: X12a's bytes without a plane, its FP32 operations,
    and the UI layer's integer operations (_ui_ops)."""
    cells = rgb.numel() // 3
    n_in = _nbytes(rgb) + (cells if a is not None else 0)
    return _glyph_bound(n_in + 4 * cells, _ui_ops(ui), X12A_OPS * 3 * cells)


def _ui_case(dev, shape, n_live, seed, radius=None, fps=60.0):
    """(rgb, a, ui) of a seeded frame and UI layer: n_live ripples over and
    around the grid (each of radius ``radius`` where given), the clock at
    1,500 ms."""
    import numpy as np
    import torch
    from ascii_renderer_tpu_torch.core.config import Config
    from ascii_renderer_tpu_torch.sim import ui as U
    from ascii_renderer_tpu_torch.tools.xla_inputs import glyph_frame
    rows, cols = shape
    rgb, a, _c, _m = (torch.from_numpy(x).to(dev)
                      for x in glyph_frame(shape, seed))
    rng = np.random.default_rng(seed)
    rip = np.stack([rng.uniform(-20, cols + 20, 16),
                    rng.uniform(-20, rows + 20, 16),
                    rng.uniform(0, 1500, 16)], -1).astype(np.float32)
    if radius is not None:
        rip[:, 2] = 1500.0 - radius / Config().ripple_speed
    return rgb, a, U.ui_params(Config(), rows, cols, fps, rip, n_live, 1500.0)


def check_ui_form(dev):
    """X12a's UI form (the frame step's UI layer by value, drawn in the
    frame's byte launch) against its plain version (the planes drawn on
    the host, then burnt in) bit for bit: seeded frames at 1x1, 36x96 and
    540x960 with 0, 1 and 16 live ripples and FPS values 0, 7, 1e7, NaN
    and half-way ones; entry()'s step with 16 live ripples; the CLI's
    raster frame (its first call). Its ripple cells against the reference
    march itself for every radius 0-200 (``_ripple_sweep``). Timed at
    36x96 with no live ripple and with 16 of radius 100, and at 540x960
    with 16 of radius 100. Returns its numbers, for X12a's record."""
    import numpy as np
    import torch
    from ascii_renderer_tpu_torch.entry import entry
    from ascii_renderer_tpu_torch.ops import frame_bytes as FB
    cases = {}
    for shape in ((1, 1), ENTRY_GRID, (ROWS, COLS)):
        for n_live in (0, 1, 16):
            for k, fps in enumerate((0.0, 7.0, 1e7, float("nan"), 2.5)):
                rgb, a, ui = _ui_case(dev, shape, n_live, 7 * n_live + k,
                                      fps=fps)
                label = (f"{shape[0]}x{shape[1]}, {len(ui.circles)} live, "
                         f"fps {fps}")
                cases[label] = ((rgb, a if k % 2 else None), {"ui": ui})
    fn, args = entry()
    rip = np.zeros((16, 3), np.float32)
    rip[:, 0] = np.linspace(-10, 110, 16)
    rip[:, 1] = np.linspace(-5, 40, 16)
    rip[:, 2] = -np.linspace(0.0, 1900.0, 16)  # radii 0 to 95 at t = 0
    state = args[1].replace(ripples=torch.from_numpy(rip),
                            n_ripples=torch.tensor(16, dtype=torch.int32))
    cases["entry() step, 16 ripples"] = _capture(
        FB, "frame_bytes", lambda: fn(args[0], state, *args[2:]))
    cases["CLI raster frame"] = _capture(FB, "frame_bytes", lambda: _cli(
        ["--backend", "raster", *CLI_GRID, "--frames", "2"]))
    for label, (a, k) in cases.items():
        assert k.get("ui") is not None, label
        n0 = FB.launches_ui
        got = FB.frame_bytes(*a, **k)
        assert FB.launches_ui == n0 + 1, label
        want = FB.frame_bytes_ref(*(None if t is None else t.cpu()
                                    for t in a), **k)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("rgb", "alpha")):
            assert torch.equal(g.cpu(), w), f"X12a UI form {what}: {label}"
    n_star = int((cases["entry() step, 16 ripples"][1]["ui"].planes_np()[0]
                  == ord("*")).sum())
    assert n_star > 0, "entry(): no ripple cell drawn"
    out = {"checked_calls": len(cases), "entry_ripple_cells": n_star,
           "ripple_radii_checked": _ripple_sweep(dev)}
    for key, shape, n_live, radius in (("36x96", ENTRY_GRID, 0, None),
                                       ("36x96_16_r100", ENTRY_GRID, 16,
                                        100.0),
                                       ("540x960_16_r100", (ROWS, COLS), 16,
                                        100.0)):
        rgb, a, ui = _ui_case(dev, shape, n_live, 3, radius=radius)
        out[f"ms_{key}"] = _device_ms(lambda: FB.frame_bytes(rgb, a, ui=ui),
                                      "frame_bytes_kernel", 1)
        bound = _ui_bound(rgb, a, ui)
        out[f"bound_ms_{key}"], out[f"bound_by_{key}"] = bound
        out[f"plain_ms_{key}"] = _event_ms(
            lambda: FB.frame_bytes_ref(rgb, a, ui=ui), 20)
    print(f"X12a UI form: bit for bit in {len(cases)} calls ({n_star} ripple "
          f"cells in entry()'s frame); {json.dumps(out)}", flush=True)
    return out


def _ripple_sweep(dev, radii=range(201)):
    """X12a's UI form's ripple cells against the reference march for each
    radius: one ripple at the centre of a grid that holds its box, its '*'
    cells exactly the march's (``tools/xla_inputs.ripple_case``; from
    radius 128 on the kernel replays the march). Returns the number of
    radii checked."""
    import numpy as np
    import torch
    from ascii_renderer_tpu_torch.ops import frame_bytes as FB
    from ascii_renderer_tpu_torch.tools.xla_inputs import ripple_case
    for r in radii:
        ui, want = ripple_case(r)
        _rgb8, a = FB.frame_bytes(torch.zeros((ui.rows, ui.cols, 3),
                                              device=dev), ui=ui)
        got = (a == ord("*")).cpu().numpy()
        assert np.array_equal(got, want), \
            f"X12a UI form: the ripple of radius {r} is not the march's"
    return len(radii)


def _tail_counts(counters, fn):
    """The glyph tail's launches in one call of fn: X12a's, B4's chars
    form's and glyph_map's."""
    c, _out = _path_counts(counters, fn, record=False)
    return c["frame_bytes"] + c["modal_vote_chars"] + c["glyph_map"]


def check_ray_grid_jit(dev):
    """The ray tracer's grid kernel (one launch for every view) against its
    plain version (ndc_grid_jit + ray_dirs_jit on the same CUDA device) at
    the farm's 1,024 orbit poses and the rt_demo pose, 96x36: bit for bit.
    Returns the record (timed at the farm's batch)."""
    import torch
    from ascii_renderer_tpu_torch.core.camera import (camera_bases,
                                                      ndc_grid_jit,
                                                      ray_dirs_jit)
    from ascii_renderer_tpu_torch.ops import ray_grid as RYG
    from ascii_renderer_tpu_torch.scene.demo import create_rt_demo_scene
    rows, cols = FARM_GRID
    demo = create_rt_demo_scene().build(device="cpu").camera
    for cams in (_orbit(), demo):
        bases = camera_bases(cams.yaw.reshape(-1), cams.pitch.reshape(-1),
                             cams.fov_y.reshape(-1))
        # the full grid, then row bands of 12 (the kernel's row offset)
        for band in ((0, None), (0, 12), (12, 12), (24, 12)):
            got = RYG.ray_grid_jit(bases, rows, cols, PIXEL_ASPECT, dev,
                                   *band)
            px, py = ndc_grid_jit(rows, cols, PIXEL_ASPECT, dev, *band)
            want = ray_dirs_jit(px, py, tuple(b.to(dev) for b in bases))
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), \
                f"jitted ray grid differs at {tuple(got.shape)}, band {band}"
    bases = camera_bases(*(getattr(_orbit(), f) for f in
                           ("yaw", "pitch", "fov_y")))
    n = FARM_VIEWS * rows * cols
    ms = _device_ms(lambda: RYG.ray_grid_jit(bases, rows, cols, PIXEL_ASPECT,
                                             dev), "ray_grid_jit_kernel", 1)
    dbases = tuple(b.to(dev) for b in bases)

    def plain():
        px, py = ndc_grid_jit(rows, cols, PIXEL_ASPECT, dev)
        return ray_dirs_jit(px, py, dbases)

    plain_ms = _event_ms(plain, 5)
    # 12 bytes out a ray (and 36 in a view); ~22 float operations a ray:
    # the two cell centres, three fused sums, the norm, three divisions
    bound = _bound(12 * n + 36 * FARM_VIEWS, RT_OPS_GRID * n)
    print(f"jitted ray grid: bit-identical at the {FARM_VIEWS} orbit poses "
          f"and the rt_demo pose, 96x36 and its bands of 12; kernel "
          f"{ms:.5f} ms, plain {plain_ms:.3f} ms, bound {bound[0]:.5f} ms "
          f"({bound[1]}) at {n} rays", flush=True)
    rec = _rec("ray_grid_jit", "ray_grid.cu", "", 0.0, ms, plain_ms, bound)
    # the XLA code it stands for: the jitted primary_ray_dirs of render_rgb
    # (K3's grid form computes those rays on the render paths)
    rec["replaces"] = "ascii_renderer_tpu/core/camera.py:172"
    rec["folded_into"] = "rt_trace (grid form)"
    return rec


# --------------------------------------------------------------------------
# The kernels for XLA code: fma32 (ops/fp), the raster's deferred shade
# (ops/raster_shade) and the ray tracer's frame (ops/rt_trace)
# --------------------------------------------------------------------------
FMA_BATCH = 1 << 23  # random triples a batch, two batches: 16,777,216
# float operations a lit pixel of the shade (a fused product-add counted
# as two; 1 / sqrt in double as two), and more a point light, from
# csrc/raster_shade.cu
SHADE_OPS_PIXEL, SHADE_OPS_POINT = 86, 28
# float operations of the ray tracer's kernel (csrc/rt_trace.cu, a fused
# product-add counted as two): a ray against a sphere, a plane, a
# triangle; a hit's point, normal and material; a light's direction,
# attenuation and term
RT_OPS_SPHERE, RT_OPS_PLANE, RT_OPS_TRI, RT_OPS_HIT, RT_OPS_LIGHT = \
    27, 17, 60, 20, 25
# float operations of a primary ray in K3's grid form (csrc/ray_dir.cuh):
# the two cell centres, three fused sums, the norm, three divisions
RT_OPS_GRID = 22


def _same_bits(got, want, what):
    """Bit for bit, NaN payloads aside: NaN in the same places."""
    import torch
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), f"{what}: NaN elsewhere"
    g, w = got[~nan].view(torch.int32), want[~nan].view(torch.int32)
    assert torch.equal(g, w), f"{what}: {int((g != w).sum())} of " \
        f"{w.numel()} values differ"


def _jax_def_line(port_file, fn):
    """``ascii_renderer_tpu/<path>:<line>`` of the reference's ``def fn``
    for a module of the port (the source is read, never imported)."""
    rel = os.path.relpath(port_file, ROOT).replace(
        "ascii_renderer_tpu_torch", "ascii_renderer_tpu", 1)
    if not os.path.isfile(os.path.join(ROOT, rel)):
        return rel
    with open(os.path.join(ROOT, rel)) as fh:
        for i, line in enumerate(fh, 1):
            if line.lstrip().startswith(f"def {fn}("):
                return f"{rel}:{i}"
    return rel


def check_fma32(dev, soup, scene):
    """K1, fma32 on CUDA tensors (one launch of csrc/fp.cu's __fmaf_rn),
    against its plain version fma32_f64 on the same card, before any
    other kernel is held to its plain version (those call fma32): 16,777,216
    random triples (half of them random bit patterns: every exponent,
    subnormals, infinities, NaN; half normal values of one scale),
    constructed float32 midpoint ties, subnormal and special values, and
    broadcast, strided, 0-d and Python-float operands: bit for bit, NaN in
    the same places. Its calls on the driven paths are held and timed
    later (time_fma32). Returns the record and the shade call of a frame
    of the mid-scale HD arm (RasterBackend, 14,884 triangles, 960x540)."""
    import torch
    from ascii_renderer_tpu_torch.backends.raster import RasterBackend
    from ascii_renderer_tpu_torch.core.config import Config
    from ascii_renderer_tpu_torch.core.fp import fma32_f64
    from ascii_renderer_tpu_torch.ops import fp as KFP
    from ascii_renderer_tpu_torch.ops import raster_shade as RSH
    from ascii_renderer_tpu_torch.tools import xla_inputs as xi
    g = torch.Generator(device=dev).manual_seed(15)
    sets = {"random bit patterns": tuple(torch.randint(
        -2 ** 31, 2 ** 31, (FMA_BATCH,), generator=g, device=dev).to(
        torch.int32).view(torch.float32) for _ in range(3)),
        "random normal": tuple(torch.randn(FMA_BATCH, generator=g,
                                           device=dev) * 4
                               for _ in range(3))}
    for label, trip in (("midpoint ties", xi.fma_ties()),
                        ("special values", xi.fma_specials())):
        sets[label] = tuple(torch.from_numpy(x).to(dev) for x in trip)
    sets.update({case: xi.fma_operands(case, dev) for case in xi.FMA_CASES})
    n_random = 0
    for label, ops in sets.items():
        _same_bits(KFP.fma32_kernel(*ops), fma32_f64(*ops), f"fma32 {label}")
        if label.startswith("random"):
            n_random += ops[0].numel()
    torch.cuda.synchronize()
    print(f"fma32 (K1): bit-identical to fma32_f64 on {n_random} random "
          f"triples, {sets['midpoint ties'][0].numel()} midpoint ties, "
          f"{sets['special values'][0].numel()} subnormal and special "
          f"values, operands {', '.join(xi.FMA_CASES)}", flush=True)
    msoup, cam = _mesh("mid")
    be = RasterBackend(Config(pixel_aspect=PIXEL_ASPECT), device=dev)
    be.set_soup(*msoup, _scene(dev))
    (shade_args, _kw) = _capture(RSH, "shade", lambda: be.render(
        0.0, cam, *MID_GRID, PIXEL_ASPECT))
    rec = _rec("fma32", "fp.cu", "", 0.0, 0.0, 0.0, (0.0, "bytes"))
    rec.update(random=n_random)
    return rec, shade_args


# K1's call sites on the driven paths: {launch size: {"path:line
# function" of the port's caller: calls}}
_FMA_SITES = {}


def _fma_site():
    """"path:line function" of the port's code that called fma32: the
    first frame above core/fp.py and this script's recorders."""
    f = sys._getframe(1)
    skip = ("chip_smoke.py", os.path.join("core", "fp.py"))
    while f.f_back is not None and f.f_code.co_filename.endswith(skip):
        f = f.f_back
    path = f.f_code.co_filename
    i = path.rfind("ascii_renderer_tpu_torch")
    return f"{path[i:] if i >= 0 else path}:{f.f_lineno} {f.f_code.co_name}"


def _record_fma_sites():
    """Wrap fma32's kernel wrapper so that, while a driven path runs, each
    call is counted at its launch size (_fma_size) and site in
    _FMA_SITES."""
    from ascii_renderer_tpu_torch.ops import fp as KFP
    real = KFP.fma32_kernel

    def rec(*a):
        if _DRIVEN[0]:
            size = _fma_size(a, {})
            if size is not None:
                sites = _FMA_SITES.setdefault(size, {})
                site = _fma_site()
                sites[site] = sites.get(site, 0) + 1
        return real(*a)

    KFP.fma32_kernel = rec


def time_fma32(sizes, real, rec):
    """K1 at each launch size of the driven paths (_record_sizes' first
    call there) held to fma32_f64 bit for bit, then timed at the largest
    of them beside torch.addcmul on the same operands (the elementwise
    floor, not the same function: it rounds the product). Fills the
    record's times, bound and site."""
    import torch
    from ascii_renderer_tpu_torch.core.fp import fma32_f64
    for size, (a, _k, _n, _w) in sizes.items():
        _same_bits(real(*a), fma32_f64(*a), f"fma32 driven call at {size}")
    size = max(sizes, key=math.prod)
    ops = sizes[size][0]
    out = real(*ops)
    n = out.numel()
    tens = [x for x in ops if isinstance(x, torch.Tensor)
            and x.device.type == "cuda"]
    at, bt, ct = (x if isinstance(x, torch.Tensor) and x.device == out.device
                  else torch.tensor(float(x), dtype=torch.float32,
                                    device=out.device) for x in ops)
    ms = _device_ms(lambda: real(*ops), "fma32_kernel", 1)
    plain = _event_ms(lambda: fma32_f64(*ops), 20)
    lib = _device_ms(lambda: torch.addcmul(ct, at, bt), None, 1)
    bound = _fma_bound(ops, out)
    forms = [f"{tuple(x.shape)} strides {x.stride()}"
             if isinstance(x, torch.Tensor) else repr(x) for x in ops]
    for sz in sorted(_FMA_SITES, key=math.prod):
        by_site = sorted(_FMA_SITES[sz].items(), key=lambda it: -it[1])
        print(f"fma32 (K1) calls at {list(sz)} on the driven paths: "
              + "; ".join(f"{n} from {st}" for st, n in by_site), flush=True)
    site = max(_FMA_SITES[size].items(), key=lambda it: it[1])[0]
    path, _, fn = site.partition(" ")
    print(f"fma32 (K1): each of its {len(sizes)} launch sizes on the driven "
          f"paths bit-identical to fma32_f64 at its first call; timed at "
          f"the largest, {list(size)} (its first call; most of that size's "
          f"calls from {site}): "
          f"{' x '.join(forms[:2])} + {forms[2]}, {_nbytes(*tens, out)} "
          f"bytes: kernel {ms:.5f} ms, plain {plain:.3f} ms, addcmul "
          f"{lib:.5f} ms, bound {bound[0]:.5f} ms ({bound[1]})", flush=True)
    rec.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound[0],
               bound_by=bound[1], shape=list(out.shape), timed_at=site,
               replaces=_jax_def_line(os.path.join(ROOT, path.split(":")[0]),
                                      fn))
    assert n > 0


def _shade_bound(args):
    """The least work of a shade call: ids, centres and the used columns
    of the table rows the lit pixels pick read once, rgb written once;
    SHADE_OPS_PIXEL (+ SHADE_OPS_POINT a point-light slot) a lit pixel."""
    import torch
    table, ids, px, py, scene, n_attrs = args
    hit = int((ids >= 0).sum())
    rows = torch.unique(ids[ids >= 0]).numel()
    n = torch.broadcast_shapes(ids.shape, px.shape, py.shape).numel()
    n_bytes = (_nbytes(ids, px, py) + 4 * rows * (3 * n_attrs + 3)
               + 12 * n)
    ops = hit * (SHADE_OPS_PIXEL + SHADE_OPS_POINT * scene.pt_pos.shape[0])
    return _bound(n_bytes, ops), hit, rows, n


def check_raster_shade(dev, calls, image_form):
    """K2, the raster's deferred shade (csrc/raster_shade.cu), against its
    plain version (the gather, then raster_common._shade_rows) at the
    calls of its grouped form (``calls``: the mid-scale HD arm's plane
    table, the subtile path's compacted tiles): bit for bit, each timed
    (``grouped_form``). The record's own numbers are its image form's at
    the headline's steady call (``image_form``, from check_shade_image):
    the headline launches only that form. Returns the record."""
    import torch
    from ascii_renderer_tpu_torch.ops import raster_shade as RSH
    lines, grouped = [], {}
    for label, args in calls.items():
        got, want = RSH.shade(*args), RSH.shade_ref(*args)
        torch.cuda.synchronize()
        _same_bits(got, want, f"shade, {label}")
        assert (want > 0).any(), label
        (bnd, by), hit, rows, n = _shade_bound(args)
        ms = _device_ms(lambda: RSH.shade(*args), "raster_shade_kernel", 1)
        plain = _event_ms(lambda: RSH.shade_ref(*args), 5)
        grouped[label] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                              bound_by=by, pixels=n, lit=hit, rows=rows)
        lines.append(f"{label} {n} pixels ({hit} lit from {rows} rows, ids "
                     f"{str(args[1].dtype)[6:]}, {args[5]} attributes): "
                     f"kernel {ms:.5f} ms, plain {plain:.3f} ms, bound "
                     f"{bnd:.5f} ms ({by})")
    print(f"raster shade (K2), grouped form: bit-identical to the plain "
          f"version for {'; '.join(lines)}", flush=True)
    im = image_form
    rec = _rec("raster_shade", "raster_shade.cu", "", 0.0, im["ms"],
               im["plain_ms"], (im["bound_ms"], im["bound_by"]))
    rec.update(replaces="ascii_renderer_tpu/backends/raster_common.py:73",
               at="headline steady frame (image form)", pixels=im["pixels"],
               lit=im["lit"], rows=im["rows"], grouped_form=grouped,
               image_form=im)
    return rec


def _capture_all(mod, name, run):
    """Run ``run()`` with ``mod.name`` recording the arguments of every
    call: [(args, kwargs)]."""
    orig = getattr(mod, name)
    seen = []

    def rec(*a, **k):
        seen.append((a, k))
        return orig(*a, **k)

    setattr(mod, name, rec)
    try:
        run()
    finally:
        setattr(mod, name, orig)
    assert seen, f"{name} was not called"
    return seen


def _image_ids(args):
    """(winner ids f32 [rows, cols] of an image-form call, -1 where no hit
    or no group covers the bin; bins): what each pixel of
    ``raster_shade.shade_image(*args)`` reads."""
    import torch
    table, e, ginv, tiles_x, rows, cols = (args[k] for k in (0, 1, 5, 8, 9,
                                                             10))
    dev = e.device
    r = torch.arange(rows, device=dev)[:, None]
    c = torch.arange(cols, device=dev)[None, :]
    bins = ((r // 8) * tiles_x + c // 128) * 8 + (c % 128) // 16
    place = ginv.long()[bins]
    covered = place < e.shape[0] * 8
    place = torch.where(covered, place, 0)
    flat = (place // 8) * 1024 + (r % 8) * 128 + (place % 8) * 16 + c % 16
    return torch.where(covered, e.reshape(-1)[flat], -1.0), bins


def _shade_image_bound(args):
    """The least work of an image-form call: each pixel's id and its bin's
    place read once (the places of the image's bins), the used columns of
    the table rows the lit pixels pick, rgb written once; the lit pixels'
    shade operations as K2's."""
    import torch
    ids, bins = _image_ids(args)
    table, scene, n_attrs = args[0], args[6], args[7]
    hit = int((ids >= 0).sum())
    rows = torch.unique(ids[ids >= 0]).numel()
    n = ids.numel()
    n_bytes = (4 * n + 4 * torch.unique(bins).numel()
               + 4 * rows * (3 * n_attrs + 3) + 12 * n)
    ops = hit * (SHADE_OPS_PIXEL + SHADE_OPS_POINT * scene.pt_pos.shape[0])
    return _bound(n_bytes, ops), hit, rows, n


def check_shade_image(dev, soup, scene, backend, cfg):
    """K2's image form (one launch: the grouped paths' shade and assembly)
    against its plain version (the grouped shade, then
    ``assemble_group_image``) bit for bit at every call the grouped paths
    make: the headline's frame 0 (a fresh backend) and steady frame, every
    grouped generation's golden call (FRAME_RUNS: its 1,024 bin slots leave
    bins uncovered), and the bunny's row bands (subtile8, subtile6,
    subtile3 at row_lo 0, BAND_ROWS, 2 BAND_ROWS). Timed at the headline's
    steady call. Returns the image form's numbers."""
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.backends.raster import RasterBackend
    from ascii_renderer_tpu_torch.ops import raster_shade as RSH
    cam = _golden_camera()
    calls = {}
    fresh = RasterBackend(cfg, device=dev)
    fresh.set_soup(*(torch.as_tensor(x) for x in soup), scene)
    calls["headline frame 0"] = _capture_all(
        RSH, "shade_image", lambda: _frame(fresh, cfg, cam))
    del fresh
    calls["headline steady frame"] = _capture_all(
        RSH, "shade_image", lambda: _frame(backend, cfg, cam))
    frame = _generation_frame(dev, soup, scene)
    for method, packed in FRAME_RUNS:
        label = f"{method}{' SETUP_PACKED' if packed else ''} golden call"
        calls[label] = _capture_all(RSH, "shade_image",
                                    lambda: frame(method, packed))
    p, n, c = (torch.as_tensor(x).to(dev) for x in soup)
    caps = _golden_caps(p.shape[0] // 3)
    for gen in ("subtile8", "subtile6", "subtile3"):
        for lo in (0, BAND_ROWS, 2 * BAND_ROWS):
            calls[f"{gen} band {lo}"] = _capture_all(
                RSH, "shade_image", lambda: R.render_soup_diag(
                    p, n, c, scene, cam, ROWS, COLS, PIXEL_ASPECT,
                    kernel=gen, row_lo=lo, band_rows=BAND_ROWS, **caps))
    lines, n_calls = [], 0
    for label, cl in calls.items():
        for i, (a, k) in enumerate(cl):
            got, want = RSH.shade_image(*a, **k), RSH.shade_image_ref(*a, **k)
            torch.cuda.synchronize()
            _same_bits(got, want, f"K2 image form, {label} call {i}")
            # the bunny leaves the top band (rows 0-175) unlit
            assert (want > 0).any() or " band 0" in label, label
            n_calls += 1
        ids, bins = _image_ids(cl[-1][0])
        lines.append(f"{label} {tuple(ids.shape)} ({int((ids >= 0).sum())} "
                     f"lit, {int(torch.unique(bins).numel())} bins, grp_cap "
                     f"{cl[-1][0][1].shape[0]})")
    a = calls["headline steady frame"][-1][0]
    ms = _device_ms(lambda: RSH.shade_image(*a), "raster_shade_image_kernel",
                    1)
    plain = _event_ms(lambda: RSH.shade_image_ref(*a), 5)
    bound, hit, rows, npix = _shade_image_bound(a)
    print(f"K2 image form: bit-identical to the plain version in {n_calls} "
          f"calls: {'; '.join(lines)}; headline kernel {ms:.5f} ms, plain "
          f"{plain:.3f} ms, bound {bound[0]:.5f} ms ({bound[1]}; {npix} "
          f"pixels, {hit} lit from {rows} rows)", flush=True)
    return dict(ms=ms, plain_ms=plain, bound_ms=bound[0], bound_by=bound[1],
                max_abs_err=0.0, pixels=npix, lit=hit, rows=rows,
                checked_calls=n_calls,
                replaces="ascii_renderer_tpu/ops/raster_group.py:1284")


def _rt_grid(cams, rows, cols, row_lo=0, n_rows=None):
    """render_rgb's grid (ops/rt_trace.Grid) of ``cams`` and their origins
    f32 [V, 3] on the host."""
    import torch
    from ascii_renderer_tpu_torch.core.camera import band_of, camera_bases
    from ascii_renderer_tpu_torch.ops import rt_trace as RTK
    yaw, pitch, fov = (getattr(cams, f).reshape(-1)
                       for f in ("yaw", "pitch", "fov_y"))
    grid = RTK.Grid(camera_bases(yaw, pitch, fov), rows, cols, PIXEL_ASPECT,
                    row_lo, band_of(rows, row_lo, n_rows))
    return grid, cams.pos.reshape(-1, 3).to(torch.float32)


def _rt_trig_grid(cams, rows, cols, row_lo=0, n_rows=None):
    """render_rgb's grid on the card above SCALAR_VIEWS views: its trig
    form (core/camera.view_trig), and the origins f32 [V, 3] on the
    host."""
    from ascii_renderer_tpu_torch.core.camera import view_trig
    grid, cam = _rt_grid(cams, rows, cols, row_lo, n_rows)
    return grid._replace(bases=None, trig=view_trig(
        cam, cams.yaw, cams.pitch, cams.fov_y)), cam


def _k3_args(a, k):
    """(scene, prims, cam [V, 3], rd3 [V, R, 3], grid or None) on the
    scene's device of a call of ops/rt_trace.trace: the grid form's rays
    by the plain grid."""
    from ascii_renderer_tpu_torch.ops import rt_trace as RTK
    scene, pr, cam, rd3 = a[:4]
    grid = k.get("grid")
    dev = scene.sph_pos.device
    if grid is not None:
        rd3 = RTK.grid_rays(grid, dev)
    return scene, pr, cam.to(dev), rd3, grid


def _k3_bound(scene, pr, cam, rd3, grid):
    """K3's least work on these rays: rgb written once (12 bytes a ray);
    the grid form's 48 bytes a view and RT_OPS_GRID operations a ray, or
    rd3 and cam read once; the valid slots' operations (_rt_ops). Returns
    (bound, rays, hits, mirror hits)."""
    n_ops, n_hit, n_refl = _rt_ops(scene, pr, cam, rd3)
    n = rd3.shape[0] * rd3.shape[1]
    if grid is None:
        return _bound(24 * n + _nbytes(cam), n_ops), n, n_hit, n_refl
    per_view = 48 if getattr(grid, "trig", None) is None else 32
    return (_bound(12 * n + per_view * rd3.shape[0],
                   n_ops + RT_OPS_GRID * n), n, n_hit, n_refl)


def _rt_inputs(scene, cams, rows, cols, dev, row_lo=0, n_rows=None):
    """(prims, cam [V, 3], rd3 [V, R, 3]) of K3's rd3 form: the jitted grid
    kernel's rays."""
    import torch
    from ascii_renderer_tpu_torch.backends.raytrace import ScenePrims
    from ascii_renderer_tpu_torch.core.camera import band_of, camera_bases
    from ascii_renderer_tpu_torch.ops.ray_grid import ray_grid_jit
    yaw, pitch, fov = (getattr(cams, f).reshape(-1)
                       for f in ("yaw", "pitch", "fov_y"))
    rows_out = band_of(rows, row_lo, n_rows)
    rd3 = ray_grid_jit(camera_bases(yaw, pitch, fov), rows, cols,
                       PIXEL_ASPECT, dev, row_lo, rows_out)
    V = yaw.shape[0]
    cam = cams.pos.reshape(-1, 3).to(dev, torch.float32)
    return ScenePrims(scene), cam, rd3.reshape(V, rows_out * cols, 3)


def _rt_ops(scene, prims, cam, rd3):
    """The ray tracer kernel's float operations on these rays, counted
    from the plain version's primary hits over the scene's valid slots
    (padding is no work of the function: the kernel skips it): every ray
    tests every valid primitive; a hit shades with a shadow ray a set
    light (spheres and triangles); a mirror hit traces and shades its
    bounce as well."""
    from ascii_renderer_tpu_torch.backends.pt_core import V3
    from ascii_renderer_tpu_torch.backends.raytrace import closest_hit
    pr = prims
    ro = V3(cam[:, 0:1], cam[:, 1:2], cam[:, 2:3])
    _t, mat, _n, hit = closest_hit(ro, V3.of(rd3), scene, pr)
    n_hit = int(hit.sum())
    n_refl = int((hit & scene.mat_reflective[mat.long()]).sum())
    n_sph, n_pln, n_tri = (int(v.sum()) for v in (
        pr.sph_valid, pr.pln_valid, pr.tri_valid))
    trace = (RT_OPS_SPHERE * n_sph + RT_OPS_PLANE * n_pln
             + RT_OPS_TRI * n_tri + RT_OPS_HIT)
    shade = (pr.n_dl + pr.n_pt) * (RT_OPS_SPHERE * n_sph
                                   + RT_OPS_TRI * n_tri + RT_OPS_LIGHT)
    return (rd3.shape[0] * rd3.shape[1] * trace + n_hit * shade
            + n_refl * (trace + shade)), n_hit, n_refl


def _k3_form(RTK, n_rays, pr):
    """K3's launch at n_rays over the scene pr, by the launch's own choice:
    (lanes a ray, staged, blocks of 128 threads)."""
    lanes, staged = RTK.launch_form(n_rays, pr)
    return lanes, staged, -(-n_rays * lanes // 128)


def check_rt_trace(dev):
    """K3, the ray tracer's frame (one launch of csrc/rt_trace.cu for every
    view), against its plain version, trace_rgb of the plain grid
    (ndc_grid_jit + ray_dirs_jit on the same device), in its grid form
    (render_rgb's: the kernel computes the rays) and its rd3 form (the
    jitted grid kernel's rays), each in every form of the kernel (1-32
    lanes a ray, the valid slots staged in shared memory or read from the
    global arrays) and the launch's own: the rt_demo golden's frame (96x36,
    its padded slots), its row bands of 12, the farm's 1,024 orbit views
    (exact slots), and the triangle / quad / mirror scene, rt_demo with
    two lights of each kind and a one-sphere scene over 16 views: bit for
    bit, and render_rgb too; the batches also in the grid form's trig form
    (each view's origin and trig, the bases formed on the card). Timed at
    the farm's batch in every form. Returns the record (the times of
    render_rgb's form at the farm, the trig form's)."""
    import torch
    from ascii_renderer_tpu_torch.backends.raytrace import (render_rgb,
                                                            trace, trace_rgb)
    from ascii_renderer_tpu_torch.ops import rt_trace as RTK
    from ascii_renderer_tpu_torch.scene.demo import create_rt_demo_scene
    rows, cols = FARM_GRID
    demo = create_rt_demo_scene().build(device=dev)
    cases = [("rt_demo golden pose", demo, demo.camera, {})]
    cases += [(f"rt_demo band {lo}-{lo + 12}", demo, demo.camera,
               dict(row_lo=lo, n_rows=12)) for lo in (0, 12, 24)]
    cases.append(("farm 1,024 views", create_rt_demo_scene().build(
        min_pad=1, device=dev), _orbit(), {}))
    from ascii_renderer_tpu_torch.tools import xla_inputs as xi
    for name in xi.RT_SCENES[1:]:  # the triangle / quad / mirror scene,
        # two lights of each kind, one sphere slot
        cases.append((f"{name} 16 views", xi.rt_scene(name, dev),
                      _orbit(16), {}))
    forms = [dict(lanes=L, stage=st) for L in RTK.LANES
             for st in ("staged", "global")]
    for label, scene, cams, kw in cases:
        pr, cam, rd3 = _rt_inputs(scene, cams, rows, cols, dev, **kw)
        grid, cam_h = _rt_grid(cams, rows, cols, **kw)
        plain_rd3 = RTK.grid_rays(grid, dev)
        _same_bits(rd3, plain_rd3, f"jitted grid kernel, {label}")
        want = trace_rgb(scene, pr, cam, plain_rd3)
        V, R = rd3.shape[:2]
        fuse = (_rt_fuse(pr, V, 1), _rt_fuse(pr, V, R))
        runs = {"rd3 form": lambda **f: RTK.trace(scene, pr, cam, rd3, fuse,
                                                  **f),
                "grid form": lambda **f: RTK.trace(scene, pr, cam_h, None,
                                                   fuse, grid=grid, **f)}
        if V > 1:
            tgrid = _rt_trig_grid(cams, rows, cols, **kw)[0]
            runs["trig form"] = lambda **f: RTK.trace(
                scene, pr, cam_h, None, fuse, grid=tgrid, **f)
        _same_bits(trace(scene, pr, cam, rd3), want, f"rt trace, {label}")
        _same_bits(render_rgb(scene, cams, rows, cols, PIXEL_ASPECT,
                              prims=pr, **kw).reshape(want.shape), want,
                   f"render_rgb, {label}")
        assert (want > 0.05).float().mean() > 0.3, label
        for ray_form, run in runs.items():
            for f in [{}] + forms:
                _same_bits(run(**f), want,
                           f"rt trace, {label}, {ray_form} {f or 'own'}")
        torch.cuda.synchronize()
    farm = cases[4][1]
    pr, cam, rd3 = _rt_inputs(farm, _orbit(), rows, cols, dev)
    grid, cam_h = _rt_grid(_orbit(), rows, cols)
    fuse = (_rt_fuse(pr, FARM_VIEWS, 1), _rt_fuse(pr, FARM_VIEWS,
                                                  rd3.shape[1]))
    tgrid = _rt_trig_grid(_orbit(), rows, cols)[0]
    ms_bases = _device_ms(lambda: RTK.trace(farm, pr, cam_h, None, fuse,
                                            grid=grid), "rt_trace_kernel", 1)
    ms = _device_ms(lambda: RTK.trace(farm, pr, cam_h, None, fuse,
                                      grid=tgrid), "rt_trace_kernel", 1)
    ms_rd3 = _device_ms(lambda: trace(farm, pr, cam, rd3), "rt_trace_kernel",
                        1)
    plain = _event_ms(lambda: trace_rgb(farm, pr, cam,
                                        RTK.grid_rays(grid, dev)), 3)
    bound, n, n_hit, n_refl = _k3_bound(farm, pr, cam, rd3, tgrid)
    bound_rd3 = _k3_bound(farm, pr, cam, rd3, None)[0]
    lanes, staged, blocks = _k3_form(RTK, n, pr)
    print(f"rt trace (K3): bit-identical to the plain version (trace_rgb "
          f"of the plain grid) in the grid form and the rd3 form, all "
          f"{len(forms)} forms (lanes {RTK.LANES}, staged and global) and "
          f"the launch's own, and render_rgb, on "
          f"{', '.join(c[0] for c in cases)}; farm {n} rays ({n_hit} hit, "
          f"{n_refl} on a mirror; {lanes} lanes a ray, "
          f"{'staged' if staged else 'global'}, {blocks} blocks): grid form "
          f"(render_rgb's, the trig form, bases once a block) {ms:.5f} ms "
          f"(bound {bound[0]:.5f} ms, {bound[1]}), the bases' 12 floats "
          f"from the host {ms_bases:.5f} ms, rd3 "
          f"form "
          f"{ms_rd3:.5f} ms (bound {bound_rd3[0]:.5f} ms, {bound_rd3[1]}), "
          f"plain {plain:.3f} ms; decisions "
          f"{RTK.FUSE['primary']['spheres_t']} (primary) / "
          f"{RTK.FUSE['bounce']['spheres_t']} (bounce, shadow)", flush=True)
    rec = _rec("rt_trace", "rt_trace.cu", "", 0.0, ms, plain, bound)
    rec.update(replaces="ascii_renderer_tpu/backends/raytrace.py:166",
               rays=n, hit=n_hit, mirror=n_refl, ms_rd3=ms_rd3,
               bound_ms_rd3=bound_rd3[0], ms_bases=ms_bases)
    return rec


def check_render_rgb_one_launch(dev):
    """render_rgb on the card is one kernel launch a call, K3's grid form:
    a profile of 3 calls each of one view (the rt_demo golden pose), a
    band of 12 rows and the 1,024-view farm holds 3 CUDA kernel rows, all
    rt_trace_kernel (no grid kernel, no torch op; a batch's bases are one
    host-to-device copy, counted apart), and the wrappers count 3 K3
    launches, no jitted grid and no fma32."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ascii_renderer_tpu_torch.backends.raytrace import (ScenePrims,
                                                            render_rgb)
    from ascii_renderer_tpu_torch.ops import fp as KFP
    from ascii_renderer_tpu_torch.ops import ray_grid as RYG
    from ascii_renderer_tpu_torch.ops import rt_trace as RTK
    from ascii_renderer_tpu_torch.scene.demo import create_rt_demo_scene
    rows, cols = FARM_GRID
    demo = create_rt_demo_scene().build(device=dev)
    farm = create_rt_demo_scene().build(min_pad=1, device=dev)
    calls = {"one view": (demo, demo.camera, {}),
             "band 12-24": (demo, demo.camera, dict(row_lo=12, n_rows=12)),
             "farm": (farm, _orbit(), {})}
    lines = []
    for label, (scene, cams, kw) in calls.items():
        pr = ScenePrims(scene)

        def one():
            return render_rgb(scene, cams, rows, cols, PIXEL_ASPECT,
                              prims=pr, **kw)

        one()
        torch.cuda.synchronize()
        for _attempt in range(_PROFILES):  # the profiler now and then
            # drops rows at a session's edge: spin kernels sit there
            counts = (RTK.launches, RYG.jit_launches, KFP.launches)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _spin()
                for _ in range(3):
                    one()
                torch.cuda.synchronize()
                _spin()
            made = tuple(now - was for now, was in zip(
                (RTK.launches, RYG.jit_launches, KFP.launches), counts))
            assert made == (3, 0, 0), f"render_rgb {label}: K3, grid, " \
                f"fma32 launches {made} in 3 calls"
            rows_ = [e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and "spin_kernel" not in e.key
                     and not e.key.startswith(("rt.", "frame.", "glyph"))]
            copies = sum(e.count for e in rows_
                         if e.key.startswith(("Memcpy", "Memset")))
            kernels = {e.key: e.count for e in rows_
                       if not e.key.startswith(("Memcpy", "Memset"))}
            assert all("rt_trace_kernel" in k for k in kernels), \
                f"render_rgb {label}: device kernels {kernels} in 3 calls"
            if sum(kernels.values()) == 3:
                break
        else:
            raise AssertionError(f"render_rgb {label}: {kernels} kernel "
                                 f"rows in 3 calls, {_PROFILES} profiles")
        lines.append(f"{label} 1 launch, {copies / 3:g} copies a call")
    print(f"render_rgb on the card: {'; '.join(lines)} (K3's grid form "
          f"only)", flush=True)


def _rt_fuse(pr, views, rays):
    """raytrace.trace's sphere decision for origins [views, 1, rays]."""
    from ascii_renderer_tpu_torch.backends import rt_core as RC
    return RC.sphere_c_fused((views, 1, rays), pr.n_sph)


def run_rt_path(dev):
    """Renderer(Config(pixel_aspect=0.5), "rt") on the rt_demo scene at
    96x36, the golden's call: frame 0 must give tests/goldens/rt_demo.txt
    exactly; then 3 moves and 20 timed frames. Then the "raytrace" frame
    step at 96x36: frame 0's chars must equal the port's CPU step.
    Returns a function that renders one frame at the pose."""
    import torch
    from ascii_renderer_tpu_torch.ascii import chars_to_strings
    from ascii_renderer_tpu_torch.backends.registry import Renderer
    from ascii_renderer_tpu_torch.core.camera import CameraInputs, update_camera
    from ascii_renderer_tpu_torch.core.config import Config
    from ascii_renderer_tpu_torch.scene.demo import create_rt_demo_scene
    from ascii_renderer_tpu_torch.sim.framestep import demo_setup
    cfg = Config(pixel_aspect=0.5)
    r = Renderer(cfg, "rt")
    scene = create_rt_demo_scene().build()
    r.set_scene(scene)
    cam = scene.camera
    moves = _moves()
    with open(GOLDEN_RT) as fh:
        golden = fh.read().splitlines()
    for f in range(4):
        if f:
            cam = update_camera(cam, moves[f - 1], 1.0 / 30.0)
        box = {}
        (ms,) = _timed(lambda: box.update(
            chars=_glyph(r.render(0.0, cam), cfg)), 1)
        chars = box["chars"]
        assert chars.device.type == "cuda" and tuple(chars.shape) == (36, 96)
        kinds = int(torch.unique(chars).numel())
        assert kinds >= 4, kinds
        if f == 0:
            rows = chars_to_strings(chars)
            bad = [i for i, (a, b) in enumerate(zip(rows, golden)) if a != b]
            assert rows == golden, f"rt_demo rows {bad} differ from golden"
            print("RT frame 0: tests/goldens/rt_demo.txt exactly", flush=True)
        print(f"RT frame {f}: {ms:.3f} ms, {kinds} distinct glyphs",
              flush=True)
    pose = scene.camera

    def one():
        _glyph(r.render(0.0, pose), cfg)

    _summary("RT frame 96x36 (rt_demo pose)", _timed(one, 20))
    ins = CameraInputs.from_keys({"w"})
    outs = []
    for d in (dev, "cpu"):
        _cfg, sc, state, step = demo_setup(Config(), "raytrace", device=d)
        _s, chars, _t, _f = step(sc, state, ins, 1.0 / 60, 60.0)
        assert tuple(chars.shape) == ENTRY_GRID
        outs.append(chars.cpu())
    assert torch.equal(outs[0], outs[1]), \
        f"RT step frame 0: {int((outs[0] != outs[1]).sum())} chars differ " \
        f"from the CPU step"
    print("RT step frame 0: chars equal the CPU step", flush=True)
    return one


def _farm_fn(scene, cfg, cams):
    """render_views of render_rgb + the glyph pass over ``cams``."""
    from ascii_renderer_tpu_torch.backends.raytrace import (render_rgb,
                                                            ScenePrims)
    from ascii_renderer_tpu_torch.core.frame import Frame
    from ascii_renderer_tpu_torch.parallel.mesh import render_views
    rows, cols = FARM_GRID
    prims = ScenePrims(scene)

    def one(sc, cam):
        from torch.profiler import record_function
        rgb = render_rgb(sc, cam, rows, cols, cfg.pixel_aspect, prims=prims)
        with record_function("frame.from_float"):
            frame = Frame.from_float(rgb)
        return _glyph(frame, cfg)

    return lambda: render_views(one, scene, cams)


def run_farm_path(dev):
    """bench config 4 at full size: 1,024 orbit views of the rt_demo
    scene (exact primitive counts) at 96x36, rendered and glyph-decided
    (mode filter on: the batched B4, one launch) in one batched call. The
    views in FARM_CHECKED must give the glyph grids of the port's CPU
    render of those views exactly. Then 5 timed farms (views/s). Returns
    a function that runs one farm (its ``views_per_s`` the median's)."""
    import torch
    from ascii_renderer_tpu_torch.core.config import Config
    from ascii_renderer_tpu_torch.parallel.mesh import batch_cameras
    from ascii_renderer_tpu_torch.scene.demo import create_rt_demo_scene
    cfg = Config(pixel_aspect=0.5)
    assert cfg.ascii_mode_filter
    cams = _orbit()
    farm = _farm_fn(create_rt_demo_scene().build(min_pad=1), cfg, cams)
    chars, ms = _event_once(farm)
    assert chars.device.type == "cuda"
    assert tuple(chars.shape) == (FARM_VIEWS,) + FARM_GRID
    sel = list(FARM_CHECKED)
    sub = batch_cameras(cams.pos[sel].numpy(), cams.yaw[sel].numpy(),
                        cams.pitch[sel].numpy())
    cpu = _farm_fn(create_rt_demo_scene().build(min_pad=1, device="cpu"),
                   cfg, sub)()
    got = chars[sel].cpu()
    assert torch.equal(got, cpu), \
        f"farm views differ from the CPU render: " \
        f"{[v for i, v in enumerate(sel) if not torch.equal(got[i], cpu[i])]}"
    kinds = int(torch.unique(chars).numel())
    print(f"view farm: {FARM_VIEWS} views at 96x36 in {ms:.1f} ms (first "
          f"call); views {sel} equal the CPU render's glyph grids; "
          f"{kinds} distinct glyphs", flush=True)
    t = _timed(farm, 5)
    _summary(f"view farm {FARM_VIEWS} x 96x36", t)
    farm.views_per_s = FARM_VIEWS / (statistics.median(t) / 1e3)
    print(f"view farm: {farm.views_per_s:.1f} views/s (median of 5 farms)",
          flush=True)
    return farm


def _progressive_tracer(dev, cfg, rows, cols, skip):
    from ascii_renderer_tpu_torch.sim.accum import ProgressivePathTracer
    return ProgressivePathTracer(cfg, _pt_scene(device=dev), rows, cols,
                                 adaptive_skip=skip, device=dev)


PROG_CHECKED, PROG_MAX = 8, 64


def run_progressive_path(dev):
    """ProgressivePathTracer on the demo scene with its atlas at 96x36,
    the config's path tracer (spp 64 a batch, 5 bounces, NEE) and adaptive
    settings: for the first PROG_CHECKED batches adaptive_skip=True (B5
    with the block gate over the compacted stream) must give the display
    rgb, alpha and active mask of adaptive_skip=False bit for bit; then the
    skipping tracer runs on until poll_done() or PROG_MAX batches, each
    batch's active pixels, gated blocks and device ms printed. A spp-2 /
    2-bounce frame 0's alpha must equal the port's CPU run. Then the HD
    arm, 960x540 at spp 8, 8 batches. Returns a function that runs one
    HD batch."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ascii_renderer_tpu_torch.core.config import Config, PathTracerConfig
    from ascii_renderer_tpu_torch.ops import pt_kernel as PTK
    small = Config(path_tracer=PathTracerConfig(samples_per_batch=2,
                                                max_bounces=2))
    alphas = []
    for d in (dev, "cpu"):
        tr = _progressive_tracer(d, small, 36, 96, True)
        _disp, a, _act = tr.step(_pt_camera())
        alphas.append(a.cpu())
    assert torch.equal(alphas[0], alphas[1]), \
        f"progressive frame 0: {int((alphas[0] != alphas[1]).sum())} alpha " \
        f"cells differ from the CPU run"
    print("progressive frame 0 (spp 2, 2 bounces): alpha equals the CPU run",
          flush=True)
    cfg = Config()
    cam = _pt_camera()
    full = _progressive_tracer(dev, cfg, 36, 96, False)
    fast = _progressive_tracer(dev, cfg, 36, 96, True)
    assert fast.skip and fast.use_kernel
    n_pix = 36 * 96
    blocks = -(-cfg.path_tracer.samples_per_batch * n_pix // PTK.BLOCK)
    # the full trajectory's first batches, held to compare with
    ref = [full.step(cam) for _ in range(PROG_CHECKED)]
    log = []
    # B5's device time a batch: its kernel rows in a profile of the loop,
    # in launch order (every batch launches PTK.launches' increment)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for b in range(PROG_MAX):
            a0 = torch.cuda.Event(enable_timing=True)
            a1 = torch.cuda.Event(enable_timing=True)
            n0 = PTK.launches
            a0.record()
            disp, alpha, act = fast.step(cam)
            a1.record()
            log.append((a0, a1, act.sum(), PTK.launches - n0))
            if b < PROG_CHECKED:
                d2, al2, ac2 = ref[b]
                assert torch.equal(disp.view(torch.int32),
                                   d2.view(torch.int32)) \
                    and torch.equal(alpha, al2) and torch.equal(act, ac2), \
                    f"progressive batch {b}: adaptive skip differs from full"
            if fast.poll_done():
                break
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "pt_trace_kernel" in e.name),
                  key=lambda e: e.time_range.start)
    per = [n for *_x, n in log]
    whole = len(kern) == sum(per)
    if not whole:
        print(f"progressive: the profile holds {len(kern)} B5 rows for "
              f"{sum(per)} launches; per-batch device ms not shown",
              flush=True)
    spp = cfg.path_tracer.samples_per_batch
    b5, first = [], 0
    for b, (a0, a1, n_act, n_l) in enumerate(log):
        # the mask a step returns is the one its batch was traced under:
        # the compacted stream's rays s * pc + p are live iff p < n_act
        n_act = int(n_act)
        live = (np.arange(blocks * PTK.BLOCK) % n_pix < n_act) \
            & (np.arange(blocks * PTK.BLOCK) < spp * n_pix)
        gated = int((~live.reshape(blocks, PTK.BLOCK).any(1)).sum())
        b5_ms = "not measured"
        if whole:
            b5.append(sum(e.time_range.elapsed_us()
                          for e in kern[first:first + n_l]) / 1e3)
            b5_ms = f"{b5[-1]:.4f} ms"
        first += n_l
        print(f"progressive batch {b}: {n_act} active pixels, {gated} of "
              f"{blocks} sample blocks gated, B5 {b5_ms} on the device "
              f"({n_l} launches), the batch {a0.elapsed_time(a1):.3f} ms on "
              f"the stream", flush=True)
    print(f"progressive: adaptive skip bit-identical to full for "
          f"{PROG_CHECKED} batches; stopped after {len(log)} batches "
          f"(poll_done: {len(log) < PROG_MAX})"
          + (f"; B5 {b5[0]:.4f} ms on the device at batch 0, {b5[-1]:.4f} "
             f"at the last" if b5 else ""), flush=True)
    hd_cfg = Config(path_tracer=PathTracerConfig(samples_per_batch=8))
    hd = _progressive_tracer(dev, hd_cfg, ROWS, COLS, True)
    hd_ms = _timed(lambda: hd.step(cam), 8)
    _summary("progressive HD 960x540 spp8", hd_ms)

    def one():
        hd.step(cam)

    return one


# --------------------------------------------------------------------------
# The app shell: the port's CLI, every mode, on the card
# --------------------------------------------------------------------------
CLI_GRID = ("--rows", "36", "--cols", "96")
TERM_LIMIT_S = 20.0


def _cli(argv):
    """main(argv) of the port's CLI in this process, its stdout and stderr
    captured and every call of its frame step recorded: (rc, stdout,
    stderr, frames, ms) — frames: the Frame each one-frame step returned;
    ms: the host ms between successive step calls (a frame, its
    completion wait and the loop around it)."""
    import contextlib
    import io
    from ascii_renderer_tpu_torch.app import cli as C
    frames, stamps = [], []
    setup = C.demo_setup

    def recording(*a, **k):
        cfg, scene, state, step = setup(*a, **k)

        def rec(*sa):
            stamps.append(time.perf_counter())
            out = step(*sa)
            frames.append(out[3] if len(out) == 4 else None)
            return out

        return cfg, scene, state, rec

    out, err = io.StringIO(), io.StringIO()
    C.demo_setup = recording
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = C.main(list(argv))
    finally:
        C.demo_setup = setup
    ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    return rc, out.getvalue(), err.getvalue(), frames, ms


def _term_pty(argv, hold=b"w", hold_s=2.0, limit_s=TERM_LIMIT_S):
    """``python -m ascii_renderer_tpu_torch.app.cli argv`` on a pty: wait
    for the loop (mouse tracking switched on), hold ``hold`` for hold_s
    seconds, then "q". Returns (rc, stderr, seconds from start to exit);
    the process is killed at limit_s."""
    import pty
    import select
    master, slave = pty.openpty()
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ascii_renderer_tpu_torch.app.cli", *argv],
        stdin=slave, stdout=slave, stderr=subprocess.PIPE, env=env, cwd=ROOT)
    os.close(slave)
    seen = b""

    def pump(wait):
        nonlocal seen
        if select.select([master], [], [], wait)[0]:
            try:
                seen += os.read(master, 1 << 16)
            except OSError:
                return False
        return True

    try:
        deadline = t0 + limit_s
        while (b"\x1b[?1003h" not in seen and proc.poll() is None
               and time.perf_counter() < deadline and pump(0.1)):
            pass
        t_hold = time.perf_counter() + hold_s
        while time.perf_counter() < t_hold and proc.poll() is None:
            os.write(master, hold)
            pump(0.05)
        os.write(master, b"q")
        while (proc.poll() is None and time.perf_counter() < deadline
               and pump(0.1)):
            pass
        if proc.poll() is None:
            proc.kill()
        rc = proc.wait()
        dt = time.perf_counter() - t0
    finally:
        os.close(master)
    return rc, proc.stderr.read().decode(), dt


def _cli_rows(text):
    rows = text.splitlines()
    assert len(rows) == ENTRY_GRID[0] and all(
        len(r) == ENTRY_GRID[1] for r in rows), [len(r) for r in rows]
    return rows


def run_cli_path(dev):
    """The port's CLI (``app/cli.main``) in this process on the card at
    96x36, each output held to its path's gate against the CPU run of the
    same argv: offline raster, raytrace and raster --batch 4 text equal;
    offline pathtrace (spp 2) the last frame's alpha plane equal and the
    text equal at its override cells. Then 20 timed offline frames of each
    backend (pathtrace at the default spp 64), --progressive until
    poll_done, --mode pixels --backend raytrace for 60 frames (the first 2
    frames' bytes equal the CPU run's), --mode term --backend raster
    through a pty ("w" held ~2 s, then "q": exit 0 within TERM_LIMIT_S,
    its FrameStats printed), and the exactness canary (B3, B7', the
    float32 product). Returns a function that expands one 96x36 frame's
    glyph bitmap (the pixels mode's expand_pixels)."""
    import ast
    import numpy as np
    import torch
    from ascii_renderer_tpu_torch.ascii.ascii_pass import AsciiPass
    from ascii_renderer_tpu_torch.core.config import Config
    from ascii_renderer_tpu_torch.utils import exactness
    os.makedirs(OUT, exist_ok=True)
    t_phase = time.perf_counter()
    for label, argv in (("raster", ["--backend", "raster"]),
                        ("raytrace", ["--backend", "raytrace"]),
                        ("raster --batch 4", ["--backend", "raster",
                                              "--batch", "4", "--frames",
                                              "4"]),
                        ("pathtrace spp 2", ["--backend", "pathtrace",
                                             "--spp", "2"])):
        runs = [_cli([*argv, *CLI_GRID, "--device", d])
                for d in ("cuda", "cpu")]
        for rc, _o, err, _f, _m in runs:
            assert rc == 0, f"CLI {label}: rc {rc}\n{err}"
        (_r, out_g, _e, fr_g, _m), (_r, out_c, _e, fr_c, _m) = runs
        rows_g, rows_c = _cli_rows(out_g), _cli_rows(out_c)
        if label.startswith("pathtrace"):
            a_g, a_c = fr_g[-1].a.cpu(), fr_c[-1].a
            assert fr_g[-1].a.device.type == "cuda"
            assert torch.equal(a_g, a_c), \
                f"CLI {label}: {int((a_g != a_c).sum())} alpha bytes differ"
            ov = ((a_c >= 2) & (a_c <= 254)).numpy()
            g = np.array([list(r) for r in rows_g])
            c = np.array([list(r) for r in rows_c])
            assert (g[ov] == c[ov]).all(), f"CLI {label}: override text"
            print(f"CLI offline {label}: alpha plane equal to the CPU run "
                  f"({int(ov.sum())} overrides, their text equal); "
                  f"{int((g != c).sum())} of {g.size} other cells differ "
                  f"(rgb rounded apart)", flush=True)
        else:
            assert rows_g == rows_c, f"CLI {label}: rows " \
                f"{[i for i, (a, b) in enumerate(zip(rows_g, rows_c)) if a != b]}" \
                f" differ from the CPU run"
            print(f"CLI offline {label}: text equal to the CPU run",
                  flush=True)
    for be in ("raster", "raytrace", "pathtrace"):
        rc, out, err, _f, ms = _cli(["--backend", be, *CLI_GRID, "--frames",
                                     "21", "--out",
                                     os.path.join(OUT, f"cli_{be}.txt")])
        assert rc == 0 and "wrote" in out, err
        _summary(f"CLI offline {be} 96x36 (a frame: step + completion)",
                 ms)

    # --progressive under the profiler: each batch's statistics step is
    # one K1b launch (accum.step), no fma32 (K1)
    from ascii_renderer_tpu_torch.ops import accum as OA
    from ascii_renderer_tpu_torch.ops import fp as KFP
    got = []

    def progressive():
        got.append(_cli(["--progressive", *CLI_GRID, "--out",
                         os.path.join(OUT, "cli_progressive.txt")]))

    n0 = (OA.launches, KFP.launches)
    _busy, _n, stages, host = profile_frames(
        progressive, 1, ("pt.", "accum."), "CLI --progressive run")
    batches, k1 = OA.launches - n0[0], KFP.launches - n0[1]
    rc, _o, err, _f, _m = got[0]
    assert rc == 0, err
    with open(os.path.join(OUT, "cli_progressive.txt")) as fh:
        _cli_rows(fh.read())
    line = [x for x in err.splitlines() if x.startswith("[progressive]")]
    assert line and "converged" in line[-1], err
    print(f"CLI --progressive: {line[-1]}; {batches} batches, accum.step "
          f"{stages.get('accum.step', 0.0) / batches:g} launches and "
          f"{host.get('accum.step', 0.0) / batches:.3f} ms of host a batch, "
          f"fma32 launches {k1}", flush=True)
    assert batches > 0 and k1 == 0, (batches, k1)
    assert stages.get("accum.step", 0.0) <= ACCUM_STEP_LAUNCHES * batches, \
        stages

    px = {}
    for d, n in (("cuda", 60), ("cpu", 2)):
        path = os.path.join(OUT, f"cli_frames_{n}.rgb")
        rc, out, err, _f, _m = _cli(["--mode", "pixels", "--backend",
                                     "raytrace", *CLI_GRID, "--frames",
                                     str(n), "--device", d, "--out", path])
        assert rc == 0 and f"wrote {n} raw frames" in out, out + err
        px[n] = np.fromfile(path, np.uint8)
        if d == "cuda":
            print(f"CLI --mode pixels: {out.strip()}", flush=True)
    f_bytes = px[2].size // 2
    assert f_bytes == 36 * 16 * 96 * 8 * 4 and px[60].size == 60 * f_bytes
    assert np.array_equal(px[60][:2 * f_bytes], px[2]), \
        f"CLI pixels: {int((px[60][:2 * f_bytes] != px[2]).sum())} bytes " \
        f"of the first 2 frames differ from the CPU run"
    print("CLI --mode pixels: the first 2 frames' bytes equal the CPU run",
          flush=True)

    rc, err, dt = _term_pty(["--mode", "term", "--backend", "raster",
                             *CLI_GRID])
    stats = [x for x in err.splitlines() if x.startswith("[termblit")]
    assert rc == 0 and dt < TERM_LIMIT_S and stats, \
        f"CLI --mode term: rc {rc} after {dt:.1f} s\n{err[-2000:]}"
    summary = ast.literal_eval(stats[-1].split("] ", 1)[1])
    assert summary["frames"] > 0, stats[-1]
    print(f"CLI --mode term (raster, w held 2 s, then q): exit 0 after "
          f"{dt:.1f} s, {stats[-1]}", flush=True)

    checks = exactness.run_checks("cuda")
    verdict = exactness.verdict(checks)
    assert verdict == "ok", f"exactness canary: {verdict}"
    print(f"exactness canary on the card: {verdict} {checks}", flush=True)
    print(f"CLI phase: {time.perf_counter() - t_phase:.1f} s", flush=True)

    cfg = Config()
    p = AsciiPass(cfg, device=dev)
    rng = np.random.default_rng(5)
    chars = torch.from_numpy(rng.integers(32, 127, ENTRY_GRID).astype(
        np.uint8)).to(dev)
    tint = torch.from_numpy(rng.integers(0, 256, ENTRY_GRID + (3,)).astype(
        np.uint8)).to(dev)

    def expand():
        p._expand(chars, tint, p.atlas)

    return expand


# --------------------------------------------------------------------------
# The parallel path: the soft-raster train step (config 5), row bands, the
# mesh over a world of one card, dryrun_multichip(1)
# --------------------------------------------------------------------------
CONFIG5_GRID, CONFIG5_STEPS, CONFIG5_LR = (36, 96), 32, 5e-2
# config 5's losses on the card against the CPU, relative: CUDA's exp, log
# and sigmoid round apart from the CPU's, and the gradients' scatter-adds
# (colors[faces], ndc[faces]) are atomics on the card, summed in another
# order. The card's loss at each of its 32 states is held to the CPU's
# loss at that state; the card's run against the CPU's own run of the 32
# steps only for CONFIG5_SAME_STEPS steps: the sphere seen from its
# equator has gradient components that are zero by symmetry and come out
# as rounding noise, whose sign Adam's normalised step turns into +-lr,
# so the two runs separate from step 3 on (this script's first card run:
# relative 4.0e-6 at step 2, 2.9e-4 at step 3, 0.37 at step 25, both
# runs falling 0.212 -> 0.042 / 0.043)
CONFIG5_RTOL, CONFIG5_SAME_STEPS = 1e-5, 2
# the card's gradients at the initial state against the CPU's, as the
# CPU tests hold the port's against JAX's: within 1e-4 x max |g|
CONFIG5_GRAD_TOL = 1e-4
# Adam's trajectory on the card, update by update: tests/test_torch_train
# .py's scene (the bench's uv_sphere(6, 8) moved by seeded noise, 4 views
# above the equator, 16x32, Adam 1e-2), where no gradient is zero by
# symmetry. TRAJ_STEPS single steps on the card; from each card state the
# CPU takes the same step (its own gradients at that state, then
# torch.optim.Adam from the card's moments and step count), and the
# card's next verts and colors are held to it within atol TRAJ_ATOL, its
# loss to the CPU's loss at that state within TRAJ_LOSS_RTOL. That is
# looser than CONFIG5_RTOL because the loss is ill-conditioned at some
# states: moving every vertex one ulp moves the CPU's loss by the same
# order as the card is from it (this script's card runs 5 and 6: the card
# 2.78e-5 from the CPU at step 19, where one ulp of the verts moves the
# CPU's loss 1.70e-5, the most over the 32 states; every other step under
# 2.5e-6); the check prints both. The two whole runs are held together
# for CONFIG5_SAME_STEPS steps only: the scene is sensitive too (the
# CPU's run from the first verts moved one ulp, which this check prints
# beside it, is 2.9e-6 apart in loss at step 3, 1.1e-5 at step 4 and
# 3.4e-2 at step 32), so past a few steps the two runs test the scene,
# not the card
TRAJ_GRID, TRAJ_VIEWS, TRAJ_LR, TRAJ_STEPS, TRAJ_ATOL = \
    (16, 32), 4, 1e-2, 32, 1e-5
TRAJ_LOSS_RTOL = 1e-4
BAND_ROWS = 176  # headline bands: 540 rows hold no TILE_H x n split
PAR_ROWS = 512   # the sharded raster over the world: TILE_H x n divide it


def _config5(device, views=1):
    """bench.py's config 5 (bench_config5): a 36x96 grid, uv_sphere(8, 12)
    (117 vertices, 192 triangles), ``views`` orbit cameras at radius 2.5,
    height 0; targets the soft render of the ground-truth colour (0.9,
    0.2, 0.1) on the CPU. Returns (verts, faces, cameras, targets)."""
    import torch
    from ascii_renderer_tpu_torch.diff.soft_raster import soft_render
    from ascii_renderer_tpu_torch.geom import meshes
    from ascii_renderer_tpu_torch.parallel.mesh import orbit_cameras
    v, f = meshes.uv_sphere(8, 12)
    assert v.shape == (117, 3) and f.shape == (192, 3), (v.shape, f.shape)
    cams = orbit_cameras(views, center=(0, 0, 0), radius=2.5, height=0.0)
    gt = torch.tensor([0.9, 0.2, 0.1]).expand(v.shape)
    targets = soft_render(torch.from_numpy(v), gt, f, cams, *CONFIG5_GRID)
    return v, f, cams, targets


def _perturbed_sphere():
    """tests/test_torch_train.py's scene, targets by the port's soft render
    on the CPU: (verts, colors, faces, cameras, targets)."""
    import numpy as np
    import torch
    from ascii_renderer_tpu_torch.diff.soft_raster import soft_render
    from ascii_renderer_tpu_torch.geom import meshes
    from ascii_renderer_tpu_torch.parallel.mesh import orbit_cameras
    rng = np.random.default_rng(7)
    v, f = meshes.uv_sphere(6, 8)
    v = (v + rng.normal(0, 0.05, v.shape)).astype(np.float32)
    c0 = rng.uniform(0.3, 0.7, v.shape).astype(np.float32)
    gt = rng.uniform(0.1, 0.9, v.shape).astype(np.float32)
    cams = orbit_cameras(TRAJ_VIEWS, center=(0, 0, 0), radius=2.5,
                         height=0.3)
    targets = soft_render(torch.from_numpy(v), torch.from_numpy(gt), f, cams,
                          *TRAJ_GRID)
    return v, c0, f, cams, targets


def _train_loss(verts, colors, f, cams, targets, grid=CONFIG5_GRID,
                grad=False):
    """The train step's loss at (verts, colors) for a mesh of one rank
    (the views' image losses summed) on a ``grid`` (rows, cols), on verts'
    device; with ``grad``, (loss, d loss / d verts, d loss / d colors)."""
    import torch
    from ascii_renderer_tpu_torch.diff.soft_raster import (
        camera_mvps, soft_luminance_loss, soft_render_mvp)
    v = verts.detach().clone().requires_grad_(grad)
    c = colors.detach().clone().requires_grad_(grad)
    img = soft_render_mvp(v, c, torch.as_tensor(f, device=v.device),
                          camera_mvps(cams, *grid), *grid)
    tgt = targets.to(v.device)
    loss = sum(soft_luminance_loss(img[k], tgt[k])
               for k in range(img.shape[0]))
    if not grad:
        return float(loss)
    gv, gc = torch.autograd.grad(loss, (v, c))
    return float(loss.detach()), gv.cpu(), gc.cpu()


def _cpu_state(state):
    """A TrainState's copy on the CPU, Adam's moments and step included."""
    from ascii_renderer_tpu_torch.parallel import train as T
    st = state.opt_state
    return T.TrainState(state.verts.cpu(), state.colors.cpu(), {
        "step": st["step"].clone(),
        "exp_avg": tuple(x.cpu() for x in st["exp_avg"]),
        "exp_avg_sq": tuple(x.cpu() for x in st["exp_avg_sq"])})


def _check_trajectory(dev, tmesh):
    """TRAJ_STEPS train steps on the card from the perturbed sphere, each
    held to the CPU's step from the card's state (TRAJ_* above); the
    CPU's own run of the same steps beside it."""
    import numpy as np
    import torch
    from ascii_renderer_tpu_torch.parallel import train as T
    v, c0, f, cams, targets = _perturbed_sphere()
    step = T.make_train_step(tmesh, torch.as_tensor(f, device=dev),
                             *TRAJ_GRID, optimizer=T.adam(TRAJ_LR))
    tgt = targets.to(dev)

    def cpu_step(st):  # the CPU's loss at st and its Adam step from st
        loss, gv, gc = _train_loss(st.verts, st.colors, f, cams, targets,
                                   TRAJ_GRID, grad=True)
        return T._optimizer_step(T.adam(TRAJ_LR), st, (gv, gc)), loss

    card = T.init_train_state(v, c0, device=dev)
    own = T.init_train_state(v, c0, device="cpu")
    # the scene's own sensitivity: the CPU's run from verts one ulp up
    ulp = T.init_train_state(np.nextafter(v, np.float32(np.inf)), c0,
                             device="cpu")
    losses, d_loss, d_par, own_rel, ulp_rel, ulp_at = [], [], [], [], [], []
    for k in range(TRAJ_STEPS):
        at = _cpu_state(card)
        want, want_loss = cpu_step(at)
        up = torch.from_numpy(np.nextafter(at.verts.numpy(), np.float32(
            np.inf)))
        ulp_at.append(abs(_train_loss(up, at.colors, f, cams, targets,
                                      TRAJ_GRID) - want_loss) / want_loss)
        card, loss = step(card, cams, tgt)
        assert float(card.opt_state["step"]) == k + 1, card.opt_state
        losses.append(float(loss))
        d_loss.append(abs(losses[-1] - want_loss) / want_loss)
        d_par.append(max(float((card.verts.cpu() - want.verts).abs().max()),
                         float((card.colors.cpu() - want.colors).abs().max())))
        own, own_loss = cpu_step(own)
        own_rel.append(abs(losses[-1] - own_loss) / own_loss)
        ulp, ulp_loss = cpu_step(ulp)
        ulp_rel.append(abs(ulp_loss - own_loss) / own_loss)
    worst = int(np.argmax(d_loss))
    print(f"Adam trajectory on the card ({TRAJ_STEPS} steps, perturbed "
          f"sphere {TRAJ_GRID[1]}x{TRAJ_GRID[0]}, {TRAJ_VIEWS} views, Adam "
          f"{TRAJ_LR}): losses {losses[0]:.6f} -> {losses[-1]:.6f}; each "
          f"step from the card's state within {max(d_loss):.2e} (loss, "
          f"relative; step {worst + 1}, where one ulp of the verts moves "
          f"the CPU's loss {ulp_at[worst]:.2e}, at most {max(ulp_at):.2e} "
          f"over the states) and {max(d_par):.2e} (verts and colors) of "
          f"the CPU's step from that state; against the CPU's own run: "
          f"{', '.join(f'{x:.2e}' for x in own_rel)}; the CPU's run from "
          f"verts one ulp up against its own: "
          f"{', '.join(f'{x:.2e}' for x in ulp_rel)}", flush=True)
    assert max(d_loss) <= TRAJ_LOSS_RTOL, d_loss
    assert max(d_par) <= TRAJ_ATOL, d_par
    assert max(own_rel[:CONFIG5_SAME_STEPS]) <= CONFIG5_RTOL, own_rel
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def _bit_equal(a, b):
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


# FP32 operations (a division, an exp, a log or a compare counted as one)
# of X5 (csrc/soft_raster.cu) a (triangle, pixel) term: the forward's
# logit (the edges 21, the barycentrics and margin 11, the coverage 7,
# the renormalisation 12, depth and logit 13), colour 15 and softmax 10;
# the backward needs those 79 again and ~169 of its own (the softmax's
# weight and dot products 21, the coverage and depth 12, the barycentric
# and colour sums 45, the renormalisation and the margin's split 28, the
# edges 42, the vertex sums 12, ~9 more)
SOFT_FWD_OPS, SOFT_BWD_OPS = 89, 248
# X5b's a band pixel: 47 and 17 a ramp entry (the softmax forward and its
# gradient)
SOFT_LOSS_OPS = (47, 17)
# config 5's train step before X5 on the card (PERF.md §5, ROADMAP.md's
# table under "Recent")
CONFIG5_PARENT = "~472 launches a step (15,103 a 32-step call under the " \
    "profiler), busy 4.6-8.1%, 90.8-114.7 steps/s"
# kernel launches config 5's step may make (~472 before X5 and X5b)
CONFIG5_STEP_LAUNCHES = 150


def _soft_inputs(dev, views):
    """Config 5's first train step's X5 and X5b inputs at ``views`` views
    (_config5, colours 0.5): (tv, tc, targets) on ``dev``."""
    import numpy as np
    import torch
    from ascii_renderer_tpu_torch.diff.soft_raster import (camera_mvps,
                                                           soft_triangles)
    v, f, cams, targets = _config5("cpu", views)
    tv, tc = soft_triangles(torch.from_numpy(v),
                            torch.from_numpy(np.full_like(v, 0.5)), f,
                            camera_mvps(cams, *CONFIG5_GRID))
    return tv.to(dev), tc.to(dev), targets.to(dev)


def check_soft_raster(dev):
    """X5's forward and backward and X5b (ops/soft_raster, one launch of
    csrc/soft_raster.cu each) against their plain versions at config 5's
    1- and 4-view shapes (its first step's triangles and targets): rgb
    atol 1e-5 and the statistics (max atol 1e-5, sum rtol 1e-5) against
    soft_raster_fwd_ref on CPU copies; the gradients to the triangles
    within 1e-4 x max |g| of torch.autograd through the chain on the card
    and of soft_raster_bwd_ref, for the loss's own cotangent; the losses
    rtol 1e-5 and their gradient 1e-4 x max |g| against soft_loss_ref.
    Each kernel timed (profiler rows), its plain version on the card's
    tensors beside it. Returns the three records (1 view; the 4-view
    figures as ``*_4``; max_abs_err: rgb's, the gradients' against
    autograd, d loss / d rgb's)."""
    import torch
    from ascii_renderer_tpu_torch.ops import soft_raster as SR
    rows, cols = CONFIG5_GRID
    kw = dict(sigma=1e-2, gamma=1e-2)

    def rel(a, b):
        b = b.cpu().double()
        return float((a.cpu().double() - b).abs().max() / b.abs().max())

    times = {}
    for views in (1, 4):
        tv, tc, tgt = _soft_inputs(dev, views)
        rgb, stats = SR.soft_raster_fwd(tv, tc, rows, cols, **kw)
        want, wstats = SR.soft_raster_fwd_ref(tv.cpu(), tc.cpu(), rows, cols,
                                              **kw)
        e_rgb = float((rgb.cpu() - want).abs().max())
        e_max = float((stats[..., 0].cpu() - wstats[..., 0]).abs().max())
        e_sum = float(((stats[..., 1].cpu() - wstats[..., 1])
                       / wstats[..., 1]).abs().max())
        losses, grad = SR.soft_loss(rgb, tgt, 0)
        wl, wg = SR.soft_loss_ref(rgb.cpu(), tgt.cpu(), 0)
        e_loss, e_lg = float(((losses.cpu() - wl) / wl).abs().max()), rel(
            grad, wg)
        gtv, gtc = SR.soft_raster_bwd(tv, tc, rgb, stats, grad, rows, cols,
                                      **kw)
        tva, tca = tv.clone().requires_grad_(), tc.clone().requires_grad_()
        chain, _l = SR.soft_raster_chain(tva, tca, rows, cols, **kw)
        atv, atc = torch.autograd.grad(chain, (tva, tca), grad)
        rtv, rtc = SR.soft_raster_bwd_ref(tv.cpu(), tc.cpu(), want, wstats,
                                          grad.cpu(), rows, cols, **kw)
        e_bwd = max(rel(gtv, atv), rel(gtc, atc), rel(gtv, rtv),
                    rel(gtc, rtc))
        a_bwd = max(float((g.cpu() - w.cpu()).abs().max())
                    for g, w in ((gtv, atv), (gtc, atc)))
        a_lg = float((grad.cpu() - wg).abs().max())
        print(f"X5 / X5b at config 5, {views} view(s) ({list(tv.shape)} "
              f"triangles, {rows}x{cols}): rgb within {e_rgb:.2e} (atol "
              f"1e-5), max {e_max:.2e}, sum {e_sum:.2e} (relative); "
              f"gradients within {e_bwd:.2e} x max |g| of autograd through "
              f"the chain and of the plain backward; losses {e_loss:.2e} "
              f"(relative), their gradient {e_lg:.2e} x max |g|", flush=True)
        assert bool(torch.isfinite(rgb).all()) and e_rgb <= 1e-5 and \
            e_max <= 1e-5 and e_sum <= 1e-5, (e_rgb, e_max, e_sum)
        assert e_bwd <= 1e-4 and e_loss <= 1e-5 and e_lg <= 1e-4, \
            (e_bwd, e_loss, e_lg)
        P, T = rows * cols, tv.shape[1]
        calls = {
            "soft_raster_fwd": (
                lambda: SR.soft_raster_fwd(tv, tc, rows, cols, **kw),
                lambda: SR.soft_raster_fwd_ref(tv, tc, rows, cols, **kw),
                _bound(_nbytes(tv, tc, rgb, stats),
                       SOFT_FWD_OPS * views * T * P), e_rgb),
            "soft_raster_bwd": (
                lambda: SR.soft_raster_bwd(tv, tc, rgb, stats, grad, rows,
                                           cols, **kw),
                lambda: SR.soft_raster_bwd_ref(tv, tc, rgb, stats, grad, rows,
                                               cols, **kw),
                _bound(_nbytes(tv, tc, rgb, stats, grad, gtv, gtc),
                       SOFT_BWD_OPS * views * T * P), a_bwd),
            "soft_loss": (
                lambda: SR.soft_loss(rgb, tgt, 0),
                lambda: SR.soft_loss_ref(rgb, tgt, 0),
                _bound(_nbytes(rgb, tgt, grad, losses), views * P * (
                    SOFT_LOSS_OPS[0] + 10 * SOFT_LOSS_OPS[1])), a_lg)}
        for name, (fn, plain, bound, err) in calls.items():
            ms = _device_ms(fn, f"{name}_kernel", SR.LAUNCHES_PER_CALL[name])
            times[name, views] = (ms, _event_ms(plain, 10), bound, err)
            print(f"  {name} at {views} view(s): kernel {ms:.5f} ms, plain "
                  f"{times[name, views][1]:.3f} ms on the card, bound "
                  f"{bound[0]:.6f} ms ({bound[1]})", flush=True)
    recs = []
    replaces = {"soft_raster_fwd": "ascii_renderer_tpu/diff/soft_raster.py:30",
                "soft_raster_bwd": "ascii_renderer_tpu/parallel/train.py:80",
                "soft_loss": "ascii_renderer_tpu/diff/soft_raster.py:118"}
    for name in ("soft_raster_fwd", "soft_raster_bwd", "soft_loss"):
        ms, plain, bound, err = times[name, 1]
        rec = _rec(name, "soft_raster.cu", "", err, ms, plain, bound)
        rec["replaces"] = replaces[name]
        ms4, plain4, bound4, err4 = times[name, 4]
        rec.update(shape=[1, *CONFIG5_GRID], ms_4=ms4, plain_ms_4=plain4,
                   bound_ms_4=bound4[0], max_abs_err_4=err4)
        recs.append(rec)
    return recs


def run_parallel_path(dev, soup, scene):
    """The parallel path on the card, in a world of one rank (an NCCL
    group in this process, its FileStore under smoke_out/, torn down at
    the end): config 5 at full size through make_train_steps(n_steps=32)
    on make_mesh((1, 1), ("dp", "sp")): its 32 losses against the port's
    CPU losses at the card's states and, for CONFIG5_SAME_STEPS, the CPU's
    run, within CONFIG5_RTOL, falling; Adam's trajectory on the perturbed
    sphere, each card step held to the CPU's step from the card's state
    (TRAJ_*); 8 timed calls (steps/s) and one profiled; a 4-view step (B
    = 4, dp = 1). Row bands, each the full
    frame's rows bit for bit: the ray tracer's rt_demo frame at 96x36 in
    bands of 12 (the jitted grid with a row offset), the PT demo frame at
    the poster pose (96x36, spp 2, 2 bounces, bands of 12: B5 on band
    uids), the bunny at 960x540 in direct bands of BAND_ROWS rows at
    row_lo 0, 176 and 352 through subtile8 (B2, B3, B1), subtile6 (B3,
    B9f), subtile3 (B7, B9d) and subtile8 with SETUP_PACKED (B10), each
    band's caps those of the full frame, overflow 0; render_rows_sharded
    and render_soup_rows_sharded over make_mesh((1,), ("rows",)) at
    960x512, equal to the local frame, overflow 0. Before the world,
    entry.dryrun_multichip(1) on the card. Returns a function that runs
    one config-5 call (32 steps), one that renders a band of each kind,
    and one that tears the world down (the first needs it)."""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.backends.pathtrace import render_pt
    from ascii_renderer_tpu_torch.backends.raytrace import render_rgb
    from ascii_renderer_tpu_torch.core.config import Config
    from ascii_renderer_tpu_torch.core.frame import Frame
    from ascii_renderer_tpu_torch.entry import dryrun_multichip
    from ascii_renderer_tpu_torch.parallel import train as T
    from ascii_renderer_tpu_torch.parallel.mesh import (
        make_mesh, render_rows_sharded, run_world)
    from ascii_renderer_tpu_torch.parallel.worlds import train_trajectory
    from ascii_renderer_tpu_torch.scene.demo import create_rt_demo_scene
    t_phase = time.perf_counter()
    os.makedirs(OUT, exist_ok=True)

    # the CPU run of config 5 (a gloo world of 1), before the card's group
    v, f, cams, targets = _config5("cpu")
    c0 = np.full_like(v, 0.5)
    rows, cols = CONFIG5_GRID
    cpu = run_world(train_trajectory, 1, "cpu", "cpu", (1, 1), v, c0, f,
                    cams, targets, rows, cols, lr=CONFIG5_LR, n_single=0,
                    n_scan=CONFIG5_STEPS)[0]
    v4, _f, cams4, targets4 = _config5("cpu", views=4)
    cpu4 = run_world(train_trajectory, 1, "cpu", "cpu", (1, 1), v4, c0, f,
                     cams4, targets4, rows, cols, lr=CONFIG5_LR,
                     n_single=1)[0]
    # the multi-device entry on the card (its own world of 1)
    line = dryrun_multichip(1)
    assert line.startswith("dryrun_multichip OK: 1 cuda ranks"), line

    store = os.path.join(OUT, "nccl_store")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        tmesh = make_mesh((1, 1), ("dp", "sp"))
        rmesh = make_mesh((1,), ("rows",))
        faces = torch.as_tensor(f, device=dev)
        opt = T.adam(CONFIG5_LR)
        state0 = T.init_train_state(v, c0, device=dev)
        tgt = targets.to(dev)
        # the gradients at the initial state, card against CPU
        g_cpu = _train_loss(torch.from_numpy(v), torch.from_numpy(c0), f,
                              cams, targets, grad=True)
        g_dev = _train_loss(state0.verts, state0.colors, f, cams, targets,
                              grad=True)
        g_err = [float((a - b).abs().max() / b.abs().max())
                 for a, b in zip(g_dev[1:], g_cpu[1:])]
        assert max(g_err) <= CONFIG5_GRAD_TOL, g_err
        # 32 single steps on the card, keeping each state
        step = T.make_train_step(tmesh, faces, rows, cols, optimizer=opt)
        st, losses, at = state0, [], []
        for _ in range(CONFIG5_STEPS):
            at.append((st.verts.cpu(), st.colors.cpu()))
            st, loss = step(st, cams, tgt)
            losses.append(float(loss))
        losses = np.asarray(losses)
        assert st.verts.device.type == dev.type
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
        # each loss against the CPU's loss at the card's state
        tf = np.asarray([_train_loss(vk, ck, f, cams, targets)
                         for vk, ck in at])
        rel_tf = np.abs(losses - tf) / tf
        # and against the CPU's own run of the 32 steps
        rel = np.abs(losses - cpu["scan_losses"]) / cpu["scan_losses"]
        print(f"config 5 (36x96, 192 triangles, Adam {CONFIG5_LR}, "
              f"{CONFIG5_STEPS} steps): losses {losses[0]:.6f} -> "
              f"{losses[-1]:.6f} (CPU run {cpu['scan_losses'][-1]:.6f}); "
              f"gradients at the initial state within {max(g_err):.2e} x "
              f"max |g| of the CPU's; each loss within {rel_tf.max():.2e} "
              f"(relative) of the CPU's loss at the card's state; against "
              f"the CPU's run: {', '.join(f'{x:.2e}' for x in rel)}",
              flush=True)
        assert rel_tf.max() <= CONFIG5_RTOL, rel_tf
        assert rel[:CONFIG5_SAME_STEPS].max() <= CONFIG5_RTOL, rel
        _check_trajectory(dev, tmesh)
        steps = T.make_train_steps(tmesh, faces, rows, cols,
                                   n_steps=CONFIG5_STEPS, optimizer=opt)
        _s, scan = steps(state0, cams, tgt)
        assert torch.isfinite(scan).all() and float(scan[-1]) < float(
            scan[0])
        ms = []
        for _ in range(8):
            (_out, t) = _event_once(lambda: steps(state0, cams, tgt))
            ms.append(t)
        steps_per_s = 1e3 * CONFIG5_STEPS * len(ms) / sum(ms)
        print(f"config 5: 8 timed calls of {CONFIG5_STEPS} steps (CUDA "
              f"events around each call): median {statistics.median(ms):.3f}"
              f" ms a call, {steps_per_s:.1f} steps/s; each: "
              f"{', '.join(f'{x:.3f}' for x in ms)}", flush=True)
        step4 = T.make_train_step(tmesh, faces, rows, cols,
                                  optimizer=T.adam(CONFIG5_LR))
        _s4, loss4 = step4(T.init_train_state(v4, c0, device=dev), cams4,
                           targets4.to(dev))
        r4 = abs(float(loss4) - cpu4["losses"][0]) / cpu4["losses"][0]
        assert tuple(cams4.yaw.shape) == (4,)
        print(f"config 5, 4 views on one rank (B = 4, dp = 1): loss "
              f"{float(loss4):.6f}, the CPU's {cpu4['losses'][0]:.6f} "
              f"(relative {r4:.2e})", flush=True)
        assert r4 <= CONFIG5_RTOL, r4

        # the ray tracer's rt_demo frame in bands of 12
        cfg = Config(pixel_aspect=PIXEL_ASPECT)
        rts = create_rt_demo_scene().build(device=dev)
        rt_full = render_rgb(rts, rts.camera, 36, 96, PIXEL_ASPECT)
        for lo in (0, 12, 24):
            band = render_rgb(rts, rts.camera, 36, 96, PIXEL_ASPECT,
                              row_lo=lo, n_rows=12)
            assert _bit_equal(band, rt_full[lo:lo + 12]), f"RT band {lo}"
        rt_rows = render_rows_sharded(
            lambda sc, c, lo, nr: render_rgb(sc, c, 36, 96, PIXEL_ASPECT,
                                             row_lo=lo, n_rows=nr),
            rts, rts.camera, rmesh, 36, 96)
        assert _bit_equal(rt_rows, rt_full), "RT render_rows_sharded"
        _glyph(Frame.from_float(rt_full), cfg)
        print("RT rt_demo 96x36: bands of 12 at row_lo 0, 12, 24 and "
              "render_rows_sharded bit for bit the full frame", flush=True)

        # the path tracer's demo frame in bands of 12 (B5 on band uids)
        pts = _pt_scene(device=dev)
        pkw = dict(rows=36, cols=96, pixel_aspect=PIXEL_ASPECT, spp=2,
                   bounces=2, light_color=PT_LIGHT)
        pt_full = render_pt(pts, _pt_camera(), 0.0, 0, **pkw)
        for lo in (0, 12, 24):
            rgb, a = render_pt(pts, _pt_camera(), 0.0, 0, row_lo=lo,
                               n_rows=12, **pkw)
            assert _bit_equal(rgb, pt_full[0][lo:lo + 12]) and torch.equal(
                a, pt_full[1][lo:lo + 12]), f"PT band {lo}"
        n_ov = int(((pt_full[1] >= 2) & (pt_full[1] <= 254)).sum())
        assert n_ov == PT_OVERRIDES, n_ov
        _glyph(Frame.from_float(*pt_full), cfg)
        print(f"PT demo 96x36 spp 2: bands of 12 at row_lo 0, 12, 24 bit for "
              f"bit the full frame, rgb and alpha ({n_ov} overrides)",
              flush=True)

        # the bunny at 960x540 in direct bands, each generation's walk
        p, n, c = (torch.as_tensor(x).to(dev) for x in soup)
        caps = _golden_caps(p.shape[0] // 3)
        cam = _golden_camera()
        for gen, packed in (("subtile8", False), ("subtile6", False),
                            ("subtile3", False), ("subtile8", True)):
            R.SETUP_PACKED = packed
            try:
                full, _d = R.render_soup_diag(p, n, c, scene, cam, ROWS,
                                              COLS, PIXEL_ASPECT,
                                              kernel=gen, **caps)
                counts = []
                for lo in (0, BAND_ROWS, 2 * BAND_ROWS):
                    band, d = R.render_soup_diag(
                        p, n, c, scene, cam, ROWS, COLS, PIXEL_ASPECT,
                        kernel=gen, row_lo=lo, band_rows=BAND_ROWS, **caps)
                    assert _bit_equal(band, full[lo:lo + BAND_ROWS]), \
                        f"{gen} band {lo}"
                    d = {k: int(x) for k, x in d.items()}
                    assert d["n_rows"] <= caps["r_cap"] and d["n_pairs"] \
                        <= caps["pair_cap"] and d["n_tiles_nz"] <= \
                        caps["tile_cap"] and d["n_big"] == 0, (gen, lo, d)
                    counts.append(d["n_pairs"])
            finally:
                R.SETUP_PACKED = False
            print(f"{gen}{' SETUP_PACKED' if packed else ''} {COLS}x{ROWS}: "
                  f"bands of {BAND_ROWS} at row_lo 0, {BAND_ROWS}, "
                  f"{2 * BAND_ROWS} bit for bit the full frame, overflow "
                  f"0, pairs {counts}", flush=True)

        # the sharded forms over the world, at 960x512
        soup_rgb, over = R.render_soup_rows_sharded(
            p, n, c, scene, cam, PAR_ROWS, COLS, PIXEL_ASPECT, rmesh,
            big_cap=0, r_cap=caps["r_cap"], pair_cap=caps["pair_cap"])
        local, _d = R.render_soup_diag(p, n, c, scene, cam, PAR_ROWS, COLS,
                                       PIXEL_ASPECT, kernel="subtile8",
                                       **caps)
        assert int(over.max()) == 0, over.tolist()
        assert _bit_equal(soup_rgb, local), "render_soup_rows_sharded"
        rows_rgb = render_rows_sharded(
            lambda sc, cm, lo, nr: R.render_soup_diag(
                p, n, c, sc, cm, PAR_ROWS, COLS, PIXEL_ASPECT,
                kernel="subtile8", row_lo=lo, band_rows=nr, **caps)[0],
            scene, cam, rmesh, PAR_ROWS, COLS)
        assert _bit_equal(rows_rgb, local), "render_rows_sharded raster"
        print(f"world of 1 (NCCL): render_soup_rows_sharded and "
              f"render_rows_sharded at {COLS}x{PAR_ROWS} bit for bit the "
              f"local frame, overflow {over.tolist()}", flush=True)
    except BaseException:
        dist.destroy_process_group()
        raise
    print(f"parallel phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    def band_frames():
        render_rgb(rts, rts.camera, 36, 96, PIXEL_ASPECT, row_lo=12,
                   n_rows=12)
        render_pt(pts, _pt_camera(), 0.0, 0, row_lo=12, n_rows=12, **pkw)
        R.render_soup_diag(p, n, c, scene, cam, ROWS, COLS, PIXEL_ASPECT,
                           kernel="subtile8", row_lo=BAND_ROWS,
                           band_rows=BAND_ROWS, **caps)

    def train_call():
        return steps(state0, cams, tgt)

    train_call.median_ms = statistics.median(ms)
    train_call.steps_per_s = steps_per_s
    return train_call, band_frames, dist.destroy_process_group


# --------------------------------------------------------------------------
# The path tracer's XLA core: render_pt(use_kernel=False), wide atlases
# --------------------------------------------------------------------------
PT_LIGHT = (16.86, 10.76, 8.2)
WIDE_ATLAS = (512, 256)  # 131,072 texels, above the kernel's 65,536
WIDE_ASSET = os.path.join(ROOT, "assets", "atlas_wide_32x16.bin")


def _override_lines(a):
    """An alpha plane (numpy u8) as the goldens' text: glyph codes of the
    override cells, '.' elsewhere; and the override count."""
    ov = (a >= 2) & (a <= 254)
    return (["".join(chr(c) if (32 <= c <= 126 and o) else "."
                     for c, o in zip(row, orow))
             for row, orow in zip(a, ov)], int(ov.sum()))


def _golden_lines(name):
    with open(os.path.join(ROOT, "tests", "goldens", name)) as fh:
        return fh.read().rstrip("\n").split("\n")


def check_pt_core(dev):
    """The XLA core on the card: both path-tracer goldens through
    render_pt(use_kernel=False) (the demo room with its atlas, 96x36, spp
    2, 2 bounces, key 0: 117 overrides; the wide-atlas quad, 32x16: 27),
    alpha planes exactly; then the core against the megakernel B5 at one
    bounce without NEE on the poster pose's 96x36 rays, 128x64 atlas:
    overrides and fetched flags exactly, radiance within 1e-5."""
    import torch
    from ascii_renderer_tpu_torch.atlas.io import load_atlas
    from ascii_renderer_tpu_torch.backends import pathtrace as PT
    from ascii_renderer_tpu_torch.core.camera import Camera, primary_ray_dirs
    from ascii_renderer_tpu_torch.scene.builder import (MaterialIds,
                                                        SceneBuilder)

    quad = SceneBuilder()
    quad.add_quad([-4, -2, 0], [4, -2, 0], [4, 2, 0], [-4, 2, 0],
                  MaterialIds.WHITE, (0, 16), (32, 16), (32, 0), (0, 0))
    quad.set_area_light([50, 50, 50], 0.1, auto=False)
    quad.set_atlas(load_atlas(WIDE_ASSET, 32, 16, strict=True))
    for label, scene, cam, grid, aspect, golden, want in (
            ("demo room", _pt_scene(device=dev), _pt_camera(), (36, 96), 0.5,
             "pt_demo_override_plane.txt", PT_OVERRIDES),
            ("wide-atlas quad", quad.build(device=dev),
             Camera.create(pos=(0, 0, 2.385), yaw=-math.pi / 2), (16, 32),
             1.0, "pt_wide_atlas_overrides.txt", 27)):
        box = {}
        (ms,) = _timed(lambda: box.update(out=PT.render_pt(
            scene, cam, 0.0, key=(0, 0), rows=grid[0], cols=grid[1],
            pixel_aspect=aspect, spp=2, bounces=2, light_color=PT_LIGHT,
            use_kernel=False)), 1)
        rgb, a = box["out"]
        assert a.device.type == "cuda" and torch.isfinite(rgb).all()
        lines, n_ov = _override_lines(a.cpu().numpy())
        gold = _golden_lines(golden)
        n_diff = sum(x != y for g, w in zip(lines, gold) for x, y in zip(g, w))
        print(f"PT core golden {golden} ({label}): {n_ov} overrides, "
              f"{n_diff} cells differ from the golden, {ms:.1f} ms",
              flush=True)
        assert lines == gold and n_ov == want, (golden, n_ov, n_diff)

    scene = _pt_scene(atlas=(128, 64), device=dev)
    cam = _pt_camera()
    rd = primary_ray_dirs(cam, 36, 96, PIXEL_ASPECT, device=dev)
    ro = cam.pos.to(dev).expand(rd.shape)
    lc, lr = PT.get_light_sphere(scene, 0.0)
    lcol = torch.tensor(PT_LIGHT) * 1.3
    kw = dict(bounces=1, light_color=lcol, nee=False)
    c_lo, c_ov, c_f = PT.trace_eye_paths(scene, ro, rd, (0, 0), lc, lr, **kw)
    k_lo, k_ov, k_f = PT.trace_eye_paths_kernel(scene, ro, rd, 0, lc, lr,
                                                **kw)
    torch.cuda.synchronize()
    err = float((c_lo - k_lo).abs().max())
    print(f"PT core vs B5 at one bounce (96x36, 128x64 atlas): overrides "
          f"{'equal' if torch.equal(c_ov, k_ov) else 'DIFFER'}, fetched "
          f"{'equal' if torch.equal(c_f, k_f) else 'DIFFER'} "
          f"({int(c_f.sum())} fetched), radiance max abs diff {err}",
          flush=True)
    assert torch.equal(c_ov, k_ov) and torch.equal(c_f, k_f)
    assert err <= 1e-5 and int(c_f.sum()) > 0


def run_pt_core_path(dev):
    """The reference app's frame with a wide atlas: the demo room with
    demo_atlas(512, 256) through Renderer(cfg, "pathtrace") (the XLA core:
    the atlas is above the kernel's budget) at 96x36, spp 64, 5 bounces,
    NEE, then the glyph pass. Frame 0's alpha plane must equal the port's
    CPU render; then 10 timed frames. Returns a function rendering one
    frame at the pose."""
    import torch
    from ascii_renderer_tpu_torch.backends.registry import Renderer
    from ascii_renderer_tpu_torch.core import quantize as Q
    from ascii_renderer_tpu_torch.core.config import Config
    cfg = Config()
    alphas = []
    for device in ("cuda", "cpu"):
        r = Renderer(cfg, "pathtrace", device=device)
        r.set_scene(_pt_scene(atlas=WIDE_ATLAS, device=device))
        box = {}
        (ms,) = _timed(lambda: box.update(frame=r.render(0.0, _pt_camera())),
                       1)
        chars = _glyph(box["frame"], cfg)
        assert tuple(chars.shape) == (36, 96)
        alphas.append(box["frame"].a.cpu())
        print(f"PT core wide atlas frame 0 on {device}: {ms:.1f} ms",
              flush=True)
        if device == "cuda":
            gpu = r
    n_ov = int(Q.is_override(alphas[0]).sum())
    assert torch.equal(alphas[0], alphas[1]), \
        f"{int((alphas[0] != alphas[1]).sum())} alpha cells differ from CPU"
    assert n_ov > 100, n_ov
    print(f"PT core wide atlas frame 0: alpha plane equals the CPU render, "
          f"{n_ov} overrides", flush=True)

    def one():
        _glyph(gpu.render(0.0, _pt_camera()), cfg)

    _summary("PT core wide atlas 96x36 spp64 steady (poster pose)",
             _timed(one, 10))
    return one


def _glyph(frame, cfg):
    from ascii_renderer_tpu_torch.ascii.ascii_pass import glyph_decide
    chars, _tint = glyph_decide(
        frame, ramp=cfg.ascii_ramp, mode_on=cfg.ascii_mode_filter,
        mode_radius=cfg.mode_radius, mode_thresh=cfg.ascii_mode_thresh,
        grayscale=cfg.use_grayscale)
    return chars


def _frame(backend, cfg, cam):
    """One user frame: RasterBackend.render, then the glyph pass."""
    frame = backend.render(0.0, cam, ROWS, COLS, PIXEL_ASPECT)
    return frame, _glyph(frame, cfg)


def _moves():
    from ascii_renderer_tpu_torch.core.camera import CameraInputs
    return [CameraInputs.from_keys(("w", "arrowleft")),
            CameraInputs.from_keys(("a",), mouse_dx=25.0),
            CameraInputs.from_keys(("s", "arrowup"), mouse_dy=-10.0)]


def _timed(fn, n):
    import torch
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _summary(label, steady):
    q = statistics.quantiles(steady, n=10)
    print(f"{label}: {len(steady)} timed frames, median "
          f"{statistics.median(steady):.3f} ms, p90 {q[-1]:.3f} ms, min "
          f"{min(steady):.3f} ms; each: "
          f"{', '.join(f'{x:.3f}' for x in steady)}", flush=True)


def run_main_path(dev, soup, scene):
    """RasterBackend + glyph pass: 4 checked frames (the golden pose, then
    3 camera moves), then 20 timed steady-state frames at the golden pose.
    Returns (backend, cfg)."""
    import numpy as np
    import torch
    from ascii_renderer_tpu_torch.backends.raster import RasterBackend
    from ascii_renderer_tpu_torch.core.camera import update_camera
    from ascii_renderer_tpu_torch.core.config import Config

    cfg = Config(pixel_aspect=PIXEL_ASPECT)
    backend = RasterBackend(cfg, device=dev)
    backend.set_soup(*soup, scene)
    cam = _golden_camera()
    moves = _moves()
    for f in range(4):
        if f:
            cam = update_camera(cam, moves[f - 1], 1.0 / 30.0)
        box = {}
        (ms,) = _timed(lambda: box.update(
            zip(("frame", "chars"), _frame(backend, cfg, cam))), 1)
        frame, chars = box["frame"], box["chars"]
        assert chars.device.type == "cuda" and chars.dtype == torch.uint8
        assert tuple(chars.shape) == (ROWS, COLS)
        assert tuple(frame.rgb.shape) == (ROWS, COLS, 3)
        ch = chars.cpu().numpy()
        lit = int((ch != ord("@")).sum())
        assert lit > 20000, f"frame {f}: only {lit} non-background cells"
        if f == 0:
            total = int(ch.astype(np.uint64).sum())
            assert total == BUNNY_CHECKSUM, total
            ds = ["".join(chr(x) for x in row) for row in ch[10::20, 10::20]]
            with open(GOLDEN_DS20) as fh:
                golden = fh.read().rstrip("\n").split("\n")
            bad = [r for r, (a, b) in enumerate(zip(ds, golden)) if a != b]
            assert ds == golden, f"ds20 rows {bad} differ from the golden"
            print(f"raster frame 0: checksum {total} and the ds20 golden, "
                  f"exact", flush=True)
        print(f"raster frame {f}: {ms:.3f} ms, {lit} lit cells, "
              f"caps {backend._caps}", flush=True)
    _summary("raster steady (golden pose)",
             _timed(lambda: _frame(backend, cfg, _golden_camera()), 20))
    return backend, cfg


def pt_frame0_check(dev):
    """A fresh spp-2 / 2-bounce Renderer's frame 0 at the poster pose:
    its alpha plane must equal the port's CPU render (plain versions) of
    the same frame, with PT_OVERRIDES override cells."""
    import torch
    from ascii_renderer_tpu_torch.backends.registry import Renderer
    from ascii_renderer_tpu_torch.core.config import Config, PathTracerConfig
    from ascii_renderer_tpu_torch.core import quantize as Q
    cfg = Config(path_tracer=PathTracerConfig(samples_per_batch=2,
                                              max_bounces=2))
    alphas = []
    for device in (dev, "cpu"):
        r = Renderer(cfg, "pathtrace", device=device)
        r.set_scene(_pt_scene(device=device))
        frame = r.render(0.0, _pt_camera())
        chars = _glyph(frame, cfg)
        assert tuple(chars.shape) == (36, 96)
        alphas.append(frame.a.cpu())
    n_ov = int(Q.is_override(alphas[0]).sum())
    assert torch.equal(alphas[0], alphas[1]), \
        f"{int((alphas[0] != alphas[1]).sum())} alpha cells differ from CPU"
    assert n_ov == PT_OVERRIDES, n_ov
    print(f"PT frame 0 (spp 2, 2 bounces): alpha plane equals the CPU "
          f"render, {n_ov} overrides", flush=True)


def run_pt_path(cfg, rows, cols, n_checked, n_timed, label):
    """Renderer(cfg, "pathtrace") on the demo scene + glyph pass: n_checked
    frames (the poster pose, then camera moves), then n_timed frames at the
    pose. Returns a function that renders one frame at the pose."""
    import torch
    from ascii_renderer_tpu_torch.backends.registry import Renderer
    from ascii_renderer_tpu_torch.core import quantize as Q
    from ascii_renderer_tpu_torch.core.camera import update_camera

    # as a user calls it: the renderer and the scene on their default
    # device, the card
    r = Renderer(cfg, "pathtrace")
    r.set_scene(_pt_scene())
    cam = _pt_camera()
    moves = _moves()
    for f in range(n_checked):
        if f:
            cam = update_camera(cam, moves[f - 1], 1.0 / 30.0)
        box = {}
        (ms,) = _timed(lambda: box.update(frame=r.render(0.0, cam, rows,
                                                          cols)), 1)
        frame = box["frame"]
        chars = _glyph(frame, cfg)
        torch.cuda.synchronize()
        assert chars.device.type == "cuda" and chars.dtype == torch.uint8
        assert tuple(chars.shape) == (rows, cols)
        n_ov = int(Q.is_override(frame.a).sum())
        kinds = int(torch.unique(chars).numel())
        mean = float(frame.rgb.double().mean())
        assert kinds >= 4 and 5.0 < mean < 250.0, (kinds, mean)
        if f == 0:
            assert n_ov > (rows * cols) // 40, f"{label}: {n_ov} overrides"
        print(f"{label} frame {f}: {ms:.3f} ms, {n_ov} overrides, {kinds} "
              f"distinct glyphs, mean byte {mean:.2f}", flush=True)
    pose = _pt_camera()

    def one():
        _glyph(r.render(0.0, pose, rows, cols), cfg)

    _summary(f"{label} steady (poster pose)", _timed(one, n_timed))
    return lambda: one()


# the CUDA runtime calls that put a kernel, a copy or a fill on a stream
_LAUNCH_CALL = re.compile(r"^cuda(Launch\w*Kernel\w*|Memcpy\w*|Memset\w*)$")


def _stage_launches(prof, prefixes, n):
    """Kernel launches a frame inside each stage, counted twice: the
    kernels (and copies) whose device interval lies within one of the
    stage's spans on the device (its annotation, from its first kernel to
    its last), and the runtime calls that launch a kernel, a copy or a
    fill within one of the stage's host ranges. The profiler can drop a
    frame's device annotation (then the first count misses that frame's
    launches) or a runtime call's record (then the second does); neither
    counts a launch of another stage, so the larger is the stage's count.
    Where they differ, both are printed. Also, as "<stage> HtoD" and
    "<stage> DtoH", the copies each way among the first count's."""
    from torch.autograd import DeviceType
    spans, ranges, kernels, calls = {}, {}, [], []
    for e in prof.events():
        r = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CPU:
            if e.name.startswith(prefixes):
                ranges.setdefault(e.name, []).append(r)
            elif _LAUNCH_CALL.match(e.name):
                calls.append(r)
        elif e.device_type != DeviceType.CUDA:
            continue
        elif e.name.startswith(prefixes):
            spans.setdefault(e.name, []).append(r)
        elif "spin_kernel" not in e.name:
            kernels.append((*r, "Memcpy HtoD" in e.name,
                            "Memcpy DtoH" in e.name))
    out = {}
    for name in sorted(set(spans) | set(ranges)):
        inside = [(h, d) for a, b, h, d in kernels
                  for lo, hi in spans.get(name, ())
                  if lo <= a and b <= hi]
        issued = sum(1 for a, b in calls for lo, hi in ranges.get(name, ())
                     if lo <= a and b <= hi)
        if issued != len(inside):
            print(f"  stage {name}: {len(inside)} launches in its device "
                  f"spans ({len(spans.get(name, ()))}), {issued} launch "
                  f"calls in its host ranges ({len(ranges.get(name, ()))}) "
                  f"over {n} frames", flush=True)
        out[name] = max(len(inside), issued) / n
        out[f"{name} HtoD"] = sum(h for h, _d in inside) / n
        out[f"{name} DtoH"] = sum(d for _h, d in inside) / n
    return out


# kernel launches pt.setup may make on a frame that is not compacted: the
# ray counters' fill (the light and the camera position go by value)
PT_SETUP_LAUNCHES = 1


def pt_stages(label, stages, n_batches):
    """A kernel-path PT frame's stage launches (profile_frames' stage
    counts): pt.rays is X7 once for the probe and once a batch, pt.trace
    B5 likewise, pt.reduce X14 once a batch; pt.setup (the frame's ray
    counters; the paths it is asked for are not compacted) at most
    PT_SETUP_LAUNCHES; no copy either way in pt.setup and pt.rays."""
    want = {"pt.rays": 1 + n_batches, "pt.trace": 1 + n_batches,
            "pt.reduce": n_batches}
    got = {k: stages.get(k, 0.0) for k in want}
    setup = stages.get("pt.setup", 0.0)
    copies = sum(stages.get(f"{st} {way}", 0.0) for st in ("pt.setup",
                                                           "pt.rays")
                 for way in ("HtoD", "DtoH"))
    print(f"{label}: kernel launches a frame by stage {json.dumps(got)}, "
          f"pt.setup {setup:g} ({copies:g} copies either way in pt.setup "
          f"and pt.rays; {n_batches} batches)", flush=True)
    assert got == want, (label, got, want)
    assert setup <= PT_SETUP_LAUNCHES and copies == 0, (label, setup, copies)


def profile_frames(frame_fn, n, prefixes, label):
    """torch.profiler over n frames: per-stage host and device ms and
    kernel launches per frame (the record_function ranges), the device's
    busy share of the wall time, and the top kernels. The full table goes
    to smoke_out/. Returns (device busy ms, kernel launches, {stage:
    kernel launches}, {stage: host ms}) a frame."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            frame_fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    avgs = prof.key_averages()
    # a stage appears twice: its host range (CPU) and its span on the
    # device stream (a CUDA annotation, gaps included); kernels are the
    # other CUDA rows
    spans = {e.key: e.device_time_total / n / 1e3 for e in avgs
             if e.device_type == DeviceType.CUDA
             and e.key.startswith(prefixes)}
    kern = sorted((e for e in avgs if e.device_type == DeviceType.CUDA
                   and not e.key.startswith(prefixes)),
                  key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kern) / n / 1e3
    launches = sum(e.count for e in kern) // n
    stage_launches = _stage_launches(prof, prefixes, n)
    print(f"{label} profile: {wall:.3f} ms/frame under the profiler, device "
          f"busy {busy:.3f} ms/frame ({100 * busy / wall:.1f}%), "
          f"{launches} kernel launches/frame", flush=True)
    stage_host = {}
    for e in sorted(avgs, key=lambda e: -e.cpu_time_total):
        if e.device_type == DeviceType.CPU and e.key.startswith(prefixes):
            stage_host[e.key] = e.cpu_time_total / n / 1e3
            print(f"  stage {e.key}: host {stage_host[e.key]:.3f} "
                  f"ms, device span {spans.get(e.key, 0.0):.3f} ms, "
                  f"{stage_launches.get(e.key, 0.0):g} launches", flush=True)
    for e in kern[:8]:
        print(f"  kernel {e.key[:60]}: {e.self_device_time_total / n / 1e3:.3f}"
              f" ms/frame, {e.count // n} launches/frame", flush=True)
    os.makedirs(OUT, exist_ok=True)
    name = label.replace(" ", "_").replace(",", "")
    with open(os.path.join(OUT, f"profile_{name}.txt"), "w") as fh:
        fh.write(avgs.table(sort_by="self_device_time_total", row_limit=200))
    return busy, launches, stage_launches, stage_host


# kernel launches a headline frame may make (30 before K2's image form)
HEADLINE_FRAME_LAUNCHES = 18


def shade_stages(label, stages):
    """A grouped frame's shade and assembly (profile_frames' stage counts,
    per call): one launch of K2's image form in raster.shade, none in
    raster.assemble."""
    got = (stages.get("raster.shade", 0.0), stages.get("raster.assemble",
                                                       0.0))
    print(f"{label}: raster.shade {got[0]:g}, raster.assemble {got[1]:g} "
          f"kernel launches", flush=True)
    assert got == (1.0, 0.0), (label, got)


def compose_stage(label, stages):
    """A frame step's frame.compose: one launch (X12a's UI form) and no
    host-to-device copy (profile_frames' stage counts, after its first
    frame)."""
    got = (stages.get("frame.compose", 0.0),
           stages.get("frame.compose HtoD", 0.0))
    print(f"{label}: frame.compose {got[0]:g} kernel launches, {got[1]:g} "
          f"host-to-device copies", flush=True)
    assert got == (1.0, 0.0), (label, got)


# the host stages the glyph tail and the camera chains take on each path
TAIL_STAGES = ("raster.mvp", "rt.grid", "frame.from_float", "frame.compose",
               "glyph")


def tail_stages(label, prof, counters, fn):
    """Print the host ms and kernel launches a frame of TAIL_STAGES from a
    profile_frames result ``prof`` of ``fn``, and the launches from float
    rgb to chars in one call of fn (X12a, B4's chars form, glyph_map);
    those must be GLYPH_LAUNCHES, and the glyph stage one launch. Returns
    {stage: (host ms, launches)}."""
    launches, host = prof[2], prof[3]
    out = {k: (host[k], launches.get(k, 0.0)) for k in TAIL_STAGES
           if k in host}
    n = _tail_counts(counters, fn)
    print(f"{label} stages a frame: " + "; ".join(
        f"{k} host {ms:.3f} ms, {ln:g} launches"
        for k, (ms, ln) in out.items()) + f"; float rgb to chars {n} "
        f"launches", flush=True)
    assert n == GLYPH_LAUNCHES, (label, n)
    assert out["glyph"][1] == 1, (label, out)
    return out


# --------------------------------------------------------------------------
# Small- and mid-scale raster: the bin walks B6 / B6', the packs B7 / B7'
# --------------------------------------------------------------------------
TEAPOT_GRID, MID_GRID, CUBE_GRID, ENTRY_GRID = (135, 240), (540, 960), \
    (24, 80), (36, 96)
GOLDEN_CUBE = os.path.join(ROOT, "tests", "goldens", "raster_cube.txt")
# B6 operations per (entry, pixel): four planes at a product, a fused
# multiply-add (2) and an add each, five inside / depth tests, one compare
B6_OPS = 4 * 4 + 5 + 1


def _room(dev, point_light=False):
    """The demo room of entry(): scene (atlas, env light; a point light
    added if asked) and its soup."""
    import torch
    from ascii_renderer_tpu_torch.atlas.io import demo_atlas
    from ascii_renderer_tpu_torch.geom.tessellate import tessellate_scene
    from ascii_renderer_tpu_torch.scene.demo import create_demo_scene
    sb = create_demo_scene()
    sb.set_atlas(demo_atlas())
    sb.set_env_light([0.25, 0.27, 0.3], 1.0)
    if point_light:
        sb.add_point_light([1.0, 2.0, 1.0], [1.0, 0.9, 0.8], 1.0)
    scene = sb.build(device=dev)
    return scene, tuple(torch.from_numpy(x).to(dev)
                        for x in tessellate_scene(scene))


def _mesh(name):
    """Soup of bench config 1 (cube), config 2 (teapot) or the mid-scale HD
    arm (bunny-class, 14,884 triangles), and its camera."""
    import numpy as np
    from ascii_renderer_tpu_torch.core.camera import Camera
    from ascii_renderer_tpu_torch.geom import meshes
    if name == "cube":
        v, i = meshes.cube(2.0)
        soup = meshes.mesh_to_soup(v, i, color=(0.85, 0.85, 0.85),
                                   smooth=False)
        return soup, Camera.create(pos=(2.2, 1.8, 3.2), yaw=float(
            np.arctan2(-3.2, -2.2)), pitch=-0.42)
    if name == "teapot":
        v, i = meshes.teapot_like(1024)
        soup = meshes.mesh_to_soup(v, i, color=(0.9, 0.9, 0.9))
        return soup, Camera.create(pos=(1.9, 1.3, 2.7), yaw=float(
            np.arctan2(-2.7, -1.9)), pitch=-0.4)
    v, i = meshes.bunny_like(15000)
    return meshes.mesh_to_soup(v, i, color=(0.8, 0.78, 0.75)), \
        _golden_camera()


def _cube_scene(dev):
    from ascii_renderer_tpu_torch.scene.builder import SceneBuilder
    sb = SceneBuilder().set_env_light([0.2, 0.22, 0.25], 1.0)
    sb.add_dir_light([-0.5, -0.7, -0.6], [1, 1, 1], 0.9)
    return sb.build(device=dev)


def _scatter_ch(positions, cam, rows, cols):
    """The clip channels render_soup's binned walks take."""
    from ascii_renderer_tpu_torch.backends import raster as R
    mvp = R.camera_mvp(cam, rows, cols, PIXEL_ASPECT)
    return R.setup_screen_channels(R.transform_clip_channels(positions, mvp),
                                   rows, cols)


def _mid_prep(soup, scene, cam, rows, cols):
    """The compacted channels and plane channels of the mid-scale path at
    the caps RasterBackend settles on after frame 0 (suggest_caps of its
    counts). Returns (cch, plane channels, caps)."""
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.backends import raster_channels as RC
    p, n, c = soup
    mvp = R.camera_mvp(cam, rows, cols, PIXEL_ASPECT)
    ch = R.setup_screen_channels(R.transform_clip_channels9(
        R.positions_to_pos9(p), mvp), rows, cols)
    n2t = p.shape[0] // 3 * 2
    cch, _cidx, n_valid = R.compact_valid_ch(dict(ch), n2t)
    _small, n_big = R.count_big_small(cch, rows, cols)
    caps = R.suggest_caps(int(n_valid), int(n_big))
    cch, cidx, _n = R.compact_valid_ch(dict(ch), caps[0])
    parts = [n, c] + ([p] if scene.pt_pos.shape[0] else [])
    slots = R.clip_attrs_compact_lists(torch.cat(parts, dim=1), ch, cidx)
    return cch, RC.plane_channels(cch, slots), caps


def _random_bins(dev):
    """Random plane entries over a 3 x 2 tile grid (row-major [P, 16]) and
    offsets: an empty bin, bins across the 128- and 256-entry chunks,
    near-clip coefficients up to 1e10, depth ties inside a chunk and
    across a chunk boundary, 20% invalid entries (tested by B6' only)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(7)
    sizes = (0, 300, 129, 1, 256, 57)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    P = int(offs[-1])
    tile = np.repeat(np.arange(6), sizes)
    cx = (tile % 3) * 128 + rng.uniform(-20, 148, P)
    cy = (tile // 3) * 8 + rng.uniform(-2, 10, P)
    ent = np.zeros((P, 16), np.float32)
    for k in range(3):
        ang = rng.uniform(0, 2 * np.pi, P)
        a = np.cos(ang) * rng.uniform(0.05, 40, P)
        b = np.sin(ang) * rng.uniform(0.05, 40, P)
        huge = rng.random(P) < 0.15
        a, b = np.where(huge, a * 3e8, a), np.where(huge, b * 3e8, b)
        g = -(a * (cx + rng.uniform(-40, 40, P))
              + b * (cy + rng.uniform(-6, 6, P)))
        ent[:, 3 * k:3 * k + 3] = np.stack([a, b, g], -1)
    zx, zy = rng.normal(size=P) * 2e-3, rng.normal(size=P) * 2e-2
    ent[:, 9:12] = np.stack([zx, zy, rng.uniform(-0.1, 1.1, P) - zx * cx
                             - zy * cy], -1)
    ent[:, 12] = (rng.random(P) >= 0.2).astype(np.float32)
    ent[:, 13] = np.concatenate([np.sort(rng.choice(100000, s, replace=False))
                                 for s in sizes]).astype(np.float32)
    tie = np.nonzero(rng.random(P) < 0.3)[0]
    tie = tie[(tie > 0) & (tile[tie] == tile[np.maximum(tie - 1, 0)])]
    ent[tie, 9:12] = ent[tie - 1, 9:12]
    ent[offs[1] + 128, 9:12] = ent[offs[1] + 127, 9:12]
    pad = (-(P + 256)) % 128 + 256
    ent = np.concatenate([ent, np.zeros((pad, 16), np.float32)])
    data = torch.from_numpy(ent).to(dev)
    mm = data.reshape(-1, 128, 16).transpose(1, 2).contiguous()
    loop = data.reshape(-1, 128)
    return {"mm": mm, "loop": loop}, torch.from_numpy(offs).to(dev), 3, 6


def _walk_chans(dev, room, cube, mid_preps):
    """(label, (rows, cols), channel dict) of every call the binned paths
    make of binned_entries: the entry() room's and the cube's uncompacted
    clip dicts, the teapot's and the mid-scale HD arm's compacted ones."""
    import torch
    scene, soup = room
    cube_p = torch.from_numpy(cube[0][0]).to(dev)
    chans = [("demo room 96x36", ENTRY_GRID,
              _scatter_ch(soup[0], scene.camera, *ENTRY_GRID)),
             ("cube 80x24", CUBE_GRID,
              _scatter_ch(cube_p, cube[1], *CUBE_GRID))]
    return chans + [(label, grid, cch) for label, grid, (cch, _pc, _caps)
                    in mid_preps]


def _walk_inputs(dev, room, cube, mid_preps):
    """(label, {"mm": data, "loop": data}, offsets, tiles_x, n_tiles) for
    every shape the binned paths give the walks."""
    from ascii_renderer_tpu_torch.backends import raster_channels as RC
    out = []
    for label, grid, ch in _walk_chans(dev, room, cube, mid_preps):
        data = {}
        for kern in ("mm", "loop"):
            data[kern], offs, tiles_x, n_tiles = RC.binned_entries(
                dict(ch), *grid, kernel=kern)
        out.append((label, data, offs, tiles_x, n_tiles))
    out.append(("random entries", *_random_bins(dev)))
    return out


# the calls X9 is timed at: the entry() step's and the mid-scale HD arm's
# (the record)
X9_TIMED = ("demo room 96x36", "mid-scale HD 960x540")


def check_bin_entries(dev, room, cube, mid_preps):
    """X9, the bin walk's entries (ops/bin_entries: four launches, the
    keys' sort a counting sort), against its plain version (the torch
    chain tile_pairs, plane_entries, the gather) at every call of the
    binned paths (_walk_chans) and at a seeded 60,000-triangle soup at the
    near plane (480x270, the clip dict uncompacted), in both layouts:
    entries (NaN in the same places), offsets, tiles_x and n_tiles bit for
    bit. Timed (kernel rows over 50 calls; the whole call, sort included,
    by CUDA events) at the entry() room's and the mid-scale HD arm's calls
    in walk "mm"'s layout. Returns the record, at the mid-scale HD arm."""
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.ops import bin_entries as BE
    from ascii_renderer_tpu_torch.tools.xla_inputs import front_inputs
    p, _a, mvp = front_inputs(60000, 16, dev, *ROWS_COLS_FRONT)
    calls = _walk_chans(dev, room, cube, mid_preps) + [(
        "near-plane soup 60,000 triangles", ROWS_COLS_FRONT,
        R.clip_screen_channels(p, mvp, *ROWS_COLS_FRONT))]
    rec = None
    for label, grid, ch in calls:
        T = ch["valid"].shape[0]
        for kern in ("mm", "loop"):
            def fn(ch=ch, grid=grid, kern=kern):
                return BE.binned_entries(dict(ch), *grid, kernel=kern)
            got = fn()
            want = BE.binned_entries_ref(dict(ch), *grid, kernel=kern)
            torch.cuda.synchronize()
            _same_bits(got[0], want[0], f"X9 {kern} {label}: entries")
            assert torch.equal(got[1], want[1]), f"X9 {kern} {label}: bins"
            assert got[2:] == want[2:], (label, got[2:], want[2:])
            n_tiles = got[3]
            P = 4 * T + 64 * n_tiles
            walked = int(got[1][-1])
            print(f"X9 {kern} {label}: exact, {T} triangle slots, {P} "
                  f"pairs ({walked} in bins), {n_tiles} tiles", flush=True)
            if kern != "mm" or label not in X9_TIMED:
                continue
            n_launch = BE.last_launches  # the form the launch took
            ms = _device_ms(fn, "bin_", n_launch)
            call = _event_ms(fn, 20)
            plain = _event_ms(lambda: BE.binned_entries_ref(
                dict(ch), *grid, kernel=kern), 3)
            # the screen channels and flags read once, the keys, the
            # source rows, the entries and the offsets written once; ~60
            # float operations a triangle
            bound = _bound(37 * T + 4 * P + 64 * (T + 1) + _nbytes(*got[:2]),
                           60 * T)
            print(f"X9 {label}: kernels {ms:.5f} ms ({n_launch} launches, "
                  f"form {BE.auto_form(n_tiles, P)}), the whole call "
                  f"{call:.5f} ms, plain {plain:.3f} ms, bound "
                  f"{bound[0]:.5f} ms ({bound[1]})", flush=True)
            if label.startswith("mid-scale"):
                rec = _rec("bin_entries", "bin_entries.cu", "", 0.0, ms,
                           plain, bound)
                rec.update(replaces="ascii_renderer_tpu/backends/"
                           "raster_channels.py:546", call_ms=call,
                           slots=T, pairs=P)
    return rec


# --------------------------------------------------------------------------
# X13, the stable partition: the mid raster path's compaction (its
# channels form) and the path tracer's compacted stream (its order form)
# --------------------------------------------------------------------------
# kernel launches raster.compact may make a frame (X13: one at every
# size), the mid HD arm's raster.shade (X3, K2 and the pixel centres'
# four), and pt.setup under compaction (X13, which zeroes the ray
# counters in its launch)
RASTER_COMPACT_LAUNCHES = 1
MID_SHADE_LAUNCHES = 6
PT_SETUP_COMPACTED_LAUNCHES = 1


def _x13_chan_bound(n, kept, v_cap):
    """The channels form's least time: a flag read (1 byte), a kept slot's
    13 channels read (52), a v_cap row written (52 of channels, the id
    and the flag: 57), the count."""
    return _bound(n + 52 * kept + 57 * v_cap + 4, 0)


def _x13_order_bound(n, n_gates, nzero=0):
    """The order form's least time: a flag read, a slot and a uid written
    (8 bytes) a flag, the gates, the zeroed buffer and the count."""
    return _bound(9 * n + 4 * (n_gates + nzero) + 4, 0)


def _x13_chan_size(a, k):
    """X13's channels form's launch size: flags, v_cap (None where nothing
    launches)."""
    valid = a[0]["valid"]
    if valid.device.type != "cuda":
        return None
    return (valid.shape[0], a[1], "channels form")


def _x13_order_size(a, k):
    """X13's order form's launch size: flags, samples, a zeroed buffer's
    ints (None where nothing launches)."""
    if a[0].device.type != "cuda":
        return None
    zero = k.get("zero")
    return (a[0].numel(), a[2], 0 if zero is None else zero.numel(),
            "order form")


def _x13_chan_size_bound(a, k):
    n, v_cap = _x13_chan_size(a, k)[:2]
    kept = min(int(a[0]["valid"].sum()), v_cap)
    return _x13_chan_bound(n, kept, v_cap)[0]


def _x13_order_size_bound(a, k):
    n, samples, nzero = _x13_order_size(a, k)[:3]
    ray_block = 1024  # rays a gate covers (ops/partition.RAY_BLOCK)
    n_gates = -(-n // ray_block) + (0 if samples == 1
                                    else -(-samples * n // ray_block))
    return _x13_order_bound(n, n_gates, nzero)[0]


def _partition_chan_calls(dev, soup, scene, caps, mid_preps):
    """{label: (channel dict, v_cap)} of compact_valid_ch's callers: the
    teapot's and the mid HD arm's X4 dicts at their steady caps, and the
    subtile golden call's (captured from its frame)."""
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.ops import partition as PTN
    calls = {}
    for (label, grid, prep), name in zip(mid_preps, ("teapot", "mid")):
        msoup, mcam = _mesh(name)
        p = torch.from_numpy(msoup[0]).to(dev)
        mvp = R.camera_mvp(mcam, *grid, PIXEL_ASPECT)
        calls[label] = (R.clip_screen_channels(
            None, mvp, *grid, pos9=R.positions_to_pos9(p)), prep[2][0])
    a, _k = _capture(PTN, "compact_channels", _oracle_frame(
        dev, soup, scene, "subtile", caps["subtile"]))
    calls["subtile golden call"] = (dict(a[0]), a[1])
    return calls


def _partition_masks(dev):
    """{label: (flag mask, uid0, samples)} of the order form: the
    progressive tracer's own masks at 96x36 (spp 64, a converging batch's)
    and 960x540 (spp 8, its eighth batch's), captured from stable_order,
    and all, none and one pixel active at both sizes."""
    import torch
    from ascii_renderer_tpu_torch.core.config import Config, PathTracerConfig
    from ascii_renderer_tpu_torch.ops import partition as PTN
    masks = {}
    for rows, cols, spp, steps in ((36, 96, 64, 6), (ROWS, COLS, 8, 8)):
        cfg = Config(path_tracer=PathTracerConfig(samples_per_batch=spp))
        tr = _progressive_tracer(dev, cfg, rows, cols, True)
        seen = _capture_all(PTN, "stable_order", lambda: [
            tr.step(_pt_camera()) for _ in range(steps)])
        act = seen[-1][0][0].clone()
        masks[f"progressive {cols}x{rows}"] = (act, 0, spp)
        for kind in ("all", "none", "one"):
            m = torch.zeros_like(act) if kind != "all" else \
                torch.ones_like(act)
            if kind == "one":
                m.view(-1)[m.numel() // 3] = True
            masks[f"{kind} active {cols}x{rows}"] = (m, 0, spp)
    return masks


def check_partition(dev, soup, scene, caps, mid_preps):
    """X13 (ops/partition) against its plain versions on the same CUDA
    tensors, bit for bit: the channels form at the teapot's, the mid HD
    arm's and the subtile golden call's compact_valid_ch inputs (every
    channel's bits, valid, cidx, n_valid), the order form at the
    progressive tracer's masks at 96x36 and 960x540 and all / none / one
    active (slot, pix_uid, the gates of 1 and of the batch's samples).
    Timed (kernel rows over 50 calls, launches_of(n) = 1 a call: the
    profile's row count checks it) with the plain version's time (CUDA
    events) and, for the order form, one torch.argsort of the inverted
    flags (stable: the same order, checked).
    Returns the records: the channels form at the mid HD arm, the order
    form at the progressive HD mask."""
    import torch
    from ascii_renderer_tpu_torch.ops import partition as PTN
    times = {}
    for label, (ch, v_cap) in _partition_chan_calls(
            dev, soup, scene, caps, mid_preps).items():
        n = ch["valid"].shape[0]

        def fn(ch=ch, v_cap=v_cap):
            return PTN.compact_channels(dict(ch), v_cap)
        got = fn()
        want = PTN.compact_channels_ref(dict(ch), v_cap)
        torch.cuda.synchronize()
        for k in PTN.COMPACT_KEYS:
            _same_bits(got[0][k], want[0][k], f"X13 {label}: {k}")
        assert torch.equal(got[0]["valid"], want[0]["valid"]), label
        assert torch.equal(got[1], want[1]), f"X13 {label}: cidx"
        n_valid = int(got[2])
        assert n_valid == int(want[2]), (label, n_valid, int(want[2]))
        kept = min(n_valid, v_cap)
        assert PTN.launches_of(n) == 1, (label, n)
        ms = _device_ms(fn, "partition_", PTN.launches_of(n))
        plain = _event_ms(lambda: PTN.compact_channels_ref(dict(ch), v_cap),
                          5)
        bound = _x13_chan_bound(n, kept, v_cap)
        times[label] = (ms, plain, bound)
        print(f"X13 channels form, {label}: bit-identical; {n} flags "
              f"({n_valid} valid), v_cap {v_cap}; kernel {ms:.5f} ms "
              f"({PTN.launches_of(n)} launches), plain {plain:.3f} ms, "
              f"bound {bound[0]:.5f} ms ({bound[1]})", flush=True)
    label = "mid-scale HD 960x540"
    rec = _rec("partition", "partition.cu", "", 0.0, *times[label])
    rec.update(replaces="ascii_renderer_tpu/backends/raster_channels.py:325",
               form="channels", call=label, by_call={
                   k: dict(ms=v[0], plain_ms=v[1], bound_ms=v[2][0])
                   for k, v in times.items()})
    otimes = {}
    for label, (act, uid0, samples) in _partition_masks(dev).items():
        flags = act.reshape(-1)
        n = flags.numel()

        def fo(flags=flags, uid0=uid0, samples=samples):
            return PTN.stable_order(flags, uid0, samples)
        slot, uid, gates = fo()
        w_slot, w_uid, w_gates = PTN.stable_order_ref(flags, uid0, samples)
        torch.cuda.synchronize()
        assert torch.equal(slot, w_slot) and torch.equal(uid, w_uid), label
        assert set(gates) == set(w_gates), label
        for s in gates:
            assert torch.equal(gates[s], w_gates[s]), (label, s)
        inv = (~flags).view(torch.uint8)
        lib_order = torch.argsort(inv, stable=True)
        assert torch.equal(lib_order.to(torch.int32), slot), label
        assert PTN.launches_of(n) == 1, (label, n)
        ms = _device_ms(fo, "partition_", PTN.launches_of(n))
        plain = _event_ms(lambda: PTN.stable_order_ref(flags, uid0, samples),
                          5)
        lib = _event_ms(lambda: torch.argsort(inv, stable=True), 20)
        bound = _x13_order_bound(n, sum(g.numel()
                                        for g in set(gates.values())))
        otimes[label] = (ms, plain, bound, lib)
        print(f"X13 order form, {label}: bit-identical; {n} pixels "
              f"({int(flags.sum())} active), gates of 1 and {samples} "
              f"samples; kernel {ms:.5f} ms ({PTN.launches_of(n)} launches), "
              f"plain {plain:.3f} ms, argsort {lib:.5f} ms, bound "
              f"{bound[0]:.5f} ms ({bound[1]})", flush=True)
    label = f"progressive {COLS}x{ROWS}"
    ms, plain, bound, lib = otimes[label]
    orec = _rec("partition_order", "partition.cu", "", 0.0, ms, plain, bound,
                library_ms=lib)
    orec.update(replaces="ascii_renderer_tpu/backends/pathtrace.py:524",
                form="order", call=label, by_call={
                    k: dict(ms=v[0], plain_ms=v[1], bound_ms=v[2][0],
                            library_ms=v[3]) for k, v in otimes.items()})
    return [rec, orec]


def partition_stages(label, stages, stage, most):
    """A frame's launches in ``stage`` (profile_frames' stage counts): at
    least one (X13's) and at most ``most``, and no copy either way."""
    got = stages.get(stage, 0.0)
    copies = (stages.get(f"{stage} HtoD", 0.0),
              stages.get(f"{stage} DtoH", 0.0))
    print(f"{label}: {stage} {got:g} kernel launches, {copies[0]:g} "
          f"host-to-device and {copies[1]:g} device-to-host copies",
          flush=True)
    assert 0 < got <= most and copies == (0.0, 0.0), (label, stage, got,
                                                      copies)


# --------------------------------------------------------------------------
# X9's bin keys and X10, the grouped generations' raster.keys and
# raster.build
# --------------------------------------------------------------------------
# kernel launches a headline frame's raster.keys (X9: four) and
# raster.build (X10: two, with X9's offsets) may make
RASTER_KEYS_LAUNCHES = 5
RASTER_BUILD_LAUNCHES = 2


def _record_keys_builds(run):
    """Run ``run()`` recording the arguments of every call of X9's bin keys
    (ops/bin_entries.pair_keys) and of X10 (ops/group_build.build_rows):
    (keys calls, build calls), each a list of (args, kwargs)."""
    from ascii_renderer_tpu_torch.ops import bin_entries as BE
    from ascii_renderer_tpu_torch.ops import group_build as GB
    seen = {"pair_keys": [], "build_rows": []}
    origs = [(BE, "pair_keys", BE.pair_keys), (GB, "build_rows",
                                                GB.build_rows)]
    for mod, name, orig in origs:
        def rec(*a, _orig=orig, _name=name, **k):
            seen[_name].append((a, k))
            return _orig(*a, **k)
        setattr(mod, name, rec)
    try:
        run()
    finally:
        for mod, name, orig in origs:
            setattr(mod, name, orig)
    return seen["pair_keys"], seen["build_rows"]


def _keys_call_plain(a, k):
    from ascii_renderer_tpu_torch.ops import bin_entries as BE
    return BE.pair_keys_ref(*a, **{n: v for n, v in k.items()
                                   if n != "form"})


def _build_call_plain(a, k):
    from ascii_renderer_tpu_torch.ops import group_build as GB
    return GB._shift_rows(GB.build_rows_ref(
        *a, k=k["k"], rows256=k.get("rows256", False)), k.get("y_off", 0))


def check_keys_builds(label, keys_calls, build_calls, builds=True):
    """X9's bin keys and X10 at recorded calls, each against its plain
    version on the same inputs: keys, offsets and counts, and every
    output of the layout, bit for bit. ``builds``: whether the path built
    through X10 (subtile4 does not)."""
    import torch
    from ascii_renderer_tpu_torch.ops import bin_entries as BE
    from ascii_renderer_tpu_torch.ops import group_build as GB
    assert keys_calls and bool(build_calls) == builds, (
        label, len(keys_calls), len(build_calls))
    for i, (a, k) in enumerate(keys_calls):
        got = BE.pair_keys(*a, **k)
        n_launch = BE.last_launches
        want = _keys_call_plain(a, k)
        torch.cuda.synchronize()
        for nm, g, w in zip(("keys", "offsets", "counts"), got, want):
            assert torch.equal(g, w), f"X9 bin keys {label} call {i}: {nm}"
        n_small, n_big, n_pairs, n_valid = got[2].tolist()
        print(f"X9 bin keys {label} call {i}: exact, {a[4].shape[0]} slots, "
              f"{got[0].shape[0]} keys ({n_pairs} in {got[1].shape[0] - 1} "
              f"bins), big_cap {k['big_cap']}, band "
              f"{k.get('ty_lo', 0)}+{k.get('tiles_y_band')}, {n_small} "
              f"small, {n_big} big, {n_valid} valid, {n_launch} launches",
              flush=True)
    for i, (a, k) in enumerate(build_calls):
        got = GB.build_rows(*a, **k)
        n_launch = GB.last_launches
        want = _build_call_plain(a, k)
        torch.cuda.synchronize()
        _same_layout(got, want, f"X10 {label} call {i}")
        n_rows, n_pairs, n_used = (int(x) for x in got[-4:-1])
        print(f"X10 {label} call {i}: exact, K {k['k']}"
              f"{' rows256' if k.get('rows256') else ''}, r_cap {a[4]}, "
              f"pair_cap {a[5]}, grp_cap {a[6]}, y_off {k.get('y_off', 0)}, "
              f"n_rows {n_rows}, n_pairs {n_pairs}, n_used {n_used}, "
              f"{n_launch} launches", flush=True)


def _kernel_split(fn, pattern, n=20):
    """{kernel: device ms a call} of fn's kernels whose names match the
    regular expression ``pattern`` (the profiler's rows over n calls)."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out, calls = {}, {}
    for e in prof.key_averages():
        m = re.search(pattern, e.key)
        if e.device_type == DeviceType.CUDA and m:
            out[m.group(0)] = out.get(m.group(0), 0.0) + \
                e.self_device_time_total / n / 1e3
            calls[m.group(0)] = calls.get(m.group(0), 0) + e.count
    # a profile that lost rows (see _device_ms) splits nothing
    return out if all(c == n for c in calls.values()) else {}


def _x10_bound(a, lay):
    """The bytes any layout build must move: the first p_eff keys and their
    pairs' 16-channel rows read once, the offsets read, every output
    written once (args ``a`` of build_rows, its outputs ``lay``)."""
    p_eff = min(a[5], a[1].shape[0])
    return _bound(_nbytes(*lay) + 68 * p_eff + 4 * (a[3] * 8 + 1), 0)


def time_keys_build(keys_call, build_call, label):
    """X9's bin keys and X10 timed at one recorded call each: kernel rows
    (the launch's own form), the whole call by CUDA events, the plain
    version, the bound. Returns (X9's bin-key numbers, X10's record)."""
    from ascii_renderer_tpu_torch.ops import bin_entries as BE
    from ascii_renderer_tpu_torch.ops import group_build as GB
    a, k = keys_call

    def keys_fn():
        return BE.pair_keys(*a, **k)

    keys, offs, _c = keys_fn()
    n_launch = BE.last_launches
    T, P, n_bins = a[4].shape[0], keys.shape[0], offs.shape[0] - 1
    ms = _device_ms(keys_fn, "bin_", n_launch)
    call = _event_ms(keys_fn, 20)
    plain = _event_ms(lambda: _keys_call_plain(a, k), 3)
    # the four bbox channels and the flags read once, the keys, offsets
    # and counts written once; ~40 operations a triangle
    bound = _bound(17 * T + 4 * P + 4 * (n_bins + 1) + 16, 40 * T)
    x9 = dict(keys_ms=ms, keys_call_ms=call, keys_plain_ms=plain,
              keys_bound_ms=bound[0], keys_bound_by=bound[1],
              keys_launches_a_call=n_launch, keys_at=label, keys_slots=T,
              keys_pairs=P, keys_bins=n_bins)
    split = _kernel_split(keys_fn, r"bin_\w+")
    x9["keys_split_ms"] = split
    print(f"X9 bin keys {label}: kernels {ms:.5f} ms ({n_launch} launches, "
          f"{T} slots, {P} keys, {n_bins} bins; "
          + ", ".join(f"{k} {v:.5f}" for k, v in split.items())
          + f"), the whole call {call:.5f} ms, plain {plain:.3f} ms, bound "
          f"{bound[0]:.5f} ms ({bound[1]})", flush=True)
    a, k = build_call

    def build_fn():
        return GB.build_rows(*a, **k)

    lay = build_fn()
    n_launch = GB.last_launches
    ms = _device_ms(build_fn, "group_build_", n_launch)
    call = _event_ms(build_fn, 20)
    plain = _event_ms(lambda: _build_call_plain(a, k), 3)
    bound = _x10_bound(a, lay)
    rec = _rec("group_build", "group_build.cu", "raster_group.py:418", 0.0,
               ms, plain, bound)
    split = _kernel_split(build_fn, r"group_build_\w+")
    rec.update(call_ms=call, launches_a_call=n_launch, at=label,
               r_cap=a[4], pair_cap=a[5], grp_cap=a[6], k=k["k"],
               split_ms=split)
    print(f"X10 {label}: kernels {ms:.5f} ms ({n_launch} launches, K "
          f"{k['k']}, r_cap {a[4]}, grp_cap {a[6]}; "
          + ", ".join(f"{k_} {v:.5f}" for k_, v in split.items())
          + "), the whole call "
          f"{call:.5f} ms, plain {plain:.3f} ms, bound {bound[0]:.5f} ms "
          f"({bound[1]})", flush=True)
    return x9, rec


def check_headline_keys_builds(dev, soup, scene, backend, cfg):
    """X9's bin keys and X10 at the headline: a fresh RasterBackend's
    frame 0 (its first caps, big_cap 64) and the driven backend's steady
    frame (its lean caps, big_cap 0), each call against its plain
    version; both timed at the steady frame. Returns (X9's bin-key
    numbers, X10's record)."""
    import torch
    from ascii_renderer_tpu_torch.backends.raster import RasterBackend
    fresh = RasterBackend(cfg, device=dev)
    fresh.set_soup(*(torch.as_tensor(x) for x in soup), scene)
    calls = _record_keys_builds(lambda: _frame(fresh, cfg, _golden_camera()))
    check_keys_builds("headline frame 0", *calls)
    del fresh, calls
    keys_calls, build_calls = _record_keys_builds(
        lambda: _frame(backend, cfg, _golden_camera()))
    check_keys_builds("headline steady frame", keys_calls, build_calls)
    return time_keys_build(keys_calls[-1], build_calls[-1],
                           "headline steady frame")


def check_golden_keys_builds(dev, soup, scene):
    """X9's bin keys and X10 at every grouped generation's golden call
    (FRAME_RUNS' frame 0; subtile4's direct grouping is the torch chain),
    each call against its plain version."""
    frame = _generation_frame(dev, soup, scene)
    for method, packed in FRAME_RUNS:
        keys_calls, build_calls = _record_keys_builds(
            lambda: frame(method, packed))
        label = f"{method}{' SETUP_PACKED' if packed else ''} golden call"
        check_keys_builds(label, keys_calls, build_calls,
                          builds=method != "subtile4")


def check_band_keys_builds(dev, soup, scene):
    """X9's bin keys and X10 at the bunny's row bands (BAND_ROWS rows at
    row_lo 0, BAND_ROWS, 2 BAND_ROWS, the golden caps) of subtile8,
    subtile6 and subtile3, each call against its plain version."""
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    p, n, c = (torch.as_tensor(x).to(dev) for x in soup)
    caps = _golden_caps(p.shape[0] // 3)
    cam = _golden_camera()
    for gen in ("subtile8", "subtile6", "subtile3"):
        for lo in (0, BAND_ROWS, 2 * BAND_ROWS):
            calls = _record_keys_builds(lambda: R.render_soup_diag(
                p, n, c, scene, cam, ROWS, COLS, PIXEL_ASPECT, kernel=gen,
                row_lo=lo, band_rows=BAND_ROWS, **caps))
            check_keys_builds(f"{gen} band {lo}", *calls)


# the shapes B6 / B6' are timed at: the driven paths' own; the records
# carry the mid-scale HD arm's
B6_TIMED = ("demo room 96x36", "teapot 240x135", "mid-scale HD 960x540")


def check_bins_kernels(dev, room, cube, mid_preps):
    """B6 and B6' against their plain versions at every shape the binned
    paths give them: z and winner ids exactly equal; each timed at the
    entry() room's, the teapot's and the mid-scale HD arm's shapes, with
    its work list (work items of one 128-entry chunk and a quarter of a
    tile's rows, blocks launched). Returns the two records, at the mid-scale HD
    arm's shape."""
    import torch
    from ascii_renderer_tpu_torch.ops import raster_bins as RB
    recs = {}
    for label, data, offs, tiles_x, n_tiles in _walk_inputs(
            dev, room, cube, mid_preps):
        walked = int((offs[1:] - offs[:-1]).sum())
        _first, n_chunks = RB.bin_slots(offs)
        items = int(n_chunks.sum())
        print(f"B6 {label}: {n_tiles} tiles, {int((n_chunks > 0).sum())} "
              f"non-empty, {walked} entries walked, deepest bin "
              f"{int(n_chunks.max())} chunks; {items} work items of one "
              f"chunk, {4 * items} blocks with work of "
              f"{4 * RB.n_slots(data['mm'].numel() // 16, n_tiles)} "
              f"launched", flush=True)
        if label == "demo room 96x36":  # entry()'s step: more blocks
            assert 4 * items > n_tiles, (items, n_tiles)
        for kern, fn, ref in (("mm", RB.tile_eval_bins_mm,
                               RB.tile_eval_bins_mm_ref),
                              ("loop", RB.tile_eval_bins,
                               RB.tile_eval_bins_ref)):
            d = data[kern]
            z_k, t_k = fn(d, offs, tiles_x, n_tiles)
            z_r, t_r = ref(d, offs, tiles_x, n_tiles)
            torch.cuda.synchronize()
            assert torch.equal(t_k, t_r), f"B6 {kern} {label}: ids differ"
            assert torch.equal(z_k.view(torch.int32), z_r.view(torch.int32)), \
                f"B6 {kern} {label}: depths differ"
            hits = int((t_k >= 0).sum())
            assert hits > 0, f"B6 {kern} {label}: nothing hit"
            print(f"B6 {kern} {label}: exact, {n_tiles} tiles, {walked} "
                  f"entries walked, {hits} lit pixels", flush=True)
            if label in B6_TIMED:  # walk, then merge: two launches
                ms = _device_ms(lambda: fn(d, offs, tiles_x, n_tiles),
                                "bins_walk_kernel", 2)
                plain = _event_ms(lambda: ref(d, offs, tiles_x, n_tiles), 3)
                bound = _bound(64 * walked + _nbytes(offs, z_k, t_k),
                               B6_OPS * 1024 * walked)
                print(f"B6 {kern} {label}: kernel {ms:.5f} ms, plain "
                      f"{plain:.3f} ms, bound {bound[0]:.5f} ms "
                      f"({bound[1]})", flush=True)
            if label.startswith("mid-scale"):
                name = ("raster_bins_walk" if kern == "mm"
                        else "raster_bins_walk_loop")
                recs[kern] = _rec(name, "raster_bins.cu",
                                  "raster_bins.py:158" if kern == "mm"
                                  else "raster_bins.py:54", 0.0, ms, plain,
                                  bound)
    return [recs["mm"], recs["loop"]]


def check_pack_channels(dev, mid_preps):
    """B7 and B7' against their plain versions, bit-exact, at the plane
    tables of the teapot and the HD arm (and B7' at the reference's
    exactness shape). Returns the two records, timed at the HD arm's."""
    import torch
    from ascii_renderer_tpu_torch.ops import pack as PK
    recs = []
    g = torch.Generator().manual_seed(3)
    exact40 = torch.randn((40, 544 * 128), generator=g).to(dev)
    cases = [(label, torch.stack(chans)) for label, _g, (_c, chans, _caps)
             in mid_preps] + [("exactness [40, 69632]", exact40)]
    for label, cm in cases:
        C, N = cm.shape
        W = -(-C // 8) * 8
        spans = [(0, 16), (16, W)]
        if not label.startswith("exactness"):
            got = PK.pack_channels(list(cm))
            want = PK.pack_channels_ref(list(cm))
            torch.cuda.synchronize()
            assert got.shape == want.shape == (N, W)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
                f"B7 {label}: not bit-exact"
        for o_k, o_r in zip(PK.pack_channels_split(cm, spans),
                            PK.pack_channels_split_ref(cm, spans)):
            torch.cuda.synchronize()
            assert torch.equal(o_k.view(torch.int32), o_r.view(torch.int32)), \
                f"B7' {label}: not bit-exact"
        print(f"B7 / B7' {label}: [{C}, {N}] -> [{N}, {W}], bit-exact",
              flush=True)
        if label.startswith("mid-scale"):
            chans = list(cm)
            padded = torch.cat([cm, cm.new_zeros((W - C, N))])
            # the floor under a pack this small: a fill of its output
            # alone, and of one float
            out, one = torch.empty((N, W), device=dev), cm.new_zeros(1)
            fill = _device_ms(lambda: out.fill_(0.0), None, 1)
            fill1 = _device_ms(lambda: one.fill_(0.0), None, 1)
            print(f"B7 floor: a fill of the [{N}, {W}] output {fill:.5f} ms, "
                  f"of one float {fill1:.5f} ms", flush=True)
            bound = _bound(4 * N * (C + W), 0)
            recs.append(_rec(
                "pack_channels", "pack.cu", "pack.py:95", 0.0,
                _device_ms(lambda: PK.pack_channels(chans),
                           "pack_span_kernel", 1),
                _event_ms(lambda: PK.pack_channels_ref(chans), 20), bound,
                library_ms=_device_ms(lambda: padded.t().contiguous(),
                                      None, 1)))
            bound = _bound(4 * N * sum(min(b, C) - a + (b - a)
                                       for a, b in spans), 0)
            recs.append(_rec(
                "pack_channels_split", "pack.cu", "pack.py:130", 0.0,
                _device_ms(lambda: PK.pack_channels_split(cm, spans),
                           "pack_span_kernel", len(spans)),
                _event_ms(lambda: PK.pack_channels_split_ref(cm, spans), 20),
                bound, library_ms=_device_ms(
                    lambda: [padded[a:b].t().contiguous() for a, b in spans],
                    None, len(spans))))
    return recs


# float operations a triangle slot of X4 and a table row of X3 (a fused
# product-add two), counted from csrc/raster_clip.cu and plane_row.cuh:
# X4's two threads a slot each transform and clip the slot (vertex
# transforms 72, depths 3, ratios 6, lerps 36) and set up one output
# triangle (41); X3's row forms its own values once (edge coefficients 15,
# their products with iw 9, the guarded reciprocal 2, the denominator 15),
# then per attribute three lerps (9) and three planes (15); the slots
# form's thread per attribute its three lerps (X4S_OPS_ATTR)
X4_OPS_SLOT = 2 * (72 + 3 + 6 + 36 + 41)
X4S_OPS_ATTR = 9
X3_OPS_ROW, X3_OPS_ATTR = 15 + 9 + 2 + 15, 9 + 15
ROWS_COLS_FRONT = (270, 480)  # the near-plane soup's grid


def _capture_last(mods_names, run):
    """Run ``run()`` recording the arguments of the LAST call of each
    ``mod.name`` in ``mods_names``: the inputs a path's steady frame gives
    a kernel wrapper. Returns {name: (args, kwargs) or None}."""
    seen = {name: None for _mod, name in mods_names}
    origs = [(mod, name, getattr(mod, name)) for mod, name in mods_names]
    for mod, name, orig in origs:
        def rec(*a, _orig=orig, _name=name, **k):
            seen[_name] = (a, k)
            return _orig(*a, **k)
        setattr(mod, name, rec)
    try:
        run()
    finally:
        for mod, name, orig in origs:
            setattr(mod, name, orig)
    return seen


def _front_calls(dev, soup, scene, caps):
    """The inputs each caller gives X4 (clip_screen), its table form
    (clip_screen_table), its slots form (clip_screen_slots) and X3
    (plane_table): entry()'s step (the demo room at 96x36) and the cube at
    80x24 through render_soup's binned walk (the table form), the teapot
    240x135 and the mid-scale HD arm (RasterBackend, a second frame at its
    settled caps), the bunny's "fused" call (its clip and attribute slots:
    the slots form) and "subtile" call (its clip and table) at the golden
    pose, and seeded soups at the near plane: 60,000 triangles (X4 and the
    slots form in both vertex layouts; X3 uncompacted with 9 attributes
    and at a compaction with 6; the table form in the pos9 layout), 256
    (the table form at 2T = 512) and 300 (the slots form). Returns
    {kernel: {caller: (args, kwargs)}}."""
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.backends.raster import RasterBackend
    from ascii_renderer_tpu_torch.core.config import Config
    from ascii_renderer_tpu_torch.entry import entry
    from ascii_renderer_tpu_torch.ops import plane_table as PT
    from ascii_renderer_tpu_torch.ops import raster_clip as RCL
    from ascii_renderer_tpu_torch.tools.xla_inputs import front_inputs
    # (a package without the table form has its callers take X4 and X3)
    wrappers = tuple((m, nm) for m, nm in (
        (RCL, "clip_screen"), (RCL, "clip_screen_table"),
        (RCL, "clip_screen_slots"), (PT, "plane_table")) if hasattr(m, nm))
    runs = {}
    fn, args = entry(device=dev)
    runs["entry() room 96x36"] = lambda: fn(*args)
    (cp, cn, cc), ccam = _mesh("cube")
    cube = tuple(torch.from_numpy(x).to(dev) for x in (cp, cn, cc))
    cscene = _cube_scene(dev)
    runs["cube 80x24"] = lambda: R.render_soup(
        *cube, cscene, ccam, *CUBE_GRID, PIXEL_ASPECT, method="scatter")
    for label, name, grid in (("teapot 240x135", "teapot", TEAPOT_GRID),
                              ("mid-scale HD 960x540", "mid", MID_GRID)):
        msoup, mcam = _mesh(name)
        be = RasterBackend(Config(pixel_aspect=PIXEL_ASPECT), device=dev)
        be.set_soup(*msoup, _scene(dev))
        runs[label] = lambda be=be, mcam=mcam, grid=grid: [be.render(
            0.0, mcam, *grid, PIXEL_ASPECT) for _ in range(2)]
    for method in ("fused", "subtile"):
        runs[f"bunny {method} 960x540"] = _oracle_frame(
            dev, soup, scene, method, caps.get(method, {}))
    out = {"clip_screen": {}, "clip_screen_table": {},
           "clip_screen_slots": {}, "plane_table": {}}
    for label, run in runs.items():
        for name, call in _capture_last(wrappers, run).items():
            if call is not None:
                out[name][label] = call
    p, attrs, mvp = front_inputs(60000, 16, dev, *ROWS_COLS_FRONT)
    pos9 = R.positions_to_pos9(p)
    near = "near-plane soup 60,000 triangles"
    out["clip_screen"][near] = ((p, mvp, *ROWS_COLS_FRONT), {})
    out["clip_screen"][near + ", pos9"] = (
        (pos9, mvp, *ROWS_COLS_FRONT), {"pos9": True})
    ch = RCL.clip_screen(p, mvp, *ROWS_COLS_FRONT)
    cch, cidx, _n = R.compact_valid_ch(dict(ch), 65536)
    out["plane_table"][near] = ((ch, ch, attrs), {})
    out["plane_table"][near + ", compacted, 6 attributes"] = (
        (cch, ch, attrs[:, :6].contiguous(), cidx), {})
    if not hasattr(RCL, "clip_screen_table"):
        return out
    nc = (attrs[:, :3].contiguous(), attrs[:, 3:6].contiguous())
    if hasattr(RCL, "clip_screen_slots"):
        out["clip_screen_slots"][near] = (
            (p, *nc, mvp, *ROWS_COLS_FRONT), {})
        out["clip_screen_slots"][near + ", pos9"] = (
            (pos9, *nc, mvp, *ROWS_COLS_FRONT), {"pos9": True})
    out["clip_screen_table"][near + ", pos9"] = (
        (pos9, *nc, mvp, *ROWS_COLS_FRONT), {"pos9": True})
    p, attrs, mvp = front_inputs(256, 17, dev, *ROWS_COLS_FRONT)
    out["clip_screen_table"]["near-plane soup 256 triangles"] = (
        (p, attrs[:, :3].contiguous(), attrs[:, 3:6].contiguous(), mvp,
         *ROWS_COLS_FRONT), {})
    if hasattr(RCL, "clip_screen_slots"):  # 2T no multiple of 128
        p, attrs, mvp = front_inputs(300, 18, dev, *ROWS_COLS_FRONT)
        out["clip_screen_slots"]["near-plane soup 300 triangles"] = (
            (p, attrs[:, :3].contiguous(), attrs[:, 3:6].contiguous(), mvp,
             *ROWS_COLS_FRONT), {})
    return out


def _same_dict(got, want, what):
    """A channel dict bit for bit: keys in order, dtypes, NaN places."""
    import torch
    assert list(got) == list(want), f"{what}: keys {list(got)}"
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, \
            f"{what}: {k} {got[k].dtype} {tuple(got[k].shape)}"
        if w.dtype == torch.float32:
            _same_bits(got[k], w, f"{what}: {k}")
        else:
            assert torch.equal(got[k], w), f"{what}: {k} differs"


def _x4_slots(args, kw):
    """X4's triangle slots T (the source's layout by ``pos9``)."""
    src = args[0]
    return src.shape[1] if kw.get("pos9") else src.shape[0] // 3


def _x4_bound(args, kw):
    """X4's least work: each slot's 9 coordinates read once, 25 floats of
    each of its two output slots, 2 valid bytes and 20 bytes of records
    written once; X4_OPS_SLOT operations a slot."""
    T = _x4_slots(args, kw)
    return _bound(36 * T + 200 * T + 2 * T + 20 * T, X4_OPS_SLOT * T), T


def _x4t_bound(args, kw):
    """The table form's least work: X4's, the normals and colors read
    once (the positions are X4's source), the [2T + 1, 32] table written
    once; X4_OPS_SLOT and two rows' X3 operations (A = 9) a slot."""
    from ascii_renderer_tpu_torch.ops import raster_clip as RCL
    T = _x4_slots(args, kw)
    n_bytes = (36 + 200 + 2 + 20 + 72) * T + 4 * (2 * T + 1) * \
        RCL.TABLE_WIDTH
    return _bound(n_bytes, (X4_OPS_SLOT + 2 * (X3_OPS_ROW + 9 * X3_OPS_ATTR))
                  * T), T


def _x4s_bound(args, kw):
    """The slots form's least work: X4's, the normals and colors read
    once (the positions are X4's source), 27 floats of each output slot
    written once; X4_OPS_SLOT and two output slots' X4S_OPS_ATTR a slot
    and attribute."""
    T = _x4_slots(args, kw)
    n_bytes = (36 + 200 + 2 + 20 + 72 + 2 * 4 * 27) * T
    return _bound(n_bytes, (X4_OPS_SLOT + 2 * 9 * X4S_OPS_ATTR) * T), T


def _x3_bound(args):
    """X3's least work: the rows' 10 screen floats (and cidx) read once,
    the records and 3A attributes of each distinct source slot a row reads
    read once, the [N + 1, W] table written once; X3_OPS_ROW +
    X3_OPS_ATTR A operations a row."""
    import torch
    from ascii_renderer_tpu_torch.ops import plane_table as PT
    ch, rec, attrs = args[:3]
    cidx = args[3] if len(args) > 3 else None
    N, T, A = ch["sxa"].shape[0], rec["rot"].shape[0], attrs.shape[1]
    if cidx is None:
        n_src = T
    else:
        src = torch.where(cidx < 2 * T, cidx % T, 0)
        n_src = torch.unique(src).numel()
    n_bytes = (40 * N + (0 if cidx is None else 4 * N)
               + (20 + 12 * A) * n_src + 4 * (N + 1) * PT.table_width(A))
    return _bound(n_bytes, (X3_OPS_ROW + X3_OPS_ATTR * A) * N), N, A, n_src


def check_front_kernels(dev, soup, scene, caps):
    """X4 (the clip with its screen setup, one launch of
    csrc/raster_clip.cu), its table form (the clip and the plane table of
    the uncompacted slots in one launch), its slots form (the clip and the
    attribute slots in one launch) and X3 (the plane table with its
    attribute lerps, one launch of csrc/plane_table.cu) against their
    plain versions on the inputs each caller gives them (_front_calls):
    the dicts, slots and tables bit for bit (NaN in the same places). X4
    and X3 timed at the mid-scale HD arm's call, the table form at the
    entry() room's and the slots form at the bunny's fused call (in X4's
    record, ``table_form`` and ``slots_form``). Returns X4's and X3's
    records."""
    import torch
    from ascii_renderer_tpu_torch.ops import plane_table as PT
    from ascii_renderer_tpu_torch.ops import raster_clip as RCL
    calls = _front_calls(dev, soup, scene, caps)
    lines = []
    for label, (args, kw) in calls["clip_screen"].items():
        got, want = RCL.clip_screen(*args, **kw), RCL.clip_screen_ref(*args,
                                                                      **kw)
        torch.cuda.synchronize()
        _same_dict(got, want, f"X4 {label}")
        T = _x4_bound(args, kw)[1]
        assert int(want["valid"].sum()) > 0, label
        lines.append(f"{label} ({T} slots{', pos9' if kw.get('pos9') else ''}"
                     f", {int(want['valid'].sum())} valid)")
    print(f"clip (X4): bit-identical to the plain version for "
          f"{'; '.join(lines)}", flush=True)
    lines = []
    for label, (args, kw) in calls["clip_screen_table"].items():
        (got_ch, got), (want_ch, want) = (
            RCL.clip_screen_table(*args, **kw),
            RCL.clip_screen_table_ref(*args, **kw))
        torch.cuda.synchronize()
        _same_dict(got_ch, want_ch, f"X4 table form {label}")
        _same_bits(got, want, f"X4 table form {label}: table")
        T = _x4_slots(args, kw)
        assert int(want_ch["valid"].sum()) > 0, label
        lines.append(f"{label} ({T} slots{', pos9' if kw.get('pos9') else ''}"
                     f", {2 * T + 1} table rows, "
                     f"{'2T a multiple of 512' if T % 256 == 0 else '2T not'}"
                     f")")
    assert {"entry() room 96x36", "cube 80x24"} <= set(
        calls["clip_screen_table"]), list(calls["clip_screen_table"])
    assert any(_x4_slots(*c) % 256 == 0
               for c in calls["clip_screen_table"].values())
    print(f"clip and table (X4's table form): bit-identical to the plain "
          f"version for {'; '.join(lines)}", flush=True)
    lines = []
    for label, (args, kw) in calls["clip_screen_slots"].items():
        (got_ch, got), (want_ch, want) = (
            RCL.clip_screen_slots(*args, **kw),
            RCL.clip_screen_slots_ref(*args, **kw))
        torch.cuda.synchronize()
        _same_dict(got_ch, want_ch, f"X4 slots form {label}")
        for s, (g_s, w_s) in enumerate(zip(got, want)):
            assert len(g_s) == len(w_s) == RCL.TABLE_ATTRS, label
            for j, (g, w) in enumerate(zip(g_s, w_s)):
                _same_bits(g, w, f"X4 slots form {label}: slot {s} "
                           f"attribute {j}")
        T = _x4_slots(args, kw)
        assert int(want_ch["valid"].sum()) > 0, label
        lines.append(f"{label} ({T} slots{', pos9' if kw.get('pos9') else ''}"
                     f", {int(want_ch['valid'].sum())} valid, rot "
                     f"{sorted(set(want_ch['rot'].tolist()))}, n_in "
                     f"{sorted(set(want_ch['n_in'].tolist()))})")
    bunny = "bunny fused 960x540"
    assert bunny in calls["clip_screen_slots"], list(calls[
        "clip_screen_slots"])
    assert _x4_slots(*calls["clip_screen_slots"][bunny]) == 68644
    print(f"clip and attribute slots (X4's slots form): bit-identical to "
          f"the plain version for {'; '.join(lines)}", flush=True)
    lines = []
    for label, (args, kw) in calls["plane_table"].items():
        got, want = PT.plane_table(*args, **kw), PT.plane_table_ref(*args,
                                                                    **kw)
        torch.cuda.synchronize()
        _same_bits(got, want, f"X3 {label}")
        _b, N, A, n_src = _x3_bound(args)
        compacted = len(args) > 3 and args[3] is not None
        lines.append(f"{label} ({N} rows{', compacted' if compacted else ''}"
                     f", {A} attributes, {n_src} source slots, "
                     f"{'B7 layout' if N % 512 == 0 else 'stacked'})")
    print(f"plane table (X3): bit-identical to the plain version for "
          f"{'; '.join(lines)}", flush=True)
    recs = []
    timed = "mid-scale HD 960x540"
    args, kw = calls["clip_screen"][timed]
    ms = _device_ms(lambda: RCL.clip_screen(*args, **kw),
                    "raster_clip_kernel", RCL.LAUNCHES_PER_CALL["clip_screen"])
    plain = _event_ms(lambda: RCL.clip_screen_ref(*args, **kw), 5)
    bound, T = _x4_bound(args, kw)
    print(f"clip (X4) at the {timed} arm's call ({T} slots): kernel "
          f"{ms:.5f} ms, plain {plain:.3f} ms, bound {bound[0]:.5f} ms "
          f"({bound[1]})", flush=True)
    rec = _rec("raster_clip", "raster_clip.cu", "", 0.0, ms, plain, bound)
    rec.update(replaces="ascii_renderer_tpu/backends/raster_channels.py:139",
               slots=T)
    room = "entry() room 96x36"
    args, kw = calls["clip_screen_table"][room]
    ms = _device_ms(lambda: RCL.clip_screen_table(*args, **kw),
                    "raster_clip_table_kernel",
                    RCL.LAUNCHES_PER_CALL["clip_screen_table"])
    plain = _event_ms(lambda: RCL.clip_screen_table_ref(*args, **kw), 5)
    bound, T = _x4t_bound(args, kw)
    print(f"clip and table (X4's table form) at the {room}'s call ({T} "
          f"slots, {2 * T + 1} table rows): kernel {ms:.5f} ms, plain "
          f"{plain:.3f} ms, bound {bound[0]:.5f} ms ({bound[1]})",
          flush=True)
    rec["table_form"] = dict(ms=ms, plain_ms=plain, bound_ms=bound[0],
                             bound_by=bound[1], slots=T,
                             replaces="ascii_renderer_tpu/backends/"
                             "raster_channels.py:139, :426, :481")
    args, kw = calls["clip_screen_slots"][bunny]
    ms = _device_ms(lambda: RCL.clip_screen_slots(*args, **kw),
                    "raster_clip_slots_kernel",
                    RCL.LAUNCHES_PER_CALL["clip_screen_slots"])
    plain = _event_ms(lambda: RCL.clip_screen_slots_ref(*args, **kw), 5)
    bound, T = _x4s_bound(args, kw)
    print(f"clip and attribute slots (X4's slots form) at the {bunny} "
          f"call ({T} slots): kernel {ms:.5f} ms, plain {plain:.3f} ms, "
          f"bound {bound[0]:.5f} ms ({bound[1]})", flush=True)
    rec["slots_form"] = dict(ms=ms, plain_ms=plain, bound_ms=bound[0],
                             bound_by=bound[1], slots=T,
                             replaces="ascii_renderer_tpu/backends/"
                             "raster_channels.py:139, :426")
    recs.append(rec)
    args, kw = calls["plane_table"][timed]
    ms = _device_ms(lambda: PT.plane_table(*args, **kw),
                    "plane_table_kernel", PT.LAUNCHES_PER_CALL["plane_table"])
    plain = _event_ms(lambda: PT.plane_table_ref(*args, **kw), 5)
    bound, N, A, n_src = _x3_bound(args)
    print(f"plane table (X3) at the {timed} arm's call ({N} rows, {A} "
          f"attributes, {n_src} source slots): kernel {ms:.5f} ms, plain "
          f"{plain:.3f} ms, bound {bound[0]:.5f} ms ({bound[1]})",
          flush=True)
    rec = _rec("plane_table", "plane_table.cu", "", 0.0, ms, plain, bound)
    rec.update(replaces="ascii_renderer_tpu/backends/raster_channels.py:481",
               rows=N, attrs=A)
    recs.append(rec)
    return recs


def _step_frames(fn, state, args, n):
    for _ in range(n):
        state, chars, tint = fn(args[0], state, *args[2:])
    return state, chars, tint


def run_entry_path():
    """entry()'s frame step on the card: frame 0 against the port's CPU
    step (chars and tint equal), 3 steps with "w" held, 20 timed steps.
    Returns a function that runs one step."""
    import torch
    from ascii_renderer_tpu_torch.entry import entry
    fn, args = entry()
    fn_c, args_c = entry(device="cpu")
    state, chars, tint = fn(*args)
    _s, chars_c, tint_c = fn_c(*args_c)
    assert chars.device.type == "cuda" and tuple(chars.shape) == ENTRY_GRID
    assert torch.equal(chars.cpu(), chars_c), \
        f"entry frame 0: {int((chars.cpu() != chars_c).sum())} chars differ"
    assert torch.equal(tint.cpu(), tint_c), "entry frame 0: tint differs"
    kinds = int(torch.unique(chars).numel())
    assert kinds >= 6, kinds
    print(f"entry step frame 0: chars and tint equal the CPU step, {kinds} "
          f"distinct glyphs", flush=True)
    state, chars, _t = _step_frames(fn, state, args, 3)
    print(f"entry step frames 1-3 (w held): camera at "
          f"{[round(float(x), 4) for x in state.camera.pos]}, frame index "
          f"{int(state.frame_idx)}", flush=True)
    box = {"state": state}

    def one():
        box["state"], _c, _t = fn(args[0], box["state"], *args[2:])

    _summary("entry step 96x36 (w held)", _timed(one, 20))
    return one


def run_cube_path(dev):
    """bench config 1: the cube at 80x24, mode filter off, through
    RasterBackend (the scan path) and render_soup's binned walks B6 and
    B6' on the card: each gives the golden."""
    import torch
    from ascii_renderer_tpu_torch.ascii import AsciiPass, chars_to_strings
    from ascii_renderer_tpu_torch.backends.raster import (RasterBackend,
                                                          render_soup)
    from ascii_renderer_tpu_torch.core.config import Config
    from ascii_renderer_tpu_torch.core.frame import Frame
    cfg = Config(pixel_aspect=PIXEL_ASPECT, grid_width=80, grid_height=24,
                 ascii_mode_filter=False)
    (p, n, c), cam = _mesh("cube")
    scene = _cube_scene(dev)
    with open(GOLDEN_CUBE) as fh:
        golden = fh.read().splitlines()
    be = RasterBackend(cfg, device=dev)
    be.set_soup(p, n, c, scene)
    frames = {"RasterBackend (scan)": be.render(0.0, cam, *CUBE_GRID,
                                                PIXEL_ASPECT)}
    soup = tuple(torch.from_numpy(x).to(dev) for x in (p, n, c))
    for method in ("scatter", "scatter_loop"):
        frames[f"render_soup {method}"] = Frame.from_float(render_soup(
            *soup, scene, cam, *CUBE_GRID, PIXEL_ASPECT, method=method))
    for label, frame in frames.items():
        rows = chars_to_strings(AsciiPass(cfg)(frame)[0])
        assert rows == golden, f"cube via {label}: differs from the golden"
        print(f"cube 80x24 via {label}: equals raster_cube.txt", flush=True)


def run_raster_mesh_path(dev, name, grid, n_checked, n_cpu, n_timed, label):
    """RasterBackend + glyph pass on a mesh: n_checked frames (the first
    n_cpu against the CPU render's chars), then n_timed frames. Returns
    a function that renders one frame."""
    import torch
    from ascii_renderer_tpu_torch.backends.raster import RasterBackend
    from ascii_renderer_tpu_torch.core.config import Config
    cfg = Config(pixel_aspect=PIXEL_ASPECT)
    soup, cam = _mesh(name)
    rows, cols = grid
    backends = [RasterBackend(cfg, device=d) for d in (dev, "cpu")[
        :1 + (n_cpu > 0)]]
    for be, d in zip(backends, (dev, "cpu")):
        be.set_soup(*soup, _scene(d))
    for f in range(n_checked):
        box = {}
        (ms,) = _timed(lambda: box.update(chars=_glyph(
            backends[0].render(0.0, cam, rows, cols, PIXEL_ASPECT), cfg)), 1)
        chars = box["chars"]
        assert chars.device.type == "cuda" and tuple(chars.shape) == grid
        lit = int((chars != ord("@")).sum())
        assert lit > rows * cols // 40, f"{label} frame {f}: {lit} lit cells"
        if f < n_cpu:
            want = _glyph(backends[1].render(0.0, cam, rows, cols,
                                             PIXEL_ASPECT), cfg)
            assert torch.equal(chars.cpu(), want), \
                f"{label} frame {f}: {int((chars.cpu() != want).sum())} " \
                f"chars differ from the CPU render"
        print(f"{label} frame {f}: {ms:.3f} ms, {lit} lit cells, caps "
              f"{backends[0]._caps}"
              f"{', equals the CPU render' if f < n_cpu else ''}",
              flush=True)

    def one():
        _glyph(backends[0].render(0.0, cam, rows, cols, PIXEL_ASPECT), cfg)

    _summary(f"{label} steady", _timed(one, n_timed))
    return one


def run_pt_step_path(dev):
    """The "pathtrace" frame step (demo_setup) at 96x36: a spp-2 / 2-bounce
    step's frame 0 alpha plane against the port's CPU step, then 10 timed
    steps at the default spp 64. Returns a function that runs one step."""
    import torch
    from ascii_renderer_tpu_torch.core.camera import CameraInputs
    from ascii_renderer_tpu_torch.core.config import Config, PathTracerConfig
    from ascii_renderer_tpu_torch.sim.framestep import demo_setup
    ins = CameraInputs.from_keys({"w"})
    small = Config(path_tracer=PathTracerConfig(samples_per_batch=2,
                                                max_bounces=2))
    alphas = []
    for d in (dev, "cpu"):
        _cfg, scene, state, step = demo_setup(small, "pathtrace", device=d)
        _s, chars, _t, frame = step(scene, state, ins, 1.0 / 60, 60.0)
        assert tuple(chars.shape) == ENTRY_GRID
        alphas.append(frame.a.cpu())
    assert torch.equal(alphas[0], alphas[1]), \
        f"PT step frame 0: {int((alphas[0] != alphas[1]).sum())} alpha " \
        f"cells differ from the CPU step"
    n_ov = int(((alphas[0] >= 2) & (alphas[0] <= 254)).sum())
    print(f"PT step frame 0 (spp 2, 2 bounces): alpha plane equals the CPU "
          f"step, {n_ov} override cells (UI included)", flush=True)
    _cfg, scene, state, step = demo_setup(Config(), "pathtrace", device=dev)
    box = {"state": state}

    def one():
        box["state"], _c, _t, _f = step(scene, box["state"], ins, 1.0 / 60,
                                        60.0)

    _summary("PT step 96x36 spp64 (w held)", _timed(one, 10))
    return one


# while a driven path runs (_path_counts), the K3, K2, X10, X4, X3 and K1
# launches it makes are recorded by size (_record_sizes)
_DRIVEN = [False]


def _path_counts(counters, run, record=True):
    """Zero every launch count, run the path, return the counts. With
    ``record`` the path is one of the driven paths whose launch sizes
    _record_sizes keeps."""
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    _DRIVEN[0] = record
    try:
        out = run()
    finally:
        _DRIVEN[0] = False
    return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}, out


def _record_sizes(mod, name, size_of, also=(), weight_of=None):
    """Wrap ``mod.name`` (and the same function where a module of ``also``
    binds it by name) so that it keeps, while a driven path runs, at each
    launch size (``size_of(args, kwargs)``; None for a call that launches
    nothing) the first call's arguments, or with ``weight_of`` those of
    the heaviest call (the largest ``weight_of(args, kwargs)``; its
    tensors copied, so a later call cannot change them), and the calls at
    it. Returns ({size: [args, kwargs, calls, weight]}, the real
    function)."""
    import torch
    real, sizes = getattr(mod, name), {}

    def copied(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def rec(*a, **k):
        out = real(*a, **k)
        if _DRIVEN[0]:
            size = size_of(a, k)
            if size is not None:
                ent = sizes.setdefault(size, [a, k, 0, None])
                ent[2] += 1
                w = None if weight_of is None else weight_of(a, k)
                if w is not None and (ent[3] is None or w > ent[3]):
                    ent[0] = tuple(copied(x) for x in a)
                    ent[1] = {kk: copied(v) for kk, v in k.items()}
                    ent[3] = w
        return out

    for m in (mod, *also):
        setattr(m, name, rec)
    return sizes, real


def _shade_size(a, k):
    """K2's launch size: the pixel grid, id type, attributes, lights."""
    if a[0].device.type != "cuda":
        return None
    import torch
    shape = tuple(torch.broadcast_shapes(a[1].shape, a[2].shape, a[3].shape))
    return (shape, str(a[1].dtype)[6:], a[5], a[4].pt_pos.shape[0])


def _shade_image_size(a, k):
    """K2's image form's launch size: the image, attributes, lights and
    the groups' slots."""
    if a[0].device.type != "cuda":
        return None
    return ((a[9], a[10]), a[7], a[6].pt_pos.shape[0], a[1].shape[0])


def _build_size(a, k):
    """X10's launch size: r_cap, grp_cap, bins, the layout, offsets."""
    if a[1].device.type != "cuda":
        return None
    return (a[4], a[6], a[3] * 8, k["k"], bool(k.get("rows256")),
            k.get("offsets") is not None)


def _build_weight(a, k):
    """An X10 call's weight: its p_eff, the pairs it gathers."""
    return min(a[5], a[1].shape[0])


def _k3_size(a, k):
    """K3's launch size: its rays, and its form (the grid's views, band
    rows and columns, or rd3)."""
    grid = k.get("grid")
    if grid is None:
        return (a[3].shape[0] * a[3].shape[1], "rd3")
    trig = getattr(grid, "trig", None)
    V = grid.bases[0].shape[0] if trig is None else trig.shape[0]
    form = "grid" if trig is None else "trig grid"
    return (V * grid.band * grid.cols,
            f"{form} {V} x {grid.band}x{grid.cols}")


def _x4_size(a, k):
    """X4's launch size: triangle slots, the pos9 layout."""
    if a[0].device.type != "cuda":
        return None
    return (_x4_slots(a, k), bool(k.get("pos9")))


def _x4t_size(a, k):
    """X4's table form's launch size: triangle slots, the pos9 layout,
    the form."""
    if a[0].device.type != "cuda":
        return None
    return (_x4_slots(a, k), bool(k.get("pos9")), "table form")


def _x4s_size(a, k):
    """X4's slots form's launch size: triangle slots, the pos9 layout,
    the form."""
    if a[0].device.type != "cuda":
        return None
    return (_x4_slots(a, k), bool(k.get("pos9")), "slots form")


def _x3_size(a, k):
    """X3's launch size: rows, attributes, source slots, compacted."""
    if a[2].device.type != "cuda":
        return None
    cidx = a[3] if len(a) > 3 else None
    return (a[0]["sxa"].shape[0], a[2].shape[1], a[1]["rot"].shape[0],
            cidx is not None)


def _fma_size(a, k):
    """K1's launch size: the broadcast shape (None where nothing
    launches)."""
    import math
    import torch
    from ascii_renderer_tpu_torch.ops import fp as KFP
    ref = next(x for x in a if isinstance(x, torch.Tensor))
    if ref.device.type != "cuda":
        return None
    shape = tuple(KFP.pack_operands(*a, ref.device)[3])
    return shape if math.prod(shape) else None


def _fma_bound(a, out):
    """K1's least work: each CUDA tensor operand read once (a broadcast
    dimension once), the result written once; an FMA two operations."""
    import torch
    tens = [x for x in a if isinstance(x, torch.Tensor)
            and x.device.type == "cuda"]
    return _bound(_nbytes(*tens, out), 2 * out.numel())


def _x7_size(a, k):
    """X7's launch size: rays, samples, jittered, compacted (None where
    nothing launches)."""
    from ascii_renderer_tpu_torch.core.camera import band_of
    if str(k.get("device", "cuda")).startswith("cpu"):
        return None
    pc = band_of(a[1], k.get("row_lo", 0), k.get("n_rows")) * a[2]
    samples = k.get("samples", 1)
    return (samples * pc, samples, k.get("fet0") is not None,
            k.get("pix_uid") is not None)


def _x7_size_bound(a, k):
    n, samples = _x7_size(a, k)[:2]
    return _x7_bound(k, n, n // samples)[0][0]


def _x14_size(a, k):
    """X14's launch size: pixels, valid samples, first, resolving,
    compacted (None where nothing launches)."""
    if a[0][1].device.type != "cuda":
        return None
    return (a[0][1].shape[0], a[5], bool(k["first"]),
            k.get("probe") is not None, k.get("slot") is not None)


def size_loss(label, sizes, real, kernel, per_call, bound_of, rec,
              also=()):
    """A kernel's loss on the driven paths from the sizes of its launches
    (``_record_sizes``): each size's device ms (at its recorded call's
    arguments: the first, or the heaviest where a weight was kept;
    ``per_call(args, kwargs)`` kernels a call) less its bound
    (``bound_of(args, kwargs)`` ms), times its calls; ``also``: more
    (sizes, real, kernel, per_call, bound_of) of another form of the
    kernel, counted with it. Adds them to the record (main checks their
    sum against the driven paths' count); returns the loss."""
    loss, parts = 0.0, []
    forms = ((sizes, real, kernel, per_call, bound_of), *also)
    for f_sizes, f_real, f_kernel, f_per_call, f_bound_of in forms:
        for size, (a, k, n, w) in sorted(f_sizes.items(),
                                         key=lambda it: str(it[0])):
            ms = _device_ms(lambda: f_real(*a, **k), f_kernel,
                            f_per_call(a, k))
            bound = f_bound_of(a, k)
            loss += n * (ms - bound)
            parts.append(dict(size=list(size), launches=n, ms=ms,
                              bound_ms=bound, weight=w))
    print(f"{label} launch sizes on the driven paths: " + "; ".join(
        f"{p['size']}: {p['launches']} calls, kernel {p['ms']:.5f} ms"
        + ("" if p["weight"] is None else f" at weight {p['weight']}")
        + f", bound {p['bound_ms']:.5f} ms" for p in parts)
        + f"; loss {loss:.3f} ms", flush=True)
    rec.update(launch_sizes=parts, loss_ms=loss)
    return loss


def _size_losses(recorded, by_name):
    """K2's, X10's, X4's, X3's, K1's and X13's losses by launch size; K1
    timed at its largest driven call (time_fma32)."""
    import torch
    from ascii_renderer_tpu_torch.ops import group_build as GB
    ((shade, shade_real), (build, build_real), (clip, clip_real),
     (table, table_real), (fma, fma_real), (clipt, clipt_real),
     (clips, clips_real), (image, image_real), (x13c, x13c_real),
     (x13o, x13o_real)) = recorded

    def build_launches(a, k):
        build_real(*a, **k)
        return GB.last_launches

    def build_bound(a, k):
        return _x10_bound(a, build_real(*a, **k))[0]

    size_loss("raster shade (K2; its image form's launches with it)", shade,
              shade_real, "raster_shade_kernel", lambda a, k: 1,
              lambda a, k: _shade_bound(a)[0][0], by_name["raster_shade"],
              also=((image, image_real, "raster_shade_image_kernel",
                     lambda a, k: 1,
                     lambda a, k: _shade_image_bound(a)[0][0]),))
    size_loss("grouped layout build (X10)", build, build_real,
              "group_build_", build_launches, build_bound,
              by_name["group_build"])
    size_loss("raster clip (X4; its table and slots forms' launches with "
              "it)", clip, clip_real, "raster_clip_kernel", lambda a, k: 1,
              lambda a, k: _x4_bound(a, k)[0][0], by_name["raster_clip"],
              also=((clipt, clipt_real, "raster_clip_table_kernel",
                     lambda a, k: 1, lambda a, k: _x4t_bound(a, k)[0][0]),
                    (clips, clips_real, "raster_clip_slots_kernel",
                     lambda a, k: 1, lambda a, k: _x4s_bound(a, k)[0][0])))
    size_loss("plane table (X3)", table, table_real, "plane_table_kernel",
              lambda a, k: 1, lambda a, k: _x3_bound(a)[0][0],
              by_name["plane_table"])
    size_loss("fma32 (K1)", fma, fma_real, "fma32_kernel", lambda a, k: 1,
              lambda a, k: _fma_bound(a, fma_real(*a))[0], by_name["fma32"])
    size_loss("stable partition (X13's channels form)", x13c, x13c_real,
              "partition_", lambda a, k: 1, _x13_chan_size_bound,
              by_name["partition"])
    size_loss("stable partition (X13's order form)", x13o, x13o_real,
              "partition_", lambda a, k: 1, _x13_order_size_bound,
              by_name["partition_order"])
    time_fma32(fma, fma_real, by_name["fma32"])
    torch.cuda.synchronize()


def k3_loss(sizes, trace, rec):
    """K3's loss on the driven paths from the sizes of its launches: each
    size's device ms (at its first driven call's rays, the launch's own
    form) less its bound (_k3_bound: the valid slots' operations, the grid
    form's rays), times its launches. Adds them to the record (main
    checks their sum against the driven paths' count); returns the
    loss."""
    from ascii_renderer_tpu_torch.ops import rt_trace as RTK
    loss, parts = 0.0, []
    for (rays, form), (a, k, n, _w) in sorted(sizes.items()):
        ms = _device_ms(lambda: trace(*a, **k), "rt_trace_kernel", 1)
        scene, pr, cam, rd3, grid = _k3_args(a, k)
        bound = _k3_bound(scene, pr, cam, rd3, grid)[0][0]
        lanes, staged, blocks = _k3_form(RTK, rays, pr)
        loss += n * (ms - bound)
        parts.append(dict(rays=rays, form=form, launches=n, ms=ms,
                          bound_ms=bound, lanes=lanes, staged=staged,
                          blocks=blocks))
    print("rt trace (K3) launch sizes on the driven paths: " + "; ".join(
        f"{p['rays']} rays ({p['form']}): {p['launches']} launches, "
        f"{p['lanes']} lanes a ray {'staged' if p['staged'] else 'global'} "
        f"on {p['blocks']} blocks, kernel {p['ms']:.5f} ms, bound "
        f"{p['bound_ms']:.5f} ms" for p in parts) + f"; loss {loss:.3f} ms",
        flush=True)
    rec.update(launch_sizes=parts, loss_ms=loss)
    return loss


# kernel launches raster.walk may make a frame of the entry() step and the
# mid-scale HD arm: X9's four, B6's walk and merge and the image assembly
# after it
RASTER_WALK_LAUNCHES = 15
# kernel launches raster.clip makes a frame of the entry() step: X4's table
# form (the clip, its setup and the plane table)
ENTRY_CLIP_LAUNCHES = 1

# the kernels of the path tracer's kernel path: its sample rays X7, B5 and
# its batch fold X14
PT_KERNELS = ("pt_rays", "pt_megakernel", "pt_reduce")

# kernels the parallel phase must launch: the PT sample rays and fold, B5,
# B4 (the dryrun's farm), K3 (RT bands and farms), every walk and setup
# of the raster bands, and X5's two kernels and X5b (the train steps)
PARALLEL_KERNELS = ("pt_megakernel", "pt_rays", "pt_reduce",
                    "modal_vote", "setup2dh", "pack", "raster_group_walk",
                    "raster_group_walk_k2", "raster_group_walk_grouped",
                    "pack_channels", "setup2dh_packed", "rt_trace",
                    "raster_shade", "soft_raster_fwd", "soft_raster_bwd",
                    "soft_loss")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import ascii_renderer_tpu_torch  # noqa: F401  (fails outside the repo)
    from ascii_renderer_tpu_torch.core.config import Config, PathTracerConfig
    from ascii_renderer_tpu_torch.backends import pathtrace as PTB
    from ascii_renderer_tpu_torch.ops import _build
    from ascii_renderer_tpu_torch.ops import accum as OA
    from ascii_renderer_tpu_torch.ops import ascii_kernel as AK
    from ascii_renderer_tpu_torch.ops import bin_entries as BE
    from ascii_renderer_tpu_torch.ops import fp as KFP
    from ascii_renderer_tpu_torch.ops import frame_bytes as FB
    from ascii_renderer_tpu_torch.ops import group_build as GB
    from ascii_renderer_tpu_torch.ops import pack as PK
    from ascii_renderer_tpu_torch.ops import partition as PTN
    from ascii_renderer_tpu_torch.ops import plane_table as PT
    from ascii_renderer_tpu_torch.ops import pt_kernel as PTK
    from ascii_renderer_tpu_torch.ops import pt_reduce as PR
    from ascii_renderer_tpu_torch.ops import raster_bins as RB
    from ascii_renderer_tpu_torch.ops import raster_clip as RCL
    from ascii_renderer_tpu_torch.ops import raster_group as RG
    from ascii_renderer_tpu_torch.ops import raster_shade as RSH
    from ascii_renderer_tpu_torch.ops import ray_grid as RYG
    from ascii_renderer_tpu_torch.ops import raster_subtile as RS
    from ascii_renderer_tpu_torch.ops import rt_trace as RTK
    from ascii_renderer_tpu_torch.ops import setup2dh as S
    from ascii_renderer_tpu_torch.ops import soft_raster as SRK

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    print(f"build: {so.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in _build.ptxas_report():
        print(f"ptxas: {line}", flush=True)

    dev = torch.device("cuda:0")
    k3_sizes, k3_trace = _record_sizes(RTK, "trace", _k3_size)
    # the PT frame's X7 and X14 launches by size (the backend binds
    # pt_rays by name)
    pt_sizes = (_record_sizes(RYG, "pt_rays", _x7_size, also=(PTB,)),
                _record_sizes(PR, "fold", _x14_size))
    _record_fma_sites()  # inside K1's size recorder: its sites by size
    recorded = (_record_sizes(RSH, "shade", _shade_size),
                _record_sizes(GB, "build_rows", _build_size,
                              weight_of=_build_weight),
                _record_sizes(RCL, "clip_screen", _x4_size),
                _record_sizes(PT, "plane_table", _x3_size),
                _record_sizes(KFP, "fma32_kernel", _fma_size),
                _record_sizes(RCL, "clip_screen_table", _x4t_size),
                _record_sizes(RCL, "clip_screen_slots", _x4s_size),
                _record_sizes(RSH, "shade_image", _shade_image_size),
                _record_sizes(PTN, "compact_channels", _x13_chan_size),
                _record_sizes(PTN, "stable_order", _x13_order_size))
    # each kernel's wrapper module and launch counter
    counters = {"setup2dh": (S, "launches"), "pack": (PK, "launches"),
                "raster_group_walk": (RG, "launches"),
                "modal_vote": (AK, "launches"),
                "modal_vote_chars": (AK, "launches_chars"),
                "glyph_map": (AK, "launches_map"),
                "frame_bytes": (FB, "launches"),
                "pt_megakernel": (PTK, "launches"),
                "raster_bins_walk": (RB, "launches"),
                "raster_bins_walk_loop": (RB, "launches_loop"),
                "pack_channels": (PK, "launches_channels"),
                "pack_channels_split": (PK, "launches_split"),
                "raster_group_walk_grouped": (RG, "launches_grouped"),
                "raster_group_walk_direct": (RG, "launches_direct"),
                "raster_group_walk_k2": (RG, "launches_k2"),
                "setup2dh_packed": (S, "launches_packed"),
                "raster_bins_walk_shaded": (RB, "launches_shaded"),
                "raster_subtile_walk": (RS, "launches"),
                "raster_subtile_walk_packed": (RS, "launches_packed"),
                "raster_subtile_walk_packed_d": (RS, "launches_packed_d"),
                "ray_grid": (RYG, "launches"),
                "ray_grid_jit": (RYG, "jit_launches"),
                "pt_rays": (RYG, "pt_launches"),
                "pt_reduce": (PR, "launches"),
                "pt_megakernel_gated": (PTK, "launches_gated"),
                "fma32": (KFP, "launches"), "raster_shade": (RSH, "launches"),
                "raster_shade_image": (RSH, "launches_image"),
                "frame_bytes_ui": (FB, "launches_ui"),
                "rt_trace": (RTK, "launches"),
                "raster_clip": (RCL, "launches"),
                "raster_clip_table": (RCL, "launches_table"),
                "raster_clip_slots": (RCL, "launches_slots"),
                "plane_table": (PT, "launches"),
                "bin_entries": (BE, "launches"),
                "bin_entries_keys": (BE, "launches_keys"),
                "group_build": (GB, "launches"),
                "partition": (PTN, "launches"),
                "partition_order": (PTN, "launches_order"),
                "accum": (OA, "launches"),
                "soft_raster_fwd": (SRK, "launches"),
                "soft_raster_bwd": (SRK, "launches_bwd"),
                "soft_loss": (SRK, "launches_loss")}
    # fma32 first: the other kernels' plain versions call it
    soup = _bunny()
    scene = _scene(dev)
    fma_rec, mid_shade = check_fma32(dev, soup, scene)
    recs = [fma_rec] + check_kernels(dev, soup, scene)
    recs.append(check_modal(dev, soup, scene))
    recs.append(check_pt_kernel(dev))
    recs.append(check_ray_grid(dev))
    recs.append(check_pt_rays(dev))
    recs.append(check_pt_reduce(dev))
    recs.append(check_accum(dev))
    recs.append(check_modal_batched(dev))
    recs += check_glyph_tail(dev, soup, scene)
    ui_form = check_ui_form(dev)
    recs.append(check_ray_grid_jit(dev))
    recs.append(check_rt_trace(dev))
    check_render_rgb_one_launch(dev)
    by_name = {r["name"]: r for r in recs}
    by_name["frame_bytes"]["ui_form"] = ui_form

    # raster headline path: B1-B3, and B4 in the glyph stage
    c_raster, (backend, cfg) = _path_counts(
        counters, lambda: run_main_path(dev, soup, scene))
    print(f"launches on the raster path: {c_raster}", flush=True)
    for k in ("setup2dh", "pack", "raster_group_walk", "modal_vote"):
        assert c_raster[k] > 0, f"{k} never launched on the raster path"
        by_name[k]["launches"] = c_raster[k]
    assert c_raster["raster_shade_image"] > 0, "K2's image form never launched"
    assert c_raster["raster_shade"] == c_raster["raster_shade_image"], \
        c_raster  # no grouped shade, no assembly chain
    for k in ("bin_entries_keys", "group_build"):  # X9's bin keys, X10
        assert c_raster[k] > 0, f"{k} never launched on the raster path"
    prof = profile_frames(lambda: _frame(backend, cfg, _golden_camera()), 5,
                          ("raster.", "frame.", "glyph"), "raster")
    stage_launches = prof[2]
    shade_stages("headline frame", stage_launches)
    print(f"headline frame: {prof[1]} kernel launches", flush=True)
    assert prof[1] <= HEADLINE_FRAME_LAUNCHES, prof[1]
    tails = {"headline frame": tail_stages(
        "headline frame", prof, counters,
        lambda: _frame(backend, cfg, _golden_camera()))}
    # X9 and X10 leave raster.keys and raster.build their kernels alone
    print(f"headline frame: raster.keys {stage_launches['raster.keys']:g}, "
          f"raster.build {stage_launches['raster.build']:g} kernel "
          f"launches", flush=True)
    assert 0 < stage_launches["raster.keys"] <= RASTER_KEYS_LAUNCHES
    assert 0 < stage_launches["raster.build"] <= RASTER_BUILD_LAUNCHES
    x9_keys, x10_rec = check_headline_keys_builds(dev, soup, scene, backend,
                                                  cfg)
    recs.append(x10_rec)
    # K2's image form at every grouped call; K2's grouped form at the mid
    # HD arm's plane table (captured by check_fma32) and the subtile path's
    # compacted tiles (below)
    image_form = check_shade_image(dev, soup, scene, backend, cfg)
    shade_calls = {"mid HD": mid_shade}
    del backend

    # the grouped generations: B9d, B9e, B9f and B10 against their plain
    # versions, then every generation's golden call
    gen_recs = check_generation_kernels(dev, soup, scene)
    recs += gen_recs
    c_gen, gen_fn = _path_counts(counters, lambda: run_generations_path(
        dev, soup, scene))
    print(f"launches on the grouped generations: {c_gen}", flush=True)
    for k in ("setup2dh", "pack", "pack_channels", "raster_group_walk",
              "modal_vote") + tuple(r["name"] for r in gen_recs):
        assert c_gen[k] > 0, f"{k} never launched on the grouped generations"
    for r in gen_recs:
        r["launches"] = c_gen[r["name"]]
    for k in ("bin_entries_keys", "group_build", "raster_shade_image"):
        assert c_gen[k] > 0, f"{k} never launched on the grouped generations"
    assert c_gen["raster_shade"] == c_gen["raster_shade_image"], c_gen
    check_golden_keys_builds(dev, soup, scene)
    shade_stages("subtile3 golden call", profile_frames(
        gen_fn, 5, ("raster.", "frame.", "glyph"), "subtile3 golden call")[2])
    # subtile4 walks B9e where subtile3 walks B9d; subtile5 walks B9f (and
    # packs with B3, not B7)
    gen_frame = _generation_frame(dev, soup, scene)
    for method in ("subtile4", "subtile5"):
        shade_stages(f"{method} golden call", profile_frames(
            lambda: gen_frame(method, False), 5,
            ("raster.", "frame.", "glyph"), f"{method} golden call")[2])

    # the retired generations: B8, B9a, B9b and B9c against their plain
    # versions, then fused, subtile, subtile2 and visibility_subtile
    caps = {}
    for kernel in ("subtile", "subtile2"):
        caps[kernel], tries = _oracle_caps(dev, soup, scene, kernel)
        print(f"{kernel}: caps {caps[kernel]} after {tries} diagnostic "
              f"passes", flush=True)
    oracle_recs = check_oracle_kernels(dev, soup, scene, caps)
    recs += oracle_recs
    shade_calls["subtile"] = _capture(RSH, "shade", _oracle_frame(
        dev, soup, scene, "subtile", caps["subtile"]))[0]
    recs.append(check_raster_shade(dev, shade_calls, image_form))
    del shade_calls, mid_shade
    c_or, or_frames = run_oracle_paths(dev, soup, scene, caps, counters)
    for rec, path in zip(oracle_recs, ("fused", "visibility_subtile",
                                       "subtile", "subtile2")):
        assert c_or[path][rec["name"]] > 0, \
            f"{rec['name']} never launched on the {path} path"
        rec["launches"] = c_or[path][rec["name"]]
    for path in ("fused", "subtile", "subtile2"):
        assert c_or[path]["modal_vote"] > 0, f"B4 not launched on {path}"
    for path in ("subtile", "subtile2"):
        assert c_or[path]["raster_shade"] > 0, f"K2 not launched on {path}"
    for path, kernels in (("fused", ("raster_clip", "raster_clip_slots")),
                          ("subtile", ("raster_clip", "plane_table")),
                          ("subtile2", ("setup2dh", "pack_channels"))):
        for k in kernels:
            assert c_or[path][k] > 0, f"{k} not launched on {path}"
    # fused's clip and attribute slots are X4's slots form, subtile2's
    # setup B2: K1 launches on neither path
    print(f"fma32 launches: fused {c_or['fused']['fma32']}, subtile2 "
          f"{c_or['subtile2']['fma32']}, subtile {c_or['subtile']['fma32']}, "
          f"visibility_subtile {c_or['visibility_subtile']['fma32']}",
          flush=True)
    assert c_or["fused"]["fma32"] == c_or["subtile2"]["fma32"] == 0, c_or
    by_name["setup2dh"]["launches"] += c_or["subtile2"]["setup2dh"]
    or_stages = {}
    for method, fn in or_frames.items():  # B8, B9b, B9c in their frames
        or_stages[method] = profile_frames(
            fn, 3, ("raster.", "frame.", "glyph"), f"{method} golden pose")[2]
    for (method, st), n in ORACLE_FRONT_LAUNCHES.items():
        assert or_stages[method].get(st) == n, (method, or_stages[method])
    # the subtile generation's compaction is X13's too
    assert c_or["subtile"]["partition"] > 0, c_or["subtile"]
    partition_stages("subtile golden pose", or_stages["subtile"],
                     "raster.compact", RASTER_COMPACT_LAUNCHES)

    # path tracer: frame 0 against the CPU render, then the reference run
    # (96x36, spp 64, 5 bounces) and the HD arm (960x540, spp 8)
    pt_frame0_check(dev)
    cfg_ref = Config()
    c_ref, ref_fn = _path_counts(counters, lambda: run_pt_path(
        cfg_ref, 36, 96, 4, 20, "PT reference run 96x36 spp64"))
    print(f"launches on the PT reference run: {c_ref}", flush=True)
    for k in PT_KERNELS + ("modal_vote",):
        assert c_ref[k] > 0, f"{k} never launched on the PT reference run"
    assert c_ref["ray_grid"] == 0, c_ref["ray_grid"]
    by_name["pt_megakernel"]["launches"] = c_ref["pt_megakernel"]
    prof = profile_frames(ref_fn, 3, ("pt.", "frame.", "glyph"),
                          "PT reference run")
    pt_stages("PT reference run", prof[2], 2)
    tails["PT reference run"] = tail_stages("PT reference run", prof,
                                            counters, ref_fn)
    cfg_hd = Config(path_tracer=PathTracerConfig(samples_per_batch=8))
    c_hd, hd_fn = _path_counts(counters, lambda: run_pt_path(
        cfg_hd, ROWS, COLS, 2, 10, "PT HD arm 960x540 spp8"))
    print(f"launches on the PT HD arm: {c_hd}", flush=True)
    for k in PT_KERNELS + ("modal_vote",):
        assert c_hd[k] > 0, f"{k} never launched on the PT HD arm"
    pt_stages("PT HD arm", profile_frames(hd_fn, 3, ("pt.", "frame.",
                                                     "glyph"),
                                          "PT HD arm")[2], 1)

    # small- and mid-scale raster: B6 / B6' and B7 / B7' against their
    # plain versions, then the entry step, config 1, config 2, the
    # mid-scale HD arm and the path-traced frame step
    room = _room(dev)
    cube = _mesh("cube")
    mid_preps = []
    for label, name, grid in (("teapot 240x135", "teapot", TEAPOT_GRID),
                              ("mid-scale HD 960x540", "mid", MID_GRID)):
        msoup, mcam = _mesh(name)
        mid_preps.append((label, grid, _mid_prep(
            tuple(torch.from_numpy(x).to(dev) for x in msoup), scene, mcam,
            *grid)))
        print(f"{label}: {msoup[0].shape[0] // 3} triangles, steady caps "
              f"{mid_preps[-1][2][2]}", flush=True)
    recs += check_bins_kernels(dev, room, cube, mid_preps)
    recs.append(check_bin_entries(dev, room, cube, mid_preps))
    recs += check_pack_channels(dev, mid_preps)
    recs += check_front_kernels(dev, soup, scene, caps)
    recs += check_partition(dev, soup, scene, caps, mid_preps)
    by_name = {r["name"]: r for r in recs}

    raster_prefixes = ("raster.", "frame.", "glyph")
    c_entry, entry_fn = _path_counts(counters, run_entry_path)
    print(f"launches on the entry step: {c_entry}", flush=True)
    for k in ("raster_bins_walk", "modal_vote", "raster_clip_table",
              "raster_shade", "bin_entries", "frame_bytes_ui"):
        assert c_entry[k] > 0, f"{k} never launched on the entry step"
    # the clip, its setup and the plane table: X4's table form alone
    assert c_entry["raster_clip"] == c_entry["raster_clip_table"], c_entry
    assert c_entry["plane_table"] == 0, c_entry
    prof = profile_frames(entry_fn, 5, raster_prefixes, "entry step")
    print(f"entry step a frame: {prof[1]} launches; raster.clip "
          f"{prof[2].get('raster.clip', 0):g} (X4's table form), "
          f"raster.shade {prof[2].get('raster.shade', 0):g} (no X3)",
          flush=True)
    assert prof[2]["raster.clip"] == ENTRY_CLIP_LAUNCHES, prof[2]
    compose_stage("entry step", prof[2])
    walk_launches = {"entry step": prof[2]["raster.walk"]}
    tails["entry step"] = tail_stages("entry step", prof, counters, entry_fn)
    c_cube, _ = _path_counts(counters, lambda: run_cube_path(dev))
    print(f"launches on the cube path: {c_cube}", flush=True)
    for k in ("raster_bins_walk", "raster_bins_walk_loop",
              "raster_clip_table", "bin_entries"):
        assert c_cube[k] > 0, f"{k} never launched on the cube path"
    assert c_cube["plane_table"] == 0, c_cube  # the table form's tables
    c_tea, tea_fn = _path_counts(counters, lambda: run_raster_mesh_path(
        dev, "teapot", TEAPOT_GRID, 3, 2, 20, "teapot 240x135"))
    print(f"launches on the teapot path: {c_tea}", flush=True)
    c_mid, mid_fn = _path_counts(counters, lambda: run_raster_mesh_path(
        dev, "mid", MID_GRID, 2, 0, 10, "mid-scale HD 960x540"))
    print(f"launches on the mid-scale HD arm: {c_mid}", flush=True)
    for c, what in ((c_tea, "teapot path"), (c_mid, "mid-scale HD arm")):
        for k in ("raster_bins_walk", "modal_vote", "raster_shade",
                  "raster_clip", "plane_table", "bin_entries", "partition"):
            assert c[k] > 0, f"{k} never launched on the {what}"
    # raster.compact is X13 alone; the mid arm's raster.shade X3, K2 and
    # the pixel centres (n_big comes from X9's counts)
    partition_stages("teapot 240x135", profile_frames(
        tea_fn, 5, raster_prefixes, "teapot 240x135")[2], "raster.compact",
        RASTER_COMPACT_LAUNCHES)
    mid_stages = profile_frames(mid_fn, 3, raster_prefixes,
                                "mid-scale HD arm")[2]
    walk_launches["mid-scale HD arm"] = mid_stages["raster.walk"]
    partition_stages("mid-scale HD arm", mid_stages, "raster.compact",
                     RASTER_COMPACT_LAUNCHES)
    print(f"mid-scale HD arm: raster.shade {mid_stages['raster.shade']:g} "
          f"kernel launches", flush=True)
    assert mid_stages["raster.shade"] <= MID_SHADE_LAUNCHES, mid_stages
    # X9 leaves raster.walk its passes, the sort, B6's walk and merge and
    # the image assembly after it; fma32 no longer launches in these paths
    print(f"raster.walk kernel launches a frame: {walk_launches}; fma32 "
          f"launches: entry step {c_entry['fma32']}, teapot "
          f"{c_tea['fma32']}, mid-scale HD arm {c_mid['fma32']}", flush=True)
    assert max(walk_launches.values()) <= RASTER_WALK_LAUNCHES, walk_launches
    c_pts, pts_fn = _path_counts(counters, lambda: run_pt_step_path(dev))
    print(f"launches on the PT frame step: {c_pts}", flush=True)
    for k in PT_KERNELS + ("modal_vote",):
        assert c_pts[k] > 0, f"{k} never launched on the PT frame step"
    assert c_pts["frame_bytes_ui"] > 0, c_pts
    prof = profile_frames(pts_fn, 3, ("pt.", "frame.", "glyph"),
                          "PT frame step")
    pt_stages("PT frame step", prof[2], 2)
    compose_stage("PT frame step", prof[2])
    tails["PT frame step"] = tail_stages("PT frame step", prof, counters,
                                         pts_fn)

    # the ray tracer: the golden frame and the "raytrace" step, then the
    # 1,024-view farm, then the progressive path tracer
    rt_prefixes = ("rt.", "frame.", "glyph")
    c_rt, rt_fn = _path_counts(counters, lambda: run_rt_path(dev))
    print(f"launches on the RT path: {c_rt}", flush=True)
    for k in ("modal_vote", "rt_trace"):
        assert c_rt[k] > 0, f"{k} never launched on the RT path"
    prof = profile_frames(rt_fn, 5, rt_prefixes, "RT frame")
    rt_stages = prof[2]
    tails["RT frame"] = tail_stages("RT frame", prof, counters, rt_fn)
    c_farm, farm_fn = _path_counts(counters, lambda: run_farm_path(dev))
    print(f"launches on the view farm: {c_farm}", flush=True)
    for k in ("modal_vote", "rt_trace"):
        assert c_farm[k] > 0, f"{k} never launched on the view farm"
    c_one, _ = _path_counts(counters, farm_fn, record=False)
    assert (c_one["modal_vote"], c_one["ray_grid_jit"],
            c_one["rt_trace"], c_one["frame_bytes"],
            c_one["modal_vote_chars"]) == (1, 0, 1, 1, 1), \
        f"a farm launches B4 and the trace once each, no grid: {c_one}"
    by_name["modal_vote_views"]["launches"] = c_farm["modal_vote"]
    prof = profile_frames(farm_fn, 2, ("rt.", "frame.", "glyph"),
                          "view farm")
    farm_stages = prof[2]
    # rt.grid on the host: the views' trig, K3 forms their bases
    print(f"view farm: rt.grid {prof[3].get('rt.grid', 0.0):.3f} ms of host "
          f"a farm under the profiler, {farm_fn.views_per_s:.1f} views/s",
          flush=True)
    tails["view farm"] = tail_stages("view farm", prof, counters, farm_fn)
    # rt.grid is host work; rt.trace is K3 alone
    for label, st in (("RT frame", rt_stages), ("view farm", farm_stages)):
        assert (st.get("rt.grid", 0), st.get("rt.trace")) == (0, 1), \
            (label, st)
    c_prog, prog_fn = _path_counts(counters,
                                   lambda: run_progressive_path(dev))
    print(f"launches on the progressive tracer: {c_prog}", flush=True)
    for k in PT_KERNELS + ("pt_megakernel_gated", "partition_order"):
        assert c_prog[k] > 0, f"{k} never launched on the progressive path"
    # a compacted frame's set-up: X13's order form and the counters' fill;
    # the statistics step one K1b launch, no fma32 (K1) on the path
    assert c_prog["accum"] > 0 and c_prog["fma32"] == 0, c_prog
    _busy, prog_launches, prog_stages, prog_host = profile_frames(
        prog_fn, 3, ("pt.", "accum."), "progressive HD batch")
    print(f"progressive HD batch: {prog_launches} launches a batch; "
          f"accum.step {prog_stages.get('accum.step', 0.0):g} launches, "
          f"{prog_host.get('accum.step', 0.0):.3f} ms of host; fma32 "
          f"launches on the progressive path {c_prog['fma32']}", flush=True)
    assert 0 < prog_stages.get("accum.step", 0.0) <= ACCUM_STEP_LAUNCHES, \
        prog_stages
    partition_stages("progressive HD batch", prog_stages, "pt.setup",
                     PT_SETUP_COMPACTED_LAUNCHES)
    assert prog_stages.get("pt.rays HtoD", 0.0) == prog_stages.get(
        "pt.rays DtoH", 0.0) == 0.0, prog_stages

    # the app shell: the CLI's modes on the card against its CPU runs,
    # then the exactness canary (B3 and B7' at the reference's shapes)
    c_cli, expand_fn = _path_counts(counters, lambda: run_cli_path(dev))
    print(f"launches in the CLI phase: {c_cli}", flush=True)
    assert c_cli["accum"] > 0, c_cli
    for k in ("pt_megakernel", "modal_vote", "raster_bins_walk", "pack",
              "pack_channels_split", "pt_rays", "pt_reduce", "rt_trace",
              "frame_bytes", "modal_vote_chars", "frame_bytes_ui"):
        assert c_cli[k] > 0, f"{k} never launched in the CLI phase"
    # every vote of the CLI's frames came through the chars form, one X12a
    # launch before each glyph launch
    assert c_cli["modal_vote"] == c_cli["modal_vote_chars"], c_cli
    assert c_cli["frame_bytes"] >= c_cli["modal_vote_chars"] + c_cli[
        "glyph_map"], c_cli
    profile_frames(expand_fn, 20, ("glyph.",), "expand_pixels 96x36")

    # the parallel path: X5 and X5b against their plain versions at config
    # 5's shapes, then config 5's train steps, row bands, the mesh over a
    # world of one card, dryrun_multichip(1)
    soft_recs = check_soft_raster(dev)
    recs += soft_recs
    by_name.update({r["name"]: r for r in soft_recs})
    c_par, (train_fn, band_fn, close) = _path_counts(
        counters, lambda: run_parallel_path(dev, soup, scene))
    print(f"launches in the parallel phase: {c_par}", flush=True)
    for k in PARALLEL_KERNELS:
        assert c_par[k] > 0, f"{k} never launched in the parallel phase"
        if k not in ("pack_channels", "pt_rays", "pt_reduce", "rt_trace",
                     "raster_shade"):  # summed at the end
            by_name[k]["launches"] += c_par[k]
    for k in ("bin_entries_keys", "group_build"):  # the bunny's bands
        assert c_par[k] > 0, f"{k} never launched in the parallel phase"
    check_band_keys_builds(dev, soup, scene)
    try:
        # config 5's steps: one X5 forward, X5b and X5 backward a step
        c_train, _ = _path_counts(counters, train_fn, record=False)
        print(f"config 5, a {CONFIG5_STEPS}-step call: X5 forward "
              f"{c_train['soft_raster_fwd']}, X5b {c_train['soft_loss']}, X5 "
              f"backward {c_train['soft_raster_bwd']} launches", flush=True)
        for k in ("soft_raster_fwd", "soft_loss", "soft_raster_bwd"):
            assert c_train[k] == CONFIG5_STEPS, (k, c_train)
        busy, launches, _st, host = profile_frames(
            train_fn, 1, ("train.",),
            f"config 5 train call ({CONFIG5_STEPS} steps)")
        print(f"config 5 a step: {launches / CONFIG5_STEPS:.2f} kernel "
              f"launches, device busy {busy / CONFIG5_STEPS:.4f} ms, "
              f"{100 * busy / train_fn.median_ms:.2f}% of the median call "
              f"({train_fn.median_ms:.3f} ms, {train_fn.steps_per_s:.1f} "
              f"steps/s), host ms a step by stage " + ", ".join(
                  f"{k} {v / CONFIG5_STEPS:.3f}" for k, v in host.items())
              + f"; the parent: {CONFIG5_PARENT}", flush=True)
        assert launches <= CONFIG5_STEP_LAUNCHES * CONFIG5_STEPS, launches
        shade_stages("band frames", profile_frames(
            band_fn, 3, ("rt.", "pt.", "raster."),
            "band frames (RT 12 rows, PT 12 rows, subtile8 176 rows)")[2])
    finally:
        close()

    # K3, K2, X10, X4, X3, K1 and X13 timed at each size they launched at
    # on the driven paths (all of them are behind: the PT core launches
    # none of them)
    k3_loss(k3_sizes, k3_trace, by_name["rt_trace"])
    _size_losses(recorded, by_name)
    ((x7_sizes, x7_real), (x14_sizes, x14_real)) = pt_sizes
    size_loss("PT sample rays (X7)", x7_sizes, x7_real, "pt_rays_kernel",
              lambda a, k: 1, _x7_size_bound, by_name["pt_rays"])
    size_loss("PT batch fold (X14)", x14_sizes, x14_real, "pt_reduce_kernel",
              lambda a, k: 1, lambda a, k: _x14_bound(a, k)[0][0],
              by_name["pt_reduce"])

    # the path tracer's XLA core: the goldens and the core against B5,
    # then the wide-atlas frame. Last: its profile holds ~20,000 launches a
    # frame, after which the profiler's sessions lost rows
    check_pt_core(dev)
    c_core, core_fn = _path_counts(counters, lambda: run_pt_core_path(dev))
    print(f"launches on the PT core path: {c_core}", flush=True)
    assert c_core["modal_vote"] > 0 and c_core["ray_grid"] > 0
    assert c_core["pt_megakernel"] == 0
    for k in ("rt_trace", "raster_shade", "group_build", "raster_clip",
              "plane_table", "fma32", "partition"):  # losses by size counted
        assert c_core[k] == 0, (k, c_core[k])
    profile_frames(core_fn, 2, ("pt.", "frame.", "glyph"),
                   "PT core wide atlas")
    for k in ("raster_bins_walk", "raster_bins_walk_loop", "pack_channels"):
        by_name[k]["launches"] = sum(
            c[k] for c in (c_gen, c_entry, c_cube, c_tea, c_mid, c_pts,
                           c_par, *c_or.values()))
    # the PT core's centre rays and jittered batches: no kernel-path frame
    # launches the ray grid, X7 computes its rays
    by_name["ray_grid"]["launches"] = sum(
        c["ray_grid"] for c in (c_ref, c_hd, c_pts, c_core, c_par))
    # pack_channels_split's one driven caller is the exactness canary
    by_name["pack_channels_split"]["launches"] = c_cli["pack_channels_split"]
    # the kernels for XLA code: every driven path's launches
    driven = (c_raster, c_gen, *c_or.values(), c_ref, c_hd, c_entry, c_cube,
              c_tea, c_mid, c_pts, c_rt, c_farm, c_prog, c_cli, c_par,
              c_core)
    for k in ("fma32", "raster_shade", "rt_trace", "raster_clip",
              "plane_table", "bin_entries", "group_build", "pt_rays",
              "pt_reduce", "accum"):
        by_name[k]["launches"] = sum(c[k] for c in driven)
        assert by_name[k]["launches"] > 0, k
    # the table form's launches are X4's, and X3's tables folded into them;
    # the slots form's are X4's too
    by_name["raster_clip"]["launches_table"] = by_name["plane_table"][
        "folded"] = sum(c["raster_clip_table"] for c in driven)
    by_name["raster_clip"]["launches_slots"] = by_name["raster_clip"][
        "slots_form"]["launches"] = sum(c["raster_clip_slots"]
                                        for c in driven)
    assert by_name["raster_clip"]["launches_slots"] > 0
    # the glyph tail: X12a, B4's chars form and glyph_map on every path
    for k in ("frame_bytes", "modal_vote_chars", "glyph_map"):
        by_name[k]["launches"] = sum(c[k] for c in driven)
        assert by_name[k]["launches"] > 0, k
    # K2's image form (in K2's launches) and X12a's UI form (in X12a's)
    for rec, k, form in ((by_name["raster_shade"], "raster_shade_image",
                          "image_form"),
                         (by_name["frame_bytes"], "frame_bytes_ui",
                          "ui_form")):
        rec[form]["launches"] = sum(c[k] for c in driven)
        assert rec[form]["launches"] > 0, k
    print(f"glyph tail a frame (host ms, launches): {json.dumps(tails)}",
          flush=True)
    # K3 computes the jitted grid's rays on every render path
    by_name["ray_grid_jit"]["launches"] = sum(c["ray_grid_jit"]
                                              for c in driven)
    assert by_name["ray_grid_jit"]["launches"] == 0, \
        [c["ray_grid_jit"] for c in driven]
    # the losses by launch size count every driven launch
    for k in ("raster_shade", "group_build", "raster_clip", "plane_table",
              "fma32", "pt_rays", "pt_reduce"):
        assert sum(p["launches"] for p in by_name[k]["launch_sizes"]) == \
            by_name[k]["launches"], (k, by_name[k]["launch_sizes"],
                                     by_name[k]["launches"])
    # X13's calls by form, on every driven path
    by_name["partition_order"]["launches"] = sum(c["partition_order"]
                                                 for c in driven)
    by_name["partition"]["launches"] = sum(
        c["partition"] for c in driven) - by_name["partition_order"][
        "launches"]
    for k in ("partition", "partition_order"):
        assert by_name[k]["launches"] > 0, k
        assert sum(p["launches"] for p in by_name[k]["launch_sizes"]) == \
            by_name[k]["launches"], (k, by_name[k]["launch_sizes"],
                                     by_name[k]["launches"])
    # X9's launches in both layouts: the tile keys' and the bin keys'
    by_name["bin_entries"]["launches_tile"] = by_name["bin_entries"][
        "launches"]
    by_name["bin_entries"]["launches_keys"] = sum(
        c["bin_entries_keys"] for c in driven)
    by_name["bin_entries"]["launches"] += by_name["bin_entries"][
        "launches_keys"]
    by_name["bin_entries"].update(x9_keys)
    k3_rec = by_name["rt_trace"]
    assert sum(p["launches"] for p in k3_rec["launch_sizes"]) == \
        k3_rec["launches"], (k3_rec["launch_sizes"], k3_rec["launches"])

    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
