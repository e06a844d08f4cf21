#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (ascii_renderer_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), torch and CUDA.
2. Builds the CUDA kernels of ascii_renderer_tpu_torch/ops/csrc with nvcc.
3. Runs each kernel of the raster main path at the headline shapes
   (bunny-class mesh, 68,644 triangles, 960x540) on the card against its
   plain-torch version on the same CUDA inputs: setup (B2) valid flags
   equal, planes within rtol 5e-4 / atol 1e-5 and in fact bit-exact;
   pack (B3) bit-exact; grouped walk (B1) winner ids and depths exactly
   equal. Median ms over
   20 runs of each, timed with CUDA events.
4. Drives the main path as a user would: RasterBackend.set_soup(bunny),
   render at 960x540, glyph_decide; frame 0 at the golden camera must
   give the reference frame (checksum + the ds20 golden), then 3 more
   frames with update_camera. Every kernel of the path must have been
   launched in that run.
5. Times 20 steady-state frames at the golden pose (median, p90), then
   profiles 5 more (stage and kernel times, the device's busy share;
   the full table goes to smoke_out/profile.txt).
6. Prints {"kernels": [...]} and, as the last line,
   {"ok": true, "device": {...}}.

Exits non-zero (and prints no result) without CUDA or without the
package beside it. Every check is an assert or an explicit raise.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ROWS, COLS, PIXEL_ASPECT = 540, 960, 0.5
# The headline frame's golden (tests/test_headline_goldens.py): the sum of
# all 518,400 glyph codes and a 27 x 48 downsample of the grid.
BUNNY_CHECKSUM = 32392648
GOLDEN_DS20 = os.path.join(ROOT, "tests", "goldens", "bunny_960x540_ds20.txt")


def _cuda_ms(fn, n=20):
    """Median ms of fn() over n runs, each bracketed by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def check_kernels(dev, soup, scene):
    """Each kernel against its plain version at the main path's shapes
    (the shapes of frame 0's first render). Returns per-kernel records."""
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
    recs.append(dict(
        name="setup2dh", route="cuda",
        source="ascii_renderer_tpu_torch/ops/csrc/setup2dh.cu",
        replaces="ascii_renderer_tpu/ops/setup2dh.py:43",
        max_abs_err=err,
        ms=_cuda_ms(lambda: S.setup_2dh_fused(pos9, attrs_t, mvp, ROWS,
                                              COLS)),
        plain_ms=_cuda_ms(lambda: S.setup_2dh_fused_ref(pos9, attrs_t, mvp,
                                                        ROWS, COLS))))
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
    recs.append(dict(
        name="pack", route="cuda",
        source="ascii_renderer_tpu_torch/ops/csrc/pack.cu",
        replaces="ascii_renderer_tpu/ops/pack.py:170",
        max_abs_err=0.0,
        ms=_cuda_ms(lambda: PK.pack_channels_split_blocked(cm_k, spans)),
        plain_ms=_cuda_ms(lambda: PK.pack_channels_split_blocked_ref(
            cm_k, spans))))
    print("B3 pack: bit-exact", flush=True)

    # B1 grouped walk, on the layout frame 0's first render builds
    T = p.shape[0] // 3
    n2t = 2 * T
    tiles_x = -(-COLS // 128)
    n_tiles = (-(-ROWS // 8)) * tiles_x
    r_cap, pair_cap, grp_cap = R._round_up(n2t, 2048), 4 * n2t, n_tiles
    keys = R._subtile_pair_keys_bbox(bb_k, ROWS, COLS, big_cap=64)
    lay = RG.build_packed_rows_grouped_kgather(
        outs_k[0], keys, tiles_x, n_tiles, r_cap, pair_cap, grp_cap, 8)
    z_k, e_k = RG.tile_eval_grouped_skip(*lay[:6], grp_cap)
    z_r, e_r = RG.tile_eval_grouped_skip_ref(*lay[:6], grp_cap)
    torch.cuda.synchronize()
    assert torch.equal(e_k, e_r), "B1 winner ids differ"
    assert torch.equal(z_k, z_r), "B1 depths differ"
    hits = int((e_k >= 0).sum())
    assert hits > 20000, hits
    recs.append(dict(
        name="raster_group_walk", route="cuda",
        source="ascii_renderer_tpu_torch/ops/csrc/raster_group.cu",
        replaces="ascii_renderer_tpu/ops/raster_group.py:256",
        max_abs_err=0.0,
        ms=_cuda_ms(lambda: RG.tile_eval_grouped_skip(*lay[:6], grp_cap)),
        plain_ms=_cuda_ms(lambda: RG.tile_eval_grouped_skip_ref(
            *lay[:6], grp_cap))))
    print(f"B1 walk: exact, {hits} lit pixels, n_rows={int(lay[7])}",
          flush=True)
    return recs


def _frame(backend, cfg, cam):
    """One user frame: RasterBackend.render, then the glyph pass."""
    from ascii_renderer_tpu_torch.ascii.ascii_pass import glyph_decide
    frame = backend.render(0.0, cam, ROWS, COLS, PIXEL_ASPECT)
    chars, _tint = glyph_decide(
        frame, ramp=cfg.ascii_ramp, mode_on=cfg.ascii_mode_filter,
        mode_radius=cfg.mode_radius, mode_thresh=cfg.ascii_mode_thresh,
        grayscale=cfg.use_grayscale)
    return frame, chars


def run_main_path(dev, soup, scene):
    """RasterBackend + glyph pass: 4 checked frames (the golden pose, then
    3 camera moves), then 20 timed steady-state frames at the golden pose.
    Returns (per-frame ms of the 4, steady ms list, backend, cfg)."""
    import numpy as np
    import torch
    from ascii_renderer_tpu_torch.backends.raster import RasterBackend
    from ascii_renderer_tpu_torch.core.camera import (CameraInputs,
                                                      update_camera)
    from ascii_renderer_tpu_torch.core.config import Config

    cfg = Config(pixel_aspect=PIXEL_ASPECT)
    backend = RasterBackend(cfg, device=dev)
    backend.set_soup(*soup, scene)
    cam = _golden_camera()
    moves = [CameraInputs.from_keys(("w", "arrowleft")),
             CameraInputs.from_keys(("a",), mouse_dx=25.0),
             CameraInputs.from_keys(("s", "arrowup"), mouse_dy=-10.0)]
    frame_ms = []
    for f in range(4):
        if f:
            cam = update_camera(cam, moves[f - 1], 1.0 / 30.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame, chars = _frame(backend, cfg, cam)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
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
            print(f"frame 0: checksum {total} and the ds20 golden, exact",
                  flush=True)
        print(f"frame {f}: {frame_ms[-1]:.3f} ms, {lit} lit cells, "
              f"caps {backend._caps}", flush=True)
    steady = []
    for _ in range(20):
        t0 = time.perf_counter()
        _frame(backend, cfg, _golden_camera())
        torch.cuda.synchronize()
        steady.append((time.perf_counter() - t0) * 1e3)
    return frame_ms, steady, backend, cfg


def profile_frames(backend, cfg, n=5):
    """torch.profiler over n steady frames: per-stage host and device ms
    per frame (the named ranges of backends/raster and ascii_pass), the
    device's busy share of the wall time, and the top kernels. The full
    table goes to smoke_out/profile.txt (git-ignored)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cam = _golden_camera()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            _frame(backend, cfg, cam)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    avgs = prof.key_averages()
    stage_prefixes = ("raster.", "frame.", "glyph")
    # a stage appears twice: its host range (CPU) and its span on the
    # device stream (a CUDA annotation, gaps included); kernels are the
    # other CUDA rows
    spans = {e.key: e.device_time_total / n / 1e3 for e in avgs
             if e.device_type == DeviceType.CUDA
             and e.key.startswith(stage_prefixes)}
    kern = sorted((e for e in avgs if e.device_type == DeviceType.CUDA
                   and not e.key.startswith(stage_prefixes)),
                  key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kern) / n / 1e3
    print(f"profile: {wall:.3f} ms/frame under the profiler, device busy "
          f"{busy:.3f} ms/frame ({100 * busy / wall:.1f}%), "
          f"{sum(e.count for e in kern) // n} kernel launches/frame",
          flush=True)
    for e in sorted(avgs, key=lambda e: -e.cpu_time_total):
        if e.device_type == DeviceType.CPU and e.key.startswith(
                stage_prefixes):
            print(f"  stage {e.key}: host {e.cpu_time_total / n / 1e3:.3f} "
                  f"ms, device span {spans.get(e.key, 0.0):.3f} ms",
                  flush=True)
    for e in kern[:10]:
        print(f"  kernel {e.key[:60]}: {e.self_device_time_total / n / 1e3:.3f}"
              f" ms/frame, {e.count // n} launches/frame", flush=True)
    out = os.path.join(ROOT, "smoke_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "profile.txt"), "w") as fh:
        fh.write(avgs.table(sort_by="self_device_time_total", row_limit=200))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import ascii_renderer_tpu_torch  # noqa: F401  (fails outside the repo)
    from ascii_renderer_tpu_torch.ops import _build
    from ascii_renderer_tpu_torch.ops import pack as PK
    from ascii_renderer_tpu_torch.ops import raster_group as RG
    from ascii_renderer_tpu_torch.ops import setup2dh as S

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

    dev = torch.device("cuda:0")
    soup = _bunny()
    scene = _scene(dev)
    recs = check_kernels(dev, soup, scene)

    mods = {"setup2dh": S, "pack": PK, "raster_group_walk": RG}
    for m in mods.values():
        m.launches = 0
    frame_ms, steady, backend, cfg = run_main_path(dev, soup, scene)
    counts = {k: m.launches for k, m in mods.items()}
    for r in recs:
        r["launches"] = counts[r["name"]]
        assert r["launches"] > 0, f"{r['name']} never launched on the path"
    print(f"frame ms: {frame_ms}", flush=True)
    q = statistics.quantiles(steady, n=10)
    print(f"steady frames (20, golden pose): median "
          f"{statistics.median(steady):.3f} ms, p90 {q[-1]:.3f} ms, "
          f"min {min(steady):.3f} ms", flush=True)
    profile_frames(backend, cfg)
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
