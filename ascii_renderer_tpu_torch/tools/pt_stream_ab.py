"""A/B of the path-trace megakernel's two entry-stream modes on one card.

``ops/csrc/pt_trace.cu`` keeps the entry stream resident in shared memory
when it fits one chunk (<= 64 entries: staged once, each warp takes rays
and leaves on its own) and streams it in chunks behind block barriers
otherwise (every thread at every barrier; a block leaves when the ray
counter is spent and no lane holds a ray). This script builds a second copy
of the kernel library whose ``pt_trace.cu`` always takes the chunked mode,
and drives the path tracer's two runs of bench config 0 (the demo room with
its atlas, 28 entries, poster pose) through both builds, interleaved
resident, chunked, chunked, resident:

- reference run: 96x36, spp 64 (2 batches of 32), 5 bounces, NEE;
- HD arm: 960x540, spp 8 (1 batch), 5 bounces, NEE.

Each measurement is a fresh ``Renderer(cfg, "pathtrace")``: frame 0 of
both builds must be bit-identical (rgb and alpha); then the host frame
median over 20 frames (10 for the HD arm), render + glyph pass,
synchronised; then the B5 device ms per frame from the profiler's
``pt_trace_kernel`` rows over 5 frames.

Run from the repo root on a machine with one NVIDIA GPU:

    python3 -m ascii_renderer_tpu_torch.tools.pt_stream_ab
"""

from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ascii_renderer_tpu_torch.ascii.ascii_pass import glyph_decide
from ascii_renderer_tpu_torch.atlas.io import demo_atlas
from ascii_renderer_tpu_torch.backends.registry import Renderer
from ascii_renderer_tpu_torch.core.camera import Camera
from ascii_renderer_tpu_torch.core.config import Config, PathTracerConfig
from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.scene.demo import create_demo_scene

RESIDENT = "const bool resident = n_entries <= kChunk;"
POSE = dict(pos=(0.0, 2.5, 6.0), yaw=-math.pi / 2)
RUNS = (("reference run 96x36 spp64", 36, 96, Config(), 20),
        ("HD arm 960x540 spp8", 540, 960,
         Config(path_tracer=PathTracerConfig(samples_per_batch=8)), 10))


def chunked_lib(tmp: str):
    """The kernel library built from a copy of csrc/ whose pt_trace.cu
    never takes the resident mode."""
    csrc = Path(tmp) / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    src = csrc / "pt_trace.cu"
    text = src.read_text()
    if text.count(RESIDENT) != 1:
        raise RuntimeError("pt_trace.cu has no resident-mode switch to turn "
                           "off")
    src.write_text(text.replace(RESIDENT, "const bool resident = false;"))
    saved = (_build.CSRC, _build.BUILD_DIR, _build._lib)
    _build.CSRC, _build.BUILD_DIR = csrc, Path(tmp) / "build"
    _build._lib = None
    try:
        return _build.lib()
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._lib = saved


def _same(x, y) -> bool:
    """Bit-equality of two (rgb f32, a u8) frames."""
    def bits(t):
        return t.view(torch.int32) if t.is_floating_point() else t
    return all(torch.equal(bits(a), bits(b)) for a, b in zip(x, y))


def measure(handle, scene, rows, cols, cfg, n_timed):
    """Frame 0 (rgb, a) on the host, the host frame median (ms) and the
    B5 device ms per frame, with the library ``handle`` loaded."""
    _build._lib = handle
    r = Renderer(cfg, "pathtrace", device="cuda")
    r.set_scene(scene)
    cam = Camera.create(**POSE)

    def one():
        frame = r.render(0.0, cam, rows, cols)
        glyph_decide(frame, ramp=cfg.ascii_ramp,
                     mode_on=cfg.ascii_mode_filter,
                     mode_radius=cfg.mode_radius,
                     mode_thresh=cfg.ascii_mode_thresh,
                     grayscale=cfg.use_grayscale)
        return frame

    f0 = one()
    first = (f0.rgb.cpu(), f0.a.cpu())
    one()
    times = []
    for _ in range(n_timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    n_prof = 5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            one()
        torch.cuda.synchronize()
    rows_ = [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and "pt_trace_kernel" in e.key]
    if not rows_:
        raise RuntimeError("no pt_trace_kernel rows in the profile")
    b5 = sum(e.self_device_time_total for e in rows_) / n_prof / 1e3
    return first, statistics.median(times), b5


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("pt_stream_ab: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    resident = _build.lib()
    sb = create_demo_scene()
    sb.set_atlas(demo_atlas())
    scene = sb.build(min_pad=1, device="cuda")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"resident": resident, "chunked": chunked_lib(tmp)}
        for label, rows, cols, cfg, n_timed in RUNS:
            seen = {"resident": [], "chunked": []}
            ref = None
            for mode in ("resident", "chunked", "chunked", "resident"):
                first, med, b5 = measure(libs[mode], scene, rows, cols, cfg,
                                         n_timed)
                ref = first if ref is None else ref
                if not _same(first, ref):
                    raise AssertionError(f"{label}: {mode} frame 0 differs "
                                         "from the resident build's")
                seen[mode].append((med, b5))
                print(f"{label} {mode}: frame median {med:.3f} ms, B5 "
                      f"{b5:.4f} ms/frame", flush=True)
            print(f"{label}: frame 0 bit-identical in both modes", flush=True)
            out[label] = {m: {"frame_median_ms": [x[0] for x in v],
                              "b5_ms_per_frame": [x[1] for x in v]}
                          for m, v in seen.items()}
    _build._lib = resident
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
