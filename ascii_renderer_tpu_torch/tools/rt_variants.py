"""Timed variants of the ray tracer's frame kernel K3 (``ops/rt_trace``):
its device ms at every form the C entry point can be asked for, at the
five launch sizes of the driven paths, on one card.

The forms: L lanes a ray (``--lanes``, default 1, 4, 8 and 32) with the
valid slots staged in shared memory or read from the global arrays, and
the launch's own choice. The sizes: the rt_demo golden frame's first 256,
512 and 1,152 rays and all its 3,456 (the golden call's padded slots: 8
sphere, 8 plane and 24 triangle slots, 4 of them valid) and the 1,024-view
farm (3,538,944 rays, exact slots). Each form's output is held to
``raytrace.trace_rgb`` bit for bit before it is timed; the time is the
profiler's kernel rows over 50 back-to-back calls (``chip_smoke
._device_ms``). The table goes to stdout, one JSON line last. Run from
the repo root on a machine with one NVIDIA GPU:

    python3 -m ascii_renderer_tpu_torch.tools.rt_variants
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
SIZES = (256, 512, 1152, 3456)  # the golden frame's first rays


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", default="1,4,8,32",
                    help="lanes a ray to time, comma-separated")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("rt_variants: CUDA is not available")
    from ascii_renderer_tpu_torch.backends import rt_core as RC
    from ascii_renderer_tpu_torch.backends.raytrace import trace_rgb
    from ascii_renderer_tpu_torch.ops import rt_trace as RTK
    from ascii_renderer_tpu_torch.scene.demo import create_rt_demo_scene
    cs = _chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda:0")
    lanes = [int(x) for x in a.lanes.split(",")]
    golden = create_rt_demo_scene().build(device=dev)
    scene, pr, cam, rd3 = (golden, *cs._rt_inputs(
        golden, golden.camera, *cs.FARM_GRID, dev))
    runs = [(f"{n} rays (golden frame)", (scene, pr, cam,
                                          rd3[:, :n].contiguous()))
            for n in SIZES]
    farm = create_rt_demo_scene().build(min_pad=1, device=dev)
    runs.append((f"{cs.FARM_VIEWS * 3456} rays (farm)",
                 (farm, *cs._rt_inputs(farm, cs._orbit(), *cs.FARM_GRID,
                                       dev))))
    table = {}
    for label, args in runs:
        V, R = args[3].shape[:2]
        fuse = (RC.sphere_c_fused((V, 1, 1), args[1].n_sph),
                RC.sphere_c_fused((V, 1, R), args[1].n_sph))
        want = trace_rgb(*args)
        row = {}
        forms = [(L, st) for L in lanes for st in ("staged", "global")]
        for L, st in forms + [(0, "auto")]:
            def fn(L=L, st=st):
                return RTK.trace(*args, fuse, lanes=L, stage=st)
            cs._same_bits(fn(), want, f"K3 {label} L={L} {st}")
            row[f"L={L} {st}" if L else "auto"] = cs._device_ms(
                fn, "rt_trace_kernel", 1)
        choice = RTK.launch_form(V * R, args[1])
        row["auto is"] = f"L={choice[0]} {'staged' if choice[1] else 'global'}"
        table[label] = row
        print(f"K3 {label}: " + "; ".join(
            f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "k3_variants_ms": table}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
