"""Timed forms of the path tracer's frame kernels, on one card: the sample
rays X7 (``ops/ray_grid.pt_rays``), the batch fold X14
(``ops/pt_reduce.fold``) and the megakernel B5's two input forms
(``ops/pt_kernel``), each in the form its wrapper takes at the size.

X7 is timed at the launches the driven paths make: the HD arm's batch (8
x 960x540, every sample of a slot in one thread, staged stores) and probe
(a sample a thread, direct stores), the reference run's batch (32 x
96x36) and a band's batch (32 x 12x96), beside a fill of the HD batch's
ray block (the floor of its stores). X14 is timed at the reference run's
two launches (batch 0's first fold, batch 1's fold with the resolve), the
HD arm's one (first fold with the resolve) and batches of 8 over 480x270
(the slot form) and 240x135 (the tile form), on each side of the size
where the wrapper changes form. B5 is timed in its frame form (the light
and one origin by value, ``trace_frame``) and its per-ray form
(``trace_blocks_raw``, on the origin block and uid block a frame used to
stage) at the reference batch (110,592 rays) and the HD arm's
(4,147,200).

Every output is held to its plain version bit for bit first (B5's two
forms to each other). Device ms by the profiler's kernel rows over 50
back-to-back calls (``chip_smoke._device_ms``). The table goes to stdout,
one JSON line last. Run from the repo root on a machine with one NVIDIA
GPU (~1 minute with the build):

    python3 -m ascii_renderer_tpu_torch.tools.pt_variants
"""

from __future__ import annotations

import json
import subprocess

from ascii_renderer_tpu_torch.tools.kernel_ab import _chip_smoke

X7_CALLS = ("HD arm batch", "HD probe", "reference batch 0",
            "band batch 1")
# X14's timed launches: (pixels, samples, first, resolve)
X14_CALLS = {"reference batch 0": (3456, 32, True, False),
             "reference batch 1 with the resolve": (3456, 32, False, True),
             "HD arm batch with the resolve": (518400, 8, True, True),
             "480x270 batch of 8": (129600, 8, False, False),
             "240x135 batch of 8": (32400, 8, False, False)}


def run_x7(cs, dev, out):
    import torch
    from ascii_renderer_tpu_torch.core.camera import camera_basis
    from ascii_renderer_tpu_torch.ops import ray_grid as RYG
    cam = cs._pt_camera()
    basis = camera_basis(cam.yaw, cam.pitch, cam.fov_y)
    for label in X7_CALLS:
        args, kw, n, pc = cs._pt_rays_call(dev, basis,
                                           *cs.PT_RAY_CALLS[label])
        got = RYG.pt_rays(*args, **kw)
        want = RYG.pt_rays_ref(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            label
        ms = cs._device_ms(lambda: RYG.pt_rays(*args, **kw),
                           "pt_rays_kernel", 1)
        per = RYG.samples_per_thread(pc, kw.get("samples", 1))
        key = f"X7 {label} ({n} rays), {per} samples a thread"
        out[key] = ms
        print(f"{key}: {ms:.5f} ms", flush=True)


def run_x14(cs, dev, out):
    import torch
    from ascii_renderer_tpu_torch.ops import pt_reduce as PR
    from ascii_renderer_tpu_torch.tools.xla_inputs import pt_outputs

    def outs(n, seed):
        return [torch.from_numpy(x).to(dev)
                for x in pt_outputs(-(-n // 1024) * 1024, seed=seed,
                                    p_override=0.003)]

    for label, (pc, B, first, resolve) in X14_CALLS.items():
        o, probe = outs(B * pc, 5), outs(pc, 6)
        kw = dict(first=first, probe=probe[:4] if resolve else None,
                  spp=B if first else 2 * B)
        base = PR.new_state(pc, dev)
        base[0].copy_(torch.from_numpy(pt_outputs(6 * pc, seed=7)[0])
                      .reshape(6, pc))
        base[1].copy_((base[0][5] > 2.5).to(torch.int32) * 65)
        want_state = tuple(t.clone() for t in base)
        want = PR.fold_ref(want_state, *o[:4], B, **kw)
        state = tuple(t.clone() for t in base)
        got = PR.fold(state, *o[:4], B, **kw)
        torch.cuda.synchronize()
        for g, w in zip((*state, *(got or ())),
                        (*want_state, *(want or ()))):
            if g.is_floating_point():
                cs._same_nan_bits(g, w, f"X14 {label}")
            else:
                assert torch.equal(g, w), f"X14 {label}"
        ms = cs._device_ms(lambda: PR.fold(state, *o[:4], B, **kw),
                           "pt_reduce_kernel", 1)
        key = f"X14 {label} ({pc} pixels x {B}), {PR.form_of(pc)} form"
        out[key] = ms
        print(f"{key}: {ms:.5f} ms", flush=True)


def run_b5(cs, dev, out):
    import torch
    from ascii_renderer_tpu_torch.ops import pt_kernel as PK
    scene = cs._pt_scene(device=dev)
    for rows, cols, B, label in ((36, 96, 32, "reference batch"),
                                 (540, 960, 8, "HD arm batch")):
        args, kw, _uid, n = cs._pt_batch(dev, scene, rows, cols, B, 1)
        frame, _plain, per_ray = cs._b5_frame_form(PK, args, kw,
                                                   rows * cols, rows * cols)
        for a, b in zip(frame(), per_ray()):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                label
        for form, fn in (("frame form", frame), ("per-ray form", per_ray)):
            ms = cs._device_ms(fn, "pt_trace_kernel", 1)
            key = f"B5 {label} ({n} rays), {form}"
            out[key] = ms
            print(f"{key}: {ms:.5f} ms", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("pt_variants: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    cs = _chip_smoke()
    dev = torch.device("cuda:0")
    out = {}
    run_x7(cs, dev, out)
    run_x14(cs, dev, out)
    run_b5(cs, dev, out)
    # the floor of X7's stores: a fill of the HD batch's ray block
    block = torch.empty((4050, 8, 128, 3), device=dev)
    key = "fill of the HD batch's ray block (49.8 MB)"
    out[key] = cs._device_ms(lambda: block.fill_(0.0), None, 1)
    print(f"{key}: {out[key]:.5f} ms", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
