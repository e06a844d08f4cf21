"""A/B of the path-trace megakernel B5, the bin walks B6 / B6', the
fused-shading walk B8, the grouped walks B1, B9d, B9e and B9f and the
subtile walks B9a, B9b and B9c between two checkouts of the repo on one
card.

Each side runs in its own process with its own checkout's
``ascii_renderer_tpu_torch`` (kernels built from that checkout's
``ops/csrc``), in turns: other, this, this, other. A side times, by the
profiler's kernel rows over 50 back-to-back calls (``chip_smoke
._device_ms``, whose row count check takes the side's launches per call):

- B5 at every launch shape of the PT runs (``chip_smoke._pt_batch``): the
  reference run's batch (110,592 rays) and probe (3,456), the HD arm's
  probe (518,400) and batch (4,147,200);
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
  ``subtile_walk_kernel`` (+ ``_merge``).

Both sides' outputs must be bit-identical (a digest per kernel and shape);
the inputs are built by the side's own package from this checkout's
``chip_smoke.py``. Run from the repo root on a machine with one NVIDIA GPU,
with the other checkout unpacked in a git-ignored directory:

    python3 -m ascii_renderer_tpu_torch.tools.kernel_ab --other DIR
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # this checkout's root
DEVICE = "cuda:0"
PT_SHAPES = ((36, 96, 32, "reference batch"), (36, 96, 1, "reference probe"),
             (540, 960, 1, "HD probe"), (540, 960, 8, "HD arm batch"))
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


def worker(root: str) -> dict:
    """Times B5, B6 / B6', B8, B1, B9d, B9e, B9f, B9a, B9b and B9c with the
    package of checkout ``root``."""
    sys.path.insert(0, root)
    import torch

    import ascii_renderer_tpu_torch as pkg
    if not Path(pkg.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {pkg.__file__}, not {root}'s package")
    from ascii_renderer_tpu_torch.ops import pt_kernel as PK
    from ascii_renderer_tpu_torch.ops import raster_bins as RB
    from ascii_renderer_tpu_torch.ops import raster_group as RG
    from ascii_renderer_tpu_torch.ops import raster_subtile as RS
    cs = _chip_smoke()
    dev = torch.device(DEVICE)
    out = {"root": root, "b5_ms": {}, "b6_ms": {}, "b8_ms": {}, "b1_ms": {},
           "b9d_ms": {}, "b9e_ms": {}, "b9f_ms": {}, "b9a_ms": {},
           "b9b_ms": {}, "b9c_ms": {}, "digest": {}}
    scene = cs._pt_scene(device=dev)
    for rows, cols, B, label in PT_SHAPES:
        args, kw, _uid, n = cs._pt_batch(dev, scene, rows, cols, B, 1)
        out["digest"][f"B5 {label}"] = _digest(PK.trace_blocks_raw(*args,
                                                                   **kw))
        out["b5_ms"][f"{label} ({n} rays)"] = cs._device_ms(
            lambda: PK.trace_blocks_raw(*args, **kw), "pt_trace_kernel",
            _per_call(PK, "trace_blocks_raw"))
    mid_preps = []
    for label, name, grid in (("teapot 240x135", "teapot", cs.TEAPOT_GRID),
                              ("mid-scale HD 960x540", "mid", cs.MID_GRID)):
        msoup, mcam = cs._mesh(name)
        mid_preps.append((label, grid, cs._mid_prep(
            tuple(torch.from_numpy(x).to(dev) for x in msoup),
            cs._scene(dev), mcam, *grid)))
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
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.worker)), flush=True)
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
        res = subprocess.run([sys.executable, __file__, "--worker", root],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"{side} side ({root}) failed:\n"
                               f"{res.stderr[-4000:]}")
        runs.append((side, json.loads(res.stdout.strip().splitlines()[-1])))
        print(f"{side}: {json.dumps(runs[-1][1])}", flush=True)
    digests = {json.dumps(r["digest"], sort_keys=True) for _s, r in runs}
    if len(digests) != 1:
        raise AssertionError("the two checkouts' outputs differ")
    summary = {}
    for key in ("b5_ms", "b6_ms", "b8_ms", "b1_ms", "b9d_ms", "b9e_ms",
                "b9f_ms", "b9a_ms", "b9b_ms", "b9c_ms"):
        for shape in runs[0][1][key]:
            summary[f"{key[:-3].capitalize()} {shape}"] = {
                side: statistics.median(r[key][shape] for s, r in runs
                                        if s == side)
                for side in ("other", "this")}
    for shape, ms in summary.items():
        print(f"{shape}: other {ms['other']:.5f} ms, this {ms['this']:.5f} "
              f"ms, other / this {ms['other'] / ms['this']:.2f}", flush=True)
    print("outputs bit-identical in both checkouts", flush=True)
    print(json.dumps({"runs": [dict(side=s, **r) for s, r in runs],
                      "median_ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
