"""Timed launch geometries of the raster front end, on one card: the clip
with its screen setup X4 (``ops/raster_clip.clip_screen``), its slots
form (``clip_screen_slots``: the clip and the attribute slots of the
fused-shading path in one launch), its table form (``clip_screen_table``:
the clip and the plane table of the uncompacted slots in one launch) and
the standalone plane table X3 (``ops/plane_table.plane_table``).

The variants are builds of the package's own sources with another value
of a constant the source leaves open (``tools/build_variants``' way):
X4's blocks of 128 threads (``RC_THREADS``: 64 or 256), which the slots
form shares; the table form's
16 source slots in blocks of 256 threads (``RC_TABLE_SLOTS`` /
``RC_TABLE_THREADS``: 32 / 256, 16 / 128, 64 / 256); X3's blocks of 128
rows (``PT_THREADS``: 64 or 256).
Each is built here into its own library and run through the package's
wrapper, which this tool points at that library for the call.

The calls are those each caller gives the wrappers
(``chip_smoke._front_calls``): the entry() room and the cube (the table
form; X4 and X3 standalone at the room's inputs too), the teapot 240x135,
the mid-scale HD arm, the bunny's fused (the slots form) and subtile (X4
and X3) calls, and the seeded near-plane soups. At each call every output is held to the
plain version bit for bit first, then device ms by the profiler's kernel
rows over 50 back-to-back calls (``chip_smoke._device_ms``). The table
goes to stdout, one JSON line last. Run from the repo root on a machine
with one NVIDIA GPU (~2 minutes with the builds):

    python3 -m ascii_renderer_tpu_torch.tools.front_variants
"""

from __future__ import annotations

import json
import subprocess

from ascii_renderer_tpu_torch.tools.build_variants import (build_variant,
                                                           launching_from)
from ascii_renderer_tpu_torch.tools.kernel_ab import _chip_smoke

# (source, entry point, defines) of each variant, by wrapper and name
VARIANTS = {
    "clip_screen": {
        f"{t} threads": ("raster_clip.cu", "raster_clip_launch",
                         (f"-DRC_THREADS={t}",)) for t in (64, 256)},
    "clip_screen_slots": {
        f"{t} threads": ("raster_clip.cu", "raster_clip_slots_launch",
                         (f"-DRC_THREADS={t}",)) for t in (64, 256)},
    "clip_screen_table": {
        f"{s} slots, {t} threads": (
            "raster_clip.cu", "raster_clip_table_launch",
            (f"-DRC_TABLE_SLOTS={s}", f"-DRC_TABLE_THREADS={t}"))
        for s, t in ((32, 256), (16, 128), (64, 256))},
    "plane_table": {
        f"{t} rows": ("plane_table.cu", "plane_table_launch",
                      (f"-DPT_THREADS={t}",)) for t in (64, 256)}}
SHIPPED = {"clip_screen": "128 threads",
           "clip_screen_slots": "128 threads",
           "clip_screen_table": "16 slots, 256 threads",
           "plane_table": "128 rows"}
KERNELS = {"clip_screen": "raster_clip_kernel",
           "clip_screen_slots": "raster_clip_slots_kernel",
           "clip_screen_table": "raster_clip_table_kernel",
           "plane_table": "plane_table_kernel"}


def front_calls(cs, dev):
    """{wrapper: {caller: (args, kwargs)}}: chip_smoke._front_calls, with
    X4 and X3 also at the entry() room's inputs (812 slots, the 1,624
    uncompacted rows)."""
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    soup, scene = cs._bunny(), cs._scene(dev)
    caps = {"subtile": cs._oracle_caps(dev, soup, scene, "subtile")[0]}
    calls = cs._front_calls(dev, soup, scene, caps)
    args, kw = calls["clip_screen_table"]["entry() room 96x36"]
    p, n, c, mvp, rows, cols = args
    calls["clip_screen"]["entry() room 96x36"] = ((p, mvp, rows, cols), {})
    ch = R.clip_screen_channels(p, mvp, rows, cols)
    calls["plane_table"]["entry() room 96x36"] = (
        (ch, ch, torch.cat([n, c, p], dim=1)), {})
    return calls


def _outputs(name, out):
    """The wrapper's output as a list of tensors to compare."""
    import torch
    if name == "plane_table":
        return [out]
    if name == "clip_screen_table":
        ch, rest = out[0], [out[1]]
    elif name == "clip_screen_slots":
        ch, rest = out[0], [x for s in out[1] for x in s]
    else:
        ch, rest = out, []
    return [ch[k] if ch[k].dtype != torch.bool else ch[k].to(torch.int32)
            for k in ch] + rest


def run(cs, dev):
    """Each wrapper as shipped and in its variants at each call."""
    import torch
    from ascii_renderer_tpu_torch.ops import plane_table as PT
    from ascii_renderer_tpu_torch.ops import raster_clip as RCL
    mods = {"clip_screen": RCL, "clip_screen_slots": RCL,
            "clip_screen_table": RCL, "plane_table": PT}
    calls = front_calls(cs, dev)
    table = {}
    for name, variants in VARIANTS.items():
        libs = {nm: build_variant(*v) for nm, v in variants.items()}
        real = getattr(mods[name], name)
        plain = getattr(mods[name], name + "_ref")
        for label, (a, kw) in calls[name].items():
            want = _outputs(name, plain(*a, **kw))
            row = {}
            for form, lib in ((SHIPPED[name] + " (shipped)", None),
                              *libs.items()):
                def fn(lib=lib):
                    if lib is None:
                        return real(*a, **kw)
                    with launching_from(lib):
                        return real(*a, **kw)
                for g, w in zip(_outputs(name, fn()), want):
                    cs._same_bits(g, w, f"{name} {label} {form}")
                torch.cuda.synchronize()
                row[form] = cs._device_ms(fn, KERNELS[name], 1)
            table[f"{name} {label}"] = row
            print(f"{name} {label}: " + "; ".join(
                f"{f} {v:.5f} ms" for f, v in row.items()), flush=True)
    return table


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("front_variants: CUDA is not available")
    cs = _chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda:0")
    from ascii_renderer_tpu_torch.ops import _build
    _build.lib()
    out = {"device": torch.cuda.get_device_name(0), "ms": run(cs, dev)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
