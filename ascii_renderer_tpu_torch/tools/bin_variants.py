"""Timed variants of the raster's pair keys and their counting sort X9
(``ops/bin_entries``): its device ms in every form the C entry point can
be asked for, at the launch sizes of the driven paths, on one card.

The forms (``bin_entries.FORMS``): 1-3, whose sequence pass takes chunks
of 32 W J keys (W warps a block, J steps of 32 keys a warp: (4, 8), (8,
8), (8, 16)); and the launch's own choice (``auto_form``). The sizes: the
tile keys at the calls of ``tools/xla_inputs.bin_calls`` (the entry()
room 96x36, the teapot 240x135, the mid-scale HD arm 960x540 and a
20,000-triangle soup at the near plane, 480x270), in walk "mm"'s layout;
the bin keys at the headline's frame (the bunny's bbox at the golden
pose, 960x540) with big_cap 0 (its steady frames) and 64 (its first
frame), and at its middle row band (22 tile rows). Each form's output is
held to the plain version bit for bit before it is timed; the time is the
profiler's ``bin_`` kernel rows over 50 back-to-back calls
(``chip_smoke._device_ms``) and the whole call by CUDA events over 20;
the launch's own form is also split by kernel. The table goes to stdout,
one JSON line last. Run from the repo root on a machine with one NVIDIA GPU:

    python3 -m ascii_renderer_tpu_torch.tools.bin_variants
"""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _split(fn, n=20):
    """{kernel: device ms a call} of fn's ``bin_`` kernels over n calls
    (the profiler's rows)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(r"bin_\w+", e.key)
        if e.device_type == DeviceType.CUDA and name:
            out[name.group(0)] = out.get(name.group(0), 0.0) + \
                e.self_device_time_total / n / 1e3
    return out


def _time_forms(cs, label, run, plain, check):
    """{form: (kernel ms, call ms)} of ``run(form)`` for every form, each
    output checked against ``plain`` first."""
    import torch
    from ascii_renderer_tpu_torch.ops import bin_entries as BE
    want = plain()
    row = {}
    for form in [*BE.FORMS, 0]:
        def fn(form=form):
            return run(form)
        check(fn(), want, f"X9 {label} form {form}")
        torch.cuda.synchronize()
        n = BE.last_launches
        row["auto" if form == 0 else str(form)] = (
            cs._device_ms(fn, "bin_", n), cs._event_ms(fn, 20))
        if form == 0:
            print(f"X9 {label} form {form}: " + ", ".join(
                f"{k} {v:.5f}" for k, v in _split(fn).items()), flush=True)
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bin_variants: CUDA is not available")
    from ascii_renderer_tpu_torch.ops import bin_entries as BE
    from ascii_renderer_tpu_torch.tools.xla_inputs import bin_calls
    cs = _chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda:0")

    def same_entries(got, want, what):
        cs._same_bits(got[0], want[0], what)
        assert torch.equal(got[1], want[1]), what

    def same_keys(got, want, what):
        for g, w in zip(got, want):
            assert torch.equal(g, w), what

    table = {}
    for label, (ch, rows, cols) in bin_calls(dev).items():
        n_tiles = -(-rows // 8) * -(-cols // 128)
        P = 4 * ch["valid"].shape[0] + 64 * n_tiles
        key = f"tile keys {label} ({P} keys, {n_tiles} tiles)"
        table[key] = _time_forms(
            cs, key,
            lambda form, ch=ch, g=(rows, cols): BE.binned_entries(
                dict(ch), *g, form=form),
            lambda ch=ch, g=(rows, cols): BE.binned_entries_ref(dict(ch),
                                                                *g),
            same_entries)
        table[key]["auto is"] = BE.auto_form(n_tiles, P)
    _cm, bb, _spans, T = cs._headline_setup(dev)
    band = 22
    for cap, kw in ((0, {}), (64, {}),
                    (0, dict(ty_lo=band, tiles_y_band=band))):
        tiles_y = kw.get("tiles_y_band") or -(-cs.ROWS // 8)
        n_bins = tiles_y * -(-cs.COLS // 128) * 8
        P = 4 * T + min(cap, T) * n_bins
        key = (f"bin keys headline big_cap {cap}"
               f"{' band ' + str(kw['ty_lo']) if kw else ''} ({P} keys, "
               f"{n_bins} bins)")
        table[key] = _time_forms(
            cs, key,
            lambda form, cap=cap, kw=kw: BE.pair_keys_bbox(
                bb, cs.ROWS, cs.COLS, big_cap=cap, form=form, **kw),
            lambda cap=cap, kw=kw: BE.pair_keys_ref(
                bb["bx0"], bb["bx1"], bb["by0"], bb["by1"], bb["valid"],
                cs.ROWS, cs.COLS, big_cap=cap, **kw),
            same_keys)
        table[key]["auto is"] = BE.auto_form(n_bins, P)
    for key, row in table.items():
        print(f"X9 {key}: " + "; ".join(
            f"form {f} {v[0]:.5f} ms (call {v[1]:.5f})"
            if isinstance(v, tuple) else f"{f} {v}"
            for f, v in row.items()), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "x9_variants_ms": table}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
