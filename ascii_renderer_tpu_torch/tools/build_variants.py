"""Timed variants of the grouped layout build X10 (``ops/group_build``)
and the raster's deferred shade K2 (``ops/raster_shade``), on one card.

The variants are builds of the package's own sources with another value
of a constant the source leaves open: X10's gather with one float4 a
thread (``-DGB_ITEMS=1``; it ships two), K2 with blocks of 64 or 256
threads (``-DRS_THREADS``; it ships 128). Each is built here into its own
library and run through the package's wrapper, which this tool points at
that library for the call.

X10 is timed at the calls the driven paths make (recorded from them): the
headline's frame 0 (a fresh backend's first caps) and its steady frame,
the golden call of each of subtile3, 5, 6, 7 and 8, and a subtile8 band
of the bunny; and at two inputs of tied depths, at the headline's steady
caps: every bin of the 960x540 frame holding the same 2 triangles (4,352
bins in one depth bucket), and 512 bins of 1,100 pairs each (the last
bucket, whose bins are ranked by compares). At each call each output is
held to the plain version bit for bit first, then device ms by the
profiler's kernel rows over 50 calls (``chip_smoke._device_ms``) and the
whole call by CUDA events over 20. The layout block is also split by
phase: a build of its source with ``tools/csrc/stamps.cuh`` prepended has
thread 0 of the block write ``clock64()`` after each phase (and the
global timer at its ends, which turns cycles into microseconds); the
median of 50 calls a phase.

K2 is timed at its callers' inputs (recorded from their paths): the
headline's grouped tiles (f32 ids [grp_cap, 8, 128]), the mid-scale HD
arm's plane table (i32 ids [540, 960]), the ``entry()`` room's (i32 ids
[36, 96]) and the subtile path's compacted tiles; each block size held to
``shade_ref`` bit for bit first.

The table goes to stdout, one JSON line last. Run from the repo root on a
machine with one NVIDIA GPU (``--only x10`` or ``--only k2`` for one of
the two):

    python3 -m ascii_renderer_tpu_torch.tools.build_variants
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.tools.kernel_ab import _chip_smoke, _shade_calls

STAMPS_H = Path(__file__).resolve().parent / "csrc" / "stamps.cuh"
# the layout block's phases, between consecutive stamps
PHASES = ("depths and bucket counts", "bucket and compaction scans",
          "order (placement)", "slots, row pointers and K-rows' groups")
# (source, entry point, defines) of each variant, by name
X10_VARIANTS = {"1 float4 a thread": ("group_build.cu", "group_build_launch",
                                      ("-DGB_ITEMS=1",))}
K2_VARIANTS = {f"{t} threads": ("raster_shade.cu", "raster_shade_launch",
                                (f"-DRS_THREADS={t}",)) for t in (64, 256)}


def build_variant(src: str, entry: str, defines=(), stamps=False):
    """``ops/csrc/<src>`` built with ``defines`` (and tools/csrc/stamps.cuh
    prepended where ``stamps``) into its own library beside the package's
    (built on first call), ``entry`` typed as the package types it (and
    ``stamps_read``)."""
    path = _build.CSRC / src
    extra = [*defines, *(("-include", str(STAMPS_H)) if stamps else ())]
    h = hashlib.sha256(" ".join((*_build.NVCC_FLAGS, *defines)).encode())
    for p in (path, *sorted(_build.CSRC.glob("*.cuh")),
              *((STAMPS_H,) if stamps else ())):
        h.update(p.read_bytes())
    out = _build.BUILD_DIR / f"lib{path.stem}_variant_{h.hexdigest()[:16]}.so"
    if not out.is_file():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            so = Path(tmp) / out.name
            res = subprocess.run(
                [_build.find_nvcc(), *_build.NVCC_FLAGS, *extra, "-I",
                 str(_build.CSRC), "-shared", "-o", str(so), str(path)],
                capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                                   f"{res.stdout}{res.stderr}")
            so.replace(out)
    lib = ctypes.CDLL(str(out))
    fn = getattr(lib, entry)
    fn.argtypes = list(_build.SIGNATURES[entry])
    fn.restype = ctypes.c_int
    if stamps:
        lib.stamps_read.argtypes = [ctypes.c_void_p]
        lib.stamps_read.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def launching_from(lib):
    """The package's wrappers launch from ``lib`` inside the block."""
    real = _build.lib
    _build.lib = lambda: lib
    try:
        yield
    finally:
        _build.lib = real


def phase_split(run, stamps, n=50):
    """{phase: median us} of the layout block over n calls of ``run``, read
    from ``stamps`` (clock64 after the start and each phase, then the
    global timer in ns at the block's start and end), and its total."""
    import torch
    buf = (ctypes.c_longlong * 8)()
    per = {nm: [] for nm in (*PHASES, "layout block", "SM GHz")}
    for _ in range(n):
        run()
        torch.cuda.synchronize()
        _build.check(stamps(buf), "stamps")
        s = list(buf)
        ns_per_cycle = (s[7] - s[6]) / max(1, s[4] - s[0])
        for i, nm in enumerate(PHASES):
            per[nm].append((s[i + 1] - s[i]) * ns_per_cycle / 1e3)
        per["layout block"].append((s[7] - s[6]) / 1e3)
        per["SM GHz"].append(1.0 / ns_per_cycle)
    return {nm: statistics.median(v) for nm, v in per.items()}


def tied_call(dev, depth, n_tiles, caps):
    """(args, kwargs) of a build at which every bin of ``n_tiles`` tiles
    holds the same ``depth`` pairs (triangles 0 to depth - 1), with X9's
    offsets, at ``caps`` (tiles_x, r_cap, pair_cap, grp_cap; pair_cap
    raised to hold every pair)."""
    import torch
    tiles_x, r_cap, pair_cap, grp_cap = caps
    n_bins = n_tiles * 8
    pair_cap = max(pair_cap, n_bins * depth)  # every pair inside the cap
    keys = ((torch.arange(n_bins, dtype=torch.int32, device=dev)[:, None]
             << 18) | torch.arange(depth, dtype=torch.int32,
                                   device=dev)[None]).reshape(-1)
    offsets = torch.arange(n_bins + 1, dtype=torch.int32, device=dev) * depth
    src = torch.randn((depth, 32), generator=torch.Generator().manual_seed(3)
                      ).to(dev)
    return ((src, keys, tiles_x, n_tiles, r_cap, pair_cap, grp_cap),
            dict(k=8, offsets=offsets))


def x10_calls(cs, dev):
    """{label: (args, kwargs)} of the build calls to time, recorded from
    the driven paths."""
    import torch
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.backends.raster import RasterBackend
    from ascii_renderer_tpu_torch.core.config import Config
    soup, scene = cs._bunny(), cs._scene(dev)
    cfg = Config(pixel_aspect=cs.PIXEL_ASPECT)
    backend = RasterBackend(cfg, device=dev)
    backend.set_soup(*(torch.as_tensor(x) for x in soup), scene)
    calls = {}
    _k, b = cs._record_keys_builds(
        lambda: cs._frame(backend, cfg, cs._golden_camera()))
    calls["headline frame 0"] = b[0]
    cs._frame(backend, cfg, cs._golden_camera())
    _k, b = cs._record_keys_builds(
        lambda: cs._frame(backend, cfg, cs._golden_camera()))
    calls["headline steady frame"] = b[-1]
    frame = cs._generation_frame(dev, soup, scene)
    for gen in ("subtile3", "subtile5", "subtile6", "subtile7", "subtile8"):
        _k, b = cs._record_keys_builds(lambda gen=gen: frame(gen, False))
        calls[f"{gen} golden call"] = b[0]
    p, n, c = (torch.as_tensor(x).to(dev) for x in soup)
    _k, b = cs._record_keys_builds(lambda: R.render_soup_diag(
        p, n, c, scene, cs._golden_camera(), cs.ROWS, cs.COLS,
        cs.PIXEL_ASPECT, kernel="subtile8", row_lo=cs.BAND_ROWS,
        band_rows=cs.BAND_ROWS, **cs._golden_caps(p.shape[0] // 3)))
    calls[f"subtile8 band {cs.BAND_ROWS}+{cs.BAND_ROWS}"] = b[0]
    a = calls["headline steady frame"][0]
    caps = (a[2], a[4], a[5], a[6])  # the headline's steady caps
    calls["ties: 4,352 bins of 2 pairs"] = tied_call(dev, 2, 544, caps)
    calls["ties: 512 bins of 1,100 pairs"] = tied_call(dev, 1100, 64, caps)
    return calls


def k2_calls(cs, dev):
    """{label: shade args} of each caller, recorded from its path
    (``kernel_ab._shade_calls``, after a headline frame 0)."""
    from ascii_renderer_tpu_torch.backends.raster import RasterBackend
    from ascii_renderer_tpu_torch.core.config import Config
    soup, scene = cs._bunny(), cs._scene(dev)
    cfg = Config(pixel_aspect=cs.PIXEL_ASPECT)
    backend = RasterBackend(cfg, device=dev)
    backend.set_soup(*soup, scene)
    cs._frame(backend, cfg, cs._golden_camera())
    return _shade_calls(cs, dev, backend, cfg)


def run_x10(cs, dev):
    """X10 as shipped and in its variants, and its layout block's phases,
    at every recorded call."""
    import torch
    from ascii_renderer_tpu_torch.ops import group_build as GB
    libs = {nm: build_variant(*v) for nm, v in X10_VARIANTS.items()}
    stamped = build_variant("group_build.cu", "group_build_launch",
                            stamps=True)
    table, phases = {}, {}
    for label, (a, k) in x10_calls(cs, dev).items():
        want = cs._build_call_plain(a, k)
        GB.build_rows(*a, **k)
        n = GB.last_launches
        row = {}
        for name, lib in (("shipped", None), *libs.items()):
            def fn(a=a, k=k, lib=lib):
                if lib is None:
                    return GB.build_rows(*a, **k)
                with launching_from(lib):
                    return GB.build_rows(*a, **k)
            cs._same_layout(fn(), want, f"X10 {label} {name}")
            torch.cuda.synchronize()
            row[name] = (cs._device_ms(fn, "group_build_", n),
                         cs._event_ms(fn, 20))

        def run(a=a, k=k):
            with launching_from(stamped):
                return GB.build_rows(*a, **k)
        cs._same_layout(run(), want, f"X10 {label} stamped")
        table[label] = row
        phases[label] = phase_split(run, stamped.stamps_read)
        print(f"X10 {label} (K {k['k']}{' rows256' if k.get('rows256') else ''}"
              f", r_cap {a[4]}, grp_cap {a[6]}, {a[1].shape[0]} keys): "
              + "; ".join(f"{f} {v[0]:.5f} ms (call {v[1]:.5f})"
                          for f, v in row.items()), flush=True)
        print(f"X10 {label} layout block: " + ", ".join(
            f"{nm} {us:.3f}{'' if nm == 'SM GHz' else ' us'}"
            for nm, us in phases[label].items()), flush=True)
    return table, phases


def run_k2(cs, dev):
    """K2 as shipped and in its variants at each caller's recorded
    inputs."""
    import torch
    from ascii_renderer_tpu_torch.ops import raster_shade as RSH
    libs = {nm: build_variant(*v) for nm, v in K2_VARIANTS.items()}
    table = {}
    for label, args in k2_calls(cs, dev).items():
        want = RSH.shade_ref(*args)
        row = {}
        for name, lib in (("128 threads (shipped)", None), *libs.items()):
            def fn(lib=lib):
                if lib is None:
                    return RSH.shade(*args)
                with launching_from(lib):
                    return RSH.shade(*args)
            cs._same_bits(fn(), want, f"K2 {label} {name}")
            torch.cuda.synchronize()
            row[name] = (cs._device_ms(fn, "raster_shade", 1),
                         cs._event_ms(fn, 20))
        ids = args[1]
        table[label] = row
        print(f"K2 {label} ({tuple(ids.shape)} {str(ids.dtype)[6:]} ids, "
              f"{int((ids >= 0).sum())} lit, {args[5]} attributes): "
              + "; ".join(f"{f} {v[0]:.5f} ms (call {v[1]:.5f})"
                          for f, v in row.items()), flush=True)
    return table


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("all", "x10", "k2"), default="all")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("build_variants: CUDA is not available")
    cs = _chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda:0")
    _build.lib()
    out = {"device": torch.cuda.get_device_name(0)}
    if a.only in ("all", "x10"):
        out["x10_ms"], out["x10_phases_us"] = run_x10(cs, dev)
    if a.only in ("all", "k2"):
        out["k2_ms"] = run_k2(cs, dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
