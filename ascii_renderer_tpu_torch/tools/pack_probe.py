"""Times the span pack in the staged design (``tools/csrc/pack_staged.cu``:
a block stages R = 32, 64 or 128 consecutive rows of a span in shared
memory from loads coalesced along n, then writes its contiguous stretch of
the output with 16-byte stores) beside the package's own span kernel
(``ops/csrc/pack.cu``, ``pack_span_kernel``: a thread gathers one 16-byte
quad), in one process on one card, at the shapes the driven paths give
the pack:

- B7 at the plane tables of the teapot 240x135, [21, 8192], and of the
  mid-scale HD arm 960x540, [21, 16384] (one span (0, 24));
- B7' at [40, 69632], spans (0, 16) and (16, 40);
- B3 at the headline frame 0's setup block
  (``chip_smoke.b3_headline_inputs``), its two spans.

Every output is held bit for bit against the plain version. Device ms by
the profiler's kernel rows over 50 back-to-back calls
(``chip_smoke._device_ms``). The staged kernel is built here from its one
source with the package's flags. Run from the repo root on a machine with
an NVIDIA GPU:

    python3 -m ascii_renderer_tpu_torch.tools.pack_probe
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import tempfile
from pathlib import Path

from ascii_renderer_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "pack_staged.cu"
ROWS = (32, 64, 128)
# (in, out, C, N, a, b, rows, stream)
SIGNATURE = (ctypes.c_void_p, ctypes.c_void_p) + (ctypes.c_int,) * 5 + (
    ctypes.c_void_p,)


def build() -> Path:
    """The staged kernel's shared library (built on first call)."""
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out = _build.BUILD_DIR / f"libpack_staged_{h.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        so = Path(tmp) / out.name
        res = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                              "-shared", "-o", str(so), str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        print("\n".join(line for line in res.stdout.splitlines()
                        + res.stderr.splitlines() if "Used" in line),
              flush=True)
        so.replace(out)
    return out


def staged(lib, cm, spans, rows: int):
    """The staged kernel's outputs, one launch a span."""
    import torch
    c, n = cm.shape
    outs = []
    for a, b in spans:
        out = torch.empty((n, b - a), dtype=torch.float32, device=cm.device)
        _build.check(lib.pack_staged_launch(
            cm.data_ptr(), out.data_ptr(), c, n, a, b, rows,
            _build.stream_ptr(cm.device)), "pack_staged_launch")
        outs.append(out)
    return tuple(outs)


def main() -> int:
    import torch

    from ascii_renderer_tpu_torch.ops import pack as PK
    from ascii_renderer_tpu_torch.tools.kernel_ab import _chip_smoke
    if not torch.cuda.is_available():
        raise SystemExit("pack_probe: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    cs = _chip_smoke()
    dev = torch.device("cuda:0")
    lib = ctypes.CDLL(str(build()))
    lib.pack_staged_launch.argtypes = list(SIGNATURE)
    lib.pack_staged_launch.restype = ctypes.c_int
    g = torch.Generator().manual_seed(0)
    cm3, spans3 = cs.b3_headline_inputs(dev)
    cases = [
        ("B7 teapot [21, 8192]", torch.randn((21, 8192), generator=g),
         [(0, 24)]),
        ("B7 mid-scale HD [21, 16384]",
         torch.randn((21, 16384), generator=g), [(0, 24)]),
        ("B7' [40, 69632] two spans",
         torch.randn((40, 544 * 128), generator=g), [(0, 16), (16, 40)]),
        (f"B3 headline {list(cm3.shape)} two spans",
         cm3.reshape(cm3.shape[0], -1), list(spans3)),
    ]
    res = {}
    for label, cm, spans in cases:
        cm = cm.to(dev).contiguous()
        want = PK.pack_channels_split_ref(cm, spans)
        times = {"pack_span_kernel": cs._device_ms(
            lambda: PK.pack_channels_split(cm, spans), "pack_span_kernel",
            len(spans))}
        for rows in ROWS:
            got = staged(lib, cm, spans, rows)
            torch.cuda.synchronize()
            for o, w in zip(got, want):
                assert torch.equal(o.view(torch.int32), w.view(torch.int32)), \
                    f"staged R={rows} {label}: not bit-exact"
            times[f"staged R={rows}"] = cs._device_ms(
                lambda: staged(lib, cm, spans, rows), "pack_staged_kernel",
                len(spans))
        res[label] = times
        print(f"{label}: " + ", ".join(f"{k} {v:.5f} ms"
                                       for k, v in times.items()),
              flush=True)
    print("staged outputs bit-exact at every shape and R", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
