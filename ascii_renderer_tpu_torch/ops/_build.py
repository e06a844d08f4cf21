"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

On first use every ``csrc/*.cu`` is compiled by ``nvcc`` into ONE shared
library with a plain C interface, which is loaded with ``ctypes``. No
PyTorch headers are included, so the build takes seconds, and it needs no
``ninja``. The library's name carries a hash of the sources and flags, so
an edited source never loads a stale build. The build directory is
``ops/build`` (listed in ``.gitignore``).

Flags: ``sm_90a`` (Hopper), ``-fmad=false`` so that only the kernels'
explicit ``fmaf`` calls fuse a product into an add (the kernels fuse exactly
where the reference does, core/fp.py, and must equal their plain-torch
versions bit for bit: one stray contraction moves near-edge winners), and
NO ``--use_fast_math``: division and sqrt stay IEEE (``-prec-div=true``,
``-prec-sqrt=true`` are nvcc's defaults).

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_FP = ctypes.POINTER(ctypes.c_float)
# C signatures of the entry points in csrc/*.cu (all return cudaError_t).
SIGNATURES = {
    # (pos9, attrs_t, mvp16_host, out, T, Tp, A, rows, cols, stream)
    "setup2dh_launch": (_P, _P, _FP, _P, _I, _I, _I, _I, _I, _P),
    # (cm, out, C, N, a, b, stream)
    "pack_span_launch": (_P, _P, _I, _I, _I, _I, _P),
    # (rows128, rowptr, gdepth, gskip, xl, yl, z, e, r_cap, grp_cap, stream)
    "walk_grouped_skip_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH.
    Raises RuntimeError when there is none: the port never runs without
    its kernels on a CUDA device."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels of ascii_renderer_tpu_torch/ops/csrc cannot "
        "be built")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into the build directory (if that exact build
    is not there yet) and return the library's path."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out = BUILD_DIR / f"libascii_kernels_{_digest(srcs)}.so"
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *map(str, srcs)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, args in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(*tensors, what: str) -> None:
    """Every tensor must be a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: expected CUDA tensors on one device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous tensors")
