"""ctypes binding for the native terminal blitter (``native/termblit.cpp``,
shared with the JAX package), with a pure-Python encoder where no native
library loads.

The library is the checked-in ``native/libtermblit.so``. Where it does not
load, ``native/termblit.cpp`` is compiled with g++ into ``app/build/``
beside this module (git-ignored) and that copy is loaded. Nothing here
writes under ``native/``: a checkout's file times are arbitrary, so a
rebuild-when-older rule would rewrite a tracked file.

Usage:
    tb = TermBlitter(rows, cols, color=True)
    sys.stdout.buffer.write(tb.encode(chars, rgb))   # chars u8[H,W], rgb u8[H,W,3]
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_SRC = os.path.join(_NATIVE_DIR, "termblit.cpp")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libtermblit.so")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
_BUILT_PATH = os.path.join(_BUILD_DIR, "libtermblit.so")


def _build_native() -> bool:
    """Compile native/termblit.cpp into the build directory (generic x86-64
    code: the directory may travel with a copy of the tree)."""
    if not os.path.exists(_SRC):
        return False
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_BUILT_PATH}.{os.getpid()}"
    try:
        subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                        "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        return False
    os.replace(tmp, _BUILT_PATH)
    return True


def _open(path: str):
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.termblit_max_bytes.restype = ctypes.c_long
    lib.termblit_max_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.termblit_encode.restype = ctypes.c_long
    lib.termblit_encode.argtypes = [u8p, u8p, u8p, u8p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_char_p]
    return lib


def _load():
    """The checked-in library, else an earlier build, else a new build;
    None if none loads."""
    for path in (_LIB_PATH, _BUILT_PATH):
        if os.path.exists(path):
            lib = _open(path)
            if lib is not None:
                return lib
    return _open(_BUILT_PATH) if _build_native() else None


class TermBlitter:
    def __init__(self, rows: int, cols: int, color: bool = True):
        self.rows, self.cols, self.color = rows, cols, color
        self._lib = _load()
        self._prev_chars = None
        self._prev_rgb = None
        if self._lib is not None:
            cap = self._lib.termblit_max_bytes(rows, cols)
            self._buf = ctypes.create_string_buffer(int(cap))

    @property
    def native(self) -> bool:
        return self._lib is not None

    def reset(self) -> None:
        """Force the next encode to be a full repaint."""
        self._prev_chars = None
        self._prev_rgb = None

    def encode(self, chars, rgb=None) -> bytes:
        """chars u8 [rows, cols]; rgb u8 [rows, cols, 3] (required if color).
        Returns the ANSI byte stream for this frame (diffed vs previous)."""
        chars = np.ascontiguousarray(np.asarray(chars, dtype=np.uint8))
        if rgb is None:
            rgb = np.zeros((self.rows, self.cols, 3), np.uint8)
        rgb = np.ascontiguousarray(np.asarray(rgb, dtype=np.uint8))
        if (chars.shape != (self.rows, self.cols)
                or rgb.shape != (self.rows, self.cols, 3)):
            raise ValueError(f"encode: expected chars [{self.rows}, "
                             f"{self.cols}] and rgb [{self.rows}, "
                             f"{self.cols}, 3], got {chars.shape} and "
                             f"{rgb.shape}")
        if self._lib is not None:
            u8p = ctypes.POINTER(ctypes.c_uint8)
            pc = (self._prev_chars.ctypes.data_as(u8p)
                  if self._prev_chars is not None else None)
            pr = (self._prev_rgb.ctypes.data_as(u8p)
                  if self._prev_rgb is not None else None)
            n = self._lib.termblit_encode(
                chars.ctypes.data_as(u8p), rgb.ctypes.data_as(u8p), pc, pr,
                self.rows, self.cols, int(self.color), self._buf)
            out = self._buf.raw[:n]
        else:
            out = self._encode_py(chars, rgb)
        self._prev_chars = chars.copy()
        self._prev_rgb = rgb.copy()
        return out

    def _encode_py(self, chars, rgb) -> bytes:
        """Pure-Python fallback (full repaint, no diffing)."""
        parts = []
        last = None
        for y in range(self.rows):
            parts.append(f"\x1b[{y + 1};1H")
            for x in range(self.cols):
                if self.color:
                    c = tuple(int(v) for v in rgb[y, x])
                    if c != last:
                        parts.append(f"\x1b[38;2;{c[0]};{c[1]};{c[2]}m")
                        last = c
                ch = int(chars[y, x])
                parts.append(chr(ch) if 32 <= ch <= 126 else "?")
        parts.append("\x1b[0m")
        return "".join(parts).encode()


def present(blitter: TermBlitter, chars, rgb=None, out=None) -> None:
    """Write one frame to the terminal (single syscall)."""
    stream = out or sys.stdout.buffer
    stream.write(blitter.encode(chars, rgb))
    stream.flush()
