"""Tracing / profiling / observability (torch port of
``ascii_renderer_tpu/utils/profiling.py``).

  - FrameStats: rolling frame-time statistics (fps, p50 / p95 latency) on
    the host clock between ticks — the viewer's frame time, what its user
    feels;
  - force_completion(): wait until the device has finished the work
    behind some outputs;
  - trace(): a torch.profiler scope that writes a Chrome trace;
  - timed(): wall-clock phase timer that synchronises the CUDA device
    before reading the clock;
  - log(): structured single-line JSON logging to stderr;
  - dump_preview(): the raw RGB cell grid as a PNG.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time
from collections import deque
from typing import Any

import numpy as np
import torch


def _tensors(out: Any):
    if isinstance(out, torch.Tensor):
        yield out
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            yield from _tensors(getattr(out, f.name))
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)


def force_completion(out: Any) -> None:
    """Block until the device work behind every tensor of ``out`` (a
    tensor, or dataclasses / sequences / dicts of them) has finished."""
    for dev in {t.device for t in _tensors(out) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class FrameStats:
    """Rolling frame statistics (window of N frames), host clock."""

    def __init__(self, window: int = 120):
        self._dts = deque(maxlen=window)
        self._last = None

    def tick(self) -> float:
        """Mark a frame boundary; returns the fps over the window."""
        now = time.perf_counter()
        if self._last is not None:
            self._dts.append(now - self._last)
        self._last = now
        return self.fps

    @property
    def fps(self) -> float:
        if not self._dts:
            return 0.0
        return 1.0 / max(float(np.mean(self._dts)), 1e-9)

    @property
    def p50_ms(self) -> float:
        return float(np.percentile(self._dts, 50)) * 1e3 if self._dts else 0.0

    @property
    def p95_ms(self) -> float:
        return float(np.percentile(self._dts, 95)) * 1e3 if self._dts else 0.0

    def summary(self) -> dict:
        return {"fps": round(self.fps, 2), "p50_ms": round(self.p50_ms, 3),
                "p95_ms": round(self.p95_ms, 3), "frames": len(self._dts)}


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler scope (CPU, and CUDA where there is a card); writes
    ``<log_dir>/trace.json``, a Chrome trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(label: str, sink=None):
    """Wall-clock phase timer; logs one structured line on exit. The CUDA
    device is synchronised before each clock reading, so the span holds
    the device work the phase enqueued."""
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    log("timing", label=label, ms=round((time.perf_counter() - t0) * 1e3, 3),
        sink=sink)


def log(event: str, sink=None, **fields) -> None:
    """Structured one-line JSON log (ref: the DBG console.log pattern,
    pathtrace.js:14 — but machine-parseable)."""
    rec = {"event": event, "t": round(time.time(), 3), **fields}
    print(json.dumps(rec), file=sink or sys.stderr, flush=True)


def dump_preview(frame, path: str) -> str:
    """Save the raw RGB cell grid as a PNG — the ?debug preview canvas
    capability (js/main.js:206-213,411-419). Needs PIL, imported here."""
    from PIL import Image
    Image.fromarray(frame.rgb.cpu().numpy()).save(path)
    return path
