"""Backend registry + router (torch port of
``ascii_renderer_tpu/backends/registry.py``; ref: js/gpu_renderer.js).

Named backend factories with friendly aliases, runtime hot-swap with scene
re-push, and a stable render facade. ``Renderer`` renders on ``device``
(CUDA unless the caller asks for the CPU); each factory is called as
``factory(cfg, device=device)``. "raster" renders scenes of every size
(the scan / binned walk below 2,048 triangle slots, the compacted
mid-scale walk below 32,768, the headline pipeline above), "pathtrace"
the path tracer and "raytrace" the deterministic ray tracer.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ascii_renderer_tpu_torch.core.camera import Camera
from ascii_renderer_tpu_torch.core.config import Config
from ascii_renderer_tpu_torch.core.frame import Frame
from ascii_renderer_tpu_torch.scene.builder import SceneData

_factories: Dict[str, Callable[..., object]] = {}
_aliases = {
    "pt": "pathtrace", "path": "pathtrace", "pathtracer": "pathtrace",
    "r": "raster", "rasterizer": "raster",
    "rt": "raytrace", "ray": "raytrace",
}


def register_backend(name: str, factory: Callable[..., object]) -> None:
    """ref: gpu_renderer.js:52-57."""
    if not name or not callable(factory):
        raise ValueError("register_backend(name, factory): invalid args")
    _factories[str(name).lower()] = factory


def list_backends():
    _ensure_defaults()
    return list(_factories.keys())


def _canonical(name: str) -> Optional[str]:
    n = str(name or "").lower()
    if n in _factories:
        return n
    a = _aliases.get(n)
    return a if a in _factories else None


def _ensure_defaults():
    if _factories:
        return
    # Lazy imports to avoid cycles.
    from ascii_renderer_tpu_torch.backends.pathtrace import PathtraceBackend
    from ascii_renderer_tpu_torch.backends.raster import RasterBackend
    from ascii_renderer_tpu_torch.backends.raytrace import RaytraceBackend
    register_backend("raytrace", RaytraceBackend)
    register_backend("raster", RasterBackend)
    register_backend("pathtrace", PathtraceBackend)


class Renderer:
    """Instance-based router (the reference uses module singletons)."""

    def __init__(self, cfg: Config | None = None, backend: str | None = None,
                 device="cuda"):
        _ensure_defaults()
        self.cfg = cfg or Config()
        self.device = torch.device(device)
        self._active = None
        self._active_name = None
        self._last_scene: Optional[SceneData] = None
        self._last_frame: Optional[Frame] = None
        self.set_backend(backend or self.cfg.default_backend)

    @property
    def backend_name(self) -> str:
        return self._active_name

    def set_backend(self, name: str) -> str:
        """Hot-swap with dispose + scene re-push (gpu_renderer.js:68-80)."""
        key = _canonical(name)
        if key is None:
            raise ValueError(
                f'Unknown backend "{name}". Known: {", ".join(list_backends())}')
        active = _factories[key](self.cfg, device=self.device)
        if self._active is not None and hasattr(self._active, "dispose"):
            self._active.dispose()
        self._active = active
        self._active_name = key
        if self._last_scene is not None:
            self._active.set_scene(self._last_scene)
        return key

    def set_scene(self, scene: SceneData) -> None:
        self._last_scene = scene
        self._active.set_scene(scene)

    def render(self, time_sec: float, camera: Camera, rows: int | None = None,
               cols: int | None = None) -> Frame:
        rows = rows or self.cfg.grid_height
        cols = cols or self.cfg.grid_width
        frame = self._active.render(time_sec, camera, rows, cols,
                                    pixel_aspect=self.cfg.pixel_aspect)
        self._last_frame = frame
        return frame

    def render_raw(self, args: dict) -> Optional[Frame]:
        """Dict-args facade (gpu_renderer.js renderRaw:97-100)."""
        if not args or "camera" not in args:
            return None
        return self.render(args.get("time", 0.0), args["camera"],
                           args.get("rows"), args.get("cols"))

    def get_pixels(self, flip_y: bool = False):
        """Last rendered frame as interleaved RGBA bytes, u8 [H, W, 4] on
        the host (getPixels, gpu_renderer.js:102-105). flip_y returns
        bottom-up rows (the raw GL readback orientation)."""
        frame = self._last_frame
        if frame is None:
            return None
        px = frame.interleaved().cpu().numpy()
        return px[::-1] if flip_y else px

    def dispose(self) -> None:
        if self._active is not None and hasattr(self._active, "dispose"):
            self._active.dispose()
        self._active = None
        self._active_name = None
