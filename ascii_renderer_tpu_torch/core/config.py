"""Global configuration (ref: js/config.js).

The reference keeps a single mutable ``config`` object whose values are baked
into GLSL shader source as ``#define``s — i.e. config changes recompile
kernels (js/config.js:7-62, pathtrace_shader.js:17-41, ascii_pass_shader.js:12-16).
Here it is a *frozen, hashable* dataclass, a copy of the JAX package's
``core/config.py`` so both packages read the same defaults.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# Grid derivation mirrors js/config.js:4-5,21-22:
#   SCREEN_SCALE=4, FONT_HEIGHT_WIDTH_RATIO=1.5
#   VIRTUAL_GRID_WIDTH  = 16 * 4 * 1.5 = 96
#   VIRTUAL_GRID_HEIGHT = 9 * 4        = 36
_SCREEN_SCALE = 4
_FONT_HEIGHT_WIDTH_RATIO = 1.5

# First digits of pi used for the UI border (ref: js/config.js:39-40).
PI_DIGITS = (
    "3141592653589793238462643383279502884197169399375105820974944592"
    "3078164062862089986280348253421170679"
)


@dataclasses.dataclass(frozen=True)
class PathTracerConfig:
    """ref: js/config.js:47-53 (PATH_TRACER block)."""

    samples_per_batch: int = 64
    max_bounces: int = 5
    light_color: Tuple[float, float, float] = (16.86, 10.76, 8.2)
    gamma_exp: float = 1.0  # no gamma correction (ref comment js/config.js:51)
    direct_light_sampling: bool = True
    # NOTE: the reference's scene-size caps (8 spheres / 64 tris / 32 quads,
    # pathtrace.js:22-24; the raytrace.js:52-61 block likewise) are WebGL
    # uniform-buffer artifacts. This framework sizes its padded SoA arrays
    # from the SceneBuilder (scene/builder.py caps) and the kernels scale
    # with them, so those knobs do not exist here.


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Per-pixel adaptive sampling (ref: js/config.js:56-61; dormant in the
    reference's live path but rebuilt natively here, see backends/pathtrace)."""

    enabled: bool = True
    max_tolerance: float = 0.10
    max_samples: int = 64
    reset_on_camera_change: bool = True
    # "rgb": per-channel Welford, mean-of-channels CI (default; catches
    # chroma-only noise). "perceptual": reference-parity scalar-luminance
    # Welford (0.3/0.59/0.11, js/render/renderer.js:179-183).
    stats_mode: str = "rgb"


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level tunables (ref: js/config.js:7-62)."""

    target_fps: int = 60
    default_backend: str = "pathtrace"  # 'pathtrace' | 'raster' | 'raytrace'
    use_grayscale: bool = False

    # Default ramp: the second duplicate ASCII_RAMP literal wins in JS
    # (ref: js/config.js:14-15 — "@%#*+=-:. ").
    ascii_ramp: str = "@%#*+=-:. "

    # Cell grid (cols × rows).
    grid_width: int = int(16 * _SCREEN_SCALE * _FONT_HEIGHT_WIDTH_RATIO)  # 96
    grid_height: int = 9 * _SCREEN_SCALE  # 36

    # Modal (majority) glyph smoothing (ref: js/config.js:24-34).
    ascii_mode_filter: bool = True
    ascii_mode_kernel: int = 5  # odd: 3 / 5 / 7
    # int(5*5*0.5) == 12 (the JS `|0` truncation in ascii_pass.js:152).
    ascii_mode_thresh: int = 12

    epsilon: float = 1e-6
    ripple_speed: float = 0.05
    max_ripple_radius: float = 100.0
    pi_digits: str = PI_DIGITS

    fovy_deg: float = 80.0

    # Measured character cell aspect (width/height). The reference measures a
    # DOM glyph at runtime (js/main.js:166-171,217); we default to the baked
    # glyph-atlas cell aspect and allow override. `--mode term` measures the
    # REAL terminal cell via TIOCGWINSZ at startup
    # (app/cli.measure_terminal_pixel_aspect) and overrides this value, so
    # non-1:2 fonts render circles round; `--pixel-aspect` forces a value.
    pixel_aspect: float = 0.5

    path_tracer: PathTracerConfig = dataclasses.field(default_factory=PathTracerConfig)
    adaptive: AdaptiveConfig = dataclasses.field(default_factory=AdaptiveConfig)

    # AsciiPass presentation options (ref: js/main.js:254-262 — only the
    # options the class actually reads: ascii_pass.js:142-146).
    alpha_gamma: float = 1.32
    transparent_background: bool = True

    @property
    def fovy_rad(self) -> float:
        return self.fovy_deg * math.pi / 180.0

    @property
    def mode_radius(self) -> int:
        """Kernel size → neighborhood radius, clamped to 3 like the shader's
        MAX_MODE_RADIUS (ref: ascii_pass.js:150-152, ascii_pass_shader.js:83)."""
        k = max(3, int(self.ascii_mode_kernel))
        return max(1, min(3, (k - 1) // 2))

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def default_config() -> Config:
    return Config()
