from ascii_renderer_tpu_torch.diff.soft_raster import (  # noqa: F401
    soft_glyph_probs, soft_luminance_loss, soft_render,
)
