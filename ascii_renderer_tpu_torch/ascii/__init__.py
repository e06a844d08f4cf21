from ascii_renderer_tpu_torch.ascii.ascii_pass import AsciiPass, glyph_decide  # noqa: F401
from ascii_renderer_tpu_torch.ascii.text import chars_to_strings  # noqa: F401
