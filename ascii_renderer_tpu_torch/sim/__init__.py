"""The frame step, its UI layer and progressive accumulation (torch port
of ``ascii_renderer_tpu/sim``)."""

from ascii_renderer_tpu_torch.sim.ui import ui_char_plane  # noqa: F401
from ascii_renderer_tpu_torch.sim.framestep import (  # noqa: F401
    FrameState, make_frame_step)
