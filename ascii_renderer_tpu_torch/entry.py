"""The port's counterpart of ``__graft_entry__.entry()``.

``entry()`` returns (fn, example_args): one full frame step of the
flagship model, the fused frame pipeline on the demo scene (the raster
backend through ``render_soup``: 1,624 triangle slots, the binned bin walk
B6), the UI composite and the glyph decision (the modal vote B4), at the
default 96 x 36 grid. ``fn(scene, state, inputs, dt_s, fps)`` returns
(state', chars u8 [36, 96], tint u8 [36, 96, 3]); the example arguments
hold "w" (walk forward) at 60 FPS.

Everything lives on ``device`` (the card unless the caller asks for the
CPU); the camera and the frame clock stay on the host.
"""

from __future__ import annotations


def entry(device="cuda"):
    """Returns (fn, example_args): one full frame step."""
    import torch
    from ascii_renderer_tpu_torch.atlas.io import demo_atlas
    from ascii_renderer_tpu_torch.core.camera import CameraInputs
    from ascii_renderer_tpu_torch.core.config import Config
    from ascii_renderer_tpu_torch.geom.tessellate import tessellate_scene
    from ascii_renderer_tpu_torch.scene.demo import create_demo_scene
    from ascii_renderer_tpu_torch.sim.framestep import (FrameState,
                                                        make_frame_step)

    cfg = Config(pixel_aspect=0.5)
    sb = create_demo_scene()
    sb.set_atlas(demo_atlas())
    sb.set_env_light([0.25, 0.27, 0.3], 1.0)
    scene = sb.build(device=device)
    soup = tuple(torch.from_numpy(x).to(device)
                 for x in tessellate_scene(scene))
    step = make_frame_step(cfg, "raster", soup=soup)

    def frame_step(scene, state, inputs, dt_s, fps):
        state, chars, tint, _frame = step(scene, state, inputs, dt_s, fps)
        return state, chars, tint

    state = FrameState.create(scene.camera)
    inputs = CameraInputs.from_keys({"w"})
    example_args = (scene, state, inputs, 1.0 / 60.0, 60.0)
    return frame_step, example_args
