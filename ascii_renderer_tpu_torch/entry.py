"""The port's counterparts of ``__graft_entry__.entry()`` and
``__graft_entry__.dryrun_multichip()``.

``entry()`` returns (fn, example_args): one full frame step of the
flagship model, the fused frame pipeline on the demo scene (the raster
backend through ``render_soup``: 1,624 triangle slots, the binned bin walk
B6), the UI composite and the glyph decision (the modal vote B4), at the
default 96 x 36 grid. ``fn(scene, state, inputs, dt_s, fps)`` returns
(state', chars u8 [36, 96], tint u8 [36, 96, 3]); the example arguments
hold "w" (walk forward) at 60 FPS.

Everything lives on ``device`` (the card unless the caller asks for the
CPU); the camera and the frame clock stay on the host.

``dryrun_multichip(n_devices, device)`` runs the multi-device paths over a
world of ``n_devices`` ranks (``parallel.mesh.run_world``: NCCL over the
cards, one a rank, or gloo ranks on the CPU; the ranks run the programs of
``parallel.worlds``): two soft-raster train steps over a ("dp", "sp")
mesh, the sharded view farm (then its glyph grids), a row-band ray-traced
frame, the row-band grouped raster and a row-band path-traced frame with
``pixel_active`` set, each held to the local render bit for bit; it
prints one summary line.
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


def _dryrun_rank(device_type: str, train_args, rows: int, cols: int) -> dict:
    """dryrun_multichip's programs on one rank: two train steps over a
    (dp, sp) mesh, then the sharded renders (numpy, whole on the rank)."""
    from ascii_renderer_tpu_torch.parallel import worlds as W
    return {"train": W.train_trajectory(device_type, *train_args, lr=5e-2,
                                        n_single=2),
            "renders": W.sharded_renders(device_type, rows, cols)}


def dryrun_multichip(n_devices: int, device: str = "cuda") -> str:
    """The multi-device paths over a world of ``n_devices`` ranks: NCCL
    over the cards for "cuda" (``n_devices`` at most the cards there are),
    gloo ranks for "cpu". Every rank takes two train steps on a ("dp",
    "sp") mesh and renders the sharded view farm, the row-band ray-traced
    and path-traced (``pixel_active`` set) frames and the row-band
    grouped raster; here every rank's results are held to the local
    renders bit for bit and the farm goes through the glyph pass. Prints
    and returns the summary line."""
    import numpy as np
    import torch
    from ascii_renderer_tpu_torch.ascii.ascii_pass import glyph_decide
    from ascii_renderer_tpu_torch.backends.raster import HEADLINE_KERNEL
    from ascii_renderer_tpu_torch.core.config import Config
    from ascii_renderer_tpu_torch.core.frame import Frame
    from ascii_renderer_tpu_torch.diff.soft_raster import soft_render
    from ascii_renderer_tpu_torch.geom import meshes
    from ascii_renderer_tpu_torch.parallel.mesh import (orbit_cameras,
                                                        run_world)
    from ascii_renderer_tpu_torch.parallel.worlds import (KERNELS,
                                                          local_renders)

    n = n_devices
    dev = torch.device(device)
    # the train step: the bench's sphere at 16x32, sp | rows
    trows, tcols = 16, 32
    sp = next(c for c in (4, 2, 1) if n % c == 0 and trows % c == 0)
    dp = n // sp
    v, f = meshes.uv_sphere(6, 8)
    cams = orbit_cameras(dp, center=(0, 0, 0), radius=2.5, height=0.0)
    gt = torch.tensor([0.9, 0.2, 0.1]).expand(v.shape)
    targets = soft_render(torch.from_numpy(v), gt, f, cams, trows, tcols)
    train_args = ((dp, sp), v, np.full_like(v, 0.5), f, cams, targets,
                  trows, tcols)
    # the renders: 8 rows a rank (TILE_H for the sharded raster)
    rows, cols = 8 * n, 32
    res = run_world(_dryrun_rank, n, device, device, train_args, rows, cols)
    want = local_renders(dev, n, rows, cols)
    for r in res:
        t, got = r["train"], r["renders"]
        assert np.isfinite(t["losses"]).all(), t["losses"]
        assert np.abs(t["verts"][-1] - v).max() > 0.0, \
            "training step did not update parameters"
        np.testing.assert_array_equal(t["losses"], res[0]["train"]["losses"])
        for k, x in want.items():
            assert np.array_equal(got[k], x), f"sharded {k} differs"
        for kernel in KERNELS:
            assert int(got[f"over_{kernel}"].max()) == 0, kernel
    got = res[0]["renders"]
    assert float(got[f"raster_{HEADLINE_KERNEL}"].max()) > 0.0, \
        "band raster rendered nothing"
    cfg = Config(pixel_aspect=0.5)
    chars = glyph_decide(
        Frame.from_float(torch.from_numpy(got["views"]).to(dev)),
        ramp=cfg.ascii_ramp, mode_on=cfg.ascii_mode_filter,
        mode_radius=cfg.mode_radius, mode_thresh=cfg.ascii_mode_thresh,
        grayscale=cfg.use_grayscale)[0]
    assert torch.unique(chars).numel() > 1, "view farm rendered nothing"
    alpha = got["pt_alpha"]
    loss = res[0]["train"]["losses"]
    line = (f"dryrun_multichip OK: {n} {device} ranks, mesh=({dp}x{sp}) "
            f"loss {loss[0]:.4f} -> {loss[1]:.4f}; view farm "
            f"{chars.shape[0]} views, checksum "
            f"{int(chars.to(torch.int64).sum())}; row-band frame {rows}x"
            f"{cols} over {n} bands equals the local frame; band raster "
            f"{rows}x{cols} sum "
            f"{float(got[f'raster_{HEADLINE_KERNEL}'].sum()):.2f}, overflow "
            f"0, equals the local frame; PT band {rows}x{cols} (pixel_active "
            f"set) equals the local frame, "
            f"{int(((alpha >= 2) & (alpha <= 254)).sum())} overrides, alpha "
            f"checksum {int(alpha.astype(np.int64).sum())}")
    print(line, flush=True)
    return line
