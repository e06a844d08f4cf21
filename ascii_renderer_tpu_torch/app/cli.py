"""CLI app shell (torch port of ``ascii_renderer_tpu/app/cli.py``; ref:
js/main.js + index.html).

    python -m ascii_renderer_tpu_torch.app.cli [--device cuda|cpu] ...

CLI flags replace the reference's URL query params (?backend=, ?debug —
js/main.js:65-70,174-180); stdout replaces the DOM/canvas. Modes:

  offline     render N frames (--batch N: N frames per step call), print
              (or save) the glyph text; --progressive accumulates path-
              traced sample batches until every pixel converged
  pixels      stream glyph-bitmap frames (raw RGB(A)) to a file
  image       render one frame and save the glyph-expanded PNG
  interactive curses live loop with WASD/arrow keys (TTY required)
  term        raw-ANSI 24-bit colour loop (native termblit), mouse-look,
              selection pause

The frame pipeline is sim/framestep's step; this shell handles IO, timing
(the TARGET_FPS gate, js/main.js:395-397) and input plumbing. Everything
renders on ``--device`` (default cuda: the card). Without CUDA, and
without ``--device cpu``, ``main`` exits non-zero and renders nothing.

The live modes pipeline their readback (the reference's fbA/fbB double
buffer, js/main.js:364-375): each frame's outputs start copying to pinned
host memory behind a CUDA event as soon as the frame is enqueued, and the
loop shows frame N-1 while frame N renders (``_HostCopy``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from ascii_renderer_tpu_torch.ascii.text import chars_to_strings
from ascii_renderer_tpu_torch.core.camera import CameraInputs
from ascii_renderer_tpu_torch.core.config import Config, PathTracerConfig
from ascii_renderer_tpu_torch.sim.framestep import demo_setup
from ascii_renderer_tpu_torch.utils.profiling import force_completion


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ascii-renderer-tpu-torch",
        description="ASCII renderer on PyTorch / CUDA "
                    "(pathtrace | raytrace | raster)")
    p.add_argument("--backend", "-b", default=None,
                   help="pathtrace|raytrace|raster (aliases pt/rt/r)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="render device (default cuda; cpu runs the plain "
                        "torch versions of the kernels)")
    p.add_argument("--frames", "-n", type=int, default=1)
    p.add_argument("--batch", type=int, default=0,
                   help="offline mode: render N frames per step call "
                        "(sim/framestep.make_batched_frame_step)")
    p.add_argument("--cols", type=int, default=None)
    p.add_argument("--rows", type=int, default=None)
    p.add_argument("--spp", type=int, default=None, help="path tracer samples")
    p.add_argument("--ramp", default=None)
    p.add_argument("--no-modal", action="store_true",
                   help="disable the modal glyph filter")
    p.add_argument("--grayscale", action="store_true")
    p.add_argument("--debug", action="store_true",
                   help="also dump the raw RGB cell grid stats (the ?debug "
                        "preview analog)")
    p.add_argument("--mode",
                   choices=["offline", "interactive", "image", "term",
                            "pixels"],
                   default="offline")
    p.add_argument("--progressive", action="store_true",
                   help="progressive path tracing: accumulate sample "
                        "batches across frames while the camera is still "
                        "(js/render/renderer.js:101-210)")
    p.add_argument("--out", default=None, help="output file (text or png)")
    p.add_argument("--pixel-aspect", type=_positive_float, default=None,
                   help="character cell width/height ratio (> 0); default: "
                        "measured from the terminal in --mode term "
                        "(TIOCGWINSZ), else the config default (0.5)")
    p.add_argument("--cell", default=None, metavar="WxH",
                   help="--mode image/pixels: glyph cell size in device "
                        "pixels, e.g. 16x32 — bakes a fresh glyph atlas at "
                        "that size (js/ascii_pass.js:20-86,304-326); "
                        "default: the checked-in 8x16 asset")
    p.add_argument("--font", default=None, metavar="PATH",
                   help="--mode image/pixels: TTF font file for --cell "
                        "baking (default: DejaVuSansMono)")
    p.add_argument("--fps", type=float, default=None, help="target fps cap")
    p.add_argument("--scene", default=None,
                   help="unified-schema scene JSON to render instead of the "
                        "demo scene (see utils/checkpoint.save_scene_json)")
    p.add_argument("--atlas", default=None, metavar="FILE:WxH",
                   help="attach a raw ASCII-texture atlas, e.g. art.bin:32x32")
    return p


_ALIASES = {"pt": "pathtrace", "rt": "raytrace", "r": "raster",
            "path": "pathtrace", "ray": "raytrace", "rasterizer": "raster"}
_KNOWN_BACKENDS = ("pathtrace", "raytrace", "raster")


def _positive_float(s: str) -> float:
    """argparse type: a strictly positive float. Rejects 0 (which a
    truthiness gate would silently ignore) and negatives (which would
    mirror-flip the image via a negative NDC aspect)."""
    v = float(s)
    if not v > 0:
        raise argparse.ArgumentTypeError(f"must be > 0, got {s}")
    return v


def _glyph_atlas_from_args(args):
    """--cell WxH [--font PATH] -> freshly baked glyph atlas (None = the
    checked-in 8x16 asset)."""
    if not getattr(args, "cell", None):
        return None
    try:
        w, h = (int(v) for v in args.cell.lower().split("x"))
        if w <= 0 or h <= 0:
            raise ValueError
    except ValueError:
        raise SystemExit(f'error: --cell expects WxH, got "{args.cell}"')
    from ascii_renderer_tpu_torch.ascii.glyphs import bake_glyph_atlas
    return bake_glyph_atlas(w, h, font_path=getattr(args, "font", None))


def config_from_args(args) -> Config:
    cfg = Config()
    kw = {}
    if args.cols:
        kw["grid_width"] = args.cols
    if args.rows:
        kw["grid_height"] = args.rows
    if args.ramp:
        kw["ascii_ramp"] = args.ramp
    if args.no_modal:
        kw["ascii_mode_filter"] = False
    if args.grayscale:
        kw["use_grayscale"] = True
    if args.fps:
        kw["target_fps"] = int(args.fps)
    if args.backend:
        kw["default_backend"] = _ALIASES.get(args.backend, args.backend)
    if args.spp:
        kw["path_tracer"] = PathTracerConfig(samples_per_batch=args.spp)
    pa = getattr(args, "pixel_aspect", None)
    if pa is not None:  # `is not None`, not truthiness: 0 must error via
        kw["pixel_aspect"] = pa  # the argparse type, never be ignored
    return cfg.replace(**kw) if kw else cfg


def measure_terminal_pixel_aspect(fd=None, fallback: float = 0.5) -> float:
    """Measured character-cell aspect (width/height) of the attached
    terminal via TIOCGWINSZ's ws_xpixel/ws_ypixel (the reference measures
    a live DOM glyph, js/main.js:166-171,217). Terminals that don't report
    pixel sizes (xpixel/ypixel of 0 is common) fall back to `fallback`."""
    import fcntl
    import struct
    import termios
    try:
        if fd is None:
            fd = sys.stdout.fileno()
        buf = fcntl.ioctl(fd, termios.TIOCGWINSZ, b"\0" * 8)
        rows_, cols_, xpx, ypx = struct.unpack("HHHH", buf)
        if rows_ > 0 and cols_ > 0 and xpx > 0 and ypx > 0:
            cw = xpx / cols_
            ch = ypx / rows_
            if ch > 0 and 0.1 <= cw / ch <= 2.0:  # sanity bounds
                return cw / ch
    except (OSError, ValueError):
        pass
    return fallback


def _builder_from_args(args):
    """--scene / --atlas -> SceneBuilder override (None = demo scene).

    The raytrace backend gets the LIT demo fixture by default: the demo
    scene lights the room with emissive quads, which the Whitted tracer
    does not treat as lights (a pitch-black room, as in the reference), so
    the rt fixture (same room, point / directional lights) is substituted
    unless the user names a scene."""
    if not args.scene and not args.atlas:
        if getattr(args, "backend", None) in ("rt", "ray", "raytrace"):
            from ascii_renderer_tpu_torch.scene.demo import (
                create_rt_demo_scene)
            return create_rt_demo_scene()
        return None
    if args.scene:
        from ascii_renderer_tpu_torch.utils.checkpoint import load_scene_json
        sb = load_scene_json(args.scene)
    else:
        from ascii_renderer_tpu_torch.scene.demo import create_demo_scene
        sb = create_demo_scene()
    if args.atlas:
        try:
            path, dims = args.atlas.rsplit(":", 1)
            w, h = (int(v) for v in dims.lower().split("x"))
        except ValueError:
            raise SystemExit(
                f'error: --atlas expects FILE:WxH, got "{args.atlas}"')
        from ascii_renderer_tpu_torch.atlas.io import load_atlas
        sb.set_atlas(load_atlas(path, w, h))
    return sb


class _HostCopy:
    """A copy of device tensors to the host, started without waiting: on
    the card into pinned host memory, non-blocking, behind a CUDA event.
    Started right after a frame is enqueued, it sits on the stream before
    the next frame's work, so ``wait()`` returns once this frame is done
    and does not wait for the next one. CPU tensors are already there."""

    def __init__(self, *tensors: torch.Tensor):
        self._event = None
        self._host = list(tensors)
        if tensors[0].is_cuda:
            self._host = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self._host.append(h)
            self._event = torch.cuda.Event()
            self._event.record()

    def wait(self):
        """The tensors as numpy arrays, once the copy has landed."""
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


def run_offline(args) -> int:
    cfg = config_from_args(args)
    # a batch of 1 is the one-frame step (the reference builds the batched
    # step for it, then calls it as the one-frame step, and fails)
    batch = args.batch if args.batch > 1 else 0
    cfg, scene, state, step = demo_setup(cfg, builder=_builder_from_args(args),
                                         batch=batch, device=args.device)
    ins = CameraInputs.from_keys(())
    fps_val = float(cfg.target_fps)
    t_frame = 0.0
    frame = None
    if batch:
        from ascii_renderer_tpu_torch.sim.framestep import broadcast_inputs
        ins_n = broadcast_inputs(ins, batch)
        dt_n = torch.full((batch,), 1.0 / 60.0, dtype=torch.float32)
        for _ in range(-(-args.frames // batch)):
            t0 = time.perf_counter()
            state, chars_n, _tint_n = step(scene, state, ins_n, dt_n, fps_val)
            force_completion(chars_n)
            t_frame = (time.perf_counter() - t0) / batch
            fps_val = 1.0 / max(t_frame, 1e-6)
        chars = chars_n[-1]
    else:
        for _ in range(args.frames):
            t0 = time.perf_counter()
            state, chars, _tint, frame = step(scene, state, ins, 1.0 / 60.0,
                                              fps_val)
            force_completion(chars)
            t_frame = time.perf_counter() - t0
            fps_val = 1.0 / max(t_frame, 1e-6)
    rows = chars_to_strings(chars)
    text = "\n".join(rows)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.out} ({len(rows)}x{len(rows[0])} glyphs, "
              f"last frame {t_frame*1000:.1f} ms)")
    else:
        print(text)
    if args.debug and frame is not None:
        rgb = frame.rgb.cpu().numpy()
        a = frame.a.cpu().numpy()
        print(f"[debug] cell grid {rgb.shape} mean={rgb.mean():.1f} "
              f"max={rgb.max()} overrides={int(((a >= 2) & (a <= 254)).sum())}",
              file=sys.stderr)
    return 0


def run_progressive(args) -> int:
    """Progressive path-traced refinement: one spp batch a step through
    sim/accum.ProgressivePathTracer (Welford statistics, 95% CI
    convergence, camera-move reset), until every pixel converged or
    --frames batches ran. --debug prints each batch's converged share (a
    readback a batch); otherwise the lagged ``poll_done`` probe never
    synchronises the stream."""
    cfg = config_from_args(args)
    sb = _builder_from_args(args)
    if sb is None:
        from ascii_renderer_tpu_torch.atlas.io import demo_atlas
        from ascii_renderer_tpu_torch.scene.demo import create_demo_scene
        sb = create_demo_scene()
        sb.set_atlas(demo_atlas())
    scene = sb.build(min_pad=1, device=args.device)
    from ascii_renderer_tpu_torch.ascii.ascii_pass import glyph_decide
    from ascii_renderer_tpu_torch.core.frame import Frame
    from ascii_renderer_tpu_torch.sim.accum import ProgressivePathTracer

    tracer = ProgressivePathTracer(cfg, scene)
    n_max = args.frames if args.frames > 1 else cfg.adaptive.max_samples
    display = act = a = None
    t0 = time.perf_counter()
    for i in range(n_max):
        display, a, act = tracer.step(scene.camera)
        if args.debug:
            conv = 100.0 * (1.0 - float(act.cpu().numpy().mean()))
            print(f"[progressive] batch {i + 1}: {conv:.1f}% converged",
                  file=sys.stderr)
            if tracer.done:
                break
        elif tracer.poll_done():
            break
    dt = time.perf_counter() - t0
    frame = Frame.from_float(display, a)
    chars, _tint = glyph_decide(
        frame, ramp=cfg.ascii_ramp, mode_on=cfg.ascii_mode_filter,
        mode_radius=cfg.mode_radius, mode_thresh=cfg.ascii_mode_thresh,
        grayscale=cfg.use_grayscale)
    text = "\n".join(chars_to_strings(chars))
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    conv = 100.0 * (1.0 - float(act.cpu().numpy().mean()))
    spb = cfg.path_tracer.samples_per_batch
    print(f"[progressive] {i + 1} batches x {spb} spp in {dt:.2f}s, "
          f"{conv:.1f}% of pixels converged "
          f"(tol {cfg.adaptive.max_tolerance:.0%}, "
          f"cap {cfg.adaptive.max_samples} batches)", file=sys.stderr)
    return 0


def run_pixels(args) -> int:
    """Frame-rate glyph-BITMAP presentation (js/ascii_pass.js:257-302):
    render -> glyph decision -> pixel expansion on the device -> raw
    RGB(A) frame stream to --out (default frames.rgb), with the rate
    measured; frame N-1 is written while frame N renders."""
    cfg = config_from_args(args)
    cfg, scene, state, step = demo_setup(cfg, builder=_builder_from_args(args),
                                         device=args.device)
    from ascii_renderer_tpu_torch.ascii.ascii_pass import AsciiPass

    p = AsciiPass(cfg, glyph_atlas=_glyph_atlas_from_args(args),
                  device=args.device)
    ins = CameraInputs.from_keys(())
    fps_val = float(cfg.target_fps)
    out_path = args.out or "frames.rgb"
    n = max(1, args.frames)
    pending = None
    wrote = 0
    # warm-up outside the timed loop (the first frame pays one-time set-up
    # costs); its frame is discarded and the state is unchanged
    _s, _c, _t, _f = step(scene, state, ins, 0.0, fps_val)
    _HostCopy(p._expand(_c, _t, p.atlas)).wait()
    t0 = time.perf_counter()
    with open(out_path, "wb") as f:
        for _ in range(n):
            state, chars, tint, _frame = step(scene, state, ins, 1.0 / 60.0,
                                              fps_val)
            px = _HostCopy(p._expand(chars, tint, p.atlas))
            if pending is not None:
                f.write(pending.wait()[0].tobytes())
                wrote += 1
            pending = px
            fps_val = wrote / max(time.perf_counter() - t0, 1e-6)
        last = pending.wait()[0]
        f.write(last.tobytes())
        wrote += 1
    dt = (time.perf_counter() - t0) / n
    h, w, nc = last.shape
    print(f"wrote {wrote} raw frames ({w}x{h} px, {nc} ch) to {out_path} "
          f"at {1.0 / dt:.1f} FPS (cell grid {cfg.grid_width}x"
          f"{cfg.grid_height})")
    return 0


def run_image(args) -> int:
    cfg = config_from_args(args)
    cfg, scene, state, step = demo_setup(cfg, builder=_builder_from_args(args),
                                         device=args.device)
    ins = CameraInputs.from_keys(())
    state, chars, tint, _frame = step(scene, state, ins, 1.0 / 60.0,
                                      float(cfg.target_fps))
    from ascii_renderer_tpu_torch.ascii.ascii_pass import AsciiPass
    p = AsciiPass(cfg, glyph_atlas=_glyph_atlas_from_args(args),
                  device=args.device)
    img = p._expand(chars, tint, p.atlas).cpu().numpy()
    out = args.out or "frame.png"
    from PIL import Image
    Image.fromarray(img).save(out)
    print(f"wrote {out} ({img.shape[1]}x{img.shape[0]} px)")
    return 0


def run_interactive(args) -> int:
    """Live terminal loop: WASD move, arrows look, c ripples, q quits
    (the pointer-lock/keyboard UX of js/main.js:84-135, terminal-ized)."""
    import curses

    cfg = config_from_args(args)
    cfg, scene, state, step = demo_setup(cfg, builder=_builder_from_args(args),
                                         device=args.device)

    def loop(scr):
        nonlocal state
        curses.curs_set(0)
        scr.nodelay(True)
        frame_interval = 1.0 / cfg.target_fps
        fps_val = float(cfg.target_fps)
        pending = None  # frame in flight (dispatch-ahead double buffer)
        last = time.perf_counter()
        keymap = {ord("w"): "w", ord("a"): "a", ord("s"): "s", ord("d"): "d",
                  ord(" "): " ", curses.KEY_UP: "arrowup",
                  curses.KEY_DOWN: "arrowdown", curses.KEY_LEFT: "arrowleft",
                  curses.KEY_RIGHT: "arrowright"}
        while True:
            now = time.perf_counter()
            dt = now - last
            if dt < frame_interval:  # TARGET_FPS gate
                time.sleep(frame_interval - dt)
                continue
            last = now
            keys = set()
            while True:
                ch = scr.getch()
                if ch == -1:
                    break
                if ch in (ord("q"), 27):
                    return
                if ch == ord("c"):  # click -> ripple at grid center
                    state = state.add_ripple(cfg.grid_width // 2,
                                             cfg.grid_height // 2)
                k = keymap.get(ch)
                if k:
                    keys.add(k)
            ins = CameraInputs.from_keys(keys)
            # kick frame N, then display frame N-1 while N renders
            state, chars, _tint, _f = step(scene, state, ins, dt, fps_val)
            copy = _HostCopy(chars)
            if pending is not None:
                rows = chars_to_strings(pending.wait()[0])
                maxy, maxx = scr.getmaxyx()
                for y, row in enumerate(rows[: maxy - 1]):
                    scr.addnstr(y, 0, row, maxx - 1)
                scr.refresh()
            pending = copy
            fps_val = 1.0 / max(time.perf_counter() - now, 1e-6)

    curses.wrapper(loop)
    return 0


def run_term(args) -> int:
    """Raw-ANSI 24-bit color loop via the native termblit encoder: WASD
    move, arrows look, mouse look, p pauses for text selection, q quits.
    Uses the alternate screen buffer.

    Selection pause (the reference's leave-pointer-lock-to-copy UX,
    js/text_overlay.js:188-238): press ``p`` — the frame freezes and
    mouse reporting turns OFF, so the terminal's native click-drag
    selection and copy work on the frozen glyphs; press any key to
    resume (the keypress is consumed)."""
    import select
    import termios
    import tty

    from ascii_renderer_tpu_torch.app.termblit import TermBlitter
    from ascii_renderer_tpu_torch.app.terminput import TermInput
    from ascii_renderer_tpu_torch.utils.profiling import FrameStats

    if not sys.stdin.isatty() or not sys.stdout.isatty():
        print("error: --mode term needs an interactive terminal "
              "(use --mode offline for piped output)", file=sys.stderr)
        return 2

    cfg = config_from_args(args)
    if args.pixel_aspect is None:
        # measure the real cell aspect (reference: js/main.js:166-171)
        cfg = cfg.replace(pixel_aspect=measure_terminal_pixel_aspect(
            fallback=cfg.pixel_aspect))
    cfg, scene, state, step = demo_setup(cfg, builder=_builder_from_args(args),
                                         device=args.device)
    tb = TermBlitter(cfg.grid_height, cfg.grid_width,
                     color=not cfg.use_grayscale)
    stats = FrameStats()
    frame_interval = 1.0 / cfg.target_fps

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    out = sys.stdout.buffer
    # mouse-look: a terminal cell is several device pixels tall/wide; scale
    # cell deltas so sensitivity feels like the reference's pixel deltas
    mouse_scale = 8.0
    try:
        tty.setcbreak(fd)
        # alt screen, hide cursor, any-event mouse tracking (xterm 1003)
        # with SGR coordinates (1006) -> pointer-look, js/main.js:108-118
        out.write(b"\x1b[?1049h\x1b[?25l\x1b[2J\x1b[?1003h\x1b[?1006h")
        out.flush()
        ti = TermInput(mouse_scale=mouse_scale)
        last = time.perf_counter()
        pending = None  # frame in flight (dispatch-ahead double buffer)
        while True:
            now = time.perf_counter()
            dt = now - last
            if dt < frame_interval:
                time.sleep(frame_interval - dt)
                continue
            last = now
            ti.reset_frame()
            while select.select([fd], [], [], 0)[0]:
                ti.feed(os.read(fd, 64))
            if ti.quit:
                return 0
            for cx, cy in ti.clicks:
                state = state.add_ripple(cx, cy)
            for tr in ti.transitions:
                if tr == "pause":  # free the terminal's native selection
                    out.write(b"\x1b[?1006l\x1b[?1003l")
                else:  # resume: restore mouse-look reporting
                    out.write(b"\x1b[?1003h\x1b[?1006h")
                out.flush()
            if ti.paused:  # frozen frame; nothing to render or draw
                time.sleep(0.05)
                continue
            ins = CameraInputs.from_keys(ti.keys, mouse_dx=ti.mdx,
                                         mouse_dy=ti.mdy)
            # kick frame N, then encode + display frame N-1 while N renders
            state, chars, tint, _f = step(scene, state, ins, dt, stats.fps)
            copy = _HostCopy(chars, tint)
            if pending is not None:
                out.write(tb.encode(*pending.wait()))
                out.flush()
            pending = copy
            stats.tick()
    finally:
        out.write(b"\x1b[?1006l\x1b[?1003l\x1b[0m\x1b[?25h\x1b[?1049l")
        out.flush()
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        print(f"[termblit native={tb.native}] {stats.summary()}",
              file=sys.stderr)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.backend:
        resolved = _ALIASES.get(args.backend, args.backend)
        if resolved not in _KNOWN_BACKENDS:
            print(f'error: unknown backend "{args.backend}". '
                  f'Known: {", ".join(_KNOWN_BACKENDS)} '
                  f'(aliases: {", ".join(_ALIASES)})', file=sys.stderr)
            return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: CUDA is not available (pass --device cpu to render "
              "on the CPU)", file=sys.stderr)
        return 2
    if args.mode == "interactive":
        return run_interactive(args)
    if args.mode == "term":
        return run_term(args)
    if args.mode == "image":
        return run_image(args)
    if args.mode == "pixels":
        return run_pixels(args)
    if args.progressive:
        return run_progressive(args)
    return run_offline(args)


if __name__ == "__main__":
    sys.exit(main())
