"""The port's app shell against the JAX package's, in one process on the
CPU: ``app/cli.py`` (every mode and flag, ``--device cpu``),
``app/terminput.py`` and ``app/termblit.py``.

Tolerances: raster and raytrace CLI text, the pixels mode's bytes and the
image mode's PNG are exact (their frames are bit-exact against JAX's);
path-traced output is held to the port's PT contract (the alpha /
override plane exact, radiance within 1e-5, so each RGB byte within 1 and
each ramp glyph within one ramp step). JAX's CLI takes the XLA core on
the CPU for the path tracer; the comparison routes it through its Pallas
kernel (interpret mode), the path the port takes, by wrapping its
``render_pt``."""

import contextlib
import dataclasses
import io
import os
import pty
import select
import shutil
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ascii_renderer_tpu.app import cli as JCLI
from ascii_renderer_tpu.app import termblit as JTB
from ascii_renderer_tpu.app.terminput import TermInput as JTermInput
from ascii_renderer_tpu.backends import pathtrace as JPT
from ascii_renderer_tpu_torch.app import cli as TCLI
from ascii_renderer_tpu_torch.app import termblit as TTB
from ascii_renderer_tpu_torch.app.terminput import TermInput
from ascii_renderer_tpu_torch.core import quantize

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDE_ATLAS = os.path.join(REPO, "assets", "atlas_wide_32x16.bin")
NATIVE = os.path.join(REPO, "native")
GRID = ["--rows", "12", "--cols", "32"]


def _run(mod, argv, record=False):
    """mod.main(argv) with stdout / stderr captured: (rc, out, err,
    frames) — frames: the Frame of every one-frame step call when
    ``record``."""
    frames = []
    setup = mod.demo_setup

    def recording(*a, **k):
        cfg, scene, state, step = setup(*a, **k)

        def rec(*sa):
            out = step(*sa)
            frames.append(out[3])
            return out

        return cfg, scene, state, rec

    out, err = io.StringIO(), io.StringIO()
    if record:
        mod.demo_setup = recording
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = mod.main(list(argv))
    finally:
        mod.demo_setup = setup
    return rc, out.getvalue(), err.getvalue(), frames


def _port(argv, **kw):
    return _run(TCLI, [*argv, "--device", "cpu"], **kw)


# ---------------------------------------------------------------------------
# offline text
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("argv", [
    ["--backend", "raster"],
    ["--backend", "raytrace"],
    ["--backend", "r", "--atlas", WIDE_ATLAS + ":32x16", "--no-modal"],
], ids=["raster", "raytrace", "raster_atlas_flag"])
def test_offline_text_equals_jax(argv):
    """One offline frame (the FPS readout at the config's 60): the text
    equals JAX's CLI text exactly."""
    rj, tj, _e, _f = _run(JCLI, [*argv, *GRID])
    rt, tt, _e, _f = _port([*argv, *GRID])
    assert rj == rt == 0
    rows = tt.splitlines()
    assert len(rows) == 12 and all(len(r) == 32 for r in rows)
    assert tt == tj
    assert len(set(tt)) > 6


def test_scene_json_from_jax_renders_as_jax(tmp_path):
    """--scene: a scene JSON written by the JAX package (the demo room and
    a mesh) renders to JAX's text through the port's raster CLI."""
    from ascii_renderer_tpu.scene.demo import create_demo_scene
    from ascii_renderer_tpu.utils.checkpoint import save_scene_json
    sb = create_demo_scene()
    sb.set_env_light([0.25, 0.27, 0.3], 1.0)
    sb.add_mesh([0, 0, 0, 2, 0, 0, 0, 2, 0, 2, 2, 0], [0, 1, 2, 1, 3, 2, 0, 9, 1],
                material_id=3)
    path = str(tmp_path / "scene.json")
    save_scene_json(path, sb)
    argv = ["--backend", "raster", "--scene", path, *GRID]
    rj, tj, _e, _f = _run(JCLI, argv)
    rt, tt, _e, _f = _port(argv)
    assert rj == rt == 0 and tt == tj


def test_pathtrace_offline_holds_the_pt_contract(monkeypatch):
    """--backend pathtrace, spp 2: the alpha plane equals JAX's kernel
    path exactly, every RGB byte is within 1, the override cells' text is
    equal and every other glyph within one ramp step (mode filter off);
    the --debug line reports the same override count."""
    orig = JPT.render_pt
    monkeypatch.setattr(JPT, "render_pt", lambda *a, **k: orig(
        *a, **{**k, "use_kernel": True, "packed": None}))
    argv = ["--backend", "pathtrace", "--spp", "2", "--no-modal", "--debug",
            *GRID]
    rj, tj, ej, fj = _run(JCLI, argv, record=True)
    rt, tt, et, ft = _port(argv, record=True)
    assert rj == rt == 0
    aj, at = np.asarray(fj[-1].a), ft[-1].a.numpy()
    np.testing.assert_array_equal(at, aj)
    d = np.abs(ft[-1].rgb.numpy().astype(int) - np.asarray(fj[-1].rgb))
    assert d.max() <= 1
    ov = (aj >= 2) & (aj <= 254)
    assert ov.sum() >= 2 * 32 + 2 * 10  # the border at least
    g = np.array([list(r) for r in tt.splitlines()])
    w = np.array([list(r) for r in tj.splitlines()])
    assert g.shape == (12, 32) and (g[ov] == w[ov]).all()
    ramp = quantize.DEFAULT_RAMP
    for a, b in zip(g[~ov & (g != w)], w[~ov & (g != w)]):
        assert abs(ramp.index(a) - ramp.index(b)) == 1, (a, b)
    assert et.splitlines()[-1].split("overrides=")[1] == \
        ej.splitlines()[-1].split("overrides=")[1]


class _Clock:
    """A stand-in for the CLI's ``time`` module whose clock advances 1/60 s
    a reading: every measured frame takes 1/60 s, so the FPS readout is the
    same 60 whatever the host's speed."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0 / 60.0
        return self.t

    def sleep(self, _s):
        pass


@pytest.mark.parametrize("batch", ["4", "1"])
def test_batched_offline_gives_the_unbatched_last_frame(monkeypatch, batch):
    """--batch 4 --frames 4 (one step call of 4 frames) prints the last
    frame of 4 one-frame steps; --batch 1 is the one-frame step (JAX's
    CLI fails on it: it builds the batched step, then calls it as the
    one-frame step)."""
    monkeypatch.setattr(TCLI, "time", _Clock())
    argv = ["--backend", "raster", "--frames", "4", *GRID]
    rb, tb, _e, _f = _port([*argv, "--batch", batch])
    monkeypatch.setattr(TCLI, "time", _Clock())
    ru, tu, _e, frames = _port(argv, record=True)
    assert rb == ru == 0 and len(frames) == 4
    assert tb == tu


def test_progressive_reports_convergence(tmp_path):
    """--progressive writes a valid glyph grid and reports each batch's
    converged share (--debug) and the run's; more batches change the
    estimate (accumulation is live)."""
    out = tmp_path / "prog.txt"
    rc, _o, err, _f = _port(["--progressive", "--frames", "3", "--rows",
                             "10", "--cols", "24", "--spp", "4",
                             "--no-modal", "--debug", "--out", str(out)])
    assert rc == 0
    text = out.read_text().rstrip("\n").split("\n")
    assert len(text) == 10 and all(len(r) == 24 for r in text)
    assert "% converged" in err and "3 batches x 4 spp" in err
    two = tmp_path / "two.txt"
    assert _port(["--progressive", "--frames", "2", "--rows", "10",
                  "--cols", "24", "--spp", "4", "--no-modal", "--out",
                  str(two)])[0] == 0
    assert two.read_text() != out.read_text()


def test_progressive_runs_until_poll_done(tmp_path):
    """Without --frames the loop ends at poll_done() or the config's cap."""
    out = tmp_path / "prog.txt"
    rc, _o, err, _f = _port(["--progressive", "--rows", "6", "--cols", "12",
                             "--spp", "2", "--out", str(out)])
    assert rc == 0 and "of pixels converged" in err
    assert len(out.read_text().split("\n")[0]) == 12


# ---------------------------------------------------------------------------
# glyph bitmaps
# ---------------------------------------------------------------------------
def test_pixels_mode_bytes_equal_jax(tmp_path):
    """--mode pixels --backend raytrace, 2 frames (both at a fixed FPS
    readout: the config's, then 0): the raw RGBA stream equals JAX's."""
    argv = ["--mode", "pixels", "--backend", "raytrace", "--frames", "2",
            "--rows", "8", "--cols", "16"]
    rj, oj, _e, _f = _run(JCLI, [*argv, "--out", str(tmp_path / "j.rgb")])
    rt, ot, _e, _f = _port([*argv, "--out", str(tmp_path / "t.rgb")])
    assert rj == rt == 0
    assert "wrote 2 raw frames (128x128 px, 4 ch)" in ot and "FPS" in ot
    got = np.fromfile(tmp_path / "t.rgb", np.uint8)
    want = np.fromfile(tmp_path / "j.rgb", np.uint8)
    assert got.size == 2 * 128 * 128 * 4
    np.testing.assert_array_equal(got, want)
    frames = got.reshape(2, 128, 128, 4)
    assert (frames[..., :3] == 255).any() and (frames[..., :3] < 250).any()


def test_image_mode_custom_cell_png_equals_jax(tmp_path):
    """--mode image --cell 16x32 bakes an atlas at that cell size: the PNG
    has the grid x cell size and the same bytes as JAX's."""
    from PIL import Image
    argv = ["--mode", "image", "--backend", "raytrace", "--rows", "6",
            "--cols", "12", "--no-modal", "--cell", "16x32"]
    rj, _o, _e, _f = _run(JCLI, [*argv, "--out", str(tmp_path / "j.png")])
    rt, ot, _e, _f = _port([*argv, "--out", str(tmp_path / "t.png")])
    assert rj == rt == 0 and "(192x192 px)" in ot
    assert Image.open(tmp_path / "t.png").size == (12 * 16, 6 * 32)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()


# ---------------------------------------------------------------------------
# flags
# ---------------------------------------------------------------------------
def test_cell_flag_rejects_garbage():
    with pytest.raises(SystemExit):
        TCLI.main(["--mode", "image", "--cell", "16by32", "--device", "cpu"])


def test_pixel_aspect_flag_validation(capsys):
    for bad in ("0", "-0.5"):
        with pytest.raises(SystemExit) as e:
            TCLI.main(["--pixel-aspect", bad, "--device", "cpu"])
        assert e.value.code != 0
        assert "must be > 0" in capsys.readouterr().err


def test_pixel_aspect_flag_applies():
    args = TCLI.build_parser().parse_args(["--pixel-aspect", "0.7"])
    assert TCLI.config_from_args(args).pixel_aspect == 0.7


def test_config_from_args_equals_jax():
    """Every config flag maps to the config JAX's CLI makes."""
    argv = ["--cols", "40", "--rows", "20", "--ramp", " .:#", "--no-modal",
            "--grayscale", "--fps", "30", "--backend", "rt", "--spp", "7",
            "--pixel-aspect", "0.7"]
    got = TCLI.config_from_args(TCLI.build_parser().parse_args(argv))
    want = JCLI.config_from_args(JCLI.build_parser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.default_backend == "raytrace" and got.grid_width == 40


def test_unknown_backend_exits_nonzero(capsys):
    assert TCLI.main(["--backend", "vulkan", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert 'unknown backend "vulkan"' in err and "pathtrace" in err


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"],
                                  ["--mode", "pixels"]])
def test_without_cuda_main_renders_nothing(monkeypatch, capsys, argv):
    """Without CUDA, and without --device cpu, main exits non-zero with a
    message before any scene is set up: nothing renders on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_setup(*a, **k):
        raise AssertionError("demo_setup called without a device")

    monkeypatch.setattr(TCLI, "demo_setup", no_setup)
    assert TCLI.main(argv) != 0
    assert "CUDA is not available" in capsys.readouterr().err


def test_measure_terminal_pixel_aspect_fake_ioctl(monkeypatch):
    """TIOCGWINSZ-derived cell aspect: pixel sizes reported -> cw/ch;
    zeros, ioctl failure or absurd ratios -> the fallback; as JAX's."""
    import fcntl

    def fake(packed):
        return lambda fd, req, buf: packed

    cases = [(struct.pack("HHHH", 40, 100, 800, 1000), 0.5),
             (struct.pack("HHHH", 40, 100, 0, 0), 0.5),
             (struct.pack("HHHH", 1, 1000, 4, 1000), 0.5)]
    for packed, fb in cases:
        monkeypatch.setattr(fcntl, "ioctl", fake(packed))
        got = TCLI.measure_terminal_pixel_aspect(fd=0, fallback=fb)
        assert got == JCLI.measure_terminal_pixel_aspect(fd=0, fallback=fb)
    monkeypatch.setattr(fcntl, "ioctl", fake(cases[0][0]))
    assert abs(TCLI.measure_terminal_pixel_aspect(fd=0) - 0.32) < 1e-9

    def raising(fd, req, buf):
        raise OSError(25, "not a tty")

    monkeypatch.setattr(fcntl, "ioctl", raising)
    assert TCLI.measure_terminal_pixel_aspect(fd=0, fallback=0.44) == 0.44


# ---------------------------------------------------------------------------
# TermInput: the cases of tests/test_cli_term.py, each against JAX's
# ---------------------------------------------------------------------------
def _state(ti):
    return (ti.keys, ti.mdx, ti.mdy, ti.clicks, ti.transitions, ti.quit,
            ti.paused)


def _feed_both(chunks, **kw):
    a, b = TermInput(**kw), JTermInput(**kw)
    for c in chunks:
        a.feed(c)
        b.feed(c)
        assert _state(a) == _state(b)
    return a


def test_terminput_keys_and_arrows():
    ti = _feed_both([b"w d", b"\x1b[A\x1b[D"])
    assert ti.keys == {"w", "d", " ", "arrowup", "arrowleft"}
    assert not ti.quit and not ti.paused
    ti.reset_frame()
    assert ti.keys == set() and ti.mdx == 0.0


def test_terminput_mouse_look_and_click():
    ti = _feed_both([b"\x1b[<35;10;5M", b"\x1b[<35;14;6M"], mouse_scale=8.0)
    assert ti.mdx == 4 * 8.0 and ti.mdy == 1 * 8.0
    ti.feed(b"\x1b[<0;3;2M")
    assert (2, 1) in ti.clicks


@pytest.mark.parametrize("key", [b"q", b"\x03"])
def test_terminput_quit(key):
    assert _feed_both([key]).quit


def test_terminput_selection_pause_cycle():
    ti = _feed_both([b"\x1b[<35;10;5M", b"p", b"\x1b[<35;20;9M", b"q",
                     b"\x1b[<35;30;9M"], mouse_scale=8.0)
    assert not ti.paused and not ti.quit
    assert ti.transitions == ["pause", "resume"]
    assert ti.mdx == 0.0 and ti.mdy == 0.0
    ti.feed(b"\x1b[<35;31;9M")
    assert ti.mdx == 8.0 and ti.keys == set()


def test_terminput_pause_resume_within_one_frame():
    ti = _feed_both([b"px"])
    assert not ti.paused and ti.transitions == ["pause", "resume"]


def test_terminput_malformed_csi_resyncs():
    ti = _feed_both([b"\x1b[<garbage-that-never-terminates-000", b"w"])
    assert "w" in ti.keys


# ---------------------------------------------------------------------------
# TermBlitter
# ---------------------------------------------------------------------------
def _files(d):
    """{name: (mtime, bytes)} of the files in directory d."""
    return {n: (os.path.getmtime(os.path.join(d, n)),
                open(os.path.join(d, n), "rb").read())
            for n in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def grids():
    rng = np.random.default_rng(0)
    chars = rng.integers(33, 127, (6, 20), dtype=np.uint8)
    rgb = rng.integers(0, 256, (6, 20, 3), dtype=np.uint8)
    return chars, rgb


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("color", [True, False], ids=["color", "mono"])
def test_termblit_encode_equals_jax(grids, native, color):
    """Full repaint, a repeat (diffed to almost nothing), a one-cell change
    and a reset: the byte streams equal JAX's encoder's."""
    chars, rgb = grids
    tb, jb = TTB.TermBlitter(6, 20, color=color), JTB.TermBlitter(
        6, 20, color=color)
    assert tb.native and jb.native
    if not native:
        tb._lib = jb._lib = None
    chars2 = chars.copy()
    chars2[3, 7] = ord("Z")
    rgb2 = rgb.copy()
    rgb2[5, 19] = (1, 2, 3)
    outs = []
    for c, r in ((chars, rgb), (chars, rgb), (chars2, rgb), (chars2, rgb2)):
        outs.append(tb.encode(c, r if color else None))
        assert outs[-1] == jb.encode(c, r if color else None)
    tb.reset()
    jb.reset()
    assert tb.encode(chars, rgb) == jb.encode(chars, rgb) == outs[0]
    assert outs[0].startswith(b"\x1b[1;1H") and outs[0].endswith(b"\x1b[0m")
    assert (b"\x1b[38;2;" in outs[0]) == color
    if native:
        assert len(outs[1]) < len(outs[0]) / 4
        assert b"\x1b[4;8H" in outs[2] and len(outs[2]) < len(outs[0]) / 2


def test_termblit_python_encoder_equals_native_full_repaint(grids):
    chars, rgb = grids
    tb, py = TTB.TermBlitter(6, 20), TTB.TermBlitter(6, 20)
    py._lib = None
    assert tb.native and tb.encode(chars, rgb) == py.encode(chars, rgb)


def test_termblit_rejects_mismatched_grids(grids):
    chars, rgb = grids
    with pytest.raises(ValueError):
        TTB.TermBlitter(5, 20).encode(chars, rgb)


def test_termblit_leaves_native_untouched(grids, monkeypatch, tmp_path):
    """On a copy of native/ whose library is older than its source (the
    case in which JAX's binding rebuilds the library in place, and a
    checkout's file times are arbitrary), making a port TermBlitter writes
    nothing there: bytes and times unchanged, the library loaded as it
    is. Where the library does not load, the port builds
    native/termblit.cpp into its own build directory and encodes the same
    bytes."""
    chars, rgb = grids
    nat = tmp_path / "native"
    shutil.copytree(NATIVE, nat)
    t = os.path.getmtime(nat / "termblit.cpp")
    os.utime(nat / "libtermblit.so", (t - 100, t - 100))
    monkeypatch.setattr(TTB, "_SRC", str(nat / "termblit.cpp"))
    monkeypatch.setattr(TTB, "_LIB_PATH", str(nat / "libtermblit.so"))
    monkeypatch.setattr(TTB, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(TTB, "_BUILT_PATH",
                        str(tmp_path / "build" / "libtermblit.so"))
    before = _files(nat)
    tb = TTB.TermBlitter(6, 20)
    want = tb.encode(chars, rgb)
    assert tb.native and not (tmp_path / "build").exists()
    assert _files(nat) == before
    bad = tmp_path / "bad.so"
    bad.write_bytes(b"not a library")
    monkeypatch.setattr(TTB, "_LIB_PATH", str(bad))
    tb = TTB.TermBlitter(6, 20)
    assert tb.native and (tmp_path / "build" / "libtermblit.so").is_file()
    assert tb.encode(chars, rgb) == want
    assert _files(nat) == before


# ---------------------------------------------------------------------------
# live modes through a pty
# ---------------------------------------------------------------------------
def _pty_session(argv, script, limit_s):
    """Run the port's CLI on a pty and play ``script``: for each (data,
    until, pause_s) write data (if any), read the output until ``until``
    appears in it (if given), then read on for pause_s. The process is
    killed at limit_s. Returns (rc, output, stderr)."""
    master, slave = pty.openpty()
    env = dict(os.environ, PYTHONPATH=REPO, TERM="xterm")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ascii_renderer_tpu_torch.app.cli", *argv],
        stdin=slave, stdout=slave, stderr=subprocess.PIPE, env=env, cwd=REPO)
    os.close(slave)
    out = b""

    def pump(wait):
        nonlocal out
        if select.select([master], [], [], wait)[0]:
            try:
                out += os.read(master, 65536)
            except OSError:
                return False
        return True

    deadline = time.time() + limit_s
    try:
        for data, until, pause in script:
            if data:
                os.write(master, data)
            while (until and until not in out and proc.poll() is None
                   and time.time() < deadline and pump(0.2)):
                pass
            t_end = time.time() + pause
            while time.time() < t_end and pump(0.05):
                pass
        while proc.poll() is None and time.time() < deadline and pump(0.2):
            pass
        while pump(0.2) and select.select([master], [], [], 0)[0]:
            pass
    finally:
        os.close(master)
        if proc.poll() is None:
            proc.kill()
        rc = proc.wait(timeout=30)
    return rc, out, proc.stderr.read().decode()


def test_term_mode_mouse_look_and_clean_exit():
    """--mode term (raster, CPU) on a pty: the loop switches mouse
    tracking on, takes held keys and SGR mouse motion, quits on q within
    its time limit, restores the terminal and reports its FrameStats."""
    rc, out, err = _pty_session(
        ["--mode", "term", "--backend", "raster", *GRID, "--fps", "60",
         "--device", "cpu"],
        [(None, b"\x1b[?1003h", 0.0), (b"w", b"\x1b[38;2;", 0.2),
         (b"\x1b[<35;10;5M", None, 0.2), (b"\x1b[<35;14;6M", None, 0.3),
         (b"q", None, 0.0)], limit_s=120)
    assert rc == 0, err[-2000:]
    assert b"\x1b[?1003h" in out and b"\x1b[38;2;" in out
    assert b"\x1b[?1003l" in out and b"\x1b[?1049l" in out
    line = [x for x in err.splitlines() if x.startswith("[termblit")]
    assert line and "native=True" in line[-1] and "'frames'" in line[-1]


def test_interactive_mode_runs_and_quits():
    """--mode interactive (curses, raster, CPU) on a pty: draws frames
    (the border's pi digits) and quits on q."""
    rc, out, err = _pty_session(
        ["--mode", "interactive", "--backend", "raster", *GRID, "--device",
         "cpu"], [(b"w", b"3141592653", 0.2), (b"q", None, 0.0)],
        limit_s=120)
    assert rc == 0, err[-2000:]
    assert b"3141592653" in out
