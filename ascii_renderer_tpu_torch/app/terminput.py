"""Terminal input state machine for --mode term (a copy of
``ascii_renderer_tpu/app/terminput.py``; stdlib only).

Parses the raw byte stream of a cbreak TTY (plain keys, CSI arrow keys,
SGR mouse reports) into per-frame camera inputs, and owns the
SELECTION-PAUSE state machine — the terminal analog of the reference's
pointer-lock escape hatch (js/text_overlay.js:188-238: leaving pointer
lock lets the user select/copy the DOM text mirror). In a terminal the
renderer's redraw and the mouse-tracking mode both fight native
selection, so:

  - pressing ``p`` PAUSES: the frame freezes and the caller must disable
    mouse reporting (TermInput emits a "pause" transition; run_term
    writes ``ESC[?1006l ESC[?1003l``) — the terminal's own click-drag
    selection and copy then work on the frozen glyph frame;
  - pressing any plain key RESUMES (a "resume" transition re-enables
    mouse reporting). The resume keypress is consumed — it neither
    quits nor moves the camera, so ``q`` is safe to use as the wake key.

Pure state machine over bytes — no TTY, select() or side effects — so
the pause/resume/parse logic is unit-testable (tests/test_torch_app.py).
"""

from __future__ import annotations

KEYMAP = {"w": "w", "a": "a", "s": "s", "d": "d", " ": " "}
ARROWS = {"A": "arrowup", "B": "arrowdown", "C": "arrowright",
          "D": "arrowleft"}
_MAX_SEQ = 16  # longest CSI we ever parse (SGR mouse "[<btn;x;yM")


class TermInput:
    """Feed raw bytes; read per-frame fields between reset_frame() calls.

    Frame fields (cleared by reset_frame):
      keys         set[str] — held movement keys this frame
      mdx, mdy     float — accumulated mouse-look deltas (cells * scale)
      clicks       list[(x, y)] — left-click cell coords (0-based)
      transitions  list["pause"|"resume"] — mode edges, in order
    Session fields (persistent):
      quit         bool — q / Ctrl-C seen (outside pause)
      paused       bool — selection pause active
    """

    def __init__(self, mouse_scale: float = 8.0):
        self.mouse_scale = mouse_scale
        self.quit = False
        self.paused = False
        self._esc: str | None = None  # accumulating CSI body, None = idle
        self._mouse_at: tuple[int, int] | None = None
        self.reset_frame()

    def reset_frame(self):
        self.keys = set()
        self.mdx = 0.0
        self.mdy = 0.0
        self.clicks = []
        self.transitions = []

    def feed(self, data: bytes):
        for ch in data.decode(errors="ignore"):
            self._feed1(ch)

    # -- internals ---------------------------------------------------------
    def _feed1(self, ch: str):
        if self._esc is not None:
            self._esc += ch
            seq = self._esc
            if seq and seq[0] != "[":  # not a CSI (bare ESC + key) — drop
                self._esc = None
            elif len(seq) >= 2 and (ch.isalpha() or ch == "~"):
                self._esc = None
                self._handle_csi(seq)
            elif len(seq) > _MAX_SEQ:  # malformed — resync
                self._esc = None
            return
        if ch == "\x1b":
            self._esc = ""
            return
        if self.paused:
            # any plain key wakes; the keypress itself is consumed
            self.paused = False
            self.transitions.append("resume")
            self._mouse_at = None  # stale anchor would jerk the camera
            return
        if ch in ("q", "\x03"):
            self.quit = True
        elif ch == "p":
            self.paused = True
            self.transitions.append("pause")
        else:
            k = KEYMAP.get(ch)
            if k:
                self.keys.add(k)

    def _handle_csi(self, seq: str):
        if self.paused:
            return  # late mouse reports after the disable write: ignore
        if len(seq) == 2 and seq[1] in ARROWS:
            self.keys.add(ARROWS[seq[1]])
            return
        if seq.startswith("[<") and seq[-1] in "Mm":  # SGR mouse event
            try:
                b, mx, my = (int(v) for v in seq[2:-1].split(";"))
            except ValueError:
                return
            if b & 3 == 0 and seq[-1] == "M" and not b & 32:
                # left press -> click ripple at the (0-based) cell
                self.clicks.append((mx - 1, my - 1))
            if self._mouse_at is not None:
                self.mdx += (mx - self._mouse_at[0]) * self.mouse_scale
                self.mdy += (my - self._mouse_at[1]) * self.mouse_scale
            self._mouse_at = (mx, my)
