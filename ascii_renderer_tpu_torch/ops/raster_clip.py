"""The small and mid raster paths' near-plane clip and screen setup (X4):
the CUDA kernel of ``csrc/raster_clip.cu`` and its plain version, and
its table form, which also writes the shading-plane table (X3's work) in
the same launch.

Stands for XLA code, not a Pallas kernel: ``transform_clip_channels``,
``transform_clip_channels9``, ``_clip_channels_core`` and
``setup_screen_channels`` of ``ascii_renderer_tpu/backends/
raster_channels.py`` (:31, :63, :76, :139), which XLA fuses into each
frame's program. On CUDA tensors the plain version is some 235 launches
(about 60 of them ``fma32``); ``clip_screen`` is one launch, a thread an
output triangle, that writes every channel of the same dict.
``clip_screen_table`` is one launch for the dict and the [2T + 1, 32]
plane table of the attributes normals, colors and positions (A = 9): the
uncompacted path's clip, setup and table, whose plain version is
``clip_screen_ref`` followed by ``ops/plane_table.plane_table_ref``.
``clip_screen_slots`` is one launch for the dict and the attribute slots
of the [2T] outputs (``clip_attrs_channel_lists``: normals, colors and
positions rotated and lerped as the clip moved each vertex, A = 9): the
fused-shading path's clip, whose plain version is ``clip_screen_ref``
followed by ``ops/plane_table.clip_attrs_channel_lists``.

The plain version is the chain the backend ran before, moved here
(``backends/raster_channels`` re-exports it): the vertex transform, the
clip into up to two triangles a slot (``_clip_channels_core``) and the
screen setup (``setup_screen_channels``). Each product the reference's
compiled program fuses is an ``fma32`` there and an ``fmaf`` in the
kernel, in the same order (core/fp.py).
"""

from __future__ import annotations

import ctypes

import torch

from ascii_renderer_tpu_torch.core.fp import fma32
from ascii_renderer_tpu_torch.ops import _build

launches = 0  # kernel launches by clip_screen and its two other forms
launches_table = 0  # kernel launches by clip_screen_table
launches_slots = 0  # kernel launches by clip_screen_slots
# kernels a call launches
LAUNCHES_PER_CALL = {"clip_screen": 1, "clip_screen_table": 1,
                     "clip_screen_slots": 1}
TABLE_ATTRS = 9  # the table and slots forms' attributes: normals, colors,
# positions
TABLE_WIDTH = 32  # the table's columns: 3 (A + 1) padded to 8

# the kernel's float output [len(FLOAT_KEYS), 2T], row by row in this order
CLIP_KEYS = tuple(f"{c}{s}" for c in "xyzw" for s in "abc")
SCREEN_KEYS = tuple(f"{c}{s}" for s in "abc" for c in ("sx", "sy", "sz",
                                                        "iw"))
FLOAT_KEYS = CLIP_KEYS + SCREEN_KEYS + ("area2",)


def _recip_guard(x: torch.Tensor, eps: float) -> torch.Tensor:
    """1 / where(|x| < eps, eps, x)."""
    return torch.reciprocal(torch.where(x.abs() < eps, eps, x))


def _lerp(c0, c1, t):
    # c0 + t * (c1 - c0): the product fuses into the add
    return fma32(t, c1 - c0, c0)


def _slots(src: torch.Tensor, pos9: bool, what: str,
           rows: int = len(FLOAT_KEYS)) -> int:
    """The triangle slots T of ``src`` (pos9 [9, T] or positions [3T, 3],
    float32) whose [rows, 2T] output the kernel indexes, or ValueError."""
    if src.dtype != torch.float32:
        raise ValueError(f"{what}: expected float32, got {src.dtype}")
    if pos9:
        if src.dim() != 2 or src.shape[0] != 9:
            raise ValueError(f"{what}: pos9 must be [9, T], got "
                             f"{tuple(src.shape)}")
        T = src.shape[1]
    else:
        if src.dim() != 2 or src.shape[1] != 3 or src.shape[0] % 3:
            raise ValueError(f"{what}: positions must be [3T, 3], got "
                             f"{tuple(src.shape)}")
        T = src.shape[0] // 3
    if 2 * T * rows >= 2 ** 31:
        raise ValueError(f"{what}: {T} triangle slots, too many")
    return T


def _clip_buffers(T: int, dev, extra: int = 0):
    """The kernel's outputs: fb [25 + extra, 2T], valid [2T], tr [3, T],
    ir [2, T]."""
    return (torch.empty((len(FLOAT_KEYS) + extra, 2 * T),
                        dtype=torch.float32, device=dev),
            torch.empty(2 * T, dtype=torch.bool, device=dev),
            torch.empty((3, T), dtype=torch.float32, device=dev),
            torch.empty((2, T), dtype=torch.int32, device=dev))


def _mvp16(mvp: torch.Tensor):
    """The matrix's 16 host floats, row-major, for the launch."""
    return (ctypes.c_float * 16)(*mvp.reshape(16).tolist())


def clip_screen(src: torch.Tensor, mvp: torch.Tensor, rows: int, cols: int,
                *, pos9: bool = False) -> dict:
    """setup_screen_channels(transform_clip_channels(src, mvp)) (with
    ``pos9``: transform_clip_channels9, src the [9, T] geometry): the [2T]
    clipped-triangle channel dict. On the CPU the plain version; on a CUDA
    device one launch, whose dict holds row views of one [25, 2T] float
    buffer beside ``valid`` and the [T] records."""
    if src.device.type == "cpu":
        return clip_screen_ref(src, mvp, rows, cols, pos9=pos9)
    global launches
    T = _slots(src, pos9, "clip_screen")
    _build.require_cuda(src, what="clip_screen")
    fb, valid, tr, ir = _clip_buffers(T, src.device)
    err = _build.lib().raster_clip_launch(
        src.data_ptr(), int(pos9), _mvp16(mvp), 0.5 * cols, 0.5 * rows,
        fb.data_ptr(), valid.data_ptr(), tr.data_ptr(), ir.data_ptr(), T,
        _build.stream_ptr(src.device))
    launches += 1
    _build.check(err, "raster_clip_launch")
    return _channel_dict(fb, valid, tr, ir)


def clip_screen_table(src: torch.Tensor, normals: torch.Tensor,
                      colors: torch.Tensor, mvp: torch.Tensor, rows: int,
                      cols: int, *, pos9: bool = False):
    """``clip_screen`` and the plane table of its [2T] slots: (the channel
    dict, the table f32 [2T + 1, 32] of the attributes normals, colors and
    positions, A = 9, with its zero background row). ``normals`` and
    ``colors`` are f32 [3T, 3]; the positions are ``src`` (with ``pos9``
    its [9, T] rows). On the CPU the plain version; on a CUDA device one
    launch."""
    if src.device.type == "cpu":
        return clip_screen_table_ref(src, normals, colors, mvp, rows, cols,
                                     pos9=pos9)
    global launches, launches_table
    T = _slots(src, pos9, "clip_screen_table")
    _check_attrs(normals, colors, T, "clip_screen_table")
    _build.require_cuda(src, normals, colors, what="clip_screen_table")
    dev = src.device
    fb, valid, tr, ir = _clip_buffers(T, dev)
    table = torch.empty((2 * T + 1, TABLE_WIDTH), dtype=torch.float32,
                        device=dev)
    err = _build.lib().raster_clip_table_launch(
        src.data_ptr(), int(pos9), _mvp16(mvp), 0.5 * cols, 0.5 * rows,
        normals.data_ptr(), colors.data_ptr(), fb.data_ptr(),
        valid.data_ptr(), tr.data_ptr(), ir.data_ptr(), table.data_ptr(), T,
        _build.stream_ptr(dev))
    launches += 1
    launches_table += 1
    _build.check(err, "raster_clip_table_launch")
    return _channel_dict(fb, valid, tr, ir), table


def _check_attrs(normals, colors, T: int, what: str):
    """normals and colors must be f32 [3T, 3], else ValueError."""
    for a in (normals, colors):
        if a.shape != (3 * T, 3) or a.dtype != torch.float32:
            raise ValueError(f"{what}: normals and colors must be float32 "
                             f"[{3 * T}, 3], got {tuple(a.shape)} {a.dtype}")


def clip_screen_slots(src: torch.Tensor, normals: torch.Tensor,
                      colors: torch.Tensor, mvp: torch.Tensor, rows: int,
                      cols: int, *, pos9: bool = False):
    """``clip_screen`` and the attribute slots of its [2T] outputs: (the
    channel dict, 3 lists, one a vertex slot, of the 9 channels [2T] of
    the attributes normals, colors and positions), as
    ``clip_attrs_channel_lists([normals, colors, positions], dict)``.
    ``normals`` and ``colors`` are f32 [3T, 3]; the positions are ``src``
    (with ``pos9`` its [9, T] rows). On the CPU the plain version; on a
    CUDA device one launch, whose dict and lists hold row views of one
    [25 + 27, 2T] float buffer."""
    if src.device.type == "cpu":
        return clip_screen_slots_ref(src, normals, colors, mvp, rows, cols,
                                     pos9=pos9)
    global launches, launches_slots
    n_a = 3 * TABLE_ATTRS
    T = _slots(src, pos9, "clip_screen_slots", len(FLOAT_KEYS) + n_a)
    _check_attrs(normals, colors, T, "clip_screen_slots")
    _build.require_cuda(src, normals, colors, what="clip_screen_slots")
    dev = src.device
    fb, valid, tr, ir = _clip_buffers(T, dev, n_a)
    err = _build.lib().raster_clip_slots_launch(
        src.data_ptr(), int(pos9), _mvp16(mvp), 0.5 * cols, 0.5 * rows,
        normals.data_ptr(), colors.data_ptr(), fb.data_ptr(),
        valid.data_ptr(), tr.data_ptr(), ir.data_ptr(), T,
        _build.stream_ptr(dev))
    launches += 1
    launches_slots += 1
    _build.check(err, "raster_clip_slots_launch")
    n = len(FLOAT_KEYS)
    return _channel_dict(fb[:n], valid, tr, ir), [
        list(fb[n + TABLE_ATTRS * s:n + TABLE_ATTRS * (s + 1)])
        for s in range(3)]


def _channel_dict(fb, valid, tr, ir) -> dict:
    """The kernel's outputs as the plain version's dict, keys in its
    order: row views of fb [25, 2T] (FLOAT_KEYS), valid [2T], the records
    rot / n_in (rows of ir [2, T]) and t_ab / t_ac / t_bc (rows of tr)."""
    rows_of = dict(zip(FLOAT_KEYS, fb))
    out = {k: rows_of[k] for k in CLIP_KEYS}
    out["valid"] = valid
    out["rot"] = ir[0]
    out["t_ab"], out["t_ac"], out["t_bc"] = tr[0], tr[1], tr[2]
    out["n_in"] = ir[1]
    out.update((k, rows_of[k]) for k in SCREEN_KEYS + ("area2",))
    return out


def clip_screen_ref(src, mvp, rows: int, cols: int, *, pos9: bool = False):
    """The plain version of ``clip_screen``."""
    ch = (transform_clip_channels9(src, mvp) if pos9
          else transform_clip_channels(src, mvp))
    return setup_screen_channels(ch, rows, cols)


def pos9_to_positions(pos9: torch.Tensor) -> torch.Tensor:
    """Channel-major pos9 f32 [9, T] -> soup positions f32 [3T, 3] (an
    exact copy)."""
    T = pos9.shape[1]
    return pos9.reshape(3, 3, T).permute(2, 0, 1).reshape(3 * T, 3)


def clip_screen_table_ref(src, normals, colors, mvp, rows: int, cols: int,
                          *, pos9: bool = False):
    """The plain version of ``clip_screen_table``: ``clip_screen_ref``,
    then ``plane_table_ref`` of the uncompacted dict over the attributes
    [normals, colors, positions]."""
    from ascii_renderer_tpu_torch.ops.plane_table import plane_table_ref
    ch = clip_screen_ref(src, mvp, rows, cols, pos9=pos9)
    positions = pos9_to_positions(src) if pos9 else src
    attrs = torch.cat([normals, colors, positions], dim=1)
    return ch, plane_table_ref(ch, ch, attrs)


def clip_screen_slots_ref(src, normals, colors, mvp, rows: int, cols: int,
                          *, pos9: bool = False):
    """The plain version of ``clip_screen_slots``: ``clip_screen_ref``,
    then ``clip_attrs_channel_lists`` of the uncompacted dict over the
    attributes [normals, colors, positions]."""
    from ascii_renderer_tpu_torch.ops.plane_table import (
        clip_attrs_channel_lists)
    ch = clip_screen_ref(src, mvp, rows, cols, pos9=pos9)
    positions = pos9_to_positions(src) if pos9 else src
    attrs = torch.cat([normals, colors, positions], dim=1)
    return ch, clip_attrs_channel_lists(attrs, ch)


def transform_clip_channels(positions: torch.Tensor, mvp: torch.Tensor):
    """Channel-major vertex stage: positions f32 [V=3T, 3] -> dict of
    [2T]-shaped per-component tensors for the near-clipped triangles (see
    ``_clip_channels_core``). The reference's vertex transform is a K = 4
    dot, which its compiler sums pairwise without fusing: (x m0 + y m1) +
    (z m2 + m3)."""
    V = positions.shape[0]
    T = V // 3
    m = mvp.tolist()  # host floats: the matrix is the host's
    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]
    clip = [(x * m[j][0] + y * m[j][1]) + (z * m[j][2] + m[j][3])
            for j in range(4)]
    cv = torch.stack(clip, dim=-1).reshape(T, 12).t()
    ch = {f"{c}{s}": cv[4 * i + j]
          for i, s in enumerate("abc")
          for j, c in enumerate("xyzw")}
    return _clip_channels_core(ch)


def transform_clip_channels9(pos9: torch.Tensor, mvp: torch.Tensor):
    """transform_clip_channels on pre-transposed geometry pos9 f32 [9, T]
    (rows xa ya za xb yb zb xc yc zc): four-term chains per channel."""
    m = mvp.tolist()
    ch = {}
    for i, s in enumerate("abc"):
        px, py, pz = pos9[3 * i], pos9[3 * i + 1], pos9[3 * i + 2]
        for j, c in enumerate("xyzw"):
            # (m0 px + m1 py) + m2 pz fuse (core/fp.py), then + m3
            ch[f"{c}{s}"] = fma32(m[j][2], pz,
                                  fma32(m[j][0], px, m[j][1] * py)) + m[j][3]
    return _clip_channels_core(ch)


def _clip_channels_core(ch):
    """Shared near-clip channel math: per-slot clip channels x/y/z/w{a,b,c}
    [T] -> the [2T] clipped-triangle channel dict: x/y/z/w per output vertex
    slot ('xa' .. 'wc'), 'valid' bool, and the lerp records 'rot', 't_ab',
    't_ac', 't_bc', 'n_in' [T] for the attributes."""
    d = {s: ch[f"z{s}"] + ch[f"w{s}"] for s in "abc"}
    ins = {s: d[s] >= 0.0 for s in "abc"}
    n_in = (ins["a"].to(torch.int32) + ins["b"].to(torch.int32)
            + ins["c"].to(torch.int32))

    # rotation r in {0,1,2}: 1-in -> first inside vertex first;
    # 2-in -> outside vertex last (as transform_clip)
    first_in = torch.where(ins["a"], 0, torch.where(ins["b"], 1, 2))
    first_out = torch.where(~ins["a"], 0, torch.where(~ins["b"], 1, 2))
    rot = torch.where(n_in == 1, first_in,
                      torch.where(n_in == 2, (first_out + 1) % 3, 0)).to(
        torch.int32)

    def rot_sel(ca, cb, cc):
        return torch.where(rot == 0, ca, torch.where(rot == 1, cb, cc))

    names = "abc"
    rch, rd = {}, {}
    for k, s in enumerate("abc"):
        # rotated slot s takes original slot (rot + k) % 3
        srcs = [names[(i + k) % 3] for i in range(3)]
        for c in "xyzw":
            rch[f"{c}{s}"] = rot_sel(*(ch[f"{c}{q}"] for q in srcs))
        rd[s] = rot_sel(*(d[q] for q in srcs))

    def ratio(p, q):
        return p / torch.where(p == q, 1.0, p - q)

    ta = ratio(rd["a"], rd["b"])  # a->b
    tc = ratio(rd["a"], rd["c"])  # a->c
    tb = ratio(rd["b"], rd["c"])  # b->c

    one_in = n_in == 1
    two_in = n_in == 2
    out = {}
    for c in "xyzw":
        a0, b0, c0 = rch[f"{c}a"], rch[f"{c}b"], rch[f"{c}c"]
        ab = _lerp(a0, b0, ta)
        ac = _lerp(a0, c0, tc)
        bc = _lerp(b0, c0, tb)
        # tri1: 3-in (a,b,c); 1-in (a, ab, ac); 2-in (a, b, bc)
        t1b = torch.where(one_in, ab, b0)
        t1c = torch.where(one_in, ac, torch.where(two_in, bc, c0))
        # tri2 (only 2-in): (a, bc, ac)
        out[f"{c}a"] = torch.cat([a0, a0])
        out[f"{c}b"] = torch.cat([t1b, bc])
        out[f"{c}c"] = torch.cat([t1c, ac])
    out["valid"] = torch.cat([n_in >= 1, two_in])
    out["rot"] = rot
    out["t_ab"], out["t_ac"], out["t_bc"] = ta, tc, tb
    out["n_in"] = n_in
    return out


def setup_screen_channels(ch, rows: int, cols: int):
    """Channel-major screen setup: adds screen-space sx/sy/sz and iw per
    slot, 'area2' and the facing/degenerate cull to ``ch`` (in place) and
    returns it. Front faces have NEGATIVE y-down area (raster.js:100-102)."""
    # the compiler folds "* 0.5 * cols" into one product by 0.5 * cols
    hx, hy = 0.5 * cols, 0.5 * rows
    ux, uy = {}, {}
    for s in "abc":
        inv_w = _recip_guard(ch[f"w{s}"], 1e-9)
        # (x*inv_w + 1) * 0.5 * cols: the product fuses into the add
        ux[s] = fma32(ch[f"x{s}"], inv_w, 1.0)
        ch[f"sx{s}"] = ux[s] * hx
        # (1 - y*inv_w): the product fuses into the subtract
        uy[s] = fma32(-ch[f"y{s}"], inv_w, 1.0)
        ch[f"sy{s}"] = uy[s] * hy
        ch[f"sz{s}"] = fma32(ch[f"z{s}"], inv_w, 1.0) * 0.5
        ch[f"iw{s}"] = inv_w
    # edges, with each vertex's scale product inlined: the single-use
    # product of the minuend fuses into the subtract (vertex a's is shared)
    e0x = fma32(ux["b"], hx, -ch["sxa"])
    e0y = fma32(uy["b"], hy, -ch["sya"])
    e1x = fma32(ux["c"], hx, -ch["sxa"])
    e1y = fma32(uy["c"], hy, -ch["sya"])
    area2 = fma32(e0x, e1y, -(e0y * e1x))  # a*b - c*d: the left fuses
    ch["valid"] = ch["valid"] & (area2 < 0.0) & (area2.abs() > 1e-12)
    ch["area2"] = area2
    return ch
