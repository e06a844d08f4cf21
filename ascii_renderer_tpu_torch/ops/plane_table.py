"""The small and mid raster paths' shading-plane table (X3): the CUDA
kernel of ``csrc/plane_table.cu`` and its plain version.

Stands for XLA code, not a Pallas kernel: ``clip_attrs_channel_lists``,
``clip_attrs_compact_lists`` and ``build_plane_table`` (with its edge
coefficients) of ``ascii_renderer_tpu/backends/raster_channels.py``
(:426, :364, :481), which XLA fuses into each frame's program; at a length
that is a multiple of 512 the reference packs the table with its Pallas
kernel (B7, ``ops/pack``). On CUDA tensors the plain version is some 180
launches (about 70 of them ``fma32``) and the pack; ``plane_table`` is one
launch, a thread a row (its gathers loaded before the arithmetic), that
writes the table with its trailing all-zero background row. The
compacted
callers take it; the uncompacted table of ``render_soup``'s binned walk
comes from X4's table form (``ops/raster_clip.clip_screen_table``), in
the clip's launch.

The plain version is the chain the backend ran before, moved here
(``backends/raster_channels`` re-exports it): the clip's rotation and
lerps applied to the attributes (``_attr_slots``), then the planes
(``plane_channels``), stacked and padded or packed (``build_plane_table``).
Each product the reference's compiled program fuses is an ``fma32`` there
and an ``fmaf`` in the kernel, in the same order (core/fp.py).
"""

from __future__ import annotations

import ctypes

import torch

from ascii_renderer_tpu_torch.core.fp import fma32
from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.ops.pack import pack_channels
from ascii_renderer_tpu_torch.ops.raster_clip import _lerp, _recip_guard

launches = 0  # kernel launches by plane_table
LAUNCHES_PER_CALL = {"plane_table": 1}  # kernels a call launches
ATTRS = (6, 9)  # the kernel's attribute counts (9: world-position planes)
# the screen channels a table row reads, in the kernel's order
SCREEN_KEYS = ("sxa", "sxb", "sxc", "sya", "syb", "syc", "iwa", "iwb", "iwc",
               "area2")
RECORD_KEYS = ("rot", "n_in", "t_ab", "t_ac", "t_bc")


def table_width(n_attrs: int) -> int:
    """Columns of a table row: 3 (A + 1) planes padded to 8."""
    return -(-3 * (n_attrs + 1) // 8) * 8


def plane_table(ch, rec, attrs: torch.Tensor, cidx=None) -> torch.Tensor:
    """The shading-plane table of N clipped triangles with one trailing
    all-zero background row: f32 [N + 1, W] (W = 3 (A + 1) padded to 8).
    ``ch`` holds the rows' screen channels (each [N]); ``rec`` the clip
    records rot / n_in / t_ab / t_ac / t_bc of the T source slots (each
    [T]; the uncompacted [2T] dict itself, N = 2T); attrs f32 [3T, A] the
    per-vertex attributes; ``cidx`` [N] i32 the compacted rows' [2T] ids
    (None: row n is slot n). On the CPU the plain version; on a CUDA
    device one launch."""
    if attrs.device.type == "cpu":
        return plane_table_ref(ch, rec, attrs, cidx)
    global launches
    T3, A = attrs.shape
    N = ch["sxa"].shape[0]
    T = rec["rot"].shape[0]
    if A not in ATTRS or T3 != 3 * T or attrs.dtype != torch.float32:
        raise ValueError(f"plane_table: attrs {tuple(attrs.shape)} "
                         f"{attrs.dtype}: expected float32 [3T, A], T = {T}, "
                         f"A in {ATTRS}")
    if (cidx is None and N != 2 * T) or (cidx is not None and (
            tuple(cidx.shape) != (N,) or cidx.dtype != torch.int32)):
        raise ValueError(f"plane_table: {N} rows of {T} slots, cidx "
                         f"{None if cidx is None else tuple(cidx.shape)}")
    if (N + 1) * table_width(A) >= 2 ** 31:
        raise ValueError(f"plane_table: {N} rows, too many")
    screen = [ch[k] for k in SCREEN_KEYS]
    recs = [rec[k] for k in RECORD_KEYS]
    attrs = attrs.contiguous()
    _build.require_cuda(attrs, *recs, *([] if cidx is None else [cidx]),
                        what="plane_table")
    for t in screen:
        if t.device != attrs.device or t.dim() != 1 or t.shape[0] != N or \
                t.dtype != torch.float32:
            raise ValueError(f"plane_table: screen channels must be float32 "
                             f"[{N}] on {attrs.device}")
    if [r.dtype for r in recs] != [torch.int32] * 2 + [torch.float32] * 3 \
            or any(r.shape != (T,) for r in recs):
        raise ValueError("plane_table: records must be int32 rot / n_in and "
                         f"float32 t_ab / t_ac / t_bc, each [{T}]")
    out = torch.empty((N + 1, table_width(A)), dtype=torch.float32,
                      device=attrs.device)
    scr = (ctypes.c_longlong * 20)(*(t.data_ptr() for t in screen),
                                   *(t.stride(0) for t in screen))
    err = _build.lib().plane_table_launch(
        scr, None if cidx is None else cidx.data_ptr(),
        *(r.data_ptr() for r in recs), attrs.data_ptr(), out.data_ptr(), N,
        T, A, _build.stream_ptr(attrs.device))
    launches += 1
    _build.check(err, "plane_table_launch")
    return out


def plane_table_ref(ch, rec, attrs: torch.Tensor, cidx=None):
    """The plain version of ``plane_table``: the attribute slots
    (``clip_attrs_channel_lists``, or ``clip_attrs_compact_lists`` at
    ``cidx``), ``build_plane_table``, then the zero row."""
    slots = (clip_attrs_channel_lists(attrs, rec) if cidx is None
             else clip_attrs_compact_lists(attrs, rec, cidx))
    table = build_plane_table(ch, slots)
    return torch.cat([table, table.new_zeros((1, table.shape[1]))])


def _attr_slots(ai, A: int, rot, ta, tc, tb, one_in, two_in, second):
    """Rotation + clip lerps of per-vertex attribute channels ai [3A, N]
    (vertex-major). ``second``: the slot holds the second clip output
    (None: emit both outputs, [2N] channels)."""
    out_slots = [[], [], []]
    for j in range(A):
        base = [ai[0 * A + j], ai[1 * A + j], ai[2 * A + j]]
        r = [torch.where(rot == 0, base[k % 3],
                         torch.where(rot == 1, base[(1 + k) % 3],
                                     base[(2 + k) % 3])) for k in range(3)]
        ab = _lerp(r[0], r[1], ta)
        ac = _lerp(r[0], r[2], tc)
        bc = _lerp(r[1], r[2], tb)
        t1b = torch.where(one_in, ab, r[1])
        t1c = torch.where(one_in, ac, torch.where(two_in, bc, r[2]))
        if second is None:
            out_slots[0].append(torch.cat([r[0], r[0]]))
            out_slots[1].append(torch.cat([t1b, bc]))
            out_slots[2].append(torch.cat([t1c, ac]))
        else:  # tri1 and tri2 share vertex a
            out_slots[0].append(r[0])
            out_slots[1].append(torch.where(second, bc, t1b))
            out_slots[2].append(torch.where(second, ac, t1c))
    return out_slots


def clip_attrs_channel_lists(attrs: torch.Tensor, ch):
    """Apply the clip rotation + lerp recorded by transform_clip_channels to
    per-vertex attributes: attrs f32 [V=3T, A] -> 3 lists (one per output
    vertex slot) of A channels, each [2T]."""
    V, A = attrs.shape
    ai = attrs.reshape(V // 3, 3 * A).t()
    n_in = ch["n_in"]
    return _attr_slots(ai, A, ch["rot"], ch["t_ab"], ch["t_ac"], ch["t_bc"],
                       n_in == 1, n_in == 2, None)


def clip_attrs_compact_lists(attrs: torch.Tensor, ch, cidx: torch.Tensor):
    """clip_attrs_channel_lists evaluated only at the compacted slots:
    cidx [v_cap] holds original [2T] ids (o < T: first clip output of
    triangle o; o >= T: the second). Returns 3 slot lists of A channels,
    each [v_cap]."""
    V, A = attrs.shape
    T = V // 3
    src = torch.where(cidx < 2 * T, cidx % T, 0).long()
    ai = attrs.reshape(T, 3 * A)[src].t()  # [3A, v_cap]
    n_in = ch["n_in"][src]
    return _attr_slots(ai, A, ch["rot"][src], ch["t_ab"][src],
                       ch["t_ac"][src], ch["t_bc"][src], n_in == 1,
                       n_in == 2, cidx >= T)


def _edge_coeffs(sx, sy):
    """Edge-plane coefficients w_k = alpha_k px + beta_k py + gamma_k."""
    alpha, beta, gamma = [], [], []
    for k in range(3):
        x1, y1 = sx[(k + 1) % 3], sy[(k + 1) % 3]
        x2, y2 = sx[(k + 2) % 3], sy[(k + 2) % 3]
        alpha.append(-(y2 - y1))
        beta.append(x2 - x1)
        # (y2 - y1) x1 - (x2 - x1) y1: the left product fuses
        gamma.append(fma32(y2 - y1, x1, -((x2 - x1) * y1)))
    return alpha, beta, gamma


def _sum3(p, q):
    """p0 q0 + p1 q1 + p2 q2 as the reference fuses it (core/fp.py)."""
    return fma32(p[2], q[2], fma32(p[0], q[0], p[1] * q[1]))


def plane_channels(ch, attr_slots):
    """The shading planes as 3*(A+1) channels, each [N]: A attribute
    planes (numerators) + the perspective denominator, 3 coeffs each.
    A = 9 (nx ny nz cr cg cb wx wy wz), or 6 without point lights."""
    A = len(attr_slots[0])
    sx = [ch[f"sx{s}"] for s in "abc"]
    sy = [ch[f"sy{s}"] for s in "abc"]
    iw = [ch[f"iw{s}"] for s in "abc"]
    alpha, beta, gamma = _edge_coeffs(sx, sy)
    inv_area = _recip_guard(ch["area2"], 1e-12)
    ai = [alpha[k] * iw[k] for k in range(3)]
    bi = [beta[k] * iw[k] for k in range(3)]
    gi = [gamma[k] * iw[k] for k in range(3)]
    chans = []
    for j in range(A):
        av = [attr_slots[k][j] for k in range(3)]
        chans += [_sum3(ai, av) * inv_area, _sum3(bi, av) * inv_area,
                  _sum3(gi, av) * inv_area]
    # the denominator plane: sum_k coef_k iw_k, fused as the reference's
    # compiled table fuses it (for alpha the second product fuses first)
    chans += [fma32(alpha[2], iw[2], fma32(alpha[1], iw[1], ai[0])) * inv_area,
              fma32(beta[2], iw[2], fma32(beta[0], iw[0], bi[1])) * inv_area,
              fma32(gamma[2], iw[2], fma32(gamma[0], iw[0], gi[1])) * inv_area]
    return chans


def build_plane_table(ch, attr_slots) -> torch.Tensor:
    """Per-triangle shading-plane table [N, 3*(A+1) padded to 8] of
    plane_channels. At a length that is a multiple of 512 it is packed by
    ops/pack (kernel B7 on CUDA), as the reference does."""
    chans = plane_channels(ch, attr_slots)
    n = chans[0].shape[0]
    if n % 512 == 0:
        return pack_channels(chans)
    table = torch.stack(chans, dim=-1)
    pad = (-table.shape[1]) % 8
    if pad:
        table = torch.cat([table, table.new_zeros((n, pad))], dim=-1)
    return table
