"""The stable partition of a flag vector (X13): the CUDA kernel of
``csrc/partition.cu`` and its plain versions, in two forms.

- The channels form (``compact_channels``): the raster's order-preserving
  compaction of the valid clipped triangles to a static ``v_cap``, the
  13 screen channels gathered into a row-major [v_cap, 13] block whose
  columns the compacted dict views, the source ids ``cidx`` (fill n),
  ``valid`` and the count ``n_valid``; the triangles past ``v_cap`` are
  dropped.
- The order form (``stable_order``): the path tracer's compacted stream,
  the active pixels first and then the rest, each in pixel order
  (``slot``), the slots' global uids (``pix_uid``) and the megakernel's
  1,024-ray block gates of a stream of 1 and of ``samples`` samples.

Stands for XLA code, not a Pallas kernel: ``compact_valid_ch``
(``ascii_renderer_tpu/backends/raster_channels.py:325``: the sort of the
unique key ``where(valid, i, n + i)``, a stack and one wide row gather)
and the compacted stream of ``render_pt``
(``ascii_renderer_tpu/backends/pathtrace.py:524-531``: the ``lax.sort``
of the unique key ``(1 - active) * pc + i``, the active count and the
block gates). Each sorts unique keys, so its order is the stable
partition: flag i, if set, at the number of set flags before it; if not,
at n_set plus the number of unset flags before it.

The plain versions (``*_ref``) are the torch chains the backends ran
before, moved here: on the CPU they are the route, on the card the
tests' yardstick. A CUDA tensor always takes the kernel, one launch a
call at every size: up to ``COUNT_ALL`` flags an ordinary launch whose
every block counts all the flags, above one cooperative launch on a grid
the card holds at once; a failed build or launch raises, and so does a
cooperative launch the card cannot hold.
"""

from __future__ import annotations

import ctypes

import torch

from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.ops import pt_kernel as PK

launches = 0        # calls that launched X13 (both forms)
launches_order = 0  # of them, the order form's
COUNT_ALL = 32768   # flags up to which every block counts all (csrc)
ROWS = 128          # out rows a count-all channels block (csrc kRows)
ROWS_THREADS = 512  # its threads (csrc kRowsThreads)
THREADS = 256       # threads a block of the other kernels (csrc kThreads)
TILE = 4 * THREADS  # flags a tile (csrc kTile)
ORDER_TILE = 2 * TILE  # the co-resident order form's (csrc kOrderRounds)
FILL = 8 * THREADS  # out floats a co-resident channels block (csrc)
RAY_BLOCK = PK.BLOCK  # rays a block gate covers (1,024)
# the compacted screen channels, in the row's order
COMPACT_KEYS = ("sxa", "sxb", "sxc", "sya", "syb", "syc",
                "sza", "szb", "szc", "iwa", "iwb", "iwc", "area2")


def launches_of(n: int) -> int:
    """Kernels a call over n flags launches: one at every size."""
    return 1


def coop_blocks(channels: bool) -> int:
    """Blocks of the co-resident form (the channels form's, or the order
    form's) the current CUDA device holds at once: the largest grid of a
    call above COUNT_ALL flags."""
    cap = _build.lib().partition_coop_capacity(int(channels))
    _build.check(max(0, -cap), "partition_coop_capacity")
    return cap


def _scratch(n: int, blocks: int, dev):
    """The blocks' counts of a co-resident call (n above COUNT_ALL): at
    least max(tiles, blocks) ints (tiles of TILE flags, the smallest any
    form takes), blocks the grid the call's other work asks for; None for
    a count-all call."""
    if n <= COUNT_ALL:
        return None
    return torch.empty(max(-(-n // TILE), blocks), dtype=torch.int32,
                       device=dev)


def _flags(flags: torch.Tensor, what: str) -> torch.Tensor:
    if flags.dtype != torch.bool or flags.dim() != 1:
        raise ValueError(f"{what}: flags must be a 1-D bool tensor, got "
                         f"{flags.dtype} {tuple(flags.shape)}")
    if not 1 <= flags.shape[0] < 2 ** 31:
        raise ValueError(f"{what}: {flags.shape[0]} flags (1 to 2^31 - 1)")
    _build.require_cuda(flags, what=what)
    return flags


def compact_channels_ref(ch, v_cap: int):
    """The plain version of ``compact_channels``: one sort of the unique
    key where(valid, i, n + i), the 13 channels stacked with a zero row
    and gathered by the kept ids."""
    valid = ch["valid"]
    dev = valid.device
    n2t = valid.shape[0]
    n_valid = valid.sum(dtype=torch.int32)
    ids = torch.arange(n2t, dtype=torch.int32, device=dev)
    skey = torch.sort(torch.where(valid, ids, n2t + ids)).values
    if v_cap > n2t:  # [T]-domain callers may pass caps sized for [2T]
        skey = torch.cat([skey, skey.new_full((v_cap - n2t,), n2t)])
    cidx = torch.where(skey[:v_cap] < n2t, skey[:v_cap], n2t)
    packed = torch.stack([ch[k] for k in COMPACT_KEYS], dim=-1)
    packed = torch.cat([packed, packed.new_zeros((1, len(COMPACT_KEYS)))])
    g = packed[cidx.long()].t()  # one wide row gather, then unpack
    cch = {k: g[i] for i, k in enumerate(COMPACT_KEYS)}
    cch["valid"] = cidx < n2t
    return cch, cidx, n_valid


def compact_channels(ch, v_cap: int):
    """Order-preserving compaction of the valid slots of the channel dict
    ``ch`` (``ch["valid"]`` bool [n], the COMPACT_KEYS float32 [n]) to a
    static [v_cap]: (cch, cidx, n_valid). cch holds the COMPACT_KEYS as
    columns of one row-major [v_cap, 13] block (slots past the kept ones
    zeros) and ``valid``; cidx i32 [v_cap] the slot's source id (fill n);
    n_valid the 0-d i32 count of valid slots, those past v_cap included
    (they are dropped). On the CPU the plain version; on a CUDA device X13's
    channels form, reading the channels in place by pointer and stride
    (X4's row views), one launch, no host sync."""
    valid = ch["valid"]
    if valid.device.type == "cpu":
        return compact_channels_ref(ch, v_cap)
    global launches
    n = valid.shape[0]
    flags = _flags(valid, "compact_channels")
    if not 1 <= v_cap or v_cap * len(COMPACT_KEYS) >= 2 ** 31:
        raise ValueError(f"compact_channels: v_cap {v_cap}")
    chans = [ch[k] for k in COMPACT_KEYS]
    for c in chans:
        if c.dtype != torch.float32 or c.dim() != 1 or c.shape[0] != n:
            raise ValueError(f"compact_channels: channels must be float32 "
                             f"[{n}]")
    _build.require_device(flags, *chans, what="compact_channels")
    dev = flags.device
    out = torch.empty((v_cap, len(COMPACT_KEYS)), dtype=torch.float32,
                      device=dev)
    ints = torch.empty(v_cap + 1, dtype=torch.int32, device=dev)
    cidx, count = ints[:v_cap], ints[v_cap]
    cvalid = torch.empty(v_cap, dtype=torch.bool, device=dev)
    part = _scratch(n, -(-v_cap * len(COMPACT_KEYS) // FILL), dev)
    c26 = (ctypes.c_longlong * 26)(*(c.data_ptr() for c in chans),
                                   *(c.stride(0) for c in chans))
    err = _build.lib().partition_channels_launch(
        flags.data_ptr(), n, c26, v_cap, out.data_ptr(), cidx.data_ptr(),
        cvalid.data_ptr(), count.data_ptr(),
        None if part is None else part.data_ptr(),
        0 if part is None else part.numel(), _build.stream_ptr(dev))
    launches += 1
    _build.check(err, "partition_channels_launch")
    cch = dict(zip(COMPACT_KEYS, out.unbind(1)))
    cch["valid"] = cvalid
    return cch, cidx, count


def block_gate(live: torch.Tensor) -> torch.Tensor:
    """int32 [nblk]: whether each RAY_BLOCK-ray block of the flat ray mask
    ``live`` holds a live ray (the pad rays are not)."""
    n = live.numel()
    pad = -n % RAY_BLOCK
    act = live.to(torch.int32)
    if pad:
        act = torch.cat([act, act.new_zeros(pad)])
    return act.reshape(-1, RAY_BLOCK).amax(dim=1)


def stable_order_ref(active: torch.Tensor, uid0: int, samples: int, *,
                     zero: torch.Tensor | None = None):
    """The plain version of ``stable_order``: one argsort of the unique key
    (1 - active) * n + i, the count, the mask of live slots repeated for
    each stream and its block gates; ``zero`` zeroed."""
    if zero is not None:
        zero.zero_()
    act = active.reshape(-1).to(torch.int64)
    pc = act.numel()
    local = torch.arange(pc, device=act.device)
    slot = torch.argsort((1 - act) * pc + local).to(torch.int32)
    # the actives hold slots [0, n_act); ray s * pc + p is live where slot
    # p is (the pad rays are not)
    mask = local < act.sum()
    return slot, slot + uid0, {s: block_gate(mask.repeat(s))
                               for s in {1, samples}}


def stable_order(active: torch.Tensor, uid0: int, samples: int, *,
                 zero: torch.Tensor | None = None):
    """The compacted stream of the pixel mask ``active`` (bool, any shape,
    flattened: n pixels): (slot i32 [n], the pixel of each stream slot,
    the active ones first, each part in pixel order; pix_uid = slot + uid0;
    {1: gates, samples: gates}, the RAY_BLOCK-ray block gates i32 of a
    stream of 1 and of ``samples`` samples, ray s * n + p live where slot
    p holds an active pixel). ``zero``: an int32 buffer on the same device
    (a frame's ray counters) that the call also zeroes. On the CPU the
    plain version; on a CUDA device X13's order form, one launch (the
    zeroing in it), no host sync."""
    flags = active.reshape(-1)
    if flags.device.type == "cpu":
        return stable_order_ref(active, uid0, samples, zero=zero)
    global launches, launches_order
    flags = _flags(flags, "stable_order")
    n = flags.shape[0]
    if samples < 1 or n * samples >= 2 ** 31:
        raise ValueError(f"stable_order: {samples} samples of {n} pixels")
    if zero is not None:
        if zero.dtype != torch.int32:
            raise ValueError(f"stable_order: zero must be int32, got "
                             f"{zero.dtype}")
        _build.require_cuda(flags, zero, what="stable_order")
    dev = flags.device
    nb1 = -(-n // RAY_BLOCK)
    nbs = 0 if samples == 1 else -(-(samples * n) // RAY_BLOCK)
    ints = torch.empty(2 * n + nb1 + nbs + 1, dtype=torch.int32, device=dev)
    slot, pix_uid = ints[:n], ints[n:2 * n]
    gate1, gates = ints[2 * n:2 * n + nb1], ints[2 * n + nb1:-1]
    part = _scratch(n, -(-(nb1 + nbs) // THREADS), dev)
    err = _build.lib().partition_order_launch(
        flags.data_ptr(), n, uid0, samples, RAY_BLOCK, slot.data_ptr(),
        pix_uid.data_ptr(), gate1.data_ptr(), nb1,
        gates.data_ptr() if nbs else None, nbs,
        None if zero is None else zero.data_ptr(),
        0 if zero is None else zero.numel(), ints[-1].data_ptr(),
        None if part is None else part.data_ptr(),
        0 if part is None else part.numel(), _build.stream_ptr(dev))
    launches += 1
    launches_order += 1
    _build.check(err, "partition_order_launch")
    return slot, pix_uid, {1: gate1, samples: gates if nbs else gate1}
