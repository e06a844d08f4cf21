"""Timed forms of X13, the stable partition (``ops/partition``), on one
card: both forms, as shipped and in builds of ``ops/csrc/partition.cu``
with other values of the constants the source leaves open
(``tools/build_variants``' way):

- ``PTN_COUNT_ALL=0``: the co-resident launch (the blocks' counts, a
  grid.sync(), the places) at every size, where the shipped build counts
  all the flags in every block of an ordinary launch up to 32,768;
- ``PTN_ROWS=64`` / ``256``: the count-all channels form's out rows a
  block (shipped: 128);
- ``PTN_ROWS_THREADS=256`` / ``1024``: the count-all channels form's
  blocks of 256 or 1,024 threads (shipped: 512);
- ``PTN_ROUNDS=8``: tiles of 2,048 flags, a warp's 8 ballots (shipped:
  1,024 and 4), but for the co-resident order form's;
- ``PTN_ORDER_ROUNDS=4`` / ``16``: the co-resident order form's tiles of
  1,024 or 4,096 flags (shipped: 2,048, so that its grid needs half the
  blocks at its barrier).

The calls: the channels form at the teapot's, the mid-scale HD arm's and
the subtile golden call's ``compact_valid_ch`` inputs, the order form at
the progressive tracer's masks at 96x36 and 960x540 and all / none / one
pixel active (``chip_smoke._partition_chan_calls``, ``_partition_masks``;
the progressive 960x540 mask also with two ray counters zeroed in the
launch, as a compacted frame's set-up calls it), and both forms on
seeded flags at 1, 1,024, 32,768, 32,769 and 2^19 -
4,096 flags (the channels form at v_cap n, the order form at 8 samples).
At each call every output is held to the plain version bit for bit first,
then device ms by the profiler's kernel rows over 50 back-to-back calls
(``chip_smoke._device_ms``, one row a call). Then block 0 of the
count-all channels kernel (the teapot's and the mid HD arm's calls) and
of the co-resident kernel (``subtile``'s, the progressive 960x540 mask)
is split by phase: a build with ``tools/csrc/stamps.cuh`` prepended has
its thread 0 write ``clock64()`` after each phase (and the global timer
at its ends, which turns cycles into microseconds); the median of 50
calls a phase. The table goes to stdout,
one JSON line last. Run from the repo root on a machine with one NVIDIA
GPU (~2 minutes with the builds):

    python3 -m ascii_renderer_tpu_torch.tools.partition_variants
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import statistics
import subprocess

from ascii_renderer_tpu_torch.tools.build_variants import (build_variant,
                                                           launching_from)
from ascii_renderer_tpu_torch.tools.kernel_ab import _chip_smoke, _mid_preps

# name: (defines, the wrapper's COUNT_ALL for the build)
VARIANTS = {"co-resident at every size": (("-DPTN_COUNT_ALL=0",), 0),
            "64 rows a block": (("-DPTN_ROWS=64",), None),
            "256 rows a block": (("-DPTN_ROWS=256",), None),
            "count-all channels blocks of 256 threads": (
                ("-DPTN_ROWS_THREADS=256",), None),
            "count-all channels blocks of 1,024 threads": (
                ("-DPTN_ROWS_THREADS=1024",), None),
            "tiles of 2,048 flags": (("-DPTN_ROUNDS=8",), None),
            "co-resident order tiles of 1,024 flags": (
                ("-DPTN_ORDER_ROUNDS=4",), None),
            "co-resident order tiles of 4,096 flags": (
                ("-DPTN_ORDER_ROUNDS=16",), None)}
# the stamped builds split by phase
PHASE_BUILDS = {"shipped": ()}
SIZES = (1, 1024, 32768, 32769, (1 << 19) - 4096)


def calls(cs, dev):
    """{label: (form, args, kwargs)}: the driven calls (the progressive
    960x540 mask also with the frame's 2 ray counters zeroed in the
    launch, as _FrameRays calls it) and the seeded sizes."""
    import torch
    from ascii_renderer_tpu_torch.tools.xla_inputs import (
        partition_channels, partition_mask)
    soup, scene = cs._bunny(), cs._scene(dev)
    caps = {"subtile": cs._oracle_caps(dev, soup, scene, "subtile")[0]}
    out = {}
    for label, (ch, v_cap) in cs._partition_chan_calls(
            dev, soup, scene, caps, _mid_preps(cs, dev)).items():
        n = ch["valid"].shape[0]
        out[f"channels, {label} ({n} flags, v_cap {v_cap})"] = (
            "channels", (dict(ch), v_cap), {})
    for label, (act, uid0, samples) in cs._partition_masks(dev).items():
        flags = act.reshape(-1)
        out[f"order, {label} ({flags.numel()} flags)"] = (
            "order", (flags, uid0, samples), {})
        if label == f"progressive {cs.COLS}x{cs.ROWS}":
            zero = torch.ones(2, dtype=torch.int32, device=dev)
            out[f"order, {label} ({flags.numel()} flags), zeroing 2 "
                f"counters"] = ("order", (flags, uid0, samples),
                                {"zero": zero})
    for n in SIZES:
        ch = {k: torch.from_numpy(v).to(dev)
              for k, v in partition_channels(n, 0.5, seed=n).items()}
        out[f"channels, {n} flags, v_cap {n}"] = ("channels", (ch, n), {})
        flags = torch.from_numpy(partition_mask(n, 0.4, seed=n)).to(dev)
        out[f"order, {n} flags, 8 samples"] = ("order", (flags, 0, 8), {})
    return out


def _outputs(form, got):
    import torch
    if form == "channels":
        cch, cidx, count = got
        return [*(cch[k] for k in cch if k != "valid"),
                cch["valid"].to(torch.int32), cidx, count.reshape(1)]
    slot, uid, gates = got
    return [slot, uid, *(gates[s] for s in sorted(gates))]


@contextlib.contextmanager
def _count_all(PTN, count_all):
    """The wrapper's COUNT_ALL as a variant build has it."""
    saved = PTN.COUNT_ALL
    if count_all is not None:
        PTN.COUNT_ALL = count_all
    try:
        yield
    finally:
        PTN.COUNT_ALL = saved


def run(cs, dev, cases):
    """{call: {form: device ms}} of the shipped build and each variant at
    each of ``cases`` (``calls``)."""
    import torch
    from ascii_renderer_tpu_torch.ops import partition as PTN
    entries = {"channels": "partition_channels_launch",
               "order": "partition_order_launch"}
    wrappers = {"channels": PTN.compact_channels, "order": PTN.stable_order}
    plains = {"channels": PTN.compact_channels_ref,
              "order": PTN.stable_order_ref}
    libs = {name: {form: build_variant("partition.cu", entry, defines)
                   for form, entry in entries.items()}
            for name, (defines, _c) in VARIANTS.items()}
    table = {}
    for label, (form, args, kw) in cases.items():
        want = _outputs(form, plains[form](*args, **kw))
        row = {}
        forms = [("shipped", None, None)] + [
            (name, libs[name][form], VARIANTS[name][1]) for name in VARIANTS]
        for name, lib, count_all in forms:
            def fn(lib=lib, count_all=count_all):
                with _count_all(PTN, count_all):
                    if lib is None:
                        return wrappers[form](*args, **kw)
                    with launching_from(lib):
                        return wrappers[form](*args, **kw)
            if "zero" in kw:
                kw["zero"].fill_(1)
            got = _outputs(form, fn())
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                cs._same_bits(g, w, f"X13 {label} {name}")
            if "zero" in kw:
                assert kw["zero"].tolist() == [0, 0], (label, name)
            row[name] = cs._device_ms(fn, "partition_", 1)
        table[label] = row
        print(f"X13 {label}: " + "; ".join(
            f"{k} {v:.5f} ms" for k, v in row.items()), flush=True)
    return table


# block 0's phases, between consecutive stamps, by kernel
PHASES = {
    "channels": ("count loads, warp sums", "barrier, ranks, staging",
                 "barrier", "gather and stores", "count store"),
    "co-resident": ("ballots, counts, block sum", "count store",
                    "grid.sync()", "counts read, block sums",
                    "places (channels: grid.sync(), gather)")}
PHASE_CALLS = {"channels, teapot": "channels",
               "channels, mid-scale": "channels",
               "channels, subtile": "co-resident",
               "order, progressive 960x540": "co-resident"}


def phases(cases, n=50):
    """{call: {phase: median us}} of block 0 at PHASE_CALLS' calls of
    ``cases``, from a stamped build (clock64 at the start and after each
    phase, the global timer at the block's ends)."""
    import torch
    from ascii_renderer_tpu_torch.ops import _build
    from ascii_renderer_tpu_torch.ops import partition as PTN
    entries = {"channels": "partition_channels_launch",
               "order": "partition_order_launch"}
    wrappers = {"channels": PTN.compact_channels, "order": PTN.stable_order}
    out = {}
    for build, defines in PHASE_BUILDS.items():
        libs = {form: build_variant("partition.cu", entry, defines,
                                    stamps=True)
                for form, entry in entries.items()}
        for label, (form, args, kw) in cases.items():
            kernel = next((k for pre, k in PHASE_CALLS.items()
                           if label.startswith(pre)), None)
            if kernel is None or "zeroing" in label:
                continue
            names = PHASES[kernel]
            per = {nm: [] for nm in (*names, "block 0")}
            buf = (ctypes.c_longlong * 8)()
            for _ in range(n):
                with launching_from(libs[form]):
                    wrappers[form](*args, **kw)
                torch.cuda.synchronize()
                _build.check(libs[form].stamps_read(buf), "stamps")
                st = list(buf)
                ns_per_cycle = (st[7] - st[6]) / max(1, st[5] - st[0])
                for i, nm in enumerate(names):
                    per[nm].append((st[i + 1] - st[i]) * ns_per_cycle / 1e3)
                per["block 0"].append((st[7] - st[6]) / 1e3)
            key = f"{label}, {build}"
            out[key] = {nm: statistics.median(v) for nm, v in per.items()}
            print(f"X13 {key}, block 0 by phase (us): " + "; ".join(
                f"{k} {v:.3f}" for k, v in out[key].items()), flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("partition_variants: CUDA is not available")
    cs = _chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda:0")
    from ascii_renderer_tpu_torch.ops import _build
    from ascii_renderer_tpu_torch.ops import partition as PTN
    _build.lib()
    print(f"co-resident grid: {PTN.coop_blocks(True)} blocks (channels), "
          f"{PTN.coop_blocks(False)} (order)", flush=True)
    cases = calls(cs, dev)
    out = {"device": torch.cuda.get_device_name(0),
           "ms": run(cs, dev, cases), "phases_us": phases(cases)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
