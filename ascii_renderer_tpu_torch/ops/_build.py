"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

On first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process,
all started together, and the objects are linked into ONE shared library
with a plain C interface, which is loaded with ``ctypes``. No PyTorch
headers are included, so the build takes about a minute (the longest
sources, rt_trace.cu's and rt_trace_trig.cu's 48 template instances each,
~55 s side by side), and it needs no ``ninja``. The library's name
carries a hash of the sources and flags, so an edited source never loads
a stale build. The build directory is ``ops/build`` (listed in
``.gitignore``).

Flags: ``sm_90a`` (Hopper), ``-fmad=false`` so that only the kernels'
explicit ``fmaf`` calls fuse a product into an add (the kernels fuse exactly
where the reference does, core/fp.py, and must equal their plain-torch
versions bit for bit: one stray contraction moves near-edge winners), and
NO ``--use_fast_math``: division and sqrt stay IEEE (``-prec-div=true``,
``-prec-sqrt=true`` are nvcc's defaults).

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception. ``-Xptxas -v`` makes
each compile report its kernels' registers, spills and shared memory; the
build keeps that report beside the library (``ptxas_report``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_FP = ctypes.POINTER(ctypes.c_float)
_LL = ctypes.c_longlong
_LLP = ctypes.POINTER(ctypes.c_longlong)
_IP = ctypes.POINTER(ctypes.c_int)
# C signatures of the entry points in csrc/*.cu (all return cudaError_t).
SIGNATURES = {
    # (pos9, attrs_t, mvp16_host, out, T, Tp, A, rows, cols, stream)
    "setup2dh_launch": (_P, _P, _FP, _P, _I, _I, _I, _I, _I, _P),
    # (pos9, attrs_t, mvp16_host, bbox, src16, table, T, Tp, A, tw, rows,
    #  cols, stream)
    "setup2dh_packed_launch": (_P, _P, _FP, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _P),
    # (cm, out, C, N, ld, a, b, stream)
    "pack_span_launch": (_P, _P, _I, _I, _LL, _I, _I, _P),
    # (rows128, rowptr, gdepth, gskip, xl, yl, z, e, part, n_slots, r_cap,
    #  grp_cap, stream)
    "walk_grouped_skip_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _P),
    # (rows128, rowptr, gdepth, xl, yl, z, e, part, n_slots, r_cap,
    #  grp_cap, stream)
    "walk_grouped_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # (rows256, rowptr, gdepth, gskip, xl, yl, z, e, part, n_slots, r_cap2,
    #  grp_cap, stream)
    "walk_grouped_k2_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _P),
    # (src_pair, goff, gdepth, gchunks, xl, yl, z, e, part, rowptr, n_slots,
    #  p_max, grp_cap, stream)
    "walk_direct_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                           _I, _P),
    # (params, prim, n_entries, n_sph, ro, rd, uid, block_active, seed,
    #  atlas, atlas_w, atlas_h, lor, log, lob, ov, fet, n_rays, bounces,
    #  nee, next_ray, stream)
    "pt_trace_launch": (_P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _I, _I,
                        _P, _P, _P, _P, _P, _I, _I, _I, _P, _P),
    # (light8_host, origin3_host, prim, n_entries, n_sph, rd, pix_uid, pc,
    #  npix, uid0, block_active, seed, atlas, atlas_w, atlas_h, lor, log,
    #  lob, ov, fet, n_rays, bounces, nee, next_ray, stream)
    "pt_trace_frame_launch": (_FP, _FP, _P, _I, _I, _P, _P, _I, _I, _I, _P,
                              _I, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I,
                              _I, _P, _P),
    # (a, b, c, sa, sb, sc, scalar_mask, geom24_host, flat, out, n, stream)
    "fma32_launch": (_P, _P, _P, _F, _F, _F, _I, _LLP, _I, _P, _LL, _P),
    # (table, row_stride, table_rows, vec, ids, ids_f32, px, py,
    #  geom12_host, n_attrs, env_color, env_intensity, n_dl, dl_dir, dl_col,
    #  n_pt, pt_pos, pt_col, n_pl, out, n, stream)
    "raster_shade_launch": (_P, _LL, _I, _I, _P, _I, _P, _P, _LLP, _I, _P,
                            _P, _P, _P, _P, _P, _P, _P, _I, _P, _LL, _P),
    # (table, row_stride, table_rows, vec, e, ginv, n_slots, n_bins,
    #  tiles_x, y_off, rows, cols, n_attrs, env_color, env_intensity, n_dl,
    #  dl_dir, dl_col, n_pt, pt_pos, pt_col, n_pl, out, stream)
    "raster_shade_image_launch": (_P, _LL, _I, _I, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _I, _P, _P),
    # (cam, rd3, grid_views, grid_one12_host, basis, rows, cols, row_lo,
    #  sx, sy, aspect, out, views, rays, sph_pos, sph_rad, sph_valid,
    #  sph_mat, n_sph, pln_n, pln_d, pln_valid, pln_mat, n_pln, tri_a,
    #  tri_e1, tri_e2, tri_valid, tri_mat, n_tri, mat_albedo,
    #  mat_reflective, dl_dir, dl_col, n_dl, pt_pos, pt_col, n_pt, pair,
    #  env_color, env_intensity, fuse_p, fuse_s, lanes, stage, stream)
    "rt_trace_launch": (_P, _P, _P, _FP, _I, _I, _I, _I, _F, _F, _F, _P, _I,
                        _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P,
                        _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I,
                        _P, _P, _I, _I, _I, _I, _P),
    # (n_rays): the lanes a ray a launch of n_rays takes by its own choice
    "rt_trace_lanes": (_LL,),
    # (lanes, n_sph, n_pln, n_tri): whether a launch of that many lanes a
    # ray stages such a scene's slots
    "rt_trace_staged": (_I, _I, _I, _I),
    # (src, pos9, mvp16_host, hx, hy, ch, valid, t_rec, i_rec, T, stream)
    "raster_clip_launch": (_P, _I, _FP, _F, _F, _P, _P, _P, _P, _I, _P),
    # (src, pos9, mvp16_host, hx, hy, normals, colors, ch, valid, t_rec,
    #  i_rec, T, stream)
    "raster_clip_slots_launch": (_P, _I, _FP, _F, _F, _P, _P, _P, _P, _P,
                                 _P, _I, _P),
    # (src, pos9, mvp16_host, hx, hy, normals, colors, ch, valid, t_rec,
    #  i_rec, table, T, stream)
    "raster_clip_table_launch": (_P, _I, _FP, _F, _F, _P, _P, _P, _P, _P,
                                 _P, _P, _I, _P),
    # (screen20_host, cidx, rot, n_in, t_ab, t_ac, t_bc, attrs, table, N, T,
    #  A, stream)
    "plane_table_launch": (_LLP, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _P),
    # (screen20_host, ws13_host, layout, T, rows, cols, tile_window,
    #  big_cap, ty_lo, band, src, offsets, counts, data, keys, n_out, mm,
    #  form, tickets, stream)
    "bin_entries_launch": (_LLP, _LLP, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                           _P, _P, _P, _P, _LL, _I, _I, _P, _P),
    # (src32, src_stride, keys, P, offsets, p_eff, n_bins, tiles_x, k,
    #  rows256, r_cap, grp_cap, y_off, ws, rows, rowptr, gdepth, gskip, xl,
    #  yl, gbins, counts, ginv, stream)
    "group_build_launch": (_P, _LL, _P, _LL, _P, _I, _I, _I, _I, _I, _I, _I,
                           _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    # (flags, n, chans26_host, v_cap, out, cidx, valid, count, part,
    #  nparts, stream)
    "partition_channels_launch": (_P, _I, _LLP, _I, _P, _P, _P, _P, _P, _I,
                                  _P),
    # (flags, n, uid0, samples, ray_block, slot, pix_uid, gate1, nb1, gates,
    #  nbs, zero, nzero, count, part, nparts, stream)
    "partition_order_launch": (_P, _I, _I, _I, _I, _P, _P, _P, _I, _P, _I,
                               _P, _I, _P, _P, _I, _P),
    # (channels): blocks of the co-resident form the device holds at once
    "partition_coop_capacity": (_I,),
    # (count, mean, m2, mean_y, m2_y, alpha, sample, sample_alpha, o_count,
    #  o_mean, o_m2, o_mean_y, o_m2_y, display, o_alpha, act, skip, any_set,
    #  any_clear, n, reset, tol, max_samples, perceptual, stream)
    "accum_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _P, _P, _P, _P, _P, _LL, _I, _F, _F, _I, _P),
    # (tv, tc, rgb, stats, V, T, rows, cols, sigma, gamma, bg0, bg1, bg2,
    #  stream)
    "soft_raster_fwd_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                               _F, _F, _P),
    # (tv, tc, rgb, stats, grad, g_tv, g_tc, V, T, rows, cols, sigma,
    #  gamma, stream)
    "soft_raster_bwd_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _F, _F, _P),
    # (rgb, target, grad, losses, V, hw, p0, np, L, tau, glyph_weight,
    #  third, hi, stream)
    "soft_loss_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F,
                         _P),
    # (px, py, out, n, basis9_host, stream)
    "ray_grid_launch": (_P, _P, _P, _I, _FP, _P),
    # (pix_uid, fet0, out, pc, samples, per, n_out, rows, cols, uid0,
    #  aspect, s0, key_x, key_y, jitter, basis9_host, stream)
    "pt_rays_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _U,
                       _U, _I, _FP, _P),
    # (cr, cg, cb, ovf, tf, tov, pc, n_valid, first, resolve, tile, lor0,
    #  log0, lob0, ov0f, inv_spp, slot, rgb, a, stream)
    "pt_reduce_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                         _P, _P, _F, _P, _P, _P, _P),
    # (bases, out, rows, cols, views, sx, sy, aspect, stream)
    "ray_grid_jit_launch": (_P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _P),
    # (idx, ovr, out, V, H, W, radius, thresh, cells_per_thread, stream)
    "modal_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # (idx, rgb, alpha, chars, codes, n_codes, V, H, W, mode_on, radius,
    #  thresh, cells_per_thread, stream)
    "glyph_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                     _P),
    # (rgb, alpha, ui_chars, ui_mask, rgb_out, a_out, n, W, row_stride,
    #  ui_vals_host, pi, stream)
    "frame_bytes_launch": (_P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _IP, _P,
                           _P),
    # (data, offsets, z, tid, part, n_slots, n_tiles, tiles_x, n_entries,
    #  mm, stream)
    "bins_walk_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # (data, offsets, light, rgb, part, n_slots, n_tiles, tiles_x,
    #  n_entries, stream)
    "shaded_walk_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # (rows, rowptr, depth, z, e, part, n_slots, n_tiles, tiles_x, r_cap,
    #  source, stream)
    "subtile_walk_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH.
    Raises RuntimeError when there is none: the port never runs without
    its kernels on a CUDA device."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels of ascii_renderer_tpu_torch/ops/csrc cannot "
        "be built")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into the build directory (if that exact build
    is not there yet) and return the library's path."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out = BUILD_DIR / f"libascii_kernels_{_digest(srcs)}.so"
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, p.stem + ".o") for p in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", o, str(p)]
                for p, o in zip(srcs, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [p.communicate()[0] for p in procs]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        with open(os.path.join(tmp, "ptxas.txt"), "w") as f:
            f.write("".join(logs))
        so = os.path.join(tmp, out.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(os.path.join(tmp, "ptxas.txt"),
                   out.with_suffix(".ptxas.txt"))
        os.replace(so, out)
    return out


def ptxas_report() -> list[str]:
    """One line per kernel of the current build, from nvcc's ``-Xptxas
    -v`` output: its name, registers, stack frame, spill stores / loads,
    shared memory."""
    log = build().with_suffix(".ptxas.txt").read_text()
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            spill = (f"stack frame {m.group(1)} B, spill stores "
                     f"{m.group(2)} B, loads {m.group(3)} B")
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{_demangle(name)}: {m.group(1)} registers, "
                       f"{spill}, {smem.group(1) if smem else 0} B static "
                       f"smem")
            name, spill = None, ""
    return out


def _demangle(name: str) -> str:
    """The kernel's name and template arguments, from its mangled symbol
    (``c++filt`` where there is one; else the mangled symbol)."""
    c = shutil.which("c++filt")
    if c is None:
        return name
    res = subprocess.run([c, name], capture_output=True, text=True)
    m = re.search(r"(\w+(?:<[^>]*>)?)\(", res.stdout)
    return m.group(1) if m else name


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, args in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def require_device(*tensors, what: str) -> None:
    """Every tensor must be a CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: expected CUDA tensors on one device, "
                             f"got {t.device}")


def require_cuda(*tensors, what: str) -> None:
    """Every tensor must be a contiguous CUDA tensor on one device."""
    require_device(*tensors, what=what)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous tensors")
