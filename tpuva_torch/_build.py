"""Build and bind the port's CUDA kernels (``tpuva_torch/csrc/*.cu``).

nvcc compiles each source into an object file, all of them at once in
parallel processes, and links them into one shared library with a plain C
interface, loaded with ctypes: no ``torch/extension.h``, so a build takes
seconds rather than minutes. It happens at the first kernel call (or an
explicit ``build()``), never on import. The library lands in
``build/tpuva_torch/`` at the repository root (git-ignored), named by a
hash of the sources, the generated headers and the flags, and is built
under a file lock so that concurrent processes build it once. Generated
headers (``generated_headers``: K7's selection networks, written by
``ops/median.py::network_header``) go into ``build/tpuva_torch/gen/``,
on nvcc's include path, before it runs.

Flags: ``--fmad=false`` keeps nvcc from contracting ``a*b + c`` into an
FMA (the kernels also use ``__fmul_rn``/``__fadd_rn`` where rounding is
pinned); fast math is never used. A call from device code to a host-only
function fails the build (nvcc drops the kernel's body otherwise). If
nvcc is missing the build raises.

The host step (``build_host``/``load_host``) compiles ``csrc/batcher.cpp``,
the staging ring, with the host C++ compiler (``$CXX``, else g++) into a
library of its own in the same directory, under the same lock, named by a
hash of the source, compiler and flags. It needs no nvcc and no card, so
the CPU tests build and run it; it too runs at first use, never on import.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "tpuva_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Werror", "cross-execution-space-call", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong

# C signatures of the entry points in csrc/*.cu
_SIGNATURES = {
    "tpuva_fused_segment": [
        _P, _I,  # frames (a host array of S pointers), S
        _P, _P, _P,  # bg0, masks, bg_out
        _I, _I, _I,  # N, H, W
        _F, _F, _F,  # c1, a, thr
        _P, _I, _I,  # taps, ntaps, shift
        _I,  # median
        _P, _P, _P,  # stage_k, stage_iters, stage_se
        _I, _P,  # seed_bg, seed (S flags on the card, or null)
        _I, _I, _I,  # emit_diff, tile_h, tile_w
        _I, _I, _P,  # Hp, Wp, occ (padded_occ; H, W, null otherwise)
        _P,  # stream
    ],
    "tpuva_fused_segment_occupancy": [
        _I, _I, _I, _I, _I,  # ntaps, median, Rm, tile_h, tile_w
        _P, _P,  # smem_bytes, blocks_per_sm (int32 out)
    ],
    "tpuva_ccl_stats": [
        _P, _I, _I, _I, _I, _I, _I,  # mask, N, Hm, Wm, H, W, C
        _P, _P, _P, _P,  # strip_occ (null: derived), fine, bits, parent
        _P, _P, _P, _P, _P,  # list, nlist, rc, table, sums
        _P, _P, _P, _P, _P,  # count, area, centroid, centroid_sum, overflow
        _P, _P,  # phase_ns (may be null), stream
    ],
    "tpuva_ccl_stats_grid": [
        _P, _P,  # blocks_per_sm, sms (int32 out)
    ],
    "tpuva_ccl_labels": [
        _P, _I, _I, _I, _I,  # mask, N, H, W, connectivity
        _P, _P, _P, _P,  # strip_occ, seg (4-connected), tiles, ntiles
        _P, _P, _P,  # parent, bits (8-connected), labels
        _P,  # stream
    ],
    "tpuva_band_labels": [
        _P, _LL, _I, _I, _I,  # mask (the band's first row), frame stride, N, Hb, W
        _I, _I, _I,  # r0, kbase, sent
        _P, _P, _P, _P, _P,  # strip_occ, tiles, ntiles, parent, bits
        _P, _P, _P, _P,  # labels, val, roots, nroots
        _P,  # stream
    ],
    # KB-recon and KB-table (csrc/spatial.cu); the band: N, Hb, W, r0, y0, kbase, sent
    "tpuva_kb_edges": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "tpuva_kb_recon_min": [
        _P, _P, _P,  # lab, val, edges
        _P, _LL, _P, _LL,  # above, its frame stride, below, its frame stride
        _I, _I, _I, _I, _I, _I, _I,  # the band
        _P, _P,  # flag, stream
    ],
    "tpuva_kb_table": [
        _P, _P, _P,  # val, roots, nroots
        _I, _I, _I, _I, _I, _I, _I,  # the band
        _I, _P, _P,  # C, scratch, table
        _P,  # stream
    ],
    "tpuva_kb_sums": [
        _P, _P, _P,  # lab, val, strip_occ
        _I, _I, _I, _I, _I, _I, _I,  # the band
        _P, _I, _P,  # table, C, sums
        _P,  # stream
    ],
    "tpuva_root_stats": [
        _P, _I, _I, _I, _I, _I,  # root, N, H, W, connectivity, C
        _P,  # strip_occ (null: derived)
        _P, _P, _P, _P, _P,  # scratch: docc, rcs, list, lrc, loff
        _P, _P, _P,  # scratch past shared memory: table, sums, extremes
        _P, _P, _P, _P,  # count, sums, lohi, labels
        _P, _P, _P, _P, _P, _P,  # the stats dict: area, centroid, csum, overflow, bbox; zero
        _I,  # with_bbox
        _P,  # stream
    ],
    "tpuva_histogram_u8": [
        _P, _I, _LL, _P,  # x, L, P (pixels per image), hist
        _P,  # stream
    ],
    "tpuva_blur_u8": [
        _P, _P, _I, _I, _I,  # x, out, N, H, W
        _P, _I, _I,  # taps (device), ntaps, shift
        _I, _I, _I, _I,  # tile_h, tile_w, dp, smem_bytes (ops/wide.py::blur_plan)
        _P,  # stream
    ],
    "tpuva_blur_u8_global": [
        _P, _P, _P, _I, _I, _I,  # x, rows, out, N, H, W
        _P, _I, _I,  # taps (device), ntaps, shift
        _P,  # stream
    ],
    "tpuva_morph_u8": [
        _P, _P, _I, _I, _I,  # x, out, N, H, W
        _P, _I, _I,  # table (device), table_len, nsteps
        _I, _I, _I,  # Ry, Rx, skip_ok
        _I, _I, _I, _I,  # tile_h, tile_w, nbuf, smem_bytes (ops/wide.py::morph_plan)
        _I, _I, _P,  # Hp, Wp, occ (padded_occ's last group; H, W, null otherwise)
        _P,  # stream
    ],
    "tpuva_morph_step_u8": [
        _P, _P, _I, _I, _I,  # x, out, N, H, W
        _P, _I, _I,  # runs (device), n, erode
        _I, _I, _P,  # Hp, Wp, occ
        _P,  # stream
    ],
    "tpuva_median_u8": [
        _P, _P, _I, _I, _I, _I,  # x, out, N, H, W, k
        _P,  # stream
    ],
    "tpuva_median_hist_u8": [
        _P, _P, _I, _I, _I, _I,  # x, out, N, H, W, k
        _P,  # stream
    ],
    "tpuva_median_hist_plan": [
        _I, _I, _I, _I, _P,  # N, H, W, k, out (7 int32)
    ],
    "tpuva_track_scan_plan": [
        _I, _I, _P, _P, _P, _P,  # T, D, kind, kd (int32 out), smem, scratch (int64 out)
    ],
    "tpuva_track_scan": [
        _P, _P, _I, _I, _I, _I,  # dets, det_valid, S, N, T, D
        _P, _P, _P, _P, _P, _P,  # pos0, tid0, missed0, active0, next_id0, frame0
        _P, _P, _P, _P, _P,  # pos1, tid1, missed1, active1, next_id1
        _P, _P,  # rows, row_valid
        _F, _I, _I,  # max_dist, death_patience, hungarian
        _P, _LL,  # scratch, scratch bytes (S streams' scratch)
        _P,  # stream
    ],
    "tpuva_edt": [
        _P, _P, _P,  # mask (uint8), out, ftab (float32[H] or null)
        _P, _P, _P,  # scratch (or null), list (flagged rows, or null), passes (int32[2])
        _I, _I, _I, _I,  # L, H, W, root
        _P,  # stream
    ],
    "tpuva_bgr2gray": [
        _P, _P, _LL, _LL, _LL,  # x, out, P (pixels), pieces, start (ops/color.py::mono_plan)
        _I, _F, _F, _F,  # is_float, the BGR weights
        _I, _I,  # vec_blocks, px_blocks
        _P,  # stream
    ],
    "tpuva_warp_affine": [
        _P, _P, _I, _I, _I, _I, _I, _I,  # x, out, L, H, W, C, ho, wo
        _I, _I,  # is_float, constant
        _F, _F, _F, _F, _F, _F, _F,  # the inverse map (ia, ib, ic, id, ie, if), border value
        _P,  # routes (int32[2] tiles a route, or null)
        _P,  # stream
    ],
    "tpuva_resize_linear": [
        _P, _P, _I, _I, _I, _I, _I, _I,  # x, out, N, H, W, C, h, w
        _P, _P, _P, _P, _I,  # taps_h, taps_w, blocks_h, blocks_w, is_float
        _I, _I, _I, _I,  # buf, vec_in, vec_out, grid_z (ops/resize.py::resize_plan)
        _P,  # routes (int32[2] tiles a route, or null)
        _P,  # stream
    ],
    "tpuva_gaussian_blur_f32": [
        _P, _P, _I, _I, _I, _I,  # x, out, L, H, W, C
        _P, _I, _I, _F,  # taps (device, or null), r, binomial, scale
        _I, _I, _I,  # th, tw, smem (ops/filters.py::blur_float_plan; smem 0: direct)
        _P,  # stream
    ],
    "tpuva_background_scan": [
        _P, _I, _P, _P, _P,  # frames, is_float, bg0, out, bg_last
        _LL, _I, _I,  # P (pixels a frame), N, order (0 scan, 1 sequential)
        _P, _I,  # tables (ops/background.py::scan_tables, on the card), ops
        _F, _F, _F, _I,  # c1, a, thr, emit_diff
        _I, _P,  # seed_bg, seed (a flag on the card, or null)
        _I, _I, _I, _P,  # px, shared, grid, scratch (ops/background.py::scan_plan)
        _P,  # stream
    ],
}
# the micro-probes P1-P4 and the latency probe (csrc/probes.cu): x, out, reps, case, stream
_SIGNATURES.update({
    f"tpuva_probe_{name}": [_P, _P, _I, _I, _P]
    for name in ("repos", "roll", "i16", "cell", "latency")
})


def nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the tpuva_torch kernels "
        "are compiled from csrc/*.cu at first use"
    )


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


GEN_DIR = BUILD_DIR / "gen"


def generated_headers() -> dict[str, str]:
    """{file name: text} of the headers the sources include from GEN_DIR."""
    from tpuva_torch.ops.median import network_header

    return {"median_net.h": network_header()}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    for name, text in sorted(generated_headers().items()):
        h.update(name.encode())
        h.update(text.encode())
    return BUILD_DIR / f"libtpuva_torch_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile csrc/*.cu unless the library for these sources exists.
    Returns (library path, compiler output; empty when it was cached).
    verbose adds ``-Xptxas -v`` (registers, shared memory, spills)."""
    lib = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib, ""
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        GEN_DIR.mkdir(exist_ok=True)
        for name, text in generated_headers().items():
            (GEN_DIR / name).write_text(text)
        ptxas = ["-Xptxas", "-v"] if verbose else []
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources()]
        cmds = [[nvcc(), *NVCC_FLAGS, *ptxas, "-I", str(GEN_DIR), "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources(), objs)]
        cmds.append([nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)])
        log = []
        try:
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for c in cmds[:-1]]
            results = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
            if all(rc == 0 for _c, _out, rc in results):
                res = subprocess.run(cmds[-1], capture_output=True, text=True)
                results.append((cmds[-1], res.stdout + res.stderr, res.returncode))
            for cmd, out, rc in results:
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
                log.append(out)
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        os.replace(tmp, lib)
        return lib, "".join(log)


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build if needed and bind the library (once per process)."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    lib.tpuva_error_string.argtypes = [_I]
    lib.tpuva_error_string.restype = ctypes.c_char_p
    return lib


HOST_SOURCE = CSRC / "batcher.cpp"
HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")
# C signatures of csrc/batcher.cpp (restype, argtypes)
_HOST_SIGNATURES = {
    "tvt_ring_create": (_P, [ctypes.c_size_t, _I, _I, ctypes.POINTER(_P)]),
    "tvt_ring_push": (_I, [_P, _P]),
    "tvt_ring_finish": (None, [_P]),
    "tvt_ring_pop": (_I, [_P, ctypes.POINTER(_I)]),
    "tvt_ring_release": (_I, [_P, _I]),
    "tvt_ring_close": (None, [_P]),
    "tvt_ring_depth": (_I, [_P]),
    "tvt_ring_destroy": (None, [_P]),
    "tvt_bgr2gray": (None, [_P, _P, ctypes.c_size_t]),
}


def cxx() -> str:
    """The host C++ compiler: $CXX, else g++."""
    return os.environ.get("CXX") or "g++"


def host_library_path() -> Path:
    h = hashlib.sha256(" ".join((cxx(), *HOST_FLAGS)).encode())
    h.update(HOST_SOURCE.read_bytes())
    return BUILD_DIR / f"libtpuva_torch_host_{h.hexdigest()[:16]}.so"


def build_host() -> Path:
    """Compile csrc/batcher.cpp (the staging ring, bgr2gray) with the host
    compiler unless the library for this source exists; no nvcc, no card.
    Same directory and file lock as build(). Raises if the compiler fails
    or is missing."""
    lib = host_library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx(), *HOST_FLAGS, "-o", str(tmp), str(HOST_SOURCE)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"host compiler failed: {' '.join(cmd)}: {e}") from e
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"host compiler failed ({res.returncode}):\n{' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, lib)
        return lib


@functools.lru_cache(maxsize=1)
def load_host() -> ctypes.CDLL:
    """Build if needed and bind the host library (once per process)."""
    lib = ctypes.CDLL(str(build_host()))
    for name, (restype, argtypes) in _HOST_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def launch(device, entry: str, what: str, *args) -> None:
    """Call entry point `entry` of the library with `args` and, last, the
    handle of CUDA device `device`'s current stream, with `device` made the
    current device first; raise on a CUDA error. The entry points set kernel
    attributes, size grids and launch on the current device, so a tensor on
    another card than the current one must enter its own: every launch of
    the port goes through here."""
    import torch

    lib = load()
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    check(lib, err, what)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (cudaGetLastError)."""
    if err:
        msg = lib.tpuva_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
