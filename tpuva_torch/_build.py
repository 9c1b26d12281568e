"""Build and bind the port's CUDA kernels (``tpuva_torch/csrc/*.cu``).

nvcc compiles every source into one shared library with a plain C
interface, loaded with ctypes: no ``torch/extension.h``, so a build takes
seconds rather than minutes. It happens at the first kernel call (or an
explicit ``build()``), never on import. The library lands in
``build/tpuva_torch/`` at the repository root (git-ignored), named by a
hash of the sources and flags, and is built under a file lock so that
concurrent processes build it once.

Flags: ``--fmad=false`` keeps nvcc from contracting ``a*b + c`` into an
FMA (the kernels also use ``__fmul_rn``/``__fadd_rn`` where rounding is
pinned); fast math is never used. If nvcc is missing the build raises.
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
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of the entry points in csrc/*.cu
_SIGNATURES = {
    "tpuva_fused_segment": [
        _P, _P, _P, _P,  # frames, bg0, masks, bg_out
        _I, _I, _I,  # N, H, W
        _F, _F, _F,  # c1, a, thr
        _P, _I, _I,  # taps, ntaps, shift
        _I,  # median
        _P, _P, _P,  # stage_k, stage_iters, stage_se
        _I, _I, _I,  # seed_bg, tile_h, tile_w
        _P,  # stream
    ],
    "tpuva_ccl_stats": [
        _P, _I, _I, _I, _I,  # mask, N, H, W, C
        _P, _P, _P, _P, _P,  # parent, bits, table, count, sums
        _P,  # stream
    ],
}


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


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
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
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), *map(str, sources())]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout}{res.stderr}"
            )
        os.replace(tmp, lib)
        return lib, res.stdout + res.stderr


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


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (cudaGetLastError)."""
    if err:
        msg = lib.tpuva_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
