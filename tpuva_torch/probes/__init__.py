"""The port's counterparts of the TPU micro-probes P1-P4 under ``bench/``.

Each probe times building blocks of a kernel on one tile, `reps` reps of a
body a call, and takes the per-op cost from the slope between two rep
counts (``_timing.py``)::

    python -m tpuva_torch.probes.repos_probe   # P1, bench/repos_probe.py
    python -m tpuva_torch.probes.roll_probe    # P2, bench/roll_probe.py
    python -m tpuva_torch.probes.i16_probe     # P3, bench/i16_probe.py
    python -m tpuva_torch.probes.cell_probe    # P4, bench/cell_probe.py

Each module has the JAX file's cases in its order (``CASES``), ``run(x,
case, reps)``, which launches the probe's kernel (``csrc/probes.cu``) on a
CUDA tensor and takes ``plain`` on a CPU tensor, ``plain``, the same
function as torch ops, ``measure`` and ``main``. Both give the JAX probe's
output bit for bit. Nothing here imports JAX, ``tpuva`` or ``bench``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuva_torch import _build


class Case(NamedTuple):
    name: str
    n_ops: int  # full-tile operations a rep, as the JAX file counts them


def case_index(cases, case) -> int:
    """The position of `case` (a name of `cases`) in the table: the
    kernel's case number."""
    names = [c.name for c in cases]
    if case not in names:
        raise ValueError(f"unknown case {case!r}; cases: {names}")
    return names.index(case)


def f32_to_i32(f: torch.Tensor) -> torch.Tensor:
    """XLA's float32 -> int32: toward zero, saturating at the int32 limits,
    NaN -> 0 (a plain torch cast on the CPU does not saturate)."""
    t = f.double().trunc().clamp(-2.0**31, 2.0**31 - 1)
    return torch.where(t.isnan(), 0.0, t).to(torch.int32)


def low_bytes(v: torch.Tensor) -> torch.Tensor:
    """int32 -> uint8 as XLA's convert: the low byte."""
    return (v & 0xFF).to(torch.uint8)


def tile(shape, high, dtype=np.uint8, seed=0) -> torch.Tensor:
    """The JAX probe's input: numpy's default_rng(seed).integers(0, high)."""
    return torch.from_numpy(np.random.default_rng(seed).integers(0, high, shape, dtype))


def check_tile(x: torch.Tensor, shape, dtype, what: str) -> None:
    """Raise unless x is the probe's tile: its shape and type, on the CPU
    (the plain version) or a CUDA device (the kernel)."""
    if tuple(x.shape) != tuple(shape) or x.dtype != dtype:
        raise ValueError(f"{what}: x must be a {tuple(shape)} {dtype} tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def launch(entry: str, x: torch.Tensor, which: int, reps: int) -> torch.Tensor:
    """Run probe kernel `entry` (csrc/probes.cu) case `which` for `reps`
    reps on the CUDA tile x; returns its output tile."""
    if reps < 0:
        raise ValueError(f"{entry}: reps must be >= 0")
    x = x.contiguous()
    out = torch.empty_like(x)
    _build.launch(x.device, entry, f"{entry} kernel", x.data_ptr(), out.data_ptr(), reps, which)
    return out
