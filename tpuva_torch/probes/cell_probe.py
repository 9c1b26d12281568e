"""P4: does a 2-row cell layout halve the CCL sweep on the card
(``bench/cell_probe.py``, ``make``)?

Each case runs `reps` reps of one body on an (80, 512) int32 tile:
``baseline_min`` (8 x axis-0 roll by 1 + min); ``extract_roundtrip`` (the
even and odd row planes, 4 x roll + min each, interleaved back);
``baseline_sweepish`` (16 x roll + min along both axes, both ways);
``cell_sweepish`` (v = min(top, bottom) of the 2-row cells, the same sweep
on v, then rows v and max(v, bottom)). Kernel: ``csrc/probes.cu``
``tpuva_probe_cell``, the tile in the registers of one CTA of 1024
threads, a block of ``BLOCK`` (10 rows x 4 columns) a thread; a warp
holds 16 whole columns, 8 row blocks down each of its 4 column groups. A
step moves only edge rows (a shuffle inside a column group, which wraps
row 79 to row 0) and edge columns (a shuffle inside the warp, through
shared memory between warps); a 2-row cell lies inside a thread, so the
stride-2 extract and the interleave cost nothing.

    python -m tpuva_torch.probes.cell_probe [--device cpu]

The first count is the JAX file's 256 reps, whose time a rep it prints;
the second gives the slope.
"""

from __future__ import annotations

import torch

from tpuva_torch.device import resolve_device
from tpuva_torch.probes import Case, case_index, check_tile, launch, tile
from tpuva_torch.probes._timing import device_line, measure_cases, parse_args

SH, SW = 80, 512
# n_ops: full-tile operations a rep (a roll or a min each; one on a
# half-height plane is half)
CASES = (
    Case("baseline_min", 16),
    Case("extract_roundtrip", 8),
    Case("baseline_sweepish", 128),
    Case("cell_sweepish", 65),
)
REPS = (256, 4096)  # the slope's rep counts: the JAX file's, and a second
FILE_REPS = REPS[0]  # the JAX file's call
CHECK_REPS = (1, 3, FILE_REPS)  # the reps a kernel is held at against its plain version
CTAS = 1
# the kernel's layout: a thread's block (rows, columns); ROW_BLOCKS lanes
# down a column group, COL_GROUPS column groups a warp, WARPS warps
BLOCK = (10, 4)
ROW_BLOCKS = SH // BLOCK[0]
COL_GROUPS = 32 // ROW_BLOCKS
WARPS = SW // (COL_GROUPS * BLOCK[1])


def make_tile() -> torch.Tensor:
    return tile((SH, SW), 1 << 20, dtype="int32")


def roll_min(x: torch.Tensor, shift: int, dim: int) -> torch.Tensor:
    return torch.minimum(x, torch.roll(x, shift, dim))


def interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a, b], dim=1).reshape(2 * a.shape[0], a.shape[1])


def body(case: str, x: torch.Tensor) -> torch.Tensor:
    if case == "baseline_min":
        for _ in range(8):
            x = roll_min(x, 1, 0)
        return x
    if case == "extract_roundtrip":
        t, b = x[0::2], x[1::2]
        for _ in range(4):
            t, b = roll_min(t, 1, 0), roll_min(b, 1, 0)
        return interleave(t, b)
    if case == "baseline_sweepish":
        for _ in range(16):
            for shift, dim in ((1, 0), (SH - 1, 0), (1, 1), (SW - 1, 1)):
                x = roll_min(x, shift, dim)
        return x
    t, b = x[0::2], x[1::2]
    v = torch.minimum(t, b)
    for _ in range(16):
        for shift, dim in ((1, 0), (SH // 2 - 1, 0), (1, 1), (SW - 1, 1)):
            v = roll_min(v, shift, dim)
    return interleave(v, torch.maximum(v, b))


def plain(x: torch.Tensor, case: str, reps: int) -> torch.Tensor:
    """`reps` x body, as torch ops; the kernel's plain version."""
    case_index(CASES, case)
    for _ in range(reps):
        x = body(case, x)
    return x


def run(x: torch.Tensor, case: str, reps: int) -> torch.Tensor:
    """`reps` reps of case on x, the (80, 512) int32 tile -> int32: the
    kernel on a CUDA tensor, plain on a CPU tensor."""
    i = case_index(CASES, case)
    check_tile(x, (SH, SW), torch.int32, "cell_probe")
    if x.device.type == "cpu":
        return plain(x, case, reps)
    out = launch("tpuva_probe_cell", x, i, reps)
    run.launches += 1
    return out


run.launches = 0


def measure(device="cuda", iters=3) -> list:
    """Slope-time every case at REPS on the device (the kernel on a CUDA device,
    plain on the CPU); one dict a case."""
    return measure_cases(run, CASES, make_tile(), CTAS, resolve_device(device), REPS, iters)


def main(argv=None) -> None:
    args = parse_args(__doc__, argv)
    dev = resolve_device(args.device)
    print(device_line(dev), flush=True)
    for row in measure(dev):
        print(f"{row['case']:18s}: {row['t1_ms'] * 1e3 / row['r1']:8.2f} us/rep; slope "
              f"{(row['t2_ms'] - row['t1_ms']) * 1e3 / (row['r2'] - row['r1']):8.3f} us/rep, "
              f"{row['ns_per_op']:7.1f} ns/op", flush=True)


if __name__ == "__main__":
    main()
