"""P1: the cost of the fused kernel's raw-window reposition building blocks
(``bench/repos_probe.py``, ``bench_case``) on the card.

Each case runs `reps` reps of its body on the (152, 1920) raw window, u8
in, int32 or float32 inside, the low byte of the int32 out: an i32 add;
an axis-0 roll by 26, by ``r % 152`` (the rep's index) and by 26 as an
amount the compiler cannot see, each + 1; the float32 cast-hop f -> int32
-> f + 1; a float32 roll by 26 + 1. Kernel: ``csrc/probes.cu``
``tpuva_probe_repos``, 8 CTAs, one an SM: the add and the cast-hop keep
their words in registers; the rolls band the tile by columns, 240 a CTA
in its own shared memory, so an axis-0 roll never leaves the CTA (no
cluster): a rep loads each word from its rolled row and stores it + 1
(``column_band_map``).

    python -m tpuva_torch.probes.repos_probe [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from tpuva_torch.device import resolve_device
from tpuva_torch.probes import Case, case_index, check_tile, f32_to_i32, launch, low_bytes, tile
from tpuva_torch.probes._timing import device_line, measure_cases, parse_args

RL, CL = 152, 1920  # the fused raw window at 1080p, full width
CASES = (
    Case("i32 add (baseline)", 1),
    Case("i32 static roll26 + add", 2),
    Case("i32 dynamic roll + add", 2),
    Case("i32 dyn-uniform roll + add", 2),
    Case("f32 cast-hop f->i->f + add", 3),
    Case("f32 static roll + add", 2),
)
REPS = (4096, 65536)  # the slope's rep counts, the JAX file's two
FILE_REPS = REPS[1]  # the JAX file's heaviest call
# the reps a kernel is held at against its plain version: 160 takes the
# dynamic amount r % 152 through every value and its wrap
CHECK_REPS = (1, 3, 160)
CTAS = 8  # one CTA an SM: 19 rows each (the register cases), 240 columns (the rolls)
FLOAT_CASES = (4, 5)
# the roll cases' column bands: a CTA's columns, 16-byte vectors of 4
# words a row, row groups of VECS threads (17 x 60 of the CTA's 1024), and
# a group's rows (g + GROUPS k)
BAND_COLS = CL // CTAS
VECS = BAND_COLS // 4
GROUPS = 1024 // VECS
GROUP_ROWS = -(-RL // GROUPS)
ROW_BYTES = 4 * BAND_COLS


def column_band_map(d: int):
    """The roll cases' index map for amount d, as the kernel computes it:
    thread (g, c) reads its k-th vector at the byte offset ((g - d) mod
    152) x ROW_BYTES + 16 c, then one group of rows (GROUPS rows) further
    a k, wrapped once past the band's last row, and writes it at row g +
    GROUPS k. Returns (the rows read, the vectors read, the rows written),
    each (GROUPS, GROUP_ROWS, VECS), -1 where a group has no k-th row."""
    g = np.arange(GROUPS)[:, None]
    off = (g - d) % RL * ROW_BYTES + 16 * np.arange(VECS)[None, :]
    src_row = np.full((GROUPS, GROUP_ROWS, VECS), -1)
    src_vec, dst_row = src_row.copy(), src_row.copy()
    for k in range(GROUP_ROWS):
        row = np.broadcast_to(g + GROUPS * k, off.shape)
        has = row < RL
        src_row[:, k] = np.where(has, off // ROW_BYTES, -1)
        src_vec[:, k] = np.where(has, off % ROW_BYTES // 16, -1)
        dst_row[:, k] = np.where(has, row, -1)
        off = off + GROUPS * ROW_BYTES
        off = np.where(off >= RL * ROW_BYTES, off - RL * ROW_BYTES, off)
    return src_row, src_vec, dst_row


def make_tile() -> torch.Tensor:
    return tile((RL, CL), 200)


def plain(x: torch.Tensor, case: str, reps: int) -> torch.Tensor:
    """The probe's body as torch ops, `reps` times; the kernel's plain
    version."""
    i = case_index(CASES, case)
    f = x.to(torch.int32)
    one = 1
    if i in FLOAT_CASES:
        f = f.to(torch.float32)
        one = torch.ones((), dtype=torch.float32, device=x.device)
    for r in range(reps):
        if i == 0:
            f = f + 1
        elif i == 2:
            f = torch.roll(f, r % RL, 0) + 1
        elif i == 4:
            f = f32_to_i32(f).to(torch.float32) + one
        else:
            f = torch.roll(f, 26, 0) + one
    return low_bytes(f32_to_i32(f) if i in FLOAT_CASES else f)


def run(x: torch.Tensor, case: str, reps: int) -> torch.Tensor:
    """`reps` reps of case on x, the (152, 1920) uint8 tile -> uint8: the
    kernel on a CUDA tensor, plain on a CPU tensor."""
    i = case_index(CASES, case)
    check_tile(x, (RL, CL), torch.uint8, "repos_probe")
    if x.device.type == "cpu":
        return plain(x, case, reps)
    out = launch("tpuva_probe_repos", x, i, reps)
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
        print(f"{row['case']:34s}: {row['ns_per_op']:8.1f} ns/op ({row['telem_s']:5.2f} Telem/s, "
              f"{row['telem_s_per_sm']:6.3f} a SM, {row['ctas']} CTAs)", flush=True)


if __name__ == "__main__":
    main()
