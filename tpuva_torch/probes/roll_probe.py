"""P2: the per-op cost of the fused kernel's building blocks (adds,
multiplies, rolls on either axis, roll + add pairs, an unaligned slice
shift, the k = 5 cascade) on the card (``bench/roll_probe.py``,
``bench_body`` timed by ``bench_pair``).

Each case runs `reps` reps of ``body(f) + 1e-7`` in float32 on a (112,
1152) tile, u8 in and the low byte of the saturating int32 conversion
out. Kernel: ``csrc/probes.cu`` ``tpuva_probe_roll``, one cluster of 4
CTAs, each holding its band of 28 rows in registers. The cases on axis 1
keep a row in a warp and shift words by shuffles; the cases on axis 0 and
the cascade hold the band with a halo of rows (``HALO``) that a
neighbouring CTA exports through distributed shared memory, refreshed
once an exchange, one cluster barrier each.

    python -m tpuva_torch.probes.roll_probe [--device cpu]
"""

from __future__ import annotations

import torch

from tpuva_torch.device import resolve_device
from tpuva_torch.probes import Case, case_index, check_tile, f32_to_i32, launch, low_bytes, tile
from tpuva_torch.probes._timing import device_line, measure_cases, parse_args

SH, SW = 112, 1152
CASES = (
    Case("add f+f", 1),
    Case("mul f*c", 1),
    Case("roll axis0 (sublane)", 1),
    Case("roll axis1 (lane)", 1),
    Case("roll axis1 by 8", 1),
    Case("roll0 + add", 2),
    Case("roll1 + add", 2),
    Case("slice1+add (unaligned)", 2),
    Case("k5 cascade (17 ops)", 17),
)
REPS = (4096, 65536)  # the slope's rep counts, the JAX file's two
FILE_REPS = REPS[1]  # the JAX file's heaviest call
# the reps a kernel is held at against its plain version: 140 is past
# float32 overflow in the doubling cases
CHECK_REPS = (1, 3, 140)
CTAS = 4  # the cluster: one CTA an SM, 28 rows each
# The kernel's halo a band (case: (rows above, rows below, reps an
# exchange)): the cascade's 4 axis-0 steps read 2 rows up and 2 down a
# rep; a roll by one row on axis 0 reads one row up a rep, so 4 rows buy 4
# reps. The other cases exchange nothing.
HALO = {"roll axis0 (sublane)": (4, 0, 4), "roll0 + add": (4, 0, 4),
        "k5 cascade (17 ops)": (2, 2, 1)}


def make_tile() -> torch.Tensor:
    return tile((SH, SW), 200)


def cascade(f: torch.Tensor, add) -> torch.Tensor:
    """The k = 5 two-axis cascade, 16 ops: for axis 1 then 0, two f = f +
    roll(f, 1) and two f = f + roll(f, n - 1); add(a, b) is the sum."""
    for dim in (1, 0):
        n = f.shape[dim]
        for shift in (1, 1, n - 1, n - 1):
            f = add(f, torch.roll(f, shift, dim))
    return f


def body(i: int, f: torch.Tensor) -> torch.Tensor:
    if i == 0:
        return f + f
    if i == 1:
        return f * torch.tensor(1.0001, dtype=torch.float32, device=f.device)
    if i in (2, 3, 4):
        return torch.roll(f, 8 if i == 4 else 1, 0 if i == 2 else 1)
    if i in (5, 6):
        return f + torch.roll(f, 1, 0 if i == 5 else 1)
    if i == 7:  # two overlapping column slices, 128 zero columns after
        return torch.nn.functional.pad(f[:, : SW - 128] + f[:, 1 : SW - 127], (0, 128))
    return cascade(f, torch.add) * 2.0**-8


def plain(x: torch.Tensor, case: str, reps: int) -> torch.Tensor:
    """`reps` x (body(f) + 1e-7) in float32, as torch ops; the kernel's
    plain version. Every add and product rounds once."""
    i = case_index(CASES, case)
    eps = torch.tensor(1e-7, dtype=torch.float32, device=x.device)
    f = x.to(torch.int32).to(torch.float32)
    for _ in range(reps):
        f = body(i, f) + eps
    return low_bytes(f32_to_i32(f))


def run(x: torch.Tensor, case: str, reps: int) -> torch.Tensor:
    """`reps` reps of case on x, the (112, 1152) uint8 tile -> uint8: the
    kernel on a CUDA tensor, plain on a CPU tensor."""
    i = case_index(CASES, case)
    check_tile(x, (SH, SW), torch.uint8, "roll_probe")
    if x.device.type == "cpu":
        return plain(x, case, reps)
    out = launch("tpuva_probe_roll", x, i, reps)
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
        print(f"{row['case']:26s}: {row['ns_per_op']:8.1f} ns/op  ({row['telem_s']:5.2f} Telem/s, "
              f"{row['telem_s_per_sm']:6.3f} a SM, {row['ctas']} CTAs)", flush=True)


if __name__ == "__main__":
    main()
