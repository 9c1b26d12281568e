"""P3: the throughput of the k = 5 blur cascade's roll + add at float32,
int32, int16 and uint16 on the card (``bench/i16_probe.py``,
``make_cascade``): does the blur's integer partial sum pay at 16-bit width?

Each case runs `reps` reps of the 16-op cascade (for axis 1 then 0, two f
= f + roll(f, 1) and two f = f + roll(f, n - 1)) and a rescale (float32: x
2^-8; the integer types: ``(f.astype(int32) >> 8).astype(dtype)``) on a
(112, 1152) tile, u8 in and the low byte out. The 16-bit types wrap: the
int16 column pass overflows (255 * 256 > 32767), as on the TPU. Kernel:
``csrc/probes.cu`` ``tpuva_probe_i16``, every case on P2's cascade code
(``roll_probe``): a cluster of 4 CTAs, each holding its band of 28 rows
and a halo of 2 rows each side (``HALO``) in registers, the halo exported
by the neighbouring CTAs once a rep. int16 and uint16 run packed, rows 2 i
and 2 i + 1 of a column in one 32-bit word: an axis-0 roll is a funnel
shift, the uint16 add one plain 32-bit add (no halfword sum passes 65,280,
so no carry crosses), the int16 add ``__vadd2`` (its rescale sign-extends,
so a plain add would carry across), the rescale one byte permute.

    python -m tpuva_torch.probes.i16_probe [--device cpu]

The first count is the JAX file's 512 reps, whose time a call it prints;
the second gives the slope.
"""

from __future__ import annotations

import torch

from tpuva_torch.device import resolve_device
from tpuva_torch.probes import Case, case_index, check_tile, f32_to_i32, launch, low_bytes, tile
from tpuva_torch.probes._timing import device_line, measure_cases, parse_args
from tpuva_torch.probes.roll_probe import cascade

SH, SW = 112, 1152
CASES = (Case("float32", 16), Case("int32", 16), Case("int16", 16), Case("uint16", 16))
REPS = (512, 8192)  # the slope's rep counts: the JAX file's, and a second
FILE_REPS = REPS[0]  # the JAX file's call
CHECK_REPS = (1, 3, FILE_REPS)  # the reps a kernel is held at against its plain version
CTAS = 4  # the cluster: one CTA an SM, 28 rows each
# The kernel's halo a band, as roll_probe.HALO: the cascade's 4 axis-0
# steps read 2 rows up and 2 down a rep, in every case (one word row of a
# packed case).
HALO = {c.name: (2, 2, 1) for c in CASES}
# int32 sums wrapped to the 16-bit type after every op
WRAP = {
    "int16": lambda v: ((v + 0x8000) & 0xFFFF) - 0x8000,
    "uint16": lambda v: v & 0xFFFF,
}


def make_tile() -> torch.Tensor:
    return tile((SH, SW), 256)


def plain(x: torch.Tensor, case: str, reps: int) -> torch.Tensor:
    """`reps` x (cascade, rescale) in the case's type, as torch ops (the 16-bit
    types as int32 wrapped after each op: torch has no uint16 add); the
    kernel's plain version."""
    case_index(CASES, case)
    f = x.to(torch.int32)
    if case == "float32":
        f = f.to(torch.float32)
    wrap = WRAP.get(case, lambda v: v)
    for _ in range(reps):
        f = cascade(f, lambda a, b: wrap(a + b))
        f = f * 2.0**-8 if case == "float32" else f >> 8
    return low_bytes(f32_to_i32(f) if case == "float32" else f)


def run(x: torch.Tensor, case: str, reps: int) -> torch.Tensor:
    """`reps` reps of case on x, the (112, 1152) uint8 tile -> uint8: the
    kernel on a CUDA tensor, plain on a CPU tensor."""
    i = case_index(CASES, case)
    check_tile(x, (SH, SW), torch.uint8, "i16_probe")
    if x.device.type == "cpu":
        return plain(x, case, reps)
    out = launch("tpuva_probe_i16", x, i, reps)
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
        t, ops = row["t1_ms"] / 1e3, row["n_ops"] * row["r1"]
        print(f"{row['case']:8s}: {t*1e3:8.2f} ms/call  {t/ops*1e9:7.1f} ns/full-tile-op  "
              f"({SH*SW*ops/t/1e12:.2f} Telem/s); slope {row['ns_per_op']:7.1f} ns/op, "
              f"{row['telem_s_per_sm']:6.3f} Telem/s a SM", flush=True)


if __name__ == "__main__":
    main()
