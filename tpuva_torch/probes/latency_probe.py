"""The latency probe: what one dependent operation of the micro-probes P1-P4
costs on the card. It replaces no TPU probe: PERF.md bounds each of P1-P4
by its rep's chain of dependent operations (reps x the chain's latency),
and this measures those latencies.

Each case runs `reps` dependent operations on one thread, or `reps`
barriers on every thread of a CTA or cluster (``CTAS``), and takes the
latency from the slope between two rep counts (``_timing.slope``): a
float32 add, the cast-hop f -> int32 -> f + 1, a load from
shared memory and one from another CTA's shared memory (chases through a
single-cycle permutation of 1024 indices), each 16 to an iteration of
the rep loop; a CTA barrier (1024 threads) and a cluster barrier of 4
CTAs (1024 threads each); an int32 add and P3's packed int16 add
(``__vadd2``), each sum also xored into a second register so that ptxas
cannot merge two adds into one. There is no integer min/max case:
ptxas regroups such a chain when its operands do not depend on it, so
it would time no latency. Kernel: ``csrc/probes.cu``
``tpuva_probe_latency``.

    python -m tpuva_torch.probes.latency_probe [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from tpuva_torch.device import resolve_device
from tpuva_torch.probes import Case, case_index, check_tile, launch
from tpuva_torch.probes._timing import device_line, parse_args, slope

N = 1024
CASES = (
    Case("f32 add", 1),
    Case("cast-hop f->i->f + 1", 1),
    Case("shared load", 1),
    Case("DSMEM load", 1),
    Case("CTA barrier", 1),
    Case("cluster barrier (4 CTAs)", 1),
    Case("i32 add", 1),
    Case("packed add (int16)", 1),
)
CTAS = (1, 1, 1, 2, 1, 4, 1, 1)  # csrc/probes.cu lat::kCtas
REPS = (4096, 65536)  # the slope's rep counts
CHECK_REPS = (0, 1, 3, 1000)


def make_tile() -> torch.Tensor:
    """One cycle through all N indices: x[order[k]] = order[k + 1]."""
    order = np.random.default_rng(11).permutation(N)
    x = np.empty(N, np.int32)
    x[order] = np.roll(order, -1)
    return torch.from_numpy(x)


def add_chain(x: torch.Tensor, reps: int, packed: bool) -> int:
    """The xor of the sums v_0 = x[0], v_j = v_(j-1) + w, w = x[1] | x[2] <<
    16, as uint32 (packed: each halfword wrapped alone)."""
    x0, w = int(x[0]), int(x[1]) | int(x[2]) << 16
    j = np.arange(reps + 1, dtype=np.uint64)
    if packed:
        lo = (x0 + j * (w & 0xFFFF)) & 0xFFFF
        v = lo | (((x0 >> 16) + j * (w >> 16)) & 0xFFFF) << 16
    else:
        v = (x0 + j * w) & 0xFFFFFFFF
    return int(np.bitwise_xor.reduce(v))


def plain(x: torch.Tensor, case: str, reps: int) -> torch.Tensor:
    """The kernel's output as torch ops: x with out[0] the chain's last
    value (the adds: the xor of every sum). The float chains add 1 to an
    integer below 2^24, so each sum is exact."""
    i = case_index(CASES, case)
    out = x.clone()
    x0 = int(x[0])
    if i >= 6:
        out[0] = int(np.uint32(add_chain(x, reps, i == 7)).view(np.int32))
    elif i in (0, 1):
        out[0] = torch.tensor(float(x0 + reps), dtype=torch.float32).view(torch.int32)
    elif i in (2, 3):
        j = 0
        nxt = x.tolist()
        for _ in range(reps):
            j = nxt[j]
        out[0] = j
    else:
        out[0] = reps
    return out


def run(x: torch.Tensor, case: str, reps: int) -> torch.Tensor:
    """`reps` dependent operations of case on x (make_tile's int32[1024]):
    the kernel on a CUDA tensor, plain on a CPU tensor."""
    i = case_index(CASES, case)
    check_tile(x, (N,), torch.int32, "latency_probe")
    if reps + N >= 2**24:
        raise ValueError("latency_probe: reps must keep the float chains exact")
    if x.device.type == "cpu":
        return plain(x, case, reps)
    out = launch("tpuva_probe_latency", x, i, reps)
    run.launches += 1
    return out


run.launches = 0


def measure(device="cuda", iters=3) -> dict:
    """{case: ns per dependent operation}: the slope between REPS."""
    dev = resolve_device(device)
    x = make_tile().to(dev)
    return {c.name: slope(lambda r, c=c: run(x, c.name, r), dev, *REPS, 1, 1, 1,
                          iters)["ns_per_op"] for c in CASES}


def main(argv=None) -> None:
    args = parse_args(__doc__, argv)
    dev = resolve_device(args.device)
    print(device_line(dev), flush=True)
    for case, ns in measure(dev).items():
        print(f"{case:28s}: {ns:8.2f} ns", flush=True)


if __name__ == "__main__":
    main()
