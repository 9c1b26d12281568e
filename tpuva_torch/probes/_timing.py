"""Timing of the micro-probes: the probe files' ``sync``/``timeit`` and
``bench_pair``'s slope rule.

On a CUDA device a call is timed with CUDA events after a warm-up; on the
CPU (``--device cpu``, the plain versions) with the host clock. The slope
between two rep counts cancels what a call costs besides its reps (the
launch, the tile's load and store):

    per-op = (t(r2) - t(r1)) / ((r2 - r1) * n_ops)

reported as ns per full-tile op, Telem/s, and Telem/s per SM in use (the
probe's CTAs, one an SM).
"""

from __future__ import annotations

import time

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, device: torch.device, iters: int = 3, warmup: int = 1):
    """(seconds per call of fn() over iters calls after warmup calls, the
    last output)."""
    out = None
    for _ in range(warmup):
        out = fn()
    sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / iters, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    return (time.perf_counter() - t0) / iters, out


def slope(call, device: torch.device, r1: int, r2: int, n_ops: int, elements: int, sms: int,
          iters: int = 3) -> dict:
    """Time call(reps) at r1 and r2 reps; the per-op cost of the slope."""
    t1 = timeit(lambda: call(r1), device, iters)[0]
    t2 = timeit(lambda: call(r2), device, iters, warmup=0)[0]  # warm from r1's
    per = (t2 - t1) / ((r2 - r1) * n_ops)
    rate = elements / per / 1e12 if per > 0 else float("nan")
    return {"r1": r1, "r2": r2, "t1_ms": t1 * 1e3, "t2_ms": t2 * 1e3, "ns_per_op": per * 1e9,
            "telem_s": rate, "telem_s_per_sm": rate / sms, "sms": sms}


def parse_args(doc: str, argv=None):
    """The probes' command line: --device, cuda unless cpu is asked for."""
    import argparse

    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    return p.parse_args(argv)


def device_line(device: torch.device) -> str:
    return f"devices: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}"


def measure_cases(run, cases, tile: torch.Tensor, ctas: int, device, reps, iters) -> list:
    """Slope-time run(x, case, r) for every case on the probe's tile on
    device; one dict a case."""
    x = tile.to(device)
    return [dict(case=c.name, n_ops=c.n_ops, ctas=ctas, **slope(
        lambda r, c=c: run(x, c.name, r), device, *reps, c.n_ops, x.numel(), ctas, iters))
        for c in cases]
