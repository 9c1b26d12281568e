"""The device the port's entry points run on."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, checked, a CUDA device with its index. The
    entry points default to ``"cuda"``; without a card they raise instead
    of running the plain versions on the CPU, which only an explicit
    ``device="cpu"`` selects."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: tpuva_torch runs on the card by default; pass "
                "device='cpu' to run the plain versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_device(dev: torch.device):
    """A context that makes CUDA device `dev` the current device (nothing
    for a CPU device): a stream or band's work on its own card enters it,
    so that what it allocates and launches lands there."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def mesh_devices(n: int, devices, what: str = "") -> tuple:
    """The first n of `devices` (default: every visible card, cuda:0 ...
    cuda:k-1) as a tuple of torch.devices, a mesh of tpuva's meshes: one
    process drives it, a device may appear several times (devices=[cpu] * 4
    puts four bands on the CPU). Raises tpuva's ValueError when fewer than
    n are given; never falls back to the CPU."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < n:
        raise ValueError(f"need {n} devices{what}, have {len(devices)}")
    return tuple(resolve_device(d) for d in devices[:n])
