"""The device the port's entry points run on."""

from __future__ import annotations

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
