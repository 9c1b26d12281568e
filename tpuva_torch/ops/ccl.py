"""8-connected CCL + per-component stats — kernel K2 and its plain version.

Replaces the Pallas kernel ``tpuva/ops/pallas/ccl.py::
label_components_tiled_raw`` together with the XLA stats step
``tpuva/ops/label.py::_stats_from_compact``. Its interface is the stats
dict that the pipeline's ``_finish_batch`` reads, not a label buffer.

- CUDA tensors launch ``csrc/ccl.cu``: block-based union-find over 2x2
  blocks with min-index roots (root order == cv2's id order), a per-frame
  root scan, integer atomics of area / sum x / sum y (see the source).
- CPU tensors take the plain version: ``ops.label.label_components``
  (iterated 3x3 neighbour-min) + ``ops.label.component_sums``.

Both give (count, int64 sums) and share the ``_assemble_stats`` epilogue.
``overflow`` is all zeros (no slot capacity here: components past
``max_components`` are cut exactly as ``_assemble_stats`` cuts them) and
``ccl_converged`` is always True (union-find has no round cap).
"""

from __future__ import annotations

import torch

from tpuva_torch import _build
from tpuva_torch.ops.label import _assemble_stats, component_sums, label_components

MAX_COMPONENTS_KERNEL = 1024  # per-CTA shared-memory accumulators in ccl.cu


def label_sums_plain(mask: torch.Tensor, max_components: int):
    """Plain version of the kernel: (count (N,) int32, sums (N, C, 3) int64)."""
    return component_sums(label_components(mask), max_components)


def _label_sums_cuda(mask: torch.Tensor, max_components: int):
    N, H, W = mask.shape
    C = max_components
    if not 1 <= C <= MAX_COMPONENTS_KERNEL:
        raise ValueError(f"max_components must be in [1, {MAX_COMPONENTS_KERNEL}]")
    if H >= 1 << 16 or W >= 1 << 16:
        raise ValueError("ccl kernel: H and W must be < 65536")
    dev = mask.device
    Hb, Wb = (H + 1) // 2, (W + 1) // 2
    parent = torch.empty((N, Hb * Wb), dtype=torch.int32, device=dev)
    bits = torch.empty((N, Hb * Wb), dtype=torch.uint8, device=dev)
    table = torch.empty((N, C), dtype=torch.int32, device=dev)
    count = torch.empty((N,), dtype=torch.int32, device=dev)
    sums = torch.empty((N, C, 3), dtype=torch.int64, device=dev)
    lib = _build.load()
    err = lib.tpuva_ccl_stats(
        mask.data_ptr(), N, H, W, C,
        parent.data_ptr(), bits.data_ptr(), table.data_ptr(),
        count.data_ptr(), sums.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, "ccl kernel")
    label_stats.launches += 1
    return count, sums


def label_stats(mask: torch.Tensor, max_components: int = 64) -> dict:
    """Stats of the 8-connected components of an (N, H, W) uint8 mask.

    Returns {count (N,) int32, area (N,C+1) int32, centroid (N,C+1,2)
    float32, centroid_sum (N,C+1,2) int32, overflow (N,) int32,
    ccl_converged bool}, row 0 the background, rows 1..C the components
    in cv2 id order — the contract of tpuva's stats dict."""
    if mask.dim() != 3 or mask.dtype != torch.uint8:
        raise ValueError("label_stats: mask must be (N, H, W) uint8")
    N, H, W = mask.shape
    if mask.device.type == "cpu":
        count, sums = label_sums_plain(mask, max_components)
    elif mask.device.type == "cuda":
        if N == 0:
            count = torch.zeros((0,), dtype=torch.int32, device=mask.device)
            sums = torch.zeros((0, max_components, 3), dtype=torch.int64, device=mask.device)
        else:
            count, sums = _label_sums_cuda(mask.contiguous(), max_components)
    else:
        raise ValueError(f"label_stats: unsupported device {mask.device}")
    stats = _assemble_stats(count, sums, H, W)
    stats["overflow"] = torch.zeros((N,), dtype=torch.int32, device=mask.device)
    stats["ccl_converged"] = True
    return stats


label_stats.launches = 0
