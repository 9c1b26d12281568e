"""tpuva_torch — the PyTorch / CUDA port of tpuva for NVIDIA Hopper (H100).

The JAX package ``tpuva`` is the reference: every module here mirrors its
counterpart there and is held bit-equal to it by ``tests/test_torch_*.py``.
The port imports nothing from ``tpuva`` (and no JAX): the few jax-free
pieces it needs (the config dataclasses, the CSV writer, numpy helpers)
are copies that those tests pin to their originals.

Layout (counterparts in ``tpuva/``):
  ops/background.py, ops/filters.py  plain front-end ops
  ops/fused_segment.py               kernel K1 (csrc/fused_segment.cu)
  ops/label.py                       scan keys, plain CCL, stats epilogue
  ops/ccl.py                         kernel K2 (csrc/ccl.cu) + stats
  track/assign.py, track/table.py    the tracker
  graph/pipeline.py                  process_batch / process_clip
  graph/config.py, export/csvio.py   pinned copies

Kernels are compiled by nvcc at the first call on a CUDA tensor
(``tpuva_torch._build``). Importing the package neither initialises CUDA
nor builds anything; CPU tensors take each kernel's plain version.
"""

__version__ = "0.1.0"
