"""tpuva_torch — the PyTorch / CUDA port of tpuva for NVIDIA Hopper (H100).

The JAX package ``tpuva`` is the reference: every module here mirrors its
counterpart there and is held bit-equal to it by ``tests/test_torch_*.py``.
The port imports nothing from ``tpuva`` (and no JAX): the few jax-free
pieces it needs (the config dataclasses, the CSV writer, numpy helpers)
are copies that those tests pin to their originals.

Layout (counterparts in ``tpuva/``):
  ops/background.py, ops/filters.py  plain front-end ops, Otsu threshold,
                                     kernel K4 (csrc/otsu.cu: histogram),
                                     kernel KS (csrc/background.cu: the
                                     float background, scanned or
                                     sequential), kernel KG (csrc/filters.cu:
                                     the float blur)
  ops/fused_segment.py               kernel K1 (csrc/fused_segment.cu)
  ops/label.py                       scan keys, plain CCL, stats epilogue
  ops/ccl.py                         kernels K2 and K3 (csrc/ccl.cu)
  track/assign.py, track/table.py    the tracker
  graph/pipeline.py                  process_batch(_staged) / process_clip
  graph/streaming.py                 StreamingPipeline
  dist/                              MultiStreamPipeline: S streams on one
                                     card, K1 and K5 a launch a step for all
  io/staging.py, io/native.py        BatchStager: pinned ring, one host copy
                                     a frame (native: csrc/batcher.cpp)
  io/                                video sources and host decode (cv2)
  export/                            CSV and HDF5 (h5py) trajectories
  app/, compose/                     TrackingProject's passes, pass 4's movie
  filters.py                         the filter chain: one program a batch
                                     (BatchStager stages a chain by its root)
  ops/warp.py, ops/distance.py       warp_affine, the exact EDT
  analysis/, debug.py                numpy analysis copies (mask_boundary on
                                     K1m), headless image dumps
  cli.py, __main__.py                python -m tpuva_torch
  graph/config.py                    pinned copy
  probes/                            the micro-probes P1-P4 of bench/
                                     (csrc/probes.cu)

Kernels are compiled by nvcc at the first call on a CUDA tensor, the host
library (the staging ring) by the host C++ compiler at its first use
(``tpuva_torch._build``). Importing the package neither initialises CUDA
nor builds anything, nor loads cv2 or h5py; CPU tensors take each
kernel's plain version.
"""

__version__ = "0.1.0"
