"""Importing the port (the micro-probes, the soak, io, export, app, compose, cli,
dist, filters, analysis and debug included) loads no JAX, nothing of bench/, no cv2 or h5py, does not
initialise CUDA and builds nothing, kernels or host library (the twin of
test_aux.py's import-purity test for tpuva)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import json, sys
from tpuva_torch import _build
before = sorted(p.name for p in _build.BUILD_DIR.glob("*")) if _build.BUILD_DIR.exists() else None
import tpuva_torch
import tpuva_torch.graph.pipeline, tpuva_torch.graph.config, tpuva_torch.export.csvio
import tpuva_torch.ops.fused_segment, tpuva_torch.ops.ccl, tpuva_torch.ops.filters
import tpuva_torch.track.table, tpuva_torch.track.assign
import tpuva_torch.graph.streaming, tpuva_torch.io.staging, tpuva_torch.io.memory
import tpuva_torch.ops.label, tpuva_torch.device, tpuva_torch.utils
import tpuva_torch.probes, tpuva_torch.probes._timing, tpuva_torch.probes.repos_probe
import tpuva_torch.probes.roll_probe, tpuva_torch.probes.i16_probe, tpuva_torch.probes.cell_probe
import tpuva_torch.probes.soak_100k, tpuva_torch.scenes
import tpuva_torch.io, tpuva_torch.io.native, tpuva_torch.export, tpuva_torch.export.hdf5io
import tpuva_torch.app, tpuva_torch.compose, tpuva_torch.analysis.curves, tpuva_torch.cli
import tpuva_torch.dist, tpuva_torch.dist.multistream, tpuva_torch.dist.pipeline, tpuva_torch.dist.spatial
import tpuva_torch.filters, tpuva_torch.ops.warp, tpuva_torch.ops.distance, tpuva_torch.debug
import tpuva_torch.analysis, tpuva_torch.analysis.image, tpuva_torch.analysis.shapes
import tpuva_torch.analysis.regions, tpuva_torch.analysis.active_contour
import torch
after = sorted(p.name for p in _build.BUILD_DIR.glob("*")) if _build.BUILD_DIR.exists() else None
print(json.dumps({
    "jax": any(m == "jax" or m.startswith("jax.") for m in sys.modules),
    "tpuva": sorted(m for m in sys.modules if m == "tpuva" or m.startswith("tpuva.")),
    "bench": sorted(m for m in sys.modules if m.split(".")[0] == "bench"),
    "cv2_h5py": sorted(m for m in ("cv2", "h5py") if m in sys.modules),
    "cuda_initialized": torch.cuda.is_initialized(),
    "loaded": _build.load.cache_info().currsize + _build.load_host.cache_info().currsize,
    "build_dir_unchanged": before == after,
}))
"""


def test_import_is_pure():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", PROBE], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {
        "jax": False,
        "tpuva": [],
        "bench": [],
        "cv2_h5py": [],
        "cuda_initialized": False,
        "loaded": 0,
        "build_dir_unchanged": True,
    }
