"""Importing the port loads no JAX, does not initialise CUDA and builds no
kernel (the twin of test_aux.py's import-purity test for tpuva)."""

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
import torch
after = sorted(p.name for p in _build.BUILD_DIR.glob("*")) if _build.BUILD_DIR.exists() else None
print(json.dumps({
    "jax": any(m == "jax" or m.startswith("jax.") for m in sys.modules),
    "tpuva": sorted(m for m in sys.modules if m == "tpuva" or m.startswith("tpuva.")),
    "cuda_initialized": torch.cuda.is_initialized(),
    "loaded": _build.load.cache_info().currsize,
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
        "cuda_initialized": False,
        "loaded": 0,
        "build_dir_unchanged": True,
    }
