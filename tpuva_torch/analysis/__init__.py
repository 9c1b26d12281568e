"""tpuva_torch.analysis — so far only ``curves`` (``tpuva/analysis/curves.py``),
which the application layer's track smoothing needs."""
