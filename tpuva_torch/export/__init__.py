"""tpuva_torch.export — see the package docstring."""
