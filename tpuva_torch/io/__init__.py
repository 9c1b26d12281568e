"""tpuva_torch.io — see the package docstring."""
