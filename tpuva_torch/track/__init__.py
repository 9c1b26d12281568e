"""tpuva_torch.track — see the package docstring."""
