"""tpuva_torch.graph — see the package docstring."""
