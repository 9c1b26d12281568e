"""tpuva_torch.ops — see the package docstring."""
