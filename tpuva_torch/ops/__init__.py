"""tpuva_torch.ops — see the package docstring."""

from tpuva_torch.ops.label import connected_components_with_stats

__all__ = ["connected_components_with_stats"]
