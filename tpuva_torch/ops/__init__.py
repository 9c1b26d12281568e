"""tpuva_torch.ops — see the package docstring."""

from tpuva_torch.ops.filters import histogram_u8, otsu_threshold
from tpuva_torch.ops.label import connected_components_with_stats

__all__ = ["connected_components_with_stats", "histogram_u8", "otsu_threshold"]
