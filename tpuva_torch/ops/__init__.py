"""tpuva_torch.ops — the names ``tpuva.ops`` exports, each a port of its
counterpart (see the package docstring)."""

from tpuva_torch.ops.background import background_update
from tpuva_torch.ops.distance import distance_transform_edt, distance_transform_edt_sq
from tpuva_torch.ops.filters import (
    dilate,
    erode,
    gaussian_blur,
    gaussian_blur_u8,
    gaussian_kernel_1d,
    histogram_u8,
    median_blur,
    morph_close,
    morph_open,
    otsu_threshold,
    structuring_element,
    threshold,
)
from tpuva_torch.ops.label import connected_components_with_stats
from tpuva_torch.ops.warp import invert_affine, rotation_matrix, warp_affine

__all__ = [
    "background_update", "connected_components_with_stats", "dilate",
    "distance_transform_edt", "distance_transform_edt_sq", "erode", "gaussian_blur",
    "gaussian_blur_u8", "gaussian_kernel_1d", "histogram_u8", "invert_affine", "median_blur",
    "morph_close", "morph_open", "otsu_threshold", "rotation_matrix", "structuring_element",
    "threshold", "warp_affine",
]
