"""Analysis algorithms (L3, reference: video/analysis/) — the port's copies
of ``tpuva/analysis/``: host-side numpy utilities for geometry, curve and
image measurement (``curves``, ``image``, ``shapes``, ``regions``,
``active_contour``), and ``regions.mask_boundary`` on a tensor's device.
Off the throughput metric path."""

from tpuva_torch.analysis.regions import Rectangle  # noqa: F401
from tpuva_torch.analysis.shapes import Circle, Ellipse  # noqa: F401
from tpuva_torch.analysis.active_contour import ActiveContour  # noqa: F401
