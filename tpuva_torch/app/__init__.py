"""tpuva_torch.app — the multi-pass tracking application (the names of
``tpuva/app/__init__.py``)."""

from tpuva_torch.app.tracks import Track, TrackCollection  # noqa: F401
from tpuva_torch.app.passes import TrackingProject  # noqa: F401
from tpuva_torch.app.params import Parameters  # noqa: F401
