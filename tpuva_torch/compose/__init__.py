"""tpuva_torch.compose — the debug-movie writer (``tpuva/compose``)."""

from tpuva_torch.compose.composer import VideoComposer, annotate_tracks  # noqa: F401
