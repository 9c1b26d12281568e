"""Multi-stream processing on one card (BASELINE.json config 5) — port of
``tpuva/dist`` without its mesh and spatial (frame-banded) parts."""

from tpuva_torch.dist.multistream import (  # noqa: F401
    init_multistream_carry,
    make_multistream_processor,
    merge_stream_rows,
)
from tpuva_torch.dist.pipeline import (  # noqa: F401
    MultiStreamPipeline,
    load_multistream_checkpoint,
    save_multistream_checkpoint,
)
