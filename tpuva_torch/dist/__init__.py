"""Several streams, or one stream's bands, over devices — port of
``tpuva/dist``: the multistream path (BASELINE.json config 5) on one card
or a ('stream',) mesh, and the spatial path, a frame's rows banded across
a ('space',) mesh. A mesh is a tuple of torch.devices that one process
drives; a device may appear in it several times."""

from tpuva_torch.dist.multistream import (  # noqa: F401
    init_multistream_carry,
    make_multistream_processor,
    make_stream_mesh,
    merge_stream_rows,
)
from tpuva_torch.dist.pipeline import (  # noqa: F401
    MultiStreamPipeline,
    SpatialStreamPipeline,
    load_multistream_checkpoint,
    save_multistream_checkpoint,
)
from tpuva_torch.dist.spatial import (  # noqa: F401
    make_space_mesh,
    make_spatial_processor,
)
