"""tpuva_torch.io — video sources, host decode and staging (the names of
``tpuva/io/__init__.py``). Importing it loads no cv2: the file readers
import it when they open a file."""

from tpuva_torch.io.base import VideoBase, VideoSlice, VideoImageStack  # noqa: F401
from tpuva_torch.io.memory import VideoMemory  # noqa: F401
from tpuva_torch.io.file import (  # noqa: F401
    RobustVideo,
    VideoFile,
    VideoFileStack,
    VideoFileWriter,
    load_any_video,
)
from tpuva_torch.io.parallel_decode import ParallelVideoReader  # noqa: F401
from tpuva_torch.io.pipe import VideoPipe  # noqa: F401
from tpuva_torch.io.fork import VideoFork  # noqa: F401
from tpuva_torch.io.staging import BatchStager  # noqa: F401
