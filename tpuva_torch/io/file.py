"""Container-format video IO via OpenCV's bundled libav (reference:
video/io/file.py — VideoFile, VideoFileWriter, VideoFileStack).

Decode/encode stays on the HOST (SURVEY.md §2.2: the decode path feeds
the batch stager; cv2's bundled libav is the decoding backend, §8). Grayscale-written videos
read back 3-channel BGR from libav; `VideoFile(gray=True)` normalizes.

The port's copy of ``tpuva/io/file.py`` (jax-free there too);
``tests/test_torch_io.py`` holds it to the original on the same files and
seeds.
"""

from __future__ import annotations

import os
import re
from glob import glob

import numpy as np

from tpuva_torch.io.base import VideoBase


class VideoFile(VideoBase):
    """Reads a container video with cv2.VideoCapture.

    Sequential iteration uses the decoder's natural order (no seek);
    random access seeks by frame index (CAP_PROP_POS_FRAMES).
    gray=True converts frames to single-channel grayscale on read.
    """

    def __init__(self, path, gray: bool = False):
        import cv2

        self.path = str(path)
        self._cap = cv2.VideoCapture(self.path)
        if not self._cap.isOpened():
            raise IOError(f"cannot open video {self.path}")
        count = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        w = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        fps = self._cap.get(cv2.CAP_PROP_FPS) or 25.0
        self._gray = gray
        # libav reports 3-channel even for gray-encoded content (§8)
        super().__init__(count, (w, h), fps, is_color=not gray)
        self._next_decode = 0

    def _convert(self, frame):
        import cv2

        if self._gray and frame.ndim == 3:
            return cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        return frame

    def get_frame(self, index: int):
        import cv2

        if not 0 <= index < self.frame_count:
            raise IndexError(index)
        if index != self._next_decode:
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, index)
            self._next_decode = index
        ok, frame = self._cap.read()
        if not ok:
            raise IOError(f"decode failed at frame {index} of {self.path}")
        self._next_decode = index + 1
        return self._convert(frame)

    def close(self):
        if self._cap is not None:
            self._cap.release()
            self._cap = None


class VideoFileWriter:
    """Encodes uint8 frames to a container file (cv2.VideoWriter).

    Context-manager; write gray or BGR frames via write_frame. Default
    codec MJPG in .avi (round-trips, §8); mp4v for .mp4.
    """

    def __init__(self, path, size=None, fps: float = 25.0, is_color=None,
                 codec: str | None = None):
        self.path = str(path)
        self.fps = fps
        self._size = size  # (w, h) or None -> from first frame
        self._is_color = is_color
        self._codec = codec
        self._writer = None
        self.frames_written = 0

    def _open(self, frame):
        import cv2

        h, w = frame.shape[:2]
        if self._size is None:
            self._size = (w, h)
        if self._is_color is None:
            self._is_color = frame.ndim == 3
        codec = self._codec or (
            "mp4v" if self.path.lower().endswith(".mp4") else "MJPG"
        )
        self._writer = cv2.VideoWriter(
            self.path,
            cv2.VideoWriter_fourcc(*codec),
            self.fps,
            self._size,
            isColor=self._is_color,
        )
        if not self._writer.isOpened():
            raise IOError(f"cannot open writer for {self.path}")

    def write_frame(self, frame: np.ndarray):
        frame = np.ascontiguousarray(frame, np.uint8)
        if self._writer is None:
            self._open(frame)
        self._writer.write(frame)
        self.frames_written += 1

    def write_video(self, video: VideoBase):
        for frame in video:
            self.write_frame(frame)

    def close(self):
        if self._writer is not None:
            self._writer.release()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class VideoFileStack(VideoBase):
    """Concatenates numbered files of one recording into one logical video
    (reference: VideoFileStack). Accepts an explicit path list or a glob
    pattern; files are sorted by the natural order of embedded numbers."""

    def __init__(self, paths, gray: bool = False):
        if isinstance(paths, str):
            paths = sorted(glob(paths), key=_natural_key)
        self._videos = [VideoFile(p, gray=gray) for p in paths]
        if not self._videos:
            raise ValueError("no files in stack")
        v0 = self._videos[0]
        total = sum(v.frame_count for v in self._videos)
        super().__init__(total, v0.size, v0.fps, v0.is_color)
        self._offsets = np.cumsum([0] + [v.frame_count for v in self._videos])

    def get_frame(self, index: int):
        if not 0 <= index < self.frame_count:
            raise IndexError(index)
        k = int(np.searchsorted(self._offsets, index, side="right") - 1)
        return self._videos[k].get_frame(index - int(self._offsets[k]))

    def close(self):
        for v in self._videos:
            v.close()


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def load_any_video(path, gray: bool = False) -> VideoBase:
    """Factory: open whatever `path` points at (reference-style helper).

    - a container file -> VideoFile
    - a glob pattern or list matching several videos -> VideoFileStack
    - a directory or glob of images -> VideoImageStack
    """
    from tpuva_torch.io.base import VideoImageStack

    IMG_EXT = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff"}
    if isinstance(path, (list, tuple)):
        exts = {os.path.splitext(str(p))[1].lower() for p in path}
        if exts <= IMG_EXT:
            return VideoImageStack(path)
        return VideoFileStack(list(path), gray=gray)
    path = str(path)
    if os.path.isdir(path):
        imgs = sorted(
            (
                p
                for p in glob(os.path.join(path, "*"))
                if os.path.splitext(p)[1].lower() in IMG_EXT
            ),
            key=_natural_key,
        )
        if not imgs:
            raise IOError(f"no images in directory {path}")
        return VideoImageStack(imgs)
    if any(ch in path for ch in "*?["):
        matches = sorted(glob(path), key=_natural_key)
        if not matches:
            raise IOError(f"no files match {path}")
        exts = {os.path.splitext(p)[1].lower() for p in matches}
        if exts <= IMG_EXT:
            return VideoImageStack(matches)
        if len(matches) == 1:
            return VideoFile(matches[0], gray=gray)
        return VideoFileStack(matches, gray=gray)
    return VideoFile(path, gray=gray)


class RobustVideo(VideoBase):
    """Decode-error tolerance wrapper (SURVEY.md §5.3): a frame that fails
    to decode is replaced by the last good frame (or a zero frame at the
    start) and the event is recorded in `errors` — the stream keeps
    flowing instead of killing a 100k-frame job."""

    def __init__(self, source: VideoBase, on_error: str = "repeat"):
        super().__init__(source.frame_count, source.size, source.fps,
                         source.is_color)
        if on_error not in ("repeat", "raise"):
            raise ValueError(on_error)
        self._source = source
        self._on_error = on_error
        self._last_good = None
        self.errors: list[tuple[int, str]] = []

    def get_frame(self, index: int):
        try:
            frame = self._source.get_frame(index)
        except (IOError, OSError) as e:
            if self._on_error == "raise":
                raise
            self.errors.append((index, str(e)))
            if self._last_good is not None:
                return self._last_good
            h, w = self.height, self.width
            shape = (h, w, 3) if self.is_color else (h, w)
            return np.zeros(shape, np.uint8)
        self._last_good = frame
        return frame

    def close(self):
        self._source.close()
