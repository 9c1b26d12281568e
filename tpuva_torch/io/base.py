"""The video abstraction: lazy iterators of uint8 frames — copy of
``VideoBase``, ``VideoSlice`` and ``VideoImageStack`` from
``tpuva/io/base.py`` (jax-free, but the port imports nothing of tpuva;
``tests/test_torch_streaming.py`` and ``tests/test_torch_io.py`` pin the
copy to the original).

Everything downstream consumes "a video": frames are HxW (gray) or HxWx3
(BGR) uint8 numpy arrays, and ``iter_batches(n)`` yields (n, H, W[, 3])
stacks for batched device processing.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


class VideoBase:
    """Iterator contract every video-like object implements.

    Subclasses must set _frame_count, _size (w, h), _fps, _is_color and
    implement get_frame(index).
    """

    def __init__(self, frame_count: int, size: Tuple[int, int], fps: float,
                 is_color: bool):
        self._frame_count = int(frame_count)
        self._size = (int(size[0]), int(size[1]))  # (width, height)
        self._fps = float(fps)
        self._is_color = bool(is_color)
        self._pos = 0

    # ------------------------------------------------------------ properties
    @property
    def frame_count(self) -> int:
        return self._frame_count

    @property
    def size(self) -> Tuple[int, int]:
        """(width, height), the reference's convention."""
        return self._size

    @property
    def width(self) -> int:
        return self._size[0]

    @property
    def height(self) -> int:
        return self._size[1]

    @property
    def fps(self) -> float:
        return self._fps

    @property
    def is_color(self) -> bool:
        return self._is_color

    @property
    def shape(self) -> Tuple[int, ...]:
        h, w = self.height, self.width
        return (
            (self.frame_count, h, w, 3)
            if self.is_color
            else (self.frame_count, h, w)
        )

    @property
    def duration(self) -> float:
        return self.frame_count / self.fps if self.fps else float("nan")

    # ------------------------------------------------------------- iteration
    def __len__(self) -> int:
        return self.frame_count

    def __iter__(self) -> Iterator[np.ndarray]:
        self.set_frame_pos(0)
        return self

    def __next__(self) -> np.ndarray:
        return self.get_next_frame()

    def set_frame_pos(self, index: int) -> None:
        if not 0 <= index <= self.frame_count:
            raise IndexError(f"frame position {index} out of range")
        self._pos = index

    def get_frame_pos(self) -> int:
        return self._pos

    def get_next_frame(self) -> np.ndarray:
        if self._pos >= self.frame_count:
            raise StopIteration
        frame = self.get_frame(self._pos)
        self._pos += 1
        return frame

    # -------------------------------------------------------- random access
    def get_frame(self, index: int) -> np.ndarray:
        raise NotImplementedError

    def __getitem__(self, key):
        if isinstance(key, slice):
            return VideoSlice(self, key)
        index = int(key)
        if index < 0:
            index += self.frame_count
        if not 0 <= index < self.frame_count:
            raise IndexError(f"frame index {key} out of range")
        return self.get_frame(index)

    # ------------------------------------------------------------ batch API
    def iter_batches(self, batch: int, pad_last: bool = False):
        """Yield (n_valid, stack) where stack is a (batch-or-less, H, W[,3])
        uint8 array. With pad_last=True the final stack is padded to full
        `batch` size by repeating the last frame (n_valid tells how many
        rows are real) — the shape-stable form device pipelines want."""
        T = self.frame_count
        for start in range(0, T, batch):
            n = min(batch, T - start)
            stack = np.stack([self.get_frame(start + i) for i in range(n)])
            if pad_last and n < batch:
                stack = np.concatenate(
                    [stack, np.repeat(stack[-1:], batch - n, axis=0)]
                )
            yield n, stack

    def to_array(self) -> np.ndarray:
        """Materialize the whole video as one uint8 array."""
        return np.stack([self.get_frame(i) for i in range(self.frame_count)])

    def close(self) -> None:  # pragma: no cover - default no-op
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __repr__(self):
        return (
            f"{type(self).__name__}(frame_count={self.frame_count}, "
            f"size={self.size}, fps={self.fps}, is_color={self.is_color})"
        )


class VideoSlice(VideoBase):
    """Lazy sliced view of another video (reference: __getitem__ slicing)."""

    def __init__(self, source: VideoBase, sl: slice):
        start, stop, step = sl.indices(source.frame_count)
        count = max(0, (stop - start + (step - (1 if step > 0 else -1))) // step)
        super().__init__(count, source.size, source.fps, source.is_color)
        self._source = source
        self._start, self._step = start, step

    def get_frame(self, index: int) -> np.ndarray:
        if not 0 <= index < self.frame_count:
            raise IndexError(index)
        return self._source.get_frame(self._start + index * self._step)


class VideoImageStack(VideoBase):
    """Video backed by a sequence of image files (reference:
    VideoImageStackBase)."""

    def __init__(self, paths, fps: float = 25.0):
        import cv2

        self._paths = [str(p) for p in paths]
        if not self._paths:
            raise ValueError("empty image stack")
        first = cv2.imread(self._paths[0], cv2.IMREAD_UNCHANGED)
        if first is None:
            raise IOError(f"cannot read image {self._paths[0]}")
        is_color = first.ndim == 3
        h, w = first.shape[:2]
        super().__init__(len(self._paths), (w, h), fps, is_color)
        self._cache = {0: first}

    def get_frame(self, index: int) -> np.ndarray:
        import cv2

        if index in self._cache:
            return self._cache.pop(index)
        frame = cv2.imread(self._paths[index], cv2.IMREAD_UNCHANGED)
        if frame is None:
            raise IOError(f"cannot read image {self._paths[index]}")
        return frame
