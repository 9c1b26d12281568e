"""Whole-clip-in-RAM video — copy of ``tpuva/io/memory.py::VideoMemory``
(pinned to the original by ``tests/test_torch_streaming.py``)."""

from __future__ import annotations

import numpy as np

from tpuva_torch.io.base import VideoBase


class VideoMemory(VideoBase):
    def __init__(self, data: np.ndarray, fps: float = 25.0, copy: bool = False):
        data = np.asarray(data)
        if data.ndim not in (3, 4):
            raise ValueError("expected (T, H, W) or (T, H, W, 3) array")
        if copy:
            data = data.copy()
        self.data = data
        is_color = data.ndim == 4
        t, h, w = data.shape[:3]
        super().__init__(t, (w, h), fps, is_color)

    def get_frame(self, index: int) -> np.ndarray:
        return self.data[index]

    def iter_batches(self, batch: int, pad_last: bool = False):
        T = self.frame_count
        for start in range(0, T, batch):
            n = min(batch, T - start)
            stack = self.data[start : start + n]
            if pad_last and n < batch:
                stack = np.concatenate(
                    [stack, np.repeat(stack[-1:], batch - n, axis=0)]
                )
            yield n, stack

    def to_array(self) -> np.ndarray:
        return self.data

    @staticmethod
    def from_video(video: VideoBase, fps: float | None = None) -> "VideoMemory":
        return VideoMemory(video.to_array(), fps or video.fps)
