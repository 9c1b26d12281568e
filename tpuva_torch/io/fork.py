"""Fan a single decoded stream out to several lock-step consumers
(reference: VideoFork-style synchronizer, SURVEY.md §2.1).

The source is decoded exactly once; each client is a VideoBase. A frame is
buffered until every client has consumed it, so clients may run skewed by
up to `max_skew` frames before the slowest one applies backpressure
(raises if exceeded, mirroring the reference's lock-step contract).

The port's copy of ``tpuva/io/fork.py`` (jax-free there too);
``tests/test_torch_io.py`` holds it to the original on the same files and
seeds.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from tpuva_torch.io.base import VideoBase


class VideoFork:
    def __init__(self, source: VideoBase, clients: int = 2, max_skew: int = 16):
        self._source = source
        self._iter = None
        self._buffer: deque = deque()  # frames awaiting slowest client
        self._base = 0  # global index of buffer[0]
        self._positions = [0] * clients
        self._max_skew = max_skew
        self.clients = [_ForkClient(self, i) for i in range(clients)]

    def __getitem__(self, i) -> "_ForkClient":
        return self.clients[i]

    def _get(self, client: int, index: int) -> np.ndarray:
        if index < self._base:
            raise RuntimeError(
                f"fork client {client} fell behind the buffer (frame {index})"
            )
        while index >= self._base + len(self._buffer):
            if index - self._base >= self._max_skew:
                raise RuntimeError(
                    f"fork client {client} ran {index - self._base} frames "
                    f"ahead of the slowest client (max_skew={self._max_skew})"
                )
            if self._iter is None:
                self._iter = iter(self._source)
            self._buffer.append(next(self._iter))
        frame = self._buffer[index - self._base]
        self._positions[client] = index + 1
        # drop frames every client has passed
        low = min(self._positions)
        while self._base < low and self._buffer:
            self._buffer.popleft()
            self._base += 1
        return frame


class _ForkClient(VideoBase):
    def __init__(self, fork: VideoFork, idx: int):
        s = fork._source
        super().__init__(s.frame_count, s.size, s.fps, s.is_color)
        self._fork = fork
        self._idx = idx

    def get_frame(self, index: int) -> np.ndarray:
        return self._fork._get(self._idx, index)
