"""Decode/process split (reference: video/io/pipe.py — VideoPipe, the
reference's only process boundary, SURVEY.md §3.5).

The reference streamed frames between *processes* over multiprocessing
pipes with a per-frame ack protocol so slow analysis would not stall
decode. The rebuild's equivalent is a decode *thread* feeding a bounded
queue: cv2's decoder releases the GIL, so a thread gives the same overlap
without pickling frames across processes; the bounded queue provides the
same backpressure the ack protocol did. The downstream face is still "a
video": VideoPipe is a VideoBase for strictly sequential consumption.

The port's copy of ``tpuva/io/pipe.py`` (jax-free there too);
``tests/test_torch_io.py`` holds it to the original on the same files and
seeds.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from tpuva_torch.io.base import VideoBase

_SENTINEL = object()


class VideoPipe(VideoBase):
    """Prefetches `source` on a background thread into a bounded queue.

    Sequential-only: random access (get_frame) raises — use the source
    directly for that. Propagates decode errors to the consumer.
    """

    def __init__(self, source: VideoBase, depth: int = 8, name: str = "video-pipe"):
        super().__init__(source.frame_count, source.size, source.fps,
                         source.is_color)
        self._source = source
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._error = None
        self._started = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._feeder, name=name, daemon=True
        )

    # --------------------------------------------------------------- feeder
    def _feeder(self):
        try:
            for frame in self._source:
                if self._stop.is_set():
                    return
                self._queue.put(frame)
            self._queue.put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 - relayed to consumer
            self._error = e
            try:
                self._queue.put(_SENTINEL)
            except Exception:
                pass

    # ------------------------------------------------------------- consumer
    def __iter__(self):
        if self._started:
            raise RuntimeError("VideoPipe supports a single pass")
        self._started = True
        self._thread.start()
        return self

    def get_next_frame(self) -> np.ndarray:
        if not self._started:
            iter(self)
        item = self._queue.get()
        if item is _SENTINEL:
            if self._error is not None:
                raise self._error
            raise StopIteration
        self._pos += 1
        return item

    def get_frame(self, index: int):
        raise NotImplementedError(
            "VideoPipe is sequential-only; seek on the source video instead"
        )

    @property
    def depth(self) -> int:
        """Current queue fill (observability; SURVEY.md §5.5 logs this)."""
        return self._queue.qsize()

    def close(self):
        self._stop.set()
        # drain so the feeder can observe the stop flag
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._started:
            self._thread.join(timeout=5)
        self._source.close()
