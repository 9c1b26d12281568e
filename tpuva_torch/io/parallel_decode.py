"""Seek-sharded parallel host decode (SURVEY.md §7.3 "consider a decode
worker pool"; config 4/5, BASELINE.json:10).

A single cv2/libav decode loop delivers order 10² fps at 1080p while the
device pipeline consumes thousands — on real hardware host decode is the
end-to-end ceiling (the reference had the same wall: its VideoPipe split
decode into a second *process*). This pool shards the FRAME RANGE:

- the stream is cut into contiguous `chunk`-frame ranges;
- each worker owns its OWN decoder handle(s) (a fresh VideoFile /
  VideoFileStack per worker — cv2.VideoCapture is not thread-safe, so
  handles are never shared), pulls the next unclaimed chunk index, seeks
  to its start (CAP_PROP_POS_FRAMES; frame-accurate for the MJPG/mp4v
  codecs this environment writes, SURVEY §8), and decodes it;
- finished chunks land in a bounded ordered reassembly window; the
  consumer serves frames strictly in order, so downstream pipelines see
  exactly the sequential decode stream.

For a VideoFileStack, chunks that span file boundaries are handled by the
per-worker stack handle transparently; chunk size can be aligned to file
boundaries by the caller for zero cross-file seeks.

Decode is CPU-bound C code that releases the GIL, so threads scale with
host cores (bench/decode_probe.py measures the scaling).

The port's copy of ``tpuva/io/parallel_decode.py`` (jax-free there too);
``tests/test_torch_io.py`` holds it to the original on the same files and
seeds.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Union

import numpy as np

from tpuva_torch.io.base import VideoBase


class ParallelVideoReader(VideoBase):
    """Multi-worker seek-sharded reader with the VideoBase contract.

    source: a path / list-of-paths / glob (opened per worker via
    load_any_video) or a zero-arg factory returning a fresh VideoBase per
    call (each worker calls it once; handles are never shared).

    Sequential access (iteration, iter_batches, monotone get_frame) is
    served from the reassembly window at full pool speed. Backward random
    access falls back to a dedicated sequential handle — correct but not
    accelerated.
    """

    def __init__(
        self,
        source: Union[str, list, tuple, Callable[[], VideoBase]],
        workers: int = 4,
        chunk: int = 64,
        gray: bool = False,
        window: Optional[int] = None,
    ):
        if callable(source):
            self._opener = source
        else:
            from tpuva_torch.io.file import load_any_video

            self._opener = lambda: load_any_video(source, gray=gray)
        self._probe = self._opener()  # metadata + random-access fallback
        super().__init__(
            self._probe.frame_count,
            self._probe.size,
            self._probe.fps,
            self._probe.is_color,
        )
        self._workers = max(1, int(workers))
        self._chunk = max(1, int(chunk))
        self._n_chunks = -(-self.frame_count // self._chunk)
        self._window = window or (self._workers + 2)
        self._cond = threading.Condition()
        self._chunks: dict[int, np.ndarray] = {}
        self._next_chunk = 0  # next chunk index to claim
        self._consumed = 0  # lowest chunk still being served
        self._stop = False
        self._error: Optional[BaseException] = None
        self._threads: list[threading.Thread] = []

    # --------------------------------------------------------------- workers
    def _start(self):
        if self._threads or self._n_chunks == 0:
            return
        for k in range(self._workers):
            t = threading.Thread(
                target=self._worker, name=f"pdecode-{k}", daemon=True
            )
            t.start()
            self._threads.append(t)

    def _worker(self):
        src = None
        try:
            src = self._opener()
            while True:
                with self._cond:
                    while (
                        not self._stop
                        and self._next_chunk < self._n_chunks
                        and self._next_chunk - self._consumed >= self._window
                    ):
                        self._cond.wait()
                    if self._stop or self._next_chunk >= self._n_chunks:
                        return
                    c = self._next_chunk
                    self._next_chunk += 1
                lo = c * self._chunk
                hi = min(self.frame_count, lo + self._chunk)
                frames = np.stack(
                    [src.get_frame(j) for j in range(lo, hi)]
                )
                with self._cond:
                    if self._stop:
                        return
                    self._chunks[c] = frames
                    self._cond.notify_all()
        except BaseException as e:  # noqa: BLE001 - relayed to consumer
            with self._cond:
                self._error = e
                self._cond.notify_all()
        finally:
            if src is not None:
                src.close()

    # --------------------------------------------------------------- access
    def get_frame(self, index: int) -> np.ndarray:
        if not 0 <= index < self.frame_count:
            raise IndexError(index)
        c = index // self._chunk
        if c < self._consumed:
            # behind the streaming frontier: dedicated fallback handle
            return self._probe.get_frame(index)
        self._start()
        with self._cond:
            # advancing past earlier chunks releases window slots
            if c > self._consumed:
                for k in range(self._consumed, c):
                    self._chunks.pop(k, None)
                self._consumed = c
                self._cond.notify_all()
            while c not in self._chunks and self._error is None:
                if self._stop:
                    raise RuntimeError("reader closed")
                self._cond.wait()
            if self._error is not None:
                raise self._error
            return self._chunks[c][index - c * self._chunk]

    def iter_batches(self, batch: int, pad_last: bool = False):
        """Ordered batches assembled from decoded chunks (the fast path
        feeding BatchStager)."""
        T = self.frame_count
        for start in range(0, T, batch):
            n = min(batch, T - start)
            stack = np.stack(
                [self.get_frame(start + i) for i in range(n)]
            )
            if pad_last and n < batch:
                stack = np.concatenate(
                    [stack, np.repeat(stack[-1:], batch - n, axis=0)]
                )
            yield n, stack

    def close(self):
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []
        self._probe.close()
