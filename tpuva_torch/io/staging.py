"""Host -> device staging — port of ``tpuva/io/staging.py::BatchStager``.

Two overlapped stages: a feeder thread assembles each padded batch from the
video and starts its copy to the device; the consumer runs device work on
the batches already delivered. The bounded queue gives backpressure and
bounds host memory (queue_depth batches in flight).

On a CUDA device the feeder fills a ring of pinned host buffers and
issues ``non_blocking`` copies on a side stream, with an event recorded
after each. The consumer's stream waits on that event before it touches
the batch (``wait_event``), and the batch is marked as used on the
consumer's stream (``record_stream``) so that the caching allocator does
not hand its memory out while that stream still reads it. A pinned buffer
is refilled only after the event of its previous copy has completed. On
the CPU the batch is a copy of the stack.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch

from tpuva_torch.device import resolve_device
from tpuva_torch.io.base import VideoBase

_SENTINEL = object()


class BatchStager:
    """Iterate (n_valid, batch) pairs for a video.

    batch is a (batch, H, W[, 3]) uint8 tensor on `device` (on a CUDA
    device: ready for work on the current stream of the thread that
    iterates); n_valid <= batch marks real rows (the tail batch is padded by
    repeating the last frame). The decoder-backed ``use_native`` path of
    tpuva is not ported yet and raises."""

    def __init__(self, video: VideoBase, batch: int, queue_depth: int = 2,
                 device="cuda", use_native: bool = False):
        if use_native:
            raise NotImplementedError("BatchStager(use_native=True) is not ported yet")
        self._video = video
        self._batch = batch
        self._device = resolve_device(device)
        self._queue: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._cuda = self._device.type == "cuda"
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(self._device)
            # one more buffer than the queue holds: the feeder fills one
            # while queue_depth batches wait
            self._ring: list = [None] * (queue_depth + 1)
            self._ring_events: list = [None] * (queue_depth + 1)
        self._thread = threading.Thread(target=self._feeder, name="batch-stager", daemon=True)
        self._started = False

    def _put_device(self, k: int, stack: np.ndarray):
        if not self._cuda:
            return torch.from_numpy(np.array(stack))
        slot = k % len(self._ring)
        if self._ring_events[slot] is not None:
            self._ring_events[slot].synchronize()  # its last copy has landed
        buf = self._ring[slot]
        if buf is None or tuple(buf.shape) != stack.shape:
            buf = torch.empty(stack.shape, dtype=torch.uint8, pin_memory=True)
            self._ring[slot] = buf
        np.copyto(buf.numpy(), stack)
        with torch.cuda.stream(self._copy_stream):
            dev = torch.empty(stack.shape, dtype=torch.uint8, device=self._device)
            dev.copy_(buf, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        self._ring_events[slot] = event
        return dev, event

    def _feeder(self):
        try:
            if self._cuda:
                torch.cuda.set_device(self._device)
            for k, (n, stack) in enumerate(self._video.iter_batches(self._batch, pad_last=True)):
                if self._stop.is_set():
                    return
                self._queue.put((n, self._put_device(k, stack)))
            self._queue.put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            self._error = e
            self._queue.put(_SENTINEL)

    def __iter__(self):
        if self._started:
            raise RuntimeError("BatchStager supports a single pass")
        self._started = True
        self._thread.start()
        return self

    def __next__(self):
        item = self._queue.get()
        if item is _SENTINEL:
            if self._error is not None:
                raise self._error
            raise StopIteration
        n, batch = item
        if self._cuda:
            batch, event = batch
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            batch.record_stream(stream)
        return n, batch

    @property
    def depth(self) -> int:
        return self._queue.qsize()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._started:
            self._thread.join(timeout=5)
