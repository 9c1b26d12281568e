"""Host -> device staging — port of ``tpuva/io/staging.py::BatchStager``.

Overlapped stages: a feeder thread assembles each padded batch in a slot
of a ring of host buffers and starts its copy to the device; the consumer
runs device work on the batches already delivered. The bounded queue
gives backpressure and bounds device memory (queue_depth batches in
flight); the ring has one slot more than the queue.

Each frame's bytes are copied once on the host, straight into its row of
a slot. The stager picks the feeder from its source: a ``VideoMemory``'s
rows go in as one block copy by the feeder thread; any other source (a
decoder: a file, a parallel reader, a pipe) is read by a decode thread
that pushes each frame through the C++ ring (``io/native.py::NativeBatcher``,
``csrc/batcher.cpp``) off the GIL, while the feeder pops sealed slots.
``use_native`` forces one feeder or the other; the Python feeder then
copies each frame from ``get_frame``. A tail batch is padded by repeating
its last frame. No batch is ever stacked on the host.

A filter chain (``tpuva_torch.filters.FilterBase``) is staged by its root:
the slots take the root's frames (a BGR root's (B, H, W, 3)), by the
feeder the root picks, and the chain's program (``filters.run_chain``) then
runs on each staged, padded batch on the device, with the carries kept
there, so the consumer gets the chain's output, as tpuva's stager gets
``FilterBase.iter_batches(pad_last=True)``'s; the first batch loses the
chain's ``first_batch_drop`` valid rows. The chain is never read frame by
frame.

On a CUDA device the slots are pinned host buffers and the feeder issues
``non_blocking`` copies on a side stream, with an event recorded after
each. The consumer's stream waits on that event before it touches the
batch (``wait_event``), and the batch is marked as used on the consumer's
stream (``record_stream``) so that the caching allocator does not hand its
memory out while that stream still reads it. A slot is refilled only
after the event of its previous copy has completed: the Python feeder
waits on it before it writes the slot again, the native feeder before it
releases the slot to the decode thread. On the CPU the slots are numpy
arrays and each batch is a copy of its slot.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch

from tpuva_torch.device import resolve_device
from tpuva_torch.io.base import VideoBase
from tpuva_torch.io.memory import VideoMemory

_SENTINEL = object()


class BatchStager:
    """Iterate (n_valid, batch) pairs for a video.

    batch is a (batch, H, W[, 3]) uint8 tensor on `device` (on a CUDA
    device: ready for work on the current stream of the thread that
    iterates); n_valid <= batch marks real rows (the tail batch is padded by
    repeating the last frame). The batches are assembled in the C++ ring
    (built with the host compiler at first use; raises if it cannot be
    built or loaded) for any source but a VideoMemory; use_native=True or
    False forces the ring or the Python feeder. A filter chain is staged by
    its root and its program run on each batch on `device` (the module's
    docstring): batch is then the chain's output, of its shape and dtype."""

    def __init__(self, video: VideoBase, batch: int, queue_depth: int = 2,
                 device="cuda", use_native: Optional[bool] = None):
        from tpuva_torch.filters import FilterBase  # filters imports io, which imports this

        self._device = resolve_device(device)
        self._chain = video if isinstance(video, FilterBase) else None
        if self._chain is not None:
            video = self._chain.chain()[0]  # the root is what is staged
            if self._chain.device != self._device:
                raise ValueError(f"BatchStager on {self._device}: the filter chain runs "
                                 f"on {self._chain.device}")
        self._video = video
        self._batch = batch
        self._cuda = self._device.type == "cuda"
        self._queue: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._nslots = queue_depth + 1
        self._error: Optional[BaseException] = None
        self._decode_error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._ring = None  # the NativeBatcher, while the native feeder holds it
        self._ring_lock = threading.Lock()
        self._decoder: Optional[threading.Thread] = None
        self._carries = None  # the chain's, on the device, from its first batch
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(self._device)
        # a VideoMemory is one block copy a batch; a decoder's frames go
        # through the ring, pushed by a thread of their own off the GIL
        self.native = type(video) is not VideoMemory if use_native is None else use_native
        target = self._feeder_native if self.native else self._feeder
        self._thread = threading.Thread(target=target, name="batch-stager", daemon=True)
        self._started = False

    # ---------------------------------------------------------------- slots
    def _new_slots(self) -> list:
        v = self._video
        shape = (self._batch, v.height, v.width) + ((3,) if v.is_color else ())
        if self._cuda:
            return [torch.empty(shape, dtype=torch.uint8, pin_memory=True)
                    for _ in range(self._nslots)]
        return [np.empty(shape, np.uint8) for _ in range(self._nslots)]

    def _stage(self, slot):
        """Start the slot's copy to the device: (batch, event) on a card,
        a tensor holding a copy of the slot on the CPU."""
        if not self._cuda:
            return torch.from_numpy(slot.copy())
        with torch.cuda.stream(self._copy_stream):
            dev = torch.empty(slot.shape, dtype=torch.uint8, device=self._device)
            dev.copy_(slot, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return dev, event

    def _filtered(self, n: int, item):
        """(n, item) as the consumer gets it: without a chain as staged;
        with one, the chain's program on the staged batch (on a card on the
        copy stream, after the copy, with the event of its output recorded
        after it), n less the chain's first-batch drop."""
        if self._chain is None:
            return n, item
        if self._carries is None:  # the first batch
            n -= self._chain.chain_drop
        if not self._cuda:
            out = self._run_chain(item)
            return max(0, min(n, out.shape[0])), out
        with torch.cuda.stream(self._copy_stream):
            out = self._run_chain(item[0])
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return max(0, min(n, out.shape[0])), (out, event)

    def _run_chain(self, batch):
        from tpuva_torch.filters import run_chain

        if self._carries is None:
            self._carries = self._chain.init_carries()
        out, self._carries = run_chain(self._chain, batch, self._carries)
        return out

    def _put(self, item) -> bool:
        """Queue an item for the consumer; False once close() stopped the
        stager (the consumer no longer reads)."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    # -------------------------------------------------------------- feeders
    def _feeder(self):
        """Python feeder: each frame from get_frame straight into its row
        of the slot; a VideoMemory's rows as one block (one copy of the
        same bytes, which the memcpy of a large block makes with stores
        that bypass the cache)."""
        try:
            if self._cuda:
                torch.cuda.set_device(self._device)
            slots = self._new_slots()
            events: list = [None] * len(slots)
            v, B = self._video, self._batch
            T = v.frame_count
            for k, start in enumerate(range(0, T, B)):
                if self._stop.is_set():
                    return
                s = k % len(slots)
                if events[s] is not None:
                    events[s].synchronize()  # its last copy has landed
                buf = slots[s].numpy() if self._cuda else slots[s]
                n = min(B, T - start)
                if type(v) is VideoMemory:  # its frames are rows of one array
                    np.copyto(buf[:n], v.data[start:start + n])
                else:
                    for i in range(n):
                        buf[i] = v.get_frame(start + i)
                buf[n:] = buf[n - 1]
                item = self._stage(slots[s])
                if self._cuda:
                    events[s] = item[1]
                if not self._put(self._filtered(n, item)):
                    return
            self._put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            self._error = e
            self._put(_SENTINEL)

    def _decode(self, ring) -> None:
        """The native feeder's decode thread: every frame into the ring."""
        try:
            for frame in self._video:
                if self._stop.is_set():
                    break
                ring.push(frame)
            ring.finish()
        except BaseException as e:  # noqa: BLE001 - relayed by the feeder
            self._decode_error = e
            ring.close()

    def _feeder_native(self):
        """Native feeder: a decode thread pushes frames into the C++ ring,
        this thread pops sealed slots, copies each to the device and
        releases the slot once its copy has completed. This thread frees
        the ring, after the decode thread has joined, on every way out."""
        from tpuva_torch.io.native import NativeBatcher

        ring = decoder = None
        try:
            if self._cuda:
                torch.cuda.set_device(self._device)
            slots = self._new_slots()
            frame_shape = tuple(slots[0].shape[1:])
            with self._ring_lock:
                if self._stop.is_set():
                    return
                ring = self._ring = NativeBatcher(frame_shape, self._batch, slots)
            decoder = self._decoder = threading.Thread(
                target=self._decode, args=(ring,), name="stager-decoder", daemon=True)
            decoder.start()
            while True:
                s, n = ring.pop()
                if n == 0:
                    break
                item = self._stage(slots[s])
                if self._cuda:
                    item[1].synchronize()  # the copy has read the slot
                ring.release(s)
                if not self._put(self._filtered(n, item)):
                    return
            decoder.join()
            if self._decode_error is not None:
                raise self._decode_error
            self._put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            self._error = e
            self._put(_SENTINEL)
        finally:
            if ring is not None:
                ring.close()  # wakes a decode thread blocked on a slot
                if decoder is not None:
                    decoder.join()
                with self._ring_lock:
                    self._ring = None
                    ring.destroy()

    # ------------------------------------------------------------- consumer
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
        """Stop the threads, a producer blocked on a full ring or queue
        included. The native feeder's thread frees the ring once its
        decode thread has joined."""
        self._stop.set()
        with self._ring_lock:
            if self._ring is not None:
                self._ring.close()  # wakes both sides of the ring
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._started:
            self._thread.join(timeout=5)
