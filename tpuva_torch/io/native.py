"""ctypes bindings of the port's host library (``tpuva_torch/csrc/batcher.cpp``)
— the counterpart of ``tpuva/io/native.py``.

``NativeBatcher`` is a single-producer, single-consumer ring over batch
slots that the caller owns (the stager's pinned buffers on a card, plain
arrays on the CPU): ``push`` copies a frame once, into the next row of the
slot being filled, off the GIL; ``pop`` hands the consumer a sealed slot;
``release`` gives it back. ``bgr2gray`` is tpuva's 14-bit fixed-point
BGR->gray in C++, ``bgr2gray_plain`` the same arithmetic in numpy (both
within 1 of OpenCV 5's ``cvtColor``, which rounds 15-bit weights).

The library is built with the host compiler at first use
(``tpuva_torch._build.build_host``). Unlike tpuva, there is no numpy
fallback: where the build or the load fails, the call raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np


def load_library() -> ctypes.CDLL:
    """The host library, built at first use; raises if it cannot be."""
    from tpuva_torch import _build

    return _build.load_host()


def available() -> bool:
    """Whether the host library builds and loads here."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def _address(buf) -> int:
    """The data address of a C-contiguous numpy array or torch tensor."""
    if isinstance(buf, np.ndarray):
        if not buf.flags.c_contiguous:
            raise ValueError("slot is not C-contiguous")
        return buf.ctypes.data
    if not buf.is_contiguous():
        raise ValueError("slot is not contiguous")
    return buf.data_ptr()


class NativeBatcher:
    """Frame-batch ring over caller-owned slots (csrc/batcher.cpp).

    slots: batch buffers of (batch, *frame_shape) uint8 each, numpy arrays
    or CPU tensors (pinned on a card); they must outlive the ring, which
    keeps a reference. The producer pushes frames, then calls finish();
    the consumer pops (slot, n_valid) pairs — n_valid == 0 is the end of
    the stream — and releases each slot once it is done with its rows.
    close() aborts from either side and wakes both; destroy() frees the
    ring once neither side can call it again.
    """

    def __init__(self, frame_shape, batch: int, slots: Sequence):
        lib = load_library()
        self.frame_shape = tuple(int(d) for d in frame_shape)
        self.batch = int(batch)
        self._frame_bytes = int(np.prod(self.frame_shape))
        want = self.batch * self._frame_bytes
        for s in slots:
            nbytes = s.nbytes if isinstance(s, np.ndarray) else s.numel() * s.element_size()
            if nbytes != want:
                raise ValueError(f"slot of {nbytes} bytes; the ring needs {want}")
        self._slots = list(slots)  # keeps the memory alive
        ptrs = (ctypes.c_void_p * len(slots))(*[_address(s) for s in slots])
        self._lib = lib
        self._h = lib.tvt_ring_create(self._frame_bytes, self.batch, len(slots), ptrs)
        if not self._h:
            raise RuntimeError("tvt_ring_create refused its arguments")

    def push(self, frame: np.ndarray) -> None:
        """Copy one frame into the ring; blocks while every slot is taken.
        Raises once the ring is closed."""
        frame = np.ascontiguousarray(frame, np.uint8)
        if frame.nbytes != self._frame_bytes:
            raise ValueError(f"frame {frame.shape} != {self.frame_shape}")
        if self._lib.tvt_ring_push(self._h, frame.ctypes.data) != 0:
            raise RuntimeError("push on a closed ring")

    def finish(self) -> None:
        """End of the stream: seal the partial slot, padded by repeating
        its last frame (the producer's thread)."""
        self._lib.tvt_ring_finish(self._h)

    def pop(self):
        """(slot index, n_valid); n_valid == 0 at the end of the stream or
        once the ring is closed."""
        slot = ctypes.c_int(-1)
        n = self._lib.tvt_ring_pop(self._h, ctypes.byref(slot))
        return slot.value, n

    def release(self, slot: int) -> None:
        if self._lib.tvt_ring_release(self._h, slot) != 0:
            raise ValueError(f"slot {slot} out of range")

    @property
    def depth(self) -> int:
        """Slots sealed and waiting for the consumer."""
        return self._lib.tvt_ring_depth(self._h)

    def close(self) -> None:
        self._lib.tvt_ring_close(self._h)

    def destroy(self) -> None:
        """Free the ring. Only once no thread can call it again."""
        if self._h:
            self._lib.tvt_ring_destroy(self._h)
            self._h = None


def bgr2gray_plain(frame: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """tpuva's fixed-point BGR->gray in numpy (tpuva's numpy fallback)."""
    frame = np.ascontiguousarray(frame, np.uint8)
    h, w = frame.shape[:2]
    if out is None:
        out = np.empty((h, w), np.uint8)
    f = frame.astype(np.uint32)
    out[:] = (
        (1868 * f[..., 0] + 9617 * f[..., 1] + 4899 * f[..., 2] + 8192)
        >> 14
    ).astype(np.uint8)
    return out


def bgr2gray(frame: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """tpuva's fixed-point BGR->gray in C++ (off the GIL)."""
    lib = load_library()
    frame = np.ascontiguousarray(frame, np.uint8)
    if frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) BGR frame, got {frame.shape}")
    h, w = frame.shape[:2]
    if out is None:
        out = np.empty((h, w), np.uint8)
    if out.shape != (h, w) or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError("out must be a C-contiguous (H, W) uint8 array")
    lib.tvt_bgr2gray(frame.ctypes.data, out.ctypes.data, h * w)
    return out
