"""The port's host I/O (tpuva_torch/io) against tpuva's on the CPU.

The staging ring: both feeders of ``BatchStager`` (the Python one, each
frame from ``get_frame`` into its slot, and the native one, a decode
thread through ``csrc/batcher.cpp``, built with the host compiler) give
tpuva's ``iter_batches(pad_last=True)`` batches, padded tail included;
a slow consumer at queue depth 1 sees every batch intact; errors reach
the consumer; ``close()`` returns while the producer is blocked; no batch
is ever stacked. Then ``bgr2gray``, and every video source the port
copies, frame for frame against tpuva's on the same files and seeds.
"""

import glob
import os
import threading
import time

import cv2
import numpy as np
import pytest
import torch

import tpuva.io as jio
import tpuva.io.native as jnative
import tpuva.io.synthetic as jsynthetic
import tpuva_torch.io as tio
import tpuva_torch.io.native as tnative
import tpuva_torch.io.synthetic as tsynthetic
from tpuva_torch import _build
from tpuva_torch.io.staging import BatchStager
from test_torch_kernels import one_torch_thread  # noqa: F401

FEEDERS = {"python": False, "native": True}
# (frames, batch, color): T < batch, T % batch == 0, T == 1, a ragged
# tail, color frames
LENGTHS = {"T<batch": (5, 8, False), "T%batch==0": (16, 8, False), "T==1": (1, 8, False),
           "ragged": (21, 8, False), "color": (11, 4, True)}


def make_clip(T, color=False, H=6, W=10, seed=0):
    shape = (T, H, W, 3) if color else (T, H, W)
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def stage_all(video, batch, native, queue_depth=2, consume=None):
    st = BatchStager(video, batch, queue_depth=queue_depth, device="cpu", use_native=native)
    got = []
    try:
        for n, b in st:
            if consume is not None:
                consume()
            got.append((n, b.numpy().copy()))
    finally:
        st.close()
    return got


@pytest.mark.parametrize("length", sorted(LENGTHS))
@pytest.mark.parametrize("feeder", sorted(FEEDERS))
def test_feeders_match_tpuva_iter_batches(feeder, length):
    T, B, color = LENGTHS[length]
    clip = make_clip(T, color)
    ref = list(jio.VideoMemory(clip).iter_batches(B, pad_last=True))
    got = stage_all(tio.VideoMemory(clip), B, FEEDERS[feeder])
    assert [n for n, _ in got] == [n for n, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        assert a.shape == b.shape and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


class CountingVideo(tio.VideoMemory):
    """Every frame distinct (its index in its first bytes); iter_batches and
    to_array raise: the stager must never stack a batch."""

    def iter_batches(self, batch, pad_last=False):
        raise AssertionError("the stager stacked a batch")

    def to_array(self):
        raise AssertionError("the stager stacked the video")


def counting_clip(T, H=8, W=12):
    clip = np.random.default_rng(T).integers(0, 256, (T, H, W), dtype=np.uint8)
    clip[:, 0, :4] = np.arange(T, dtype=np.uint32)[:, None].view(np.uint8).reshape(T, 4)
    return clip


@pytest.mark.parametrize("feeder", sorted(FEEDERS))
def test_slow_consumer_depth_one_sees_every_batch(feeder):
    """Queue depth 1 (two slots), a consumer that sleeps on every batch and
    a fast producer: a slot rewritten before its batch left it would show
    as a wrong frame."""
    clip = counting_clip(83)
    got = stage_all(CountingVideo(clip), 4, FEEDERS[feeder], queue_depth=1,
                    consume=lambda: time.sleep(0.002))
    ref = list(jio.VideoMemory(clip).iter_batches(4, pad_last=True))
    assert len(got) == len(ref) == 21
    for (n, a), (m, b) in zip(got, ref):
        assert n == m
        np.testing.assert_array_equal(a, b)


class FailingVideo(tio.VideoMemory):
    def __init__(self, data, fail_at):
        super().__init__(data)
        self.fail_at = fail_at

    def get_frame(self, index):
        if index == self.fail_at:
            raise IOError(f"decode failed at frame {index}")
        return super().get_frame(index)


@pytest.mark.parametrize("feeder", sorted(FEEDERS))
def test_errors_reach_the_consumer(feeder):
    st = BatchStager(FailingVideo(make_clip(40), 13), 4, device="cpu",
                     use_native=FEEDERS[feeder])
    seen = []
    with pytest.raises(IOError, match="frame 13"):
        for n, _b in st:
            seen.append(n)
    st.close()
    assert seen == [4, 4, 4][:len(seen)] and not st._thread.is_alive()


@pytest.mark.parametrize("feeder", sorted(FEEDERS))
def test_close_returns_while_the_producer_is_blocked(feeder):
    st = BatchStager(tio.VideoMemory(make_clip(400)), 2, queue_depth=1, device="cpu",
                     use_native=FEEDERS[feeder])
    it = iter(st)
    next(it)
    time.sleep(0.1)  # the producer fills the ring and blocks
    if FEEDERS[feeder]:
        ring = st._ring
        assert ring.depth >= 1 and st._decoder.is_alive()
    t0 = time.monotonic()
    st.close()
    assert time.monotonic() - t0 < 2.0
    assert not st._thread.is_alive()
    if FEEDERS[feeder]:
        # the feeder thread freed the ring after the decode thread joined
        assert not st._decoder.is_alive() and ring._h is None and st._ring is None


class DecodedVideo(tio.VideoBase):
    """A decoder's shape of source: frames only through get_frame."""

    def __init__(self, data):
        super().__init__(data.shape[0], (data.shape[2], data.shape[1]), 25.0, data.ndim == 4)
        self.data = data

    def get_frame(self, index):
        return self.data[index]


@pytest.mark.parametrize("source", ["memory", "decoded", "slice", "synthetic", "forced"])
def test_feeder_follows_the_source(source):
    """A VideoMemory is one block copy a batch (the Python feeder); every
    other source goes through the C++ ring; use_native forces either. The
    batches are tpuva's iter_batches(pad_last=True) whichever it takes."""
    clip = make_clip(13)
    video, native = {
        "memory": (tio.VideoMemory(clip), False),
        "decoded": (DecodedVideo(clip), True),
        "slice": (tio.VideoMemory(np.concatenate([clip[:2], clip]))[2:], True),
        "synthetic": (tsynthetic.SyntheticVideo(h=24, w=32, frames=13, radius=3, seed=3), True),
        "forced": (DecodedVideo(clip), False),
    }[source]
    st = BatchStager(video, 4, device="cpu",
                     **({"use_native": False} if source == "forced" else {}))
    assert st.native is native
    try:
        got = [(n, b.numpy().copy()) for n, b in st]
    finally:
        st.close()
    ref = list(jio.VideoMemory(np.stack([video.get_frame(i) for i in range(13)]))
               .iter_batches(4, pad_last=True))
    assert [n for n, _ in got] == [n for n, _ in ref] == [4, 4, 4, 1]
    for (_, a), (_, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_ring_freed_without_close():
    """A native stager iterated to its end and never closed still frees its
    ring: the feeder thread does, once its decode thread has joined."""
    st = BatchStager(DecodedVideo(make_clip(9)), 4, device="cpu")
    it = iter(st)
    next(it)
    ring = st._ring
    assert st.native and ring is not None
    assert [next(it)[0], next(it)[0]] == [4, 1]
    with pytest.raises(StopIteration):
        next(it)
    st._thread.join(timeout=5)
    assert not st._thread.is_alive() and not st._decoder.is_alive()
    assert ring._h is None and st._ring is None


def test_native_failed_build_or_load_raises(monkeypatch, tmp_path):
    # a compiler that fails: build_host raises, nothing is left behind
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="host compiler failed"):
        _build.build_host()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="host compiler failed"):
        _build.build_host()
    assert not list(tmp_path.glob("*.so"))

    # a load that fails: native staging raises instead of falling back
    def refuse():
        raise OSError("cannot load the host library")

    monkeypatch.setattr(_build, "load_host", refuse)
    assert not tnative.available()
    st = BatchStager(tio.VideoMemory(make_clip(5)), 4, device="cpu", use_native=True)
    with pytest.raises(OSError, match="cannot load"):
        list(st)
    st.close()
    with pytest.raises(OSError):
        tnative.bgr2gray(make_clip(1, color=True)[0])


def test_native_ring_protocol():
    """NativeBatcher alone: a frame into each row, the tail padded, slots
    only back through release(), checked sizes, close wakes a blocked push."""
    frame_shape, B = (3, 5), 4
    slots = [np.zeros((B,) + frame_shape, np.uint8) for _ in range(2)]
    ring = tnative.NativeBatcher(frame_shape, B, slots)
    frames = make_clip(6, H=3, W=5)
    for f in frames:
        ring.push(f)
    ring.finish()
    s0, n0 = ring.pop()
    s1, n1 = ring.pop()
    assert (n0, n1) == (4, 2) and {s0, s1} == {0, 1} and ring.pop()[1] == 0
    np.testing.assert_array_equal(slots[s0], frames[:4])
    np.testing.assert_array_equal(slots[s1], np.concatenate([frames[4:], frames[5:]] + [frames[5:]]))
    with pytest.raises(ValueError):
        ring.release(2)
    with pytest.raises(ValueError):
        ring.push(np.zeros((3, 4), np.uint8))
    ring.destroy()
    with pytest.raises(ValueError):
        tnative.NativeBatcher(frame_shape, B, [np.zeros((B, 3, 4), np.uint8)])

    # both slots full and not released: the producer blocks until close
    ring = tnative.NativeBatcher(frame_shape, 1, [np.zeros((1,) + frame_shape, np.uint8)] * 2)
    errors = []

    def produce():
        try:
            for f in frames:
                ring.push(f)
        except RuntimeError as e:
            errors.append(e)

    t = threading.Thread(target=produce)
    t.start()
    time.sleep(0.05)
    assert t.is_alive() and ring.depth == 2
    ring.close()
    t.join(timeout=5)
    assert not t.is_alive() and errors and ring.pop()[1] == 0
    ring.destroy()


def test_bgr2gray_native_equals_plain_tpuva_and_cv2():
    img = np.random.default_rng(1).integers(0, 256, (40, 56, 3), np.uint8)
    native = tnative.bgr2gray(img)
    np.testing.assert_array_equal(native, tnative.bgr2gray_plain(img))
    np.testing.assert_array_equal(native, jnative.bgr2gray(img))
    out = np.empty((40, 56), np.uint8)
    assert tnative.bgr2gray(img, out) is out
    np.testing.assert_array_equal(out, native)
    # tpuva's 14-bit weights are within 1 of cv2's rounding (tpuva's own
    # bound, tests/test_native.py): the port carries tpuva's arithmetic
    ref = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    assert np.abs(native.astype(int) - ref.astype(int)).max() <= 1


# ------------------------------------------------------------ video sources
def write_avi(path, clip, fps=25.0):
    with jio.VideoFileWriter(str(path), fps=fps) as w:
        for f in clip:
            w.write_frame(f)


def frames_of(video, order=None):
    idx = range(video.frame_count) if order is None else order
    return np.stack([video.get_frame(i) for i in idx])


def assert_same_video(a, b, order=None):
    assert (a.frame_count, a.size, a.is_color) == (b.frame_count, b.size, b.is_color)
    np.testing.assert_array_equal(frames_of(a, order), frames_of(b, order))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two encoded gray clips (the second 7 frames), a directory of PNGs."""
    d = tmp_path_factory.mktemp("io")
    clip = make_clip(13, H=48, W=64, seed=3)
    write_avi(d / "rec_1.avi", clip)
    write_avi(d / "rec_2.avi", make_clip(7, H=48, W=64, seed=4))
    img_dir = d / "imgs"
    img_dir.mkdir()
    for i in range(5):
        cv2.imwrite(str(img_dir / f"img_{i}.png"), clip[i])
    return d


class BadFrames(tio.VideoMemory):
    def get_frame(self, index):
        if index in (0, 3, 4):
            raise IOError(f"bad frame {index}")
        return super().get_frame(index)


class JBadFrames(jio.VideoMemory):
    def get_frame(self, index):
        if index in (0, 3, 4):
            raise IOError(f"bad frame {index}")
        return super().get_frame(index)


SOURCES = ["file_color", "file_gray", "file_backward", "stack_glob", "stack_list",
           "any_file", "any_glob", "any_dir", "any_image_list", "robust", "pipe", "fork",
           "parallel_1", "parallel_3", "parallel_backward", "parallel_callable",
           "synthetic"]


@pytest.mark.parametrize("source", SOURCES)
def test_sources_match_tpuva(files, source):
    d = str(files)
    one, both = os.path.join(d, "rec_1.avi"), os.path.join(d, "rec_*.avi")
    imgs = sorted(glob.glob(os.path.join(d, "imgs", "*.png")))
    if source in ("file_color", "file_gray", "file_backward"):
        gray = source != "file_color"
        order = [5, 6, 2, 0, 12, 11] if source == "file_backward" else None
        assert_same_video(tio.VideoFile(one, gray=gray), jio.VideoFile(one, gray=gray), order)
    elif source == "stack_glob":
        a, b = tio.VideoFileStack(both, gray=True), jio.VideoFileStack(both, gray=True)
        assert a.frame_count == 20
        assert_same_video(a, b, [0, 12, 13, 19, 5, 14])
    elif source == "stack_list":
        paths = sorted(glob.glob(both))
        assert_same_video(tio.VideoFileStack(paths), jio.VideoFileStack(paths))
    elif source.startswith("any_"):
        arg = {"any_file": one, "any_glob": both, "any_dir": os.path.join(d, "imgs"),
               "any_image_list": imgs}[source]
        a, b = tio.load_any_video(arg, gray=True), jio.load_any_video(arg, gray=True)
        assert type(a).__name__ == type(b).__name__
        assert_same_video(a, b)
    elif source == "robust":
        clip = make_clip(6)
        a, b = tio.RobustVideo(BadFrames(clip)), jio.RobustVideo(JBadFrames(clip))
        assert_same_video(a, b)
        assert a.errors == b.errors and len(a.errors) == 3
        with pytest.raises(IOError):
            tio.RobustVideo(BadFrames(clip), on_error="raise").get_frame(3)
    elif source == "pipe":
        a, b = tio.VideoPipe(tio.VideoFile(one)), jio.VideoPipe(jio.VideoFile(one))
        np.testing.assert_array_equal(np.stack(list(a)), np.stack(list(b)))
        a.close()
        b.close()
    elif source == "fork":
        clip = make_clip(9)
        fa, fb = tio.VideoFork(tio.VideoMemory(clip), clients=2, max_skew=4), \
            jio.VideoFork(jio.VideoMemory(clip), clients=2, max_skew=4)
        for i in range(9):  # skewed by up to 3 frames, in lock step
            for k, j in ((0, min(i + 3, 8)), (1, i)):
                np.testing.assert_array_equal(fa[k].get_frame(j), fb[k].get_frame(j))
        with pytest.raises(RuntimeError):
            tio.VideoFork(tio.VideoMemory(clip), clients=2, max_skew=2)[0].get_frame(5)
    elif source.startswith("parallel"):
        if source == "parallel_callable":
            clip = make_clip(29)
            a = tio.ParallelVideoReader(lambda: tio.VideoMemory(clip), workers=3, chunk=4)
            b = jio.ParallelVideoReader(lambda: jio.VideoMemory(clip), workers=3, chunk=4)
        else:
            workers = 1 if source == "parallel_1" else 3
            # chunk 3 does not divide the 20 frames
            a = tio.ParallelVideoReader(both, workers=workers, chunk=3, gray=True)
            b = jio.ParallelVideoReader(both, workers=workers, chunk=3, gray=True)
        order = None
        if source == "parallel_backward":
            order = list(range(12)) + [2, 0, 11, 19, 1]
        try:
            assert_same_video(a, b, order)
        finally:
            a.close()
            b.close()
    elif source == "synthetic":
        kw = dict(h=60, w=80, frames=30, n_blobs=3, radius=6.0, seed=5)
        a, b = tsynthetic.SyntheticVideo(**kw), jsynthetic.SyntheticVideo(**kw)
        assert_same_video(a, b, [0, 29, 7, 7, 13])
        np.testing.assert_array_equal(a.positions(17), b.positions(17))
    else:
        raise AssertionError(source)


@pytest.mark.parametrize("writer", ["port", "tpuva"])
def test_video_file_writer_round_trip(tmp_path, writer):
    """A file written by either package reads back the same in both; the
    two writers' files decode to the same frames."""
    yy, xx = np.mgrid[:32, :48]
    gray = np.stack([(2 * xx + 3 * yy + 9 * t) % 256 for t in range(6)]).astype(np.uint8)
    color = np.stack([gray, 255 - gray, gray // 2], axis=-1)
    W = tio.VideoFileWriter if writer == "port" else jio.VideoFileWriter
    for name, clip in (("gray", gray), ("color", color)):
        path = str(tmp_path / f"{name}.avi")
        with W(path, fps=20.0) as w:
            w.write_video(tio.VideoMemory(clip))
            assert w.frames_written == 6
        other = str(tmp_path / f"{name}_other.avi")
        with (jio.VideoFileWriter if writer == "port" else tio.VideoFileWriter)(other, fps=20.0) as w:
            for f in clip:
                w.write_frame(f)
        a, b = tio.VideoFile(path, gray=name == "gray"), jio.VideoFile(path, gray=name == "gray")
        assert a.fps == b.fps == 20.0
        assert_same_video(a, b)
        assert_same_video(a, tio.VideoFile(other, gray=name == "gray"))
        # MJPG is lossy: the round trip lands near the source
        assert np.abs(frames_of(a).astype(int) - clip.astype(int)).mean() < 8


@pytest.mark.parametrize("feeder", sorted(FEEDERS))
def test_stager_over_an_encoded_file(files, feeder):
    """The stager over a VideoFile (gray, sequential decode) gives tpuva's
    batches of the same file."""
    path = os.path.join(str(files), "rec_1.avi")
    ref = list(jio.VideoFile(path, gray=True).iter_batches(4, pad_last=True))
    got = stage_all(tio.VideoFile(path, gray=True), 4, FEEDERS[feeder])
    assert [n for n, _ in got] == [n for n, _ in ref] == [4, 4, 4, 1]
    for (_, a), (_, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert torch.get_num_threads() == 1  # one_torch_thread holds
