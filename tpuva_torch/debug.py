"""Interactive/debug display helpers (reference: video/debug.py —
show_image / show_video windows, SURVEY.md §2.1).

Headless-safe: with no display available (the normal case on a server),
images are written to files under TPUVA_DEBUG_DIR (default ./debug_out)
instead of opening windows.

The port's copy of ``tpuva/debug.py`` (held to its PNG bytes by
``tests/test_torch_analysis.py``); a tensor is copied to the host first.
"""

from __future__ import annotations

import os

import numpy as np

from tpuva_torch.utils import ensure_directory_exists

_counter = [0]


def _has_display() -> bool:
    return bool(os.environ.get("DISPLAY"))


def _host(image) -> np.ndarray:
    """A numpy array of image (a tensor on any device, or array-like)."""
    if hasattr(image, "detach"):
        return image.detach().cpu().numpy()
    return np.asarray(image)


def _dump(image: np.ndarray, name: str) -> str:
    import cv2

    out_dir = ensure_directory_exists(
        os.environ.get("TPUVA_DEBUG_DIR", "debug_out")
    )
    path = os.path.join(out_dir, f"{name}_{_counter[0]:04d}.png")
    _counter[0] += 1
    img = _host(image)
    if img.dtype != np.uint8:
        lo, hi = float(img.min()), float(img.max())
        scale = 255.0 / (hi - lo) if hi > lo else 1.0
        img = np.clip((img - lo) * scale, 0, 255).astype(np.uint8)
    cv2.imwrite(path, img)
    return path


def show_image(image, title: str = "image", wait: bool = True):
    """Display an image in a window, or dump it to a file when headless.
    Returns the file path when dumping, else None."""
    import cv2

    if not _has_display():
        return _dump(image, title.replace(" ", "_"))
    cv2.imshow(title, _host(image))
    if wait:
        cv2.waitKey(0)
        cv2.destroyWindow(title)
    return None


def show_video(video, title: str = "video", fps: float | None = None,
               max_dump_frames: int = 16):
    """Play a video in a window; headless: dump up to max_dump_frames
    evenly spaced frames."""
    import cv2

    if not _has_display():
        T = video.frame_count
        step = max(1, T // max_dump_frames)
        return [
            _dump(video.get_frame(i), title.replace(" ", "_"))
            for i in range(0, T, step)
        ]
    delay = int(1000 / (fps or video.fps or 25))
    for frame in video:
        cv2.imshow(title, frame)
        if cv2.waitKey(delay) & 0xFF == ord("q"):
            break
    cv2.destroyWindow(title)
    return None
