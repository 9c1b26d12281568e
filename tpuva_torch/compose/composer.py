"""Debug-movie writer with drawing primitives (L4, reference:
video/composer.py — VideoComposer, SURVEY.md §2.1/§3.4).

Holds a "current frame" canvas, exposes drawing primitives (lines,
circles, rectangles, points, text, alpha-blended overlays) and encodes the
canvas when advanced. Host-side by design: it consumes device results
(masks, tracks) after transfer and is off the metric path — the
reference's best observability idea (SURVEY.md §5.5), kept intact.

The port's copy of ``tpuva/compose/composer.py`` (cv2 imported when a
frame is drawn or encoded); ``tests/test_torch_app.py`` holds the pass-4
movie it writes to tpuva's.
"""

from __future__ import annotations

import numpy as np

from tpuva_torch.io.file import VideoFileWriter


class VideoComposer(VideoFileWriter):
    def __init__(self, path, size=None, fps: float = 25.0, is_color=True,
                 background=None, codec=None, zoom: float = 1.0):
        super().__init__(path, size=size, fps=fps, is_color=is_color,
                         codec=codec)
        self.zoom = float(zoom)
        self._frame: np.ndarray | None = None
        if background is not None:
            self.set_frame(background)

    # --------------------------------------------------------------- canvas
    @property
    def frame(self) -> np.ndarray:
        if self._frame is None:
            raise RuntimeError("no current frame; call set_frame first")
        return self._frame

    def _to_canvas(self, image: np.ndarray) -> np.ndarray:
        import cv2

        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = np.clip(np.round(img), 0, 255).astype(np.uint8)
        if self._is_color in (None, True) and img.ndim == 2:
            img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
        if self.zoom != 1.0:
            img = cv2.resize(
                img, None, fx=self.zoom, fy=self.zoom,
                interpolation=cv2.INTER_NEAREST,
            )
        return img

    def set_frame(self, image: np.ndarray, copy: bool = True):
        """Start the next output frame from `image` (advancing: encodes the
        previous canvas first, reference semantics)."""
        if self._frame is not None:
            self.write_frame(self._frame)
        img = self._to_canvas(image)
        self._frame = img.copy() if copy else img

    def advance(self):
        """Encode the current canvas and keep it for further drawing."""
        self.write_frame(self.frame)

    # ------------------------------------------------------------- drawing
    def _pt(self, p):
        return (int(round(p[0] * self.zoom)), int(round(p[1] * self.zoom)))

    def add_image(self, image, alpha: float = 0.5, rect=None):
        """Alpha-blend an overlay image onto the canvas (optionally into
        rect=(x, y, w, h))."""
        import cv2

        overlay = self._to_canvas(image)
        canvas = self.frame
        if rect is not None:
            x, y, w, h = (int(round(v * self.zoom)) for v in rect)
            overlay = cv2.resize(overlay, (w, h))
            roi = canvas[y : y + h, x : x + w]
            canvas[y : y + h, x : x + w] = cv2.addWeighted(
                roi, 1 - alpha, overlay, alpha, 0
            )
        else:
            self._frame = cv2.addWeighted(canvas, 1 - alpha, overlay, alpha, 0)

    def add_line(self, p0, p1, color=(0, 0, 255), width: int = 1):
        import cv2

        cv2.line(self.frame, self._pt(p0), self._pt(p1), color, width)

    def add_curve(self, points, color=(0, 0, 255), width: int = 1,
                  closed: bool = False):
        import cv2

        pts = np.asarray(
            [[self._pt(p)] for p in points], np.int32
        )
        cv2.polylines(self.frame, [pts], closed, color, width)

    def add_circle(self, center, radius: int = 3, color=(0, 0, 255),
                   filled: bool = True, width: int = 1):
        import cv2

        cv2.circle(
            self.frame,
            self._pt(center),
            int(round(radius * self.zoom)),
            color,
            -1 if filled else width,
        )

    def add_rectangle(self, rect, color=(0, 0, 255), width: int = 1):
        x, y, w, h = rect
        import cv2

        cv2.rectangle(
            self.frame, self._pt((x, y)), self._pt((x + w, y + h)), color, width
        )

    def add_points(self, points, radius: int = 1, color=(0, 0, 255)):
        for p in points:
            self.add_circle(p, radius, color, filled=True)

    def add_text(self, text, pos, color=(255, 255, 255), size: float = 0.5):
        import cv2

        cv2.putText(
            self.frame, str(text), self._pt(pos),
            cv2.FONT_HERSHEY_SIMPLEX, size, color, 1, cv2.LINE_AA,
        )

    # -------------------------------------------------------------- closing
    def close(self):
        if self._frame is not None:
            self.write_frame(self._frame)
            self._frame = None
        super().close()


def annotate_tracks(
    composer: VideoComposer,
    clip,
    rows,
    color_cycle=((0, 0, 255), (0, 255, 0), (255, 0, 0), (0, 255, 255),
                 (255, 0, 255), (255, 255, 0)),
    trail: int = 25,
):
    """Convenience: render a tracked clip with per-track colored markers and
    trails from trajectory rows (the rebuild of the reference's pass-4
    debug movie)."""
    by_frame: dict[int, list] = {}
    history: dict[int, list] = {}
    for tid, frame, x, y, area in rows:
        by_frame.setdefault(int(frame), []).append((int(tid), x, y))
    for t, frame in enumerate(clip):
        composer.set_frame(frame)
        for tid, x, y in by_frame.get(t, []):
            hist = history.setdefault(tid, [])
            hist.append((x, y))
            color = color_cycle[(tid - 1) % len(color_cycle)]
            composer.add_circle((x, y), 4, color, filled=False)
            composer.add_text(str(tid), (x + 6, y - 6), color)
            if len(hist) > 1:
                composer.add_curve(hist[-trail:], color)
    composer.close()
