"""Lazy filter chain — port of ``tpuva/filters.py``.

Filters compose by nesting, as in tpuva:

    FilterBlur(FilterMonochrome(FilterCrop(video, rect)), 3)

and every filter is a video (``VideoBase``), so anything that consumes a
video consumes a chain. Each filter declares ``batch_transform(batch,
carry) -> batch`` or ``(batch, carry)`` over (N, H, W[, 3]) tensors; the
chain runs its filters root first as one program a batch (``run_chain``):
``iter_batches`` over the root's batches, and ``io.staging.BatchStager``
over batches it staged on the card, with the carries kept there.
``get_frame`` applies this filter alone to ``source.get_frame(index)``,
recursively, as tpuva's does.

Every filter takes ``device`` (default ``"cuda"``, through
``resolve_device``; a filter over a filter inherits its source's); one
chain runs on one device. The dtype and the device choose each filter's
route, nothing else: on a CUDA tensor, ``FilterBlur`` on uint8 launches
kernel K1b (``ops.wide.blur_u8``) once a batch, ``FilterMedian`` on uint8
kernel K7 (``ops.median.median_u8``, through ``ops.filters.median_blur``)
once a batch, ``FilterBackground`` on a uint8 (N, H, W) batch kernel K1's
diff emit (``ops.fused_segment``) once a batch, ``FilterMonochrome``
kernel KM (``ops.color.bgr_to_gray``), ``FilterResize`` kernel KR
(``ops.resize.resize_linear``), ``FilterRotate(angle=)`` and
``FilterWarpAffine`` kernel KW (``ops.warp.warp_affine``) once a batch;
on float32, ``FilterBlur`` kernel KG (``ops.filters.gaussian_blur``) and
``FilterBackground`` kernel KS in its sequential order
(``ops.background.background_scan``) once a batch; the other filters are
torch ops. CPU tensors run the plain versions of the same functions.

Arithmetic: every float32 product and sum is rounded on its own, in
tpuva's source order. Where tpuva's XLA:CPU run contracts one into an FMA
(the BGR weights of ``FilterMonochrome``, the background update, the float
blur's taps, the warp, the resize's taps) it can differ by a rounding
step: ROADMAP Queue 3 R1 and R5. ``FilterNormalize`` multiplies by the
float32 reciprocal of its range, as XLA rewrites tpuva's division by a
constant, and ``FilterResize`` applies jax.image.resize's weights
(computed on the host, ``ops.resize.resize_taps``) as two gathered taps
an axis, H before W.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tpuva_torch.device import resolve_device
from tpuva_torch.io.base import VideoBase
from tpuva_torch.ops.background import background_scan
from tpuva_torch.ops.color import BGR_WEIGHTS as _BGR_WEIGHTS  # noqa: F401 (tpuva's name)
from tpuva_torch.ops.color import bgr_to_gray
from tpuva_torch.ops.filters import gaussian_blur, median_blur
from tpuva_torch.ops.fused_segment import fused_segment
from tpuva_torch.ops.resize import resize_linear, resize_taps  # noqa: F401 (re-exported)
from tpuva_torch.ops.warp import rotation_matrix, warp_affine
from tpuva_torch.ops.wide import blur_u8


def _flag(value: bool, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.bool, device=device)


class FilterBase(VideoBase):
    """A video wrapping a source video with a batch transform."""

    sequential_only = False  # stateful filters set True
    first_batch_drop = 0  # valid rows lost from the stream's first batch

    def __init__(self, source: VideoBase, frame_count: Optional[int] = None,
                 size: Optional[Tuple[int, int]] = None, fps: Optional[float] = None,
                 is_color: Optional[bool] = None, device=None):
        super().__init__(
            source.frame_count if frame_count is None else frame_count,
            source.size if size is None else size,
            source.fps if fps is None else fps,
            source.is_color if is_color is None else is_color,
        )
        self.source = source
        if device is None:
            device = source.device if isinstance(source, FilterBase) else "cuda"
        self.device = resolve_device(device)

    # ------------------------------------------------------- transform spec
    def init_carry(self):
        """Initial carry of a stateful filter, on self.device (None =
        stateless)."""
        return None

    def batch_transform(self, batch: torch.Tensor, carry):
        """(N, H, W[, 3]) batch -> output batch, or (output, new carry)."""
        raise NotImplementedError

    def _apply(self, batch, carry):
        out = self.batch_transform(batch, carry)
        if isinstance(out, tuple):
            return out
        return out, carry

    # --------------------------------------------------------------- chain
    def chain(self):
        """(root source, the nested filters root first); raises unless they
        all run on one device."""
        filters = []
        node = self
        while isinstance(node, FilterBase):
            filters.append(node)
            node = node.source
        if len({f.device for f in filters}) > 1:
            raise ValueError("a filter chain runs on one device: "
                             f"{sorted({str(f.device) for f in filters})}")
        return node, filters[::-1]

    def init_carries(self) -> tuple:
        """Every filter's initial carry, root first."""
        return tuple(f.init_carry() for f in self.chain()[1])

    @property
    def chain_drop(self) -> int:
        """Valid rows the chain loses from the stream's first batch."""
        return sum(f.first_batch_drop for f in self.chain()[1])

    # ------------------------------------------------------------ execution
    def iter_batches(self, batch: int, pad_last: bool = False):
        """(n_valid, output) numpy pairs: each batch of the root (padded
        first, with pad_last) through the chain's program on self.device;
        the first loses chain_drop valid rows."""
        root, _filters = self.chain()
        carries = self.init_carries()
        drop = self.chain_drop
        for n, stack in root.iter_batches(batch, pad_last=pad_last):
            x = torch.from_numpy(np.ascontiguousarray(stack)).to(self.device)
            out, carries = run_chain(self, x, carries)
            out = out.cpu().numpy()
            yield max(0, min(n - drop, out.shape[0])), out
            drop = 0

    def get_frame(self, index: int) -> np.ndarray:
        """Random access: this filter applied to source.get_frame(index),
        recursively per filter, not the chain's program (a filter with its
        own random access, FilterTimeDifference, keeps it inside a chain)."""
        if self.sequential_only:
            raise NotImplementedError(
                f"{type(self).__name__} is sequential-only; iterate instead")
        frame = torch.from_numpy(np.ascontiguousarray(self.source.get_frame(index)))
        out, _ = self._apply(frame.to(self.device)[None], self.init_carry())
        return out[0].cpu().numpy()

    def close(self):
        self.source.close()


def run_chain(chain: FilterBase, batch: torch.Tensor, carries: tuple):
    """The chain's program on one batch of its root: every filter in turn,
    root first -> (output, new carries). run_chain.runs counts the calls."""
    _root, filters = chain.chain()
    new = []
    for f, c in zip(filters, carries):
        batch, c = f._apply(batch, c)
        new.append(c)
    run_chain.runs += 1
    return batch, tuple(new)


run_chain.runs = 0


# ------------------------------------------------------------------ filters
class FilterFunction(FilterBase):
    """An arbitrary per-frame torch function, mapped over the batch with
    torch.func.vmap."""

    def __init__(self, source, fn: Callable, device=None, **shape_overrides):
        super().__init__(source, device=device, **shape_overrides)
        self._fn = fn

    def batch_transform(self, batch, carry):
        return torch.func.vmap(self._fn)(batch)


QUADRANTS = {
    "upper left": (0.0, 0.0, 0.5, 0.5),
    "upper right": (0.5, 0.0, 0.5, 0.5),
    "lower left": (0.0, 0.5, 0.5, 0.5),
    "lower right": (0.5, 0.5, 0.5, 0.5),
    "left": (0.0, 0.0, 0.5, 1.0),
    "right": (0.5, 0.0, 0.5, 1.0),
    "upper": (0.0, 0.0, 1.0, 0.5),
    "lower": (0.0, 0.5, 1.0, 0.5),
}


class FilterCrop(FilterBase):
    """Crop to rect=(x, y, w, h) in pixels, or a quadrant string like
    'upper left'."""

    def __init__(self, source, rect, device=None):
        W, H = source.size
        if isinstance(rect, str):
            fx, fy, fw, fh = QUADRANTS[rect.lower()]
            rect = (int(fx * W), int(fy * H), int(fw * W), int(fh * H))
        x, y, w, h = (int(v) for v in rect)
        if not (0 <= x and 0 <= y and x + w <= W and y + h <= H and w > 0 and h > 0):
            raise ValueError(f"crop rect {rect} outside {source.size}")
        self.rect = (x, y, w, h)
        super().__init__(source, size=(w, h), device=device)

    def batch_transform(self, batch, carry):
        x, y, w, h = self.rect
        return batch[:, y:y + h, x:x + w]


class FilterMonochrome(FilterBase):
    """BGR -> gray: (b w0 + g w1) + r w2 in float32 with OpenCV's BGR
    weights, rounded half to even and clipped to uint8 (a float batch stays
    float; ops.color.bgr_to_gray: kernel KM on a CUDA tensor). A gray batch
    passes through."""

    def __init__(self, source, device=None):
        super().__init__(source, is_color=False, device=device)

    def batch_transform(self, batch, carry):
        if batch.dim() == 3:
            return batch
        return bgr_to_gray(batch)


class FilterResize(FilterBase):
    """Bilinear resize to size (width, height): jax.image.resize "linear"
    without antialiasing (the pixel-centre convention of cv2.resize
    INTER_LINEAR), H then W; uint8 rounded half to even and clipped
    (ops.resize.resize_linear: kernel KR on a CUDA tensor)."""

    def __init__(self, source, size, device=None):
        self.target = (int(size[0]), int(size[1]))
        super().__init__(source, size=self.target, device=device)

    def batch_transform(self, batch, carry):
        return resize_linear(batch, self.target)


class FilterBlur(FilterBase):
    """Gaussian blur (cv2.GaussianBlur semantics): uint8 input through
    cv2's fixed-point path, bit-exact (ops.wide.blur_u8: kernel K1b on a
    CUDA tensor, a colour batch's channels folded into the leading axis);
    float input through ops.filters.gaussian_blur (kernel KG on a CUDA
    tensor, a colour batch as it lies)."""

    def __init__(self, source, sigma: float = 0.0, ksize: Optional[int] = None, device=None):
        if ksize is None:
            # cv2 auto kernel size for sigma: ksize = 2*ceil(3*sigma)+1
            ksize = max(1, 2 * int(np.ceil(3.0 * max(sigma, 0.8))) + 1)
        self.ksize, self.sigma = int(ksize), float(sigma)
        super().__init__(source, device=device)

    def batch_transform(self, batch, carry):
        if batch.dtype == torch.uint8:
            if batch.dim() == 4:  # colour: (N, H, W, 3) -> (3N, H, W)
                N, H, W, C = batch.shape
                x = batch.permute(0, 3, 1, 2).reshape(N * C, H, W)
                y = blur_u8(x, self.ksize, self.sigma)
                return y.reshape(N, C, H, W).permute(0, 2, 3, 1)
            return blur_u8(batch, self.ksize, self.sigma)
        x = batch.to(torch.float32)  # colour: (N, H, W, 3), the channels interleaved
        return gaussian_blur(x, self.ksize, self.sigma, channels_last=x.dim() == 4)


class FilterMedian(FilterBase):
    """Median filter (cv2.medianBlur semantics, exact selection): on a
    uint8 CUDA batch kernel K7 once (ops.filters.median_blur folds a colour
    batch's channels into the leading axis); the torch sort otherwise."""

    def __init__(self, source, ksize: int = 3, device=None):
        self.ksize = int(ksize)
        super().__init__(source, device=device)

    def batch_transform(self, batch, carry):
        if batch.dim() == 4:
            return median_blur(batch.movedim(-1, 1), self.ksize).movedim(1, -1)
        return median_blur(batch, self.ksize)


class FilterNormalize(FilterBase):
    """Map [vmin, vmax] -> [0, 1] float32: (x - vmin) times the float32
    reciprocal of (vmax - vmin), the product XLA makes of tpuva's division
    by that constant; clipped."""

    def __init__(self, source, vmin: float = 0.0, vmax: float = 255.0, device=None):
        self.vmin, self.vmax = float(vmin), float(vmax)
        super().__init__(source, device=device)

    def batch_transform(self, batch, carry):
        inv = float(np.float32(1) / np.float32(self.vmax - self.vmin))
        x = (batch.to(torch.float32) - float(np.float32(self.vmin))) * inv
        return torch.clamp(x, 0.0, 1.0)


class FilterTimeDifference(FilterBase):
    """Signed frame-to-frame difference as int16: out[t] = frame[t+1] -
    frame[t]; frame_count is one less than the source's."""

    first_batch_drop = 1

    def __init__(self, source, device=None):
        super().__init__(source, frame_count=source.frame_count - 1, device=device)

    def init_carry(self):
        # (prev_frame, valid): valid False until the first batch seeds it
        h, w = self.source.height, self.source.width
        shape = (h, w, 3) if self.source.is_color else (h, w)
        return (torch.zeros(shape, dtype=torch.int16, device=self.device),
                _flag(False, self.device))

    def batch_transform(self, batch, carry):
        prev, valid = carry
        x = batch.to(torch.int16)
        diff = x - torch.cat([prev[None], x[:-1]], dim=0)
        # the stream's first frame has no predecessor: shift one left
        out = torch.where(valid, diff, torch.roll(diff, -1, dims=0))
        return out, (x[-1].clone(), _flag(True, x.device))

    def get_frame(self, index: int) -> np.ndarray:
        a = self.source.get_frame(index).astype(np.int16)
        b = self.source.get_frame(index + 1).astype(np.int16)
        return b - a


class FilterRotate(FilterBase):
    """Rotation: `turns` multiples of 90 degrees counterclockwise (an exact
    axis permutation), or `angle` degrees counterclockwise about the frame
    centre (cv2.getRotationMatrix2D convention) through ops.warp's bilinear
    sampler, same output size, constant border."""

    def __init__(self, source, turns: int | None = None, angle: float | None = None,
                 border: str = "constant", device=None):
        if (turns is None) == (angle is None):
            raise ValueError("give exactly one of turns= or angle=")
        self.turns = int(turns) % 4 if turns is not None else None
        self.angle = float(angle) if angle is not None else None
        self.border = border
        w, h = source.size
        size = (h, w) if self.turns is not None and self.turns % 2 else (w, h)
        super().__init__(source, size=size, device=device)

    def batch_transform(self, batch, carry):
        if self.turns is not None:
            return torch.rot90(batch, k=self.turns, dims=(1, 2))
        w, h = self.source.size
        M = rotation_matrix(((w - 1) / 2.0, (h - 1) / 2.0), self.angle)
        return warp_affine(batch, M, border=self.border)


class FilterWarpAffine(FilterBase):
    """Arbitrary affine transform (cv2.warpAffine): M is the forward 2x3
    src->dst matrix; out_size (w, h) defaults to the source size."""

    def __init__(self, source, M, out_size=None, border: str = "constant",
                 border_value: float = 0.0, device=None):
        self.M = np.asarray(M, np.float64).reshape(2, 3)
        self.border = border
        self.border_value = float(border_value)
        self.out_size = ((int(out_size[0]), int(out_size[1])) if out_size is not None
                         else source.size)
        super().__init__(source, size=self.out_size, device=device)

    def batch_transform(self, batch, carry):
        return warp_affine(batch, self.M, out_size=self.out_size, border=self.border,
                           border_value=self.border_value)


class FilterFlip(FilterBase):
    """Horizontal or vertical mirror."""

    def __init__(self, source, horizontal: bool = True, device=None):
        self.horizontal = bool(horizontal)
        super().__init__(source, device=device)

    def batch_transform(self, batch, carry):
        return torch.flip(batch, dims=(2 if self.horizontal else 1,))


class FilterBackground(FilterBase):
    """Running-average background subtraction as a filter: yields
    clip(rint(|frame - B|)) uint8 after B <- (1-alpha) B + alpha frame, the
    model seeded from the first frame seen. Sequential-only (the output at
    t depends on the whole history). A uint8 (N, H, W) batch runs K1's
    diff emit (ops.fused_segment, no blur, no median, seed_bg the carry's
    ~valid), one launch a batch on a card; a float batch kernel KS in its
    sequential order (ops.background.background_scan), one launch a batch."""

    sequential_only = True

    def __init__(self, source, alpha: float = 0.02, device=None):
        if source.is_color:
            raise ValueError("FilterBackground expects a grayscale source")
        self.alpha = float(alpha)
        super().__init__(source, device=device)

    def init_carry(self):
        h, w = self.source.height, self.source.width
        return (torch.zeros((h, w), dtype=torch.float32, device=self.device),
                _flag(False, self.device))

    def batch_transform(self, batch, carry):
        bg, valid = carry
        if batch.dtype == torch.uint8 and batch.dim() == 3:
            diffs, bg = fused_segment(batch, bg, alpha=self.alpha, threshold=0.0,
                                      emit="diff", seed_bg=~valid)
            return diffs, (bg, _flag(True, bg.device))
        diffs, bg = background_scan(batch.to(torch.float32), bg, self.alpha, seed_bg=~valid,
                                    order="sequential", emit="diff")
        return diffs, (bg, _flag(True, bg.device))
