"""Affine warping (cv2.warpAffine, INTER_LINEAR) — port of
``tpuva/ops/warp.py``.

- ``M`` is the forward 2x3 map src->dst (cv2 inverts it unless
  WARP_INVERSE_MAP; ``inverse=True`` mirrors that flag);
- bilinear sampling at the pixel-centre convention: four clipped
  flat-index gathers a sample;
- BORDER_CONSTANT (an out-of-bounds corner of a sample contributes the
  border value: each corner is masked on its own) and BORDER_REPLICATE.

``invert_affine`` and ``rotation_matrix`` are host numpy in float64, copies
of the originals. ``warp_affine_plain`` runs torch ops on the image's
device, every float32 product and sum rounded on its own in tpuva's
source order (the sample coordinates, then the lerps ``a + f * (b - a)``);
tpuva's XLA:CPU run contracts some of them into FMAs (ROADMAP Queue 3 R5).
``warp_affine`` launches kernel KW (csrc/filters.cu ``tpuva_warp_affine``)
once on a CUDA tensor, the same operations in the same order, and takes
the plain version on a CPU one. ``warp_plan`` is the launch both share:
the layout and the float32 inverse map. KW takes a 64 x 32 output tile
across all the images and reads its corners from the tile's source
footprint staged in shared memory, or, where the footprint exceeds a
16 KB buffer, gathers them from global memory: a route a tile,
chosen on the card from the map; ``warp_affine_routes`` counts them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuva_torch import _build


def invert_affine(M) -> np.ndarray:
    """Invert a 2x3 affine matrix (host-side, float64 like cv2's
    invertAffineTransform)."""
    M = np.asarray(M, np.float64).reshape(2, 3)
    a, b, c = M[0]
    d, e, f = M[1]
    det = a * e - b * d
    if det == 0:
        raise ValueError("singular affine matrix")
    ia, ib = e / det, -b / det
    id_, ie = -d / det, a / det
    return np.array(
        [[ia, ib, -(ia * c + ib * f)], [id_, ie, -(id_ * c + ie * f)]],
        np.float64,
    )


def rotation_matrix(center, angle_deg: float, scale: float = 1.0):
    """cv2.getRotationMatrix2D: counterclockwise rotation about `center`
    ((cx, cy) in pixel coords) with isotropic scaling."""
    cx, cy = float(center[0]), float(center[1])
    a = np.deg2rad(angle_deg)
    al = scale * np.cos(a)
    be = scale * np.sin(a)
    return np.array(
        [
            [al, be, (1.0 - al) * cx - be * cy],
            [-be, al, be * cx + (1.0 - al) * cy],
        ],
        np.float64,
    )


def _f32(v) -> float:
    """v rounded to float32, as a Python float (the value a float32 op sees)."""
    return float(np.float32(v))


class WarpPlan(NamedTuple):
    L: int  # images: the leading axes' product
    H: int
    W: int
    C: int  # 3 for (..., H, W, 3), else 1
    ho: int
    wo: int
    coeffs: tuple  # (ia, ib, ic, id, ie, if): the inverse map dst -> src, float32 values
    out_shape: tuple


def warp_plan(shape, M, out_size=None, inverse: bool = False) -> WarpPlan:
    """The warp of an image of shape (N, H, W), (H, W) or (..., H, W, 3):
    the last two axes, or the two before a channel axis of 3, are spatial;
    out_size (w, h) defaults to the input's; M the 2x3 forward src->dst
    matrix, inverted unless inverse, each coefficient rounded to float32."""
    shape = tuple(shape)
    chan = len(shape) >= 3 and shape[-1] == 3
    sp = len(shape) - (3 if chan else 2)  # the H axis
    H, W = shape[sp], shape[sp + 1]
    wo, ho = out_size if out_size is not None else (W, H)
    Mi = np.asarray(M, np.float64).reshape(2, 3)
    if not inverse:
        Mi = invert_affine(Mi)
    coeffs = tuple(_f32(v) for v in Mi.reshape(-1))
    L = int(np.prod(shape[:sp], dtype=np.int64))
    return WarpPlan(L, H, W, 3 if chan else 1, int(ho), int(wo), coeffs,
                    shape[:sp] + (int(ho), int(wo)) + ((3,) if chan else ()))


KW_TILE = (64, 32)  # KW's output tile (w, h): a CTA (csrc/filters.cu kWarpTX, kWarpTY)


def _warp_cuda(img: torch.Tensor, M, out_size, inverse: bool, border: str,
               border_value: float, routes: torch.Tensor | None) -> torch.Tensor:
    """KW's launch on a CUDA img; routes (int32[2] on the card, or None)
    receives the tiles of each route."""
    plan = warp_plan(img.shape, M, out_size, inverse)
    x = img if img.dtype in (torch.uint8, torch.float32) else img.to(torch.float32)
    x = x.contiguous()
    out = torch.empty(plan.out_shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out.to(img.dtype)
    if x.numel() == 0:
        raise ValueError("warp_affine: an empty image has nothing to sample")
    _build.launch(x.device, "tpuva_warp_affine", "warp_affine kernel", x.data_ptr(),
                  out.data_ptr(), plan.L, plan.H, plan.W, plan.C, plan.ho, plan.wo,
                  int(x.dtype == torch.float32), int(border == "constant"), *plan.coeffs,
                  _f32(border_value), None if routes is None else routes.data_ptr())
    warp_affine.launches += 1
    return out if out.dtype == img.dtype else out.to(img.dtype)


def warp_affine_routes(img: torch.Tensor, M, out_size=None, inverse: bool = False,
                       border: str = "constant", border_value: float = 0.0):
    """(warp_affine of a CUDA img, (the tiles that staged their footprint in
    shared memory, the tiles that gathered from global memory)): one KW
    launch, counted in warp_affine.launches."""
    if border not in ("constant", "replicate"):
        raise ValueError(border)
    if img.device.type != "cuda":
        raise ValueError(f"warp_affine_routes: a CUDA tensor is needed, got {img.device}")
    routes = torch.zeros(2, dtype=torch.int32, device=img.device)
    out = _warp_cuda(img, M, out_size, inverse, border, border_value, routes)
    return out, tuple(routes.tolist())


def warp_affine(img: torch.Tensor, M, out_size=None, inverse: bool = False,
                border: str = "constant", border_value: float = 0.0) -> torch.Tensor:
    """Batched cv2.warpAffine (INTER_LINEAR) on img (N, H, W), (H, W) or
    (..., H, W, 3) (warp_plan). Returns img's dtype: uint8 rounded half to
    even and clipped, others cast from float32. CUDA tensors launch KW once
    (warp_affine.launches counts them; another dtype than uint8 and float32
    goes through float32); CPU tensors take warp_affine_plain."""
    if border not in ("constant", "replicate"):
        raise ValueError(border)
    if img.device.type == "cpu":
        return warp_affine_plain(img, M, out_size, inverse, border, border_value)
    if img.device.type != "cuda":
        raise ValueError(f"warp_affine: unsupported device {img.device}")
    return _warp_cuda(img, M, out_size, inverse, border, border_value, None)


warp_affine.launches = 0


def warp_affine_plain(img: torch.Tensor, M, out_size=None, inverse: bool = False,
                      border: str = "constant", border_value: float = 0.0) -> torch.Tensor:
    """KW's plain version: warp_affine as torch ops on img's device."""
    if border not in ("constant", "replicate"):
        raise ValueError(border)
    plan = warp_plan(img.shape, M, out_size, inverse)
    chan = plan.C == 3
    H, W, h_out, w_out = plan.H, plan.W, plan.ho, plan.wo
    ia, ib, ic, id_, ie, if_ = plan.coeffs
    dev = img.device
    xs = torch.arange(w_out, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(h_out, dtype=torch.float32, device=dev)[:, None]
    sx = ia * xs + ib * ys + ic  # (h_out, w_out)
    sy = id_ * xs + ie * ys + if_
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)

    fimg = img.to(torch.float32)
    if chan:  # the channel axis joins the leading ones
        fimg = fimg.movedim(-1, 0)
    lead = fimg.shape[:-2]
    flat = fimg.reshape(lead + (H * W,))
    bv = torch.tensor(_f32(border_value), dtype=torch.float32, device=dev)

    def corner(xi, yi):
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(-1)
        g = flat.index_select(-1, idx).reshape(lead + (h_out, w_out))
        if border == "constant":
            g = torch.where((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H), g, bv)
        return g

    g00 = corner(x0, y0)
    g01 = corner(x0 + 1, y0)
    g10 = corner(x0, y0 + 1)
    g11 = corner(x0 + 1, y0 + 1)
    top = g00 + fx * (g01 - g00)
    bot = g10 + fx * (g11 - g10)
    out = top + fy * (bot - top)
    if chan:
        out = out.movedim(0, -1)
    if img.dtype == torch.uint8:
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out.to(img.dtype)
