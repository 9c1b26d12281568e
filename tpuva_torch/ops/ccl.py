"""Connected-component kernels K2 and K3 and their plain versions.

K2, ``label_stats``: 8-connected CCL + per-component stats.

Replaces the Pallas kernel ``tpuva/ops/pallas/ccl.py::
label_components_tiled_raw`` together with the XLA stats step
``tpuva/ops/label.py::_stats_from_compact``. Its interface is the stats
dict that the pipeline's ``_finish_batch`` reads, not a label buffer.

- CUDA tensors make one cooperative launch of ``csrc/ccl.cu``'s
  persistent kernel: block-based union-find over 2x2 blocks with
  min-index roots (root order == cv2's id order), a per-frame root scan,
  integer atomics of area / sum x / sum y, and the stats epilogue (see the
  source), its phases joined by grid-wide barriers. It reads the mask of
  the occupied strips (1 block row x 128 blocks, 2 x 256 pixels) of a
  strip occupancy — the caller's ``strip_occ``, as the Pallas kernel
  takes it (the staged route's, from K1's ``padded_occ`` emit), or every
  strip where none is given — for which of their quarters (a tile's
  width) hold foreground, and visits only those tiles. It writes the stats dict's tensors
  itself, into one output tensor; its scratch is one workspace tensor
  (``k2_workspace``). No other torch op runs.
- CPU tensors take the plain version: ``ops.label.label_components``
  (iterated 3x3 neighbour-min) + ``ops.label.component_sums`` over the
  whole image, whatever the occupancy says, then ``_assemble_stats``.

Both give the same bits. ``overflow`` is all zeros (no slot capacity
here: components past ``max_components`` are cut exactly as
``_assemble_stats`` cuts them) and ``ccl_converged`` is always True
(union-find has no round cap).

K3, ``label_components_tiled``: dense root-key labels, 4- or 8-connected
(see its docstring); 8-connected it visits only the occupied strips, and
``root_labels`` hands that occupancy on with the labels.

K6, ``root_stats``: the dense stats of root-key labels — counts, integer
sums, bbox extremes and dense cv2 ids — replacing the XLA
``tpuva/ops/label.py::_stats_from_root`` and ``relabel_dense``. CUDA
tensors launch ``tpuva_root_stats`` (``csrc/ccl.cu``), given K3's strip
occupancy or deriving one; CPU tensors take its plain version
``ops.label.root_stats_plain``, the torch ops the port ran before.
``ops.label.connected_components_with_stats`` runs K3, then K6 with K3's
occupancy, and shares the stats epilogue with the plain path.
"""

from __future__ import annotations

import ctypes

import torch

from tpuva_torch import _build
from tpuva_torch.ops.label import (
    _assemble_stats, _check_connectivity, component_sums, label_components, root_stats_plain,
)

MAX_COMPONENTS_KERNEL = 1024  # per-CTA shared-memory accumulators in ccl.cu


STRIP_BLOCKS = 128  # a strip: one 2x2-block row x 128 blocks (2 x 256 pixels)


def strip_shape(Hm: int, Wm: int) -> tuple:
    """(rows, columns) of the strip occupancy of an (Hm, Wm) mask:
    (ceil(Hm / 2), ceil(ceil(Wm / 2) / 128)); tpuva's (Hp/2, Wp/256) for a
    padded mask."""
    return (Hm + 1) // 2, -(-((Wm + 1) // 2) // STRIP_BLOCKS)


def strip_occupancy_plain(mask: torch.Tensor) -> torch.Tensor:
    """(N, Hm, Wm) mask -> (N, *strip_shape(Hm, Wm)) uint8, 1 where the
    strip holds foreground: the occupancy tpuva's staged route reduces from
    a cropped mask (two reduce_windows over it, zero-padded)."""
    N, Hm, Wm = mask.shape
    R, S = strip_shape(Hm, Wm)
    padded = torch.zeros((N, 2 * R, 256 * S), dtype=torch.bool, device=mask.device)
    padded[:, :Hm, :Wm] = mask != 0
    return padded.reshape(N, R, 2, S, 256).any(dim=4).any(dim=2).to(torch.uint8)


def label_sums_plain(mask: torch.Tensor, max_components: int):
    """Plain version of the kernel: (count (N,) int32, sums (N, C, 3) int64)."""
    return component_sums(label_components(mask), max_components)


def k2_workspace(N: int, Hm: int, Wm: int, C: int):
    """K2's scratch in one workspace tensor: ({name: (byte offset, bytes)},
    total bytes), each array 16-byte aligned, for an (N, Hm, Wm) mask and
    C components: parent and bits (a 2x2 block each), rc (a strip's roots),
    list (the batch's tiles with foreground, an int2 each), table (each
    frame's first C roots), sums (32-bit area, sum x, sum y), nlist (the
    list's length) and fine (a strip's segments with foreground, a byte)."""
    Hb, Wb = (Hm + 1) // 2, (Wm + 1) // 2
    R, S = strip_shape(Hm, Wm)
    tiles = -(-Hb // 16) * -(-Wb // 32)
    sizes = {"parent": 4 * N * Hb * Wb, "rc": 4 * N * R * S, "list": 8 * N * tiles,
             "table": 4 * N * C, "sums": 12 * N * C, "nlist": 4, "bits": N * Hb * Wb,
             "fine": N * R * S}
    layout, o = {}, 0
    for name, nbytes in sizes.items():
        layout[name] = (o, nbytes)
        o += -(-nbytes // 16) * 16
    return layout, o


STATS_FIELDS = ("count", "area", "centroid", "centroid_sum", "overflow")
# the persistent kernel's phases (csrc/ccl.cu), in order
K2_PHASES = ("occupancy", "list", "local", "border", "flatten", "roots", "stats", "epilogue")


def stats_views(out: torch.Tensor, N: int, C: int) -> dict:
    """The stats dict's tensors as views of one int32 tensor of
    N * (2 + 5 * (C + 1)) words, in STATS_FIELDS order: count (N,), area
    (N, C+1), centroid (N, C+1, 2) float32 (its words' bits), centroid_sum
    (N, C+1, 2), overflow (N,)."""
    shapes = {"count": (N,), "area": (N, C + 1), "centroid": (N, C + 1, 2),
              "centroid_sum": (N, C + 1, 2), "overflow": (N,)}
    views, o = {}, 0
    for name in STATS_FIELDS:
        n = 1
        for d in shapes[name]:
            n *= d
        v = out[o:o + n].view(shapes[name])
        views[name] = v.view(torch.float32) if name == "centroid" else v
        o += n
    return views


def _label_stats_cuda(mask: torch.Tensor, max_components: int, strip_occ, H: int, W: int,
                      phase_ns=None):
    """K2's one cooperative launch on an (N, Hm, Wm) mask (zero outside its
    (H, W) image), over the occupied strips of strip_occ (N,
    *strip_shape(Hm, Wm)) uint8 or bool, or of the occupancy it derives
    from the mask: the stats dict's tensors (stats_views). phase_ns, a
    (9,) int64 CUDA tensor, receives the kernel's clock (ns) at its start
    and after each of its phases A-G (K2_PHASES), then the number of tiles
    it visited."""
    N, Hm, Wm = mask.shape
    C = max_components
    if not 1 <= C <= MAX_COMPONENTS_KERNEL:
        raise ValueError(f"max_components must be in [1, {MAX_COMPONENTS_KERNEL}]")
    if Hm >= 1 << 16 or Wm >= 1 << 16 or N >= 1 << 16 or H * W >= 1 << 31:
        raise ValueError("ccl kernel: N, H and W must be < 65536, and H * W < 2^31")
    dev = mask.device
    derive = strip_occ is None
    layout, total = k2_workspace(N, Hm, Wm, C)
    ws = torch.empty((total,), dtype=torch.uint8, device=dev)
    out = torch.empty((N * (2 + 5 * (C + 1)),), dtype=torch.int32, device=dev)
    views = stats_views(out, N, C)
    at = {name: ws.data_ptr() + off for name, (off, _n) in layout.items()}
    lib = _build.load()
    err = lib.tpuva_ccl_stats(
        mask.data_ptr(), N, Hm, Wm, H, W, C, None if derive else strip_occ.data_ptr(),
        *(at[k] for k in ("fine", "bits", "parent", "list", "nlist", "rc", "table", "sums")),
        *(views[k].data_ptr() for k in STATS_FIELDS),
        None if phase_ns is None else phase_ns.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, "ccl kernel")
    label_stats.launches += 1
    label_stats.occ_launches += not derive
    return views


def k2_grid() -> tuple:
    """(CTAs an SM, SMs) of K2's cooperative grid on the current card; 0 CTAs
    an SM where the card cannot launch it (K2 then raises)."""
    lib = _build.load()
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(lib, lib.tpuva_ccl_stats_grid(ctypes.addressof(per_sm), ctypes.addressof(sms)),
                 "ccl kernel grid")
    return per_sm.value, sms.value


def label_stats(mask: torch.Tensor, max_components: int = 64, strip_occ=None,
                H=None, W=None) -> dict:
    """Stats of the 8-connected components of an (N, H, W) uint8 mask.

    With strip_occ and (H, W), as tpuva's label_components_tiled_raw takes
    them, mask is a padded (N, Hm, Wm) mask, zero outside its (H, W) image,
    and strip_occ (N, *strip_shape(Hm, Wm)) — (N, Hp/2, Wp/256) — says
    which strips of 2 rows x 256 columns hold foreground: the kernels visit
    only those (a strip it calls empty must hold none). Without them the
    kernels derive the occupancy from the mask, as tpuva's staged route
    reduces it. The plain version computes the stats of the (H, W) image
    whatever the occupancy says.

    Returns {count (N,) int32, area (N,C+1) int32, centroid (N,C+1,2)
    float32, centroid_sum (N,C+1,2) int32, overflow (N,) int32,
    ccl_converged bool}, row 0 the background, rows 1..C the components
    in cv2 id order — the contract of tpuva's stats dict."""
    if mask.dim() != 3 or mask.dtype != torch.uint8:
        raise ValueError("label_stats: mask must be (N, H, W) uint8")
    N, Hm, Wm = mask.shape
    if (strip_occ is None) != (H is None) or (H is None) != (W is None):
        raise ValueError("label_stats: give strip_occ with H and W, or none of them")
    if strip_occ is None:
        H, W = Hm, Wm
    else:
        if not (0 < H <= Hm and 0 < W <= Wm):
            raise ValueError(f"label_stats: image ({H}, {W}) outside the mask ({Hm}, {Wm})")
        if tuple(strip_occ.shape) != (N, *strip_shape(Hm, Wm)) or strip_occ.dtype not in (
                torch.uint8, torch.bool) or strip_occ.device != mask.device:
            raise ValueError(f"label_stats: strip_occ must be (N, {strip_shape(Hm, Wm)}) "
                             "uint8 or bool on the mask's device")
    if mask.device.type == "cpu":
        count, sums = label_sums_plain(mask[:, :H, :W], max_components)
        stats = _assemble_stats(count, sums, H, W)
        stats["overflow"] = torch.zeros((N,), dtype=torch.int32, device=mask.device)
    elif mask.device.type == "cuda" and N == 0:
        stats = stats_views(torch.empty((0,), dtype=torch.int32, device=mask.device), 0,
                            max_components)
    elif mask.device.type == "cuda":
        occ = None if strip_occ is None else strip_occ.contiguous()
        stats = _label_stats_cuda(mask.contiguous(), max_components, occ, H, W)
    else:
        raise ValueError(f"label_stats: unsupported device {mask.device}")
    stats["ccl_converged"] = True
    return stats


label_stats.launches = 0  # every K2 launch
label_stats.occ_launches = 0  # those given the caller's strip_occ


def label_components_tiled(mask: torch.Tensor, connectivity: int = 8,
                           return_converged: bool = False):
    """Dense root-key labels — kernel K3, replacing the Pallas kernel
    ``tpuva/ops/pallas/ccl.py::label_components_tiled``.

    mask: (N, H, W) or (H, W) uint8/bool. Returns int32 labels of the same
    shape (each component pixel its component's minimum scan key + 1,
    background 0) — bit-equal to ``ops.label.label_components`` — and with
    return_converged=True also ``converged``, always True: union-find has
    no round cap (the Pallas kernel's max_rounds can run out).

    CUDA tensors launch ``tpuva_ccl_labels`` in ``csrc/ccl.cu`` (2x2-block
    union-find over the occupied strips for 8-connectivity, pixel
    union-find for 4); CPU tensors take the plain ``label_components``. The
    Pallas knobs ``tile``, ``max_rounds``, ``frames_per_step`` and
    ``max_run`` size TPU grid steps and VMEM windows; the kernel here has
    none of those to size."""
    labels, _occ = root_labels(mask, connectivity)
    return (labels, True) if return_converged else labels


def root_labels(mask: torch.Tensor, connectivity: int = 8):
    """K3 with its strip occupancy: (labels, strip_occ). labels as
    label_components_tiled returns them; strip_occ the (N, *strip_shape(H,
    W)) uint8 occupancy that K3 derived on the card for 8-connectivity (K6
    reads only its strips), None for 4-connectivity and on the CPU."""
    _check_connectivity(connectivity)
    squeeze = mask.dim() == 2
    if squeeze:
        mask = mask[None]
    if mask.dim() != 3 or mask.dtype not in (torch.uint8, torch.bool):
        raise ValueError("label_components_tiled: mask must be (N, H, W) uint8 or bool")
    if mask.device.type == "cpu":
        labels, occ = label_components(mask, connectivity), None
    elif mask.device.type == "cuda":
        labels, occ = _labels_cuda(mask.to(torch.uint8).contiguous(), connectivity)
    else:
        raise ValueError(f"label_components_tiled: unsupported device {mask.device}")
    if squeeze:
        labels, occ = labels[0], None if occ is None else occ[0]
    return labels, occ


def _labels_cuda(mask: torch.Tensor, connectivity: int):
    """The launch sequence of tpuva_ccl_labels: (labels, the strip
    occupancy it derived for 8-connectivity, else None)."""
    N, H, W = mask.shape
    dev = mask.device
    labels = torch.empty((N, H, W), dtype=torch.int32, device=dev)
    if N == 0 or H == 0 or W == 0:
        occ = None if connectivity == 4 else torch.zeros(
            (N, *strip_shape(H, W)), dtype=torch.uint8, device=dev)
        return labels, occ
    Hb, Wb = (H + 1) // 2, (W + 1) // 2
    if N >= 1 << 16 or 4 * Hb * Wb >= 1 << 31:
        raise ValueError("label_components_tiled kernel: N < 65536 and 4*ceil(H/2)*ceil(W/2) < 2^31")
    occ = tiles = ntiles = parent = bits = None
    if connectivity == 8:
        occ = torch.empty((N, *strip_shape(H, W)), dtype=torch.uint8, device=dev)
        tiles = torch.empty((N, -(-Hb // 16) * -(-Wb // 32)), dtype=torch.int32, device=dev)
        ntiles = torch.empty((N,), dtype=torch.int32, device=dev)
        parent = torch.empty((N, Hb * Wb), dtype=torch.int32, device=dev)
        bits = torch.empty((N, Hb * Wb), dtype=torch.uint8, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.load()
    err = lib.tpuva_ccl_labels(
        mask.data_ptr(), N, H, W, connectivity, ptr(occ), ptr(tiles), ptr(ntiles),
        ptr(parent), ptr(bits), labels.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, "ccl labels kernel")
    label_components_tiled.launches += 1
    return labels, occ


label_components_tiled.launches = 0


def root_strip_shape(H: int, W: int, connectivity: int) -> tuple:
    """(rows, columns) of K6's strips of an (H, W) frame, 512 scan keys
    each: 8-connected strip_shape(H, W) (2 rows x 256 columns, K3's
    strips), 4-connected (H, ceil(W / 512)) (512 columns of one row)."""
    return strip_shape(H, W) if connectivity == 8 else (H, -(-W // 512))


def root_occupancy_plain(root: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """(N, *root_strip_shape(H, W, connectivity)) uint8, 1 where one of K6's
    strips of root-key labels (N, H, W) holds foreground: the occupancy
    K6 derives, and K3's for 8-connectivity."""
    if connectivity == 8:
        return strip_occupancy_plain(root)
    N, H, W = root.shape
    S = root_strip_shape(H, W, 4)[1]
    fg = torch.nn.functional.pad((root != 0).to(torch.uint8), (0, 512 * S - W))
    return fg.reshape(N, H, S, 512).amax(dim=3)


def root_stats(root: torch.Tensor, max_components: int, connectivity: int = 8,
               sums: bool = True, bbox: bool = False, labels: bool = False,
               strip_occ=None):
    """Kernel K6: the dense stats of root-key labels (N, H, W) int32, as
    K3 or label_components gives them.

    Returns (count (N,) int32 = min(components, C), sums (N, C, 3) int64 of
    (area, sum x, sum y), lohi (N, C, 4) int32 of (min x, min y, max x,
    max y), dense (N, H, W) int32 cv2 ids 1..C, 0 for background and later
    components), C = max_components, the first C components in cv2 id
    order; an output not asked for (sums, bbox, labels) is None, and bbox
    needs sums. strip_occ, (N, *root_strip_shape(H, W, connectivity))
    uint8 or bool (K3's for 8-connectivity), says which strips hold
    foreground: on the card only those are read (a strip it calls empty
    must hold none); without it the kernel derives it from the labels.

    CUDA tensors launch tpuva_root_stats (csrc/ccl.cu) once, with no host
    sync; CPU tensors take the plain version ops.label.root_stats_plain
    (whatever strip_occ says); both are bit-equal."""
    _check_connectivity(connectivity)
    if root.dim() != 3 or root.dtype != torch.int32:
        raise ValueError("root_stats: root must be (N, H, W) int32")
    if bbox and not sums:
        raise ValueError("root_stats: bbox needs sums")
    N, H, W = root.shape
    if strip_occ is not None and (
            tuple(strip_occ.shape) != (N, *root_strip_shape(H, W, connectivity))
            or strip_occ.dtype not in (torch.uint8, torch.bool)
            or strip_occ.device != root.device):
        raise ValueError(f"root_stats: strip_occ must be (N, {root_strip_shape(H, W, connectivity)}) "
                         "uint8 or bool on the labels' device")
    if root.device.type == "cpu":
        return root_stats_plain(root, max_components, connectivity, sums, bbox, labels)
    if root.device.type != "cuda":
        raise ValueError(f"root_stats: unsupported device {root.device}")
    return _root_stats_cuda(root.contiguous(), max_components, connectivity, sums, bbox, labels,
                            None if strip_occ is None else strip_occ.to(torch.uint8).contiguous())


def _root_stats_cuda(root, C, connectivity, sums, bbox, labels, strip_occ):
    N, H, W = root.shape
    dev = root.device
    if C < 0:
        raise ValueError("root_stats: max_components must be >= 0")
    if N == 0 or H == 0 or W == 0:
        lohi = torch.tensor([1 << 30, 1 << 30, -1, -1], dtype=torch.int32, device=dev)
        return (torch.zeros((N,), dtype=torch.int32, device=dev),
                torch.zeros((N, C, 3), dtype=torch.int64, device=dev) if sums else None,
                lohi.repeat(N, C, 1) if bbox else None,
                torch.zeros((N, H, W), dtype=torch.int32, device=dev) if labels else None)
    # every output is written by the kernels: k6_roots the count and the
    # zeroed sums and seeded bbox, k6_labels every pixel
    if N >= 1 << 16 or H >= 1 << 16 or W >= 1 << 16:
        raise ValueError("root_stats kernel: N, H and W must be < 65536")
    out_sums = torch.empty((N, C, 3), dtype=torch.int64, device=dev) if sums else None
    lohi = torch.empty((N, C, 4), dtype=torch.int32, device=dev) if bbox else None
    dense = torch.empty((N, H, W), dtype=torch.int32, device=dev) if labels else None
    R, S = root_strip_shape(H, W, connectivity)
    Q, Ct = R * S, max(C, 1)
    derive = strip_occ is None
    occ = torch.empty((N, R, S), dtype=torch.uint8, device=dev) if derive else strip_occ
    # one int32 buffer (each allocation is host time): count (N), the
    # scratch nlist (N), rcnt and list (N, Q), table (N, C)
    buf = torch.empty((N * (2 + 2 * Q + Ct),), dtype=torch.int32, device=dev)
    count = buf[:N]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    at = lambda i: buf.data_ptr() + 4 * i  # noqa: E731
    lib = _build.load()
    err = lib.tpuva_root_stats(
        root.data_ptr(), N, H, W, connectivity, C, occ.data_ptr(), int(derive),
        at(2 * N), at(2 * N + N * Q), at(N), at(2 * N + 2 * N * Q),
        count.data_ptr(), ptr(out_sums), ptr(lohi), ptr(dense),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, "root stats kernel")
    root_stats.launches += 1
    root_stats.occ_launches += not derive
    return count, out_sums, lohi, dense


root_stats.launches = 0  # every K6 launch sequence
root_stats.occ_launches = 0  # those given the caller's strip_occ (K3's)
