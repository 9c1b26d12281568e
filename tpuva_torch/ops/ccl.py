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
(see its docstring); either way it visits only the occupied strips, and
``root_labels`` hands that occupancy on with the labels.

K6: the dense stats of root-key labels — counts, integer sums, bbox
extremes, dense cv2 ids and the stats dict — replacing the XLA
``tpuva/ops/label.py::_stats_from_root``, ``relabel_dense`` and its
stats epilogue. CUDA tensors make one launch of ``tpuva_root_stats``
(``csrc/ccl.cu``) a call, given K3's strip occupancy or deriving one:
``root_stats`` for the raw outputs, ``root_stats_dict`` for the stats
dict, which the kernel writes itself (the epilogue it shares with K2). CPU tensors take its plain version ``ops.label.root_stats_plain``
(then ``ops.label._stats_dict`` for the dict), the torch ops the port ran
before. ``ops.label.connected_components_with_stats`` runs K3, then K6
with K3's occupancy.
"""

from __future__ import annotations

import ctypes

import torch

from tpuva_torch import _build
from tpuva_torch.ops.label import (
    _assemble_stats, _check_connectivity, _stats_dict, component_sums, label_components,
    root_stats_plain,
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
    return _aligned_layout({
        "parent": 4 * N * Hb * Wb, "rc": 4 * N * R * S, "list": 8 * N * tiles,
        "table": 4 * N * C, "sums": 12 * N * C, "nlist": 4, "bits": N * Hb * Wb,
        "fine": N * R * S})


def _aligned_layout(sizes: dict):
    """({name: (byte offset, bytes)}, total bytes) of the arrays of sizes,
    in order, each 16-byte aligned in one workspace tensor."""
    layout, o = {}, 0
    for name, nbytes in sizes.items():
        layout[name] = (o, nbytes)
        o += -(-nbytes // 16) * 16
    return layout, o


STATS_FIELDS = ("count", "area", "centroid", "centroid_sum", "overflow")
# the persistent kernel's phases (csrc/ccl.cu), in order
K2_PHASES = ("occupancy", "list", "local", "border", "flatten", "roots", "stats", "epilogue")


def stats_words(N: int, C: int, bbox: bool = False) -> int:
    """int32 words of stats_views' tensor."""
    return N * (2 + (9 if bbox else 5) * (C + 1))


def stats_views(out: torch.Tensor, N: int, C: int, bbox: bool = False) -> dict:
    """The stats dict's tensors as views of one int32 tensor of
    stats_words(N, C, bbox) words, in STATS_FIELDS order: count (N,), area
    (N, C+1), centroid (N, C+1, 2) float32 (its words' bits), centroid_sum
    (N, C+1, 2), overflow (N,); then, with bbox, bbox (N, C+1, 4)."""
    shapes = {"count": (N,), "area": (N, C + 1), "centroid": (N, C + 1, 2),
              "centroid_sum": (N, C + 1, 2), "overflow": (N,), "bbox": (N, C + 1, 4)}
    views, o = {}, 0
    for name in STATS_FIELDS + (("bbox",) if bbox else ()):
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
    _build.launch(
        dev, "tpuva_ccl_stats", "ccl kernel",
        mask.data_ptr(), N, Hm, Wm, H, W, C, None if derive else strip_occ.data_ptr(),
        *(at[k] for k in ("fine", "bits", "parent", "list", "nlist", "rc", "table", "sums")),
        *(views[k].data_ptr() for k in STATS_FIELDS),
        None if phase_ns is None else phase_ns.data_ptr(),
    )
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
    union-find over the occupied segments for 4); CPU tensors take the
    plain ``label_components``. The
    Pallas knobs ``tile``, ``max_rounds``, ``frames_per_step`` and
    ``max_run`` size TPU grid steps and VMEM windows; the kernel here has
    none of those to size."""
    labels, _occ = root_labels(mask, connectivity)
    return (labels, True) if return_converged else labels


def root_labels(mask: torch.Tensor, connectivity: int = 8):
    """K3 with its strip occupancy: (labels, strip_occ). labels as
    label_components_tiled returns them; strip_occ the (N,
    *root_strip_shape(H, W, connectivity)) uint8 occupancy that K3 derived
    on the card (K6 reads only its strips), None on the CPU."""
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
    occupancy it derived, (N, *root_strip_shape(H, W, connectivity)))."""
    N, H, W = mask.shape
    dev = mask.device
    labels = torch.empty((N, H, W), dtype=torch.int32, device=dev)
    occ_shape = (N, *root_strip_shape(H, W, connectivity))
    if N == 0 or H == 0 or W == 0:
        return labels, torch.zeros(occ_shape, dtype=torch.uint8, device=dev)
    occ = torch.empty(occ_shape, dtype=torch.uint8, device=dev)
    Hb, Wb = (H + 1) // 2, (W + 1) // 2
    if N >= 1 << 16 or 4 * Hb * Wb >= 1 << 31:
        raise ValueError("label_components_tiled kernel: N < 65536 and 4*ceil(H/2)*ceil(W/2) < 2^31")
    seg = parent = bits = None
    if connectivity == 8:
        tiles = torch.empty((N, -(-Hb // 16) * -(-Wb // 32)), dtype=torch.int32, device=dev)
        parent = torch.empty((N, Hb * Wb), dtype=torch.int32, device=dev)
        bits = torch.empty((N, Hb * Wb), dtype=torch.uint8, device=dev)
    else:
        T = -(-H // 16) * -(-W // 32)
        if T >= 1 << 16:
            raise ValueError("label_components_tiled kernel, 4-connected: fewer than 65536 "
                             "16 x 32 tiles a frame")
        seg = torch.empty(occ.shape, dtype=torch.int16, device=dev)
        tiles = torch.empty((N, T), dtype=torch.int32, device=dev)
    ntiles = torch.empty((N,), dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.launch(
        dev, "tpuva_ccl_labels", "ccl labels kernel",
        mask.data_ptr(), N, H, W, connectivity, occ.data_ptr(), ptr(seg), tiles.data_ptr(),
        ntiles.data_ptr(), ptr(parent), ptr(bits), labels.data_ptr(),
    )
    label_components_tiled.launches += 1
    label_components_tiled.conn4_launches += connectivity == 4
    return labels, occ


label_components_tiled.launches = 0  # every K3 launch sequence
label_components_tiled.conn4_launches = 0  # those 4-connected


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


def _root_input(root: torch.Tensor, C: int, connectivity: int, strip_occ, what: str):
    """Check K6's input: root (N, H, W) int32, C >= 0, strip_occ None or
    (N, *root_strip_shape(H, W, connectivity)) uint8/bool on root's device.
    Returns strip_occ as uint8, contiguous on a card."""
    _check_connectivity(connectivity)
    if root.dim() != 3 or root.dtype != torch.int32:
        raise ValueError(f"{what}: root must be (N, H, W) int32")
    if C < 0:
        raise ValueError(f"{what}: max_components must be >= 0")
    N, H, W = root.shape
    if strip_occ is not None and (
            tuple(strip_occ.shape) != (N, *root_strip_shape(H, W, connectivity))
            or strip_occ.dtype not in (torch.uint8, torch.bool)
            or strip_occ.device != root.device):
        raise ValueError(f"{what}: strip_occ must be (N, {root_strip_shape(H, W, connectivity)}) "
                         "uint8 or bool on the labels' device")
    if root.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {root.device}")
    if root.device.type == "cuda" and (N >= 1 << 16 or H >= 1 << 16 or W >= 1 << 16):
        raise ValueError(f"{what} kernel: N, H and W must be < 65536")
    if strip_occ is None or root.device.type == "cpu":
        return strip_occ
    return strip_occ.to(torch.uint8).contiguous()


def root_stats(root: torch.Tensor, max_components: int, connectivity: int = 8,
               sums: bool = True, bbox: bool = False, labels: bool = False,
               strip_occ=None):
    """Kernel K6's raw outputs: the dense stats of root-key labels (N, H,
    W) int32, as K3 or label_components gives them.

    Returns (count (N,) int32 = min(components, C), sums (N, C, 3) int64 of
    (area, sum x, sum y), lohi (N, C, 4) int32 of (min x, min y, max x,
    max y), dense (N, H, W) int32 cv2 ids 1..C, 0 for background and later
    components), C = max_components, the first C components in cv2 id
    order; an output not asked for (sums, bbox, labels) is None, and bbox
    needs sums. strip_occ, (N, *root_strip_shape(H, W, connectivity))
    uint8 or bool (K3's), says which strips hold foreground: on the card
    only those are read (a strip it calls empty must hold none); without it
    the kernel derives it from the labels.

    CUDA tensors launch tpuva_root_stats (csrc/ccl.cu) once, with no host
    sync; CPU tensors take the plain version ops.label.root_stats_plain
    (whatever strip_occ says); both are bit-equal."""
    strip_occ = _root_input(root, max_components, connectivity, strip_occ, "root_stats")
    if bbox and not sums:
        raise ValueError("root_stats: bbox needs sums")
    if root.device.type == "cpu":
        return root_stats_plain(root, max_components, connectivity, sums, bbox, labels)
    N, H, W = root.shape
    C, dev = max_components, root.device
    count = torch.empty((N,), dtype=torch.int32, device=dev)
    out_sums = torch.empty((N, C, 3), dtype=torch.int64, device=dev) if sums else None
    lohi = torch.empty((N, C, 4), dtype=torch.int32, device=dev) if bbox else None
    dense = torch.empty((N, H, W), dtype=torch.int32, device=dev) if labels else None
    if N:
        _root_stats_launch(root.contiguous(), C, connectivity, strip_occ, count, out_sums, lohi,
                           dense)
    return count, out_sums, lohi, dense


def root_stats_dict(root: torch.Tensor, max_components: int, connectivity: int = 8,
                    compute_bbox: bool = True, compute_labels: bool = True,
                    strip_occ=None) -> dict:
    """Kernel K6's stats dict of root-key labels (N, H, W) int32: count,
    area, centroid, centroid_sum, overflow, bbox and labels, as
    ops.label.connected_components_with_stats documents them. strip_occ as
    root_stats takes it.

    CUDA tensors make one launch of tpuva_root_stats, which writes the
    whole dict (the epilogue it shares with K2): the dict's tensors are
    views of one int32 tensor (stats_views with its bbox, then one word
    the kernel sets to 0), labels (N, H, W) int32 where compute_labels,
    else that word broadcast (read-only); bbox zeros without compute_bbox.
    No torch op runs on the card besides the allocations. CPU tensors take
    the plain version, root_stats_plain then ops.label._stats_dict; both
    are bit-equal."""
    strip_occ = _root_input(root, max_components, connectivity, strip_occ, "root_stats_dict")
    N, H, W = root.shape
    C, dev = max_components, root.device
    if root.device.type == "cpu":
        return _stats_dict(*root_stats_plain(root, C, connectivity, True, compute_bbox,
                                             compute_labels), H, W)
    words = stats_words(N, C, bbox=True)
    out = torch.empty((words + 1,), dtype=torch.int32, device=dev)
    stats = stats_views(out, N, C, bbox=True)
    dense = torch.empty((N, H, W), dtype=torch.int32, device=dev) if compute_labels else None
    if N:
        _root_stats_launch(root.contiguous(), C, connectivity, strip_occ, stats["count"],
                           labels=dense, stats=stats, with_bbox=compute_bbox, zero=out[words:])
    stats["labels"] = dense if compute_labels else out[words].expand(N, H, W)
    return stats


K6_SMEM_BYTES = 48 * 1024  # csrc/ccl.cu kSmemBytes


def k6_frame_bytes(C: int, sums: bool, box: bool) -> int:
    """Bytes of one frame's K6 table (C int32), sums (3C uint32 low and 3C
    high words, where summed) and extremes (4C int32, where kept): the
    kernel keeps them in shared memory where they fit K6_SMEM_BYTES, else
    in k6_workspace's global arrays (csrc/ccl.cu k6_frame_bytes)."""
    return C * ((24 if sums else 0) + (16 if box else 0) + 4)


def k6_workspace(N: int, H: int, W: int, connectivity: int, C: int, derive: bool,
                 sums: bool, box: bool):
    """K6's scratch in one workspace tensor: ({name: (byte offset, bytes)},
    total bytes), each array 16-byte aligned, for root-key labels (N, H, W)
    and C components: list, lrc and loff (a strip each: the occupied strips
    in order, their roots, the rank of their first root); deriving the
    occupancy, rcs (each strip's roots) and docc (its foreground, a byte);
    where a frame's arrays pass shared memory (k6_frame_bytes), table, acc
    (the sums, where summed: 3 uint32 low words a component, then 3 high
    words) and box (the extremes, where kept, 4 int32)."""
    R, S = root_strip_shape(H, W, connectivity)
    Q = R * S
    sizes = {"list": 4 * N * Q, "lrc": 4 * N * Q, "loff": 4 * N * Q}
    if derive:
        sizes.update(rcs=4 * N * Q, docc=N * Q)
    if k6_frame_bytes(C, sums, box) > K6_SMEM_BYTES:
        sizes["table"] = 4 * N * C
        if sums:
            sizes["acc"] = 24 * N * C
        if box:
            sizes["box"] = 16 * N * C
    return _aligned_layout(sizes)


def _root_stats_launch(root, C, connectivity, strip_occ, count, sums=None, lohi=None,
                       labels=None, stats=None, with_bbox=False, zero=None):
    """One launch of tpuva_root_stats on root (N, H, W) int32, N > 0,
    contiguous on the card, over strip_occ's strips or deriving them: the
    count into count, the raw sums, extremes and ids into the tensors given,
    and with stats (stats_views with its bbox) the stats dict, its bbox
    computed where with_bbox; zero, a word set to 0."""
    N, H, W = root.shape
    dev = root.device
    derive = strip_occ is None
    acc_sums = sums is not None or stats is not None
    acc_box = lohi is not None or (stats is not None and with_bbox)
    layout, total = k6_workspace(N, H, W, connectivity, C, derive, acc_sums, acc_box)
    ws = torch.empty((max(total, 16),), dtype=torch.uint8, device=dev)  # H * W == 0: no strips
    at = lambda name: ws.data_ptr() + layout[name][0] if name in layout else None  # noqa: E731
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    st = stats or {}
    _build.launch(
        dev, "tpuva_root_stats", "root stats kernel", root.data_ptr(), N, H, W, connectivity, C, ptr(strip_occ),
        *(at(k) for k in ("docc", "rcs", "list", "lrc", "loff", "table", "acc", "box")),
        count.data_ptr(), ptr(sums), ptr(lohi), ptr(labels),
        *(ptr(st.get(k)) for k in ("area", "centroid", "centroid_sum", "overflow", "bbox")),
        ptr(zero), int(with_bbox),
    )
    root_stats.launches += 1
    root_stats.occ_launches += not derive


root_stats.launches = 0  # every K6 launch (root_stats and root_stats_dict)
root_stats.occ_launches = 0  # those given the caller's strip_occ (K3's)
