// 8-connected CCL + per-component stats (kernel K2), dense root-key labels
// (K3) and the dense stats of root-key labels (K6) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel tpuva/ops/pallas/ccl.py::
// label_components_tiled_raw together with the XLA stats step
// tpuva/ops/label.py::_stats_from_compact and the epilogue :494
// _assemble_stats. The plain PyTorch version is tpuva_torch/ops/ccl.py::
// label_sums_plain followed by tpuva_torch/ops/label.py::_assemble_stats;
// the two are bit-equal. Entry point tpuva_ccl_stats.
//
// Algorithm. The Pallas kernel is correct only because TPU grid steps run
// one after another in raster order (ccl.py:4-10); CUDA blocks run in no
// order, so this is block-based union-find over 2x2 blocks (Allegretti,
// Bolelli & Grana, "Optimized Block-Based Algorithms to Label Connected
// Components on GPUs", IEEE TPDS 2020, BKE). Any two pixels of a 2x2 block
// are 8-adjacent, so at most one component touches a block. Union always
// links the larger root under the smaller one with atomicMin, so every
// root is its component's minimum block index, and ascending root index is
// cv2's BBDT id order (tpuva's _scan_key order) with no key map.
//
// Occupancy. Like the Pallas kernel (its strip_occ argument), K2 visits
// only occupied strips: a strip is one block row x 128 blocks (2 rows x
// 256 pixels), and strip_occ (N, Hb, S) u8, S = ceil(Wb / 128), says which
// hold foreground. The caller passes it (the staged route takes it from
// K1's padded_occ emit) or K2 derives it from the mask. K2 refines it to
// segments (a strip's four quarters of 32 blocks, the width of a tile):
// it reads the mask of the occupied strips only (of every strip where it
// derives the occupancy) and keeps, for each strip, which of its segments
// hold foreground. Tiles are 16 x 32 blocks, so a tile's row is one
// segment; only the tiles with foreground are visited, and inside a tile
// only its rows whose segment holds foreground: no other mask byte, parent
// or flag is read or written. Every read of a neighbour's flags first
// checks the neighbour's segment.
//
// K2 is one persistent kernel, ccl_stats_persistent, launched once a call
// with cudaLaunchCooperativeKernel on as many CTAs as the card holds at
// once (the occupancy query x the SMs); its phases are joined by
// grid.sync() and each CTA takes every gridDim.x-th item of a phase:
//   A  the segment occupancy: a warp a strip reads its 512 mask bytes (16
//      a lane), only for the strips strip_occ calls occupied where it is
//      given; the list's count zeroed;
//   B  a thread a group of 16 strips of one strip column: the root counts
//      of its strips with foreground zeroed, and each of its tiles (up to
//      four) that holds foreground appended to one batch-wide list, with
//      its live rows;
//   C  a CTA a listed tile: its block flags from the mask, union inside the
//      tile in shared memory (path splitting in its finds), flattened
//      parents of its foreground blocks written as frame-global block
//      indices (local_union);
//   D  union across the listed tiles' borders in global memory (the top
//      row and the first and last columns; border_item), eight tiles a CTA;
//   E  every foreground block points at its root; each tile row (a warp)
//      adds its roots to its strip's count;
//   F  a CTA a frame: a block scan of the occupied strips' root counts in
//      strip order gives each strip's first rank; the strips holding one of
//      the first C roots write them ascending into the frame's table (a
//      warp a strip); count = min(roots, C); the frame's sums zeroed;
//   G  a CTA a listed tile: each foreground block's root's rank by binary
//      search in the table, its area, sum x and sum y summed over the
//      warp's blocks of that rank, one atomic add each into wrapping 32-bit
//      sums (the epilogue wraps them to int32 anyway). Integer atomics make
//      the result independent of their order;
//   H  a warp a frame: the stats epilogue, writing the stats dict's
//      tensors (count, area, centroid, centroid_sum, overflow).
// No CTA is launched for an empty tile, and no torch op runs besides the
// wrapper's two allocations. K3 (8-connected, below) runs the same
// union-find (border_item; local_union is ccl_local's with runs) as its own
// launch sequence.
// Where the caller asks (phase_ns), CTA 0 records %globaltimer after each
// phase's barrier: chip_smoke.py --k2 prints the phases' times from it.
//
// What bounds it on an H100: memory — the mask read (1 B/px) and the
// parent/flag arrays (1.25 B/px written, read three or four times), of
// the segments with foreground only; where the occupancy is derived, phase
// A reads the whole mask once. On a sparse frame (the bench clip: about 3%
// of the strips occupied) what is left is the latency of the phases'
// chains (a tile's union-find in shared memory, a frame's root scan) and of
// the seven grid barriers.
//
// Dense root-key labels (kernel K3), entry point tpuva_ccl_labels.
//
// Replaces the Pallas TPU kernel tpuva/ops/pallas/ccl.py::
// label_components_tiled: per pixel, its component's minimum scan key + 1
// (tpuva's _scan_key), 0 for background. The plain PyTorch version is
// tpuva_torch/ops/label.py::label_components; the two are bit-equal.
//   8-connectivity: ccl_occ derives the strip occupancy (one read of the
//     mask, 16 bytes a lane), ccl_tiles lists the occupied tiles, and
//     ccl_local, ccl_border and ccl_flatten_tiles run over that list only,
//     as K2's do. ccl_labels8 then gives each thread a 2 x 4 pixel group
//     (two blocks of one block row) and writes it as two 16-byte stores:
//     zeros where the occupancy calls the strip empty, with no read of its
//     mask, parents or flags; else, from the two blocks' flags (a block's
//     four mask bits) and one parent a foreground block, the label
//     4 * root_block + ctz(bits[root_block]) + 1 of each set pixel. The
//     scan key is K = 4 * block + within (within = 2 * (y & 1) + (x & 1),
//     the bit order of the block flags), the root is the component's
//     minimum block, and every set pixel of that block belongs to the
//     component, so its lowest set bit is the minimum key. The occupancy
//     is handed back to the caller: K6 (below) reads only its strips.
//   4-connectivity: diagonal pixels of a 2x2 block are not 4-adjacent, so
//     union-find runs on pixels, by the same route over K6's 4-connected
//     strips (one row x 512 pixels) and their segments (32 pixels, a tile
//     row's width). ccl4_occ derives the strip occupancy (handed back, as
//     8-connected) and each strip's segments with foreground (one read of
//     the mask); ccl4_tiles lists each frame's 16 x 32-pixel tiles with
//     foreground and their live rows; ccl4_local runs the union inside the
//     listed tiles only (a row's runs linked by a ballot, up links in
//     shared memory), ccl4_border on their top rows and first columns only,
//     both with the labels buffer as the parent array (an entry is the
//     parent's raster index + 1, so a root's entry is already its label);
//     ccl4_labels (a thread 4 pixels) writes every label as 16-byte stores:
//     zeros for a segment without foreground, with no other read, else each
//     foreground pixel's root + 1 (its walk ends at the root while others
//     rewrite entries to their roots' labels). Roots are each component's minimum raster index,
//     the 4-connected scan key, linked by atomicMin; no link is ever made
//     across a diagonal.
// What bounds it on an H100: memory. The floor is the mask read (1 B/px)
// and the int32 label write (4 B/px), 2.65 GB per 256-frame 1080p batch,
// 0.79 ms at 3.35 TB/s; the label write dominates. ccl_occ's and ccl4_occ's
// read is that mask read, the union-find touches only occupied strips (4-
// connected: segments), and the label write is 16-byte stores, coalesced
// along each row.
//
// Dense stats of root-key labels (kernel K6), entry point tpuva_root_stats.
//
// Replaces tpuva/ops/label.py::_stats_from_root (its dense branch; its
// sparse_strips branch already gates the stats on strip occupancy),
// relabel_dense and the stats epilogue (:494 _assemble_stats and the
// bbox), XLA on the TPU. The plain PyTorch version is tpuva_torch/ops/
// label.py::root_stats_plain (a root compare, nonzero, searchsorted and
// index_add_/scatter_reduce_) followed by _stats_dict; the two are
// bit-equal. Input: root-key labels (N, H, W) int32, as K3 or
// label_components give them. Strips follow the scan-key order, 512 keys
// each: 8-connected a strip is 2 rows x 256 columns (128 blocks, K3's
// strips), 4-connected 512 columns of one row (K3's too). A warp takes a
// strip, 16 labels a lane (16-byte loads where W % 4 == 0), in key order.
// One launch a call, k6_frame, a CTA a frame, for every option (the stats
// dict with or without its bbox and dense ids; the raw sums, extremes and
// ids): the occupied strips (given, or read from the labels), their roots
// (label == key + 1, the key from (y, x), no key map read) scanned in strip
// order into a table of the first C root keys, the sums and extremes added
// over the occupied strips, then the stats epilogue it shares with K2
// (stats_epilogue), all joined by the CTA's barriers. The table and the
// sums (32-bit words and their carries) live in shared memory where they
// fit 48 KB, else in global scratch, in the same launch. Integer atomics
// make every sum independent of their order. What bounds it on an H100:
// memory. Given K3's occupancy, the labels of the occupied strips (3% of
// the bench clip's) and the outputs; deriving it, one read of the labels
// (2.12 GB a 256-frame 1080p batch, 0.634 ms at 3.35 TB/s); with labels,
// the 2.12 GB write besides. No host sync anywhere.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int SW = 128;            // strip width, in 2x2 blocks
constexpr int TBY = 16, TBX = 32;  // a tile, in 2x2 blocks: a quarter of 16 strips
constexpr int kTileThreads = TBY * TBX;
constexpr int kBorderThreads = 64;  // a tile's top row, first and last columns (62)
constexpr int kTilesPerCta = 16;   // listed tiles a CTA of the listed kernels takes at most
constexpr int T4Y = 16, T4X = 32;  // a K3 4-connected tile, in pixels: a row is a warp
constexpr int kFlatThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kOccWarps = 8;       // ccl_occ: strips a CTA

// block flag bits: 1 = (y, x), 2 = (y, x+1), 4 = (y+1, x), 8 = (y+1, x+1)
__device__ __forceinline__ bool link_left(int l, int b) { return (l & 0xA) && (b & 0x5); }
__device__ __forceinline__ bool link_up(int u, int b) { return (u & 0xC) && (b & 0x3); }
__device__ __forceinline__ bool link_upleft(int ul, int b) { return (ul & 0x8) && (b & 0x1); }
__device__ __forceinline__ bool link_upright(int ur, int b) { return (ur & 0x4) && (b & 0x2); }

// The root of i, where par[i] holds i's parent + kOff (kOff = 1: K3
// 4-connected's labels buffer, whose entries are labels).
template <int kOff = 0>
__device__ __forceinline__ int find_root(const int* par, int i) {
  const volatile int* vp = par;
  int p = vp[i] - kOff;
  while (p != i) {
    i = p;
    p = vp[i] - kOff;
  }
  return i;
}

// find_root that points each node on the way at its grandparent (path
// splitting). Parents only ever point at smaller indices, and a store
// points a node at a node that was its ancestor: a link an atomicMin made
// on a node that was no longer a root may be overwritten, but unite
// retries that link. A store of a final root into par (a flatten pass)
// may itself be overwritten, so the passes that do that use find_root.
__device__ __forceinline__ int find_compress(int* par, int i) {
  volatile int* vp = par;
  int p = vp[i];
  while (p != i) {
    const int gp = vp[p];
    if (gp != p) vp[i] = gp;
    i = p;
    p = gp;
  }
  return i;
}

// Link the roots of a and b, the larger under the smaller (with path
// splitting in the finds where kCompress: a tile's union in shared memory;
// par's entries parents + kOff, as find_root's).
template <bool kCompress, int kOff = 0>
__device__ void unite(int* par, int a, int b) {
  static_assert(!(kCompress && kOff), "path splitting stores plain parents");
  while (true) {
    a = kCompress ? find_compress(par, a) : find_root<kOff>(par, a);
    b = kCompress ? find_compress(par, b) : find_root<kOff>(par, b);
    if (a == b) return;
    if (a < b) {
      const int old = atomicMin(&par[b], a + kOff) - kOff;
      if (old == b) return;
      b = old;
    } else {
      const int old = atomicMin(&par[a], b + kOff) - kOff;
      if (old == a) return;
      a = old;
    }
  }
}

// Frame geometry in blocks and strips; occ is the frame's (Hb, S) strip
// occupancy, or null for "every strip occupied". The mask's frames lie fs
// bytes apart, and its row y is the frame's row y + r0: rows 0 .. r0 - 1
// of the frame are blank (KB-labels, below, labels a band whose first row
// is odd in the image as a frame with one blank row above it, r0 = 1).
struct Geom {
  int H, W, Hb, Wb, S, TY, TX;  // S: strips a block row; TY, TX: tiles
  int r0;
  long long fs;
  __host__ __device__ int tiles() const { return TY * TX; }
};

Geom geom(int H, int W) {
  Geom g;
  g.H = H; g.W = W;
  g.Hb = (H + 1) / 2; g.Wb = (W + 1) / 2;
  g.S = (g.Wb + SW - 1) / SW;
  g.TY = (g.Hb + TBY - 1) / TBY;
  g.TX = (g.Wb + TBX - 1) / TBX;
  g.r0 = 0;
  g.fs = (long long)H * W;
  return g;
}

// Row y of frame n of the mask (y >= g.r0).
__device__ __forceinline__ const uint8_t* mask_row(const uint8_t* mask, const Geom& g, int n,
                                                   int y) {
  return mask + size_t(n) * g.fs + size_t(y - g.r0) * g.W;
}

__device__ __forceinline__ bool strip_occupied(const uint8_t* occ, const Geom& g, int by, int bx) {
  return occ == nullptr || occ[by * g.S + bx / SW] != 0;
}

// K2's segment occupancy: a strip's byte holds bit k where its segment k
// (blocks 32k .. 32k + 31 of the strip, tile column 4 * sx + k) holds
// foreground.
__device__ __forceinline__ bool seg_occupied(const uint8_t* fine, const Geom& g, int by, int bx) {
  return (fine[by * g.S + bx / SW] >> ((bx % SW) / TBX)) & 1;
}
template <bool kSeg>
__device__ __forceinline__ bool occupied(const uint8_t* o, const Geom& g, int by, int bx) {
  return kSeg ? seg_occupied(o, g, by, bx) : strip_occupied(o, g, by, bx);
}

// Exclusive rank of flag among the CTA's threads in thread order, and the
// number of flags set; every thread of the CTA calls it (barriers inside).
__device__ int2 block_rank(bool flag, int* warp_incl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const unsigned bal = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_incl[warp] = __popc(bal);
  __syncthreads();
  if (warp == 0) {
    int v = lane < nw ? warp_incl[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    if (lane < nw) warp_incl[lane] = v;
  }
  __syncthreads();
  const int2 r = make_int2((warp ? warp_incl[warp - 1] : 0) + __popc(bal & ((1u << lane) - 1u)),
                           warp_incl[nw - 1]);
  __syncthreads();  // warp_incl is reused by the next call
  return r;
}

// The tiles the CTA takes, k = blockIdx.x, + gridDim.x, ...: the frame's
// listed tiles, or with no list every tile of the frame.
struct TileWalk {
  const int* list;
  int n;
  __device__ TileWalk(const int* tiles, const int* ntiles, const Geom& g, int frame)
      : list(tiles ? tiles + size_t(frame) * g.tiles() : nullptr),
        n(tiles ? ntiles[frame] : g.tiles()) {}
  __device__ int tile(int k) const { return list ? list[k] : k; }
};

// Whether the first min(16, avail) bytes at p hold a nonzero one: one
// 16-byte load where they are 16 and p is 16-byte aligned.
__device__ __forceinline__ bool any16(const uint8_t* p, int avail) {
  if (avail >= 16 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    return (v.x | v.y | v.z | v.w) != 0;
  }
  bool fg = false;
  for (int i = 0; i < 16 && i < avail; ++i) fg |= p[i] != 0;
  return fg;
}

// This lane's 16 bytes of strip s (of the flattened N x Hb x S) of the
// mask, 2 rows x 256 pixels a warp (lanes 0-15 the first row): whether
// they hold foreground.
__device__ __forceinline__ bool strip_lane_fg(const uint8_t* __restrict__ mask, const Geom& g,
                                              size_t s) {
  const int lane = threadIdx.x & 31;
  const int n = int(s / (size_t(g.Hb) * g.S));
  const int r = int(s % (size_t(g.Hb) * g.S));
  const int y = 2 * (r / g.S) + (lane >> 4), x = (r % g.S) * 2 * SW + 16 * (lane & 15);
  return y < g.H && y >= g.r0 && x < g.W && any16(mask_row(mask, g, n, y) + x, g.W - x);
}

// Strip s of the occupancy from the mask: a warp; every lane calls it.
__device__ __forceinline__ void occ_strip(const uint8_t* __restrict__ mask, const Geom& g,
                                          uint8_t* __restrict__ occ, size_t s) {
  const bool fg = __any_sync(0xffffffffu, strip_lane_fg(mask, g, s));
  if ((threadIdx.x & 31) == 0) occ[s] = fg;
}

// Strip s's segment occupancy (seg_occupied's byte) from the mask: a warp;
// every lane calls it and gets it. Segment k is 64 pixels of both rows,
// lanes 4k .. 4k + 3 and 16 + 4k .. 16 + 4k + 3.
__device__ __forceinline__ unsigned strip_segments(const uint8_t* __restrict__ mask,
                                                   const Geom& g, size_t s) {
  const unsigned m = __ballot_sync(0xffffffffu, strip_lane_fg(mask, g, s));
  const unsigned rows = m | (m >> 16);
  unsigned seg = 0;
  for (int k = 0; k < SW / TBX; ++k) seg |= ((rows >> (4 * k)) & 0xFu) ? 1u << k : 0u;
  return seg;
}

// Strip occupancy from the mask: one warp a strip.
__global__ void __launch_bounds__(32 * kOccWarps)
ccl_occ(const uint8_t* __restrict__ mask, int N, Geom g, uint8_t* __restrict__ occ) {
  const size_t s = size_t(blockIdx.x) * kOccWarps + (threadIdx.x >> 5);
  if (s < size_t(N) * g.Hb * g.S) occ_strip(mask, g, occ, s);
}

// Each frame's tiles holding an occupied strip, ascending: tiles (N, TY*S),
// ntiles (N,).
__global__ void __launch_bounds__(kScanThreads)
ccl_tiles(Geom g, const uint8_t* __restrict__ occ, int* __restrict__ tiles,
          int* __restrict__ ntiles) {
  __shared__ int warp_incl[32];
  const int n = blockIdx.x;
  const uint8_t* o = occ + size_t(n) * g.Hb * g.S;
  const int T = g.tiles();
  int running = 0;
  for (int base = 0; base < T; base += kScanThreads) {
    const int t = base + threadIdx.x;
    bool flag = false;
    if (t < T) {
      const int ty = t / g.TX, sx = (t % g.TX) * TBX / SW;
      for (int by = ty * TBY; by < min(ty * TBY + TBY, g.Hb); ++by) flag |= o[by * g.S + sx] != 0;
    }
    const int2 r = block_rank(flag, warp_incl);
    if (flag) tiles[size_t(n) * T + running + r.x] = t;
    running += r.y;
  }
  if (threadIdx.x == 0) ntiles[n] = running;
}

// K2's union inside tile t of frame n, given this thread's block (by, bx),
// whether it is live (inside the frame, its segment holding foreground) and
// its flags bb: in shared memory (par, bits: kTileThreads each; path
// splitting in its finds), the foreground blocks' flattened parents
// written as frame-global block indices (no phase of K2 reads a background
// block's parent). A tile row is a warp, and each run of blocks linked to
// their left neighbours points at its first block at once (a ballot), so
// that the unions link runs and no chain grows along a row (ccl_local's
// unions, one a link, leave chains as long as a row). Every thread of the
// CTA calls it (barriers inside); par and bits are free again when it
// returns.
__device__ __forceinline__ void local_union(const Geom& g, int n, int by, int bx, bool live,
                                            int bb, int* __restrict__ parent,
                                            uint8_t* __restrict__ bits_g, int* par,
                                            uint8_t* bits) {
  static_assert(TBX == 32, "a tile row is a warp");
  const int li = threadIdx.x;
  const int ty = li / TBX, tx = li % TBX;
  bits[li] = (uint8_t)bb;
  const int left = __shfl_up_sync(0xffffffffu, bb, 1);
  const unsigned starts = __ballot_sync(0xffffffffu, !(tx > 0 && link_left(left, bb)));
  const unsigned upto = tx == TBX - 1 ? 0xffffffffu : (2u << tx) - 1u;
  par[li] = ty * TBX + 31 - __clz(starts & upto);
  __syncthreads();
  if (bb && ty > 0) {
    const int u = li - TBX;
    if (link_up(bits[u], bb)) unite<true>(par, li, u);
    if (tx > 0 && link_upleft(bits[u - 1], bb)) unite<true>(par, li, u - 1);
    if (tx < TBX - 1 && link_upright(bits[u + 1], bb)) unite<true>(par, li, u + 1);
  }
  __syncthreads();
  if (live) {
    const size_t gi = size_t(n) * g.Hb * g.Wb + size_t(by) * g.Wb + bx;
    if (bb) {
      const int lr = find_compress(par, li);
      parent[gi] = (by - ty + lr / TBX) * g.Wb + bx - tx + lr % TBX;
    }
    bits_g[gi] = (uint8_t)bb;
  }
  __syncthreads();  // par and bits are the next tile's
}

__global__ void __launch_bounds__(kTileThreads)
ccl_local(const uint8_t* __restrict__ mask, Geom g, const uint8_t* __restrict__ occ,
          const int* __restrict__ tiles, const int* __restrict__ ntiles,
          int* __restrict__ parent, uint8_t* __restrict__ bits_g) {
  __shared__ int par[kTileThreads];
  __shared__ uint8_t bits[kTileThreads];
  const int n = blockIdx.y;
  const TileWalk walk(tiles, ntiles, g, n);
  const uint8_t* o = occ ? occ + size_t(n) * g.Hb * g.S : nullptr;
  const int li = threadIdx.x;
  const int ty = li / TBX, tx = li % TBX;
  for (int k = blockIdx.x; k < walk.n; k += gridDim.x) {
    const int t = walk.tile(k);
    const int by = (t / g.TX) * TBY + ty, bx = (t % g.TX) * TBX + tx;
    const bool live = by < g.Hb && bx < g.Wb && strip_occupied(o, g, by, bx);
    int bb = 0;
    if (live) {
      const int y = 2 * by, x = 2 * bx;
      if (y >= g.r0) {
        const uint8_t* row = mask_row(mask, g, n, y);
        bb |= row[x] != 0;
        if (x + 1 < g.W) bb |= (row[x + 1] != 0) << 1;
      }
      if (y + 1 < g.H) {
        const uint8_t* row = mask_row(mask, g, n, y + 1);
        bb |= (row[x] != 0) << 2;
        if (x + 1 < g.W) bb |= (row[x + 1] != 0) << 3;
      }
    }
    bits[li] = (uint8_t)bb;
    par[li] = li;
    __syncthreads();
    if (bb) {
      if (tx > 0 && link_left(bits[li - 1], bb)) unite<true>(par, li, li - 1);
      if (ty > 0) {
        const int u = li - TBX;
        if (link_up(bits[u], bb)) unite<true>(par, li, u);
        if (tx > 0 && link_upleft(bits[u - 1], bb)) unite<true>(par, li, u - 1);
        if (tx < TBX - 1 && link_upright(bits[u + 1], bb)) unite<true>(par, li, u + 1);
      }
    }
    __syncthreads();
    if (live) {
      const size_t gi = size_t(n) * g.Hb * g.Wb + size_t(by) * g.Wb + bx;
      int root = by * g.Wb + bx;
      if (bb) {
        const int lr = find_compress(par, li);
        root = (by - ty + lr / TBX) * g.Wb + bx - tx + lr % TBX;
      }
      parent[gi] = root;
      bits_g[gi] = (uint8_t)bb;
    }
    __syncthreads();  // par and bits are the next tile's
  }
}

// Border item i (0..kBorderThreads-1) of tile t of frame n: i < TBX the
// top row, then the first column and the last column below it. occ is the
// frames' strip occupancy, or with kSeg K2's segment occupancy.
template <bool kSeg>
__device__ __forceinline__ void border_item(const Geom& g, const uint8_t* __restrict__ occ,
                                            int n, int t, int i, int* __restrict__ parent,
                                            const uint8_t* __restrict__ bits_g) {
  const uint8_t* o = occ ? occ + size_t(n) * g.Hb * g.S : nullptr;
  int* par = parent + size_t(n) * g.Hb * g.Wb;
  const uint8_t* bits = bits_g + size_t(n) * g.Hb * g.Wb;
  const int by0 = (t / g.TX) * TBY, bx0 = (t % g.TX) * TBX;
  int by, bx;
  if (i < TBX) {
    by = by0; bx = bx0 + i;
  } else if (i < TBX + TBY - 1) {
    by = by0 + 1 + i - TBX; bx = bx0;
  } else if (i < TBX + 2 * (TBY - 1)) {
    by = by0 + 1 + i - TBX - (TBY - 1); bx = bx0 + TBX - 1;
  } else {
    return;
  }
  if (by >= g.Hb || bx >= g.Wb || !occupied<kSeg>(o, g, by, bx)) return;
  const int b = by * g.Wb + bx;
  const int bb = bits[b];
  if (!bb) return;
  const bool left = bx == bx0, top = by == by0, right = bx == bx0 + TBX - 1;
  if (left && bx > 0 && occupied<kSeg>(o, g, by, bx - 1) && link_left(bits[b - 1], bb))
    unite<false>(par, b, b - 1);
  if (by > 0) {
    const int u = b - g.Wb;
    if (top && occupied<kSeg>(o, g, by - 1, bx) && link_up(bits[u], bb)) unite<false>(par, b, u);
    if ((top || left) && bx > 0 && occupied<kSeg>(o, g, by - 1, bx - 1) &&
        link_upleft(bits[u - 1], bb))
      unite<false>(par, b, u - 1);
    if ((top || right) && bx + 1 < g.Wb && occupied<kSeg>(o, g, by - 1, bx + 1) &&
        link_upright(bits[u + 1], bb))
      unite<false>(par, b, u + 1);
  }
}

// Union across tile borders: the tile's top row, and its first and last
// columns below it (the last column's up-right neighbour lies in the next
// tile). A neighbour's flags are read only where its strip is occupied.
__global__ void __launch_bounds__(kBorderThreads)
ccl_border(Geom g, const uint8_t* __restrict__ occ, const int* __restrict__ tiles,
           const int* __restrict__ ntiles, int* __restrict__ parent,
           const uint8_t* __restrict__ bits_g) {
  const int n = blockIdx.y;
  const TileWalk walk(tiles, ntiles, g, n);
  for (int k = blockIdx.x; k < walk.n; k += gridDim.x)
    border_item<false>(g, occ, n, walk.tile(k), threadIdx.x, parent, bits_g);
}

// Every foreground block of the listed tiles' occupied strips points
// at its root (after the last union).
__global__ void __launch_bounds__(kTileThreads)
ccl_flatten_tiles(Geom g, const uint8_t* __restrict__ occ, const int* __restrict__ tiles,
                  const int* __restrict__ ntiles, int* __restrict__ parent,
                  const uint8_t* __restrict__ bits_g) {
  const int n = blockIdx.y;
  const TileWalk walk(tiles, ntiles, g, n);
  const uint8_t* o = occ + size_t(n) * g.Hb * g.S;
  int* par = parent + size_t(n) * g.Hb * g.Wb;
  const uint8_t* bits = bits_g + size_t(n) * g.Hb * g.Wb;
  const int ty = threadIdx.x / TBX, tx = threadIdx.x % TBX;
  for (int k = blockIdx.x; k < walk.n; k += gridDim.x) {
    const int t = walk.tile(k);
    const int by = (t / g.TX) * TBY + ty, bx = (t % g.TX) * TBX + tx;
    if (by >= g.Hb || bx >= g.Wb || !strip_occupied(o, g, by, bx)) continue;
    const int b = by * g.Wb + bx;
    if (bits[b]) par[b] = find_root(par, b);
  }
}

// One thread a 2 x 4 pixel group, blocks (by, 2q) and (by, 2q + 1) of
// frame blockIdx.y: 4 * root block + lowest set bit of its flags + 1 for
// each set pixel, 0 for background, as one 16-byte store a row (scalar
// stores where W % 4 != 0 or the group passes the image's edge). A group
// of an empty strip is written as zeros with no other read; in an occupied
// strip the blocks' flags (their mask bits) say which pixels are set, and
// a foreground block reads its parent and its root's flags.
// Band mode (KB-labels, kBand): each set pixel 4 * root block + lowest set
// bit + B.add (its piece's minimum global scan key), background B.bg, the
// frame's rows r0 .. H - 1 written as rows 0 .. H - r0 - 1 of labels; each
// root block (its parent itself) appends itself to its frame's root list
// and writes its label into val, the piece's value.
struct BandOut {
  int add, bg;       // label = 4 * root + ffs(root flags) + add; background bg
  int* val;          // (N, Hb * Wb): a piece's value at its root block
  int* roots;        // (N, Hb * Wb): each frame's root blocks, nroots[n] of them
  int* nroots;       // (N,), zero before the launch
};

template <bool kBand>
__global__ void __launch_bounds__(kFlatThreads)
ccl_labels8(Geom g, const uint8_t* __restrict__ occ, const int* __restrict__ parent,
            const uint8_t* __restrict__ bits_g, int* __restrict__ labels, BandOut B) {
  const int Q = (g.W + 3) / 4;  // groups a block row
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.Hb * Q) return;
  const int n = blockIdx.y, by = i / Q, q = i - by * Q;
  const int x = 4 * q, y = 2 * by, bx = 2 * q;
  const int add = kBand ? B.add : 0, bg = kBand ? B.bg : 0;
  int4 row[2] = {make_int4(bg, bg, bg, bg), make_int4(bg, bg, bg, bg)};
  if (occ[(size_t(n) * g.Hb + by) * g.S + bx / SW]) {
    const size_t f = size_t(n) * g.Hb * g.Wb;
    int lab[2][4] = {{bg, bg, bg, bg}, {bg, bg, bg, bg}};
    for (int k = 0; k < 2 && bx + k < g.Wb; ++k) {
      const int b = by * g.Wb + bx + k;
      const int bb = bits_g[f + b];
      if (!bb) continue;
      const int r = parent[f + b];
      const int v = 4 * r + __ffs(bits_g[f + r]) + add;  // 4 * r + ctz + 1 + add
      if (kBand && r == b) {
        B.val[f + b] = v;
        B.roots[f + atomicAdd(&B.nroots[n], 1)] = b;
      }
      lab[0][2 * k] = (bb & 1) ? v : bg;
      lab[0][2 * k + 1] = (bb & 2) ? v : bg;
      lab[1][2 * k] = (bb & 4) ? v : bg;
      lab[1][2 * k + 1] = (bb & 8) ? v : bg;
    }
    row[0] = make_int4(lab[0][0], lab[0][1], lab[0][2], lab[0][3]);
    row[1] = make_int4(lab[1][0], lab[1][1], lab[1][2], lab[1][3]);
  }
  const int r0 = kBand ? g.r0 : 0, Ho = g.H - r0;  // the rows labels holds
  for (int k = 0; k < 2 && y + k < g.H; ++k) {
    if (y + k < r0) continue;
    int* p = labels + (size_t(n) * Ho + y + k - r0) * g.W + x;
    if ((g.W & 3) == 0) {  // x + 4 <= W, and the row starts 16-byte aligned
      *reinterpret_cast<int4*>(p) = row[k];
    } else {
      const int v[4] = {row[k].x, row[k].y, row[k].z, row[k].w};
      for (int j = 0; j < 4 && x + j < g.W; ++j) p[j] = v[j];
    }
  }
}

// ---- K3, 4-connected: pixel union-find over the segments with foreground ----

// A frame's 4-connected strips (K6's: 512 pixels of one row, S a row), their
// segments (sixteen runs of 32 pixels, a tile row's width) and its T4Y x T4X
// tiles, TY x TX of them.
constexpr int kStrip4 = 512;
constexpr int kSeg4 = kStrip4 / T4X;  // segments a strip
constexpr int kBorder4 = 64;          // a tile's top row and first column (48 items)

struct Geom4 {
  int H, W, S, TY, TX;
  __host__ __device__ int tiles() const { return TY * TX; }
};

Geom4 geom4(int H, int W) {
  Geom4 g;
  g.H = H; g.W = W;
  g.S = (W + kStrip4 - 1) / kStrip4;
  g.TY = (H + T4Y - 1) / T4Y;
  g.TX = (W + T4X - 1) / T4X;
  return g;
}

// The strip occupancy and segments of the mask, a warp a strip (16 pixels a
// lane; segment k is lanes 2k and 2k + 1): occ (N, H, S) u8, 1 where the
// strip holds foreground (K6's occupancy); seg (N, H, S) u16, bit k where
// its segment k does.
__global__ void __launch_bounds__(32 * kOccWarps)
ccl4_occ(const uint8_t* __restrict__ mask, int N, Geom4 g, uint8_t* __restrict__ occ,
         uint16_t* __restrict__ seg) {
  const size_t s = size_t(blockIdx.x) * kOccWarps + (threadIdx.x >> 5);
  if (s >= size_t(N) * g.H * g.S) return;
  const int lane = threadIdx.x & 31;
  const size_t row = s / g.S;  // n * H + y
  const int x = int(s % g.S) * kStrip4 + 16 * lane;
  const unsigned m = __ballot_sync(0xffffffffu, x < g.W && any16(mask + row * g.W + x, g.W - x));
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < kSeg4; ++k) bits |= ((m >> (2 * k)) & 3u) ? 1u << k : 0u;
  if (lane == 0) {
    occ[s] = bits != 0;
    seg[s] = static_cast<uint16_t>(bits);
  }
}

// Each frame's tiles with foreground, ascending, each with its live rows:
// tiles (N, TY * TX) of t | rows << 16 (bit r where the tile's segment of
// its row r holds foreground), ntiles (N,).
__global__ void __launch_bounds__(kScanThreads)
ccl4_tiles(Geom4 g, const uint16_t* __restrict__ seg, int* __restrict__ tiles,
           int* __restrict__ ntiles) {
  __shared__ int warp_incl[32];
  const int n = blockIdx.x, T = g.tiles();
  const uint16_t* sg = seg + size_t(n) * g.H * g.S;
  int running = 0;
  for (int base = 0; base < T; base += kScanThreads) {
    const int t = base + threadIdx.x;
    unsigned rows = 0;
    if (t < T) {
      const int y0 = (t / g.TX) * T4Y, tx = t % g.TX;
      const int c = tx / kSeg4, b = tx % kSeg4;
      for (int r = 0; r < T4Y && y0 + r < g.H; ++r)
        rows |= ((unsigned(sg[(y0 + r) * g.S + c]) >> b) & 1u) << r;
    }
    const int2 k = block_rank(rows != 0, warp_incl);
    if (rows) tiles[size_t(n) * T + running + k.x] = int(unsigned(t) | rows << 16);
    running += k.y;
  }
  if (threadIdx.x == 0) ntiles[n] = running;
}

// This thread's pixel (y, x) of a listed tile (item: t | rows << 16) and
// whether it is live: inside the frame, its row's segment holding
// foreground.
__device__ __forceinline__ bool tile4_px(const Geom4& g, int item, int* y, int* x) {
  const int t = item & 0xffff, ty = threadIdx.x / T4X;
  *y = (t / g.TX) * T4Y + ty;
  *x = (t % g.TX) * T4X + threadIdx.x % T4X;
  return *y < g.H && *x < g.W && ((unsigned(item) >> (16 + ty)) & 1u);
}

// The union inside each listed tile of frame blockIdx.y (the CTA takes every
// gridDim.x-th), a thread a pixel: a tile row is a warp, each run of
// foreground pixels points at its first pixel at once (a ballot), then the
// up links are united in shared memory (path splitting in the finds). Each
// pixel of a live row gets its tile-local root's frame raster index + 1, 0
// for background: the labels buffer is the parent array, each entry the
// parent's index + 1. The next tile's list entry and mask byte are loaded
// before this tile's barriers.
__global__ void __launch_bounds__(T4Y * T4X)
ccl4_local(const uint8_t* __restrict__ mask, Geom4 g, const int* __restrict__ tiles,
           const int* __restrict__ ntiles, int* __restrict__ labels) {
  __shared__ int par[T4Y * T4X];
  __shared__ uint8_t fgs[T4Y * T4X];
  const int n = blockIdx.y, nt = ntiles[n];
  int k = blockIdx.x;
  if (k >= nt) return;  // CTA-uniform
  const int* list = tiles + size_t(n) * g.tiles();
  const uint8_t* m = mask + size_t(n) * g.H * g.W;
  int* lab = labels + size_t(n) * g.H * g.W;
  const int li = threadIdx.x, ty = li / T4X, tx = li % T4X;
  // the mask byte of this thread's pixel of an item, 0 where it is not live
  auto byte_of = [&](int item) -> uint8_t {
    int y, x;
    return tile4_px(g, item, &y, &x) ? m[y * g.W + x] : 0;
  };
  int item = list[k];
  uint8_t mv = byte_of(item);
  int item_next = k + int(gridDim.x) < nt ? list[k + gridDim.x] : 0;
  for (; k < nt; k += gridDim.x) {
    int y, x;
    const bool live = tile4_px(g, item, &y, &x);
    const bool fg = live && mv;
    const int kn = k + gridDim.x;
    const uint8_t mv_next = kn < nt ? byte_of(item_next) : 0;
    const int item_after = kn + int(gridDim.x) < nt ? list[kn + gridDim.x] : 0;
    fgs[li] = fg;
    const int left = __shfl_up_sync(0xffffffffu, int(fg), 1);
    const unsigned starts = __ballot_sync(0xffffffffu, !(tx > 0 && left && fg));
    const unsigned upto = tx == T4X - 1 ? 0xffffffffu : (2u << tx) - 1u;
    par[li] = ty * T4X + 31 - __clz(starts & upto);
    __syncthreads();
    if (fg && ty > 0 && fgs[li - T4X]) unite<true>(par, li, li - T4X);
    __syncthreads();
    if (live) {
      int v = 0;
      if (fg) {
        const int lr = find_compress(par, li);
        v = (y - ty + lr / T4X) * g.W + x - tx + lr % T4X + 1;
      }
      lab[y * g.W + x] = v;
    }
    __syncthreads();  // par and fgs are the next tile's
    item = item_next;
    item_next = item_after;
    mv = mv_next;
  }
}

// Union across the listed tiles' top rows and first columns in the labels
// buffer (each entry a parent's index + 1), kTileThreads / kBorder4 tiles a
// CTA a step: a pixel and its neighbour above (top row) or to its left
// (first column) are united where both are foreground. A foreground pixel's
// row is live, so its entry holds a parent.
__global__ void __launch_bounds__(kTileThreads)
ccl4_border(const uint8_t* __restrict__ mask, Geom4 g, const int* __restrict__ tiles,
            const int* __restrict__ ntiles, int* __restrict__ labels) {
  constexpr int kPer = kTileThreads / kBorder4;
  const int n = blockIdx.y, nt = ntiles[n];
  const int* list = tiles + size_t(n) * g.tiles();
  const uint8_t* m = mask + size_t(n) * g.H * g.W;
  int* lab = labels + size_t(n) * g.H * g.W;
  const int i = threadIdx.x % kBorder4;
  for (int k = blockIdx.x * kPer + threadIdx.x / kBorder4; k < nt; k += gridDim.x * kPer) {
    const int t = list[k] & 0xffff;
    const int y0 = (t / g.TX) * T4Y, x0 = (t % g.TX) * T4X;
    int y, x, d;
    if (i < T4X) {
      y = y0; x = x0 + i; d = g.W;
      if (y == 0) continue;
    } else if (i < T4X + T4Y) {
      y = y0 + i - T4X; x = x0; d = 1;
      if (x == 0) continue;
    } else {
      continue;
    }
    if (y >= g.H || x >= g.W) continue;
    const int p = y * g.W + x;
    if (m[p] && m[p - d]) unite<false, 1>(lab, p, p - d);
  }
}

// One thread a 4-pixel group of one row of frame blockIdx.y, written as one
// 16-byte store (scalar stores where W % 4 != 0): zeros where the group's
// segment holds no foreground, with no other read; else each foreground
// pixel's root (its chain of entries, each an ancestor's index + 1) + 1, 0
// for background. An entry changes only to its root's encoding while other
// threads walk it, so every walk ends at the root. (A thread a group keeps
// more walks in flight on a dense mask than a warp a strip, which measured
// slower.)
__global__ void __launch_bounds__(kFlatThreads)
ccl4_labels(const uint8_t* __restrict__ mask, Geom4 g, const uint16_t* __restrict__ seg,
            int* __restrict__ labels) {
  const int Q = (g.W + 3) / 4;  // groups a row
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.H * Q) return;
  const int n = blockIdx.y, y = i / Q, x = 4 * (i - y * Q);
  const size_t f = size_t(n) * g.H * g.W;
  int v[4] = {0, 0, 0, 0};
  const unsigned live = seg[(size_t(n) * g.H + y) * g.S + x / kStrip4];
  if ((live >> ((x % kStrip4) / T4X)) & 1u) {
    const uint8_t* row = mask + f + size_t(y) * g.W;
    for (int j = 0; j < 4 && x + j < g.W; ++j)
      if (row[x + j]) v[j] = find_root<1>(labels + f, y * g.W + x + j) + 1;
  }
  int* p = labels + f + size_t(y) * g.W + x;
  if ((g.W & 3) == 0) {  // x + 4 <= W, and the row starts 16-byte aligned
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < 4 && x + j < g.W; ++j) p[j] = v[j];
  }
}

// ---- K6: the dense stats of root-key labels: strips and helpers ----

// K6's strips: R rows of S strips, 512 scan keys each, in key order.
// 8-connected: rows 2r, 2r + 1 x columns 256c .. 256c + 255 (K3's strips);
// 4-connected: row r x columns 512c .. 512c + 511.
struct SGeom {
  int H, W, Wb, R, S;
  int vec;  // W % 4 == 0 and the buffers 16-byte aligned: 16-byte accesses
  __host__ __device__ int strips() const { return R * S; }
};

SGeom sgeom(int H, int W, int conn, bool aligned) {
  SGeom g;
  g.H = H; g.W = W; g.Wb = (W + 1) / 2;
  g.R = conn == 8 ? (H + 1) / 2 : H;
  g.S = conn == 8 ? (g.Wb + SW - 1) / SW : (W + 511) / 512;
  g.vec = aligned && (W & 3) == 0;
  return g;
}

// Element e (0..15) of lane `lane` in strip (r, c): its (x, y) and scan key.
// 8-connected: lane l holds blocks 4l .. 4l + 3 of the strip, each block's
// pixels in the order of its flag bits; 4-connected: columns 16l .. 16l + 15.
template <int kConn>
__device__ __forceinline__ void strip_px(const SGeom& g, int r, int c, int lane, int e,
                                         int& x, int& y, int& key) {
  if (kConn == 8) {
    const int j = e >> 2, w = e & 3;
    y = 2 * r + (w >> 1);
    x = 2 * (SW * c + 4 * lane + j) + (w & 1);
    key = 4 * (r * g.Wb + SW * c + 4 * lane + j) + w;
  } else {
    y = r;
    x = 512 * c + 16 * lane + e;
    key = y * g.W + x;
  }
}

// n consecutive int32 of row y from column x0 (0 outside the image).
template <int kN>
__device__ __forceinline__ void load_row(const int* frame, const SGeom& g, int y, int x0,
                                         int* v) {
  if (y >= g.H) {
    for (int i = 0; i < kN; ++i) v[i] = 0;
    return;
  }
  const int* p = frame + size_t(y) * g.W + x0;
  if (g.vec && x0 + kN <= g.W) {
    for (int i = 0; i < kN; i += 4) {
      const int4 q = *reinterpret_cast<const int4*>(p + i);
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else {
    for (int i = 0; i < kN; ++i) v[i] = x0 + i < g.W ? p[i] : 0;
  }
}

template <int kN>
__device__ __forceinline__ void store_row(int* frame, const SGeom& g, int y, int x0,
                                          const int* v) {
  if (y >= g.H) return;
  int* p = frame + size_t(y) * g.W + x0;
  if (g.vec && x0 + kN <= g.W) {
    for (int i = 0; i < kN; i += 4)
      *reinterpret_cast<int4*>(p + i) = make_int4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
    for (int i = 0; i < kN && x0 + i < g.W; ++i) p[i] = v[i];
  }
}

// The 16 labels of a lane in strip (r, c), in key order.
template <int kConn>
__device__ __forceinline__ void load_strip(const int* frame, const SGeom& g, int r, int c,
                                           int lane, int* v) {
  if (kConn == 8) {
    int a[8], b[8];
    const int x0 = 256 * c + 8 * lane;
    load_row<8>(frame, g, 2 * r, x0, a);
    load_row<8>(frame, g, 2 * r + 1, x0, b);
    for (int j = 0; j < 4; ++j) {
      v[4 * j] = a[2 * j]; v[4 * j + 1] = a[2 * j + 1];
      v[4 * j + 2] = b[2 * j]; v[4 * j + 3] = b[2 * j + 1];
    }
  } else {
    load_row<16>(frame, g, r, 512 * c + 16 * lane, v);
  }
}

template <int kConn>
__device__ __forceinline__ void store_strip(int* frame, const SGeom& g, int r, int c,
                                            int lane, const int* v) {
  if (kConn == 8) {
    int a[8], b[8];
    for (int j = 0; j < 4; ++j) {
      a[2 * j] = v[4 * j]; a[2 * j + 1] = v[4 * j + 1];
      b[2 * j] = v[4 * j + 2]; b[2 * j + 1] = v[4 * j + 3];
    }
    const int x0 = 256 * c + 8 * lane;
    store_row<8>(frame, g, 2 * r, x0, a);
    store_row<8>(frame, g, 2 * r + 1, x0, b);
  } else {
    store_row<16>(frame, g, r, 512 * c + 16 * lane, v);
  }
}

// Index of v in the ascending tab[0, cnt), or -1 (a component past C).
__device__ __forceinline__ int rank_of(const int* tab, int cnt, int v) {
  int lo = 0, hi = cnt;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tab[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo < cnt && tab[lo] == v ? lo : -1;
}

// Exclusive prefix sum of v over the CTA's threads in thread order, and the
// total; every thread of the CTA calls it (barriers inside).
__device__ int2 block_scan(int v, int* warp_incl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? warp_incl[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    if (lane < nw) warp_incl[lane] = w;
  }
  __syncthreads();
  const int2 r = make_int2((warp ? warp_incl[warp - 1] : 0) + incl - v, warp_incl[nw - 1]);
  __syncthreads();  // warp_incl is reused by the next call
  return r;
}

// Bit e: the lane's label e of strip (r, c) is a root (its key + 1).
template <int kConn>
__device__ __forceinline__ unsigned lane_roots(const SGeom& g, int r, int c, int lane,
                                               const int* v) {
  unsigned m = 0;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    int x, y, key;
    strip_px<kConn>(g, r, c, lane, e, x, y, key);
    m |= unsigned(v[e] == key + 1) << e;
  }
  return m;
}

// ---- The stats epilogue, shared by K2 and K6 ----

constexpr float kImax = 2147483520.0f;  // 2^31 - 128, the largest float32 below 2^31

// The stats dict's rows of one frame, a warp (tpuva_torch/ops/label.py::
// _assemble_stats and _stats_dict, bit for bit). sums: 3C (area, sum x,
// sum y of the frame's first C components in cv2 order, zero past its
// count), wrapping 32-bit words. The wrapping int32 totals; row 0,
// the background, by subtraction from the image's totals (area in int32;
// x and y in float32: cx0, cy0 are the image's); centroid = float32 sum /
// float32 area, 0 where the area is 0; centroid_sum the int32 sums (the
// background's clamped to +-(2^31 - 128) and cut toward zero), 0 where the
// area is 0. Where bbox is given (rows of 4): (x, y, w, h) where box, the
// extremes (4C: min x, min y, max x, max y), is given too, the
// background's (0, 0, W, H), a component's from its extremes, zeros where
// the area is 0; all zeros where box is null.
__device__ void stats_epilogue(const unsigned* sums, const int* box, int C, int H, int W,
                               float cx0, float cy0, int* area, float* centroid, int* csum,
                               int* bbox) {
  const int lane = threadIdx.x & 31;
  unsigned ta = 0, tx = 0, ty = 0;
  for (int c = lane; c < C; c += 32) {
    ta += sums[3 * c];
    tx += sums[3 * c + 1];
    ty += sums[3 * c + 2];
  }
  ta = __reduce_add_sync(0xffffffffu, ta);
  tx = __reduce_add_sync(0xffffffffu, tx);
  ty = __reduce_add_sync(0xffffffffu, ty);
  for (int row = lane; row <= C; row += 32) {
    int a, ix, iy;
    float fx, fy;
    if (row == 0) {
      a = int(unsigned(H) * unsigned(W) - ta);
      fx = __fsub_rn(cx0, __int2float_rn(int(tx)));
      fy = __fsub_rn(cy0, __int2float_rn(int(ty)));
      ix = __float2int_rz(fminf(fmaxf(fx, -kImax), kImax));
      iy = __float2int_rz(fminf(fmaxf(fy, -kImax), kImax));
    } else {
      const unsigned* e = sums + 3 * (row - 1);
      a = int(e[0]);
      ix = int(e[1]);
      iy = int(e[2]);
      fx = __int2float_rn(ix);
      fy = __int2float_rn(iy);
    }
    const bool present = a > 0;
    const float fa = __int2float_rn(a > 1 ? a : 1);
    area[row] = a;
    centroid[2 * row] = present ? __fdiv_rn(fx, fa) : 0.0f;
    centroid[2 * row + 1] = present ? __fdiv_rn(fy, fa) : 0.0f;
    csum[2 * row] = present ? ix : 0;
    csum[2 * row + 1] = present ? iy : 0;
    if (bbox) {
      int b[4] = {0, 0, 0, 0};
      if (present && box && row == 0) {
        b[2] = W;
        b[3] = H;
      } else if (present && box) {
        const int* e = box + 4 * (row - 1);
        b[0] = e[0];
        b[1] = e[1];
        b[2] = e[2] - e[0] + 1;
        b[3] = e[3] - e[1] + 1;
      }
      for (int j = 0; j < 4; ++j) bbox[4 * row + j] = b[j];
    }
  }
}

// ---- K6: the dense stats of root-key labels, one CTA a frame ----

constexpr int kK6Threads = 512;
constexpr int kK6Warps = kK6Threads / 32;
constexpr int kListStrips = 16;  // strips a thread of K6's listing takes a step
constexpr int kK6Big = 1 << 30;  // a bbox minimum not yet set (the plain version's)
constexpr int kSmemBytes = 48 * 1024;

// Bytes of a frame's table (C int32), sums (3C low and 3C high words,
// where summed) and extremes (4C int32, where kept): in shared memory where
// they fit kSmemBytes (tpuva_torch/ops/ccl.py::k6_frame_bytes).
__host__ __device__ inline size_t k6_frame_bytes(int C, bool sums, bool box) {
  return size_t(C) * ((sums ? 24 : 0) + (box ? 16 : 0) + 4);
}

struct K6Params {
  const int* root;         // (N, H, W) root-key labels
  SGeom g;
  int N, C;
  const uint8_t* occ;      // (N, Q) the caller's strip occupancy, or null: derived
  // scratch (tpuva_torch/ops/ccl.py::k6_workspace), Q = g.strips()
  uint8_t* docc;           // (N, Q) the derived occupancy (deriving only)
  int* rcs;                // (N, Q) each strip's roots (deriving only)
  int* list;               // (N, Q) the occupied strips, ascending
  int* lrc;                // (N, Q) their roots
  int* loff;               // (N, Q) the rank of their first root
  int* gtable;             // (N, C)    the table, where not in shared memory
  unsigned* gacc;          // (N, 2, C, 3) the sums' low and high words, likewise
  int* gbox;               // (N, C, 4) the extremes, likewise
  // outputs; each but count null where not asked for
  int* count;              // (N,)
  long long* sums;         // (N, C, 3) area, sum x, sum y
  int* lohi;               // (N, C, 4) min x, min y, max x, max y
  int* labels;             // (N, H, W) dense ids
  int* area;               // the stats dict (ops/ccl.py::stats_views with its bbox):
  float* centroid;         //   area (N, C+1), centroid (N, C+1, 2), centroid_sum
  int* csum;               //   (N, C+1, 2), overflow (N,), bbox (N, C+1, 4); null
  int* overflow;           //   area: no dict
  int* bbox;
  int* zero;               // one word set to 0 (the dict's broadcast labels), or null
  int acc_sums, acc_box;   // sum area, x and y / keep the extremes
  float cx0, cy0;          // float32 of the image's sums of x and of y (the dict)
};

// Add x to the 64-bit sum of words lo and lo[hi]: 32-bit atomics (native
// in shared memory, where 64-bit adds loop on a compare-and-swap), the
// carry counted into the high word; exact in any order.
__device__ __forceinline__ void add64(unsigned* lo, int hi, unsigned x) {
  const unsigned old = atomicAdd(lo, x);
  if (old + x < old) atomicAdd(lo + hi, 1u);
}

// Add a run of a lane's pixels of component i into the sums (acc: 3C low
// words, then 3C high words) and extremes.
__device__ __forceinline__ void k6_flush(int i, unsigned area, unsigned sx, unsigned sy, int x0,
                                         int y0, int x1, int y1, unsigned* acc, int C,
                                         int* box) {
  if (acc) {
    add64(&acc[3 * i], 3 * C, area);
    add64(&acc[3 * i + 1], 3 * C, sx);
    add64(&acc[3 * i + 2], 3 * C, sy);
  }
  if (box) {
    atomicMin(&box[4 * i], x0);
    atomicMin(&box[4 * i + 1], y0);
    atomicMax(&box[4 * i + 2], x1);
    atomicMax(&box[4 * i + 3], y1);
  }
}

// The lane's 16 labels v of strip (r, c): each one's rank in the table
// (ascending tab[0, cnt), its last entry tmax; a label in [1, tmax] is in
// it, a lane without one is done at once), runs of one rank summed in
// registers and added once into acc and box where they are given (a lane's
// sums are at most 16 x 65535); with ids, each label replaced by its rank +
// 1 (0 for background and for a component past C).
template <int kConn>
__device__ __forceinline__ void k6_strip(const SGeom& g, int r, int c, int lane, int* v,
                                         const int* tab, int cnt, int tmax,
                                         unsigned* acc, int C, int* box, bool ids) {
  bool any = false;
#pragma unroll
  for (int e = 0; e < 16; ++e) any |= unsigned(v[e] - 1) < unsigned(tmax);
  if (!any) {  // background and components past C only
    if (ids)
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = 0;
    return;
  }
  const bool sum = acc || box;
  int last_v = 0, last_i = -1, cur = -1;
  unsigned area = 0, sx = 0, sy = 0;
  int x0 = kK6Big, y0 = kK6Big, x1 = -1, y1 = -1;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    if (!v[e]) continue;
    if (v[e] != last_v) {
      last_v = v[e];
      last_i = v[e] > tmax ? -1 : rank_of(tab, cnt, v[e]);
    }
    if (ids) v[e] = last_i + 1;
    if (last_i < 0 || !sum) continue;
    if (last_i != cur) {
      if (cur >= 0) k6_flush(cur, area, sx, sy, x0, y0, x1, y1, acc, C, box);
      cur = last_i;
      area = sx = sy = 0;
      x0 = y0 = kK6Big;
      x1 = y1 = -1;
    }
    int x, y, key;
    strip_px<kConn>(g, r, c, lane, e, x, y, key);
    area += 1;
    sx += unsigned(x);
    sy += unsigned(y);
    x0 = min(x0, x); y0 = min(y0, y); x1 = max(x1, x); y1 = max(y1, y);
  }
  if (cur >= 0) k6_flush(cur, area, sx, sy, x0, y0, x1, y1, acc, C, box);
}

// The warp's strips s = list[k] (k itself where list is null) for k =
// first, first + step, ... < end, two at a time: both strips' labels are
// loaded before f(k, s, r, c, v) runs on the first, so that each warp keeps
// two strips' loads in flight.
template <int kConn, typename F>
__device__ __forceinline__ void strip_pairs(const int* frame, const SGeom& g, int lane, int first,
                                            int end, int step, const int* list, F f) {
  for (int k = first; k < end; k += 2 * step) {
    const int k2 = k + step;
    const bool two = k2 < end;  // warp-uniform
    const int s = list ? list[k] : k, s2 = two ? (list ? list[k2] : k2) : s;
    const int r = s / g.S, c = s - r * g.S, r2 = s2 / g.S, c2 = s2 - r2 * g.S;
    int v[16], w[16];
    load_strip<kConn>(frame, g, r, c, lane, v);
    if (two) load_strip<kConn>(frame, g, r2, c2, lane, w);
    f(k, s, r, c, v);
    if (two) f(k2, s2, r2, c2, w);
  }
}

// K6 in one launch, a CTA a frame (blockIdx.x), its phases joined by the
// CTA's barriers:
//   A  deriving the occupancy: a warp a strip, all strips (two strips'
//      loads in flight, as in B and D): whether it holds foreground and its
//      roots (label == key + 1, the key from (y, x));
//   B  the occupied strips listed in order (a block scan over the occupancy
//      bytes, a thread 16 strips a step); given the occupancy, each listed
//      strip's roots counted by a warp; a block scan of the roots in strip
//      order gives each listed strip the rank of its first root;
//   C  the table: each listed strip holding one of the first C roots writes
//      their keys + 1 ascending (a warp a strip); the sums zeroed, the
//      extremes seeded;
//   D  the sums (and extremes) over the listed strips, a warp a strip: each
//      label's rank by binary search in the table (a lane without a label
//      up to its last entry skips the search), runs of one rank summed in
//      registers, one 32-bit atomic add a run and sum, its carry into a high
//      word; with the dense ids every strip
//      instead, rank + 1 written in 16-byte stores, zeros for an empty strip
//      without a read;
//   E  the outputs: count; the raw sums and extremes; the stats dict's rows
//      (stats_epilogue, warp 0).
// kShared: the table, sums and extremes in shared memory; else in the
// frame's global scratch. Integer atomics make every sum independent of
// their order.
template <int kConn, bool kShared>
__global__ void __launch_bounds__(kK6Threads, 2) k6_frame(K6Params P) {
  extern __shared__ unsigned k6_smem[];  // sums[2][3C], extremes[4C], table[C]
  __shared__ int warp_incl[32];
  const SGeom& g = P.g;
  const int n = blockIdx.x, Q = g.strips(), C = P.C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool derive = P.occ == nullptr;
  const size_t fq = size_t(n) * Q;
  const int* frame = P.root + size_t(n) * g.H * g.W;
  const uint8_t* occ = derive ? P.docc + fq : P.occ + fq;
  int* list = P.list + fq;
  int* lrc = P.lrc + fq;
  int* loff = P.loff + fq;

  // A. deriving: every strip's foreground and roots
  if (derive) {
    strip_pairs<kConn>(frame, g, lane, warp, Q, kK6Warps, nullptr,
                       [&](int, int s, int r, int c, const int* v) {
      bool fg = false;
#pragma unroll
      for (int e = 0; e < 16; ++e) fg |= v[e] != 0;
      const int rc = __reduce_add_sync(0xffffffffu, __popc(lane_roots<kConn>(g, r, c, lane, v)));
      fg = __any_sync(0xffffffffu, fg);
      if (lane == 0) {
        P.docc[fq + s] = fg;
        P.rcs[fq + s] = rc;
      }
    });
    __syncthreads();
  }

  // B. the occupied strips in order, their roots and first ranks: a thread
  // kListStrips consecutive strips a step, their occupancy bytes (and
  // roots) loaded at once
  int nl = 0, total = 0;
  for (int base = 0; base < Q; base += kK6Threads * kListStrips) {
    const int s0 = base + int(threadIdx.x) * kListStrips;
    const int* rcs = derive ? P.rcs + fq + s0 : nullptr;
    unsigned bits = 0;  // bit i: strip s0 + i occupied
#pragma unroll
    for (int i = 0; i < kListStrips; ++i) bits |= unsigned(s0 + i < Q && occ[s0 + i]) << i;
    int nroots = 0;
    if (derive) {
#pragma unroll
      for (int i = 0; i < kListStrips; ++i) nroots += (bits >> i) & 1u ? rcs[i] : 0;
    }
    const int2 at = block_scan(__popc(bits), warp_incl);
    const int2 ro = derive ? block_scan(nroots, warp_incl) : make_int2(0, 0);  // CTA-uniform
    int k = nl + at.x, off = total + ro.x;
    for (int i = 0; i < kListStrips; ++i) {
      if (!((bits >> i) & 1u)) continue;
      list[k] = s0 + i;
      if (derive) {
        lrc[k] = rcs[i];
        loff[k] = off;
        off += rcs[i];
      }
      ++k;
    }
    nl += at.y;
    total += ro.y;
  }
  __syncthreads();
  if (!derive) {
    strip_pairs<kConn>(frame, g, lane, warp, nl, kK6Warps, list,
                       [&](int k, int, int r, int c, const int* v) {
      const int rc = __reduce_add_sync(0xffffffffu, __popc(lane_roots<kConn>(g, r, c, lane, v)));
      if (lane == 0) lrc[k] = rc;
    });
    __syncthreads();
    const int per = (nl + kK6Threads - 1) / kK6Threads;
    const int k0 = min(nl, int(threadIdx.x) * per), k1 = min(nl, k0 + per);
    int sum = 0;
    for (int k = k0; k < k1; ++k) sum += lrc[k];
    const int2 p = block_scan(sum, warp_incl);
    int off = p.x;
    for (int k = k0; k < k1; ++k) {
      loff[k] = off;
      off += lrc[k];
    }
    total = p.y;
    __syncthreads();
  }
  const int cnt = min(total, C);

  // C. the table of the first cnt roots; sums zeroed, extremes seeded
  unsigned* acc;
  int *box, *tab;
  if (kShared) {
    unsigned char* base = reinterpret_cast<unsigned char*>(k6_smem);
    const size_t sums_bytes = P.acc_sums ? size_t(24) * C : 0;
    acc = P.acc_sums ? k6_smem : nullptr;
    box = P.acc_box ? reinterpret_cast<int*>(base + sums_bytes) : nullptr;
    tab = reinterpret_cast<int*>(base + sums_bytes + (P.acc_box ? size_t(16) * C : 0));
  } else {
    acc = P.acc_sums ? P.gacc + size_t(n) * 6 * C : nullptr;
    box = P.acc_box ? P.gbox + size_t(n) * 4 * C : nullptr;
    tab = P.gtable + size_t(n) * C;
  }
  if (acc)
    for (int i = threadIdx.x; i < 6 * C; i += kK6Threads) acc[i] = 0;
  if (box)
    for (int i = threadIdx.x; i < 4 * C; i += kK6Threads) box[i] = (i & 3) < 2 ? kK6Big : -1;
  for (int k = warp; k < nl; k += kK6Warps) {
    const int off = loff[k];
    if (off >= cnt) break;  // warp-uniform: the ranks ascend with k
    if (lrc[k] == 0) continue;
    const int s = list[k], r = s / g.S, c = s - r * g.S;
    int v[16];
    load_strip<kConn>(frame, g, r, c, lane, v);
    const unsigned roots = lane_roots<kConn>(g, r, c, lane, v);
    int pos = __popc(roots);  // this lane's rank: a warp scan of the counts
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, pos, d);
      if (lane >= d) pos += t;
    }
    pos += off - __popc(roots);
    for (int e = 0; e < 16 && pos < cnt; ++e) {
      if (!((roots >> e) & 1u)) continue;
      int x, y, key;
      strip_px<kConn>(g, r, c, lane, e, x, y, key);
      tab[pos++] = key + 1;
    }
  }
  __syncthreads();
  const int tmax = cnt ? tab[cnt - 1] : 0;

  // D. the sums over the listed strips; with the dense ids, every strip
  if (P.labels) {
    int* out = P.labels + size_t(n) * g.H * g.W;
    for (int s = warp; s < Q; s += kK6Warps) {
      const int r = s / g.S, c = s - r * g.S;
      int v[16] = {};
      if (occ[s]) {
        load_strip<kConn>(frame, g, r, c, lane, v);
        k6_strip<kConn>(g, r, c, lane, v, tab, cnt, tmax, acc, C, box, true);
      }
      store_strip<kConn>(out, g, r, c, lane, v);
    }
  } else if ((acc || box) && cnt > 0) {
    strip_pairs<kConn>(frame, g, lane, warp, nl, kK6Warps, list,
                       [&](int, int, int r, int c, int* v) {
      k6_strip<kConn>(g, r, c, lane, v, tab, cnt, tmax, acc, C, box, false);
    });
  }
  __syncthreads();

  // E. the outputs
  if (threadIdx.x == 0) {
    P.count[n] = cnt;
    if (P.overflow) P.overflow[n] = 0;
    if (P.zero && n == 0) *P.zero = 0;
  }
  if (P.sums)
    for (int i = threadIdx.x; i < 3 * C; i += kK6Threads)
      P.sums[size_t(n) * 3 * C + i] = (long long)(acc[i] | (unsigned long long)acc[3 * C + i] << 32);
  if (P.lohi)
    for (int i = threadIdx.x; i < 4 * C; i += kK6Threads) P.lohi[size_t(n) * 4 * C + i] = box[i];
  if (P.area && warp == 0) {
    const size_t row = size_t(n) * (C + 1);
    stats_epilogue(acc, P.acc_box ? box : nullptr, C, g.H, g.W, P.cx0, P.cy0, P.area + row,
                   P.centroid + 2 * row, P.csum + 2 * row, P.bbox + 4 * row);
  }
}


// ---- K2: one persistent cooperative launch a call ----

constexpr int kK2Blocks = 4;          // CTAs an SM the persistent kernel is built for
constexpr int kBorderTiles = kTileThreads / kBorderThreads;  // tiles a CTA a border step
constexpr int kRootStrips = 8;        // strips a thread of the roots phase scans a step
constexpr int kMaxC = 1024;           // components the kernel takes (the roots phase's list)

struct K2Params {
  const uint8_t* mask;  // (N, g.H, g.W)
  Geom g;
  int N, C;
  int H, W;             // the image inside the mask (the stats' totals)
  float cx0, cy0;       // float32 of the image's sums of x and of y
  const uint8_t* occ;   // (N, Hb, S) the caller's strip occupancy, or null: derived
  uint8_t* fine;        // (N, Hb, S) the segment occupancy (seg_occupied), phase A's
  uint8_t* bits;        // (N, Hb * Wb) block flags
  int* parent;          // (N, Hb * Wb)
  int2* list;           // the batch's tiles with foreground (item()), *nlist of them
  int* nlist;
  int* rc;              // (N, Hb * S) roots in each occupied strip
  int* table;           // (N, C) the first C roots, ascending
  unsigned* sums;       // (N, C, 3) area, sum x, sum y, wrapping 32-bit
  int* count;           // (N,)  the outputs: the stats dict's tensors
  int* area;            // (N, C + 1)
  float* centroid;      // (N, C + 1, 2)
  int* csum;            // (N, C + 1, 2)
  int* overflow;        // (N,)
  long long* phase_ns;  // null, or (9,): %globaltimer of CTA 0 at the start and after
                        // phases A-G, then the list's length
};

// An item of K2's tile list: x = frame | (the tile's live block rows << 16:
// bit r where the tile's segment of row r holds foreground), y = the tile.
__device__ __forceinline__ int2 item(int n, unsigned rows, int t) {
  return make_int2(int(unsigned(n) | rows << 16), t);
}
__device__ __forceinline__ int item_frame(int2 it) { return it.x & 0xffff; }

// This thread's block (by, bx) of an item's tile, and whether it is live:
// inside the frame, its row's segment of the tile holding foreground.
__device__ __forceinline__ bool item_block(const Geom& g, int2 it, int* by, int* bx) {
  const int ty = threadIdx.x / TBX;
  *by = (it.y / g.TX) * TBY + ty;
  *bx = (it.y % g.TX) * TBX + threadIdx.x % TBX;
  return *by < g.Hb && *bx < g.Wb && ((unsigned(it.x) >> (16 + ty)) & 1u);
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The roots phase for frame n: the root counts of the strips with
// foreground scanned in strip (= block) order, kRootStrips strips a thread
// a step, until C roots are passed; the strips that hold one of the first C
// roots go to a list, and a warp a listed strip writes its roots' block
// indices into the table at the strip's offset (a lane's blocks are read
// only where their segment holds foreground). count = min(roots, C); the
// frame's sums are zeroed.
__device__ void k2_roots(const K2Params& P, int n, int* warp_incl, int* slist, int* soff,
                         int* scount) {
  const Geom& g = P.g;
  const int C = P.C, ns = g.Hb * g.S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const uint8_t* o = P.fine + size_t(n) * ns;
  const int* rc = P.rc + size_t(n) * ns;
  const uint8_t* bits = P.bits + size_t(n) * g.Hb * g.Wb;
  const int* par = P.parent + size_t(n) * g.Hb * g.Wb;
  int* table = P.table + size_t(n) * C;
  for (int i = threadIdx.x; i < 3 * C; i += blockDim.x) P.sums[size_t(n) * 3 * C + i] = 0u;
  int running = 0;  // roots of the strips before this step (CTA-uniform)
  for (int base = 0; base < ns && running < C; base += kRootStrips * blockDim.x) {
    const int s0 = base + kRootStrips * threadIdx.x;
    // a strip's roots: its count where it holds foreground (read twice, not kept)
    auto roots = [&](int s) { return s < ns && o[s] ? rc[s] : 0; };
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kRootStrips; ++q) sum += roots(s0 + q);
    if (threadIdx.x == 0) *scount = 0;
    const int2 r = block_scan(sum, warp_incl);  // its barriers also order scount
    int off = running + r.x;
#pragma unroll
    for (int q = 0; q < kRootStrips; ++q) {
      const int v = roots(s0 + q);
      if (v > 0 && off < C) {
        const int i = atomicAdd(scount, 1);
        slist[i] = s0 + q;
        soff[i] = off;
      }
      off += v;
    }
    __syncthreads();
    const int nl = *scount;
    for (int i = warp; i < nl; i += nw) {  // a warp a listed strip, 4 blocks a lane
      const int st = slist[i];
      const int by = st / g.S, bx0 = (st % g.S) * SW + 4 * lane;
      const bool seg = (o[st] >> (4 * lane / TBX)) & 1;
      unsigned m4 = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int b = by * g.Wb + bx0 + k;
        if (seg && bx0 + k < g.Wb && bits[b] && par[b] == b) m4 |= 1u << k;
      }
      const int c = __popc(m4);
      int incl = c;
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += t;
      }
      int at = soff[i] + incl - c;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if ((m4 >> k) & 1u) {
          if (at < C) table[at] = by * g.Wb + bx0 + k;
          ++at;
        }
    }
    running += r.y;
    __syncthreads();  // slist, soff and scount are the next step's
  }
  if (threadIdx.x == 0) P.count[n] = min(running, C);
}

// The stats of an item's tile: each foreground block's rank in the
// frame's table (binary search), its area, sum x and sum y summed over the
// warp's blocks of one rank (a tile row is a warp), one atomic add each a
// rank and warp into the wrapping 32-bit sums. Integer sums: any order
// gives the same bits.
__device__ __forceinline__ void k2_stats_tile(const K2Params& P, int2 it) {
  const Geom& g = P.g;
  const int n = item_frame(it);
  const int cnt = P.count[n];
  if (cnt == 0) return;
  const int lane = threadIdx.x & 31;
  int by, bx;
  int rank = -1;
  unsigned area = 0, sx = 0, sy = 0;
  if (item_block(g, it, &by, &bx)) {
    const int b = by * g.Wb + bx;
    const int bb = P.bits[size_t(n) * g.Hb * g.Wb + b];
    if (bb) {
      rank = rank_of(P.table + size_t(n) * P.C, cnt,
                     P.parent[size_t(n) * g.Hb * g.Wb + b]);
      const unsigned x = 2u * unsigned(bx), y = 2u * unsigned(by);
      area = __popc(bb);
      sx = ((bb & 1) ? x : 0) + ((bb & 2) ? x + 1 : 0) + ((bb & 4) ? x : 0) +
           ((bb & 8) ? x + 1 : 0);
      sy = ((bb & 1) ? y : 0) + ((bb & 2) ? y : 0) + ((bb & 4) ? y + 1 : 0) +
           ((bb & 8) ? y + 1 : 0);
    }
  }
  unsigned pend = __ballot_sync(0xffffffffu, rank >= 0);
  while (pend) {  // one rank at a time: the leader's
    const int leader = __ffs(pend) - 1;
    const int rk = __shfl_sync(0xffffffffu, rank, leader);
    const bool mine = rank == rk;
    const unsigned a = __reduce_add_sync(0xffffffffu, mine ? area : 0u);
    const unsigned x = __reduce_add_sync(0xffffffffu, mine ? sx : 0u);
    const unsigned y = __reduce_add_sync(0xffffffffu, mine ? sy : 0u);
    if (lane == leader) {
      unsigned* e = P.sums + (size_t(n) * P.C + rk) * 3;
      atomicAdd(e, a);
      atomicAdd(e + 1, x);
      atomicAdd(e + 2, y);
    }
    pend &= ~__ballot_sync(0xffffffffu, mine);
  }
}

// The stats epilogue of frame n, a warp: stats_epilogue on the frame's
// 32-bit sums, no bbox; overflow 0.
__device__ __forceinline__ void k2_epilogue(const K2Params& P, int n) {
  const size_t row = size_t(n) * (P.C + 1);
  stats_epilogue(P.sums + size_t(n) * 3 * P.C, static_cast<const int*>(nullptr), P.C, P.H, P.W,
                 P.cx0, P.cy0, P.area + row, P.centroid + 2 * row, P.csum + 2 * row,
                 static_cast<int*>(nullptr));
  if ((threadIdx.x & 31) == 0) P.overflow[n] = 0;
}

// K2 in one cooperative launch: the phases of the six-kernel sequence
// K3 still runs, over a batch-wide list of occupied tiles, joined by
// grid.sync(), with the stats epilogue last. Each CTA takes every
// gridDim.x-th item of a phase; no CTA is launched for an empty tile.
__global__ void __launch_bounds__(kTileThreads, kK2Blocks)
ccl_stats_persistent(K2Params P) {
  __shared__ int par[kTileThreads];
  __shared__ uint8_t bits[kTileThreads];
  __shared__ int warp_incl[32];
  __shared__ int slist[kMaxC], soff[kMaxC];
  __shared__ int scount;
  cg::grid_group grid = cg::this_grid();
  const Geom& g = P.g;
  const int lane = threadIdx.x & 31;
  const size_t nthreads = size_t(gridDim.x) * blockDim.x;
  const size_t gtid = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int ns = g.Hb * g.S;

  // CTA 0's clock at the start and after each phase's barrier (timing only)
  auto stamp = [&](int i) {
    if (P.phase_ns && gtid == 0) P.phase_ns[i] = globaltimer();
  };
  stamp(0);

  // A. the segment occupancy, a warp a strip: from the mask where it is
  // derived; else from the mask of the caller's occupied strips only, a
  // warp 32 strips, 0 for an empty one. The list starts empty.
  if (gtid == 0) *P.nlist = 0;
  const size_t strips = size_t(P.N) * ns;
  if (P.occ == nullptr) {
    for (size_t s = gtid / 32; s < strips; s += nthreads / 32) {
      const unsigned seg = strip_segments(P.mask, g, s);
      if (lane == 0) P.fine[s] = seg;
    }
  } else {
    for (size_t s0 = gtid / 32 * 32; s0 < strips; s0 += nthreads) {
      const size_t s = s0 + lane;
      unsigned occupied = __ballot_sync(0xffffffffu, s < strips && P.occ[s]), seg = 0;
      while (occupied) {
        const int k = __ffs(occupied) - 1;
        const unsigned sk = strip_segments(P.mask, g, s0 + k);
        if (lane == k) seg = sk;
        occupied &= occupied - 1;
      }
      if (s < strips) P.fine[s] = seg;
    }
  }
  grid.sync();
  stamp(1);

  // B. a thread a group of TBY strips of one strip column (up to SW / TBX
  // tiles): the root counts of its strips with foreground zeroed, and each
  // tile with foreground appended to the list with its live rows
  // (warp-aggregated)
  const int gpf = g.TY * g.S;  // groups a frame
  for (size_t base = size_t(blockIdx.x) * blockDim.x; base < size_t(P.N) * gpf;
       base += nthreads) {
    const size_t q = base + threadIdx.x;
    int n = 0, ty = 0, sx = 0;
    unsigned rows[SW / TBX] = {};  // each tile's live rows
    if (q < size_t(P.N) * gpf) {
      n = int(q / gpf);
      const int r = int(q % gpf);
      ty = r / g.S;
      sx = r % g.S;
      const uint8_t* f = P.fine + size_t(n) * ns + ty * TBY * g.S + sx;
      unsigned seg[TBY];  // the group's strips, loaded before any store
#pragma unroll
      for (int r = 0; r < TBY; ++r) seg[r] = ty * TBY + r < g.Hb ? f[r * g.S] : 0u;
#pragma unroll
      for (int r = 0; r < TBY; ++r) {
        if (seg[r]) P.rc[size_t(n) * ns + (ty * TBY + r) * g.S + sx] = 0;
#pragma unroll
        for (int k = 0; k < SW / TBX; ++k) rows[k] |= ((seg[r] >> k) & 1u) << r;
      }
    }
    int nt = 0;
#pragma unroll
    for (int k = 0; k < SW / TBX; ++k) nt += rows[k] != 0;
    int incl = nt;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    int at = 0;
    if (lane == 31 && incl) at = atomicAdd(P.nlist, incl);
    at = __shfl_sync(0xffffffffu, at, 31) + incl - nt;
#pragma unroll
    for (int k = 0; k < SW / TBX; ++k)
      if (rows[k]) P.list[at++] = item(n, rows[k], ty * g.TX + sx * (SW / TBX) + k);
  }
  grid.sync();
  stamp(2);
  const int L = *reinterpret_cast<volatile int*>(P.nlist);
  const uint8_t* fine = P.fine;

  // C. union inside each listed tile
  for (int k = blockIdx.x; k < L; k += gridDim.x) {
    const int2 it = P.list[k];
    const int n = item_frame(it);
    int by, bx;
    const bool live = item_block(g, it, &by, &bx);
    int bb = 0;
    if (live) {
      const int y = 2 * by, x = 2 * bx;
      const uint8_t* row = P.mask + (size_t(n) * g.H + y) * g.W;
      bb |= row[x] != 0;
      if (x + 1 < g.W) bb |= (row[x + 1] != 0) << 1;
      if (y + 1 < g.H) {
        bb |= (row[g.W + x] != 0) << 2;
        if (x + 1 < g.W) bb |= (row[g.W + x + 1] != 0) << 3;
      }
    }
    local_union(g, n, by, bx, live, bb, P.parent, P.bits, par, bits);
  }
  grid.sync();
  stamp(3);

  // D. union across the listed tiles' borders, kBorderTiles tiles a CTA a
  // step
  for (int k0 = blockIdx.x * kBorderTiles; k0 < L; k0 += gridDim.x * kBorderTiles) {
    const int k = k0 + threadIdx.x / kBorderThreads;
    if (k < L) {
      const int2 it = P.list[k];
      border_item<true>(g, fine, item_frame(it), it.y, threadIdx.x % kBorderThreads, P.parent,
                        P.bits);
    }
  }
  grid.sync();
  stamp(4);

  // E. every foreground block points at its root; each tile row (a warp,
  // inside one strip) adds its roots to the strip's count
  for (int k = blockIdx.x; k < L; k += gridDim.x) {
    const int2 it = P.list[k];
    const int n = item_frame(it);
    int by, bx;
    bool root = false;
    if (item_block(g, it, &by, &bx)) {
      int* par_n = P.parent + size_t(n) * g.Hb * g.Wb;
      const int b = by * g.Wb + bx;
      if (P.bits[size_t(n) * g.Hb * g.Wb + b]) {
        const int r = find_root(par_n, b);
        par_n[b] = r;
        root = r == b;
      }
    }
    const unsigned rb = __ballot_sync(0xffffffffu, root);
    if (lane == 0 && rb) atomicAdd(&P.rc[size_t(n) * ns + by * g.S + bx / SW], __popc(rb));
  }
  grid.sync();
  stamp(5);

  // F. each frame's first C roots in block order, its count; sums zeroed
  for (int n = blockIdx.x; n < P.N; n += gridDim.x) k2_roots(P, n, warp_incl, slist, soff, &scount);
  grid.sync();
  stamp(6);

  // G. the listed tiles' stats
  for (int k = blockIdx.x; k < L; k += gridDim.x) k2_stats_tile(P, P.list[k]);
  grid.sync();
  stamp(7);
  if (P.phase_ns && gtid == 0) P.phase_ns[8] = L;

  // H. the stats dict's tensors, a warp a frame
  for (size_t n = gtid / 32; n < size_t(P.N); n += nthreads / 32) k2_epilogue(P, int(n));
}

}  // namespace

namespace {

// CTAs a frame of K3 4-connected's walks over a frame's listed tiles: about
// 16 CTAs an SM over the batch (four resident), at least one a frame.
cudaError_t walk_ctas(int N, int* ctas) {
  int dev, sms;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  *ctas = (16 * sms + N - 1) / N;
  return cudaSuccess;
}

}  // namespace

// mask (N,H,W) u8 (nonzero = foreground) -> labels (N,H,W) int32 root-key
// labels: the component's minimum scan key + 1, 0 for background, for
// connectivity 8 or 4, and the strip occupancy strip_occ (N, R, S) u8 of
// K6's strips (ops/ccl.py::root_strip_shape). Connectivity 8: R = Hb,
// S = ceil(Wb/128), and scratch tiles (N, ceil(Hb/16) * ceil(Wb/32)) int32,
// ntiles (N,) int32, parent (N, Hb*Wb) int32 and bits (N, Hb*Wb) u8, with
// Hb = ceil(H/2), Wb = ceil(W/2). Connectivity 4: R = H, S = ceil(W/512),
// and scratch seg (N, H, S) u16, tiles (N, ceil(H/16) * ceil(W/32)) int32,
// ntiles (N,) int32; the labels buffer is its parent array. Scratch a
// connectivity does not take may be null. labels must be 16-byte aligned.
// Needs N < 65536 and 4*Hb*Wb < 2^31, and for connectivity 4 fewer than
// 65536 tiles a frame. Returns cudaGetLastError() after the launches
// (0 = launched).
extern "C" int tpuva_ccl_labels(const uint8_t* mask, int N, int H, int W, int connectivity,
                                uint8_t* strip_occ, uint16_t* seg, int* tiles, int* ntiles,
                                int* parent, uint8_t* bits, int* labels, void* stream) {
  if (N <= 0 || N >= 65536 || H <= 0 || W <= 0 ||
      4LL * ((H + 1) / 2) * ((W + 1) / 2) >= (1LL << 31) ||
      (connectivity != 4 && connectivity != 8) ||
      (reinterpret_cast<uintptr_t>(labels) & 15) != 0 || strip_occ == nullptr ||
      tiles == nullptr || ntiles == nullptr ||
      (connectivity == 8 && (parent == nullptr || bits == nullptr)) ||
      (connectivity == 4 && (seg == nullptr || geom4(H, W).tiles() >= 65536)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (connectivity == 8) {  // K2's route: the occupancy, then only occupied strips' tiles
    const Geom g = geom(H, W);
    const size_t strips = size_t(N) * g.Hb * g.S;
    ccl_occ<<<unsigned((strips + kOccWarps - 1) / kOccWarps), 32 * kOccWarps, 0, s>>>(
        mask, N, g, strip_occ);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ccl_tiles<<<N, kScanThreads, 0, s>>>(g, strip_occ, tiles, ntiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const dim3 g_list((g.tiles() + kTilesPerCta - 1) / kTilesPerCta, N);
    ccl_local<<<g_list, kTileThreads, 0, s>>>(mask, g, strip_occ, tiles, ntiles, parent, bits);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ccl_border<<<g_list, kBorderThreads, 0, s>>>(g, strip_occ, tiles, ntiles, parent, bits);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ccl_flatten_tiles<<<g_list, kTileThreads, 0, s>>>(g, strip_occ, tiles, ntiles, parent, bits);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const int groups = g.Hb * ((W + 3) / 4);
    ccl_labels8<false><<<dim3((groups + kFlatThreads - 1) / kFlatThreads, N), kFlatThreads, 0,
                         s>>>(g, strip_occ, parent, bits, labels, BandOut{});
    return static_cast<int>(cudaGetLastError());
  }
  // the same route over pixels: the occupancy and segments, the tiles with
  // foreground, their unions, their borders, then every label
  const Geom4 g = geom4(H, W);
  int ctas;
  if ((err = walk_ctas(N, &ctas)) != cudaSuccess) return static_cast<int>(err);
  const size_t strips = size_t(N) * H * g.S;
  ccl4_occ<<<unsigned((strips + kOccWarps - 1) / kOccWarps), 32 * kOccWarps, 0, s>>>(
      mask, N, g, strip_occ, seg);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ccl4_tiles<<<N, kScanThreads, 0, s>>>(g, seg, tiles, ntiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 walk(ctas, N);
  ccl4_local<<<walk, T4Y * T4X, 0, s>>>(mask, g, tiles, ntiles, labels);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ccl4_border<<<walk, kTileThreads, 0, s>>>(mask, g, tiles, ntiles, labels);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int groups = H * ((W + 3) / 4);
  ccl4_labels<<<dim3((groups + kFlatThreads - 1) / kFlatThreads, N), kFlatThreads, 0, s>>>(
      mask, g, seg, labels);
  return static_cast<int>(cudaGetLastError());
}

// KB-labels: K3's 8-connected sequence on one row band of a frame, labels
// on the image's global scan keys. mask: the band's first row of frame 0,
// frames frame_stride bytes apart, Hb rows of W (a view of a larger mask:
// the band inside its front end's halo rows). The band's first row y0 is
// row r0 of K3's frame, r0 = y0 & 1, so that the frame's 2 x 2 blocks are
// the image's (a blank row above an odd band); kbase = 2 * (y0 - r0) * Wb
// is the global key of the frame's key 0. Out: labels (N, Hb, W) int32,
// each foreground pixel its band piece's minimum global key, background
// sent (tpuva's band_sweep fixed point); val (N, Hbk * Wb) int32, at each
// piece's root block the piece's key, other entries untouched; roots
// (N, Hbk * Wb) int32, each frame's root blocks in no order, nroots (N,)
// of them; strip_occ (N, Hbk, S) u8 and scratch tiles, ntiles, parent and
// bits as tpuva_ccl_labels's for an (Hb + r0, W) frame, Hbk = ceil((Hb +
// r0) / 2). Needs N < 65536 and labels 16-byte aligned. Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int tpuva_band_labels(const uint8_t* mask, long long frame_stride, int N, int Hb,
                                 int W, int r0, int kbase, int sent, uint8_t* strip_occ,
                                 int* tiles, int* ntiles, int* parent, uint8_t* bits, int* labels,
                                 int* val, int* roots, int* nroots, void* stream) {
  if (N <= 0 || N >= 65536 || Hb <= 0 || W <= 0 || (r0 != 0 && r0 != 1) ||
      frame_stride < (long long)Hb * W || 4LL * ((Hb + r0 + 1) / 2) * ((W + 1) / 2) >= (1LL << 31) ||
      (reinterpret_cast<uintptr_t>(labels) & 15) != 0 || !mask || !strip_occ || !tiles ||
      !ntiles || !parent || !bits || !val || !roots || !nroots)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  Geom g = geom(Hb + r0, W);
  g.r0 = r0;
  g.fs = frame_stride;
  const size_t strips = size_t(N) * g.Hb * g.S;
  ccl_occ<<<unsigned((strips + kOccWarps - 1) / kOccWarps), 32 * kOccWarps, 0, s>>>(
      mask, N, g, strip_occ);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ccl_tiles<<<N, kScanThreads, 0, s>>>(g, strip_occ, tiles, ntiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 g_list((g.tiles() + kTilesPerCta - 1) / kTilesPerCta, N);
  ccl_local<<<g_list, kTileThreads, 0, s>>>(mask, g, strip_occ, tiles, ntiles, parent, bits);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ccl_border<<<g_list, kBorderThreads, 0, s>>>(g, strip_occ, tiles, ntiles, parent, bits);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ccl_flatten_tiles<<<g_list, kTileThreads, 0, s>>>(g, strip_occ, tiles, ntiles, parent, bits);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaMemsetAsync(nroots, 0, sizeof(int) * size_t(N), s)) != cudaSuccess)
    return static_cast<int>(err);
  const int groups = g.Hb * ((W + 3) / 4);
  ccl_labels8<true><<<dim3((groups + kFlatThreads - 1) / kFlatThreads, N), kFlatThreads, 0,
                      s>>>(g, strip_occ, parent, bits, labels,
                           BandOut{kbase - 1, sent, val, roots, nroots});
  return static_cast<int>(cudaGetLastError());
}

namespace {

// The persistent kernel's grid: CTAs resident an SM (the occupancy query)
// and the card's SMs, 0 CTAs where the card has no cooperative launch.
cudaError_t k2_grid(int* blocks_per_sm, int* sms) {
  int dev, coop;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, ccl_stats_persistent,
                                                           kTileThreads, 0)) != cudaSuccess)
    return err;
  if (!coop) *blocks_per_sm = 0;
  return cudaSuccess;
}

}  // namespace

// K2's launch: CTAs an SM and SMs of the cooperative grid (the grid is
// their product; 0 CTAs an SM where the card cannot launch it).
extern "C" int tpuva_ccl_stats_grid(int* blocks_per_sm, int* sms) {
  return static_cast<int>(k2_grid(blocks_per_sm, sms));
}

// K2: mask (N, Hm, Wm) u8, zero outside its (H, W) image -> the stats dict
// of the image's 8-connected components, first C in cv2 id order: count
// (N,) int32 = min(#components, C), area (N, C+1) int32, centroid
// (N, C+1, 2) float32, centroid_sum (N, C+1, 2) int32, overflow (N,) int32
// (zeros), row 0 the background; bit-equal to tpuva_torch/ops/label.py::
// _assemble_stats on the plain version's sums. One cooperative launch
// visits only the occupied strips of strip_occ (N, Hb, S) u8, Hb =
// ceil(Hm/2), S = ceil(ceil(Wm/2) / 128), where the caller gives it (a
// strip it calls empty must hold no foreground); with strip_occ null it
// reads every strip. Scratch (tpuva_torch/ops/ccl.py::k2_workspace):
// fine (N, Hb, S) u8, bits (N, Hb*Wb) u8, parent (N, Hb*Wb) int32, list
// (N * tiles) int2 with tiles = ceil(Hb/16) * ceil(Wb/32), nlist (1) int32,
// rc (N, Hb*S) int32, table (N, C) int32, sums (N, C, 3) uint32. phase_ns:
// null, or 9 int64 that receive CTA 0's %globaltimer at the start and after
// each of the phases A-G (a breakdown for timing), then the list's length.
// Needs N, Hm, Wm < 65536, N * tiles < 2^31, H * W < 2^31 and
// 1 <= C <= 1024. Returns cudaErrorNotSupported where the card has no
// cooperative launch, else the launch's error (0 = launched).
extern "C" int tpuva_ccl_stats(const uint8_t* mask, int N, int Hm, int Wm, int H, int W, int C,
                               const uint8_t* strip_occ, uint8_t* fine, uint8_t* bits,
                               int* parent, int* list, int* nlist, int* rc, int* table,
                               unsigned* sums, int* count, int* area, float* centroid, int* csum,
                               int* overflow, long long* phase_ns, void* stream) {
  const Geom g = geom(Hm, Wm);
  if (N <= 0 || N >= 65536 || Hm <= 0 || Wm <= 0 || Hm >= 65536 || Wm >= 65536 || H <= 0 ||
      W <= 0 || H > Hm || W > Wm || (long long)H * W >= (1LL << 31) || C < 1 || C > kMaxC ||
      (long long)N * g.tiles() >= (1LL << 31) || fine == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int per_sm, sms;
  cudaError_t err = k2_grid(&per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorNotSupported);
  K2Params P{mask, g, N, C, H, W,
             static_cast<float>(double(H) * (W - 1) * W / 2.0),
             static_cast<float>(double(W) * (H - 1) * H / 2.0),
             strip_occ, fine, bits, parent, reinterpret_cast<int2*>(list), nlist, rc, table,
             sums, count, area, centroid, csum, overflow, phase_ns};
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ccl_stats_persistent),
                                    dim3(per_sm * sms), dim3(kTileThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K6: root-key labels root (N,H,W) int32 (K3's, or label_components') ->
// the dense stats of each frame's first C components in cv2 id order, in
// one launch (k6_frame), for connectivity 8 or 4. Outputs, each but count
// null where not asked for: count (N,) int32 = min(#components, C); sums
// (N,C,3) int64 of (area, sum x, sum y); lohi (N,C,4) int32 of (min x,
// min y, max x, max y) (2^30, 2^30, -1, -1 for an absent component);
// labels (N,H,W) int32 dense ids 1..C, 0 for background and later
// components; the stats dict (tpuva_torch/ops/ccl.py::stats_views with its
// bbox): area (N,C+1) int32, centroid (N,C+1,2) float32, csum (N,C+1,2)
// int32, overflow (N,) int32 (zeros) and bbox (N,C+1,4) int32, (x, y, w, h)
// from the extremes where with_bbox, else zeros, bit-equal to tpuva_torch/
// ops/label.py::_stats_dict; zero, one int32 set to 0. strip_occ (N, R, S)
// u8 is K6's strips' occupancy (8-connected R = ceil(H/2),
// S = ceil(ceil(W/2)/128), K3's; 4-connected R = H, S = ceil(W/512), K3's
// too): only its strips are read, and a strip it calls empty must hold no
// foreground; null derives it. Scratch (ops/ccl.py::k6_workspace), Q = R*S:
// list, lrc, loff (N, Q) int32; deriving docc (N, Q) u8 and rcs (N, Q)
// int32; where the frame's arrays pass shared memory (k6_frame_bytes),
// gtable (N, C) int32, gacc (N, 2, C, 3) uint32 (the sums' low and high
// words) where sums or the dict are asked for, gbox (N, C, 4) int32 where
// the extremes are. 16-byte loads and
// stores where W % 4 == 0 and root and labels are 16-byte aligned. Needs
// N < 65536, H, W < 65536 and N*R*S < 2^31. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int tpuva_root_stats(const int* root, int N, int H, int W, int connectivity, int C,
                                const uint8_t* strip_occ, uint8_t* docc, int* rcs, int* list,
                                int* lrc, int* loff, int* gtable, unsigned* gacc,
                                int* gbox, int* count, long long* sums, int* lohi, int* labels,
                                int* area, float* centroid, int* csum, int* overflow, int* bbox,
                                int* zero, int with_bbox, void* stream) {
  const bool derive = strip_occ == nullptr, dict = area != nullptr;
  const bool acc_sums = sums || dict, acc_box = lohi || (dict && with_bbox);
  const bool shared = k6_frame_bytes(C, acc_sums, acc_box) <= kSmemBytes;
  if (N <= 0 || N >= 65536 || H < 0 || W < 0 || H >= 65536 || W >= 65536 || C < 0 ||
      (connectivity != 4 && connectivity != 8) || count == nullptr || list == nullptr ||
      lrc == nullptr || loff == nullptr || (derive && (docc == nullptr || rcs == nullptr)) ||
      (dict && (centroid == nullptr || csum == nullptr || overflow == nullptr ||
                bbox == nullptr)) ||
      (!shared && (gtable == nullptr || (acc_sums && gacc == nullptr) ||
                   (acc_box && gbox == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = ((reinterpret_cast<uintptr_t>(root) |
                         reinterpret_cast<uintptr_t>(labels)) & 15) == 0;
  const SGeom g = sgeom(H, W, connectivity, aligned);
  if (size_t(N) * g.strips() >= (size_t(1) << 31)) return static_cast<int>(cudaErrorInvalidValue);
  K6Params P{root, g, N, C, strip_occ, docc, rcs, list, lrc, loff, gtable, gacc, gbox,
             count, sums, lohi, labels, area, centroid, csum, overflow, bbox, zero,
             acc_sums, acc_box,
             static_cast<float>(double(H) * (W - 1) * W / 2.0),
             static_cast<float>(double(W) * (H - 1) * H / 2.0)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = shared ? k6_frame_bytes(C, acc_sums, acc_box) : 0;
  if (connectivity == 8 && shared) k6_frame<8, true><<<N, kK6Threads, smem, s>>>(P);
  else if (connectivity == 8) k6_frame<8, false><<<N, kK6Threads, 0, s>>>(P);
  else if (shared) k6_frame<4, true><<<N, kK6Threads, smem, s>>>(P);
  else k6_frame<4, false><<<N, kK6Threads, 0, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}
