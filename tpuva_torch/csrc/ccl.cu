// 8-connected CCL + per-component stats (kernel K2) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel tpuva/ops/pallas/ccl.py::
// label_components_tiled_raw together with the XLA stats step
// tpuva/ops/label.py::_stats_from_compact. The plain PyTorch version is
// tpuva_torch/ops/ccl.py::label_sums_plain; the two are bit-equal.
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
// K1's padded_occ emit) or ccl_occ derives it from the mask. Tiles are
// 16 x 32 blocks, so a tile's row lies in one strip; ccl_tiles lists each
// frame's tiles that touch an occupied strip, and the per-tile kernels
// walk that list (each CTA every gridDim.x-th entry; the grid, sized on
// the host without reading the lists, gives a CTA kTilesPerCta entries
// where every tile is listed, and the CTAs past a frame's list return at
// once), skipping the rows of empty strips inside a tile: no mask byte,
// parent or flag of an empty strip is read or written. A block of an
// empty strip has no foreground, so every read of a neighbour's flags
// first checks the neighbour's strip. K3 calls ccl_local and ccl_border
// with no list and no occupancy: one CTA a tile, every strip occupied.
//
// Kernels, in launch order, all on the caller's stream:
//   ccl_occ     (strip_occ not given) one warp a strip: any foreground;
//   ccl_tiles   one CTA a frame: the frame's occupied tiles, in order;
//   ccl_local   a tile's block flags from the mask, union inside the tile
//               in shared memory (path splitting in its finds), flattened
//               parents written as global block indices;
//   ccl_border  union across tile borders in global memory (the tile's
//               top row and its first and last columns);
//   ccl_flatten_tiles every foreground block points at its root;
//   ccl_roots   one CTA per frame walks the occupied strips in block order
//               (ballot + warp scan), records the first C roots ascending
//               and zeroes the frame's sums;
//   ccl_stats   each foreground block finds its root's rank by binary
//               search in that table and adds its area, sum x and sum y,
//               first into 32-bit shared-memory sums, then once per CTA
//               and component into int64 sums. Integer atomics make the
//               result independent of their order.
//
// What bounds it on an H100: memory — the mask read (1 B/px) and the
// parent/flag arrays (1.25 B/px written, read three or four times), of
// the occupied strips only; where the occupancy is derived, ccl_occ reads
// the whole mask once. On a sparse frame (the bench clip: about 3% of the
// strips occupied) what is left is the latency of the tiles that hold
// foreground (union-find chains in shared memory, shortened by path
// splitting), the CTAs past the lists, and ccl_roots' chain of barriers
// (one CTA a frame).
//
// Dense root-key labels (kernel K3), entry point tpuva_ccl_labels.
//
// Replaces the Pallas TPU kernel tpuva/ops/pallas/ccl.py::
// label_components_tiled: per pixel, its component's minimum scan key + 1
// (tpuva's _scan_key), 0 for background. The plain PyTorch version is
// tpuva_torch/ops/label.py::label_components; the two are bit-equal.
//   8-connectivity: ccl_local and ccl_border as above (one CTA a tile, no
//     list), ccl_flatten (every foreground block points at its root), then
//     ccl_labels8 writes 4 * root_block + ctz(bits[root_block]) + 1 to each
//     foreground pixel. The scan key is K = 4 * block + within (within =
//     2 * (y & 1) + (x & 1), the bit order of the block flags), the root is
//     the component's minimum block, and every set pixel of that block
//     belongs to the component, so its lowest set bit is the minimum key.
//   4-connectivity: diagonal pixels of a 2x2 block are not 4-adjacent, so
//     union-find runs on pixels: ccl4_local (a 16x32-pixel tile in shared
//     memory), ccl4_border (tile borders in global memory), ccl4_flatten
//     (each pixel's root, the minimum raster index = the 4-conn scan key),
//     with the labels buffer itself as the parent array; ccl4_finish then
//     turns it into root + 1 or 0 in place.
// What bounds it on an H100: memory. The floor is the mask read (1 B/px)
// and the int32 label write (4 B/px), 2.65 GB per 256-frame 1080p batch,
// 0.79 ms at 3.35 TB/s; the label write dominates. These kernels read and
// write the parent array several times more (8-conn: 1.25 B/px of block
// scratch; 4-conn: the 4 B/px labels three or four times). Coalesced
// vector stores and TMA are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SW = 128;            // strip width, in 2x2 blocks
constexpr int TBY = 16, TBX = 32;  // a tile, in 2x2 blocks: a quarter of 16 strips
constexpr int kTileThreads = TBY * TBX;
constexpr int kBorderThreads = 64;  // a tile's top row, first and last columns (62)
constexpr int kTilesPerCta = 16;   // listed tiles a CTA of the listed kernels takes at most
constexpr int T4Y = 16, T4X = 32;  // ccl4_local tile, in pixels
constexpr int kFlatThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kOccWarps = 8;       // ccl_occ: strips a CTA

// block flag bits: 1 = (y, x), 2 = (y, x+1), 4 = (y+1, x), 8 = (y+1, x+1)
__device__ __forceinline__ bool link_left(int l, int b) { return (l & 0xA) && (b & 0x5); }
__device__ __forceinline__ bool link_up(int u, int b) { return (u & 0xC) && (b & 0x3); }
__device__ __forceinline__ bool link_upleft(int ul, int b) { return (ul & 0x8) && (b & 0x1); }
__device__ __forceinline__ bool link_upright(int ur, int b) { return (ur & 0x4) && (b & 0x2); }

__device__ __forceinline__ int find_root(const int* par, int i) {
  const volatile int* vp = par;
  int p = vp[i];
  while (p != i) {
    i = p;
    p = vp[i];
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
// splitting in the finds where kCompress: a tile's union in shared memory).
template <bool kCompress>
__device__ void unite(int* par, int a, int b) {
  while (true) {
    a = kCompress ? find_compress(par, a) : find_root(par, a);
    b = kCompress ? find_compress(par, b) : find_root(par, b);
    if (a == b) return;
    if (a < b) {
      const int old = atomicMin(&par[b], a);
      if (old == b) return;
      b = old;
    } else {
      const int old = atomicMin(&par[a], b);
      if (old == a) return;
      a = old;
    }
  }
}

// Frame geometry in blocks and strips; occ is the frame's (Hb, S) strip
// occupancy, or null for "every strip occupied".
struct Geom {
  int H, W, Hb, Wb, S, TY, TX;  // S: strips a block row; TY, TX: tiles
  __host__ __device__ int tiles() const { return TY * TX; }
};

Geom geom(int H, int W) {
  Geom g;
  g.H = H; g.W = W;
  g.Hb = (H + 1) / 2; g.Wb = (W + 1) / 2;
  g.S = (g.Wb + SW - 1) / SW;
  g.TY = (g.Hb + TBY - 1) / TBY;
  g.TX = (g.Wb + TBX - 1) / TBX;
  return g;
}

__device__ __forceinline__ bool strip_occupied(const uint8_t* occ, const Geom& g, int by, int bx) {
  return occ == nullptr || occ[by * g.S + bx / SW] != 0;
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

// Strip occupancy from the mask: one warp a strip (2 rows x 256 pixels,
// 16 bytes a lane).
__global__ void __launch_bounds__(32 * kOccWarps)
ccl_occ(const uint8_t* __restrict__ mask, int N, Geom g, uint8_t* __restrict__ occ) {
  const size_t strips = size_t(N) * g.Hb * g.S;
  const size_t s = size_t(blockIdx.x) * kOccWarps + (threadIdx.x >> 5);
  if (s >= strips) return;
  const int lane = threadIdx.x & 31;
  const int n = int(s / (size_t(g.Hb) * g.S));
  const int r = int(s % (size_t(g.Hb) * g.S));
  const int y = 2 * (r / g.S) + (lane >> 4), x = (r % g.S) * 2 * SW + 16 * (lane & 15);
  bool fg = false;
  if (y < g.H && x < g.W) {
    const uint8_t* p = mask + (size_t(n) * g.H + y) * g.W + x;
    if (x + 16 <= g.W && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      fg = (v.x | v.y | v.z | v.w) != 0;
    } else {
      for (int i = 0; i < 16 && x + i < g.W; ++i) fg |= p[i] != 0;
    }
  }
  fg = __any_sync(0xffffffffu, fg);
  if (lane == 0) occ[s] = fg;
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

__global__ void __launch_bounds__(kTileThreads)
ccl_local(const uint8_t* __restrict__ mask, Geom g, const uint8_t* __restrict__ occ,
          const int* __restrict__ tiles, const int* __restrict__ ntiles,
          int* __restrict__ parent, uint8_t* __restrict__ bits_g) {
  __shared__ int par[kTileThreads];
  __shared__ uint8_t bits[kTileThreads];
  const int n = blockIdx.y;
  const TileWalk walk(tiles, ntiles, g, n);
  const uint8_t* o = occ ? occ + size_t(n) * g.Hb * g.S : nullptr;
  const uint8_t* m = mask + size_t(n) * g.H * g.W;
  const int li = threadIdx.x;
  const int ty = li / TBX, tx = li % TBX;
  for (int k = blockIdx.x; k < walk.n; k += gridDim.x) {
    const int t = walk.tile(k);
    const int by = (t / g.TX) * TBY + ty, bx = (t % g.TX) * TBX + tx;
    const bool live = by < g.Hb && bx < g.Wb && strip_occupied(o, g, by, bx);
    int bb = 0;
    if (live) {
      const int y = 2 * by, x = 2 * bx;
      const uint8_t* row = m + size_t(y) * g.W;
      bb |= row[x] != 0;
      if (x + 1 < g.W) bb |= (row[x + 1] != 0) << 1;
      if (y + 1 < g.H) {
        bb |= (row[g.W + x] != 0) << 2;
        if (x + 1 < g.W) bb |= (row[g.W + x + 1] != 0) << 3;
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

// Union across tile borders: the tile's top row, and its first and last
// columns below it (the last column's up-right neighbour lies in the next
// tile). A neighbour's flags are read only where its strip is occupied.
__global__ void __launch_bounds__(kBorderThreads)
ccl_border(Geom g, const uint8_t* __restrict__ occ, const int* __restrict__ tiles,
           const int* __restrict__ ntiles, int* __restrict__ parent,
           const uint8_t* __restrict__ bits_g) {
  const int n = blockIdx.y;
  const TileWalk walk(tiles, ntiles, g, n);
  const uint8_t* o = occ ? occ + size_t(n) * g.Hb * g.S : nullptr;
  int* par = parent + size_t(n) * g.Hb * g.Wb;
  const uint8_t* bits = bits_g + size_t(n) * g.Hb * g.Wb;
  const int i = threadIdx.x;
  for (int k = blockIdx.x; k < walk.n; k += gridDim.x) {
    const int t = walk.tile(k);
    const int by0 = (t / g.TX) * TBY, bx0 = (t % g.TX) * TBX;
    int by, bx;
    if (i < TBX) {
      by = by0; bx = bx0 + i;
    } else if (i < TBX + TBY - 1) {
      by = by0 + 1 + i - TBX; bx = bx0;
    } else if (i < TBX + 2 * (TBY - 1)) {
      by = by0 + 1 + i - TBX - (TBY - 1); bx = bx0 + TBX - 1;
    } else {
      continue;
    }
    if (by >= g.Hb || bx >= g.Wb || !strip_occupied(o, g, by, bx)) continue;
    const int b = by * g.Wb + bx;
    const int bb = bits[b];
    if (!bb) continue;
    const bool left = bx == bx0, top = by == by0, right = bx == bx0 + TBX - 1;
    if (left && bx > 0 && strip_occupied(o, g, by, bx - 1) && link_left(bits[b - 1], bb))
      unite<false>(par, b, b - 1);
    if (by > 0) {
      const int u = b - g.Wb;
      if (top && strip_occupied(o, g, by - 1, bx) && link_up(bits[u], bb)) unite<false>(par, b, u);
      if ((top || left) && bx > 0 && strip_occupied(o, g, by - 1, bx - 1) &&
          link_upleft(bits[u - 1], bb))
        unite<false>(par, b, u - 1);
      if ((top || right) && bx + 1 < g.Wb && strip_occupied(o, g, by - 1, bx + 1) &&
          link_upright(bits[u + 1], bb))
        unite<false>(par, b, u + 1);
    }
  }
}

// K3: every foreground block points at its root (after the last union).
__global__ void __launch_bounds__(kFlatThreads)
ccl_flatten(int nb, int* __restrict__ parent, const uint8_t* __restrict__ bits_g) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  int* par = parent + size_t(blockIdx.y) * nb;
  if (bits_g[size_t(blockIdx.y) * nb + b]) par[b] = find_root(par, b);
}

// K2: every foreground block of the listed tiles' occupied strips points
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

// The first C roots of frame blockIdx.x in block order: the occupied
// strips in order, 1024 at a time into shared memory, then their blocks,
// eight strips (1024 blocks) a step, ranked by a block-wide scan.
__global__ void __launch_bounds__(kScanThreads)
ccl_roots(Geom g, int C, const uint8_t* __restrict__ occ, const int* __restrict__ parent,
          const uint8_t* __restrict__ bits_g, int* __restrict__ table,
          int* __restrict__ count, long long* __restrict__ sums) {
  constexpr int kStrips = kScanThreads / SW;  // strips a step
  __shared__ int warp_incl[32];
  __shared__ int strips[kScanThreads];
  const int n = blockIdx.x;
  const int ns = g.Hb * g.S;
  const uint8_t* o = occ + size_t(n) * ns;
  const int* par = parent + size_t(n) * g.Hb * g.Wb;
  const uint8_t* bits = bits_g + size_t(n) * g.Hb * g.Wb;
  for (int i = threadIdx.x; i < 3 * C; i += blockDim.x) sums[size_t(n) * 3 * C + i] = 0;
  int running = 0;
  for (int base = 0; base < ns && running < C; base += kScanThreads) {
    const int s = base + threadIdx.x;
    const bool occupied = s < ns && o[s];
    const int2 r = block_rank(occupied, warp_incl);
    if (occupied) strips[r.x] = s;
    __syncthreads();
    for (int k0 = 0; k0 < r.y && running < C; k0 += kStrips) {
      const int k = k0 + threadIdx.x / SW;
      bool flag = false;
      int b = 0;
      if (k < r.y) {
        const int st = strips[k];
        const int by = st / g.S, bx = (st % g.S) * SW + threadIdx.x % SW;
        b = by * g.Wb + bx;
        flag = bx < g.Wb && bits[b] && par[b] == b;
      }
      const int2 q = block_rank(flag, warp_incl);
      if (flag && running + q.x < C) table[size_t(n) * C + running + q.x] = b;
      running += q.y;  // block-uniform: later roots are cut anyway
    }
    __syncthreads();  // strips is the next chunk's
  }
  if (threadIdx.x == 0) count[n] = min(running, C);
}

__global__ void __launch_bounds__(kTileThreads)
ccl_stats(Geom g, int C, const uint8_t* __restrict__ occ, const int* __restrict__ tiles,
          const int* __restrict__ ntiles, const int* __restrict__ parent,
          const uint8_t* __restrict__ bits_g, const int* __restrict__ table,
          const int* __restrict__ count, unsigned long long* __restrict__ sums) {
  extern __shared__ unsigned acc[];  // 3*C sums, then C table entries
  int* tab = reinterpret_cast<int*>(acc + 3 * C);
  const int n = blockIdx.y;
  const int cnt = count[n];
  const TileWalk walk(tiles, ntiles, g, n);
  if (cnt == 0 || int(blockIdx.x) >= walk.n) return;
  for (int i = threadIdx.x; i < 3 * cnt; i += blockDim.x) acc[i] = 0;
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) tab[i] = table[size_t(n) * C + i];
  __syncthreads();
  const uint8_t* o = occ + size_t(n) * g.Hb * g.S;
  const int* par = parent + size_t(n) * g.Hb * g.Wb;
  const uint8_t* bits = bits_g + size_t(n) * g.Hb * g.Wb;
  for (int k = blockIdx.x; k < walk.n; k += gridDim.x) {
    const int t = walk.tile(k);
    for (int j = threadIdx.x; j < kTileThreads; j += blockDim.x) {
      const int by = (t / g.TX) * TBY + j / TBX, bx = (t % g.TX) * TBX + j % TBX;
      if (by >= g.Hb || bx >= g.Wb || !strip_occupied(o, g, by, bx)) continue;
      const int b = by * g.Wb + bx;
      const int bb = bits[b];
      if (!bb) continue;
      const int r = par[b];
      int lo = 0, hi = cnt;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (tab[mid] < r) lo = mid + 1; else hi = mid;
      }
      if (lo == cnt || tab[lo] != r) continue;  // rank >= C: cut
      const unsigned x = 2u * unsigned(bx), y = 2u * unsigned(by);
      const unsigned area = __popc(bb);
      const unsigned sx = ((bb & 1) ? x : 0) + ((bb & 2) ? x + 1 : 0) +
                          ((bb & 4) ? x : 0) + ((bb & 8) ? x + 1 : 0);
      const unsigned sy = ((bb & 1) ? y : 0) + ((bb & 2) ? y : 0) +
                          ((bb & 4) ? y + 1 : 0) + ((bb & 8) ? y + 1 : 0);
      atomicAdd(&acc[3 * lo], area);
      atomicAdd(&acc[3 * lo + 1], sx);
      atomicAdd(&acc[3 * lo + 2], sy);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * cnt; i += blockDim.x)
    if (acc[i]) atomicAdd(&sums[size_t(n) * 3 * C + i], (unsigned long long)acc[i]);
}

// One thread per pixel: 4 * root block + lowest set bit of its flags + 1,
// or 0 for background.
__global__ void __launch_bounds__(kFlatThreads)
ccl_labels8(const uint8_t* __restrict__ mask, int H, int W, int Wb,
            const int* __restrict__ parent, const uint8_t* __restrict__ bits_g,
            int* __restrict__ labels) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= H * W) return;
  const size_t g = size_t(blockIdx.y) * H * W + p;
  int out = 0;
  if (mask[g]) {
    const int y = p / W, x = p - y * W;
    const size_t f = size_t(blockIdx.y) * ((H + 1) / 2) * Wb;
    const int r = parent[f + (y >> 1) * Wb + (x >> 1)];
    out = 4 * r + (__ffs(bits_g[f + r]) - 1) + 1;
  }
  labels[g] = out;
}

// Pixel-level union-find inside one T4Y x T4X tile; every pixel's parent
// is written as a frame-global raster index (background: itself).
__global__ void __launch_bounds__(T4Y * T4X)
ccl4_local(const uint8_t* __restrict__ mask, int H, int W, int* __restrict__ par_g) {
  __shared__ int par[T4Y * T4X];
  __shared__ uint8_t fg[T4Y * T4X];
  const int li = threadIdx.x;
  const int ty = li / T4X, tx = li % T4X;
  const int y = blockIdx.y * T4Y + ty, x = blockIdx.x * T4X + tx;
  const bool inside = y < H && x < W;
  const size_t frame = size_t(blockIdx.z) * H * W;
  const uint8_t f = inside && mask[frame + size_t(y) * W + x] != 0;
  fg[li] = f;
  par[li] = li;
  __syncthreads();
  if (f) {
    if (tx > 0 && fg[li - 1]) unite<false>(par, li, li - 1);
    if (ty > 0 && fg[li - T4X]) unite<false>(par, li, li - T4X);
  }
  __syncthreads();
  if (inside) {
    int root = y * W + x;
    if (f) {
      const int lr = find_root(par, li);
      root = (blockIdx.y * T4Y + lr / T4X) * W + blockIdx.x * T4X + lr % T4X;
    }
    par_g[frame + size_t(y) * W + x] = root;
  }
}

__global__ void __launch_bounds__(kFlatThreads)
ccl4_border(const uint8_t* __restrict__ mask, int H, int W, int* __restrict__ par_g) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= H * W) return;
  const size_t frame = size_t(blockIdx.y) * H * W;
  const uint8_t* m = mask + frame;
  if (!m[p]) return;
  int* par = par_g + frame;
  const int y = p / W, x = p - y * W;
  if (x > 0 && x % T4X == 0 && m[p - 1]) unite<false>(par, p, p - 1);
  if (y > 0 && y % T4Y == 0 && m[p - W]) unite<false>(par, p, p - W);
}

__global__ void __launch_bounds__(kFlatThreads)
ccl4_flatten(const uint8_t* __restrict__ mask, int HW, int* __restrict__ par_g) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const size_t frame = size_t(blockIdx.y) * HW;
  if (mask[frame + p]) par_g[frame + p] = find_root(par_g + frame, p);
}

// In place, after ccl4_flatten: root + 1 for foreground, 0 for background.
__global__ void __launch_bounds__(kFlatThreads)
ccl4_finish(const uint8_t* __restrict__ mask, int HW, int* __restrict__ labels) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const size_t g = size_t(blockIdx.y) * HW + p;
  labels[g] = mask[g] ? labels[g] + 1 : 0;
}

}  // namespace

// mask (N,H,W) u8 (nonzero = foreground) -> labels (N,H,W) int32 root-key
// labels: the component's minimum scan key + 1, 0 for background, for
// connectivity 8 or 4. Scratch for connectivity 8: parent (N, Hb*Wb) int32
// and bits (N, Hb*Wb) u8 with Hb = ceil(H/2), Wb = ceil(W/2); connectivity 4
// uses the labels buffer as its parent array and takes no scratch (parent
// and bits may be null). Needs N < 65536 and 4*Hb*Wb < 2^31. Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int tpuva_ccl_labels(const uint8_t* mask, int N, int H, int W,
                                int connectivity, int* parent, uint8_t* bits,
                                int* labels, void* stream) {
  if (N <= 0 || N >= 65536 || H <= 0 || W <= 0 ||
      4LL * ((H + 1) / 2) * ((W + 1) / 2) >= (1LL << 31) ||
      (connectivity != 4 && connectivity != 8) ||
      (connectivity == 8 && (parent == nullptr || bits == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int HW = H * W;
  const dim3 g_px((HW + kFlatThreads - 1) / kFlatThreads, N);
  cudaError_t err;
  if (connectivity == 8) {  // the tile kernels with no list: every strip occupied
    const Geom g = geom(H, W);
    const dim3 g_tiles(g.tiles(), N);
    ccl_local<<<g_tiles, kTileThreads, 0, s>>>(mask, g, nullptr, nullptr, nullptr, parent, bits);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ccl_border<<<g_tiles, kBorderThreads, 0, s>>>(g, nullptr, nullptr, nullptr, parent, bits);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const dim3 g_flat((g.Hb * g.Wb + kFlatThreads - 1) / kFlatThreads, N);
    ccl_flatten<<<g_flat, kFlatThreads, 0, s>>>(g.Hb * g.Wb, parent, bits);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ccl_labels8<<<g_px, kFlatThreads, 0, s>>>(mask, H, W, g.Wb, parent, bits, labels);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 g_local((W + T4X - 1) / T4X, (H + T4Y - 1) / T4Y, N);
  ccl4_local<<<g_local, T4Y * T4X, 0, s>>>(mask, H, W, labels);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ccl4_border<<<g_px, kFlatThreads, 0, s>>>(mask, H, W, labels);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ccl4_flatten<<<g_px, kFlatThreads, 0, s>>>(mask, HW, labels);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ccl4_finish<<<g_px, kFlatThreads, 0, s>>>(mask, HW, labels);
  return static_cast<int>(cudaGetLastError());
}

// mask (N,H,W) u8 -> count (N,) int32 = min(#components, C) and
// sums (N,C,3) int64 of (area, sum x, sum y) in cv2 id order, visiting
// only the occupied strips of strip_occ (N, Hb, S) u8, S = ceil(Wb / 128):
// with derive != 0 ccl_occ writes it from the mask first, else the caller
// gives it, and a strip it calls empty must hold no foreground.
// Scratch: tiles (N, ceil(Hb/16) * ceil(Wb/32)) int32, ntiles (N,) int32, parent
// (N, Hb*Wb) int32, bits (N, Hb*Wb) u8, table (N, C) int32, with
// Hb = ceil(H/2), Wb = ceil(W/2). Needs H, W < 65536 (the 32-bit per-CTA
// sums), N < 65536 and 1 <= C <= 1024. Returns cudaGetLastError() after
// the launches (0 = launched).
extern "C" int tpuva_ccl_stats(const uint8_t* mask, int N, int H, int W, int C,
                               uint8_t* strip_occ, int derive, int* tiles, int* ntiles,
                               int* parent, uint8_t* bits, int* table,
                               int* count, long long* sums, void* stream) {
  if (N <= 0 || N >= 65536 || H <= 0 || W <= 0 || H >= 65536 || W >= 65536 || C < 1 ||
      C > 1024 || strip_occ == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g = geom(H, W);
  cudaError_t err;
  if (derive) {
    const size_t strips = size_t(N) * g.Hb * g.S;
    ccl_occ<<<unsigned((strips + kOccWarps - 1) / kOccWarps), 32 * kOccWarps, 0, s>>>(
        mask, N, g, strip_occ);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  ccl_tiles<<<N, kScanThreads, 0, s>>>(g, strip_occ, tiles, ntiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // kTilesPerCta listed tiles a CTA at most; CTAs past the frame's list return
  const dim3 g_list((g.tiles() + kTilesPerCta - 1) / kTilesPerCta, N);
  ccl_local<<<g_list, kTileThreads, 0, s>>>(mask, g, strip_occ, tiles, ntiles, parent, bits);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ccl_border<<<g_list, kBorderThreads, 0, s>>>(g, strip_occ, tiles, ntiles, parent, bits);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ccl_flatten_tiles<<<g_list, kTileThreads, 0, s>>>(g, strip_occ, tiles, ntiles, parent, bits);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ccl_roots<<<N, kScanThreads, 0, s>>>(g, C, strip_occ, parent, bits, table, count, sums);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ccl_stats<<<g_list, kTileThreads, 16 * C, s>>>(
      g, C, strip_occ, tiles, ntiles, parent, bits, table, count,
      reinterpret_cast<unsigned long long*>(sums));
  return static_cast<int>(cudaGetLastError());
}
