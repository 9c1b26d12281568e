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
// Kernels, in launch order, all on the caller's stream:
//   ccl_local   one CTA per 16x32-block tile: block flags from the mask,
//               union inside the tile in shared memory, flattened parents
//               written as global block indices;
//   ccl_border  union across tile borders in global memory;
//   ccl_flatten every foreground block points at its root;
//   ccl_roots   one CTA per frame scans the root flags in block order
//               (ballot + warp scan), records the first C roots ascending
//               and zeroes the frame's sums;
//   ccl_stats   each foreground block finds its root's rank by binary
//               search in that table and adds its area, sum x and sum y,
//               first into 32-bit shared-memory sums, then once per CTA
//               and component into int64 sums. Integer atomics make the
//               result independent of their order.
//
// What bounds it on an H100: memory — the mask read (1 B/px) and the
// parent/flag arrays (1.25 B/px written, read three or four times);
// ccl_roots is a sequential loop over the frame's 518,400 blocks at 1080p
// per CTA (latency-bound, 256 CTAs for a 256-frame batch). Skipping empty
// rows and tiles is later work.
//
// Dense root-key labels (kernel K3), entry point tpuva_ccl_labels.
//
// Replaces the Pallas TPU kernel tpuva/ops/pallas/ccl.py::
// label_components_tiled: per pixel, its component's minimum scan key + 1
// (tpuva's _scan_key), 0 for background. The plain PyTorch version is
// tpuva_torch/ops/label.py::label_components; the two are bit-equal.
//   8-connectivity: ccl_local, ccl_border and ccl_flatten as above, then
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

constexpr int TBY = 16, TBX = 32;  // ccl_local tile, in 2x2 blocks
constexpr int kFlatThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kStatsBlocksPerCta = 1024;

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

// Link the roots of a and b, the larger under the smaller.
__device__ void unite(int* par, int a, int b) {
  while (true) {
    a = find_root(par, a);
    b = find_root(par, b);
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

__global__ void __launch_bounds__(TBY * TBX)
ccl_local(const uint8_t* __restrict__ mask, int H, int W, int Hb, int Wb,
          int* __restrict__ parent, uint8_t* __restrict__ bits_g) {
  __shared__ int par[TBY * TBX];
  __shared__ uint8_t bits[TBY * TBX];
  const int n = blockIdx.z;
  const int li = threadIdx.x;
  const int ty = li / TBX, tx = li % TBX;
  const int by = blockIdx.y * TBY + ty, bx = blockIdx.x * TBX + tx;
  const uint8_t* m = mask + size_t(n) * H * W;
  int bb = 0;
  if (by < Hb && bx < Wb) {
    const int y = 2 * by, x = 2 * bx;
    const uint8_t* row = m + size_t(y) * W;
    bb |= row[x] != 0;
    if (x + 1 < W) bb |= (row[x + 1] != 0) << 1;
    if (y + 1 < H) {
      bb |= (row[W + x] != 0) << 2;
      if (x + 1 < W) bb |= (row[W + x + 1] != 0) << 3;
    }
  }
  bits[li] = (uint8_t)bb;
  par[li] = li;
  __syncthreads();
  if (bb) {
    if (tx > 0 && link_left(bits[li - 1], bb)) unite(par, li, li - 1);
    if (ty > 0) {
      const int u = li - TBX;
      if (link_up(bits[u], bb)) unite(par, li, u);
      if (tx > 0 && link_upleft(bits[u - 1], bb)) unite(par, li, u - 1);
      if (tx < TBX - 1 && link_upright(bits[u + 1], bb)) unite(par, li, u + 1);
    }
  }
  __syncthreads();
  if (by < Hb && bx < Wb) {
    const size_t g = size_t(n) * Hb * Wb + size_t(by) * Wb + bx;
    int root = by * Wb + bx;
    if (bb) {
      const int lr = find_root(par, li);
      root = (blockIdx.y * TBY + lr / TBX) * Wb + blockIdx.x * TBX + lr % TBX;
    }
    parent[g] = root;
    bits_g[g] = (uint8_t)bb;
  }
}

__global__ void __launch_bounds__(kFlatThreads)
ccl_border(int Hb, int Wb, int* __restrict__ parent,
           const uint8_t* __restrict__ bits_g) {
  const int nb = Hb * Wb;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  int* par = parent + size_t(blockIdx.y) * nb;
  const uint8_t* bits = bits_g + size_t(blockIdx.y) * nb;
  const int bb = bits[b];
  if (!bb) return;
  const int by = b / Wb, bx = b % Wb;
  const bool left = bx % TBX == 0, top = by % TBY == 0, right = bx % TBX == TBX - 1;
  if (left && bx > 0 && link_left(bits[b - 1], bb)) unite(par, b, b - 1);
  if (by > 0) {
    const int u = b - Wb;
    if (top && link_up(bits[u], bb)) unite(par, b, u);
    if ((top || left) && bx > 0 && link_upleft(bits[u - 1], bb)) unite(par, b, u - 1);
    if ((top || right) && bx + 1 < Wb && link_upright(bits[u + 1], bb))
      unite(par, b, u + 1);
  }
}

__global__ void __launch_bounds__(kFlatThreads)
ccl_flatten(int nb, int* __restrict__ parent, const uint8_t* __restrict__ bits_g) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  int* par = parent + size_t(blockIdx.y) * nb;
  if (bits_g[size_t(blockIdx.y) * nb + b]) par[b] = find_root(par, b);
}

__global__ void __launch_bounds__(kScanThreads)
ccl_roots(int nb, int C, const int* __restrict__ parent,
          const uint8_t* __restrict__ bits_g, int* __restrict__ table,
          int* __restrict__ count, long long* __restrict__ sums) {
  __shared__ int warp_incl[32];
  __shared__ int running_s;
  const int n = blockIdx.x;
  const int* par = parent + size_t(n) * nb;
  const uint8_t* bits = bits_g + size_t(n) * nb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < 3 * C; i += blockDim.x) sums[size_t(n) * 3 * C + i] = 0;
  if (threadIdx.x == 0) running_s = 0;
  __syncthreads();
  for (int base = 0; base < nb; base += kScanThreads) {
    const int b = base + threadIdx.x;
    const bool flag = b < nb && bits[b] && par[b] == b;
    const unsigned bal = __ballot_sync(0xffffffffu, flag);
    if (lane == 0) warp_incl[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {
      int v = warp_incl[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += t;
      }
      warp_incl[lane] = v;
    }
    __syncthreads();
    const int running = running_s;
    const int rank = running + (warp ? warp_incl[warp - 1] : 0) +
                     __popc(bal & ((1u << lane) - 1u));
    if (flag && rank < C) table[size_t(n) * C + rank] = b;
    const int total = running + warp_incl[31];
    __syncthreads();
    if (threadIdx.x == 0) running_s = total;
    if (total >= C) break;  // block-uniform: later roots are cut anyway
  }
  __syncthreads();
  if (threadIdx.x == 0) count[n] = min(running_s, C);
}

__global__ void __launch_bounds__(kFlatThreads)
ccl_stats(int Wb, int nb, int C, const int* __restrict__ parent,
          const uint8_t* __restrict__ bits_g, const int* __restrict__ table,
          const int* __restrict__ count, unsigned long long* __restrict__ sums) {
  extern __shared__ unsigned acc[];  // 3*C sums, then C table entries
  int* tab = reinterpret_cast<int*>(acc + 3 * C);
  const int n = blockIdx.y;
  const int cnt = count[n];
  if (cnt == 0) return;
  for (int i = threadIdx.x; i < 3 * cnt; i += blockDim.x) acc[i] = 0;
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) tab[i] = table[size_t(n) * C + i];
  __syncthreads();
  const int* par = parent + size_t(n) * nb;
  const uint8_t* bits = bits_g + size_t(n) * nb;
  const int b0 = blockIdx.x * kStatsBlocksPerCta;
  for (int j = threadIdx.x; j < kStatsBlocksPerCta; j += blockDim.x) {
    const int b = b0 + j;
    if (b >= nb) break;
    const int bb = bits[b];
    if (!bb) continue;
    const int r = par[b];
    int lo = 0, hi = cnt;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (tab[mid] < r) lo = mid + 1; else hi = mid;
    }
    if (lo == cnt || tab[lo] != r) continue;  // rank >= C: cut
    const unsigned x = 2u * unsigned(b % Wb), y = 2u * unsigned(b / Wb);
    const unsigned area = __popc(bb);
    const unsigned sx = ((bb & 1) ? x : 0) + ((bb & 2) ? x + 1 : 0) +
                        ((bb & 4) ? x : 0) + ((bb & 8) ? x + 1 : 0);
    const unsigned sy = ((bb & 1) ? y : 0) + ((bb & 2) ? y : 0) +
                        ((bb & 4) ? y + 1 : 0) + ((bb & 8) ? y + 1 : 0);
    atomicAdd(&acc[3 * lo], area);
    atomicAdd(&acc[3 * lo + 1], sx);
    atomicAdd(&acc[3 * lo + 2], sy);
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

// Pixel-level union-find inside one TBY x TBX tile; every pixel's parent
// is written as a frame-global raster index (background: itself).
__global__ void __launch_bounds__(TBY * TBX)
ccl4_local(const uint8_t* __restrict__ mask, int H, int W, int* __restrict__ par_g) {
  __shared__ int par[TBY * TBX];
  __shared__ uint8_t fg[TBY * TBX];
  const int li = threadIdx.x;
  const int ty = li / TBX, tx = li % TBX;
  const int y = blockIdx.y * TBY + ty, x = blockIdx.x * TBX + tx;
  const bool inside = y < H && x < W;
  const size_t frame = size_t(blockIdx.z) * H * W;
  const uint8_t f = inside && mask[frame + size_t(y) * W + x] != 0;
  fg[li] = f;
  par[li] = li;
  __syncthreads();
  if (f) {
    if (tx > 0 && fg[li - 1]) unite(par, li, li - 1);
    if (ty > 0 && fg[li - TBX]) unite(par, li, li - TBX);
  }
  __syncthreads();
  if (inside) {
    int root = y * W + x;
    if (f) {
      const int lr = find_root(par, li);
      root = (blockIdx.y * TBY + lr / TBX) * W + blockIdx.x * TBX + lr % TBX;
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
  if (x > 0 && x % TBX == 0 && m[p - 1]) unite(par, p, p - 1);
  if (y > 0 && y % TBY == 0 && m[p - W]) unite(par, p, p - W);
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
  if (connectivity == 8) {
    const int Hb = (H + 1) / 2, Wb = (W + 1) / 2, nb = Hb * Wb;
    const dim3 g_local((Wb + TBX - 1) / TBX, (Hb + TBY - 1) / TBY, N);
    ccl_local<<<g_local, TBY * TBX, 0, s>>>(mask, H, W, Hb, Wb, parent, bits);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const dim3 g_flat((nb + kFlatThreads - 1) / kFlatThreads, N);
    ccl_border<<<g_flat, kFlatThreads, 0, s>>>(Hb, Wb, parent, bits);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ccl_flatten<<<g_flat, kFlatThreads, 0, s>>>(nb, parent, bits);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ccl_labels8<<<g_px, kFlatThreads, 0, s>>>(mask, H, W, Wb, parent, bits, labels);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 g_local((W + TBX - 1) / TBX, (H + TBY - 1) / TBY, N);
  ccl4_local<<<g_local, TBY * TBX, 0, s>>>(mask, H, W, labels);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ccl4_border<<<g_px, kFlatThreads, 0, s>>>(mask, H, W, labels);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ccl4_flatten<<<g_px, kFlatThreads, 0, s>>>(mask, HW, labels);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ccl4_finish<<<g_px, kFlatThreads, 0, s>>>(mask, HW, labels);
  return static_cast<int>(cudaGetLastError());
}

// mask (N,H,W) u8 -> count (N,) int32 = min(#components, C) and
// sums (N,C,3) int64 of (area, sum x, sum y) in cv2 id order.
// Scratch: parent (N, Hb*Wb) int32, bits (N, Hb*Wb) u8, table (N, C) int32,
// with Hb = ceil(H/2), Wb = ceil(W/2). Needs H, W < 65536 (the 32-bit
// per-CTA sums) and 1 <= C <= 1024. Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int tpuva_ccl_stats(const uint8_t* mask, int N, int H, int W, int C,
                               int* parent, uint8_t* bits, int* table,
                               int* count, long long* sums, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || H >= 65536 || W >= 65536 || C < 1 || C > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Hb = (H + 1) / 2, Wb = (W + 1) / 2, nb = Hb * Wb;
  const dim3 g_local((Wb + TBX - 1) / TBX, (Hb + TBY - 1) / TBY, N);
  ccl_local<<<g_local, TBY * TBX, 0, s>>>(mask, H, W, Hb, Wb, parent, bits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g_flat((nb + kFlatThreads - 1) / kFlatThreads, N);
  ccl_border<<<g_flat, kFlatThreads, 0, s>>>(Hb, Wb, parent, bits);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ccl_flatten<<<g_flat, kFlatThreads, 0, s>>>(nb, parent, bits);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ccl_roots<<<N, kScanThreads, 0, s>>>(nb, C, parent, bits, table, count, sums);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 g_stats((nb + kStatsBlocksPerCta - 1) / kStatsBlocksPerCta, N);
  ccl_stats<<<g_stats, kFlatThreads, 16 * C, s>>>(
      Wb, nb, C, parent, bits, table, count,
      reinterpret_cast<unsigned long long*>(sums));
  return static_cast<int>(cudaGetLastError());
}
