// Exact k x k median of uint8 frames (kernel K7) for Hopper, sm_90a.
//
// Replaces tpuva/ops/filters.py::median_blur for k > 3 on uint8 frames:
// cv2.medianBlur's exact median with BORDER_REPLICATE. On the TPU it is
// XLA code, not a Pallas kernel: jnp.sort over the stacked k*k window axis
// (:208; the 19-op network _median9 for k = 3, :239). The port's plain
// version, tpuva_torch/ops/filters.py::median_u8_plain, does the same with
// torch.sort over chunks of frames; the kernel is bit-equal to it (a
// median of integers has one answer). Every odd k from 3 up is taken.
//
// k = 3, 5, 7, 9: median_net_kernel. A CTA owns 128 columns of two bands
// of rows of one frame (blockIdx.z) and stages them with a halo of
// r = k / 2 into shared memory as 32-bit words of two 16-bit lanes, the
// same pixel of each band (byte p held as p << 8 | p; one byte_perm a
// word). Staging reads 16-byte pieces of a row; only pieces that cross
// the frame's left or right edge, or rows that are not 16-byte aligned,
// read byte by byte with clamped columns, and a row clamps once a piece
// (BORDER_REPLICATE: frames smaller than the window and one-row frames
// included). No integer division a byte. A thread then loads the input
// words of a block of MedianNet<k>::kBX x kBY outputs (16-byte shared
// loads) and runs the block's network, generated by
// tpuva_torch/ops/median.py::median_network into median_net.h: Adams's
// separable sorting network (ACM TOG 40(4), 2021) of min and max only, so
// it gives the exact median with ties by construction. Each input column
// is sorted once for the block's rows, the rows two outputs share sorted
// once; the k sorted columns of each output are merged (Batcher) with
// the merges of the columns neighbouring outputs share done once, and
// every merge only over the positions that can still reach rank k*k / 2.
// A min or max is one VIMNMX.U16 (__vminu2/__vmaxu2) on both lanes, a
// single-use chain of two one VIMNMX3.U16 (__vimin3_u16x2/__vimax3_u16x2).
// The results leave as bytes, four columns gathered into a 32-bit store.
//
// Operations a pixel (ops/median.py::network_ops_per_px: the network's
// instructions over 2 lanes, plus shared loads, staging and stores):
//   k = 3: 17.25 comparisons, 7.6 + 2.5 = 10.2 instructions
//   k = 5: 63.75 comparisons, 29.9 + 2.9 = 32.7
//   k = 7: 148.5 comparisons, 70.3 + 3.5 = 73.7
//   k = 9: 330.0 comparisons, 157.3 + 5.0 = 162.3
// against the radix select's 16 k^2 (144, 400, 784, 1296) that this
// tier replaced.
//
// What bounds it on an H100: one byte read and one written a pixel, 0.317
// ms for a 256-frame 1080p batch at 3.35 TB/s; the instructions, which
// issue to the 64 INT32 lanes an SM (132 SMs at 1.98 GHz, 16.7 T/s; a
// VIMNMX.U16 takes one lane-slot, a VIMNMX3.U16 two): 1.04 ms at k = 5 and
// 2.34 at k = 7 for that batch. So it is bound by its operations. Its
// registers set the CTAs an SM: 128 threads a CTA and launch bounds of
// 10, 5, 2 and 3 CTAs an SM at k = 3, 5, 7, 9 (MedianNet<k>::kThreads,
// kMinBlocks; the most that spill nothing), so that one CTA's staging
// overlaps other CTAs' networks.
//
// k >= 11: a radix select a pixel, 8 counts of the k*k window (from the
// top bit down, the candidate prefix | bit is kept while at most
// rank = k*k / 2 window values lie below it); no pinned route uses them.
// median_smem_kernel stages a 32 x 64 tile and its halo (bytes, clamped
// indices) in shared memory: with k = 255's halo 286 x 318 bytes (89 KB),
// under a CTA's 227 KB; the halo fits up to k = 435. Past that,
// median_global_kernel stages nothing and counts each pixel's window from
// global memory through the caches, its indices clamped the same way.

#include <cstdint>
#include <cuda_runtime.h>

#include "median_net.h"  // generated: tpuva_torch/ops/median.py::network_header

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 64;                             // owned columns: a thread a column
constexpr int kRowsPerThread = 8;                      // owned rows of a thread, consecutive
constexpr int kTileH = kThreads / kTileW * kRowsPerThread;  // 32 owned rows a CTA
constexpr int kMaxSmem = 227 * 1024;

constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Shared memory of one CTA for window k: the tile plus its halo, one byte a
// pixel, (kTileH + 2r) rows of kTileW + 2r.
constexpr long long median_smem(int k) {
  return (kTileH + 2LL * (k / 2)) * (kTileW + 2LL * (k / 2));
}

// The CTA's tile plus a halo of r into s, row pitch P: s[i * P + j] is the
// frame's pixel (y0 - r + i, x0 - r + j), the indices clamped into it.
__device__ __forceinline__ void stage(const uint8_t* __restrict__ frame, uint8_t* s, int H,
                                      int W, int y0, int x0, int r, int P) {
  const int rows = kTileH + 2 * r, total = rows * P;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int i = idx / P, j = idx - i * P;
    const int y = min(max(y0 - r + i, 0), H - 1), x = min(max(x0 - r + j, 0), W - 1);
    s[idx] = frame[(long long)y * W + x];
  }
}

// ---- k = 3, 5, 7, 9: the selection network on packed pixels ----

// Two pixels a 32-bit word, one in each 16-bit lane, a byte p held as
// p << 8 | p (monotone in p): lane 0 from a row of the CTA's upper band,
// lane 1 from the same row of its lower band. Op is what the generated
// networks (median_net.h) call.
struct U16x2 {
  static __device__ __forceinline__ uint32_t mn(uint32_t a, uint32_t b) { return __vminu2(a, b); }
  static __device__ __forceinline__ uint32_t mx(uint32_t a, uint32_t b) { return __vmaxu2(a, b); }
  static __device__ __forceinline__ uint32_t mn3(uint32_t a, uint32_t b, uint32_t c) {
    return __vimin3_u16x2(a, b, c);
  }
  static __device__ __forceinline__ uint32_t mx3(uint32_t a, uint32_t b, uint32_t c) {
    return __vimax3_u16x2(a, b, c);
  }
  // byte i of a (lane 0) and of b (lane 1), each doubled into its lane
  static __device__ __forceinline__ uint32_t pack(uint32_t a, uint32_t b, int i) {
    return __byte_perm(a, b, i * 0x11 + (i + 4) * 0x1100);
  }
};

// threadIdx.x (I = 0), blockIdx.x, .y, .z (I = 1, 2, 3), read by a volatile
// move so that the compiler reads it again instead of keeping an earlier
// read live in a register
template <int I>
__device__ __forceinline__ int special_reg() {
#ifdef __CUDA_ARCH__
  int r;
  if constexpr (I == 0) asm volatile("mov.u32 %0, %%tid.x;" : "=r"(r));
  if constexpr (I == 1) asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(r));
  if constexpr (I == 2) asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(r));
  if constexpr (I == 3) asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(r));
  return r;
#else
  return I == 0 ? threadIdx.x : I == 1 ? blockIdx.x : I == 2 ? blockIdx.y : blockIdx.z;
#endif
}

// The CTA geometry of window K with THREADS threads: TX x TY threads,
// each with a block of MedianNet<K>'s kBX x kBY outputs in each band; the
// staged tile, SROWS rows of PITCH words, word (i, j) holding the pixels
// (y0 - R + i, x0 - R + j) and (y0 + BAND - R + i, x0 - R + j).
template <int K, int THREADS = MedianNet<K>::kThreads>
struct NetTile {
  using Net = MedianNet<K>;
  static constexpr int R = K / 2;
  static constexpr int TX = kNetTileW / Net::kBX, TY = THREADS / TX;
  static constexpr int BAND = TY * Net::kBY;  // rows of a band
  static constexpr int SROWS = BAND + 2 * R;
  static constexpr int PITCH = (kNetTileW - Net::kBX + Net::kCols + 3) / 4 * 4;
  static constexpr int CHUNKS = kNetTileW / 16 + 2;  // 16-byte pieces of [x0 - 16, x0 + 144)
  static_assert(kNetTileW % Net::kBX == 0 && Net::kBX % 4 == 0 && R <= 16, "tile shape");
  static_assert(PITCH >= kNetTileW + 2 * R, "a staged row holds the halo");
};

template <int K, int THREADS = MedianNet<K>::kThreads,
          int MIN_BLOCKS = MedianNet<K>::kMinBlocks>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
median_net_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int H, int W,
                  int load16, int store4) {
  using T = NetTile<K, THREADS>;
  using Net = typename T::Net;
  constexpr int R = T::R, P = T::PITCH;
  __shared__ __align__(16) uint32_t s[T::SROWS * P];
  const int x0 = blockIdx.x * kNetTileW, y0 = blockIdx.y * 2 * T::BAND;
  const long long plane = (long long)H * W;
  const uint8_t* frame = x + blockIdx.z * plane;
  // Stage: a 16-byte piece of a row of each band a step. Rows clamp once a
  // piece; only pieces that cross the frame's left or right edge (or any,
  // when rows are not 16-byte aligned) read byte by byte with clamped
  // columns (BORDER_REPLICATE).
  for (int item = threadIdx.x; item < T::SROWS * T::CHUNKS; item += THREADS) {
    const int i = item / T::CHUNKS, c = item - i * T::CHUNKS;
    const uint8_t* ra = frame + (long long)min(max(y0 - R + i, 0), H - 1) * W;
    const uint8_t* rb = frame + (long long)min(max(y0 + T::BAND - R + i, 0), H - 1) * W;
    const int gx = x0 - 16 + 16 * c;
    uint32_t a[4], b[4];
    if (load16 && gx >= 0 && gx + 16 <= W) {
      const uint4 va = __ldg(reinterpret_cast<const uint4*>(ra + gx));
      const uint4 vb = __ldg(reinterpret_cast<const uint4*>(rb + gx));
      a[0] = va.x, a[1] = va.y, a[2] = va.z, a[3] = va.w;
      b[0] = vb.x, b[1] = vb.y, b[2] = vb.z, b[3] = vb.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = b[q] = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int xx = min(max(gx + 4 * q + t, 0), W - 1);
          a[q] |= uint32_t(ra[xx]) << (8 * t);
          b[q] |= uint32_t(rb[xx]) << (8 * t);
        }
      }
    }
    const int j0 = 16 * c - 16 + R;  // staged column of the piece's first byte
    uint32_t* row = s + i * P;
#pragma unroll
    for (int t = 0; t < 16; ++t)
      if (j0 + t >= 0 && j0 + t < P) row[j0 + t] = U16x2::pack(a[t / 4], b[t / 4], t % 4);
  }
  __syncthreads();
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
  const int ox = x0 + tx * Net::kBX, oy = y0 + ty * Net::kBY;
  if (ox >= W || oy >= H) return;
  // the block's input words: 16-byte loads, then an 8- and a 4-byte one
  // for the rest of a row (a row starts 16-byte aligned)
  constexpr int C = Net::kCols, C4 = C / 4 * 4;
  uint32_t v[Net::kRows][C];
  const uint32_t* src = s + ty * Net::kBY * P + tx * Net::kBX;
#pragma unroll
  for (int i = 0; i < Net::kRows; ++i) {
    const uint32_t* row = src + i * P;
#pragma unroll
    for (int j = 0; j < C4; j += 4) {
      const uint4 w = *reinterpret_cast<const uint4*>(row + j);
      v[i][j] = w.x, v[i][j + 1] = w.y, v[i][j + 2] = w.z, v[i][j + 3] = w.w;
    }
    if constexpr (C - C4 >= 2) {
      const uint2 w = *reinterpret_cast<const uint2*>(row + C4);
      v[i][C4] = w.x, v[i][C4 + 1] = w.y;
    }
    if constexpr (C % 2) v[i][C - 1] = row[C - 1];
  }
  uint32_t o[Net::kBY][Net::kBX];
  Net::template run<U16x2, C>(v, o);
  // The output block's place, from the thread and block indices read anew:
  // nothing of the staging stays live in registers across the network.
  const int tid = special_reg<0>(), bz = special_reg<3>();
  const int px = special_reg<1>() * kNetTileW + tid % T::TX * Net::kBX;
  const int py = special_reg<2>() * 2 * T::BAND + tid / T::TX * Net::kBY;
  // Each band's bytes: lane 0 is byte 0 of a word, lane 1 byte 2; four
  // columns gathered into one 32-bit store where they lie in the frame.
#pragma unroll
  for (int band = 0; band < 2; ++band)
#pragma unroll
    for (int t = 0; t < Net::kBY; ++t) {
      const int y = py + band * T::BAND + t;
      if (y >= H) continue;
      uint8_t* dst = out + bz * (long long)H * W + (long long)y * W + px;
#pragma unroll
      for (int c = 0; c < Net::kBX; c += 4) {
        const int sel = band ? 0x62 : 0x40;
        const uint32_t lo = __byte_perm(o[t][c], o[t][c + 1], sel);
        const uint32_t hi = __byte_perm(o[t][c + 2], o[t][c + 3], sel);
        const uint32_t w4 = __byte_perm(lo, hi, 0x5410);
        if (store4 && px + c + 4 <= W) {
          *reinterpret_cast<uint32_t*>(dst + c) = w4;
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (px + c + b < W) dst[c + b] = static_cast<uint8_t>(w4 >> (8 * b));
        }
      }
    }
}

// ---- k >= 11: the radix select ----

// Any odd k: the counts read the window from shared memory.
__global__ void __launch_bounds__(kThreads)
median_smem_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int H, int W,
                   int k) {
  const int r = k / 2, P = kTileW + 2 * r, rank = k * k / 2;
  extern __shared__ uint8_t s[];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const long long plane = (long long)H * W;
  stage(x + blockIdx.z * plane, s, H, W, y0, x0, r, P);
  __syncthreads();
  const int lx = threadIdx.x % kTileW, ly0 = threadIdx.x / kTileW * kRowsPerThread;
  if (x0 + lx >= W) return;
  uint8_t* o = out + blockIdx.z * plane + x0 + lx;
  for (int p = 0; p < kRowsPerThread && y0 + ly0 + p < H; ++p) {
    const uint8_t* win = s + (ly0 + p) * P + lx;
    uint32_t m = 0;
    for (int b = 7; b >= 0; --b) {
      const uint32_t c = m | (1u << b);
      int n = 0;
      for (int dy = 0; dy < k; ++dy) {
        const uint8_t* row = win + dy * P;
        for (int dx = 0; dx < k; ++dx) n += row[dx] < c;
      }
      if (n <= rank) m = c;
    }
    o[(long long)(y0 + ly0 + p) * W] = static_cast<uint8_t>(m);
  }
}

// k whose halo no CTA holds: each pixel's window read from global memory,
// the indices clamped into the frame. Counts in 64 bits: k * k passes int
// from k = 46341.
__global__ void __launch_bounds__(kThreads)
median_global_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int H, int W,
                     int k) {
  const int r = k / 2;
  const long long rank = (long long)k * k / 2;
  const int lx = threadIdx.x % kTileW, ly0 = threadIdx.x / kTileW * kRowsPerThread;
  const int px = blockIdx.x * kTileW + lx, y0 = blockIdx.y * kTileH + ly0;
  if (px >= W) return;
  const long long plane = (long long)H * W;
  const uint8_t* frame = x + blockIdx.z * plane;
  uint8_t* o = out + blockIdx.z * plane + px;
  for (int p = 0; p < kRowsPerThread && y0 + p < H; ++p) {
    uint32_t m = 0;
    for (int b = 7; b >= 0; --b) {
      const uint32_t c = m | (1u << b);
      long long n = 0;
      for (int dy = -r; dy <= r; ++dy) {
        const uint8_t* row = frame + (long long)min(max(y0 + p + dy, 0), H - 1) * W;
        for (int dx = -r; dx <= r; ++dx) n += __ldg(row + min(max(px + dx, 0), W - 1)) < c;
      }
      if (n <= rank) m = c;
    }
    o[(long long)(y0 + p) * W] = static_cast<uint8_t>(m);
  }
}

using MedianKernel = void (*)(const uint8_t*, uint8_t*, int, int, int);

// One launch of the network kernel for window K per 65535 frames.
template <int K, int THREADS = MedianNet<K>::kThreads,
          int MIN_BLOCKS = MedianNet<K>::kMinBlocks>
cudaError_t launch_net(const uint8_t* x, uint8_t* out, int N, int H, int W, cudaStream_t s) {
  using T = NetTile<K, THREADS>;
  const int load16 = W % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int store4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const long long plane = (long long)H * W;
  if (cdiv(H, 2 * T::BAND) > 65535) return cudaErrorInvalidValue;
  for (int n0 = 0; n0 < N; n0 += 65535) {
    const dim3 grid(cdiv(W, kNetTileW), cdiv(H, 2 * T::BAND), N - n0 < 65535 ? N - n0 : 65535);
    median_net_kernel<K, THREADS, MIN_BLOCKS><<<grid, THREADS, 0, s>>>(
        x + n0 * plane, out + n0 * plane, H, W, load16, store4);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// x (N,H,W) u8 -> out (N,H,W) u8, the k x k median of every frame with
// BORDER_REPLICATE; k odd, 3 or more: k <= 9 by the selection networks,
// larger k by the radix select, the tile's halo in shared memory up to
// k = 435, global memory past it. out must not alias x. Returns
// cudaGetLastError() after the launches (0 = launched): one launch, or one
// a 65535 frames past that.
extern "C" int tpuva_median_u8(const uint8_t* x, uint8_t* out, int N, int H, int W, int k,
                               void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || cdiv(H, kTileH) > 65535 || k < 3 || k % 2 == 0 ||
      x == out)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3: return static_cast<int>(launch_net<3>(x, out, N, H, W, s));
    case 5: return static_cast<int>(launch_net<5>(x, out, N, H, W, s));
    case 7: return static_cast<int>(launch_net<7>(x, out, N, H, W, s));
    case 9: return static_cast<int>(launch_net<9>(x, out, N, H, W, s));
    default: break;
  }
  const int smem = median_smem(k) <= kMaxSmem ? static_cast<int>(median_smem(k)) : 0;
  MedianKernel kernel = smem ? median_smem_kernel : median_global_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long plane = (long long)H * W;
  for (int n0 = 0; n0 < N; n0 += 65535) {
    const dim3 grid(cdiv(W, kTileW), cdiv(H, kTileH), N - n0 < 65535 ? N - n0 : 65535);
    kernel<<<grid, kThreads, smem, s>>>(x + n0 * plane, out + n0 * plane, H, W, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
