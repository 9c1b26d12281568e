// Exact k x k median of uint8 frames (kernel K7) for Hopper, sm_90a.
//
// Replaces tpuva/ops/filters.py::median_blur for k > 3 on uint8 frames:
// cv2.medianBlur's exact median with BORDER_REPLICATE. On the TPU it is
// XLA code, not a Pallas kernel: jnp.sort over the stacked k*k window axis
// (the 19-op network for k = 3). The port's plain version,
// tpuva_torch/ops/filters.py::median_u8_plain, does the same with
// torch.sort over chunks of frames; the kernel is bit-equal to it (a
// median of integers has one answer). Every odd k from 3 up is taken.
//
// Design. One CTA owns a kTileH x kTileW tile of one frame (blockIdx.z)
// and stages it with a halo of r = k / 2 rows and columns into shared
// memory, the indices clamped into the frame (BORDER_REPLICATE; a frame
// smaller than the window, or one row high, clamps the same way). A
// thread owns kRowsPerThread consecutive pixels of one column and finds
// each one's median by a radix select: from the top bit down, the
// candidate prefix | bit is kept while at most rank = k*k / 2 window
// values lie below it, which ends on the rank-th smallest value, ties
// included. That is 8 counts of the k*k window a pixel. For k <= 9
// (median_reg_kernel) the window lives in registers and slides down the
// thread's column, one new row of k loads a pixel; larger k
// (median_smem_kernel) count straight from shared memory. A 32 x 64 tile
// with k = 255's halo takes 286 x 318 bytes (89 KB), under a CTA's 227 KB;
// the halo fits up to k = 435. Past that, median_global_kernel stages
// nothing and counts each pixel's window from global memory through the
// caches, its indices clamped the same way.
//
// What bounds it on an H100: one byte read and one written a pixel (0.317
// ms for a 256-frame 1080p batch at 3.35 TB/s) against the radix select's
// 8 k^2 compares and adds a pixel (at k = 7, 784 operations: 6.2 ms at 67
// Tops/s). So this design is bound by its operations, well above the
// byte time; a sliding-histogram design (O(k) a pixel) is the redesign.

#include <cstdint>
#include <cuda_runtime.h>

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

// k <= 9: the thread's window in registers, sliding down its column.
template <int K>
__global__ void __launch_bounds__(kThreads)
median_reg_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int H, int W, int) {
  constexpr int R = K / 2, P = kTileW + 2 * R, RANK = K * K / 2;
  extern __shared__ uint8_t s[];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const long long plane = (long long)H * W;
  stage(x + blockIdx.z * plane, s, H, W, y0, x0, R, P);
  __syncthreads();
  const int lx = threadIdx.x % kTileW, ly0 = threadIdx.x / kTileW * kRowsPerThread;
  if (x0 + lx >= W) return;
  uint8_t* o = out + blockIdx.z * plane + x0 + lx;
  uint32_t v[K][K];  // v[dy][dx]: window row dy of the current pixel
#pragma unroll
  for (int dy = 0; dy + 1 < K; ++dy)
#pragma unroll
    for (int dx = 0; dx < K; ++dx) v[dy + 1][dx] = s[(ly0 + dy) * P + lx + dx];
#pragma unroll
  for (int p = 0; p < kRowsPerThread; ++p) {
    if (y0 + ly0 + p >= H) break;
#pragma unroll
    for (int dy = 0; dy + 1 < K; ++dy)
#pragma unroll
      for (int dx = 0; dx < K; ++dx) v[dy][dx] = v[dy + 1][dx];
#pragma unroll
    for (int dx = 0; dx < K; ++dx) v[K - 1][dx] = s[(ly0 + p + K - 1) * P + lx + dx];
    uint32_t m = 0;
#pragma unroll
    for (int b = 7; b >= 0; --b) {
      const uint32_t c = m | (1u << b);
      int n = 0;
#pragma unroll
      for (int dy = 0; dy < K; ++dy)
#pragma unroll
        for (int dx = 0; dx < K; ++dx) n += v[dy][dx] < c;
      if (n <= RANK) m = c;
    }
    o[(long long)(y0 + ly0 + p) * W] = static_cast<uint8_t>(m);
  }
}

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

}  // namespace

// x (N,H,W) u8 -> out (N,H,W) u8, the k x k median of every frame with
// BORDER_REPLICATE; k odd, 3 or more: k <= 9 in registers, the tile's halo
// in shared memory up to k = 435, global memory past it. out must not
// alias x. Returns cudaGetLastError() after the launches (0 = launched):
// one launch, or one a 65535 frames past that.
extern "C" int tpuva_median_u8(const uint8_t* x, uint8_t* out, int N, int H, int W, int k,
                               void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || cdiv(H, kTileH) > 65535 || k < 3 || k % 2 == 0 ||
      x == out)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = median_smem(k) <= kMaxSmem ? static_cast<int>(median_smem(k)) : 0;
  MedianKernel kernel = k == 3   ? median_reg_kernel<3>
                        : k == 5 ? median_reg_kernel<5>
                        : k == 7 ? median_reg_kernel<7>
                        : k == 9 ? median_reg_kernel<9>
                        : smem   ? median_smem_kernel
                                 : median_global_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plane = (long long)H * W;
  for (int n0 = 0; n0 < N; n0 += 65535) {
    const dim3 grid(cdiv(W, kTileW), cdiv(H, kTileH), N - n0 < 65535 ? N - n0 : 65535);
    kernel<<<grid, kThreads, smem, s>>>(x + n0 * plane, out + n0 * plane, H, W, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
