// K1's stages past a CTA's shared memory (kernels K1b and K1m) for
// Hopper, sm_90a.
//
// Replaces the parts of the Pallas TPU kernel tpuva/ops/pallas/
// fused_segment.py::fused_segment that csrc/fused_segment.cu cannot hold:
// that kernel keeps a tile's window, row sums and morphology region in
// shared memory, so a blur of more than 63 taps, a structuring element
// wider than 31, or a morphology reach whose tile outgrows a CTA's 227 KB
// (open and close 7 x 10 reach 120 pixels) does not fit it. The TPU
// kernel has no such limit (its tiles live in VMEM). The wrapper
// (ops/fused_segment.py::fused_segment) takes those stages out of K1 and
// runs them here, over global memory:
//   K1b, blur_u8: cv2's u8 Gaussian, REFLECT_101, integer taps,
//     (acc + 2^(s-1)) >> s, as two passes (rows into uint16 sums, then
//     columns), before K1 runs on the blurred frames without a blur;
//   K1m, morph_u8: one erode or dilate step over any structuring element
//     (as runs: a row offset and the column offsets lo..hi it covers),
//     cv2's constant borders (erode reads outside pixels as 255, dilate as
//     0, so they are skipped), after K1 runs without morphology: open and
//     close are one launch a step. For K1's padded_occ mode the last step
//     writes the (N, Hp, Wp) padded mask (0 outside the H x W image) and
//     sets the (N, Hp/2, Wp/128) occupancy of its foreground, as K1 does
//     where it runs the morphology itself: the occupancy is that of the
//     final mask.
// Both are exact integer code; the plain PyTorch versions are
// tpuva_torch/ops/filters.py::gaussian_blur_u8 and its _morph, and the
// kernels are bit-equal to them.
//
// Design. One thread a pixel, 256 threads a CTA along a row, the grid over
// (columns, rows, frames): neighbouring threads read neighbouring bytes,
// and the taps or runs are read at one address by a whole warp. A simple
// kernel first: every tap is a load through L1, so a step costs O(taps)
// loads a pixel, and the bound is the operations at large structuring
// elements (PERF.md has the times). K1m clips each run to the image once,
// so its inner loop is a load and a min or max, and leaves a pixel's runs
// once the value can no longer change (0 for erode, 255 for dilate).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Source index of position i along an axis of length n under REFLECT_101,
// with as many reflections as the reach needs.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i >= n ? period - i : i;
}

__global__ void __launch_bounds__(kThreads)
blur_rows_kernel(const uint8_t* __restrict__ x, uint16_t* __restrict__ rows,
                 int H, int W, const int* __restrict__ taps, int ntaps) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= W) return;
  const size_t row = (size_t(blockIdx.z) * H + blockIdx.y) * W;
  const uint8_t* src = x + row;
  const int r = ntaps / 2;
  int acc = 0;
  if (col >= r && col + r < W) {
    for (int k = 0; k < ntaps; ++k) acc += taps[k] * src[col + k - r];
  } else {
    for (int k = 0; k < ntaps; ++k) acc += taps[k] * src[reflect101(col + k - r, W)];
  }
  rows[row + col] = static_cast<uint16_t>(acc);
}

__global__ void __launch_bounds__(kThreads)
blur_cols_kernel(const uint16_t* __restrict__ rows, uint8_t* __restrict__ out,
                 int H, int W, const int* __restrict__ taps, int ntaps, int shift) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= W) return;
  const int y = blockIdx.y;
  const uint16_t* src = rows + size_t(blockIdx.z) * H * W + col;
  const int r = ntaps / 2;
  int acc = 0;  // at most 255 * 256 * 256 < 2^24
  if (y >= r && y + r < H) {
    for (int k = 0; k < ntaps; ++k) acc += taps[k] * src[size_t(y + k - r) * W];
  } else {
    for (int k = 0; k < ntaps; ++k) acc += taps[k] * src[size_t(reflect101(y + k - r, H)) * W];
  }
  out[(size_t(blockIdx.z) * H + y) * W + col] =
      static_cast<uint8_t>((acc + (1 << (shift - 1))) >> shift);
}

// One thread an output pixel of an (Hp, Wp) image (H, W unless padded):
// pixels outside the H x W input are 0; with occ, foreground sets its
// 2-row x 128-column block's byte.
template <bool kErode>
__global__ void __launch_bounds__(kThreads)
morph_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int H, int W,
             const int* __restrict__ runs, int n, int Hp, int Wp, uint8_t* __restrict__ occ) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= Wp) return;
  const int y = blockIdx.y;
  uint8_t* dst = out + (size_t(blockIdx.z) * Hp + y) * Wp + col;
  if (y >= H || col >= W) {
    *dst = 0;
    return;
  }
  const uint8_t* src = x + size_t(blockIdx.z) * H * W;
  // erode: the minimum, from 255 (outside pixels); dilate: the maximum, from 0
  constexpr int kStop = kErode ? 0 : 255;
  int v = kErode ? 255 : 0;
  for (int k = 0; k < n && v != kStop; ++k) {
    const int yy = y + runs[3 * k];  // run k: row offset, column offsets lo..hi
    if (yy < 0 || yy >= H) continue;
    const uint8_t* row = src + size_t(yy) * W;
    const int a = max(col + runs[3 * k + 1], 0), b = min(col + runs[3 * k + 2], W - 1);
    for (int xx = a; xx <= b; ++xx) v = kErode ? min(v, int(row[xx])) : max(v, int(row[xx]));
  }
  *dst = static_cast<uint8_t>(v);
  if (occ && v) occ[(size_t(blockIdx.z) * (Hp / 2) + (y >> 1)) * (Wp / 128) + (col >> 7)] = 1;
}

bool shape_ok(int N, int H, int W) {
  return N > 0 && H > 0 && W > 0 && N <= 65535 && H <= 65535;
}

}  // namespace

// x (N,H,W) u8 -> out (N,H,W) u8, the blur of every frame; rows is an
// (N,H,W) uint16 buffer for the row pass. taps: ntaps (odd) non-negative
// ints on the device whose sum times 255 fits in 16 bits (the caller,
// which made them, checks that); shift >= 1. Returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int tpuva_blur_u8(const uint8_t* x, uint16_t* rows, uint8_t* out, int N, int H,
                             int W, const int* taps, int ntaps, int shift, void* stream) {
  if (!shape_ok(N, H, W) || ntaps < 1 || ntaps % 2 == 0 || shift < 1 || shift > 24)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kThreads - 1) / kThreads, H, N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  blur_rows_kernel<<<grid, kThreads, 0, s>>>(x, rows, H, W, taps, ntaps);
  blur_cols_kernel<<<grid, kThreads, 0, s>>>(rows, out, H, W, taps, ntaps, shift);
  return static_cast<int>(cudaGetLastError());
}

// x (N,H,W) u8 -> out (N,Hp,Wp) u8: one erode (erode != 0) or dilate step
// over the structuring element's n runs on the device, int32 triples
// (dy, lo, hi): the pixels (dy, lo..hi) from the anchor. out must not
// alias x. Unpadded, Hp = H, Wp = W and occ is null; K1's padded_occ mode
// passes Hp >= H even, Wp >= W a multiple of 128 and occ (N, Hp/2, Wp/128)
// u8, which the launch clears and the kernel sets. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int tpuva_morph_u8(const uint8_t* x, uint8_t* out, int N, int H, int W,
                              const int* runs, int n, int erode, int Hp, int Wp,
                              uint8_t* occ, void* stream) {
  if (!shape_ok(N, Hp, Wp) || n < 1 || x == out || H <= 0 || W <= 0 || Hp < H || Wp < W ||
      (occ == nullptr && (Hp != H || Wp != W)) || (occ != nullptr && (Hp % 2 || Wp % 128)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Wp + kThreads - 1) / kThreads, Hp, N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (occ != nullptr &&
      (err = cudaMemsetAsync(occ, 0, size_t(N) * (Hp / 2) * (Wp / 128), s)) != cudaSuccess)
    return static_cast<int>(err);
  if (erode)
    morph_kernel<true><<<grid, kThreads, 0, s>>>(x, out, H, W, runs, n, Hp, Wp, occ);
  else
    morph_kernel<false><<<grid, kThreads, 0, s>>>(x, out, H, W, runs, n, Hp, Wp, occ);
  return static_cast<int>(cudaGetLastError());
}
