// Exact Euclidean distance transform of masks (kernel KE) for Hopper, sm_90a.
//
// Replaces tpuva/ops/distance.py::distance_transform_edt and
// distance_transform_edt_sq (:65, :81). On the TPU it is an XLA program,
// not a Pallas kernel: per axis a lax.while_loop of 3-point parabolic
// erosions (_edt_pass_axis, :38) run to its first unchanged pass, on the
// device. The port's plain version, tpuva_torch/ops/distance.py::
// edt_sq_passes_plain, runs the same loop as torch ops with a host read a
// pass. Its fixed point is exactly the separable squared EDT: the column
// stage gives every pixel its column's squared distance to the nearest
// zero, g (+inf where the column has none), the row stage the min-plus
// D(x) = min over x' of g(x') + (x - x')^2. An exact algorithm for those
// two stages therefore equals the plain version bit for bit wherever the
// squared distances are below 2^24 (float32 holds every integer there):
// always where (H - 1)^2 + (W - 1)^2 < 2^24, a 1080p or 2896 x 2896 frame.
// The kernel sums in 32-bit integers and rounds once to float32, so a
// squared distance of 2^24 or more (a pixel 4096 px or farther from every
// zero, only on frames whose diagonal passes 4096 px) is the correctly
// rounded one, where the plain version's float32 sums may round on the
// way. Past 4096 px a side the entry point refuses the masks.
//
// Design, two kernels a call on the caller's stream, no host read:
// - edt_cols_kernel: a thread a column of one mask (blockIdx.y), 128
//   columns a CTA, neighbouring threads on neighbouring bytes. A down scan
//   writes each pixel's distance to the nearest zero above it as uint16
//   (kNone: no zero yet), an up scan reads it back and writes the smaller
//   of it and the distance to the nearest zero below. Rows are read eight
//   at a time before the dependent scan uses them.
// - edt_rows_kernel: a CTA a row: the row's column distances squared into
//   shared memory (uint32, kInf for none), then a thread an output x,
//   searching outward from g(x): offset j on both sides while j^2 < the
//   best so far (no farther x' can beat it). A row with no finite g is
//   +inf throughout and searches nothing. __fsqrt_rn gives the distance,
//   correctly rounded as torch.sqrt is.
// Both stages also report the pass counts of the plain loop: the column
// loop stops after 1 + the largest finite column distance, the row loop
// after 1 + the largest smallest minimising offset of a finite output
// (the pass that last lowered it), so each kernel keeps that maximum with
// one atomicMax a warp.
//
// What bounds it on an H100: bytes, 1 B read and 4 B written a pixel,
// 0.050 ms for 16 1080p masks at 3.35 TB/s. This kernel also writes and
// reads the uint16 column distances twice (13 B a pixel in all), and a
// column's scan is a chain of dependent rows, so it runs far from that.
// The row search costs about the distance a pixel: on motion masks,
// mostly zeros, a few steps a pixel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSide = 4096;  // the uint16 distances and the row's shared memory
constexpr uint16_t kNone = 0xffff;  // no zero in that direction
constexpr uint32_t kInf = 0x7f000000u;  // +inf squared; kInf + 4095^2 < 2^32
constexpr int kColThreads = 128;
constexpr int kRowThreads = 256;
constexpr int kRowsAhead = 8;

__device__ __forceinline__ uint16_t step(uint16_t run) {
  return run == kNone ? kNone : static_cast<uint16_t>(run + 1);
}

__device__ __forceinline__ void warp_max_to(int* dst, unsigned v) {
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && v) atomicMax(dst, static_cast<int>(v));
}

__global__ void __launch_bounds__(kColThreads)
edt_cols_kernel(const uint8_t* __restrict__ mask, uint16_t* __restrict__ cols, int H, int W,
                int* __restrict__ passes) {
  const int x = blockIdx.x * kColThreads + threadIdx.x;
  const bool ok = x < W;
  const long long plane = static_cast<long long>(H) * W;
  const uint8_t* m = mask + blockIdx.y * plane + x;
  uint16_t* c = cols + blockIdx.y * plane + x;
  unsigned far = 0;
  if (ok) {
    uint16_t run = kNone;
    for (int y0 = 0; y0 < H; y0 += kRowsAhead) {
      uint8_t v[kRowsAhead];
#pragma unroll
      for (int i = 0; i < kRowsAhead; ++i)
        if (y0 + i < H) v[i] = m[static_cast<long long>(y0 + i) * W];
#pragma unroll
      for (int i = 0; i < kRowsAhead; ++i)
        if (y0 + i < H) {
          run = v[i] ? step(run) : 0;
          c[static_cast<long long>(y0 + i) * W] = run;
        }
    }
    run = kNone;
    for (int y0 = H - 1; y0 >= 0; y0 -= kRowsAhead) {
      uint16_t v[kRowsAhead];
#pragma unroll
      for (int i = 0; i < kRowsAhead; ++i)
        if (y0 - i >= 0) v[i] = c[static_cast<long long>(y0 - i) * W];
#pragma unroll
      for (int i = 0; i < kRowsAhead; ++i)
        if (y0 - i >= 0) {
          run = v[i] == 0 ? 0 : step(run);
          const uint16_t d = v[i] < run ? v[i] : run;
          c[static_cast<long long>(y0 - i) * W] = d;
          if (d != kNone) far = max(far, static_cast<unsigned>(d));
        }
    }
  }
  warp_max_to(&passes[0], far);
}

__global__ void __launch_bounds__(kRowThreads)
edt_rows_kernel(const uint16_t* __restrict__ cols, float* __restrict__ out, int W, int root,
                int* __restrict__ passes) {
  __shared__ uint32_t g[kMaxSide];
  const long long row = static_cast<long long>(blockIdx.x) * W;  // (mask, y) flattened
  int finite = 0;
  for (int x = threadIdx.x; x < W; x += kRowThreads) {
    const uint16_t d = cols[row + x];
    g[x] = d == kNone ? kInf : static_cast<uint32_t>(d) * d;
    finite |= d != kNone;
  }
  finite = __syncthreads_or(finite);
  unsigned farthest = 0;  // the largest smallest minimising offset of a finite output
  for (int x = threadIdx.x; x < W; x += kRowThreads) {
    uint32_t best = g[x];
    int at = 0;
    if (finite && best != 0) {
      const int reach = max(x, W - 1 - x);
      for (int j = 1; j <= reach; ++j) {
        const uint32_t jj = static_cast<uint32_t>(j) * j;
        if (jj >= best) break;  // g >= 0: no x' this far or farther beats best
        if (j <= x) {
          const uint32_t v = g[x - j] + jj;
          if (v < best) best = v, at = j;
        }
        if (x + j < W) {
          const uint32_t v = g[x + j] + jj;
          if (v < best) best = v, at = j;
        }
      }
    }
    float r;
    if (best >= kInf) {
      r = __int_as_float(0x7f800000);  // +inf
    } else {
      r = __uint2float_rn(best);
      if (root) r = __fsqrt_rn(r);
      farthest = max(farthest, static_cast<unsigned>(at));
    }
    out[row + x] = r;
  }
  warp_max_to(&passes[1], farthest);
}

}  // namespace

// mask (L, H, W) uint8 (nonzero = foreground) -> out (L, H, W) float32, the
// squared EDT or (root) the EDT; cols (L, H, W) uint16 scratch; passes
// int32[2], zeroed by the caller, receives the largest finite column
// distance and the largest smallest minimising row offset (the plain
// loop's pass counts less one). Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int tpuva_edt(const uint8_t* mask, uint16_t* cols, float* out, int* passes,
                         int L, int H, int W, int root, void* stream) {
  if (L <= 0 || H <= 0 || W <= 0 || H > kMaxSide || W > kMaxSide || L > 65535 ||
      static_cast<long long>(L) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  edt_cols_kernel<<<dim3((W + kColThreads - 1) / kColThreads, L), kColThreads, 0, s>>>(
      mask, cols, H, W, passes);
  edt_rows_kernel<<<static_cast<unsigned>(L * H), kRowThreads, 0, s>>>(cols, out, W, root,
                                                                       passes);
  return static_cast<int>(cudaGetLastError());
}
