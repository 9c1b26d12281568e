// 256-bin histogram of a uint8 image batch (kernel K4) for Hopper, sm_90a.
//
// Replaces tpuva/ops/filters.py::histogram_u8, the histogram of the staged
// Otsu route (tpuva/graph/pipeline.py::_otsu_mask_stage). On the TPU it is
// an XLA program, not a Pallas kernel: one bf16 one-hot matmul per image on
// the MXU, because a scatter-add is slow there. Here it is a hand-written
// kernel with integer atomics, exact for any count below 2^31. The plain
// PyTorch version is tpuva_torch/ops/filters.py::histogram_u8_plain; the
// two are bit-equal (integer counts do not depend on the order of adds).
//
// Design. A grid of CTAs per frame (blockIdx.y = frame), each over one
// contiguous chunk of the frame's pixels: the CTA zeroes a 256-bin int32
// histogram in shared memory, its threads read 16 bytes per load (uint4,
// neighbouring threads on neighbouring addresses) and add each byte with
// an atomicAdd on shared memory, and then the CTA adds its non-zero bins
// to the frame's row of the output with one global atomicAdd each. Chunk
// ends that are not 16-byte aligned (a frame of H*W % 16 != 0 starts
// anywhere) are read a byte at a time.
//
// What bounds it on an H100: the bytes, 1 B read per pixel (0.16 ms for
// 531 MB at 3.35 TB/s); one add per pixel is far below the card's integer
// rate. The Otsu route feeds it |F - B| magnitudes, most of them in a few
// low bins, so a warp's shared-memory atomics often hit one address; on
// the route's batch-256 1080p magnitudes it still runs within 1.25x of the
// byte bound (PERF.md), so per-warp sub-histograms are not needed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1 << 16;  // pixels per CTA (a multiple of 16)

__device__ __forceinline__ void add_word(int* h, uint32_t w) {
  atomicAdd(&h[w & 0xff], 1);
  atomicAdd(&h[(w >> 8) & 0xff], 1);
  atomicAdd(&h[(w >> 16) & 0xff], 1);
  atomicAdd(&h[w >> 24], 1);
}

__global__ void __launch_bounds__(kThreads)
histogram_u8_kernel(const uint8_t* __restrict__ x, long long P,
                    int* __restrict__ hist) {
  __shared__ int h[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) h[i] = 0;
  __syncthreads();

  const uint8_t* frame = x + (long long)blockIdx.y * P;
  const long long start = (long long)blockIdx.x * kChunk;
  const long long end = min(start + (long long)kChunk, P);
  const uint8_t* a = frame + start;
  const uint8_t* b = frame + end;
  // the 16-byte aligned middle [a16, b16) of [a, b)
  const uint8_t* a16 = reinterpret_cast<const uint8_t*>(
      (reinterpret_cast<uintptr_t>(a) + 15) & ~uintptr_t(15));
  const uint8_t* b16 = reinterpret_cast<const uint8_t*>(
      reinterpret_cast<uintptr_t>(b) & ~uintptr_t(15));
  if (a16 >= b16) {  // no aligned middle: all bytes one at a time
    a16 = b16 = b;
  }
  for (const uint8_t* p = a + threadIdx.x; p < a16; p += blockDim.x) atomicAdd(&h[*p], 1);
  for (const uint8_t* p = b16 + threadIdx.x; p < b; p += blockDim.x) atomicAdd(&h[*p], 1);
  const uint4* v = reinterpret_cast<const uint4*>(a16);
  const long long nv = (b16 - a16) / 16;
  for (long long i = threadIdx.x; i < nv; i += blockDim.x) {
    const uint4 w = v[i];
    add_word(h, w.x);
    add_word(h, w.y);
    add_word(h, w.z);
    add_word(h, w.w);
  }
  __syncthreads();

  int* out = hist + (long long)blockIdx.y * 256;
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    if (h[i]) atomicAdd(&out[i], h[i]);
}

}  // namespace

// x (L, P) uint8 -> hist (L, 256) int32, which the caller has zeroed.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tpuva_histogram_u8(const uint8_t* x, int L, long long P,
                                  int* hist, void* stream) {
  if (L <= 0 || P <= 0 || L > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((P + kChunk - 1) / kChunk), L);
  histogram_u8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, P, hist);
  return static_cast<int>(cudaGetLastError());
}
