// KS: the float running-average background over a batch, for Hopper,
// sm_90a, in both of tpuva's orders.
//
// On the TPU neither order is a Pallas kernel; each is XLA. The scanned
// order replaces tpuva/graph/pipeline.py:85 background_trajectory(
// parallel=True), a jax.lax.associative_scan of the affine maps
// B -> s B + o with s = 1 - alpha, o_t = alpha F_t: the front end of every
// parallel_bg run. The sequential order replaces tpuva/filters.py:403
// FilterBackground's lax.scan of background_update over a float batch.
// Their plain versions are tpuva_torch/ops/background.py::
// background_scan_plain (graph/pipeline.py's _affine_scan recursion, and
// the per-frame loop). Each thread takes one pixel and computes the same
// float32 operations in the same order as the plain version, every
// product and sum rounded on its own (__fmul_rn, __fadd_rn; the library
// is built with --fmad=false besides): bit-equal to it.
//
// Scanned order. jax's associative_scan combines pairs (0, 1), (2, 3),
// ..., recurses on those n / 2 results, then combines each odd result with
// the next even element; combine((s1, o1), (s2, o2)) = (s1 s2, s2 o1 + o2).
// In place over one array that is an up-sweep, x[(2k + 2)d - 1] =
// combine(x[(2k + 2)d - d - 1], x[(2k + 2)d - 1]) for the n_l / 2 pairs
// of each level (d = 1, 2, 4, ...; n_0 = N, n_{l+1} = n_l / 2 while
// n_l >= 2), then a down-sweep from the deepest level back,
// x[(2k + 1)d - 1] = combine(x[(2k + 1)d - d - 1], x[(2k + 1)d - 1]) for
// k = 1 .. (n_l - 1) / 2: the same expressions for every N, odd or even
// (tests/test_torch_background_scan.py holds ops/background.py::
// scan_model, a numpy copy of these loops, to the recursion for N = 1 to
// 300). The s of every node is a scalar shared by all pixels: the wrapper
// replays the same loops on the host in float32 (ops/background.py::
// scan_tables) and uploads the s2 of each combine, in the order the loops
// visit them, and the final S_t; a thread keeps only its pixel's o
// values, N floats, in shared memory laid out [t][pixel] (a warp's
// accesses consecutive), and computes B_t = S_t B_0 + O_t (two roundings),
// the emit, and B_{N-1}. No barrier: a thread owns its column. Where N
// floats for 32 pixels exceed the 227 KB a CTA can have
// (ops/background.py::scan_plan), the column lies in a global scratch,
// one a thread of a grid-stride loop.
//
// Sequential order. b = c1 b + a F_t (three roundings), the emit of
// |F_t - b|, in registers, no scratch.
//
// Emits: "mask", |F - B| > float32(threshold) -> 255 else 0 (cv2's
// THRESH_BINARY); "diff", clip(rint(|F - B|), 0, 255) (rint: half to even,
// as torch.round). Frames are uint8 (the route, after the filter prefix)
// or float32 (the filter chain). B_0 is the filtered first frame where the
// seed flag is set (a host flag, or one on the card), else bg0.
//
// What bounds them on an H100: the scanned order at N = 256 reads the
// frames (1 B a pixel), writes the emit (1 B) and reads and writes the
// background once: 1.07 GB a 1080p batch, 0.322 ms at 3.35 TB/s. Its
// 2N combines a pixel, three shared accesses each, move ~12.7 GB through
// shared memory at 128 B a clock an SM (~0.38 ms); the kernel also reads
// the frames twice (the o values, then the emit). At N = 256 a pixel's
// values take 1 KB of shared memory, so an SM holds 224 pixels, 7 warps:
// the kernel is bound by latency, not by bytes (PERF.md). The sequential
// order reads a float32 frame and writes a byte a pixel and frame.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSeqThreads = 256;

__device__ __forceinline__ float load_f(const uint8_t* p) { return static_cast<float>(*p); }
__device__ __forceinline__ float load_f(const float* p) { return *p; }

// |f - b| (the difference rounded, abs exact) as the emit's byte
__device__ __forceinline__ uint8_t emit_byte(float f, float b, int emit_diff, float thr) {
  const float d = fabsf(__fsub_rn(f, b));
  if (emit_diff) return static_cast<uint8_t>(fminf(fmaxf(rintf(d), 0.0f), 255.0f));
  return d > thr ? 255 : 0;
}

template <typename T>
__global__ void __launch_bounds__(kSeqThreads)
    ks_sequential(const T* __restrict__ f, const float* __restrict__ bg0, uint8_t* __restrict__ out,
                  float* __restrict__ bg_last, long long P, int N, float c1, float a, float thr,
                  int emit_diff, int seed_bg, const uint8_t* __restrict__ seed) {
  const bool seeded = seed ? seed[0] != 0 : seed_bg != 0;
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; p < P;
       p += static_cast<long long>(gridDim.x) * blockDim.x) {
    float b = seeded ? load_f(f + p) : bg0[p];
    for (int t = 0; t < N; ++t) {
      const float x = load_f(f + t * P + p);
      b = __fadd_rn(__fmul_rn(c1, b), __fmul_rn(a, x));
      out[t * P + p] = emit_byte(x, b, emit_diff, thr);
    }
    bg_last[p] = b;
  }
}

// one combine in place: x[q] = s2 x[q - d] + x[q]
__device__ __forceinline__ void combine_at(float* x, long long stride, int q, int d, float s2) {
  x[q * stride] = __fadd_rn(__fmul_rn(s2, x[(q - d) * stride]), x[q * stride]);
}

// tables: the s2 of every combine in the loops' order (ops), then S_t (N)
template <typename T, bool kShared>
__global__ void __launch_bounds__(256)
    ks_scan(const T* __restrict__ f, const float* __restrict__ bg0, uint8_t* __restrict__ out,
            float* __restrict__ bg_last, long long P, int N, const float* __restrict__ tables,
            int ops, float a, float thr, int emit_diff, int seed_bg,
            const uint8_t* __restrict__ seed, float* __restrict__ scratch) {
  extern __shared__ float smem[];
  const bool seeded = seed ? seed[0] != 0 : seed_bg != 0;
  const int px = blockDim.x;  // pixels a CTA
  float* x;
  long long stride;
  if (kShared) {
    x = smem + threadIdx.x;
    stride = px;
  } else {
    x = scratch + static_cast<long long>(blockIdx.x) * px + threadIdx.x;
    stride = static_cast<long long>(gridDim.x) * px;
  }
  int levels = 0;  // level l pairs the N >> l elements of the level above
  while ((N >> levels) >= 2) ++levels;
  const float* S = tables + ops;
  for (long long base = static_cast<long long>(blockIdx.x) * px; base < P;
       base += static_cast<long long>(gridDim.x) * px) {
    const long long p = base + threadIdx.x;
    if (p >= P) continue;
    for (int t = 0; t < N; ++t) x[t * stride] = __fmul_rn(a, load_f(f + t * P + p));
    int op = 0;
    for (int l = 0, d = 1; l < levels; ++l, d <<= 1) {  // up-sweep
      const int m = (N >> l) >> 1;
#pragma unroll 4
      for (int k = 0; k < m; ++k) combine_at(x, stride, (2 * k + 2) * d - 1, d, __ldg(tables + op + k));
      op += m;
    }
    for (int l = levels; l >= 1; --l) {  // down-sweep
      const int d = 1 << (l - 1);
      const int m = ((N >> (l - 1)) - 1) >> 1;
#pragma unroll 4
      for (int k = 1; k <= m; ++k)
        combine_at(x, stride, (2 * k + 1) * d - 1, d, __ldg(tables + op + k - 1));
      op += m;
    }
    const float b0 = seeded ? load_f(f + p) : bg0[p];
    float b = b0;
    for (int t = 0; t < N; ++t) {
      b = __fadd_rn(__fmul_rn(__ldg(S + t), b0), x[t * stride]);
      out[t * P + p] = emit_byte(load_f(f + t * P + p), b, emit_diff, thr);
    }
    bg_last[p] = b;
  }
}

template <typename T>
cudaError_t launch(const void* frames, const float* bg0, uint8_t* out, float* bg_last,
                   long long P, int N, int order, const float* tables, int ops, float c1,
                   float a, float thr, int emit_diff, int seed_bg, const uint8_t* seed, int px,
                   int shared, int grid, float* scratch, cudaStream_t s) {
  const T* f = static_cast<const T*>(frames);
  if (order == 1) {
    ks_sequential<T><<<grid, kSeqThreads, 0, s>>>(f, bg0, out, bg_last, P, N, c1, a, thr,
                                                  emit_diff, seed_bg, seed);
    return cudaGetLastError();
  }
  if (shared) {
    const size_t smem = static_cast<size_t>(N) * px * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(ks_scan<T, true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    ks_scan<T, true><<<grid, px, smem, s>>>(f, bg0, out, bg_last, P, N, tables, ops, a, thr,
                                            emit_diff, seed_bg, seed, nullptr);
  } else {
    ks_scan<T, false><<<grid, px, 0, s>>>(f, bg0, out, bg_last, P, N, tables, ops, a, thr,
                                          emit_diff, seed_bg, seed, scratch);
  }
  return cudaGetLastError();
}

}  // namespace

// KS: frames (N, P) uint8 (is_float 0) or float32 (1), bg0 (P) float32 ->
// out (N, P) uint8 (emit_diff 1: the rounded magnitudes; 0: the mask of
// |F - B| > thr), bg_last (P) float32. order 0 scanned (tables: the s2 of
// its ops combines, then S, from ops/background.py::scan_tables; px pixels
// a CTA, shared 1: their columns in px * N floats of shared memory, 0: in
// scratch, grid * px * N floats), 1 sequential (c1, a; px and tables
// unused). seed (a flag on the card) or seed_bg (where seed is null)
// starts B from the first frame. Returns cudaGetLastError().
extern "C" int tpuva_background_scan(const void* frames, int is_float, const float* bg0,
                                     uint8_t* out, float* bg_last, long long P, int N, int order,
                                     const float* tables, int ops, float c1, float a, float thr,
                                     int emit_diff, int seed_bg, const uint8_t* seed, int px,
                                     int shared, int grid, float* scratch, void* stream) {
  if (P <= 0 || N <= 0 || grid <= 0 || (order != 0 && order != 1) ||
      (order == 0 && (!tables || ops < 0 || px <= 0 || px > 256 || px % 32 ||
                      (!shared && !scratch))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_float ? launch<float>(frames, bg0, out, bg_last, P, N, order, tables, ops, c1, a, thr,
                               emit_diff, seed_bg, seed, px, shared, grid, scratch, s)
               : launch<uint8_t>(frames, bg0, out, bg_last, P, N, order, tables, ops, c1, a,
                                 thr, emit_diff, seed_bg, seed, px, shared, grid, scratch, s);
  return static_cast<int>(err);
}
