// Exact Euclidean distance transform of masks (kernel KE) for Hopper, sm_90a.
//
// Replaces tpuva/ops/distance.py::distance_transform_edt and
// distance_transform_edt_sq (:65, :81). On the TPU it is an XLA program,
// not a Pallas kernel: per axis a lax.while_loop of 3-point parabolic
// erosions (_edt_pass_axis, :38), pass k adding 2k - 1 in float32, run to
// its first unchanged pass. The port's plain version, tpuva_torch/ops/
// distance.py::edt_sq_passes_plain, runs the same loop as torch ops. This
// kernel gives that loop's float32 values, bit for bit, at every size:
// - Columns. A pixel whose nearest zero in its column is d rows away ends
//   the column loop at f(d), f(0) = 0, f(d) = fl(f(d - 1) + (2d - 1)) (a
//   float add is monotone, so no later pass lowers it), +inf where the
//   column has no zero. f(d) = d^2 exactly up to d = 4096; past it
//   (H > 4097) f comes from the caller's table (ops/distance.py f_table,
//   uploaded once a height).
// - Rows. The loop's fixed point is D(x) = min over x' of the float chain
//   g(x') + 1 + 3 + ... + (2j - 1), j = |x - x'| (moves at passes 1..j are
//   the cheapest walk; min commutes with a monotone add). Each sum is
//   exact while it stays below 2^24, so where a pixel's minimum is below
//   2^24 an outward search with exact candidates g(x') + j^2, bounded by
//   j^2 < best, gives it: a candidate whose exact sum passes 2^24 rounds
//   to 2^24 or more and cannot win. A row where some pixel's minimum
//   reaches 2^24 (a pixel 4096 px or more from every zero) is flagged, and
//   edt_round_rows_kernel runs tpuva's row loop on it, in float32 with
//   __fadd_rn, to the row's own fixed point (a pass that changes nothing
//   in a row leaves it fixed for good, so this equals the batch's loop).
//   Only shapes with (H - 1)^2 + (W - 1)^2 >= 2^24 can flag a row; the
//   launcher runs that kernel only for them.
// - Passes. The column loop stops after 1 + the largest finite column
//   distance, the row loop after 1 + the last pass that lowered a finite
//   output: the smallest minimising offset of the search, or the last
//   changing pass of the row loop. The band kernel keeps its maximum with
//   one global atomicMax a CTA (its warps' go to shared memory first: one
//   a warp, all on one address, serialised at L2), the row loop's kernel
//   one a warp.
//
// Design, on the caller's stream, no host read:
// - edt_band_kernel: a CTA a band of R rows of one mask (R from the width,
//   a band's squared distances fit kBandBytes of shared memory; past
//   kSharedRow, where one row and its staged mask rows, 9 W bytes, no
//   longer fit, a row's live in global scratch). The band's mask rows and
//   kHalo rows either side are staged into shared memory first, every
//   4-byte cp.async in flight at once (a thread's column scans would
//   otherwise wait on one global load a row). A thread takes 4 columns:
//   it scans up from the band for each column's nearest zero above and
//   down for the one below (the staged rows first, global memory past
//   them; per-thread early exit: on motion masks a row or two), then down
//   and up the band's rows, writing f(d) into shared memory. Then a thread
//   a pixel, neighbouring threads on neighbouring pixels: the row search
//   out of shared memory, the result (or __fsqrt_rn of it) stored once.
// - edt_round_rows_kernel (large shapes only): a CTA a flagged row, the
//   row loop in two shared buffers (global ones past kSharedRow).
// - Masks: a launch takes up to 65535 (grid y); the wrapper splits more.
//
// What bounds it on an H100: bytes, 1 B read and 4 B written a pixel,
// 0.050 ms for 16 1080p masks at 3.35 TB/s. The band kernel moves about
// that: the mask once (plus the rows above and below a band that its
// scans reach) and the float32 result once; the column distances never
// leave shared memory. The row search costs about the distance a pixel:
// on motion masks, mostly zeros, a few steps a pixel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kNone = 0xffffffffu;  // no zero in that direction
constexpr float kExact = 16777216.0f;    // 2^24: below it float32 holds every integer
constexpr int kBandThreads = 512;
constexpr int kHalo = 2;  // rows staged above and below a band
constexpr int kLoopThreads = 1024;
constexpr int kMaxBandRows = 32;
constexpr int kBandBytes = 61440;  // a band's squared distances in shared memory
constexpr int kSharedRow = 25600;  // widest row in shared memory
constexpr int kExactSide = 4096;   // f(d) = d^2 up to here
constexpr int kOptinBytes = 232448;  // an H100 CTA's shared memory, opted in
constexpr int kBandStatic = 2 * kMaxBandRows * 4 + 2 * 4;  // the band kernel's static arrays
// a band of one row: its f(d) (4 W) and its mask rows with the halo (5 W);
// the row loop's two buffers (8 W) fit too
static_assert(9 * kSharedRow + kBandStatic <= kOptinBytes, "band kernel past shared memory");
static_assert(8 * kSharedRow <= kOptinBytes, "row loop past shared memory");

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// the warp's largest v into *dst (shared memory, or global memory where
// few warps write)
__device__ __forceinline__ void warp_max_to(int* dst, unsigned v) {
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && v) atomicMax(dst, static_cast<int>(v));
}

// the mask bytes of columns c0 .. c0 + 3 of a row, packed; columns past W
// read as 0 (a zero: the scans stop there, and they are never stored)
template <bool kVec>
__device__ __forceinline__ uint32_t load4(const uint8_t* row, int c0, int nc) {
  if (kVec) return *reinterpret_cast<const uint32_t*>(row + c0);
  uint32_t w = 0;
  for (int i = 0; i < nc; ++i) w |= static_cast<uint32_t>(row[c0 + i]) << (8 * i);
  return w;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ bool zero_at(uint32_t w, int i) { return ((w >> (8 * i)) & 0xffu) == 0; }

__device__ __forceinline__ uint32_t step(uint32_t run) { return run == kNone ? kNone : run + 1; }

// row y of the mask: from the staged rows [ys, ye) in shared memory, else
// from global memory
struct Rows {
  const uint8_t* m;  // the mask in global memory
  const uint8_t* s;  // rows ys .. ye - 1 in shared memory
  int W, ys, ye;
  __device__ __forceinline__ const uint8_t* operator()(int y) const {
    return y >= ys && y < ye ? s + (y - ys) * W : m + static_cast<long long>(y) * W;
  }
};

// the distance from row `from` to the nearest zero of each column in rows
// from + dir, from + 2 dir, ... (kNone without one): the staged rows one at
// a time, then 4 rows of global memory at once
template <bool kVec>
__device__ void scan_out(const Rows& rows, int H, int from, int dir, int c0, int nc,
                         uint32_t dist[4]) {
  unsigned need = (1u << nc) - 1;
  for (int i = 0; i < 4; ++i) dist[i] = kNone;
  auto take = [&](uint32_t w, int k) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if ((need >> i & 1u) && zero_at(w, i)) {
        dist[i] = static_cast<uint32_t>(k);
        need &= ~(1u << i);
      }
  };
  int k = 1;
  for (; need; ++k) {
    const int y = from + dir * k;
    if (y < rows.ys || y >= rows.ye) break;
    take(load4<kVec>(rows.s + (y - rows.ys) * rows.W, c0, nc), k);
  }
  for (; need; k += 4) {
    if (from + dir * k < 0 || from + dir * k >= H) break;
    uint32_t w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int y = from + dir * (k + u);
      w[u] = y >= 0 && y < H ? load4<kVec>(rows(y), c0, nc) : 0xffffffffu;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) take(w[u], k + u);
  }
}

// f(d) as the column loop leaves it
__device__ __forceinline__ float col_value(uint32_t d, const float* __restrict__ ftab) {
  if (d == kNone) return inf();
  return d <= kExactSide ? static_cast<float>(d * d) : ftab[d];
}

template <bool kVec, bool kWide>
__global__ void __launch_bounds__(kBandThreads)
edt_band_kernel(const uint8_t* __restrict__ mask, float* __restrict__ out, float* scratch,
                const float* __restrict__ ftab, int* __restrict__ list, int* __restrict__ passes,
                int H, int W, int R, int root) {
  extern __shared__ float4 smem4[];
  __shared__ int row_any[kMaxBandRows];   // the row holds a finite column value
  __shared__ int row_flag[kMaxBandRows];  // a pixel's minimum reached 2^24
  __shared__ int cta_max[2];               // the CTA's part of passes
  const int y0 = blockIdx.x * R;
  const int rows = min(R, H - y0);
  const long long plane = static_cast<long long>(H) * W;
  const uint8_t* m = mask + blockIdx.y * plane;
  float* o = out + blockIdx.y * plane + static_cast<long long>(y0) * W;
  float* g = kWide ? scratch + blockIdx.y * plane + static_cast<long long>(y0) * W
                   : reinterpret_cast<float*>(smem4);
  uint32_t* gd = reinterpret_cast<uint32_t*>(g);  // the down scan's distances, then f(d)
  if (threadIdx.x < kMaxBandRows) row_any[threadIdx.x] = row_flag[threadIdx.x] = 0;
  if (threadIdx.x < 2) cta_max[threadIdx.x] = 0;
  // the band's mask rows and kHalo rows either side into shared memory
  // (after the squared distances), all loads in flight at once
  Rows src{m, reinterpret_cast<const uint8_t*>(smem4) + R * W * 4, W, 0, 0};
  if (!kWide) {
    src.ys = max(y0 - kHalo, 0);
    src.ye = min(y0 + rows + kHalo, H);
    uint8_t* dst = const_cast<uint8_t*>(src.s);
    const uint8_t* from = m + static_cast<long long>(src.ys) * W;
    const int n = (src.ye - src.ys) * W;
    if (kVec) {
      for (int i = 4 * threadIdx.x; i < n; i += 4 * kBandThreads) cp_async4(dst + i, from + i);
      cp_async_wait_all();
    } else {
      for (int i = threadIdx.x; i < n; i += kBandThreads) dst[i] = from[i];
    }
  }
  __syncthreads();

  // columns: a thread 4 of them
  unsigned far = 0;
  for (int c0 = 4 * threadIdx.x; c0 < W; c0 += 4 * kBandThreads) {
    const int nc = min(4, W - c0);
    uint32_t run[4], below[4];
    scan_out<kVec>(src, H, y0, -1, c0, nc, run);  // distance from y0 to the zero above
#pragma unroll
    for (int i = 0; i < 4; ++i) run[i] = run[i] == kNone ? kNone : run[i] - 1;  // from y0 - 1
    for (int r = 0; r < rows; ++r) {
      const uint32_t w = load4<kVec>(src(y0 + r), c0, nc);
#pragma unroll
      for (int i = 0; i < 4; ++i) run[i] = zero_at(w, i) ? 0 : step(run[i]);
      uint32_t* dst = gd + r * W + c0;
      if (kVec) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(run[0], run[1], run[2], run[3]);
      } else {
        for (int i = 0; i < nc; ++i) dst[i] = run[i];
      }
    }
    scan_out<kVec>(src, H, y0 + rows - 1, 1, c0, nc, below);
#pragma unroll
    for (int i = 0; i < 4; ++i)  // from row y0 + rows
      below[i] = below[i] == kNone ? kNone : below[i] - 1;
    for (int r = rows - 1; r >= 0; --r) {
      uint32_t* src = gd + r * W + c0;
      uint32_t dn[4];
      if (kVec) {
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        dn[0] = v.x, dn[1] = v.y, dn[2] = v.z, dn[3] = v.w;
      } else {
        for (int i = 0; i < 4; ++i) dn[i] = i < nc ? src[i] : kNone;
      }
      float f[4];
      bool any = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        below[i] = dn[i] == 0 ? 0 : step(below[i]);
        const uint32_t d = min(dn[i], below[i]);
        f[i] = col_value(d, ftab);
        if (d != kNone && i < nc) {
          far = max(far, d);
          any = true;
        }
      }
      if (any) row_any[r] = 1;
      float* fd = g + r * W + c0;
      if (kVec) {
        *reinterpret_cast<float4*>(fd) = make_float4(f[0], f[1], f[2], f[3]);
      } else {
        for (int i = 0; i < nc; ++i) fd[i] = f[i];
      }
    }
  }
  __syncthreads();

  // rows: a thread a pixel, the outward search bounded by the best so far
  unsigned farthest = 0;  // the largest smallest minimising offset below 2^24
  {
    int r = threadIdx.x / W, x = threadIdx.x % W;
    const int dr = kBandThreads / W, dx = kBandThreads % W;
    while (r < rows) {
      const float* gr = g + r * W;
      float res = inf();
      if (row_any[r]) {
        const float v = gr[x];
        res = v;
        if (v != 0.0f) {
          float best = fminf(v, kExact);
          int at = 0;
          const int reach = max(x, W - 1 - x);
          for (int j = 1; j <= reach; ++j) {
            const float jj = static_cast<float>(j * j);  // exact: j <= 4096 here
            if (jj >= best) break;  // g >= 0: no x' this far or farther beats best
            if (j <= x) {
              const float c = __fadd_rn(gr[x - j], jj);
              if (c < best) best = c, at = j;
            }
            if (x + j < W) {
              const float c = __fadd_rn(gr[x + j], jj);
              if (c < best) best = c, at = j;
            }
          }
          if (best < kExact) {
            farthest = max(farthest, static_cast<unsigned>(at));
          } else {
            row_flag[r] = 1;  // a rounded chain may win: the row loop decides
          }
          res = best;
        }
        if (root && res != 0.0f) res = __fsqrt_rn(res);
      }
      o[static_cast<long long>(r) * W + x] = res;
      x += dx;
      r += dr;
      if (x >= W) x -= W, ++r;
    }
  }
  // one global atomic a CTA: every warp's on one address serialised at L2
  // and took most of the kernel's time
  warp_max_to(&cta_max[0], far);
  warp_max_to(&cta_max[1], farthest);
  __syncthreads();
  if (threadIdx.x < 2 && cta_max[threadIdx.x])
    atomicMax(&passes[threadIdx.x], cta_max[threadIdx.x]);
  if (!list) return;  // the shape cannot flag a row
  for (int r = 0; r < rows; ++r) {
    if (!row_flag[r]) continue;
    for (int x = threadIdx.x; x < W; x += kBandThreads)
      o[static_cast<long long>(r) * W + x] = g[r * W + x];  // the row loop's start
    if (threadIdx.x == 0)
      list[1 + atomicAdd(list, 1)] = static_cast<int>(blockIdx.y) * H + y0 + r;
  }
}

// tpuva's row loop on each listed row of out (its column values), to the
// row's fixed point: pass k sets D(x) = min(D(x), D(x -+ 1) + (2k - 1))
template <bool kShared>
__global__ void __launch_bounds__(kLoopThreads)
edt_round_rows_kernel(float* out, float* scratch, const int* __restrict__ list, int W, int root,
                      int* __restrict__ passes) {
  extern __shared__ float smem[];
  const int count = list[0];
  unsigned last = 0;  // the last pass that lowered a pixel
  for (int i = blockIdx.x; i < count; i += gridDim.x) {
    const long long row = static_cast<long long>(list[1 + i]) * W;
    float* a = kShared ? smem : out + row;
    float* b = kShared ? smem + W : scratch + row;
    if (kShared)
      for (int x = threadIdx.x; x < W; x += kLoopThreads) a[x] = out[row + x];
    __syncthreads();
    for (int k = 1;; ++k) {
      const float w = static_cast<float>(2 * k - 1);
      int changed = 0;
      for (int x = threadIdx.x; x < W; x += kLoopThreads) {
        const float v = a[x];
        const float l = x > 0 ? __fadd_rn(a[x - 1], w) : inf();
        const float r = x + 1 < W ? __fadd_rn(a[x + 1], w) : inf();
        const float nv = fminf(v, fminf(l, r));
        b[x] = nv;
        if (nv != v) changed = 1, last = k;
      }
      if (!__syncthreads_or(changed)) break;
      float* t = a;
      a = b;
      b = t;
    }
    for (int x = threadIdx.x; x < W; x += kLoopThreads) {
      const float v = a[x];
      out[row + x] = root ? __fsqrt_rn(v) : v;
    }
    __syncthreads();
  }
  warp_max_to(&passes[1], last);
}

int band_rows(int W) {
  if (W > kSharedRow) return 1;
  return max(1, min(kMaxBandRows, kBandBytes / (4 * W)));
}

template <bool kVec, bool kWide>
cudaError_t launch_band(const uint8_t* mask, float* out, float* scratch, const float* ftab,
                        int* list, int* passes, int L, int H, int W, int root, cudaStream_t s) {
  const int R = band_rows(W);
  const int smem = kWide ? 0 : R * W * 4 + (R + 2 * kHalo) * W;
  const auto k = edt_band_kernel<kVec, kWide>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k<<<dim3((H + R - 1) / R, L), kBandThreads, smem, s>>>(mask, out, scratch, ftab, list, passes,
                                                         H, W, R, root);
  return cudaGetLastError();
}

}  // namespace

// mask (L, H, W) uint8 (nonzero = foreground), L <= 65535 -> out (L, H, W)
// float32, the squared EDT or (root) the EDT. ftab float32[H], the f table
// (f_table(H) of ops/distance.py; null where H <= 4097); scratch float32
// (L, H, W) (null where W <= 25600); list int32[1 + L H], the flagged
// rows (null where (H - 1)^2 + (W - 1)^2 < 2^24: no row can be flagged);
// passes int32[2], zeroed by the caller, receives the largest finite
// column distance and the last pass that lowered a finite row output (the
// plain loop's pass counts less one). Returns cudaGetLastError() after the launches (0 =
// launched).
extern "C" int tpuva_edt(const uint8_t* mask, float* out, const float* ftab, float* scratch,
                         int* list, int* passes, int L, int H, int W, int root, void* stream) {
  const bool wide = W > kSharedRow;
  const bool large = static_cast<double>(H - 1) * (H - 1) + static_cast<double>(W - 1) * (W - 1) >=
                     static_cast<double>(kExact);
  if (L <= 0 || H <= 0 || W <= 0 || L > 65535 || static_cast<long long>(L) * H > 0x7ffffffeLL ||
      (H > kExactSide + 1 && !ftab) || (wide && !scratch) || (large && !list))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* lst = large ? list : nullptr;
  if (lst) {
    const cudaError_t err = cudaMemsetAsync(lst, 0, sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  cudaError_t err;
  if (wide)
    err = vec ? launch_band<true, true>(mask, out, scratch, ftab, lst, passes, L, H, W, root, s)
              : launch_band<false, true>(mask, out, scratch, ftab, lst, passes, L, H, W, root, s);
  else
    err = vec ? launch_band<true, false>(mask, out, scratch, ftab, lst, passes, L, H, W, root, s)
              : launch_band<false, false>(mask, out, scratch, ftab, lst, passes, L, H, W, root, s);
  if (err != cudaSuccess || !lst) return static_cast<int>(err);
  const int grid = static_cast<int>(min(static_cast<long long>(L) * H, 264LL));
  if (wide) {
    edt_round_rows_kernel<false><<<grid, kLoopThreads, 0, s>>>(out, scratch, lst, W, root, passes);
  } else {
    const int smem = 2 * W * 4;
    err = cudaFuncSetAttribute(edt_round_rows_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    edt_round_rows_kernel<true><<<grid, kLoopThreads, smem, s>>>(out, scratch, lst, W, root,
                                                                 passes);
  }
  return static_cast<int>(cudaGetLastError());
}
