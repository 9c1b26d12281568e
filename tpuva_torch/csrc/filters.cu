// The filter chain's pixel kernels for Hopper, sm_90a: BGR -> gray (KM),
// the affine warp (KW), the linear resize (KR) and the float Gaussian
// blur (KG).
//
// On the TPU none is a Pallas kernel: each is one XLA program a batch of
// tpuva's filter chain. KM replaces tpuva/filters.py:202
// FilterMonochrome.batch_transform (a float32 tensordot with the BGR
// weights), KW tpuva/ops/warp.py:59 warp_affine (cv2.warpAffine,
// INTER_LINEAR, under FilterRotate(angle=) and FilterWarpAffine), KR
// tpuva/filters.py:220 FilterResize.batch_transform (jax.image.resize
// "linear" without antialiasing), KG tpuva/ops/filters.py:148
// gaussian_blur (cv2.GaussianBlur on float32, under FilterBlur on a float
// batch). Their plain versions are torch ops in the port:
// tpuva_torch/ops/color.py::bgr_to_gray_plain, ops/warp.py::
// warp_affine_plain, ops/resize.py::resize_linear_plain and
// ops/filters.py::gaussian_blur_plain.
// Each kernel computes the same float32 operations in the same order,
// every product and sum rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn; the library is built with --fmad=false besides), uint8
// results rounded half to even (rintf) and clamped: bit-equal to the
// plain version.
//
// What bounds them on an H100: bytes. KM reads 3 B and writes 1 B a uint8
// pixel (0.634 ms for a 256-frame 1080p BGR batch at 3.35 TB/s), KW and
// KR read each input byte once and write each output byte once at best;
// their few float operations a pixel are far below the card's 67 T/s.
// - KM: a thread 16 uint8 pixels (4 float32 ones): three 16-byte loads of
//   the interleaved B, G, R bytes and one 16-byte store, neighbouring
//   threads on neighbouring 48-byte pieces. Where the input or output is
//   not 16-byte aligned (a ring slot at any offset), or for the pixels
//   past the last whole piece, a thread a pixel (ops/color.py::mono_plan
//   splits the two).
// - KW: a CTA a 64 x 32 output tile across all the images, a thread 4 of
//   its pixels. Each pixel's sample coordinates, clamped corners, border
//   flags and weights are computed once, in tpuva's source order, and
//   kept in registers; a tile whose corners all lie in the image skips the
//   border value's selects. The tile's source footprint (the bounding box of
//   its clamped corners, the same for every image) is staged per image
//   into shared memory by 16-byte cp.async loads, double-buffered across
//   the images; the corners are read from there and the results go
//   through a shared output tile to 16-byte stores of consecutive output
//   bytes. A tile whose footprint exceeds a buffer (strong down-scaling
//   or shear, an out_size far from the input) gathers its corners from
//   global memory instead, in the same kernel: a route chosen per tile
//   from the map. Rows whose byte length is not a multiple of 16 take
//   byte-wise copies.
// - KR: a CTA a 64 x 16 output tile across the images, a thread 4 pixels
//   of one column, their taps read once. Per image the tile's distinct
//   input rows (at most two an output row) are staged over the span of
//   columns its taps name, by 16-byte cp.async, double-buffered; the H
//   pass at the two columns that the W pass takes, rounded to float32 as
//   the plain version's intermediate is, then the W pass, from shared
//   memory; a shared output tile and 16-byte stores. An axis whose size
//   stays is skipped, as jax skips it. A tile whose rows x span exceed a
//   buffer (strong down-scaling in x) gathers from global memory: KW's
//   two routes. The taps and each block's rows come from tables that
//   ops/resize.py uploads once a shape.
// - KG: 4 B read and 4 B written a float (0.079 ms for 16 gray 1080p
//   frames, 0.238 BGR); its 3r + 1 operations an output and pass are far
//   below the card's rate. A CTA a th x tw tile of one image, all its
//   interleaved channels (a BGR frame's stride of 3 read as it lies): the
//   tile's rows and columns with their REFLECT_101 halo (repeated
//   reflection, so a radius past H or W and a one-pixel axis work) staged
//   into shared memory, the row pass of every staged row into shared
//   memory, its float32 results the column pass's inputs, as the plain
//   version's; ksize 3 and 5 with sigma <= 0 as tpuva's box cascade (2r
//   levels of adjacent-pair sums an axis, then one multiply by 2^-2(k-1):
//   the frames after FilterNormalize are not integers, so the cascade's
//   sums round and a weighted binomial sum would differ), the others with
//   cv2's symmetric-pair order. ops/filters.py::blur_float_plan picks the
//   tile from the radius and the channels; where even a 1 x 32 tile
//   exceeds shared memory (weighted taps past ksize ~110) each output
//   computes its rows' row pass from global memory, the same values.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f(const uint8_t* p) { return static_cast<float>(*p); }
__device__ __forceinline__ float load_f(const float* p) { return *p; }

__device__ __forceinline__ void store(uint8_t* p, float v) {
  *p = static_cast<uint8_t>(fminf(fmaxf(rintf(v), 0.0f), 255.0f));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// ((b w0) + (g w1)) + (r w2), each op rounded
__device__ __forceinline__ float gray_of(float b, float g, float r, float w0, float w1,
                                         float w2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(b, w0), __fmul_rn(g, w1)), __fmul_rn(r, w2));
}

__device__ __forceinline__ uint32_t gray_byte(float b, float g, float r, float w0, float w1,
                                              float w2) {
  return static_cast<uint32_t>(fminf(fmaxf(rintf(gray_of(b, g, r, w0, w1, w2)), 0.0f), 255.0f));
}

// KM, 16 uint8 pixels a piece: 48 input bytes as 12 words, 16 output bytes
__global__ void __launch_bounds__(kThreads)
bgr2gray_u8_vec(const uint4* __restrict__ x, uint4* __restrict__ out, long long pieces,
                float w0, float w1, float w2) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < pieces;
       i += stride) {
    const uint4 a = x[3 * i], b = x[3 * i + 1], c = x[3 * i + 2];
    const uint32_t w[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
    uint32_t o[4] = {0, 0, 0, 0};
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      float ch[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int byte = 3 * p + k;
        ch[k] = static_cast<float>((w[byte >> 2] >> (8 * (byte & 3))) & 0xffu);
      }
      o[p >> 2] |= gray_byte(ch[0], ch[1], ch[2], w0, w1, w2) << (8 * (p & 3));
    }
    out[i] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// KM, 4 float32 pixels a piece: 12 floats in, 4 out
__global__ void __launch_bounds__(kThreads)
bgr2gray_f32_vec(const float4* __restrict__ x, float4* __restrict__ out, long long pieces,
                 float w0, float w1, float w2) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < pieces;
       i += stride) {
    const float4 a = x[3 * i], b = x[3 * i + 1], c = x[3 * i + 2];
    out[i] = make_float4(gray_of(a.x, a.y, a.z, w0, w1, w2), gray_of(a.w, b.x, b.y, w0, w1, w2),
                         gray_of(b.z, b.w, c.x, w0, w1, w2), gray_of(c.y, c.z, c.w, w0, w1, w2));
  }
}

// KM, a thread a pixel over [start, P): the tail, or every pixel of an
// unaligned batch
template <typename T>
__global__ void __launch_bounds__(kThreads)
bgr2gray_px(const T* __restrict__ x, T* __restrict__ out, long long start, long long P,
            float w0, float w1, float w2) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = start + blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
       i < P; i += stride) {
    const T* p = x + 3 * i;
    store(out + i, gray_of(load_f(p), load_f(p + 1), load_f(p + 2), w0, w1, w2));
  }
}

// KW: a 64 x 32 output tile, 4 pixels a thread, two CTAs an SM
constexpr int kWarpTX = 64;
constexpr int kWarpTY = 32;
constexpr int kWarpThreads = 512;
constexpr int kWarpPx = kWarpTX * kWarpTY / kWarpThreads;
constexpr int kFootBytes = 16384;  // one image's footprint; two buffers

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a uint8 or float32 sample as float32 (a byte exactly, without the
// quarter-rate conversion: 2^23 + b less 2^23)
__device__ __forceinline__ float sample(const uint8_t* p) {
  return __fsub_rn(__uint_as_float(0x4b000000u | *p), 8388608.0f);
}
__device__ __forceinline__ float sample(const float* p) { return *p; }

// the stored value: uint8 rounded half to even and clamped (clamped first,
// then 2^23 added: the same byte as rintf then the clamp), or float32
__device__ __forceinline__ void put(uint8_t* p, float v) {
  *p = static_cast<uint8_t>(__float_as_uint(__fadd_rn(fminf(fmaxf(v, 0.0f), 255.0f), 8388608.0f)));
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// a pixel's flags: valid, xb > xa, yb > ya, then the four corners inside
// the image (00, 01, 10, 11)
enum : uint32_t { kValid = 1, kDx = 2, kDy = 4, kOk00 = 8, kOk01 = 16, kOk10 = 32, kOk11 = 64 };

// the lerps of one channel from its four corners, tpuva's order
template <bool kConstant>
__device__ __forceinline__ float lerp4(float g00, float g01, float g10, float g11, uint32_t bits,
                                       float fx, float fy, float bv) {
  if (kConstant) {
    if (!(bits & kOk00)) g00 = bv;
    if (!(bits & kOk01)) g01 = bv;
    if (!(bits & kOk10)) g10 = bv;
    if (!(bits & kOk11)) g11 = bv;
  }
  const float top = __fadd_rn(g00, __fmul_rn(fx, __fsub_rn(g01, g00)));
  const float bot = __fadd_rn(g10, __fmul_rn(fx, __fsub_rn(g11, g10)));
  return __fadd_rn(top, __fmul_rn(fy, __fsub_rn(bot, top)));
}

// KW: images (L, H, W, C) -> (L, ho, wo, C); (ia ib ic; id ie if_) the
// inverse map dst -> src in float32. vec_in: x and its rows 16-byte
// aligned; vec_out: out and its rows likewise. routes (or null) counts
// the tiles of each route: [shared footprint, direct gather].
template <typename T, int C, bool kConstant>
__global__ void __launch_bounds__(kWarpThreads, 2)
warp_affine_kernel(const T* __restrict__ x, T* __restrict__ out, int L, int H, int W, int ho,
                   int wo, float ia, float ib, float ic, float id, float ie, float if_, float bv,
                   int vec_in, int vec_out, int* __restrict__ routes) {
  constexpr int kPx = C * static_cast<int>(sizeof(T));  // bytes a pixel
  extern __shared__ uint4 kw_smem[];
  uint8_t* foot = reinterpret_cast<uint8_t*>(kw_smem);
  T* otile = reinterpret_cast<T*>(foot + 2 * kFootBytes);
  __shared__ int box[4];  // the footprint: min ya, max yb, min xa, max xb
  if (threadIdx.x == 0) box[0] = box[2] = 0x7fffffff, box[1] = box[3] = -1;
  const int tx0 = blockIdx.x * kWarpTX, ty0 = blockIdx.y * kWarpTY;

  int xa[kWarpPx], ya[kWarpPx];
  uint32_t bits[kWarpPx];
  float fx[kWarpPx], fy[kWarpPx];
  int lo_y = 0x7fffffff, hi_y = -1, lo_x = 0x7fffffff, hi_x = -1;
#pragma unroll
  for (int k = 0; k < kWarpPx; ++k) {
    const int p = threadIdx.x + k * kWarpThreads;
    const int xo = tx0 + p % kWarpTX, yo = ty0 + p / kWarpTX;
    bits[k] = 0;
    xa[k] = ya[k] = 0;
    fx[k] = fy[k] = 0.0f;
    if (xo < wo && yo < ho) {
      const float fxo = static_cast<float>(xo), fyo = static_cast<float>(yo);
      const float sx = __fadd_rn(__fadd_rn(__fmul_rn(ia, fxo), __fmul_rn(ib, fyo)), ic);
      const float sy = __fadd_rn(__fadd_rn(__fmul_rn(id, fxo), __fmul_rn(ie, fyo)), if_);
      const float x0f = floorf(sx), y0f = floorf(sy);
      fx[k] = __fsub_rn(sx, x0f);
      fy[k] = __fsub_rn(sy, y0f);
      // The floors clamped to [-2, W + 1] and [-2, H + 1] before the
      // integer conversion: every corner outside the image stays outside
      // (so the same border mask) and clamps to the same edge pixel as the
      // plain version's int64 floor, and no conversion overflows.
      const int x0 = static_cast<int>(fminf(fmaxf(x0f, -2.0f), static_cast<float>(W) + 1.0f));
      const int y0 = static_cast<int>(fminf(fmaxf(y0f, -2.0f), static_cast<float>(H) + 1.0f));
      const int a = min(max(x0, 0), W - 1), b = min(max(x0 + 1, 0), W - 1);
      const int c = min(max(y0, 0), H - 1), d = min(max(y0 + 1, 0), H - 1);
      const bool okx0 = x0 >= 0 && x0 < W, okx1 = x0 + 1 >= 0 && x0 + 1 < W;
      const bool oky0 = y0 >= 0 && y0 < H, oky1 = y0 + 1 >= 0 && y0 + 1 < H;
      xa[k] = a;
      ya[k] = c;
      bits[k] = kValid | (b > a ? kDx : 0u) | (d > c ? kDy : 0u) | (okx0 && oky0 ? kOk00 : 0u) |
                (okx1 && oky0 ? kOk01 : 0u) | (okx0 && oky1 ? kOk10 : 0u) |
                (okx1 && oky1 ? kOk11 : 0u);
      lo_y = min(lo_y, c), hi_y = max(hi_y, d), lo_x = min(lo_x, a), hi_x = max(hi_x, b);
    }
  }
  bool inside = true;  // every corner of this thread's pixels lies in the image
#pragma unroll
  for (int k = 0; k < kWarpPx; ++k)
    inside &= !(bits[k] & kValid) || (bits[k] & (kOk00 | kOk01 | kOk10 | kOk11)) ==
                                         (kOk00 | kOk01 | kOk10 | kOk11);
  lo_y = __reduce_min_sync(0xffffffffu, lo_y);
  hi_y = __reduce_max_sync(0xffffffffu, hi_y);
  lo_x = __reduce_min_sync(0xffffffffu, lo_x);
  hi_x = __reduce_max_sync(0xffffffffu, hi_x);
  // a tile whose corners all lie in the image needs no border value (the
  // barrier also orders thread 0's box before the atomics below)
  const bool all_inside = __syncthreads_and(inside);
  const bool select = kConstant && !all_inside;
  if ((threadIdx.x & 31) == 0 && hi_y >= 0) {
    atomicMin(&box[0], lo_y);
    atomicMax(&box[1], hi_y);
    atomicMin(&box[2], lo_x);
    atomicMax(&box[3], hi_x);
  }
  __syncthreads();
  const int fy0 = box[0], fh = box[1] - box[0] + 1;
  // the footprint's bytes of a row: [a0, a0 + pitch), 16-byte aligned on vec_in
  int a0 = box[2] * kPx, a1 = (box[3] + 1) * kPx;
  if (vec_in) a0 &= ~15, a1 = (a1 + 15) & ~15;
  const int pitch = a1 - a0;
  const bool fits = static_cast<long long>(fh) * pitch <= kFootBytes;
  if (routes && threadIdx.x == 0) atomicAdd(&routes[fits ? 0 : 1], 1);

  const long long row_bytes = static_cast<long long>(W) * kPx;
  const long long plane_bytes = row_bytes * H;
  const long long oplane = static_cast<long long>(ho) * wo * C;
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(x);
  const int nx = min(kWarpTX, wo - tx0), ny = min(kWarpTY, ho - ty0);

  // image n's footprint into buffer buf (cp.async groups on vec_in)
  auto stage = [&](int n, int buf) {
    const uint8_t* src = xb + n * plane_bytes + fy0 * row_bytes + a0;
    uint8_t* dst = foot + buf * kFootBytes;
    if (vec_in) {
      const int q = pitch / 16;
      for (int i = threadIdx.x; i < fh * q; i += kWarpThreads) {
        const int r = i / q, c = i - r * q;
        cp_async16(dst + r * pitch + 16 * c, src + r * row_bytes + 16 * c);
      }
      cp_async_commit();
    } else {
      for (int r = 0; r < fh; ++r)
        for (int c = threadIdx.x; c < pitch; c += kWarpThreads)
          dst[r * pitch + c] = src[r * row_bytes + c];
    }
  };
  // the output tile of image n to global memory
  auto flush = [&](int n) {
    uint8_t* ob = reinterpret_cast<uint8_t*>(out + n * oplane);
    const uint8_t* tb = reinterpret_cast<const uint8_t*>(otile);
    const int rb = nx * kPx;  // a multiple of 16 on vec_out
    if (vec_out) {
      const int q = rb / 16;
      for (int i = threadIdx.x; i < ny * q; i += kWarpThreads) {
        const int r = i / q, c = i - r * q;
        *reinterpret_cast<uint4*>(ob + ((static_cast<long long>(ty0 + r) * wo + tx0) * kPx) +
                                  16 * c) =
            *reinterpret_cast<const uint4*>(tb + r * (kWarpTX * kPx) + 16 * c);
      }
    } else {
      for (int r = 0; r < ny; ++r)
        for (int c = threadIdx.x; c < rb; c += kWarpThreads)
          ob[(static_cast<long long>(ty0 + r) * wo + tx0) * kPx + c] = tb[r * (kWarpTX * kPx) + c];
    }
  };

  if (fits) {
    stage(0, 0);
    for (int n = 0; n < L; ++n) {
      if (n + 1 < L) {
        stage(n + 1, (n + 1) & 1);
        if (vec_in) cp_async_wait<1>();
      } else if (vec_in) {
        cp_async_wait<0>();
      }
      __syncthreads();
      const uint8_t* fb = foot + (n & 1) * kFootBytes;
      auto frame = [&](auto sel) {
#pragma unroll
        for (int k = 0; k < kWarpPx; ++k) {
          if (!(bits[k] & kValid)) continue;
          const int p = threadIdx.x + k * kWarpThreads;
          const uint8_t* q00 = fb + (ya[k] - fy0) * pitch + xa[k] * kPx - a0;
          const int dx = bits[k] & kDx ? kPx : 0, dy = bits[k] & kDy ? pitch : 0;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float g00 = sample(reinterpret_cast<const T*>(q00) + c);
            const float g01 = sample(reinterpret_cast<const T*>(q00 + dx) + c);
            const float g10 = sample(reinterpret_cast<const T*>(q00 + dy) + c);
            const float g11 = sample(reinterpret_cast<const T*>(q00 + dx + dy) + c);
            put(otile + p * C + c,
                lerp4<decltype(sel)::value>(g00, g01, g10, g11, bits[k], fx[k], fy[k], bv));
          }
        }
      };
      if (select) frame(std::true_type{});
      else frame(std::false_type{});
      __syncthreads();
      flush(n);
    }
  } else {
    for (int n = 0; n < L; ++n) {
      const T* img = x + n * (plane_bytes / static_cast<long long>(sizeof(T)));
#pragma unroll
      for (int k = 0; k < kWarpPx; ++k) {
        if (!(bits[k] & kValid)) continue;
        const int p = threadIdx.x + k * kWarpThreads;
        const long long i00 = (static_cast<long long>(ya[k]) * W + xa[k]) * C;
        const long long dx = bits[k] & kDx ? C : 0;
        const long long dy = bits[k] & kDy ? static_cast<long long>(W) * C : 0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const T* t00 = img + i00 + c;
          const float g00 = sample(t00), g01 = sample(t00 + dx);
          const float g10 = sample(t00 + dy), g11 = sample(t00 + dx + dy);
          put(otile + p * C + c,
              select ? lerp4<true>(g00, g01, g10, g11, bits[k], fx[k], fy[k], bv)
                     : lerp4<false>(g00, g01, g10, g11, bits[k], fx[k], fy[k], bv));
        }
      }
      __syncthreads();
      flush(n);
      __syncthreads();
    }
  }
}

// KR: a CTA a 64 x 16 output tile across the images (blockIdx.y splits
// them), a thread 4 pixels of one column. The tile's taps come from the
// (4, n) tables once a CTA; its blocks' records (ops/resize.py::
// tile_blocks) name the distinct input rows its outputs take (at most two
// an output row) and, through the first and last column tap, the span of
// input columns. Per image the rows' spans are staged into shared memory
// by 16-byte cp.async, double-buffered across the images; the H pass runs
// there at the two columns of each output's W pass, rounded to float32 as
// the plain version's intermediate, then the W pass; the results go
// through a shared output tile to 16-byte stores. A tile whose rows x span
// exceed the buffer (ops/resize.py::resize_plan sizes it: the largest
// footprint up to 48 KB) gathers its inputs from global memory in the same
// kernel; routes counts the tiles of each route.
constexpr int kResizeTX = 64;
constexpr int kResizeTY = 16;
constexpr int kResizeThreads = 256;
constexpr int kResizePx = kResizeTX * kResizeTY / kResizeThreads;  // rows a thread, one column
constexpr int kResizeRows = 2 * kResizeTY;  // distinct input rows a tile at most
constexpr int kResizeBufMax = 49152;  // bytes of one staging buffer at most
static_assert(kResizeThreads % kResizeTX == 0, "a thread keeps one output column");

// images (N, H, W, C) -> (N, h, w, C). taps_h, taps_w: (4, h) and (4, w)
// tables (lo, hi, w_lo bits, w_hi bits; the identity where an axis keeps
// its size, which is then skipped as jax skips it); blocks_h, blocks_w: a
// slot an output (its lo's and hi's places in its block's record, hi's <<
// 16; read for rows only), then each block's record (count, the distinct
// taps in order). buf: bytes of one staging buffer; vec_in, vec_out as
// KW's.
template <typename T, int C>
__global__ void __launch_bounds__(kResizeThreads, 4)
resize_linear_kernel(const T* __restrict__ x, T* __restrict__ out, int N, int H, int W, int h,
                     int w, const int* __restrict__ taps_h, const int* __restrict__ taps_w,
                     const int* __restrict__ blocks_h, const int* __restrict__ blocks_w, int buf,
                     int vec_in, int vec_out, int* __restrict__ routes) {
  constexpr int kPx = C * static_cast<int>(sizeof(T));  // bytes a pixel
  extern __shared__ uint4 kr_smem[];
  uint8_t* foot = reinterpret_cast<uint8_t*>(kr_smem);
  T* otile = reinterpret_cast<T*>(foot + 2 * buf);
  __shared__ int rows[kResizeRows];
  const int nbx = (w + kResizeTX - 1) / kResizeTX;
  const int bx = blockIdx.x % nbx, by = blockIdx.x / nbx;
  const int tx0 = bx * kResizeTX, ty0 = by * kResizeTY;
  const int nx = min(kResizeTX, w - tx0), ny = min(kResizeTY, h - ty0);
  const bool rh = h != H, rw = w != W;
  const int* rec_h = blocks_h + h + by * (1 + kResizeRows);
  const int* rec_w = blocks_w + w + bx * (1 + 2 * kResizeTX);
  const int nr = rec_h[0];
  if (threadIdx.x < nr) rows[threadIdx.x] = rec_h[1 + threadIdx.x];
  // the span's bytes of a row: [a0, a0 + pitch), 16-byte aligned on vec_in
  int a0 = rec_w[1] * kPx, a1 = (rec_w[rec_w[0]] + 1) * kPx;
  if (vec_in) a0 &= ~15, a1 = (a1 + 15) & ~15;
  const int pitch = a1 - a0;
  const bool fits = static_cast<long long>(nr) * pitch <= buf;
  if (routes && blockIdx.y == 0 && threadIdx.x == 0) atomicAdd(&routes[fits ? 0 : 1], 1);

  // this thread's column (its two taps) and rows ty + 4 k (theirs)
  const int px = threadIdx.x % kResizeTX, py = threadIdx.x / kResizeTX;
  int clo = 0, chi = 0;
  float wxlo = 1.0f, wxhi = 0.0f;
  if (px < nx) {
    const int o = tx0 + px;
    clo = taps_w[o], chi = taps_w[w + o];
    wxlo = __int_as_float(taps_w[2 * w + o]), wxhi = __int_as_float(taps_w[3 * w + o]);
  }
  int rlo[kResizePx], rhi[kResizePx], slo[kResizePx], shi[kResizePx];
  float wylo[kResizePx], wyhi[kResizePx];
#pragma unroll
  for (int k = 0; k < kResizePx; ++k) {
    const int y = py + k * (kResizeThreads / kResizeTX);
    rlo[k] = rhi[k] = slo[k] = shi[k] = 0;
    wylo[k] = 1.0f, wyhi[k] = 0.0f;
    if (y < ny) {
      const int o = ty0 + y, slot = blocks_h[o];
      rlo[k] = taps_h[o], rhi[k] = taps_h[h + o];
      wylo[k] = __int_as_float(taps_h[2 * h + o]), wyhi[k] = __int_as_float(taps_h[3 * h + o]);
      slo[k] = slot & 0xffff, shi[k] = slot >> 16;
    }
  }
  // one channel of pixel k: lo and hi point at its column tap clo in its
  // two rows, d elements on to chi; the H pass at both columns (w_lo x[lo]
  // + w_hi x[hi]), then the W pass
  auto lerp = [&](const T* lo, const T* hi, int d, int k) {
    float t0 = sample(lo);
    if (rh) t0 = __fadd_rn(__fmul_rn(t0, wylo[k]), __fmul_rn(sample(hi), wyhi[k]));
    if (rw) {
      float t1 = sample(lo + d);
      if (rh) t1 = __fadd_rn(__fmul_rn(t1, wylo[k]), __fmul_rn(sample(hi + d), wyhi[k]));
      t0 = __fadd_rn(__fmul_rn(t0, wxlo), __fmul_rn(t1, wxhi));
    }
    return t0;
  };
  __syncthreads();  // rows[]

  const long long row_bytes = static_cast<long long>(W) * kPx;
  const long long plane_bytes = row_bytes * H;
  const long long oplane = static_cast<long long>(h) * w * C;
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(x);

  // image n's rows x span into buffer b (cp.async groups on vec_in)
  auto stage = [&](int n, int b) {
    const uint8_t* src = xb + n * plane_bytes + a0;
    uint8_t* dst = foot + b * buf;
    if (vec_in) {
      const int q = pitch / 16;
      for (int i = threadIdx.x; i < nr * q; i += kResizeThreads) {
        const int r = i / q, c = i - r * q;
        cp_async16(dst + r * pitch + 16 * c, src + rows[r] * row_bytes + 16 * c);
      }
      cp_async_commit();
    } else {
      for (int r = 0; r < nr; ++r)
        for (int c = threadIdx.x; c < pitch; c += kResizeThreads)
          dst[r * pitch + c] = src[rows[r] * row_bytes + c];
    }
  };
  // the output tile of image n to global memory
  auto flush = [&](int n) {
    uint8_t* ob = reinterpret_cast<uint8_t*>(out + n * oplane);
    const uint8_t* tb = reinterpret_cast<const uint8_t*>(otile);
    const int rb = nx * kPx;  // a multiple of 16 on vec_out
    if (vec_out) {
      const int q = rb / 16;
      for (int i = threadIdx.x; i < ny * q; i += kResizeThreads) {
        const int r = i / q, c = i - r * q;
        *reinterpret_cast<uint4*>(ob + ((static_cast<long long>(ty0 + r) * w + tx0) * kPx) +
                                  16 * c) =
            *reinterpret_cast<const uint4*>(tb + r * (kResizeTX * kPx) + 16 * c);
      }
    } else {
      for (int r = 0; r < ny; ++r)
        for (int c = threadIdx.x; c < rb; c += kResizeThreads)
          ob[(static_cast<long long>(ty0 + r) * w + tx0) * kPx + c] =
              tb[r * (kResizeTX * kPx) + c];
    }
  };
  const bool col_ok = px < nx;
  const int d = (chi - clo) * C;

  if (fits) {
    const int dlo = clo * kPx - a0;  // column clo's byte in a staged row
    int n = blockIdx.y, b = 0;
    if (n < N) stage(n, 0);
    for (; n < N; n += gridDim.y, b ^= 1) {
      if (n + static_cast<int>(gridDim.y) < N) {
        stage(n + gridDim.y, b ^ 1);
        if (vec_in) cp_async_wait<1>();
      } else if (vec_in) {
        cp_async_wait<0>();
      }
      __syncthreads();
      const uint8_t* fb = foot + b * buf;
#pragma unroll
      for (int k = 0; k < kResizePx; ++k) {
        const int y = py + k * (kResizeThreads / kResizeTX);
        if (!col_ok || y >= ny) continue;
        const T* lo = reinterpret_cast<const T*>(fb + slo[k] * pitch + dlo);
        const T* hi = reinterpret_cast<const T*>(fb + shi[k] * pitch + dlo);
#pragma unroll
        for (int c = 0; c < C; ++c)
          put(otile + (y * kResizeTX + px) * C + c, lerp(lo + c, hi + c, d, k));
      }
      __syncthreads();
      flush(n);
    }
  } else {
    for (int n = blockIdx.y; n < N; n += gridDim.y) {
      const T* img = x + n * (plane_bytes / static_cast<long long>(sizeof(T)));
#pragma unroll
      for (int k = 0; k < kResizePx; ++k) {
        const int y = py + k * (kResizeThreads / kResizeTX);
        if (!col_ok || y >= ny) continue;
        const T* lo = img + (static_cast<long long>(rlo[k]) * W + clo) * C;
        const T* hi = img + (static_cast<long long>(rhi[k]) * W + clo) * C;
#pragma unroll
        for (int c = 0; c < C; ++c)
          put(otile + (y * kResizeTX + px) * C + c, lerp(lo + c, hi + c, d, k));
      }
      __syncthreads();
      flush(n);
      __syncthreads();
    }
  }
}

template <typename T, int C>
cudaError_t launch_warp(const void* x, void* out, int L, int H, int W, int ho, int wo,
                        int constant, float ia, float ib, float ic, float id, float ie, float if_,
                        float bv, int* routes, cudaStream_t s) {
  const dim3 grid((wo + kWarpTX - 1) / kWarpTX, (ho + kWarpTY - 1) / kWarpTY);
  const int smem = 2 * kFootBytes + kWarpTX * kWarpTY * C * static_cast<int>(sizeof(T));
  const long long px = C * static_cast<long long>(sizeof(T));
  const int vec_in = (W * px) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_out = (wo * px) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  const auto k = constant ? warp_affine_kernel<T, C, true> : warp_affine_kernel<T, C, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k<<<grid, kWarpThreads, smem, s>>>(xi, o, L, H, W, ho, wo, ia, ib, ic, id, ie, if_, bv, vec_in,
                                     vec_out, routes);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t launch_resize(const void* x, void* out, int N, int H, int W, int h, int w,
                          const int* taps_h, const int* taps_w, const int* blocks_h,
                          const int* blocks_w, int buf, int vec_in, int vec_out, int grid_z,
                          int* routes, cudaStream_t s) {
  const long long tiles = static_cast<long long>((w + kResizeTX - 1) / kResizeTX) *
                          ((h + kResizeTY - 1) / kResizeTY);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = 2 * buf + kResizeTX * kResizeTY * C * static_cast<int>(sizeof(T));
  const auto k = resize_linear_kernel<T, C>;
  const cudaError_t err =
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k<<<dim3(static_cast<unsigned>(tiles), grid_z), kResizeThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), N, H, W, h, w, taps_h, taps_w, blocks_h,
      blocks_w, buf, vec_in, vec_out, routes);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- KG
// REFLECT_101 source index of position i on an axis of n, repeated for
// any offset (ops/filters.py::reflect101_index)
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i >= n ? period - i : i;
}

// the binomial cascade of 2R + 1 values v (strided by step): 2R levels of
// adjacent-pair sums, each shrinking the row by one (tpuva's order)
template <int R>
__device__ __forceinline__ float cascade(const float* v, int step) {
  float y[2 * R + 1];
#pragma unroll
  for (int j = 0; j <= 2 * R; ++j) y[j] = v[j * step];
#pragma unroll
  for (int lvl = 0; lvl < 2 * R; ++lvl)
#pragma unroll
    for (int j = 0; j < 2 * R - lvl; ++j) y[j] = __fadd_rn(y[j], y[j + 1]);
  return y[0];
}

// the weighted taps around v[r * step]: k[r] centre, then
// + k[r - i] (left + right) for i = 1..r, every op rounded alone
__device__ __forceinline__ float weighted(const float* v, int step, const float* k, int r) {
  float acc = __fmul_rn(v[r * step], k[r]);
  for (int i = 1; i <= r; ++i)
    acc = __fadd_rn(acc, __fmul_rn(k[r - i], __fadd_rn(v[(r - i) * step], v[(r + i) * step])));
  return acc;
}

// KB 0: the weighted taps (k[0..r], k[r] the centre); KB 1 or 2: the
// binomial cascade of radius KB, then one multiply by scale
template <int C, int KB>
__device__ __forceinline__ float blur_taps(const float* v, int step, const float* k, int r) {
  if constexpr (KB == 0)
    return weighted(v, step, k, r);
  else
    return cascade<KB>(v, step);
}

// KG, staged: a CTA a th x tw tile of one image, all C channels; the
// tile's rows and columns with their halo (reflected) staged into shared
// memory I, the row pass of every staged row into R, then the column pass
// from R, each in the plain version's order; a grid-stride loop over the
// images in z
template <int C, int KB>
__global__ void __launch_bounds__(kThreads)
    blur_f32_staged(const float* __restrict__ x, float* __restrict__ out, int L, int H, int W,
                    const float* __restrict__ taps, int r, float scale, int th, int tw) {
  extern __shared__ float smem[];
  float* k = smem;                      // r + 1 taps
  float* I = k + r + 1;                 // (th + 2r) x (tw + 2r) C
  const int iw = (tw + 2 * r) * C;      // a staged row's floats
  float* R = I + (th + 2 * r) * iw;     // (th + 2r) x tw C
  const int rw = tw * C;
  const int y0 = blockIdx.y * th, x0 = blockIdx.x * tw;
  const int rows = th + 2 * r;
  if (KB == 0)
    for (int i = threadIdx.x; i <= r; i += blockDim.x) k[i] = taps[i];
  const int ow = min(tw, W - x0) * C;  // the tile's output floats a row
  const int oh = min(th, H - y0);
  // a tile whose halo lies inside the image reads it without reflection
  const bool inside = x0 >= r && x0 + tw + r <= W && y0 >= r && y0 + th + r <= H;
  for (int l = blockIdx.z; l < L; l += gridDim.z) {
    const float* img = x + static_cast<long long>(l) * H * W * C;
    for (int i = threadIdx.x; i < rows * iw; i += blockDim.x) {
      const int yy = i / iw, e = i - yy * iw;
      if (inside) {
        I[i] = img[(static_cast<long long>(y0 - r + yy) * W + x0 - r) * C + e];
      } else {
        const int col = reflect101(x0 - r + e / C, W);
        I[i] = img[(static_cast<long long>(reflect101(y0 - r + yy, H)) * W + col) * C + e % C];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * rw; i += blockDim.x) {
      const int yy = i / rw, e = i - yy * rw;
      R[i] = blur_taps<C, KB>(I + yy * iw + e, C, k, r);
    }
    __syncthreads();
    float* dst = out + static_cast<long long>(l) * H * W * C;
    for (int i = threadIdx.x; i < oh * rw; i += blockDim.x) {
      const int y = i / rw, e = i - y * rw;
      if (e >= ow) continue;
      float v = blur_taps<C, KB>(R + y * rw + e, rw, k, r);
      if (KB != 0) v = __fmul_rn(v, scale);
      dst[(static_cast<long long>(y0 + y) * W + x0) * C + e] = v;
    }
    __syncthreads();  // I and R are refilled for the next image
  }
}

// the row pass at source row y (already reflected), output column xo,
// channel c, straight from global memory (weighted taps)
template <int C>
__device__ __forceinline__ float row_direct(const float* img, int y, int xo, int c, int W,
                                            const float* k, int r) {
  const float* row = img + static_cast<long long>(y) * W * C + c;
  float acc = __fmul_rn(row[static_cast<long long>(xo) * C], k[r]);
  for (int i = 1; i <= r; ++i)
    acc = __fadd_rn(acc, __fmul_rn(k[r - i], __fadd_rn(row[reflect101(xo - i, W) * C],
                                                        row[reflect101(xo + i, W) * C])));
  return acc;
}

// KG, direct: where no tile fits shared memory (the weighted taps only,
// ksize past ~110): each output's column pass over the row pass of its
// 2r + 1 rows, each computed from global memory, the same values in the
// same order as the staged route
template <int C>
__global__ void __launch_bounds__(kThreads)
    blur_f32_direct(const float* __restrict__ x, float* __restrict__ out, long long total, int H,
                    int W, const float* __restrict__ k, int r) {
  for (long long o = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; o < total;
       o += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(o % C);
    const long long px = o / C;
    const int xo = static_cast<int>(px % W);
    const long long ly = px / W;
    const int y = static_cast<int>(ly % H);
    const float* img = x + (ly / H) * H * W * C;
    float acc = __fmul_rn(row_direct<C>(img, y, xo, c, W, k, r), k[r]);
    for (int i = 1; i <= r; ++i)
      acc = __fadd_rn(acc, __fmul_rn(k[r - i],
                                     __fadd_rn(row_direct<C>(img, reflect101(y - i, H), xo, c, W, k, r),
                                               row_direct<C>(img, reflect101(y + i, H), xo, c, W, k, r))));
    out[o] = acc;
  }
}

template <int C>
cudaError_t launch_blur_f32(const float* x, float* out, int L, int H, int W, const float* taps,
                            int r, int binomial, float scale, int th, int tw, int smem,
                            cudaStream_t s) {
  if (smem == 0) {
    const long long total = static_cast<long long>(L) * H * W * C;
    const long long blocks = (total + kThreads - 1) / kThreads;
    blur_f32_direct<C><<<static_cast<int>(blocks < 65536 ? blocks : 65536), kThreads, 0, s>>>(
        x, out, total, H, W, taps, r);
    return cudaGetLastError();
  }
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, L < 65535 ? L : 65535);
  auto kernel = !binomial ? blur_f32_staged<C, 0> : r == 1 ? blur_f32_staged<C, 1>
                                                           : blur_f32_staged<C, 2>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(x, out, L, H, W, taps, r, scale, th, tw);
  return cudaGetLastError();
}

}  // namespace

// KM: x (P, 3) interleaved B, G, R -> out (P), uint8 (is_float 0) or
// float32 (1). pieces whole 16-byte pieces (16 uint8 or 4 float32 pixels
// each; 0 where x or out is not 16-byte aligned) on vec_blocks CTAs, then
// pixels [start, P) one a thread on px_blocks CTAs (ops/color.py::
// mono_plan). Returns cudaGetLastError() after the launches.
extern "C" int tpuva_bgr2gray(const void* x, void* out, long long P, long long pieces,
                              long long start, int is_float, float w0, float w1, float w2,
                              int vec_blocks, int px_blocks, void* stream) {
  if (P <= 0 || pieces < 0 || start < 0 || start > P || (pieces > 0 && vec_blocks <= 0) ||
      (start < P && px_blocks <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float) {
    if (pieces > 0)
      bgr2gray_f32_vec<<<vec_blocks, kThreads, 0, s>>>(
          static_cast<const float4*>(x), static_cast<float4*>(out), pieces, w0, w1, w2);
    if (start < P)
      bgr2gray_px<float><<<px_blocks, kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<float*>(out), start, P, w0, w1, w2);
  } else {
    if (pieces > 0)
      bgr2gray_u8_vec<<<vec_blocks, kThreads, 0, s>>>(
          static_cast<const uint4*>(x), static_cast<uint4*>(out), pieces, w0, w1, w2);
    if (start < P)
      bgr2gray_px<uint8_t><<<px_blocks, kThreads, 0, s>>>(
          static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), start, P, w0, w1, w2);
  }
  return static_cast<int>(cudaGetLastError());
}

// KW: x (L, H, W, C) -> out (L, ho, wo, C), C 1 or 3, uint8 or float32;
// (ia ib ic; id ie if_) the float32 inverse map, constant (1, with
// border value bv) or replicate (0) border; routes int32[2] (or null)
// receives the tiles that staged their footprint and those that gathered
// directly. Returns cudaGetLastError().
extern "C" int tpuva_warp_affine(const void* x, void* out, int L, int H, int W, int C, int ho,
                                 int wo, int is_float, int constant, float ia, float ib,
                                 float ic, float id, float ie, float if_, float bv, int* routes,
                                 void* stream) {
  if (L <= 0 || H <= 0 || W <= 0 || ho <= 0 || wo <= 0 || (C != 1 && C != 3) ||
      H >= (1 << 24) || W >= (1 << 24) || (ho + kWarpTY - 1) / kWarpTY > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_float)
    err = C == 3 ? launch_warp<float, 3>(x, out, L, H, W, ho, wo, constant, ia, ib, ic, id, ie,
                                         if_, bv, routes, s)
                 : launch_warp<float, 1>(x, out, L, H, W, ho, wo, constant, ia, ib, ic, id, ie,
                                         if_, bv, routes, s);
  else
    err = C == 3 ? launch_warp<uint8_t, 3>(x, out, L, H, W, ho, wo, constant, ia, ib, ic, id, ie,
                                           if_, bv, routes, s)
                 : launch_warp<uint8_t, 1>(x, out, L, H, W, ho, wo, constant, ia, ib, ic, id, ie,
                                           if_, bv, routes, s);
  return static_cast<int>(err);
}

// KR: x (N, H, W, C) -> out (N, h, w, C), C 1 or 3, uint8 or float32;
// taps_h (4, h) / taps_w (4, w) and blocks_h / blocks_w int32 tables on
// the card (ops/resize.py::tap_table, tile_blocks); buf bytes of a staging
// buffer (a multiple of 16, at most 48 KB), vec_in / vec_out whether x /
// out and their rows are 16-byte aligned, grid_z CTAs over the images of
// a tile (ops/resize.py::resize_plan); routes int32[2] (or null) receives
// the tiles that staged their rows and those that gathered. Returns
// cudaGetLastError().
extern "C" int tpuva_resize_linear(const void* x, void* out, int N, int H, int W, int C, int h,
                                   int w, const int* taps_h, const int* taps_w,
                                   const int* blocks_h, const int* blocks_w, int is_float,
                                   int buf, int vec_in, int vec_out, int grid_z, int* routes,
                                   void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || h <= 0 || w <= 0 || (C != 1 && C != 3) || !taps_h ||
      !taps_w || !blocks_h || !blocks_w || buf < 0 || buf % 16 || buf > kResizeBufMax ||
      grid_z <= 0 || grid_z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_float)
    err = C == 3 ? launch_resize<float, 3>(x, out, N, H, W, h, w, taps_h, taps_w, blocks_h,
                                           blocks_w, buf, vec_in, vec_out, grid_z, routes, s)
                 : launch_resize<float, 1>(x, out, N, H, W, h, w, taps_h, taps_w, blocks_h,
                                           blocks_w, buf, vec_in, vec_out, grid_z, routes, s);
  else
    err = C == 3 ? launch_resize<uint8_t, 3>(x, out, N, H, W, h, w, taps_h, taps_w, blocks_h,
                                             blocks_w, buf, vec_in, vec_out, grid_z, routes, s)
                 : launch_resize<uint8_t, 1>(x, out, N, H, W, h, w, taps_h, taps_w, blocks_h,
                                             blocks_w, buf, vec_in, vec_out, grid_z, routes, s);
  return static_cast<int>(err);
}

// KG: x (L, H, W, C) float32, C 1 or 3 interleaved -> out, the same
// shape: cv2.GaussianBlur's row pass, then its column pass, REFLECT_101.
// binomial 1 (ksize 3 or 5, sigma <= 0): the box cascade of radius r an
// axis, then one multiply by scale; 0: the weighted taps (r + 1 floats on
// the card, the centre last). smem > 0: the staged route, a th x tw tile
// a CTA in smem bytes of shared memory (ops/filters.py::blur_float_plan);
// 0: the direct route. Returns cudaGetLastError().
extern "C" int tpuva_gaussian_blur_f32(const float* x, float* out, int L, int H, int W, int C,
                                       const float* taps, int r, int binomial, float scale,
                                       int th, int tw, int smem, void* stream) {
  if (L <= 0 || H <= 0 || W <= 0 || (C != 1 && C != 3) || r < 1 ||
      (binomial && (r > 2 || smem == 0)) || (!binomial && !taps) || smem < 0 ||
      (smem > 0 && (th <= 0 || tw <= 0 || (H + th - 1) / th > 65535)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      C == 3 ? launch_blur_f32<3>(x, out, L, H, W, taps, r, binomial, scale, th, tw, smem, s)
             : launch_blur_f32<1>(x, out, L, H, W, taps, r, binomial, scale, th, tw, smem, s));
}
