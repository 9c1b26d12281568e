// The filter chain's pixel kernels for Hopper, sm_90a: BGR -> gray (KM),
// the affine warp (KW) and the linear resize (KR).
//
// On the TPU none is a Pallas kernel: each is one XLA program a batch of
// tpuva's filter chain. KM replaces tpuva/filters.py:202
// FilterMonochrome.batch_transform (a float32 tensordot with the BGR
// weights), KW tpuva/ops/warp.py:59 warp_affine (cv2.warpAffine,
// INTER_LINEAR, under FilterRotate(angle=) and FilterWarpAffine), KR
// tpuva/filters.py:220 FilterResize.batch_transform (jax.image.resize
// "linear" without antialiasing). Their plain versions are torch ops in
// the port: tpuva_torch/ops/color.py::bgr_to_gray_plain,
// ops/warp.py::warp_affine_plain and ops/resize.py::resize_linear_plain.
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
// - KW: a thread an output pixel (32 x 8 a CTA; grid z the images): the
//   sample coordinates once, then the four corners of each image and
//   channel gathered from the input (L2 holds the neighbourhood), each
//   masked on its own under the constant border.
// - KR: a thread an output pixel: the H pass at the two columns that the
//   W pass takes (four gathered inputs), rounded to float32 as the plain
//   version's intermediate is, then the W pass; an axis whose size stays
//   is skipped, as jax skips it. The taps (lower and upper index, their
//   weights) come from a table that ops/resize.py uploads once a shape.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileX = 32;
constexpr int kTileY = 8;

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

// KW: images (L, H, W, C) -> (L, ho, wo, C); (ia ib ic; id ie if_) the
// inverse map dst -> src in float32
template <typename T, int C, bool kConstant>
__global__ void __launch_bounds__(kTileX * kTileY)
warp_affine_kernel(const T* __restrict__ x, T* __restrict__ out, int L, int H, int W, int ho,
                   int wo, float ia, float ib, float ic, float id, float ie, float if_,
                   float bv) {
  const int xo = blockIdx.x * kTileX + threadIdx.x;
  const int yo = blockIdx.y * kTileY + threadIdx.y;
  if (xo >= wo || yo >= ho) return;
  const float fxo = static_cast<float>(xo), fyo = static_cast<float>(yo);
  const float sx = __fadd_rn(__fadd_rn(__fmul_rn(ia, fxo), __fmul_rn(ib, fyo)), ic);
  const float sy = __fadd_rn(__fadd_rn(__fmul_rn(id, fxo), __fmul_rn(ie, fyo)), if_);
  const float x0f = floorf(sx), y0f = floorf(sy);
  const float fx = __fsub_rn(sx, x0f), fy = __fsub_rn(sy, y0f);
  // The floors clamped to [-2, W + 1] and [-2, H + 1] before the integer
  // conversion: every corner outside the image stays outside (so the same
  // border mask) and clamps to the same edge pixel as the plain version's
  // int64 floor, and no conversion overflows.
  const int x0 = static_cast<int>(fminf(fmaxf(x0f, -2.0f), static_cast<float>(W) + 1.0f));
  const int y0 = static_cast<int>(fminf(fmaxf(y0f, -2.0f), static_cast<float>(H) + 1.0f));
  const int xa = min(max(x0, 0), W - 1), xb = min(max(x0 + 1, 0), W - 1);
  const int ya = min(max(y0, 0), H - 1), yb = min(max(y0 + 1, 0), H - 1);
  const bool okx0 = x0 >= 0 && x0 < W, okx1 = x0 + 1 >= 0 && x0 + 1 < W;
  const bool oky0 = y0 >= 0 && y0 < H, oky1 = y0 + 1 >= 0 && y0 + 1 < H;
  const long long plane = static_cast<long long>(H) * W * C;
  const long long i00 = (static_cast<long long>(ya) * W + xa) * C;
  const long long i01 = (static_cast<long long>(ya) * W + xb) * C;
  const long long i10 = (static_cast<long long>(yb) * W + xa) * C;
  const long long i11 = (static_cast<long long>(yb) * W + xb) * C;
  const long long o = (static_cast<long long>(yo) * wo + xo) * C;
  const long long oplane = static_cast<long long>(ho) * wo * C;
  for (int n = blockIdx.z; n < L; n += gridDim.z) {
    const T* img = x + n * plane;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float g00 = load_f(img + i00 + c), g01 = load_f(img + i01 + c);
      float g10 = load_f(img + i10 + c), g11 = load_f(img + i11 + c);
      if (kConstant) {
        if (!(okx0 && oky0)) g00 = bv;
        if (!(okx1 && oky0)) g01 = bv;
        if (!(okx0 && oky1)) g10 = bv;
        if (!(okx1 && oky1)) g11 = bv;
      }
      const float top = __fadd_rn(g00, __fmul_rn(fx, __fsub_rn(g01, g00)));
      const float bot = __fadd_rn(g10, __fmul_rn(fx, __fsub_rn(g11, g10)));
      store(out + n * oplane + o + c, __fadd_rn(top, __fmul_rn(fy, __fsub_rn(bot, top))));
    }
  }
}

// the resize taps of one output sample: rows lo, hi, w_lo bits, w_hi bits
// of a (4, n) int32 table
struct Tap {
  int lo, hi;
  float wlo, whi;
};

__device__ __forceinline__ Tap tap(const int* __restrict__ t, int n, int o) {
  return {t[o], t[n + o], __int_as_float(t[2 * n + o]), __int_as_float(t[3 * n + o])};
}

// KR: images (N, H, W, C) -> (N, h, w, C). taps_h / taps_w: (4, h) and
// (4, w) tables, or null where the axis keeps its size (then h == H or
// w == W)
template <typename T, int C>
__global__ void __launch_bounds__(kTileX * kTileY)
resize_linear_kernel(const T* __restrict__ x, T* __restrict__ out, int N, int H, int W, int h,
                     int w, const int* __restrict__ taps_h, const int* __restrict__ taps_w) {
  const int xo = blockIdx.x * kTileX + threadIdx.x;
  const int yo = blockIdx.y * kTileY + threadIdx.y;
  if (xo >= w || yo >= h) return;
  const Tap th = taps_h ? tap(taps_h, h, yo) : Tap{yo, yo, 1.0f, 0.0f};
  const Tap tw = taps_w ? tap(taps_w, w, xo) : Tap{xo, xo, 1.0f, 0.0f};
  const long long plane = static_cast<long long>(H) * W * C;
  const long long oplane = static_cast<long long>(h) * w * C;
  const long long rlo = static_cast<long long>(th.lo) * W, rhi = static_cast<long long>(th.hi) * W;
  const long long o = (static_cast<long long>(yo) * w + xo) * C;
  for (int n = blockIdx.z; n < N; n += gridDim.z) {
    const T* img = x + n * plane;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      // the H pass at columns tw.lo and tw.hi (w_lo x[lo] + w_hi x[hi])
      float t[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const long long col = (k ? tw.hi : tw.lo);
        const float a = load_f(img + (rlo + col) * C + c);
        t[k] = taps_h ? __fadd_rn(__fmul_rn(a, th.wlo),
                                  __fmul_rn(load_f(img + (rhi + col) * C + c), th.whi))
                      : a;
      }
      const float v = taps_w ? __fadd_rn(__fmul_rn(t[0], tw.wlo), __fmul_rn(t[1], tw.whi)) : t[0];
      store(out + n * oplane + o + c, v);
    }
  }
}

// grid of a tiled kernel over (w, h) outputs and L images (z at most 65535;
// the kernels loop over the rest)
dim3 tile_grid(int w, int h, int L) {
  return dim3((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY, L < 65535 ? L : 65535);
}

template <typename T, int C>
void launch_warp(const void* x, void* out, int L, int H, int W, int ho, int wo, int constant,
                 float ia, float ib, float ic, float id, float ie, float if_, float bv,
                 cudaStream_t s) {
  const dim3 grid = tile_grid(wo, ho, L), block(kTileX, kTileY);
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (constant)
    warp_affine_kernel<T, C, true><<<grid, block, 0, s>>>(xi, o, L, H, W, ho, wo, ia, ib, ic,
                                                          id, ie, if_, bv);
  else
    warp_affine_kernel<T, C, false><<<grid, block, 0, s>>>(xi, o, L, H, W, ho, wo, ia, ib, ic,
                                                           id, ie, if_, bv);
}

template <typename T, int C>
void launch_resize(const void* x, void* out, int N, int H, int W, int h, int w,
                   const int* taps_h, const int* taps_w, cudaStream_t s) {
  resize_linear_kernel<T, C><<<tile_grid(w, h, N), dim3(kTileX, kTileY), 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), N, H, W, h, w, taps_h, taps_w);
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
// border value bv) or replicate (0) border. Returns cudaGetLastError().
extern "C" int tpuva_warp_affine(const void* x, void* out, int L, int H, int W, int C, int ho,
                                 int wo, int is_float, int constant, float ia, float ib,
                                 float ic, float id, float ie, float if_, float bv,
                                 void* stream) {
  if (L <= 0 || H <= 0 || W <= 0 || ho <= 0 || wo <= 0 || (C != 1 && C != 3) ||
      H >= (1 << 24) || W >= (1 << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float) {
    if (C == 3) launch_warp<float, 3>(x, out, L, H, W, ho, wo, constant, ia, ib, ic, id, ie, if_, bv, s);
    else launch_warp<float, 1>(x, out, L, H, W, ho, wo, constant, ia, ib, ic, id, ie, if_, bv, s);
  } else {
    if (C == 3) launch_warp<uint8_t, 3>(x, out, L, H, W, ho, wo, constant, ia, ib, ic, id, ie, if_, bv, s);
    else launch_warp<uint8_t, 1>(x, out, L, H, W, ho, wo, constant, ia, ib, ic, id, ie, if_, bv, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// KR: x (N, H, W, C) -> out (N, h, w, C), C 1 or 3, uint8 or float32;
// taps_h (4, h) / taps_w (4, w) int32 tables on the card, null where the
// axis keeps its size. Returns cudaGetLastError().
extern "C" int tpuva_resize_linear(const void* x, void* out, int N, int H, int W, int C, int h,
                                   int w, const int* taps_h, const int* taps_w, int is_float,
                                   void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || h <= 0 || w <= 0 || (C != 1 && C != 3) ||
      (!taps_h && h != H) || (!taps_w && w != W))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float) {
    if (C == 3) launch_resize<float, 3>(x, out, N, H, W, h, w, taps_h, taps_w, s);
    else launch_resize<float, 1>(x, out, N, H, W, h, w, taps_h, taps_w, s);
  } else {
    if (C == 3) launch_resize<uint8_t, 3>(x, out, N, H, W, h, w, taps_h, taps_w, s);
    else launch_resize<uint8_t, 1>(x, out, N, H, W, h, w, taps_h, taps_w, s);
  }
  return static_cast<int>(cudaGetLastError());
}
