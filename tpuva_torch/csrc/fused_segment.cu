// Fused segmentation front-end (kernel K1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel tpuva/ops/pallas/fused_segment.py::
// fused_segment (emit="mask", without padded_occ). Per frame and pixel:
//   cv2's u8 Gaussian blur: REFLECT_101, integer taps, (acc + 2^(s-1)) >> s
//   -> optional median 3x3 (BORDER_REPLICATE)
//   -> B <- (1-a)*B + a*F in float32 (two products, one add, no FMA)
//   -> |F - B| > thr
//   -> open (erode, dilate) -> close (dilate, erode), cv2 constant borders:
//      erode reads outside pixels as foreground, dilate as background.
// The plain PyTorch version is tpuva_torch/ops/fused_segment.py::
// fused_segment_plain; the two are bit-equal.
//
// Design. The TPU kernel relies on a grid that runs in order on one core;
// here one CTA owns a TH x TW tile and walks the N frames in order itself
// (the background recurrence is the only sequential dependency), keeping
// the background of its owned region plus the morphology reach Rm in
// shared memory for the whole batch. Each frame it loads the u8 window
// (owned + P on each side, P = blur_r + median_r + Rm) and runs every stage
// in shared memory on a region that shrinks by that stage's reach, so the
// owned pixels come out exact. Background halo pixels are updated
// redundantly by neighbouring CTAs with identical arithmetic; only owned
// pixels are written. Tiles with no foreground skip morphology: open and
// close of an all-zero tile are zero under cv2's borders.
//
// What bounds it on an H100: the data moved is 1 B read + 1 B written per
// pixel per frame (1.06 GB per 256-frame 1080p batch, 0.32 ms at
// 3.35 TB/s), so its speed of light is memory. This first version loads
// each window halo again per frame, runs every stage through shared memory
// with one thread per element and an integer division per index, so it is
// bound by instruction issue and shared-memory traffic well above that
// line. Registers for the per-thread rows and cp.async/TMA double buffering
// of the next frame are the later work.
//
// Exactness: built with --fmad=false and never with fast math; the
// background update uses __fmul_rn/__fadd_rn; the blur is integer code (a
// float conv2d would run in TF32 under cuDNN). Every partial blur sum is
// below 2^24 (255 * 256 * 256), so int32 holds it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 63;
constexpr int kMaxSE = 31;
constexpr int kThreads = 256;
constexpr int kMaxSmem = 227 * 1024;

struct SegParams {
  int N, H, W;
  float c1, a, thr;
  int ntaps, shift;
  int taps[kMaxTaps];
  int rm;                         // median radius: 0 or 1
  int stage_k[4];                 // SE size per stage, 0 = skip
  int stage_iters[4];
  unsigned stage_se[4][kMaxSE];   // per-row SE bitmask (bit dx)
  int P, Rm, TH, TW;
  int seed_bg;
};

// Shared-memory layout, shared by host (size) and device (carving).
struct Layout {
  int WH, WW, BH, BW, MH, MW;
  size_t raw, hs, blur, filt, bg, m0, m1, total;
  __host__ __device__ static size_t up16(size_t v) { return (v + 15) & ~size_t(15); }
  __host__ __device__ Layout(int TH, int TW, int P, int Rm, int rm) {
    WH = TH + 2 * P;          // raw window
    WW = TW + 2 * P;
    BH = TH + 2 * (Rm + rm);  // blurred region
    BW = TW + 2 * (Rm + rm);
    MH = TH + 2 * Rm;         // background / mask region
    MW = TW + 2 * Rm;
    size_t off = 0;
    raw = off;  off += up16(size_t(WH) * WW);
    hs = off;   off += up16(size_t(WH) * BW * 4);
    blur = off; off += up16(size_t(BH) * BW);
    filt = off; off += rm ? up16(size_t(MH) * MW) : 0;
    bg = off;   off += up16(size_t(MH) * MW * 4);
    m0 = off;   off += up16(size_t(MH) * MW);
    m1 = off;   off += up16(size_t(MH) * MW);
    total = off;
  }
};

__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i >= n ? period - i : i;
}

__device__ __forceinline__ bool in_image(int gy, int gx, int H, int W) {
  return gy >= 0 && gy < H && gx >= 0 && gx < W;
}

__device__ __forceinline__ void sort2(int* p, int i, int j) {
  const int a = p[i], b = p[j];
  p[i] = min(a, b);
  p[j] = max(a, b);
}

// Paeth's 19-op median-of-9 network (the pairs of tpuva's _median9).
__device__ __forceinline__ int median9(int* p) {
  sort2(p, 1, 2); sort2(p, 4, 5); sort2(p, 7, 8); sort2(p, 0, 1);
  sort2(p, 3, 4); sort2(p, 6, 7); sort2(p, 1, 2); sort2(p, 4, 5);
  sort2(p, 7, 8); sort2(p, 0, 3); sort2(p, 5, 8); sort2(p, 4, 7);
  sort2(p, 3, 6); sort2(p, 1, 4); sort2(p, 2, 5); sort2(p, 4, 7);
  sort2(p, 4, 2); sort2(p, 6, 4); sort2(p, 4, 2);
  return p[4];
}

// One erode or dilate over the M region. Reads outside the image see the
// op's identity (cv2's constant border); reads outside the M region see it
// too, which only disturbs the band that the reach bookkeeping discards.
__device__ void morph_step(const uint8_t* in, uint8_t* out, int MH, int MW,
                           int oy, int ox, int H, int W, int k,
                           const unsigned* se, bool erode) {
  const int r = k / 2;
  const int fill = erode ? 1 : 0;
  for (int i = threadIdx.x; i < MH * MW; i += blockDim.x) {
    const int y = i / MW, x = i % MW;
    int acc = fill;
    for (int dy = -r; dy <= r; ++dy) {
      const unsigned row = se[dy + r];
      const int yy = y + dy;
      for (int dx = -r; dx <= r; ++dx) {
        if (!((row >> (dx + r)) & 1u)) continue;
        const int xx = x + dx;
        int v = fill;
        if (yy >= 0 && yy < MH && xx >= 0 && xx < MW &&
            in_image(oy + yy, ox + xx, H, W))
          v = in[yy * MW + xx];
        acc = erode ? min(acc, v) : max(acc, v);
      }
    }
    out[i] = (uint8_t)acc;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_segment_kernel(const uint8_t* __restrict__ frames,
                     const float* __restrict__ bg0,
                     uint8_t* __restrict__ masks,
                     float* __restrict__ bg_out, const SegParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, W = p.W, P = p.P, Rm = p.Rm, rm = p.rm;
  const int TH = p.TH, TW = p.TW;
  const Layout L(TH, TW, P, Rm, rm);
  uint8_t* raw = smem + L.raw;
  int* hs = reinterpret_cast<int*>(smem + L.hs);
  uint8_t* blur = smem + L.blur;
  uint8_t* filt = rm ? smem + L.filt : blur;  // without median B == M
  float* bg = reinterpret_cast<float*>(smem + L.bg);
  uint8_t* mbuf[2] = {smem + L.m0, smem + L.m1};

  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int my0 = y0 - Rm, mx0 = x0 - Rm;         // M region origin
  const int by0 = my0 - rm, bx0 = mx0 - rm;       // B region origin
  const int MN = L.MH * L.MW;
  const size_t HW = size_t(H) * W;

  if (!p.seed_bg) {
    for (int i = threadIdx.x; i < MN; i += blockDim.x) {
      const int gy = my0 + i / L.MW, gx = mx0 + i % L.MW;
      bg[i] = in_image(gy, gx, H, W) ? bg0[size_t(gy) * W + gx] : 0.f;
    }
  }

  for (int t = 0; t < p.N; ++t) {
    const uint8_t* fr = frames + size_t(t) * HW;
    // 1. u8 window with REFLECT_101 coordinates
    for (int i = threadIdx.x; i < L.WH * L.WW; i += blockDim.x) {
      const int gy = reflect101(y0 - P + i / L.WW, H);
      const int gx = reflect101(x0 - P + i % L.WW, W);
      raw[i] = fr[size_t(gy) * W + gx];
    }
    __syncthreads();
    // 2. row pass: window rows, B columns (B col c is window col c + ntaps/2)
    for (int i = threadIdx.x; i < L.WH * L.BW; i += blockDim.x) {
      const int r = i / L.BW, c = i % L.BW;
      const uint8_t* src = raw + r * L.WW + c;
      int acc = 0;
      for (int k = 0; k < p.ntaps; ++k) acc += p.taps[k] * int(src[k]);
      hs[i] = acc;
    }
    __syncthreads();
    // 3. column pass + cv2's single rounding
    for (int i = threadIdx.x; i < L.BH * L.BW; i += blockDim.x) {
      const int r = i / L.BW, c = i % L.BW;
      int acc = 0;
      for (int k = 0; k < p.ntaps; ++k) acc += p.taps[k] * hs[(r + k) * L.BW + c];
      blur[i] = (uint8_t)(p.shift ? (acc + (1 << (p.shift - 1))) >> p.shift : acc);
    }
    __syncthreads();
    // 4. median 3x3 at clamped (replicated) coordinates
    if (rm) {
      for (int i = threadIdx.x; i < MN; i += blockDim.x) {
        const int gy = my0 + i / L.MW, gx = mx0 + i % L.MW;
        int v = 0;
        if (in_image(gy, gx, H, W)) {
          int win[9];
          int k = 0;
          for (int dy = -1; dy <= 1; ++dy)
            for (int dx = -1; dx <= 1; ++dx) {
              const int yy = min(max(gy + dy, 0), H - 1) - by0;
              const int xx = min(max(gx + dx, 0), W - 1) - bx0;
              win[k++] = blur[yy * L.BW + xx];
            }
          v = median9(win);
        }
        filt[i] = (uint8_t)v;
      }
      __syncthreads();
    }
    // 5. background update and strict threshold
    int any = 0;
    for (int i = threadIdx.x; i < MN; i += blockDim.x) {
      const int gy = my0 + i / L.MW, gx = mx0 + i % L.MW;
      uint8_t m = 0;
      if (in_image(gy, gx, H, W)) {
        const float f = float(filt[i]);
        float b = (p.seed_bg && t == 0) ? f : bg[i];
        b = __fadd_rn(__fmul_rn(p.c1, b), __fmul_rn(p.a, f));
        bg[i] = b;
        m = fabsf(__fsub_rn(f, b)) > p.thr ? 1 : 0;
      }
      mbuf[0][i] = m;
      any |= m;
    }
    any = __syncthreads_or(any);
    // 6. morphology, ping-pong over the M region
    int cur = 0;
    if (any) {
      for (int s = 0; s < 4; ++s) {
        if (!p.stage_k[s]) continue;
        const bool erode = (s == 0 || s == 3);
        for (int it = 0; it < p.stage_iters[s]; ++it) {
          morph_step(mbuf[cur], mbuf[cur ^ 1], L.MH, L.MW, my0, mx0, H, W,
                     p.stage_k[s], p.stage_se[s], erode);
          __syncthreads();
          cur ^= 1;
        }
      }
    }
    // 7. owned pixels out, 0/255
    uint8_t* out = masks + size_t(t) * HW;
    for (int i = threadIdx.x; i < TH * TW; i += blockDim.x) {
      const int r = i / TW, c = i % TW;
      const int gy = y0 + r, gx = x0 + c;
      if (gy < H && gx < W)
        out[size_t(gy) * W + gx] =
            (any && mbuf[cur][(r + Rm) * L.MW + c + Rm]) ? 255 : 0;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < TH * TW; i += blockDim.x) {
    const int r = i / TW, c = i % TW;
    const int gy = y0 + r, gx = x0 + c;
    if (gy < H && gx < W) bg_out[size_t(gy) * W + gx] = bg[(r + Rm) * L.MW + c + Rm];
  }
}

}  // namespace

extern "C" const char* tpuva_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// frames (N,H,W) u8, bg0 (H,W) f32 -> masks (N,H,W) u8 0/255, bg_out (H,W).
// Host arrays: taps[ntaps]; stage_k[4], stage_iters[4], stage_se[4][31].
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tpuva_fused_segment(
    const uint8_t* frames, const float* bg0, uint8_t* masks, float* bg_out,
    int N, int H, int W, float c1, float a, float thr,
    const int* taps, int ntaps, int shift, int median,
    const int* stage_k, const int* stage_iters, const unsigned* stage_se,
    int seed_bg, int tile_h, int tile_w, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || ntaps < 1 || ntaps > kMaxTaps ||
      ntaps % 2 == 0 || tile_h <= 0 || tile_w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  SegParams p{};
  p.N = N; p.H = H; p.W = W;
  p.c1 = c1; p.a = a; p.thr = thr;
  p.ntaps = ntaps; p.shift = shift;
  for (int k = 0; k < ntaps; ++k) p.taps[k] = taps[k];
  p.rm = median ? 1 : 0;
  p.Rm = 0;
  for (int s = 0; s < 4; ++s) {
    if (stage_k[s] < 0 || stage_k[s] > kMaxSE || (stage_k[s] && stage_k[s] % 2 == 0))
      return static_cast<int>(cudaErrorInvalidValue);
    p.stage_k[s] = stage_k[s];
    p.stage_iters[s] = stage_k[s] ? stage_iters[s] : 0;
    for (int r = 0; r < kMaxSE; ++r) p.stage_se[s][r] = stage_se[s * kMaxSE + r];
    p.Rm += (stage_k[s] / 2) * p.stage_iters[s];
  }
  p.P = ntaps / 2 + p.rm + p.Rm;  // blur + median + morphology reach
  p.TH = tile_h; p.TW = tile_w;
  p.seed_bg = seed_bg;
  const Layout L(tile_h, tile_w, p.P, p.Rm, p.rm);
  if (L.total > size_t(kMaxSmem)) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      fused_segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + tile_w - 1) / tile_w, (H + tile_h - 1) / tile_h);
  fused_segment_kernel<<<grid, kThreads, L.total,
                         static_cast<cudaStream_t>(stream)>>>(
      frames, bg0, masks, bg_out, p);
  return static_cast<int>(cudaGetLastError());
}
