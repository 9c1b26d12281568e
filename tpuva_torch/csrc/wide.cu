// K1's stages past a CTA's shared memory (kernels K1b and K1m) for
// Hopper, sm_90a.
//
// Replaces the parts of the Pallas TPU kernel tpuva/ops/pallas/
// fused_segment.py::fused_segment that csrc/fused_segment.cu cannot hold:
// that kernel keeps a tile's window, row sums and morphology region in
// shared memory, so a blur of more than 63 taps, a structuring element
// wider than 31, or a morphology reach whose tile outgrows a CTA's 227 KB
// (open and close 7 x 10 reach 120 pixels) does not fit it. The TPU
// kernel has no such limit: its tiles live in VMEM, and it iterates the
// open and close inside one launch. The wrapper (ops/fused_segment.py::
// fused_segment) takes those stages out of K1 and runs them here:
//   K1b, blur_u8: cv2's u8 Gaussian, REFLECT_101, integer taps,
//     (acc + 2^(s-1)) >> s, before K1 runs on the blurred frames without a
//     blur;
//   K1m, morph_u8: erode and dilate steps over any structuring element
//     (as runs: a row offset and the column offsets lo..hi it covers),
//     cv2's constant borders (erode reads outside pixels as 255, dilate as
//     0) at every step, after K1 runs without morphology. For K1's
//     padded_occ mode the last launch writes the (N, Hp, Wp) padded mask
//     (0 outside the H x W image) and sets the (N, Hp/2, Wp/128) occupancy
//     of its foreground, as K1 does where it runs the morphology itself.
// Both are exact integer (or min/max) code; the plain PyTorch versions are
// tpuva_torch/ops/filters.py::gaussian_blur_u8 and its _morph, and the
// kernels are bit-equal to them.
//
// What bounds them on an H100. K1m: the mask read and written once a
// launch (1.06 GB a 256-frame 1080p batch, 0.32 ms at 3.35 TB/s) against
// a few byte min/max a pixel and step, so several steps share a launch
// (one step a launch over global memory, the first form, read the mask
// once a step and spent a load through L1 a structuring element pixel).
// K1b: 2 x (2 x 65 - 1) + 2 operations a pixel at 65 taps (2.06 ms at 67
// Tops/s), against 1 byte read and 1 written: the design spends fewer
// instructions a tap.
//
// Design of K1m (morph_group_kernel). The host (ops/wide.py::morph_plan)
// cuts the step list into groups: consecutive steps whose summed reach
// (Ry rows, Rx columns) fits the halo of a tile whose buffers fit shared
// memory, at most about twice the owned area (2.25x). One launch runs a
// group: a CTA owns a TH x TW tile of one frame and loads the tile plus
// the group's halo (columns rounded out to 16 bytes) into shared memory,
// 16 bytes a load where the image rows are 16-byte aligned, then runs
// every step of the group there and writes its owned pixels once, 16
// bytes a store. A step is separable by runs: for each distinct column
// extent (lo, hi) of the SE a row pass reduces each row over lo..hi into
// a buffer T, four pixels a 32-bit word, by doubling in registers (w = 2k
// from two w = k results, funnel shifts for the byte offsets; extents past
// 16 in chunks of 16); a column pass then combines, for each output word,
// the T words of the rows dy that carry that extent (as contiguous
// ranges). A rect SE is one extent; cv2's 7-wide ellipse three. Each step
// shrinks the region it computes by its reach, so the owned pixels come
// out exact. Pixels of the region outside the image are reset to the
// step's border value (255 erode, 0 dilate) before every step: values an
// earlier step computed there must not leak in. A tile whose every input
// byte is 0 or 255 (the pipeline's masks always are) runs its min and max
// as AND and OR; other bytes take __vminu4/__vmaxu4. A tile whose input
// region is all zero writes zeros and stops, where every SE of the group
// holds its anchor (the host says so: a step of such an SE maps zeros to
// zeros). SEs whose single step fits no tile keep morph_step_kernel, one
// thread a pixel over global memory, one step a launch; the plan chooses
// it from the shapes alone.
//
// Design of K1b (blur_tile_kernel), one launch: a CTA owns a TH x TW
// output tile (ops/wide.py::blur_plan; 128 x 64 at 65 taps), loads
// the (TH + 2r) x (TW + 2r) u8 window with the REFLECT_101 index (as many
// reflections as the reach needs) into shared memory, 16-byte loads four
// in flight where its columns lie inside the image, runs the row pass
// into uint16 sums in shared memory (at most 255 x 256, stored a column a
// row), then the column pass from there into an int32 sum and cv2's
// single rounding, and writes the tile out 16 bytes a store. A thread
// computes eight outputs of a row (row pass) or a column (column pass).
// Where every tap is at most 255 (cv2's always are, but for a centre tap
// of 256 at a tiny sigma), the row pass takes four taps an instruction
// (__dp4a on the window's bytes, funnel-shifted per output) and the
// column pass two (__dp2a_lo on pairs of row sums, which the transposed
// layout makes adjacent); else a multiply-add a tap over a ring of eight
// values in registers. Folding the symmetric taps, t[k] (a + b), saved
// nothing on this card (an add and a multiply a pair cost two
// multiply-adds; PERF.md) and does not combine with __dp2a_lo, whose
// 16-bit operands the pair sums overflow. Tap counts whose window fits no
// tile keep the two global passes through an (N, H, W) uint16 buffer
// (blur_rows_kernel, blur_cols_kernel).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kGuard = 64;  // bytes before and after each morphology buffer
constexpr int kChunk = 16;  // the widest run extent one unrolled row reduction takes
constexpr int kSlide = 8;   // outputs a thread slides over in K1b's passes

__host__ __device__ constexpr long long up16(long long v) { return (v + 15) & ~15LL; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

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

bool shape_ok(int N, int H, int W) {
  return N > 0 && H > 0 && W > 0 && N <= 65535 && H <= 65535;
}

// ---------------------------------------------------------------- K1b

// Shared memory of one K1b CTA; mirrored by ops/wide.py::blur_smem.
struct BlurLayout {
  long long WH, WW, WP, HP, win, hs, taps, taps4, taps2, rowoff, colidx, total;
  BlurLayout(int TH, int TW, int ntaps) {
    const long long r = ntaps / 2;
    WH = TH + 2 * r;  // window rows
    WW = TW + 2 * r;  // window columns
    WP = up16(WW + 15);         // window pitch: up to 15 bytes before column 0 (16-byte loads)
    HP = WH + (6 - WH % 4) % 4;  // row-sum column pitch, 2 mod 4 (uint16): no bank conflicts
    long long off = 0;
    win = off;    off += up16(WH * WP);      // the u8 window, then the output tile
    hs = off;     off += up16(TW * HP * 2);  // uint16 row sums, a column a row (transposed)
    taps = off;   off += up16(4LL * ntaps);
    taps4 = off;  off += up16(4LL * cdiv(ntaps, 4));  // the taps as bytes, four a word
    taps2 = off;  off += up16(4LL * cdiv(ntaps, 2));  // and two a word
    rowoff = off; off += up16(4 * WH);       // REFLECT_101 source row offsets
    colidx = off; off += up16(4 * WW);       // and column indices
    total = off;
  }
};

struct BlurParams {
  int N, H, W, ntaps, shift, TH, TW;
  int vin, vout;  // 16: 16-byte loads, stores; 1: bytes
  int WH, WW, WP, HP, win, hs, taps, taps4, taps2, rowoff, colidx;
};

// acc[s] = sum_k taps[k] * ld(s + k), s < kSlide, a multiply-add a tap: a
// ring of kSlide values in registers, one new load a tap (the ring's slots
// are fixed by unrolling the tap loop by kSlide).
template <class Ld>
__device__ __forceinline__ void slide(int (&acc)[kSlide], Ld ld, const int* taps, int ntaps) {
  constexpr int R = kSlide;
  int ring[R];
#pragma unroll
  for (int s = 0; s < R; ++s) acc[s] = 0;
#pragma unroll
  for (int s = 0; s + 1 < R; ++s) ring[s] = ld(s);
  for (int kb = 0; kb < ntaps; kb += R) {
#pragma unroll
    for (int kk = 0; kk < R; ++kk) {
      const int k = kb + kk;
      if (k < ntaps) {
        ring[(kk + R - 1) % R] = ld(k + R - 1);  // ring[(k + s) % R] = ld(k + s)
        const int t = taps[k];
#pragma unroll
        for (int s = 0; s < R; ++s) acc[s] += t * ring[(kk + s) % R];
      }
    }
  }
}

// The same over bytes v[k], four taps an instruction (__dp4a): taps4[m]
// holds taps 4m .. 4m + 3 as bytes (every tap <= 255; 0 past the last, so
// the bytes read past the window count nothing).
__device__ __forceinline__ void slide_dp4a(int (&acc)[kSlide], const uint8_t* v,
                                           const uint32_t* taps4, int ngroups) {
  const int sh = 8 * (reinterpret_cast<uintptr_t>(v) & 3);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(v - (reinterpret_cast<uintptr_t>(v) & 3));
  uint32_t u0 = __funnelshift_r(w[0], w[1], sh), u1 = __funnelshift_r(w[1], w[2], sh);
  uint32_t next = w[2];
  uint32_t a[kSlide] = {};
  for (int m = 0; m < ngroups; ++m) {
    const uint32_t w3 = w[m + 3];
    const uint32_t u2 = __funnelshift_r(next, w3, sh);  // u0, u1, u2: v[4m ..], v[4m + 4 ..], v[4m + 8 ..]
    next = w3;
    const uint32_t t = taps4[m];
    a[0] = __dp4a(u0, t, a[0]);
    a[1] = __dp4a(__funnelshift_r(u0, u1, 8), t, a[1]);
    a[2] = __dp4a(__funnelshift_r(u0, u1, 16), t, a[2]);
    a[3] = __dp4a(__funnelshift_r(u0, u1, 24), t, a[3]);
    a[4] = __dp4a(u1, t, a[4]);
    a[5] = __dp4a(__funnelshift_r(u1, u2, 8), t, a[5]);
    a[6] = __dp4a(__funnelshift_r(u1, u2, 16), t, a[6]);
    a[7] = __dp4a(__funnelshift_r(u1, u2, 24), t, a[7]);
    u0 = u1;
    u1 = u2;
  }
#pragma unroll
  for (int s = 0; s < kSlide; ++s) acc[s] = int(a[s]);
}

// The same over uint16 values c[k] (4-byte aligned), two taps an
// instruction (__dp2a_lo): taps2[m] holds taps 2m, 2m + 1 as bytes.
__device__ __forceinline__ void slide_dp2a(int (&acc)[kSlide], const uint16_t* c,
                                           const uint32_t* taps2, int npairs) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(c);  // w[q] = c[2q], c[2q + 1]
  uint32_t u0 = w[0], u1 = w[1], u2 = w[2], u3 = w[3];
  uint32_t a[kSlide] = {};
  for (int m = 0; m < npairs; ++m) {
    const uint32_t u4 = w[m + 4];
    const uint32_t t = taps2[m];
    a[0] = __dp2a_lo(u0, t, a[0]);
    a[1] = __dp2a_lo(__funnelshift_r(u0, u1, 16), t, a[1]);
    a[2] = __dp2a_lo(u1, t, a[2]);
    a[3] = __dp2a_lo(__funnelshift_r(u1, u2, 16), t, a[3]);
    a[4] = __dp2a_lo(u2, t, a[4]);
    a[5] = __dp2a_lo(__funnelshift_r(u2, u3, 16), t, a[5]);
    a[6] = __dp2a_lo(u3, t, a[6]);
    a[7] = __dp2a_lo(__funnelshift_r(u3, u4, 16), t, a[7]);
    u0 = u1;
    u1 = u2;
    u2 = u3;
    u3 = u4;
  }
#pragma unroll
  for (int s = 0; s < kSlide; ++s) acc[s] = int(a[s]);
}

// DP: every tap is at most 255, and the passes take __dp4a (rows) and
// __dp2a_lo (columns); else a multiply-add a tap.
template <bool DP>
__global__ void __launch_bounds__(kThreads)
blur_tile_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                 const int* __restrict__ taps_g, const BlurParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* win = smem + p.win;
  uint16_t* hs = reinterpret_cast<uint16_t*>(smem + p.hs);
  int* taps = reinterpret_cast<int*>(smem + p.taps);
  uint32_t* taps4 = reinterpret_cast<uint32_t*>(smem + p.taps4);
  uint32_t* taps2 = reinterpret_cast<uint32_t*>(smem + p.taps2);
  int* rowoff = reinterpret_cast<int*>(smem + p.rowoff);
  int* colidx = reinterpret_cast<int*>(smem + p.colidx);
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * p.TH, x0 = blockIdx.x * p.TW;
  const int r = p.ntaps / 2;
  const size_t frame = size_t(blockIdx.z) * p.H * p.W;
  const int ngroups = cdiv(p.ntaps, 4), npairs = cdiv(p.ntaps, 2);
  for (int i = tid; i < p.ntaps; i += kThreads) taps[i] = taps_g[i];
  for (int m = tid; m < ngroups; m += kThreads) {
    uint32_t t4 = 0;
    for (int j = 0; j < 4 && 4 * m + j < p.ntaps; ++j) t4 |= uint32_t(taps_g[4 * m + j] & 0xff) << (8 * j);
    taps4[m] = t4;
  }
  for (int m = tid; m < npairs; m += kThreads)
    taps2[m] = uint32_t(taps_g[2 * m] & 0xff) |
               (2 * m + 1 < p.ntaps ? uint32_t(taps_g[2 * m + 1] & 0xff) << 8 : 0u);
  for (int i = tid; i < p.WH; i += kThreads) rowoff[i] = reflect101(y0 - r + i, p.H) * p.W;
  for (int i = tid; i < p.WW; i += kThreads) colidx[i] = reflect101(x0 - r + i, p.W);
  __syncthreads();
  // the window, rows from their REFLECT_101 sources: where its columns lie
  // inside the image and the rows are 16-byte aligned, the aligned 16-byte
  // chunks that cover them (window column c at byte xoff + c of its row);
  // else four bytes a thread through the column table. Four copies in
  // flight a thread.
  const uint8_t* src = x + frame;
  const int wx0 = x0 - r;
  int xoff = 0;
  if (p.vin == 16 && wx0 >= 0 && wx0 + p.WW <= p.W) {
    xoff = wx0 & 15;
    const int ax0 = wx0 - xoff, nch = cdiv(xoff + p.WW, 16), total = p.WH * nch;
    for (int base = tid; base < total; base += 4 * kThreads) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int it = base + u * kThreads;
        if (it < total)
          v[u] = *reinterpret_cast<const uint4*>(src + rowoff[it / nch] + ax0 + 16 * (it % nch));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int it = base + u * kThreads;
        if (it < total) *reinterpret_cast<uint4*>(win + (it / nch) * p.WP + 16 * (it % nch)) = v[u];
      }
    }
  } else {
    const int nw = cdiv(p.WW, 4), total = p.WH * nw;
    for (int base = tid; base < total; base += 4 * kThreads) {
      uint32_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int it = base + u * kThreads;
        v[u] = 0;
        if (it < total) {
          const uint8_t* s = src + rowoff[it / nw];
          const int c = 4 * (it % nw);
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (c + b < p.WW) v[u] |= uint32_t(s[colidx[c + b]]) << (8 * b);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int it = base + u * kThreads;
        if (it < total) *reinterpret_cast<uint32_t*>(win + (it / nw) * p.WP + 4 * (it % nw)) = v[u];
      }
    }
  }
  __syncthreads();
  // row pass: window rows x the tile's columns, eight sums a thread, stored
  // a column a row (hs[column * HP + window row])
  const int ngr = p.TW / kSlide;
  for (int it = tid; it < p.WH * ngr; it += kThreads) {
    const int i = it / ngr, g = it % ngr;
    const uint8_t* v = win + i * p.WP + xoff + kSlide * g;
    int acc[kSlide];
    if constexpr (DP) slide_dp4a(acc, v, taps4, ngroups);
    else slide(acc, [v](int k) { return int(v[k]); }, taps, p.ntaps);
#pragma unroll
    for (int s = 0; s < kSlide; ++s) hs[(kSlide * g + s) * p.HP + i] = static_cast<uint16_t>(acc[s]);
  }
  __syncthreads();
  // column pass: eight rows of a column a thread, rounded once, into the
  // window's bytes (the output tile, pitch TW)
  const int half = 1 << (p.shift - 1);
  const int TW = p.TW;
  for (int it = tid; it < (p.TH / kSlide) * TW; it += kThreads) {
    const int gy = it / TW, j = it % TW;
    if (y0 + kSlide * gy >= p.H) continue;
    const uint16_t* c = hs + j * p.HP + kSlide * gy;
    int acc[kSlide];
    if constexpr (DP) slide_dp2a(acc, c, taps2, npairs);
    else slide(acc, [c](int k) { return int(c[k]); }, taps, p.ntaps);
#pragma unroll
    for (int s = 0; s < kSlide; ++s)
      win[(kSlide * gy + s) * TW + j] = static_cast<uint8_t>((acc[s] + half) >> p.shift);
  }
  __syncthreads();
  uint8_t* dst = out + frame;
  if (p.vout == 16) {
    const int nq = TW / 16;
    for (int it = tid; it < p.TH * nq; it += kThreads) {
      const int i = it / nq, q = it % nq;
      const int gy = y0 + i, gx = x0 + 16 * q;
      if (gy < p.H && gx < p.W)
        *reinterpret_cast<uint4*>(dst + size_t(gy) * p.W + gx) =
            *reinterpret_cast<const uint4*>(win + i * TW + 16 * q);
    }
  } else {
    for (int it = tid; it < p.TH * TW; it += kThreads) {
      const int i = it / TW, j = it % TW;
      const int gy = y0 + i, gx = x0 + j;
      if (gy < p.H && gx < p.W) dst[size_t(gy) * p.W + gx] = win[i * TW + j];
    }
  }
}

// Tap counts whose window fits no tile: rows into an (N, H, W) uint16
// buffer, then columns, one thread a pixel over global memory.
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

// ---------------------------------------------------------------- K1m

struct MorphParams {
  int N, H, W, Hp, Wp;  // input (N, H, W), output (N, Hp, Wp)
  int TH, TW, Ry, Rx, Rxa;
  int nsteps, table_len, nbuf, skip_ok;
  int vin, vout;  // 16: 16-byte global loads / stores; 1: bytes
  int occ_w;      // occ bytes a block row: Wp / 128 (padded_occ)
  int RH, RP, buf;  // region rows, region pitch, bytes a buffer (guards included)
};

// Shared memory of one K1m CTA; mirrored by ops/wide.py::morph_smem.
long long morph_smem(int TH, int TW, int Ry, int Rxa, int nbuf, int table_len,
                     long long* RH, long long* RP, long long* buf) {
  *RH = TH + 2LL * Ry;
  *RP = TW + 2LL * Rxa;
  *buf = up16(*RH * *RP + 2 * kGuard);
  return nbuf * *buf + up16(4LL * table_len);
}

template <bool BIN, bool ERODE>
__device__ __forceinline__ uint32_t mop(uint32_t a, uint32_t b) {
  if constexpr (BIN) return ERODE ? (a & b) : (a | b);  // bytes 0 or 255
  else return ERODE ? __vminu4(a, b) : __vmaxu4(a, b);
}

template <bool BIN, bool ERODE>
__device__ __forceinline__ uint4 mop4(uint4 a, uint4 b) {
  return make_uint4(mop<BIN, ERODE>(a.x, b.x), mop<BIN, ERODE>(a.y, b.y),
                    mop<BIN, ERODE>(a.z, b.z), mop<BIN, ERODE>(a.w, b.w));
}

// bytes 4k + S .. 4k + S + 3 of the byte stream held in words m
template <int S>
__device__ __forceinline__ uint32_t bytes_at(const uint32_t* m, int k) {
  if constexpr (S % 4 == 0) return m[k + S / 4];
  else return __funnelshift_r(m[k + S / 4], m[k + S / 4 + 1], 8 * (S % 4));
}

// Doubling: m holds M_P, the op over P consecutive bytes, valid at
// positions [0, LEN); it becomes M_N at positions [0, 16).
template <int P, int LEN, int N, bool BIN, bool ERODE>
__device__ __forceinline__ void doubling(uint32_t* m) {
  if constexpr (2 * P <= N) {
    constexpr int NL = LEN - P;  // M_2P[x] = op(M_P[x], M_P[x + P])
#pragma unroll
    for (int k = 0; k < (NL + 3) / 4; ++k) m[k] = mop<BIN, ERODE>(m[k], bytes_at<P>(m, k));
    doubling<2 * P, NL, N, BIN, ERODE>(m);
  } else if constexpr (N > P) {  // M_N[x] = op(M_P[x], M_P[x + N - P])
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = mop<BIN, ERODE>(m[k], bytes_at<N - P>(m, k));
  }
}

// out: the op over bytes b0 + j + d, d < N, for the 16 positions j of a
// row (four words), from the row's aligned words.
template <int N, bool BIN, bool ERODE>
__device__ __forceinline__ void row_chunk(const uint8_t* row, int b0, uint32_t (&out)[4]) {
  constexpr int L = 15 + N;            // bytes the 16 windows span
  constexpr int NU = (L + 3) / 4 + 2;  // words, with room for the reads of bytes_at
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (b0 & ~3));
  const int sh = 8 * (b0 & 3);
  uint32_t m[NU];
  uint32_t lo = w[0];
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    const uint32_t hi = w[k + 1];
    m[k] = __funnelshift_r(lo, hi, sh);
    lo = hi;
  }
  doubling<1, L, N, BIN, ERODE>(m);
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = m[k];
}

template <bool BIN, bool ERODE>
__device__ __forceinline__ void row_chunk_n(int n, const uint8_t* row, int b0,
                                            uint32_t (&out)[4]) {
  switch (n) {
    case 1: row_chunk<1, BIN, ERODE>(row, b0, out); break;
    case 2: row_chunk<2, BIN, ERODE>(row, b0, out); break;
    case 3: row_chunk<3, BIN, ERODE>(row, b0, out); break;
    case 4: row_chunk<4, BIN, ERODE>(row, b0, out); break;
    case 5: row_chunk<5, BIN, ERODE>(row, b0, out); break;
    case 6: row_chunk<6, BIN, ERODE>(row, b0, out); break;
    case 7: row_chunk<7, BIN, ERODE>(row, b0, out); break;
    case 8: row_chunk<8, BIN, ERODE>(row, b0, out); break;
    case 9: row_chunk<9, BIN, ERODE>(row, b0, out); break;
    case 10: row_chunk<10, BIN, ERODE>(row, b0, out); break;
    case 11: row_chunk<11, BIN, ERODE>(row, b0, out); break;
    case 12: row_chunk<12, BIN, ERODE>(row, b0, out); break;
    case 13: row_chunk<13, BIN, ERODE>(row, b0, out); break;
    case 14: row_chunk<14, BIN, ERODE>(row, b0, out); break;
    case 15: row_chunk<15, BIN, ERODE>(row, b0, out); break;
    default: row_chunk<16, BIN, ERODE>(row, b0, out); break;
  }
}

// T[y][x] = op over A[y][x + lo .. x + hi], rows [y0, y1), 16-byte groups
// [q0, q1) of columns
template <bool BIN, bool ERODE>
__device__ void row_pass(const uint8_t* A, uint8_t* T, int RP, int y0, int y1, int q0, int q1,
                         int lo, int hi) {
  const int nq = q1 - q0;
  for (int it = threadIdx.x; it < (y1 - y0) * nq; it += kThreads) {
    const int y = y0 + it / nq, q = q0 + it % nq;
    const uint8_t* row = A + y * RP;
    uint32_t acc[4];
    row_chunk_n<BIN, ERODE>(min(kChunk, hi - lo + 1), row, 16 * q + lo, acc);
    for (int c = lo + kChunk; c <= hi; c += kChunk) {
      uint32_t part[4];
      row_chunk_n<BIN, ERODE>(min(kChunk, hi - c + 1), row, 16 * q + c, part);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = mop<BIN, ERODE>(acc[k], part[k]);
    }
    *reinterpret_cast<uint4*>(T + y * RP + 16 * q) = make_uint4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// dst[y][x] = op(part[y][x] (the extents so far; none: the neutral value),
// T[y + dy][x] for dy in the nv ranges [a, b]), rows [y0, y1)
template <bool BIN, bool ERODE>
__device__ void col_pass(const uint8_t* T, const uint8_t* part, uint8_t* dst, int RP, int y0,
                         int y1, int q0, int q1, const int* ranges, int nv) {
  constexpr uint32_t kNeutral = ERODE ? 0xffffffffu : 0u;
  const int nq = q1 - q0;
  for (int it = threadIdx.x; it < (y1 - y0) * nq; it += kThreads) {
    const int y = y0 + it / nq, q = q0 + it % nq;
    uint4 acc = part ? *reinterpret_cast<const uint4*>(part + y * RP + 16 * q)
                     : make_uint4(kNeutral, kNeutral, kNeutral, kNeutral);
    for (int v = 0; v < nv; ++v) {
      const int a = ranges[2 * v], b = ranges[2 * v + 1];
      const uint8_t* src = T + (y + a) * RP + 16 * q;
      for (int dy = a; dy <= b; ++dy, src += RP)
        acc = mop4<BIN, ERODE>(acc, *reinterpret_cast<const uint4*>(src));
    }
    *reinterpret_cast<uint4*>(dst + y * RP + 16 * q) = acc;
  }
}

// The region's pixels outside the image get the step's border value: the
// rows above and below it whole, the columns left and right of it.
__device__ void reset_outside(uint8_t* A, const MorphParams& p, int gy0, int gx0,
                              uint8_t fill) {
  const int rt = min(max(-gy0, 0), p.RH);        // rows [0, rt) above the image
  const int rb = max(min(p.H - gy0, p.RH), rt);  // rows [rb, RH) below it
  const int cl = min(max(-gx0, 0), p.RP);        // columns [0, cl) left of it
  const int cr = max(min(p.W - gx0, p.RP), cl);  // columns [cr, RP) right of it
  const uint32_t f = fill * 0x01010101u;
  const int nq = p.RP / 16;
  for (int it = threadIdx.x; it < (rt + p.RH - rb) * nq; it += kThreads) {
    int r = it / nq;
    if (r >= rt) r += rb - rt;
    *reinterpret_cast<uint4*>(A + r * p.RP + 16 * (it % nq)) = make_uint4(f, f, f, f);
  }
  const int nb = cl + p.RP - cr;
  for (int it = threadIdx.x; it < (rb - rt) * nb; it += kThreads) {
    int c = it % nb;
    if (c >= cl) c += cr - cl;
    A[(rt + it / nb) * p.RP + c] = fill;
  }
}

// Every step of the group on the region in A (T, and O for SEs of several
// extents, are scratch). tab: per step erode, ry, rx, the number of
// extents, then per extent lo, hi, the number of row ranges and the
// ranges [a, b].
template <bool BIN>
__device__ void run_steps(uint8_t* A, uint8_t* T, uint8_t* O, const int* tab,
                          const MorphParams& p, int gy0, int gx0) {
  const bool border = gy0 < 0 || gx0 < 0 || gy0 + p.RH > p.H || gx0 + p.RP > p.W;
  int off = 0, cy = 0, cx = p.Rxa - p.Rx;  // the band of the region no longer exact
  for (int s = 0; s < p.nsteps; ++s) {
    const int erode = tab[off], ry = tab[off + 1], rx = tab[off + 2], ne = tab[off + 3];
    off += 4;
    if (s > 0 && border) {  // the load wrote step 0's border value
      reset_outside(A, p, gy0, gx0, erode ? 0xff : 0);
      __syncthreads();
    }
    const int q0 = (cx + rx) / 16, q1 = cdiv(p.RP - cx - rx, 16);
    for (int e = 0; e < ne; ++e) {
      const int lo = tab[off], hi = tab[off + 1], nv = tab[off + 2];
      const int* ranges = tab + off + 3;
      off += 3 + 2 * nv;
      if (erode) row_pass<BIN, true>(A, T, p.RP, cy, p.RH - cy, q0, q1, lo, hi);
      else row_pass<BIN, false>(A, T, p.RP, cy, p.RH - cy, q0, q1, lo, hi);
      __syncthreads();
      // the last extent writes A (read by no one any more), the others O
      uint8_t* to = e == ne - 1 ? A : O;
      const uint8_t* part = e == 0 ? nullptr : O;
      if (erode)
        col_pass<BIN, true>(T, part, to, p.RP, cy + ry, p.RH - cy - ry, q0, q1, ranges, nv);
      else
        col_pass<BIN, false>(T, part, to, p.RP, cy + ry, p.RH - cy - ry, q0, q1, ranges, nv);
      __syncthreads();
    }
    cy += ry;
    cx += rx;
  }
}

__device__ __forceinline__ uint32_t not_binary(uint32_t v) {  // bytes other than 0 and 255
  return (v ^ (v >> 1)) & 0x7f7f7f7fu;
}

// The owned TH x TW pixels out to an (Hp, Wp) frame from src (pitch RP;
// null: zeros), 0 outside the H x W image; with occ a store holding
// foreground sets its 2 x 128 block's byte (a 16-byte store never crosses
// one).
__device__ void write_tile(uint8_t* dst, uint8_t* occ, const uint8_t* src, const MorphParams& p,
                           int y0, int x0) {
  if (p.vout == 16) {
    const int nq = p.TW / 16;
    for (int it = threadIdx.x; it < p.TH * nq; it += kThreads) {
      const int r = it / nq, q = it % nq;
      const int gy = y0 + r, gx = x0 + 16 * q;
      if (gy >= p.Hp || gx >= p.Wp) continue;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (src && gy < p.H && gx < p.W) {
        v = *reinterpret_cast<const uint4*>(src + r * p.RP + 16 * q);
        const int nin = p.W - gx;  // in-image bytes of the store
        uint32_t keep[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int b = min(max(nin - 4 * k, 0), 4);
          keep[k] = b == 4 ? 0xffffffffu : (1u << (8 * b)) - 1u;
        }
        v.x &= keep[0]; v.y &= keep[1]; v.z &= keep[2]; v.w &= keep[3];
      }
      *reinterpret_cast<uint4*>(dst + size_t(gy) * p.Wp + gx) = v;
      if (occ && (v.x | v.y | v.z | v.w)) occ[(gy >> 1) * p.occ_w + (gx >> 7)] = 1;
    }
  } else {
    for (int it = threadIdx.x; it < p.TH * p.TW; it += kThreads) {
      const int r = it / p.TW, c = it % p.TW;
      const int gy = y0 + r, gx = x0 + c;
      if (gy >= p.Hp || gx >= p.Wp) continue;
      const uint8_t v = (src && gy < p.H && gx < p.W) ? src[r * p.RP + c] : 0;
      dst[size_t(gy) * p.Wp + gx] = v;
      if (occ && v) occ[(gy >> 1) * p.occ_w + (gx >> 7)] = 1;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
morph_group_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                   const int* __restrict__ table, uint8_t* __restrict__ occ,
                   const MorphParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* A = smem + kGuard;
  uint8_t* T = smem + p.buf + kGuard;
  uint8_t* O = smem + 2 * p.buf + kGuard;  // nbuf == 3 only
  int* tab = reinterpret_cast<int*>(smem + p.nbuf * p.buf);
  const int y0 = blockIdx.y * p.TH, x0 = blockIdx.x * p.TW;
  uint8_t* dst = out + size_t(blockIdx.z) * p.Hp * p.Wp;
  uint8_t* occ_f = occ ? occ + size_t(blockIdx.z) * (p.Hp / 2) * p.occ_w : nullptr;
  if (y0 >= p.H || x0 >= p.W) {  // a tile of the padding alone (padded_occ's grid)
    write_tile(dst, nullptr, nullptr, p, y0, x0);
    return;
  }
  for (int i = threadIdx.x; i < p.table_len; i += kThreads) tab[i] = table[i];
  // the region: rows y0 - Ry .., columns x0 - Rxa .. (16-byte aligned);
  // outside the image step 0's border value
  const int gy0 = y0 - p.Ry, gx0 = x0 - p.Rxa;
  const uint8_t* src = x + size_t(blockIdx.z) * p.H * p.W;
  const uint32_t fill = table[0] ? 0xffffffffu : 0u;
  uint32_t any = 0, nonbin = 0;  // over the image's bytes
  if (p.vin == 16) {  // W % 16 == 0: a 16-byte group lies wholly inside or outside
    const int nq = p.RP / 16, total = p.RH * nq;
    for (int base = threadIdx.x; base < total; base += 4 * kThreads) {  // four loads in flight
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int it = base + u * kThreads;
        const int gy = gy0 + it / nq, gx = gx0 + 16 * (it % nq);
        v[u] = make_uint4(fill, fill, fill, fill);
        if (it < total && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
          v[u] = *reinterpret_cast<const uint4*>(src + size_t(gy) * p.W + gx);
          any |= v[u].x | v[u].y | v[u].z | v[u].w;
          nonbin |= not_binary(v[u].x) | not_binary(v[u].y) | not_binary(v[u].z) |
                    not_binary(v[u].w);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int it = base + u * kThreads;
        if (it < total) *reinterpret_cast<uint4*>(A + (it / nq) * p.RP + 16 * (it % nq)) = v[u];
      }
    }
  } else {
    const int nw = p.RP / 4, total = p.RH * nw;
    for (int base = threadIdx.x; base < total; base += 4 * kThreads) {
      uint32_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int it = base + u * kThreads;
        const int gy = gy0 + it / nw, gx = gx0 + 4 * (it % nw);
        const bool row_in = it < total && gy >= 0 && gy < p.H;
        v[u] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          uint32_t byte = fill & 0xffu;
          if (row_in && gx + b >= 0 && gx + b < p.W) {
            byte = src[size_t(gy) * p.W + gx + b];
            any |= byte;
          }
          v[u] |= byte << (8 * b);
        }
        nonbin |= not_binary(v[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int it = base + u * kThreads;
        if (it < total) *reinterpret_cast<uint32_t*>(A + (it / nw) * p.RP + 4 * (it % nw)) = v[u];
      }
    }
  }
  const bool any_fg = __syncthreads_or(any != 0);  // also publishes A and the table
  const bool bin = !__syncthreads_or(nonbin != 0);
  if (p.skip_ok && !any_fg) {
    write_tile(dst, nullptr, nullptr, p, y0, x0);
    return;
  }
  if (bin) run_steps<true>(A, T, O, tab, p, gy0, gx0);
  else run_steps<false>(A, T, O, tab, p, gy0, gx0);
  write_tile(dst, occ_f, A + p.Ry * p.RP + p.Rxa, p, y0, x0);
}

// One step, one thread an output pixel of an (Hp, Wp) image (H, W unless
// padded), over global memory: the structuring elements whose single step
// fits no tile. Pixels outside the H x W input are 0; with occ,
// foreground sets its 2-row x 128-column block's byte.
template <bool kErode>
__global__ void __launch_bounds__(kThreads)
morph_step_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int H, int W,
                  const int* __restrict__ runs, int n, int Hp, int Wp,
                  uint8_t* __restrict__ occ) {
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

bool pad_ok(int H, int W, int Hp, int Wp, const uint8_t* occ) {
  return H > 0 && W > 0 && Hp >= H && Wp >= W &&
         (occ != nullptr || (Hp == H && Wp == W)) &&
         (occ == nullptr || (Hp % 2 == 0 && Wp % 128 == 0));
}

}  // namespace

// x (N,H,W) u8 -> out (N,H,W) u8, the blur of every frame, one launch.
// taps: ntaps (odd) non-negative ints on the device whose sum times 255
// fits in 16 bits, each at most 255 where dp != 0 (the caller, which made
// them, checks both); shift >= 1. tile_h a multiple of 8, tile_w of 16;
// smem_bytes is the host's layout (ops/wide.py::blur_smem), which must
// agree with BlurLayout. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int tpuva_blur_u8(const uint8_t* x, uint8_t* out, int N, int H, int W,
                             const int* taps, int ntaps, int shift, int tile_h, int tile_w,
                             int dp, int smem_bytes, void* stream) {
  if (!shape_ok(N, H, W) || 1LL * H * W >= (1LL << 31) || ntaps < 1 || ntaps % 2 == 0 ||
      shift < 1 || shift > 24 || tile_h < kSlide || tile_h % kSlide || tile_w < 16 ||
      tile_w % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const BlurLayout L(tile_h, tile_w, ntaps);
  if (L.total > kMaxSmem || L.total != smem_bytes) return static_cast<int>(cudaErrorInvalidValue);
  BlurParams p{};
  p.N = N; p.H = H; p.W = W; p.ntaps = ntaps; p.shift = shift;
  p.TH = tile_h; p.TW = tile_w;
  p.vin = (reinterpret_cast<uintptr_t>(x) % 16 == 0 && W % 16 == 0) ? 16 : 1;
  p.vout = (reinterpret_cast<uintptr_t>(out) % 16 == 0 && W % 16 == 0) ? 16 : 1;
  p.WH = int(L.WH); p.WW = int(L.WW); p.WP = int(L.WP); p.HP = int(L.HP);
  p.win = int(L.win); p.hs = int(L.hs); p.taps = int(L.taps); p.taps4 = int(L.taps4);
  p.taps2 = int(L.taps2); p.rowoff = int(L.rowoff); p.colidx = int(L.colidx);
  auto k = dp ? blur_tile_kernel<true> : blur_tile_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(W, tile_w), cdiv(H, tile_h), N);
  k<<<grid, kThreads, L.total, static_cast<cudaStream_t>(stream)>>>(x, out, taps, p);
  return static_cast<int>(cudaGetLastError());
}

// The same blur as two passes over global memory, for tap counts whose
// window fits no tile: rows is an (N,H,W) uint16 buffer for the row pass.
extern "C" int tpuva_blur_u8_global(const uint8_t* x, uint16_t* rows, uint8_t* out, int N,
                                    int H, int W, const int* taps, int ntaps, int shift,
                                    void* stream) {
  if (!shape_ok(N, H, W) || ntaps < 1 || ntaps % 2 == 0 || shift < 1 || shift > 24)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kThreads - 1) / kThreads, H, N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  blur_rows_kernel<<<grid, kThreads, 0, s>>>(x, rows, H, W, taps, ntaps);
  blur_cols_kernel<<<grid, kThreads, 0, s>>>(rows, out, H, W, taps, ntaps, shift);
  return static_cast<int>(cudaGetLastError());
}

// x (N,H,W) u8 -> out (N,Hp,Wp) u8: a group of nsteps erode or dilate
// steps, one launch. table (table_len int32 on the device, see run_steps)
// holds the steps' extents and row ranges; Ry, Rx the group's summed
// reach; skip_ok != 0 where every step's SE holds its anchor. tile_w a
// multiple of 16; nbuf 2 (every SE one extent) or 3; smem_bytes is the
// host's layout (ops/wide.py::morph_smem), which must agree with
// morph_smem here. out must not alias x. Unpadded, Hp = H, Wp = W and occ
// is null; K1's padded_occ mode passes Hp >= H even, Wp >= W a multiple of
// 128 and occ (N, Hp/2, Wp/128) u8, which the launch clears and the kernel
// sets. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tpuva_morph_u8(const uint8_t* x, uint8_t* out, int N, int H, int W,
                              const int* table, int table_len, int nsteps, int Ry, int Rx,
                              int skip_ok, int tile_h, int tile_w, int nbuf, int smem_bytes,
                              int Hp, int Wp, uint8_t* occ, void* stream) {
  if (!shape_ok(N, Hp, Wp) || !pad_ok(H, W, Hp, Wp, occ) || x == out || nsteps < 1 ||
      table_len < 4 * nsteps || Ry < 0 || Rx < 0 || tile_h < 1 || tile_w < 16 ||
      tile_w % 16 || (nbuf != 2 && nbuf != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  MorphParams p{};
  p.N = N; p.H = H; p.W = W; p.Hp = Hp; p.Wp = Wp;
  p.TH = tile_h; p.TW = tile_w; p.Ry = Ry; p.Rx = Rx; p.Rxa = (Rx + 15) / 16 * 16;
  long long RH, RP, buf;
  const long long total = morph_smem(tile_h, tile_w, Ry, p.Rxa, nbuf, table_len, &RH, &RP, &buf);
  if (total > kMaxSmem || total != smem_bytes) return static_cast<int>(cudaErrorInvalidValue);
  p.RH = int(RH); p.RP = int(RP); p.buf = int(buf);
  p.nsteps = nsteps; p.table_len = table_len; p.nbuf = nbuf; p.skip_ok = skip_ok ? 1 : 0;
  p.vin = (reinterpret_cast<uintptr_t>(x) % 16 == 0 && W % 16 == 0) ? 16 : 1;
  p.vout = (reinterpret_cast<uintptr_t>(out) % 16 == 0 && Wp % 16 == 0) ? 16 : 1;
  p.occ_w = occ ? Wp / 128 : 0;
  cudaError_t err = cudaFuncSetAttribute(morph_group_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (occ != nullptr &&
      (err = cudaMemsetAsync(occ, 0, size_t(N) * (Hp / 2) * (Wp / 128), s)) != cudaSuccess)
    return static_cast<int>(err);
  const dim3 grid(cdiv(Wp, tile_w), cdiv(Hp, tile_h), N);
  morph_group_kernel<<<grid, kThreads, total, s>>>(x, out, table, occ, p);
  return static_cast<int>(cudaGetLastError());
}

// One erode (erode != 0) or dilate step over global memory, for SEs whose
// step fits no tile: the SE's n runs on the device, int32 triples (dy, lo,
// hi), the pixels (dy, lo..hi) from the anchor; out, Hp, Wp and occ as
// tpuva_morph_u8's. Returns cudaGetLastError() after the launch.
extern "C" int tpuva_morph_step_u8(const uint8_t* x, uint8_t* out, int N, int H, int W,
                                   const int* runs, int n, int erode, int Hp, int Wp,
                                   uint8_t* occ, void* stream) {
  if (!shape_ok(N, Hp, Wp) || !pad_ok(H, W, Hp, Wp, occ) || n < 1 || x == out)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Wp + kThreads - 1) / kThreads, Hp, N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (occ != nullptr &&
      (err = cudaMemsetAsync(occ, 0, size_t(N) * (Hp / 2) * (Wp / 128), s)) != cudaSuccess)
    return static_cast<int>(err);
  if (erode)
    morph_step_kernel<true><<<grid, kThreads, 0, s>>>(x, out, H, W, runs, n, Hp, Wp, occ);
  else
    morph_step_kernel<false><<<grid, kThreads, 0, s>>>(x, out, H, W, runs, n, Hp, Wp, occ);
  return static_cast<int>(cudaGetLastError());
}
