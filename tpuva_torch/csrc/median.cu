// Exact k x k median of uint8 frames (kernel K7) for Hopper, sm_90a.
//
// Replaces tpuva/ops/filters.py::median_blur for k > 3 on uint8 frames:
// cv2.medianBlur's exact median with BORDER_REPLICATE. On the TPU it is
// XLA code, not a Pallas kernel: jnp.sort over the stacked k*k window axis
// (:208; the 19-op network _median9 for k = 3, :239). The port's plain
// version, tpuva_torch/ops/filters.py::median_u8_plain, does the same with
// torch.sort over chunks of frames; the kernel is bit-equal to it (a
// median of integers has one answer). Every odd k from 3 up is taken (to
// about 40,000, where a CTA's staged rows leave shared memory).
//
// k = 3, 5, 7, 9: median_net_kernel. A CTA owns 128 columns of two bands
// of rows of one frame (blockIdx.z) and stages them with a halo of
// r = k / 2 into shared memory as 32-bit words of two 16-bit lanes, the
// same pixel of each band (byte p held as p << 8 | p; one byte_perm a
// word). Staging reads 16-byte pieces of a row; only pieces that cross
// the frame's left or right edge, or rows that are not 16-byte aligned,
// read byte by byte with clamped columns, and a row clamps once a piece
// (BORDER_REPLICATE: frames smaller than the window and one-row frames
// included). No integer division a byte. A thread then loads the input
// words of a block of MedianNet<k>::kBX x kBY outputs (16-byte shared
// loads) and runs the block's network, generated by
// tpuva_torch/ops/median.py::median_network into median_net.h: Adams's
// separable sorting network (ACM TOG 40(4), 2021) of min and max only, so
// it gives the exact median with ties by construction. Each input column
// is sorted once for the block's rows, the rows two outputs share sorted
// once; the k sorted columns of each output are merged (Batcher) with
// the merges of the columns neighbouring outputs share done once, and
// every merge only over the positions that can still reach rank k*k / 2.
// A min or max is one VIMNMX.U16 (__vminu2/__vmaxu2) on both lanes, a
// single-use chain of two one VIMNMX3.U16 (__vimin3_u16x2/__vimax3_u16x2).
// The results leave as bytes, four columns gathered into a 32-bit store.
//
// Operations a pixel (ops/median.py::network_ops_per_px: the network's
// instructions over 2 lanes, plus shared loads, staging and stores):
//   k = 3: 17.25 comparisons, 7.6 + 2.5 = 10.2 instructions
//   k = 5: 63.75 comparisons, 29.9 + 2.9 = 32.7
//   k = 7: 148.5 comparisons, 70.3 + 3.5 = 73.7
//   k = 9: 330.0 comparisons, 157.3 + 5.0 = 162.3
// against the radix select's 16 k^2 (144, 400, 784, 1296) that this
// tier replaced.
//
// What bounds it on an H100: one byte read and one written a pixel, 0.317
// ms for a 256-frame 1080p batch at 3.35 TB/s; the instructions, which
// issue to the 64 INT32 lanes an SM (132 SMs at 1.98 GHz, 16.7 T/s; a
// VIMNMX.U16 takes one lane-slot, a VIMNMX3.U16 two): 1.04 ms at k = 5 and
// 2.34 at k = 7 for that batch. So it is bound by its operations. Its
// registers set the CTAs an SM: 128 threads a CTA and launch bounds of
// 10, 5, 2 and 3 CTAs an SM at k = 3, 5, 7, 9 (MedianNet<k>::kThreads,
// kMinBlocks; the most that spill nothing), so that one CTA's staging
// overlaps other CTAs' networks.
//
// k >= 11: median_hist_kernel, Huang's vertical sliding histogram (IEEE
// TASSP 27(1), 1979). A thread owns one output column of a strip of S rows
// of one frame (a CTA 128 columns of a strip, 64 with 32-bit counts;
// blockIdx.z the frame) and keeps its window's 256-bin histogram in shared
// memory. Stepping down
// a row it removes the k pixels of the row that leaves the window and adds
// the k of the row that enters: 2k updates a pixel where the radix select
// it replaced counted the k*k window 8 times (16 k^2 operations). Rows and
// columns clamp into the frame (BORDER_REPLICATE, frames below the window
// included); a strip starts by adding its first window's k rows.
// - Counts: 8-bit up to k = 15 (k^2 <= 255), 16-bit up to k = 255, 32-bit
//   past that. A value's removal precedes its successor's addition, so no
//   count passes k^2 even mid-row. Bin b of the threads is laid out
//   [b][word column][lane]: the 32 lanes of a warp in 32 distinct banks,
//   whatever bins they hit; the counts of 4 / sizeof(count) warps share a
//   word (never two lanes of one warp), updated by a 32-bit shared atomic
//   add of the warp's count shifted into its place (red.shared: no
//   returned value, so no wait; its address one shift-add from the pixel
//   on the shared window), read by a narrow load.
// - The median is tracked, not searched: m, lt = #(window < m), its
//   16-bin coarse block c = m >> 4 and lc = #(window < 16 c); 16 coarse
//   counts (one per 16 bins) beside the fine ones. lt and lc move by sums
//   of absolute byte differences of the rows' words (VABSDIFF4, two a
//   word and threshold), not by a compare an update. After a row, m
//   walks: inside its block bin by bin, else block by block to the
//   median's block, then bin by bin from its start: at most 15 + 15 moves
//   whatever the frame (a 0/255 frame moves the median by 255 in a row).
// - Rows staged once a CTA: a step's entering and leaving rows (the CTA's
//   columns plus a halo rounded up to 16 bytes each side) in shared memory,
//   16-byte loads where they lie inside an aligned row, bytes with clamped
//   columns elsewhere; double buffered, the next step's pieces loaded into
//   registers before the step's updates and stored after them, one
//   barrier a step. A thread reads its k pixels of a row as words
//   (funnel-shifted to its window's start): no halo in shared memory, so
//   no k limit past shared memory's rows of 4 x (columns + k).
// - Strips (ops/median.py::hist_plan): S = 8k rows, so that filling the
//   first window (k^2 updates) adds 1/16 to a strip's 2k a row, but no
//   more rows than leave every SM a CTA (132 on an H100) for the frames
//   and column blocks of the call (N = 1 at 1080p included).
// What bounds it: one byte read and one written a pixel, 0.317 ms a
// 256-frame 1080p batch, against 2k updates a pixel; each update is four
// integer instructions (a byte permute, the two addresses) and two shared
// atomics (fine and coarse), plus 1.5 a value for lt and lc, so its issue,
// not the bytes, is its limit, and with it the latency of its chains
// (pixel load, address, atomic; a count read a walk step): the counts'
// shared memory sets 24 warps an SM with 8-bit counts, 12 with 16-bit.
// Giving a thread 2 or 4 adjacent columns (one atomic counting a pixel
// into every window of the thread's that holds it) issues fewer
// instructions but leaves 6-12 warps an SM, and ran slower.

#include <cstdint>
#include <cuda_runtime.h>

#include "median_net.h"  // generated: tpuva_torch/ops/median.py::network_header

namespace {

constexpr int kMaxSmem = 227 * 1024;
// the least k of the histogram tier; the networks take the odd k below it
constexpr int kHistMinK = 11;

constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---- k = 3, 5, 7, 9: the selection network on packed pixels ----

// Two pixels a 32-bit word, one in each 16-bit lane, a byte p held as
// p << 8 | p (monotone in p): lane 0 from a row of the CTA's upper band,
// lane 1 from the same row of its lower band. Op is what the generated
// networks (median_net.h) call.
struct U16x2 {
  static __device__ __forceinline__ uint32_t mn(uint32_t a, uint32_t b) { return __vminu2(a, b); }
  static __device__ __forceinline__ uint32_t mx(uint32_t a, uint32_t b) { return __vmaxu2(a, b); }
  static __device__ __forceinline__ uint32_t mn3(uint32_t a, uint32_t b, uint32_t c) {
    return __vimin3_u16x2(a, b, c);
  }
  static __device__ __forceinline__ uint32_t mx3(uint32_t a, uint32_t b, uint32_t c) {
    return __vimax3_u16x2(a, b, c);
  }
  // byte i of a (lane 0) and of b (lane 1), each doubled into its lane
  static __device__ __forceinline__ uint32_t pack(uint32_t a, uint32_t b, int i) {
    return __byte_perm(a, b, i * 0x11 + (i + 4) * 0x1100);
  }
};

// threadIdx.x (I = 0), blockIdx.x, .y, .z (I = 1, 2, 3), read by a volatile
// move so that the compiler reads it again instead of keeping an earlier
// read live in a register
template <int I>
__device__ __forceinline__ int special_reg() {
#ifdef __CUDA_ARCH__
  int r;
  if constexpr (I == 0) asm volatile("mov.u32 %0, %%tid.x;" : "=r"(r));
  if constexpr (I == 1) asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(r));
  if constexpr (I == 2) asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(r));
  if constexpr (I == 3) asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(r));
  return r;
#else
  return I == 0 ? threadIdx.x : I == 1 ? blockIdx.x : I == 2 ? blockIdx.y : blockIdx.z;
#endif
}

// The CTA geometry of window K with THREADS threads: TX x TY threads,
// each with a block of MedianNet<K>'s kBX x kBY outputs in each band; the
// staged tile, SROWS rows of PITCH words, word (i, j) holding the pixels
// (y0 - R + i, x0 - R + j) and (y0 + BAND - R + i, x0 - R + j).
template <int K, int THREADS = MedianNet<K>::kThreads>
struct NetTile {
  using Net = MedianNet<K>;
  static constexpr int R = K / 2;
  static constexpr int TX = kNetTileW / Net::kBX, TY = THREADS / TX;
  static constexpr int BAND = TY * Net::kBY;  // rows of a band
  static constexpr int SROWS = BAND + 2 * R;
  static constexpr int PITCH = (kNetTileW - Net::kBX + Net::kCols + 3) / 4 * 4;
  static constexpr int CHUNKS = kNetTileW / 16 + 2;  // 16-byte pieces of [x0 - 16, x0 + 144)
  static_assert(kNetTileW % Net::kBX == 0 && Net::kBX % 4 == 0 && R <= 16, "tile shape");
  static_assert(PITCH >= kNetTileW + 2 * R, "a staged row holds the halo");
};

template <int K, int THREADS = MedianNet<K>::kThreads,
          int MIN_BLOCKS = MedianNet<K>::kMinBlocks>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
median_net_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int H, int W,
                  int load16, int store4) {
  using T = NetTile<K, THREADS>;
  using Net = typename T::Net;
  constexpr int R = T::R, P = T::PITCH;
  __shared__ __align__(16) uint32_t s[T::SROWS * P];
  const int x0 = blockIdx.x * kNetTileW, y0 = blockIdx.y * 2 * T::BAND;
  const long long plane = (long long)H * W;
  const uint8_t* frame = x + blockIdx.z * plane;
  // Stage: a 16-byte piece of a row of each band a step. Rows clamp once a
  // piece; only pieces that cross the frame's left or right edge (or any,
  // when rows are not 16-byte aligned) read byte by byte with clamped
  // columns (BORDER_REPLICATE).
  for (int item = threadIdx.x; item < T::SROWS * T::CHUNKS; item += THREADS) {
    const int i = item / T::CHUNKS, c = item - i * T::CHUNKS;
    const uint8_t* ra = frame + (long long)min(max(y0 - R + i, 0), H - 1) * W;
    const uint8_t* rb = frame + (long long)min(max(y0 + T::BAND - R + i, 0), H - 1) * W;
    const int gx = x0 - 16 + 16 * c;
    uint32_t a[4], b[4];
    if (load16 && gx >= 0 && gx + 16 <= W) {
      const uint4 va = __ldg(reinterpret_cast<const uint4*>(ra + gx));
      const uint4 vb = __ldg(reinterpret_cast<const uint4*>(rb + gx));
      a[0] = va.x, a[1] = va.y, a[2] = va.z, a[3] = va.w;
      b[0] = vb.x, b[1] = vb.y, b[2] = vb.z, b[3] = vb.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = b[q] = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int xx = min(max(gx + 4 * q + t, 0), W - 1);
          a[q] |= uint32_t(ra[xx]) << (8 * t);
          b[q] |= uint32_t(rb[xx]) << (8 * t);
        }
      }
    }
    const int j0 = 16 * c - 16 + R;  // staged column of the piece's first byte
    uint32_t* row = s + i * P;
#pragma unroll
    for (int t = 0; t < 16; ++t)
      if (j0 + t >= 0 && j0 + t < P) row[j0 + t] = U16x2::pack(a[t / 4], b[t / 4], t % 4);
  }
  __syncthreads();
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
  const int ox = x0 + tx * Net::kBX, oy = y0 + ty * Net::kBY;
  if (ox >= W || oy >= H) return;
  // the block's input words: 16-byte loads, then an 8- and a 4-byte one
  // for the rest of a row (a row starts 16-byte aligned)
  constexpr int C = Net::kCols, C4 = C / 4 * 4;
  uint32_t v[Net::kRows][C];
  const uint32_t* src = s + ty * Net::kBY * P + tx * Net::kBX;
#pragma unroll
  for (int i = 0; i < Net::kRows; ++i) {
    const uint32_t* row = src + i * P;
#pragma unroll
    for (int j = 0; j < C4; j += 4) {
      const uint4 w = *reinterpret_cast<const uint4*>(row + j);
      v[i][j] = w.x, v[i][j + 1] = w.y, v[i][j + 2] = w.z, v[i][j + 3] = w.w;
    }
    if constexpr (C - C4 >= 2) {
      const uint2 w = *reinterpret_cast<const uint2*>(row + C4);
      v[i][C4] = w.x, v[i][C4 + 1] = w.y;
    }
    if constexpr (C % 2) v[i][C - 1] = row[C - 1];
  }
  uint32_t o[Net::kBY][Net::kBX];
  Net::template run<U16x2, C>(v, o);
  // The output block's place, from the thread and block indices read anew:
  // nothing of the staging stays live in registers across the network.
  const int tid = special_reg<0>(), bz = special_reg<3>();
  const int px = special_reg<1>() * kNetTileW + tid % T::TX * Net::kBX;
  const int py = special_reg<2>() * 2 * T::BAND + tid / T::TX * Net::kBY;
  // Each band's bytes: lane 0 is byte 0 of a word, lane 1 byte 2; four
  // columns gathered into one 32-bit store where they lie in the frame.
#pragma unroll
  for (int band = 0; band < 2; ++band)
#pragma unroll
    for (int t = 0; t < Net::kBY; ++t) {
      const int y = py + band * T::BAND + t;
      if (y >= H) continue;
      uint8_t* dst = out + bz * (long long)H * W + (long long)y * W + px;
#pragma unroll
      for (int c = 0; c < Net::kBX; c += 4) {
        const int sel = band ? 0x62 : 0x40;
        const uint32_t lo = __byte_perm(o[t][c], o[t][c + 1], sel);
        const uint32_t hi = __byte_perm(o[t][c + 2], o[t][c + 3], sel);
        const uint32_t w4 = __byte_perm(lo, hi, 0x5410);
        if (store4 && px + c + 4 <= W) {
          *reinterpret_cast<uint32_t*>(dst + c) = w4;
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (px + c + b < W) dst[c + b] = static_cast<uint8_t>(w4 >> (8 * b));
        }
      }
    }
}

// ---- k >= 11: the sliding histogram ----

// The histograms of a CTA of T threads, counts of type C: 256 fine bins
// and 16 coarse ones (bin 256 + b counts the values of fine bins 16 b to
// 16 b + 15), bin b's counts of every thread at b * kStride bytes, laid
// out [word column][lane]: a word holds the counts of kPerWord warps, the
// same lane of each, so a warp's 32 lanes touch 32 banks whatever bins
// they hit.
template <class C, int T>
struct Hist {
  static constexpr int kPerWord = 4 / sizeof(C);
  static constexpr int kColumns = T / 32 / kPerWord;  // words a bin for each lane
  static constexpr int kShift = kColumns == 1 ? 7 : kColumns == 2 ? 8 : kColumns == 4 ? 9 : 0;
  static constexpr int kStride = 1 << kShift;         // bytes a bin
  static constexpr int kBytes = 272 * kStride;
  static_assert(kShift > 0 && kColumns * 128 == kStride, "word columns a power of two");
};

// threads a CTA for counts of `bytes` bytes (ops/median.py::hist_plan)
constexpr int hist_threads(int bytes) { return bytes == 4 ? 64 : 128; }

// A shared atomic add that returns nothing (ATOMS.ADD with no result),
// at a shared-window address: the address is one multiply-add from a
// pixel, with no generic pointer's base added to each.
__device__ __forceinline__ void shared_add(uint32_t addr, uint32_t v) {
#ifdef __CUDA_ARCH__
  asm volatile("red.shared.add.u32 [%0], %1;" ::"r"(addr), "r"(v));
#else
  atomicAdd(static_cast<uint32_t*>(__cvta_shared_to_generic(addr)), v);
#endif
}

// p >> 4 as one shift that the compiler cannot fold into the shift-add of
// a coarse address (it would make that a shift, a mask and an add)
__device__ __forceinline__ uint32_t high_nibble(uint32_t p) {
#ifdef __CUDA_ARCH__
  uint32_t q;
  asm("shr.b32 %0, %1, 4;" : "=r"(q) : "r"(p));
  return q;
#else
  return p >> 4;
#endif
}

// Orders the shared atomics before the count reads that follow it.
__device__ __forceinline__ void compiler_fence() { asm volatile("" ::: "memory"); }

// One thread's window: its counts in the CTA's histograms, the median m,
// its coarse block c = m >> 4, lt = #(window < m) and lc = #(window < 16 c).
template <class C, int T>
struct Window {
  using L = Hist<C, T>;
  uint8_t* hist;
  uint32_t fine0, coarse0;  // the thread's word in fine bin 0 and in coarse bin 0
                            // (shared-window addresses)
  uint32_t rb, inc;         // its count's byte in bin 0, its count's unit in a word
  uint32_t m = 0, c = 0, lt = 0, lc = 0;
  // m, m - 1, 16 c and 16 c - 1 (0 for 0) in every byte of a word
  uint32_t m4 = 0, m4p = 0, c4 = 0, c4p = 0;

  __device__ __forceinline__ Window(uint8_t* h, int warp, int lane) : hist(h) {
    const uint32_t tb = ((warp / L::kPerWord) * 32 + lane) * 4;
    fine0 = static_cast<uint32_t>(__cvta_generic_to_shared(h)) + tb;
    coarse0 = fine0 + 256 * L::kStride;
    rb = tb + (warp % L::kPerWord) * sizeof(C);
    inc = 1u << (8 * sizeof(C) * (warp % L::kPerWord));
  }
  // byte B of v into (ADD) or out of the window: its fine and coarse
  // counts, a shared atomic add each (a byte permute, a shift-add for
  // the fine address, a shift and a shift-add for the coarse one)
  template <int B, bool ADD>
  __device__ __forceinline__ void update(uint32_t v) {
    const uint32_t p = __byte_perm(v, 0u, 0x4440u + B);
    const uint32_t d = ADD ? inc : 0u - inc;
    shared_add(fine0 + (p << L::kShift), d);
    shared_add(coarse0 + (high_nibble(p) << L::kShift), d);
  }
  template <bool REMOVE>
  __device__ __forceinline__ void word(uint32_t out, uint32_t in) {
    if (REMOVE) update<0, false>(out);
    update<0, true>(in);
    if (REMOVE) update<1, false>(out);
    update<1, true>(in);
    if (REMOVE) update<2, false>(out);
    update<2, true>(in);
    if (REMOVE) update<3, false>(out);
    update<3, true>(in);
  }
  // a row step: the k pixels of the window's columns of the staged rows
  // `in` and (REMOVE) `out`, from byte sh / 8 of their first words on. A
  // word's bytes below t number (SAD(v, t) - SAD(v, t - 1) + 4) / 2 (SAD:
  // the sum of the bytes' distances to t, __vsadu4), so lt and lc move
  // by half the SADs of the entering words less the leaving words' at m
  // and m - 1, 16 c and 16 c - 1. Filling a window (no REMOVE) leaves m
  // and c at 0, and lt and lc at 0.
  template <bool REMOVE>
  __device__ __forceinline__ void step(const uint32_t* in, const uint32_t* out, int k,
                                       uint32_t sh) {
    uint32_t i0 = in[0], o0 = REMOVE ? out[0] : 0u;
    uint32_t up = 0, down = 0, cup = 0, cdown = 0;
    auto count = [&](uint32_t iv, uint32_t ov) {
      up += __vsadu4(iv, m4) + __vsadu4(ov, m4p);
      down += __vsadu4(iv, m4p) + __vsadu4(ov, m4);
      cup += __vsadu4(iv, c4) + __vsadu4(ov, c4p);
      cdown += __vsadu4(iv, c4p) + __vsadu4(ov, c4);
    };
    int j = 0;
    for (; j + 4 <= k; j += 4) {
      const uint32_t i1 = in[j / 4 + 1], o1 = REMOVE ? out[j / 4 + 1] : 0u;
      const uint32_t iv = __funnelshift_r(i0, i1, sh), ov = __funnelshift_r(o0, o1, sh);
      i0 = i1, o0 = o1;
      word<REMOVE>(ov, iv);
      if (REMOVE) count(iv, ov);
    }
    // k is odd: 1 or 3 bytes left, the others zero in both words
    const uint32_t keep = k - j == 3 ? 0xffffffu : 0xffu;
    const uint32_t iv = __funnelshift_r(i0, in[j / 4 + 1], sh) & keep;
    const uint32_t ov = REMOVE ? __funnelshift_r(o0, out[j / 4 + 1], sh) & keep : 0u;
    if (REMOVE) update<0, false>(ov);
    update<0, true>(iv);
    if (k - j == 3) {
      if (REMOVE) update<1, false>(ov);
      update<1, true>(iv);
      if (REMOVE) update<2, false>(ov);
      update<2, true>(iv);
    }
    if (REMOVE) {
      count(iv, ov);
      lt += static_cast<int>(up - down) / 2;
      lc += static_cast<int>(cup - cdown) / 2;
    }
    compiler_fence();
  }
  __device__ __forceinline__ uint32_t fine(uint32_t b) const {
    return *reinterpret_cast<const C*>(hist + (b << L::kShift) + rb);
  }
  __device__ __forceinline__ uint32_t coarse(uint32_t b) const {
    return *reinterpret_cast<const C*>(hist + ((256u + b) << L::kShift) + rb);
  }
  // m to the window's median, the least m with #(< m) <= rank < #(<= m):
  // inside m's block bin by bin; else block by block to the median's
  // block, then bin by bin from its first bin (at most 15 + 15 moves)
  __device__ __forceinline__ void walk(uint32_t rank) {
    if (lt > rank) {
      if (lc > rank) {
        do {
          --c;
          lc -= coarse(c);
        } while (lc > rank);
        m = 16 * c, lt = lc;
        for (uint32_t h; lt + (h = fine(m)) <= rank; ++m) lt += h;
      } else {
        do {
          --m;
          lt -= fine(m);
        } while (lt > rank);
      }
    } else {
      const uint32_t h = fine(m);
      if (lt + h <= rank) {
        const uint32_t hc = lc + coarse(c);
        if (hc <= rank) {
          lc = hc, ++c;
          for (uint32_t g; lc + (g = coarse(c)) <= rank; ++c) lc += g;
          m = 16 * c, lt = lc;
        } else {
          lt += h, ++m;
        }
        for (uint32_t g; lt + (g = fine(m)) <= rank; ++m) lt += g;
      }
    }
    m4 = m * 0x01010101u, m4p = (m ? m - 1 : 0) * 0x01010101u;
    c4 = 16 * c * 0x01010101u, c4p = (c ? 16 * c - 1 : 0) * 0x01010101u;
  }
};


// 16 bytes of row y (clamped) from column gx on: one 16-byte load where the
// piece lies inside a row that allows it, else bytes with clamped columns
// (BORDER_REPLICATE)
__device__ __forceinline__ uint4 row_piece(const uint8_t* __restrict__ frame, int H, int W,
                                           int y, int gx, int load16) {
  const uint8_t* row = frame + (long long)min(max(y, 0), H - 1) * W;
  if (load16 && gx >= 0 && gx + 16 <= W) return __ldg(reinterpret_cast<const uint4*>(row + gx));
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) w[q] |= uint32_t(row[min(max(gx + 4 * q + b, 0), W - 1)]) << (8 * b);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A CTA: T columns (x0 on) of a strip of S rows (y0 on) of frame
// blockIdx.z. Step i adds row y0 - r + i and, from i = k on, removes row
// y0 - r + i - k; after step k - 1 + s the window is output row y0 + s's.
// Shared memory: the histograms, then two buffers of the staged entering
// and leaving rows, BW bytes each: staged byte j is column x0 - R16 + j.
template <class C, int T>
__global__ void __launch_bounds__(T)
median_hist_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int H, int W,
                   int k, int S, int load16) {
  using L = Hist<C, T>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int r = k / 2, R16 = (r + 15) / 16 * 16, P = T / 16 + R16 / 8, BW = 16 * P + 16;
  uint8_t* rows = smem + L::kBytes;
  const int t = threadIdx.x;
  const int x0 = blockIdx.x * T, y0 = blockIdx.y * S, y1 = min(y0 + S, H);
  const long long plane = (long long)H * W;
  const uint8_t* frame = x + blockIdx.z * plane;
  uint8_t* oframe = out + blockIdx.z * plane;
  const int nsteps = k + (y1 - y0) - 1;
  // step i's pieces: P of the entering row, then P of the leaving one
  auto items = [&](int i) { return i >= k ? 2 * P : P; };
  auto piece = [&](int i, int j) {
    return row_piece(frame, H, W, j < P ? y0 - r + i : y0 - r + i - k,
                     x0 - R16 + 16 * (j < P ? j : j - P), load16);
  };
  auto put = [&](int i, int j, uint4 v) {
    *reinterpret_cast<uint4*>(rows + ((i & 1) * 2 + (j >= P)) * BW + 16 * (j < P ? j : j - P)) = v;
  };
  for (int i = t; i < L::kBytes / 16; i += T)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int j = t; j < items(0); j += T) put(0, j, piece(0, j));
  __syncthreads();
  Window<C, T> win(smem, t / 32, t % 32);
  const uint32_t rank = uint32_t(k) * uint32_t(k) / 2;
  const int o = R16 - r + t;  // the thread's window's first byte in a staged row
  const uint32_t sh = 8 * (o & 3);
  const bool active = x0 + t < W;
  for (int i = 0; i < nsteps; ++i) {
    // the next step's first pieces in flight during this step's updates
    const bool more = i + 1 < nsteps, pre = more && t < items(i + 1);
    uint4 next;
    if (pre) next = piece(i + 1, t);
    if (active) {
      const uint32_t* in = reinterpret_cast<const uint32_t*>(rows + (i & 1) * 2 * BW) + o / 4;
      const uint32_t* leave = in + BW / 4;
      if (i >= k) {
        win.template step<true>(in, leave, k, sh);
      } else {
        win.template step<false>(in, leave, k, sh);
      }
      if (i >= k - 1) {
        win.walk(rank);
        oframe[(long long)(y0 + i - k + 1) * W + x0 + t] = static_cast<uint8_t>(win.m);
      }
    }
    if (more) {
      if (pre) put(i + 1, t, next);
      for (int j = t + T; j < items(i + 1); j += T) put(i + 1, j, piece(i + 1, j));
    }
    __syncthreads();
  }
}

// The histogram tier's launch for N frames of H x W, window k, on a card of
// `sms` SMs: count bytes, threads a CTA, strip rows, shared bytes a CTA
// (ops/median.py::hist_plan computes the same)
struct HistPlan {
  int bytes, threads, strip, smem;
};

HistPlan hist_plan(int N, int H, int W, int k, int sms) {
  const long long kk = (long long)k * k;
  HistPlan p;
  p.bytes = kk <= 255 ? 1 : kk <= 65535 ? 2 : 4;
  p.threads = hist_threads(p.bytes);
  // strips a frame that leave every SM a CTA; no strip above 8k rows
  const long long ctas = (long long)cdiv(W, p.threads) * (N < 65535 ? N : 65535);
  const long long want = (sms + ctas - 1) / ctas;
  const int strips = static_cast<int>(want < H ? want : H);
  p.strip = max(1, min(8 * k, cdiv(H, strips)));
  const int r16 = (k / 2 + 15) / 16 * 16;
  p.smem = 272 * 128 * (p.bytes == 1 ? 1 : 2) + 4 * (p.threads + 2 * r16 + 16);
  return p;
}

template <class C>
cudaError_t launch_hist(const uint8_t* x, uint8_t* out, int N, int H, int W, int k,
                        const HistPlan& p, cudaStream_t s) {
  constexpr int T = hist_threads(sizeof(C));
  static_assert(Hist<C, T>::kBytes == 272 * 128 * (sizeof(C) == 1 ? 1 : 2), "hist_plan's bytes");
  if (p.smem > kMaxSmem || cdiv(H, p.strip) > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(median_hist_kernel<C, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  const int load16 = W % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long plane = (long long)H * W;
  for (int n0 = 0; n0 < N; n0 += 65535) {
    const dim3 grid(cdiv(W, T), cdiv(H, p.strip), N - n0 < 65535 ? N - n0 : 65535);
    median_hist_kernel<C, T><<<grid, T, p.smem, s>>>(x + n0 * plane, out + n0 * plane, H, W, k,
                                                     p.strip, load16);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// CTAs an SM of the kernel for counts C at plan p's shared memory
template <class C>
cudaError_t hist_occupancy(const HistPlan& p, int* blocks) {
  const auto kernel = median_hist_kernel<C, hist_threads(sizeof(C))>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, p.threads, p.smem);
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

cudaError_t median_hist(const uint8_t* x, uint8_t* out, int N, int H, int W, int k,
                        cudaStream_t s) {
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorNoDevice;
  const HistPlan p = hist_plan(N, H, W, k, sms);
  switch (p.bytes) {
    case 1: return launch_hist<uint8_t>(x, out, N, H, W, k, p, s);
    case 2: return launch_hist<uint16_t>(x, out, N, H, W, k, p, s);
    default: return launch_hist<uint32_t>(x, out, N, H, W, k, p, s);
  }
}

bool valid(const uint8_t* x, const uint8_t* out, int N, int H, int W, int k) {
  return N > 0 && H > 0 && W > 0 && k >= 3 && k % 2 == 1 && k <= 65535 && x != out;
}

// One launch of the network kernel for window K per 65535 frames.
template <int K, int THREADS = MedianNet<K>::kThreads,
          int MIN_BLOCKS = MedianNet<K>::kMinBlocks>
cudaError_t launch_net(const uint8_t* x, uint8_t* out, int N, int H, int W, cudaStream_t s) {
  using T = NetTile<K, THREADS>;
  const int load16 = W % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int store4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const long long plane = (long long)H * W;
  if (cdiv(H, 2 * T::BAND) > 65535) return cudaErrorInvalidValue;
  for (int n0 = 0; n0 < N; n0 += 65535) {
    const dim3 grid(cdiv(W, kNetTileW), cdiv(H, 2 * T::BAND), N - n0 < 65535 ? N - n0 : 65535);
    median_net_kernel<K, THREADS, MIN_BLOCKS><<<grid, THREADS, 0, s>>>(
        x + n0 * plane, out + n0 * plane, H, W, load16, store4);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// x (N,H,W) u8 -> out (N,H,W) u8, the k x k median of every frame with
// BORDER_REPLICATE; k odd, 3 or more: k <= 9 by the selection networks,
// larger k by the sliding histogram (up to the k whose staged rows fit
// shared memory, about 40,000). out must not alias x. Returns
// cudaGetLastError() after the launches (0 = launched): one launch, or one
// a 65535 frames past that.
extern "C" int tpuva_median_u8(const uint8_t* x, uint8_t* out, int N, int H, int W, int k,
                               void* stream) {
  if (!valid(x, out, N, H, W, k)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k >= kHistMinK) return static_cast<int>(median_hist(x, out, N, H, W, k, s));
  switch (k) {
    case 3: return static_cast<int>(launch_net<3>(x, out, N, H, W, s));
    case 5: return static_cast<int>(launch_net<5>(x, out, N, H, W, s));
    case 7: return static_cast<int>(launch_net<7>(x, out, N, H, W, s));
    case 9: return static_cast<int>(launch_net<9>(x, out, N, H, W, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The histogram tier for any odd k from 3 (the crossover with the
// networks is timed with it); otherwise as tpuva_median_u8.
extern "C" int tpuva_median_hist_u8(const uint8_t* x, uint8_t* out, int N, int H, int W, int k,
                                    void* stream) {
  if (!valid(x, out, N, H, W, k)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(median_hist(x, out, N, H, W, k, static_cast<cudaStream_t>(stream)));
}

// The histogram tier's plan on the current card, into out[7]: count
// bytes, threads a CTA, strip rows, shared bytes a CTA, the card's SMs,
// CTAs an SM (the occupancy calculator's, at that shared memory) and
// kHistMinK. Returns a CUDA error code.
extern "C" int tpuva_median_hist_plan(int N, int H, int W, int k, int* out) {
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorNoDevice);
  const HistPlan p = hist_plan(N, H, W, k, sms);
  int blocks = 0;
  const cudaError_t err = p.smem > kMaxSmem ? cudaErrorInvalidValue
                          : p.bytes == 1  ? hist_occupancy<uint8_t>(p, &blocks)
                          : p.bytes == 2  ? hist_occupancy<uint16_t>(p, &blocks)
                                          : hist_occupancy<uint32_t>(p, &blocks);
  const int v[7] = {p.bytes, p.threads, p.strip, p.smem, sms, blocks, kHistMinK};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return static_cast<int>(err);
}
