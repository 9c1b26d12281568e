// The TPU micro-probes P1-P4 for Hopper, sm_90a.
//
// Replace the pallas_call of each of the four micro-probes under bench/:
//   P1 tpuva_probe_repos: bench/repos_probe.py:51 bench_case, on the
//      (152, 1920) raw window: i32 add; static, dynamic (r % 152) and
//      dynamic-uniform axis-0 roll + add; f32 cast-hop f -> i32 -> f + 1;
//      f32 static roll + add;
//   P2 tpuva_probe_roll: bench/roll_probe.py:50 bench_body, (112, 1152)
//      f32, each rep body(f) + 1e-7: add, mul, rolls on either axis, roll +
//      add, an unaligned slice shift, the k = 5 two-axis cascade x 2^-8;
//   P3 tpuva_probe_i16: bench/i16_probe.py:40 make_cascade, (112, 1152),
//      the 16-op k = 5 cascade in f32, i32, i16 or u16, then the rescale;
//   P4 tpuva_probe_cell: bench/cell_probe.py:62 make, (80, 512) int32,
//      roll + min sweeps on the full height or on 2-row cells.
// Each entry point takes (x, out, reps, case, stream) and runs `reps` reps
// of the case's body on one tile, bit for bit as the JAX probe: roll(f, s,
// axis) is jnp.roll (out[i] = f[(i - s) mod n]), float adds and products
// round once each (__fadd_rn, __fmul_rn, built with --fmad=false), float
// -> int32 is cvt.rzi (toward zero, saturating, NaN -> 0, as XLA), and the
// u8 output is the int32's low byte. The plain PyTorch versions are
// tpuva_torch/probes/*_probe.py::plain.
//
// What the probes time, and so what the design must keep: every rep does
// its operations (no closed form: the elementwise cases pass each value
// through an empty asm statement a rep, so the compiler cannot fold the
// loop), and the tile stays on the chip across reps, as in the TPU's VMEM.
// A tile of 32-bit words is too large for one CTA's 227 KB (P1 1,167,360
// B, P2 and P3 516,096 B), so it is split over CTAs, one an SM. P1's roll
// cases band it by columns (8 CTAs of 240 columns, 145,920 B each), so an
// axis-0 roll stays in its CTA's shared memory (its section below). P2 and
// P3 hold row bands in registers and trade halo rows over a 4-CTA cluster,
// P3's four cases on P2's cascade code (their sections below). The cases
// with no exchange (i32 add, the cast-hop, f+f, the multiply) keep their
// words in registers for all reps. P4's (80, 512) tile, 163,840 B, lies in
// the registers of one CTA, a block of 10 x 4 words a thread, its 2-row
// cells inside a thread (its section below). The compared cases keep their
// words in registers without spilling in the rep loop (P3's 32-bit and
// packed cascades, P4's sweeps), so that a ratio of their times is one of
// words, operations and exchanges alone.
//
// Bound: the larger of the operations (reps x ops x elements) on the 1-8
// SMs a probe uses and the chain of a rep's dependent operations and
// barriers that its function needs (chip_smoke.py's PROBE_CHAINS); beside
// it the pipe or memory that limits each case (PROBE_PIPES). PERF.md has
// the times.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;

// An empty asm statement that takes and gives back v: the compiler must
// hold v in a register each rep and cannot fold a loop of adds into one.
// The rep loops that use it are not unrolled (#pragma unroll 1): ptxas
// does not see the asm, and would merge the adds of unrolled reps.
__device__ __forceinline__ void keep(int& v) { asm volatile("" : "+r"(v)); }
__device__ __forceinline__ void keep(float& v) { asm volatile("" : "+f"(v)); }
__device__ __forceinline__ void keep(uint32_t& v) { asm volatile("" : "+r"(v)); }

__device__ __forceinline__ uint8_t low_byte(int v) { return static_cast<uint8_t>(v); }
// XLA's f32 -> int32: toward zero, saturating, NaN -> 0 (cvt.rzi.s32.f32)
__device__ __forceinline__ uint8_t low_byte(float v) {
  return static_cast<uint8_t>(__float2int_rz(v));
}

__device__ __forceinline__ uint32_t permute(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// An H x W tile of 32-bit words banded over C CTAs: CTA q holds the
// words [q * kBand, (q + 1) * kBand) of the flat tile, whole rows, kPer
// words a thread at most.
template <int H, int W, int C>
struct Band {
  static constexpr int kN = H * W;
  static constexpr int kBand = kN / C;
  static constexpr int kPer = (kBand + kThreads - 1) / kThreads;
  static_assert(kN % C == 0 && kBand % W == 0, "whole rows a CTA");
};

// The x of a case with no exchange, its words in registers for every rep:
// v = op(v) a rep, then the low bytes out.
template <typename B, typename Load, typename Op>
__device__ __forceinline__ void in_registers(const uint8_t* x, uint8_t* out, int reps,
                                             Load load, Op op) {
  using T = decltype(load(uint8_t(0)));
  const int base = int(blockIdx.x) * B::kBand;
  T v[B::kPer];
#pragma unroll
  for (int k = 0; k < B::kPer; ++k) {
    const int e = int(threadIdx.x) + k * kThreads;
    if (e < B::kBand) v[k] = load(x[base + e]);
  }
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int k = 0; k < B::kPer; ++k) {
      v[k] = op(v[k]);
      keep(v[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < B::kPer; ++k) {
    const int e = int(threadIdx.x) + k * kThreads;
    if (e < B::kBand) out[base + e] = low_byte(v[k]);
  }
}

// u8 -> int32 -> the probe's type
struct ToInt {
  __device__ int operator()(uint8_t u) const { return u; }
};
struct ToFloat {
  __device__ float operator()(uint8_t u) const { return __int2float_rn(u); }
};

// ---------------------------------------------------------------- P1
// The cases with no exchange (the i32 add, the cast-hop) keep their words
// in registers for all reps (in_registers, over the rows of an 8-CTA
// cluster's bands). The roll cases band the tile by columns instead: CTA q
// holds columns [240 q, 240 q + 240) of all 152 rows in its own shared
// memory (145,920 B), so an axis-0 roll never leaves the CTA: no DSMEM, no
// cluster. Thread (g, c), 17 row groups of 60 threads (threads 1020-1023
// idle), holds the 16-byte vector c (4 columns) of rows g + 17 k, k < 9
// (8 for g = 16). A rep loads each vector from row (i - d) mod 152, waits
// at the CTA's barrier, stores it + 1 at row i and waits again: one shared
// load and one store a word, two CTA barriers. The source rows are
// computed a row at a time, as byte offsets: (g - d) mod 152, then 17 rows
// further a k, wrapped once (17 x 8 < 152), so the three amounts (26, r %
// 152, 26 unseen) cost the same. Bound: shared memory, 8 B a word at 128 B
// a clock an SM (PERF.md). probes/repos_probe.py::column_band_map is this
// index map, tested against torch.roll on the CPU.
namespace repos {
constexpr int H = 152, W = 1920, C = 8;
constexpr int kCols = W / C;  // the roll cases: a CTA's columns
constexpr int kVecs = kCols / 4;  // 16-byte vectors a row
constexpr int kGroups = kThreads / kVecs;  // row groups
constexpr int kRows = (H + kGroups - 1) / kGroups;  // rows a group (the last one fewer)
constexpr int kRowBytes = kCols * 4;
static_assert(kCols % 4 == 0 && kGroups * (kRows - 1) < H && kGroups * kRows >= H &&
                  size_t(H) * kRowBytes <= 232448,
              "a group's rows wrap at most once; the band fits one CTA");

template <typename T>
using Vec = std::conditional_t<std::is_same_v<T, float>, float4, int4>;

// The roll cases: 1 i32 roll26, 2 roll r % H, 3 opaque 26; 5 f32 roll26
template <int CASE>
__device__ __forceinline__ void column_band_case(const uint8_t* x, uint8_t* out, int reps) {
  using T = std::conditional_t<CASE == 5, float, int>;
  using V = Vec<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = threadIdx.x / kVecs, c = threadIdx.x % kVecs;
  // the thread's rows: 0 for the idle threads, which still meet every barrier
  const int rows = g >= kGroups ? 0 : g + kGroups * (kRows - 1) < H ? kRows : kRows - 1;
  const int col = int(blockIdx.x) * kCols + 4 * c;  // the thread's first tile column
  unsigned char* const mine = smem + g * kRowBytes + 16 * c;  // row g's vector
  constexpr int kStep = kGroups * kRowBytes, kWrap = H * kRowBytes;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (k < rows) {
      const uchar4 u = *reinterpret_cast<const uchar4*>(x + (g + kGroups * k) * W + col);
      *reinterpret_cast<V*>(mine + k * kStep) = V{T(int(u.x)), T(int(u.y)), T(int(u.z)),
                                                  T(int(u.w))};
    }
  }
  __syncthreads();
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    int d = 26;
    if constexpr (CASE == 2) d = r % H;
    if constexpr (CASE == 3) asm volatile("" : "+r"(d));  // the same amount, not folded
    int off = g - d;  // the source row of k = 0, then its byte offset
    if (off < 0) off += H;
    off = off * kRowBytes + 16 * c;
    // every thread loads all kRows vectors (each offset is in the band; a
    // row a thread lacks is not stored): a load under `k < rows` became a
    // branch that recomputed the offsets from k = 0 where d was a constant.
    // Each offset from the first, wrapped alone: no chain between them.
    V v[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int o = off + k * kStep;
      v[k] = *reinterpret_cast<const V*>(smem + (o >= kWrap ? o - kWrap : o));
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (k < rows) {
        V& a = v[k];
        if constexpr (CASE == 5) {
          a = V{__fadd_rn(a.x, 1.0f), __fadd_rn(a.y, 1.0f), __fadd_rn(a.z, 1.0f),
                __fadd_rn(a.w, 1.0f)};
        } else {
          a = V{a.x + 1, a.y + 1, a.z + 1, a.w + 1};
        }
        *reinterpret_cast<V*>(mine + k * kStep) = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (k < rows) {
      const V a = *reinterpret_cast<const V*>(mine + k * kStep);
      *reinterpret_cast<uchar4*>(out + (g + kGroups * k) * W + col) =
          make_uchar4(low_byte(a.x), low_byte(a.y), low_byte(a.z), low_byte(a.w));
    }
  }
}

template <int CASE>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int reps) {
  using B = Band<H, W, C>;
  if constexpr (CASE == 0) {  // i32 add
    in_registers<B>(x, out, reps, ToInt{}, [](int v) { return v + 1; });
  } else if constexpr (CASE == 4) {  // f32 cast-hop f -> i32 -> f + 1
    in_registers<B>(x, out, reps, ToFloat{}, [](float v) {
      return __fadd_rn(__int2float_rn(__float2int_rz(v)), 1.0f);
    });
  } else {
    column_band_case<CASE>(x, out, reps);
  }
}

// the register cases run as a cluster, as before; the roll cases as 8
// lone CTAs, one an SM by their shared memory
constexpr bool in_cluster(int which) { return which == 0 || which == 4; }
constexpr size_t smem_bytes(int which) { return in_cluster(which) ? 0 : size_t(H) * kRowBytes; }
}  // namespace repos

// ---------------------------------------------------------------- P2
// P2 keeps each CTA's band of 28 rows in registers: only rows that a
// neighbouring CTA holds cross through DSMEM, as a halo copied once an
// exchange into the CTA's own registers. The rows a CTA exports are
// double-buffered in its shared memory, so an exchange costs one cluster
// barrier, split into an arrive after the export and a wait before the
// halo is read. Two layouts:
// - rows (the axis-1 cases: roll by 1 and by 8, roll1 + add, the slice):
//   warp w < 28 holds band row w, lane l its columns [36 l, 36 l + 36); a
//   step takes the neighbouring lane's edge words by shuffles: no barrier
//   and no exchange at all;
// - blocks (the axis-0 cases and the cascade): a window of 32 rows, the
//   band and its halo, over 8 groups of 4 warps, thread t of group g
//   holding window rows 4 g .. 4 g + 3 at columns [9 t, 9 t + 9). An
//   axis-1 step trades each row's edge word with the neighbouring thread
//   through shared memory at the group's named barrier, an axis-0 step the
//   edge row with the neighbouring group at the CTA's barrier, each
//   double-buffered: one barrier a step. The window's edge rows take
//   ghost values, and every step after an exchange leaves one more edge
//   row wrong on the side it reads from. The cascade's 4 axis-0 steps read
//   2 rows up and 2 down: a halo of 2 rows each side, one exchange a rep,
//   whose wait the middle groups put after their axis-1 steps. The
//   roll-only axis-0 cases (roll axis0, roll0 + add) read a row up a rep:
//   a halo of 4 rows above, one exchange every 4 reps (4 ghost rows of
//   32). probes/roll_probe.py::HALO holds these depths, and
//   tests/test_torch_roll_bands.py models the exchanges on the CPU.
// The blocks layout's steps and the cascade take the word type T and P,
// the tile rows a word holds: 1, or 2 for P3's packed 16-bit cases (rows
// 2 i and 2 i + 1 of a column, the low and the high halfword). A thread's
// 4 rows are then kR / P word rows; an axis-1 roll moves whole words, an
// axis-0 roll is a funnel shift of a word and the one above or below.
namespace roll {
constexpr int H = 112, W = 1152, C = 4;
constexpr int kBandRows = H / C;
using B = Band<H, W, C>;
constexpr float kEps = 1e-7f;

constexpr int kLane = W / 32;  // rows layout: words a lane
constexpr int kGroups = 8;  // blocks layout: groups of 4 warps
constexpr int kGT = kThreads / kGroups;  // a group's threads, across a row
constexpr int kR = 4, kK = W / kGT;  // a thread's tile rows and words a row
constexpr int kHalo = 2;  // the cascade's halo rows each side
constexpr int kPeriod = 4;  // reps an exchange of the roll-only axis-0 cases
static_assert(kLane * 32 == W && kK * kGT == W && kGroups * kR == kBandRows + 2 * kHalo &&
                  kPeriod == kR && kBandRows % 2 == 0 && kHalo % 2 == 0,
              "the window is the band and a 2-row halo each side (or 4 rows above); a "
              "packed word's two rows lie in one band");

// the blocks layout's shared memory for R word rows a thread, [buffer][...]
// [thread]: an axis-0 step's edge words a group, an axis-1 step's edge
// words a row, the rows exported to the neighbouring CTAs
template <typename T, int R>
struct Smem {
  T v[2][kGroups][kK][kGT];
  T h[2][kGroups][R][kGT];
  T e[2][R][kK][kGT];
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// the named barrier of group g's 128 threads (0 is __syncthreads')
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "n"(kGT) : "memory");
}

// roll(f, 1, axis=0) at a word, from it and the word above it, and
// roll(f, H - 1, axis=0) from it and the word below: P = 2, (the above's
// high half, its low half) and (its high half, the below's low half)
template <int P, typename T>
__device__ __forceinline__ T from_above(T above, T self) {
  if constexpr (P == 1) return above;
  else return __funnelshift_r(above, self, 16);
}
template <int P, typename T>
__device__ __forceinline__ T from_below(T self, T below) {
  if constexpr (P == 1) return below;
  else return __funnelshift_r(self, below, 16);
}

// An axis-0 step of the blocks layout: each word becomes op(it, roll(f, 1,
// axis=0) there, kUp) or op(it, roll(f, H - 1, axis=0) there). The first
// group reads the last one's row and the last group the first one's: ghost
// values.
template <bool kUp, int P, typename T, int R, typename Op>
__device__ __forceinline__ void vstep(T (&v)[R][kK], Smem<T, R>& sm, int& buf, int g, int t,
                                      Op op) {
#pragma unroll
  for (int k = 0; k < kK; ++k) sm.v[buf][g][k][t] = v[kUp ? R - 1 : 0][k];
  __syncthreads();
  const int gn = kUp ? (g + kGroups - 1) % kGroups : (g + 1) % kGroups;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const T a = sm.v[buf][gn][k][t];
    if constexpr (kUp) {
#pragma unroll
      for (int i = R - 1; i > 0; --i) v[i][k] = op(v[i][k], from_above<P>(v[i - 1][k], v[i][k]));
      v[0][k] = op(v[0][k], from_above<P>(a, v[0][k]));
    } else {
#pragma unroll
      for (int i = 0; i < R - 1; ++i) v[i][k] = op(v[i][k], from_below<P>(v[i][k], v[i + 1][k]));
      v[R - 1][k] = op(v[R - 1][k], from_below<P>(v[R - 1][k], a));
    }
  }
  buf ^= 1;
}

// An axis-1 step of the blocks layout: each word becomes op(it, the word
// left of it: roll(f, 1, axis=1), kLeft) or op(it, the word right of it:
// roll(f, W - 1, axis=1)); a row lies in its group, which alone meets.
template <bool kLeft, typename T, int R, typename Op>
__device__ __forceinline__ void hstep(T (&v)[R][kK], Smem<T, R>& sm, int& buf, int g, int t,
                                      Op op) {
#pragma unroll
  for (int i = 0; i < R; ++i) sm.h[buf][g][i][t] = v[i][kLeft ? kK - 1 : 0];
  group_sync(g);
  const int tn = kLeft ? (t + kGT - 1) % kGT : (t + 1) % kGT;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const T a = sm.h[buf][g][i][tn];
    if constexpr (kLeft) {
#pragma unroll
      for (int k = kK - 1; k > 0; --k) v[i][k] = op(v[i][k], v[i][k - 1]);
      v[i][0] = op(v[i][0], a);
    } else {
#pragma unroll
      for (int k = 0; k < kK - 1; ++k) v[i][k] = op(v[i][k], v[i][k + 1]);
      v[i][kK - 1] = op(v[i][kK - 1], a);
    }
  }
  buf ^= 1;
}

// word rows [i0, i0 + n) of v to (kOut) or from export slots [j0, j0 + n) of e
template <bool kOut, typename T, int R>
__device__ __forceinline__ void trade(T (&v)[R][kK], T (*e)[kK][kGT], int i0, int j0, int n,
                                      int t) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < i0 || i >= i0 + n) continue;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      if constexpr (kOut) e[j0 + i - i0][k][t] = v[i][k];
      else v[i][k] = e[j0 + i - i0][k][t];
    }
  }
}

// The k = 5 two-axis cascade, `reps` reps on thread (g, t)'s words of the
// window: for axis 1 then 0, two f = add(f, roll(f, 1)) and two f = add(f,
// roll(f, n - 1)), the last step `last` (the add, then the case's rescale).
// The halo, kHalo rows each side (n word rows), is what the neighbours
// exported at the end of the last rep: the CTA above its last band rows,
// the one below its first. P2's cascade and P3's four cases.
template <int P, typename T, int R, typename Add, typename Last>
__device__ __forceinline__ void cascade(T (&v)[R][kK], Smem<T, R>& sm, Smem<T, R>& up,
                                        Smem<T, R>& down, int reps, int g, int t, Add add,
                                        Last last) {
  constexpr int n = kHalo / P;
  static_assert(R == 2 * n, "a thread's word rows: a halo's and as many band rows");
  const bool edge = g == 0 || g == kGroups - 1;
  int bv = 0, bh = 0;
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    if (r > 0 && edge) {
      cluster_wait();
      if (g == 0) trade<false>(v, up.e[(r - 1) & 1], 0, n, n, t);
      else trade<false>(v, down.e[(r - 1) & 1], n, 0, n, t);
    }
    hstep<true>(v, sm, bh, g, t, add);
    hstep<true>(v, sm, bh, g, t, add);
    hstep<false>(v, sm, bh, g, t, add);
    hstep<false>(v, sm, bh, g, t, add);
    if (r > 0 && !edge) cluster_wait();
    vstep<true, P>(v, sm, bv, g, t, add);
    vstep<true, P>(v, sm, bv, g, t, add);
    vstep<false, P>(v, sm, bv, g, t, add);
    vstep<false, P>(v, sm, bv, g, t, last);
    if (r + 1 < reps) {  // the first band rows, then the last ones
      if (g == 0) trade<true>(v, sm.e[r & 1], n, 0, n, t);
      else if (g == kGroups - 1) trade<true>(v, sm.e[r & 1], 0, n, n, t);
      cluster_arrive();
    }
  }
}

// The axis-1 cases: 3 roll by 1, 4 roll by 8, 6 roll1 + add, 7 the slice
template <int CASE>
__device__ __forceinline__ void rows_case(const uint8_t* x, uint8_t* out, int reps) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  if (w >= kBandRows) return;
  const int base = (int(blockIdx.x) * kBandRows + w) * W + kLane * l;
  constexpr unsigned kAll = 0xffffffffu;
  float v[kLane];
#pragma unroll
  for (int k = 0; k < kLane; ++k) v[k] = __int2float_rn(x[base + k]);
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    if constexpr (CASE == 3 || CASE == 6) {  // the word left of each: lane l - 1's last
      const float a = __shfl_sync(kAll, v[kLane - 1], (l + 31) & 31);
#pragma unroll
      for (int k = kLane - 1; k >= 0; --k) {
        const float left = k ? v[k - 1] : a;
        v[k] = __fadd_rn(CASE == 3 ? left : __fadd_rn(v[k], left), kEps);
      }
    } else if constexpr (CASE == 4) {  // 8 words left: lane l - 1's last 8 for the first 8
      float a[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] = __shfl_sync(kAll, v[kLane - 8 + j], (l + 31) & 31);
#pragma unroll
      for (int k = kLane - 1; k >= 0; --k) v[k] = __fadd_rn(k >= 8 ? v[k - 8] : a[k], kEps);
    } else {  // f[:, j] + f[:, j + 1] for j < W - 128, else 0: lane l + 1's first word
      const float a = __shfl_sync(kAll, v[0], (l + 1) & 31);
#pragma unroll
      for (int k = 0; k < kLane; ++k) {
        const float s = kLane * l + k < W - 128 ? __fadd_rn(v[k], k + 1 < kLane ? v[k + 1] : a)
                                                : 0.0f;
        v[k] = __fadd_rn(s, kEps);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kLane; ++k) out[base + k] = low_byte(v[k]);
}

// Thread (g, t) of CTA q on the blocks layout, P tile rows a word of type
// T: its words of the window (kTop halo rows above the band), each byte
// by load; `reps` reps of the case (kTop = kHalo: the cascade with op and
// last; else a roll by one row and op(the word, the word above) a rep, 4
// reps an exchange); then its band rows' low bytes (P = 2: each half's).
template <int P, int kTop, typename T, typename Load, typename Op, typename Last>
__device__ __forceinline__ void blocks_case(const uint8_t* x, uint8_t* out, int reps,
                                            Smem<T, kR / P>& sm, Load load, Op op, Last last) {
  constexpr int R = kR / P;
  const int q = blockIdx.x, g = threadIdx.x / kGT, t = threadIdx.x % kGT;
  const int first = q * kBandRows - kTop + kR * g;  // the tile row of v[0]'s first row
  T v[R][kK];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = (first + P * i + H) % H;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const uint8_t* p = x + row * W + kK * t + k;
      if constexpr (P == 1) v[i][k] = load(*p);
      else v[i][k] = T(load(p[0])) | T(load(p[W])) << 16;  // rows 2 i, 2 i + 1
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  Smem<T, R>& up = *cluster.map_shared_rank(&sm, (q + C - 1) % C);
  Smem<T, R>& down = *cluster.map_shared_rank(&sm, (q + 1) % C);
  if constexpr (kTop == kHalo) {
    cascade<P>(v, sm, up, down, reps, g, t, op, last);
  } else {
    int bv = 0;
#pragma unroll 1
    for (int r = 0; r < reps; ++r) {
      if (r > 0 && r % kPeriod == 0) {  // the last 4 band rows to the CTA below's halo
        const int p = (r / kPeriod) & 1;
        if (g == kGroups - 1) trade<true>(v, sm.e[p], 0, 0, R, t);
        cluster_arrive();
        cluster_wait();
        if (g == 0) trade<false>(v, up.e[p], 0, 0, R, t);
      }
      vstep<true, P>(v, sm, bv, g, t, op);
    }
  }
  cluster.sync();  // no CTA leaves while a neighbour may read its exports
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int wrow = kR * g + P * i - kTop;  // the band row
    if (wrow < 0 || wrow >= kBandRows) continue;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      uint8_t* p = out + (first + P * i) * W + kK * t + k;
      if constexpr (P == 1) {
        *p = low_byte(v[i][k]);
      } else {
        p[0] = uint8_t(v[i][k]);
        p[W] = uint8_t(v[i][k] >> 16);
      }
    }
  }
}

template <int CASE>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int reps) {
  if constexpr (CASE == 0) {  // add f+f
    in_registers<B>(x, out, reps, ToFloat{},
                    [](float v) { return __fadd_rn(__fadd_rn(v, v), kEps); });
  } else if constexpr (CASE == 1) {  // mul f*c
    in_registers<B>(x, out, reps, ToFloat{},
                    [](float v) { return __fadd_rn(__fmul_rn(v, 1.0001f), kEps); });
  } else if constexpr (CASE == 3 || CASE == 4 || CASE == 6 || CASE == 7) {
    rows_case<CASE>(x, out, reps);
  } else {  // 2 roll axis0, 5 roll0 + add, 8 the k = 5 cascade x 2^-8
    extern __shared__ __align__(16) unsigned char smem[];
    Smem<float, kR>& sm = *reinterpret_cast<Smem<float, kR>*>(smem);
    if constexpr (CASE == 8) {
      blocks_case<1, kHalo>(
          x, out, reps, sm, ToFloat{}, [](float a, float c) { return __fadd_rn(a, c); },
          [](float a, float c) {  // the last add, then x 2^-8 and + 1e-7
            return __fadd_rn(__fmul_rn(__fadd_rn(a, c), 0.00390625f), kEps);
          });
    } else {
      blocks_case<1, kR>(
          x, out, reps, sm, ToFloat{},
          [](float self, float above) {
            if constexpr (CASE == 2) return __fadd_rn(above, kEps);
            else return __fadd_rn(__fadd_rn(self, above), kEps);
          },
          nullptr);
    }
  }
}

// dynamic shared memory of case `which`
constexpr size_t smem_bytes(int which) {
  return which == 2 || which == 5 || which == 8 ? sizeof(Smem<float, kR>) : 0;
}
}  // namespace roll

// ---------------------------------------------------------------- P3
// P3 runs its four cases on P2's cascade (the blocks layout, the same 4
// CTAs of 28 rows, a thread's 4 x 9 tile elements, one halo exchange a
// rep), so that the cases differ only in words, operations and exchanges:
// float32 and int32 a word an element, 4 x 9 words a thread; int16 and
// uint16 packed, the rows 2 i and 2 i + 1 of a column in one 32-bit word,
// 2 x 9 words a thread, the 2-row halo one word row. Rows and not columns:
// a pair of columns would make a row 576 words, which does not split over
// a group's 128 threads, while a pair of rows keeps P2's geometry, and an
// axis-0 roll by a row is then one funnel shift (an axis-1 roll moves
// whole words). The adds: float32 FADD; int32 IADD3 or IMAD.IADD (ptxas
// puts about 3 in 5 on the FMA pipe); uint16 one plain 32-bit add a word,
// exact because no halfword sum passes 255 x 2^8 = 65,280 (the rescale
// brings every value back to 255 or less), so no carry crosses into the
// high half, and ptxas fuses an axis-0 step's funnel shift and add into
// one LEA.HI; int16 a halfword-safe add, __vadd2, since its rescale
// sign-extends into the high byte (0xFFxx from the second rep) and a plain
// add would carry across: on sm_90a __vadd2 is one instruction,
// VIADD.16x2. The rescale of the packed cases is one byte permute: each
// halfword's high byte, sign-replicated (int16) or zero-filled (uint16).
// 4 CTAs and not 8: 8 bands of 14 rows would take a window of 18 rows (14
// and 2 x 2 halo), which does not split over 8 groups of 4 rows, and the
// halo's share would grow from 4/28 to 4/14 of a band. Bound (PERF.md):
// on 4 SMs the rep loop's instructions issue in 0.77 (uint16) to 1.26 ms
// (the 32-bit cases) at 512 reps, above every case's operations and chain.
namespace i16 {
using roll::C;
using roll::kHalo;
using roll::kR;
using roll::Smem;

template <int CASE>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int reps) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (CASE == 0) {  // float32
    roll::blocks_case<1, kHalo>(
        x, out, reps, *reinterpret_cast<Smem<float, kR>*>(smem), ToFloat{},
        [](float a, float c) { return __fadd_rn(a, c); },
        [](float a, float c) { return __fmul_rn(__fadd_rn(a, c), 0.00390625f); });
  } else if constexpr (CASE == 1) {  // int32
    roll::blocks_case<1, kHalo>(
        x, out, reps, *reinterpret_cast<Smem<int, kR>*>(smem), ToInt{},
        [](int a, int c) { return a + c; }, [](int a, int c) { return (a + c) >> 8; });
  } else {  // int16 (2), uint16 (3)
    // the high byte of each halfword, sign-replicated (int16) or zero (uint16)
    constexpr uint32_t kSel = CASE == 2 ? 0xB391u : 0x4341u;
    const auto add = [](uint32_t a, uint32_t c) {
      if constexpr (CASE == 2) return __vadd2(a, c);
      else return a + c;
    };
    roll::blocks_case<2, kHalo>(
        x, out, reps, *reinterpret_cast<Smem<uint32_t, kR / 2>*>(smem), ToInt{}, add,
        [add](uint32_t a, uint32_t c) { return permute(add(a, c), 0u, kSel); });
  }
}

// dynamic shared memory of case `which`
constexpr size_t smem_bytes(int which) {
  return which < 2 ? sizeof(Smem<int, kR>) : sizeof(Smem<uint32_t, kR / 2>);
}
}  // namespace i16

// ---------------------------------------------------------------- P4
// P4 keeps the tile in registers, one layout for every case: thread (w, l)
// of the CTA's 32 warps holds a block of 10 rows x 4 columns, rows 10 rb
// .. 10 rb + 9 and columns 16 w + 4 cb .. 16 w + 4 cb + 3, lane l = 8 cb
// + rb. So a warp holds 16 whole columns, all 80 rows, its 8 lanes of one
// cb a column group. An axis-0 roll by one row moves a word only to the
// next row of its column: a step shifts the block's rows in registers and
// takes the one edge row of the lane above or below by a shuffle inside the
// column group (width 8), which also wraps row 79 to row 0. An axis-1 roll
// by one column takes the edge column of the neighbouring lane by a
// shuffle; at the warp's edge columns through shared memory, the writing
// lanes' edge columns as 16-byte vectors, double-buffered, one CTA barrier
// a step (warp 0's reads warp 31's: the wrap). Everything else is a
// register rename: a step does one min a word and moves only edges. The
// 2-row cells lie inside a thread (5 a column), so cell_sweepish's extract
// and interleave cost nothing: the sweep runs on the 5 x 4 block of v =
// min(top, bottom), its shuffles and exchanges a word each row. Every step
// passes its words through keep(), so that no step is folded into the next
// (chip_smoke.py's probe_sass counts each step's mins).
// tests/test_torch_cell_registers.py models these exchanges on the CPU.
// Bound: the mins, one a word a step at 64 a clock an SM (PERF.md).
namespace cell {
constexpr int H = 80, W = 512;
constexpr int kR = 10, kC = 4;  // a thread's block: rows x columns
constexpr int kRB = H / kR;  // row blocks: the lanes of a column group
constexpr int kCB = 32 / kRB;  // column groups a warp
constexpr int kWarps = kThreads / 32;
constexpr int kSlot = 12;  // a lane's edge column in shared memory: 10 rows, 16-byte vectors
static_assert(kRB * kCB == 32 && kWarps * kCB * kC == W && kR % 2 == 0 && kSlot % 4 == 0 &&
                  kSlot >= kR,
              "whole columns a warp; a 2-row cell inside a thread");
constexpr unsigned kAll = 0xffffffffu;

// the warp-edge columns: [buffer][warp][row block][row]
struct Smem {
  int e[2][kWarps][kRB][kSlot];
};

template <int NR>
__device__ __forceinline__ void keep_all(int (&v)[NR][kC]) {
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < kC; ++j) keep(v[i][j]);
}

// An axis-0 roll by one row + min on the plane of rows P, P + S, ... of
// the block: each word becomes min(it, the word above: roll(f, 1), kUp) or
// min(it, the word below: roll(f, R - 1)). The lane above or below in the
// column group gives its edge row, 8 lanes wrapping as the plane's rows.
template <bool kUp, int S, int P, int NR>
__device__ __forceinline__ void vstep(int (&v)[NR][kC], int rb) {
  constexpr int n = NR / S;  // the plane's rows in the block
  const int src = (rb + (kUp ? kRB - 1 : 1)) % kRB;
  const auto row = [&](int i, int j) -> int& { return v[P + S * i][j]; };
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    const int a = __shfl_sync(kAll, row(kUp ? n - 1 : 0, j), src, kRB);
    if constexpr (kUp) {
#pragma unroll
      for (int i = n - 1; i > 0; --i) row(i, j) = min(row(i, j), row(i - 1, j));
      row(0, j) = min(row(0, j), a);
    } else {
#pragma unroll
      for (int i = 0; i < n - 1; ++i) row(i, j) = min(row(i, j), row(i + 1, j));
      row(n - 1, j) = min(row(n - 1, j), a);
    }
  }
}

// An axis-1 roll by one column + min: each word becomes min(it, the word
// left of it: roll(f, 1), kLeft) or min(it, the word right of it: roll(f,
// W - 1)). The lane of the next column group gives its edge column by a
// shuffle; the warp's first (kLeft) or last column group takes the
// neighbouring warp's from shared memory, written before the barrier.
template <bool kLeft, int NR>
__device__ __forceinline__ void hstep(int (&v)[NR][kC], Smem& sm, int& buf, int w, int cb,
                                      int rb) {
  constexpr int kVecs = (NR + 3) / 4, kOut = kLeft ? kC - 1 : 0;
  if (cb == (kLeft ? kCB - 1 : 0)) {  // the column the neighbouring warp reads
#pragma unroll
    for (int m = 0; m < kVecs; ++m) {
      int q[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) q[u] = 4 * m + u < NR ? v[4 * m + u][kOut] : 0;
      *reinterpret_cast<int4*>(&sm.e[buf][w][rb][4 * m]) = make_int4(q[0], q[1], q[2], q[3]);
    }
  }
  __syncthreads();
  const bool reads = cb == (kLeft ? 0 : kCB - 1);
  const int wn = (w + (kLeft ? kWarps - 1 : 1)) % kWarps;
#pragma unroll
  for (int m = 0; m < kVecs; ++m) {
    int4 e = make_int4(0, 0, 0, 0);
    if (reads) e = *reinterpret_cast<const int4*>(&sm.e[buf][wn][rb][4 * m]);
    const int ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = 4 * m + u;
      if (i >= NR) break;
      int a = kLeft ? __shfl_up_sync(kAll, v[i][kC - 1], kRB)
                    : __shfl_down_sync(kAll, v[i][0], kRB);
      if (reads) a = ev[u];
      if constexpr (kLeft) {
#pragma unroll
        for (int j = kC - 1; j > 0; --j) v[i][j] = min(v[i][j], v[i][j - 1]);
        v[i][0] = min(v[i][0], a);
      } else {
#pragma unroll
        for (int j = 0; j < kC - 1; ++j) v[i][j] = min(v[i][j], v[i][j + 1]);
        v[i][kC - 1] = min(v[i][kC - 1], a);
      }
    }
  }
  buf ^= 1;
}

// roll(f, 1) + min, roll(f, R - 1) + min on axis 0 and the same on axis 1
template <int NR>
__device__ __forceinline__ void sweep(int (&v)[NR][kC], Smem& sm, int& buf, int w, int cb,
                                      int rb) {
  vstep<true, 1, 0>(v, rb);
  keep_all(v);
  vstep<false, 1, 0>(v, rb);
  keep_all(v);
  hstep<true>(v, sm, buf, w, cb, rb);
  keep_all(v);
  hstep<false>(v, sm, buf, w, cb, rb);
  keep_all(v);
}

template <int CASE>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const int* __restrict__ x, int* __restrict__ out, int reps) {
  __shared__ __align__(16) Smem sm;
  const int w = threadIdx.x / 32, l = threadIdx.x % 32, cb = l / kRB, rb = l % kRB;
  const int base = kR * rb * W + (w * kCB + cb) * kC;  // the block's first word
  int v[kR][kC];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int4 q = *reinterpret_cast<const int4*>(x + base + i * W);
    v[i][0] = q.x, v[i][1] = q.y, v[i][2] = q.z, v[i][3] = q.w;
  }
  int buf = 0;
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    if constexpr (CASE == 0) {  // baseline_min: 8 x roll(1, axis 0) + min
#pragma unroll 1
      for (int k = 0; k < 8; ++k) {
        vstep<true, 1, 0>(v, rb);
        keep_all(v);
      }
    } else if constexpr (CASE == 1) {  // extract_roundtrip: each row plane
#pragma unroll 1
      for (int k = 0; k < 4; ++k) {
        vstep<true, 2, 0>(v, rb);
        vstep<true, 2, 1>(v, rb);
        keep_all(v);
      }
    } else if constexpr (CASE == 2) {  // baseline_sweepish
#pragma unroll 1
      for (int k = 0; k < 16; ++k) sweep(v, sm, buf, w, cb, rb);
    } else {  // cell_sweepish: v = min(top, bottom), the sweep, then v and max(v, bottom)
      int c[kR / 2][kC], b[kR / 2][kC];
#pragma unroll
      for (int j = 0; j < kR / 2; ++j)
#pragma unroll
        for (int q = 0; q < kC; ++q) b[j][q] = v[2 * j + 1][q], c[j][q] = min(v[2 * j][q], b[j][q]);
      keep_all(c);
#pragma unroll 1
      for (int k = 0; k < 16; ++k) sweep(c, sm, buf, w, cb, rb);
#pragma unroll
      for (int j = 0; j < kR / 2; ++j)
#pragma unroll
        for (int q = 0; q < kC; ++q) v[2 * j][q] = c[j][q], v[2 * j + 1][q] = max(c[j][q], b[j][q]);
      keep_all(v);
    }
  }
#pragma unroll
  for (int i = 0; i < kR; ++i)
    *reinterpret_cast<int4*>(out + base + i * W) = make_int4(v[i][0], v[i][1], v[i][2], v[i][3]);
}
}  // namespace cell

// ---------------------------------------------------------- latencies
// The latency probe. It replaces no TPU kernel: PERF.md bounds each of
// P1-P4 by the chain of dependent operations of its rep (reps x the
// chain's latency), and this measures those latencies on the card. One
// thread of CTA 0 runs `reps` dependent operations of a kind on x, an
// int32[1024] single-cycle permutation (x[i] the next index of a chase):
// a float32 add, the cast-hop f -> int32 -> f + 1, a shared-memory load,
// a load from the other CTA's shared memory of a 2-CTA cluster; or every
// thread of a CTA or a 4-CTA cluster `reps` barriers; or an int32
// add v + w, or P3's packed int16 add __vadd2(v, w) (VIADD.16x2), w = x[1]
// | x[2] << 16 from memory, so unknown to the compiler. out is x with
// out[0] the chain's last value (reps for the barriers; the adds: the xor
// of every sum, x[0] the first). ptxas merges two dependent adds into one
// IADD3 even across keep() (its SASS), so each sum is also xored into a
// second register off the chain: a sum with two uses is not merged, and
// chip_smoke.py's probe_sass holds each add's loop to 16 adds an
// iteration. Bound: the chain itself, so no bound but its own latency. No
// min/max case: ptxas regroups a chain of them against operands that do
// not depend on it (the SASS showed min/max off the chain), so it times no
// latency.
namespace lat {
constexpr int kN = 1024;
constexpr int kCtas[] = {1, 1, 1, 2, 1, 4, 1, 1};

template <int CASE>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const int* __restrict__ x, int* __restrict__ out, int reps) {
  __shared__ int s[kN];
  for (int e = threadIdx.x; e < kN; e += kThreads) s[e] = x[e];
  constexpr bool kCluster = kCtas[CASE] > 1;
  if constexpr (kCluster) cg::this_cluster().sync();
  else __syncthreads();
  int v = reps;
  if constexpr (CASE >= 6) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      uint32_t u = s[0], all = u;
      const uint32_t w = uint32_t(s[1]) | uint32_t(s[2]) << 16;
#pragma unroll 16
      for (int r = 0; r < reps; ++r) {
        if constexpr (CASE == 6) u += w;
        else u = __vadd2(u, w);
        keep(u);
        all ^= u;
      }
      v = int(all);
    }
  } else if constexpr (CASE <= 3) {
    // 16 dependent operations an iteration (a loop's own add, compare and
    // branch would otherwise count in each operation's time), then the rest
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      if constexpr (CASE <= 1) {
        float f = static_cast<float>(s[0]);
#pragma unroll 16
        for (int r = 0; r < reps; ++r) {
          if constexpr (CASE == 0) f = __fadd_rn(f, 1.0f);
          else f = __fadd_rn(__int2float_rn(__float2int_rz(f)), 1.0f);
          keep(f);
        }
        v = __float_as_int(f);
      } else {
        const int* t = s;
        if constexpr (CASE == 3) t = cg::this_cluster().map_shared_rank(s, 1);
        int i = 0;
#pragma unroll 16
        for (int r = 0; r < reps; ++r) i = t[i];
        v = i;
      }
    }
  } else {
#pragma unroll 1
    for (int r = 0; r < reps; ++r) {
      if constexpr (kCluster) cg::this_cluster().sync();
      else __syncthreads();
    }
  }
  if constexpr (kCluster) cg::this_cluster().sync();  // the chased CTA stays until done
  if (blockIdx.x != 0) return;
  for (int e = threadIdx.x; e < kN; e += kThreads) out[e] = e == 0 ? v : x[e];
}
}  // namespace lat

template <typename In, typename Out>
using ProbeKernel = void (*)(const In*, Out*, int);

template <typename In, typename Out>
int launch(ProbeKernel<In, Out> k, int ctas, size_t smem, const void* x, void* out, int reps,
           cudaStream_t stream, bool cluster = true) {
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster && ctas > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, k, static_cast<const In*>(x), static_cast<Out*>(out), reps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point runs `reps` reps of case `which` (the order of the
// probe's CASES table) on x, the probe's tile (uint8; int32 for P4), into
// out of the same shape. One CTA an SM, in one cluster but for P1's roll
// cases and P4's one CTA. Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int tpuva_probe_repos(const void* x, void* out, int reps, int which,
                                 cudaStream_t stream) {
  using namespace repos;
  static const ProbeKernel<uint8_t, uint8_t> ks[] = {kernel<0>, kernel<1>, kernel<2>,
                                                  kernel<3>, kernel<4>, kernel<5>};
  if (which < 0 || which >= 6) return static_cast<int>(cudaErrorInvalidValue);
  return launch(ks[which], C, smem_bytes(which), x, out, reps, stream, in_cluster(which));
}

extern "C" int tpuva_probe_roll(const void* x, void* out, int reps, int which,
                                cudaStream_t stream) {
  using namespace roll;
  static const ProbeKernel<uint8_t, uint8_t> ks[] = {kernel<0>, kernel<1>, kernel<2>,
                                                  kernel<3>, kernel<4>, kernel<5>,
                                                  kernel<6>, kernel<7>, kernel<8>};
  if (which < 0 || which >= 9) return static_cast<int>(cudaErrorInvalidValue);
  return launch(ks[which], C, smem_bytes(which), x, out, reps, stream);
}

extern "C" int tpuva_probe_i16(const void* x, void* out, int reps, int which,
                               cudaStream_t stream) {
  using namespace i16;
  static const ProbeKernel<uint8_t, uint8_t> ks[] = {kernel<0>, kernel<1>, kernel<2>, kernel<3>};
  if (which < 0 || which >= 4) return static_cast<int>(cudaErrorInvalidValue);
  return launch(ks[which], C, smem_bytes(which), x, out, reps, stream);
}

extern "C" int tpuva_probe_cell(const void* x, void* out, int reps, int which,
                                cudaStream_t stream) {
  using namespace cell;
  static const ProbeKernel<int, int> ks[] = {kernel<0>, kernel<1>, kernel<2>, kernel<3>};
  if (which < 0 || which >= 4) return static_cast<int>(cudaErrorInvalidValue);
  return launch(ks[which], 1, 0, x, out, reps, stream);
}

// The latency probe: `reps` dependent operations of kind `which`
// (lat::kernel's cases, probes/latency_probe.py's CASES) on x, int32[1024].
extern "C" int tpuva_probe_latency(const void* x, void* out, int reps, int which,
                                   cudaStream_t stream) {
  using namespace lat;
  static const ProbeKernel<int, int> ks[] = {kernel<0>, kernel<1>, kernel<2>, kernel<3>,
                                             kernel<4>, kernel<5>, kernel<6>, kernel<7>};
  if (which < 0 || which >= 8) return static_cast<int>(cudaErrorInvalidValue);
  return launch(ks[which], kCtas[which], 0, x, out, reps, stream);
}
