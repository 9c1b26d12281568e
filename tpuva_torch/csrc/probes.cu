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
// axis-0 roll stays in its CTA's shared memory (its section below). P2
// holds row bands in registers and trades halo rows over a 4-CTA cluster
// (its section below). P3 holds row bands in the distributed shared memory
// of an 8-CTA cluster (64,512 B each, or 32,256 B packed): an axis-0 roll
// reads the neighbouring band through DSMEM; an axis-1 roll stays in its
// row, so in its CTA. A P3 step reads every word it needs into
// registers, waits at a barrier (no reader may see a new word), writes its
// band and waits again (every writer done before the next reads): the
// cluster's barrier for a step that reads across CTAs, the CTA's for one
// that does not; the last in-row step before a step across publishes its
// writes at the cluster's barrier, since a CTA's own barrier does not hold
// back a neighbour that would read its band. There is room for one
// buffer only, so a step costs two barriers; a cooperative
// grid-wide sync instead would wait for the whole grid through global
// memory, where the cluster's barrier is in hardware among its SMs. The
// cases with no exchange (i32 add, the cast-hop, f+f, the multiply) keep
// their words in registers for all reps.
// The 16-bit cases of P3 run packed, two halfwords a 32-bit register:
// wrapping per-halfword adds (__vadd2), an axis-1 roll by one element as
// a funnel shift of two neighbouring words, and the rescale
// (f.astype(int32) >> 8).astype(dtype) as one byte permute that takes each
// halfword's high byte, sign-replicated for i16 and zero-filled for u16.
// P4's (80, 512) tile, 163,840 B, lies in the registers of one CTA, a
// block of 10 x 4 words a thread, its 2-row cells inside a thread (its
// section below). The compared cases keep their words in registers across
// a step's barrier without spilling in the rep loop (P3's 32-bit and
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

// An H x W tile of 32-bit words banded over the C CTAs of a cluster: CTA
// q holds the words [q * kBand, (q + 1) * kBand) of the flat tile in its
// shared memory, whole rows. kMapa: read other CTAs' words through 32-bit
// shared::cluster addresses (mapa), half the registers of the generic
// pointers map_shared_rank gives, which the cascades need to hold their
// words without spilling. P3 alone reads other CTAs' words through a Band.
template <int H, int W, int C, typename T, bool kMapa = false>
struct Band {
  static constexpr int kN = H * W;
  static constexpr int kBand = kN / C;
  static constexpr int kPer = (kBand + kThreads - 1) / kThreads;
  static constexpr size_t kBytes = size_t(kBand) * sizeof(T);
  static_assert(kN % C == 0 && kBand % W == 0, "whole rows a CTA");
  T* s;
  int base;

  __device__ explicit Band(T* smem) : s(smem), base(int(blockIdx.x) * kBand) {}

  // word g of the tile, through DSMEM from the CTA that holds it (its own
  // rows too: a branch to read those locally made the steps 1.3-2.7x
  // slower, PERF.md)
  __device__ __forceinline__ T at(int g) const {
    if constexpr (kMapa) {
      const int q = g / kBand;
      const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(s + (g - q * kBand)));
      uint32_t r, v;
      asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(q));
      // volatile: kept in order with the cluster's barriers
      asm volatile("ld.shared::cluster.b32 %0, [%1];" : "=r"(v) : "r"(r));
      if constexpr (std::is_same_v<T, float>) return __uint_as_float(v);
      else return static_cast<T>(v);
    } else {
      const int q = g / kBand;
      return cg::this_cluster().map_shared_rank(s, q)[g - q * kBand];
    }
  }
  // roll(f, d, axis=0) at this band's word e, 0 <= d < H
  __device__ __forceinline__ T up(int e, int d) const {
    int g = base + e - d * W;
    if (g < 0) g += kN;
    return at(g);
  }
  // roll(f, d, axis=1) at this band's word e, 0 <= d < W
  __device__ __forceinline__ T left(int e, int d) const {
    const int row = e / W * W;
    int c = e - row - d;
    if (c < 0) c += W;
    return s[row + c];
  }
  __device__ __forceinline__ void sync_cluster() const { cg::this_cluster().sync(); }
};

// A step of the band in place: word e becomes fn(e), computed from the
// tile as it stood. The first barrier keeps every read ahead of the
// writes: `across`, fn reads other CTAs' bands, so no CTA may write before
// all have read. The second publishes them: `publish`, the next step reads
// across, so every CTA's writes must be done before any CTA goes on (a
// CTA's own barrier does not hold the others back).
//
// A thread holds up to 16 words across the first barrier (P3), of the 64
// registers 1024 threads have. The compiler hoists a step's addresses out
// of the rep loop; where a rep has several steps (kRecompute: the
// cascades) they do not fit beside the words and spilled to local memory,
// so there the thread's index is made opaque each step and the addresses
// are recomputed instead (PERF.md has both).
template <bool kRecompute = false, typename B, typename Fn>
__device__ __forceinline__ void band_step(B& b, bool across, Fn fn, bool publish) {
  auto barrier = [&](bool cluster) {
    if (cluster) b.sync_cluster();
    else __syncthreads();
  };
  int tid = threadIdx.x;
  if constexpr (kRecompute) asm volatile("" : "+r"(tid));
  decltype(fn(0)) v[B::kPer];
#pragma unroll
  for (int k = 0; k < B::kPer; ++k) {
    const int e = tid + k * kThreads;
    if (B::kBand % kThreads == 0 || e < B::kBand) v[k] = fn(e);
  }
  barrier(across);
#pragma unroll
  for (int k = 0; k < B::kPer; ++k) {
    const int e = tid + k * kThreads;
    if (B::kBand % kThreads == 0 || e < B::kBand) b.s[e] = v[k];
  }
  barrier(publish);
}

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

template <typename B, typename Load>
__device__ __forceinline__ void load_band(B& b, const uint8_t* x, Load load) {
  for (int e = threadIdx.x; e < B::kBand; e += kThreads) b.s[e] = load(x[b.base + e]);
  b.sync_cluster();
}

template <typename B>
__device__ __forceinline__ void store_band(const B& b, uint8_t* out) {
  for (int e = threadIdx.x; e < B::kBand; e += kThreads) out[b.base + e] = low_byte(b.s[e]);
}

// u8 -> int32 -> the probe's type
struct ToInt {
  __device__ int operator()(uint8_t u) const { return u; }
};
struct ToFloat {
  __device__ float operator()(uint8_t u) const { return __int2float_rn(u); }
};

// The k = 5 two-axis cascade of roll_probe.py and i16_probe.py: for axis
// 1 then 0, two f = f + roll(f, 1) and two f = f + roll(f, n - 1); the
// last step's sum goes through rescale. left(e) and right(e) give roll(f,
// 1, axis=1) and roll(f, W - 1, axis=1) at word e.
template <typename B, typename Add, typename Left, typename Right, typename Rescale>
__device__ __forceinline__ void cascade(B& b, int H, Add add, Left left, Right right,
                                        Rescale rescale) {
  for (int d = 0; d < 2; ++d)
    band_step<true>(b, false, [&](int e) { return add(b.s[e], left(e)); }, false);
  for (int d = 0; d < 2; ++d)
    band_step<true>(b, false, [&](int e) { return add(b.s[e], right(e)); }, d == 1);
  for (int d = 0; d < 2; ++d)
    band_step<true>(b, true, [&](int e) { return add(b.s[e], b.up(e, 1)); }, true);
  band_step<true>(b, true, [&](int e) { return add(b.s[e], b.up(e, H - 1)); }, true);
  band_step<true>(b, true, [&](int e) { return rescale(add(b.s[e], b.up(e, H - 1))); }, true);
}

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
  using T = std::conditional_t<(CASE >= 4), float, int>;
  using B = Band<H, W, C, T>;
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
namespace roll {
constexpr int H = 112, W = 1152, C = 4;
constexpr int kBandRows = H / C;
using B = Band<H, W, C, float>;
constexpr float kEps = 1e-7f;

constexpr int kLane = W / 32;  // rows layout: words a lane
constexpr int kGroups = 8;  // blocks layout: groups of 4 warps
constexpr int kGT = kThreads / kGroups;  // a group's threads, across a row
constexpr int kR = 4, kK = W / kGT;  // a thread's rows and words a row
constexpr int kPeriod = 4;  // reps an exchange of the roll-only axis-0 cases
static_assert(kLane * 32 == W && kK * kGT == W && kGroups * kR == kBandRows + 4 &&
                  kPeriod == kR,
              "the window is the band and a 4-row halo");

// the blocks layout's shared memory, [buffer][...][thread]: an axis-0
// step's edge rows a group, an axis-1 step's edge words a row, the rows
// exported to the neighbouring CTAs
struct Smem {
  float v[2][kGroups][kK][kGT];
  float h[2][kGroups][kR][kGT];
  float e[2][kR][kK][kGT];
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

// An axis-0 step of the blocks layout: each word becomes op(it, the word
// above: roll(f, 1, axis=0), kUp) or op(it, the word below: roll(f, H - 1,
// axis=0)). The first group reads the last one's row and the last group
// the first one's: ghost values.
template <bool kUp, typename Op>
__device__ __forceinline__ void vstep(float (&v)[kR][kK], Smem& sm, int& buf, int g, int t,
                                      Op op) {
#pragma unroll
  for (int k = 0; k < kK; ++k) sm.v[buf][g][k][t] = v[kUp ? kR - 1 : 0][k];
  __syncthreads();
  const int gn = kUp ? (g + kGroups - 1) % kGroups : (g + 1) % kGroups;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const float a = sm.v[buf][gn][k][t];
    if constexpr (kUp) {
#pragma unroll
      for (int i = kR - 1; i > 0; --i) v[i][k] = op(v[i][k], v[i - 1][k]);
      v[0][k] = op(v[0][k], a);
    } else {
#pragma unroll
      for (int i = 0; i < kR - 1; ++i) v[i][k] = op(v[i][k], v[i + 1][k]);
      v[kR - 1][k] = op(v[kR - 1][k], a);
    }
  }
  buf ^= 1;
}

// An axis-1 step of the blocks layout: each word becomes op(it, the word
// left of it: roll(f, 1, axis=1), kLeft) or op(it, the word right of it:
// roll(f, W - 1, axis=1)); a row lies in its group, which alone meets.
template <bool kLeft, typename Op>
__device__ __forceinline__ void hstep(float (&v)[kR][kK], Smem& sm, int& buf, int g, int t,
                                      Op op) {
#pragma unroll
  for (int i = 0; i < kR; ++i) sm.h[buf][g][i][t] = v[i][kLeft ? kK - 1 : 0];
  group_sync(g);
  const int tn = kLeft ? (t + kGT - 1) % kGT : (t + 1) % kGT;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const float a = sm.h[buf][g][i][tn];
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

// rows [i0, i0 + n) of v to (kOut) or from export slots [j0, j0 + n) of e
template <bool kOut>
__device__ __forceinline__ void trade(float (&v)[kR][kK], float (*e)[kK][kGT], int i0, int j0,
                                      int n, int t) {
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    if (i < i0 || i >= i0 + n) continue;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      if constexpr (kOut) e[j0 + i - i0][k][t] = v[i][k];
      else v[i][k] = e[j0 + i - i0][k][t];
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

// The axis-0 cases (2 roll axis0, 5 roll0 + add) and the cascade (8)
template <int CASE>
__device__ __forceinline__ void blocks_case(const uint8_t* x, uint8_t* out, int reps, Smem& sm) {
  constexpr bool kCascade = CASE == 8;
  constexpr int kTop = kCascade ? 2 : kR;  // halo rows above the band (the cascade: 2 below)
  const int q = blockIdx.x, g = threadIdx.x / kGT, t = threadIdx.x % kGT;
  const int first = q * kBandRows - kTop + kR * g;  // the tile row of v[0]
  float v[kR][kK];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = (first + i + H) % H;
#pragma unroll
    for (int k = 0; k < kK; ++k) v[i][k] = __int2float_rn(x[row * W + kK * t + k]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  Smem& up = *cluster.map_shared_rank(&sm, (q + C - 1) % C);
  Smem& down = *cluster.map_shared_rank(&sm, (q + 1) % C);
  int bv = 0, bh = 0;
  if constexpr (kCascade) {
    const auto add = [](float a, float c) { return __fadd_rn(a, c); };
    const auto last = [](float a, float c) {  // the last add, then x 2^-8 and + 1e-7
      return __fadd_rn(__fmul_rn(__fadd_rn(a, c), 0.00390625f), kEps);
    };
    const bool edge = g == 0 || g == kGroups - 1;
#pragma unroll 1
    for (int r = 0; r < reps; ++r) {
      // the halo: the rows the neighbours exported at the end of rep r - 1
      // (the CTA above its last two band rows, the one below its first two)
      if (r > 0 && edge) {
        cluster_wait();
        if (g == 0) trade<false>(v, up.e[(r - 1) & 1], 0, 2, 2, t);
        else trade<false>(v, down.e[(r - 1) & 1], 2, 0, 2, t);
      }
      hstep<true>(v, sm, bh, g, t, add);
      hstep<true>(v, sm, bh, g, t, add);
      hstep<false>(v, sm, bh, g, t, add);
      hstep<false>(v, sm, bh, g, t, add);
      if (r > 0 && !edge) cluster_wait();
      vstep<true>(v, sm, bv, g, t, add);
      vstep<true>(v, sm, bv, g, t, add);
      vstep<false>(v, sm, bv, g, t, add);
      vstep<false>(v, sm, bv, g, t, last);
      if (r + 1 < reps) {  // the first two band rows, then the last two
        if (g == 0) trade<true>(v, sm.e[r & 1], 2, 0, 2, t);
        else if (g == kGroups - 1) trade<true>(v, sm.e[r & 1], 0, 2, 2, t);
        cluster_arrive();
      }
    }
  } else {
    const auto op = [](float self, float above) {
      if constexpr (CASE == 2) return __fadd_rn(above, kEps);
      else return __fadd_rn(__fadd_rn(self, above), kEps);
    };
#pragma unroll 1
    for (int r = 0; r < reps; ++r) {
      if (r > 0 && r % kPeriod == 0) {  // the last 4 band rows to the CTA below's halo
        const int p = (r / kPeriod) & 1;
        if (g == kGroups - 1) trade<true>(v, sm.e[p], 0, 0, kR, t);
        cluster_arrive();
        cluster_wait();
        if (g == 0) trade<false>(v, up.e[p], 0, 0, kR, t);
      }
      vstep<true>(v, sm, bv, g, t, op);
    }
  }
  cluster.sync();  // no CTA leaves while a neighbour may read its exports
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int wrow = kR * g + i - kTop;  // the band row
    if (wrow < 0 || wrow >= kBandRows) continue;
#pragma unroll
    for (int k = 0; k < kK; ++k) out[(first + i) * W + kK * t + k] = low_byte(v[i][k]);
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
    blocks_case<CASE>(x, out, reps, *reinterpret_cast<Smem*>(smem));
  }
}

// dynamic shared memory of case `which`
constexpr size_t smem_bytes(int which) {
  return which == 2 || which == 5 || which == 8 ? sizeof(Smem) : 0;
}
}  // namespace roll

// ---------------------------------------------------------------- P3
namespace i16 {
// 8 CTAs: 16 words a thread at 32 bits, 8 packed, so that the two spill
// alike (8 B and 0 B a thread; at 4 CTAs, 32 and 16 words a thread, they
// spilled 108 B and 28 B: PERF.md)
constexpr int H = 112, W = 1152, C = 8;
template <typename T>
using Tile = Band<H, W, C, T, true>;

template <int CASE>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int reps) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (CASE == 0) {  // float32
    Tile<float> b(reinterpret_cast<float*>(smem));
    load_band(b, x, ToFloat{});
    for (int r = 0; r < reps; ++r)
      cascade(
          b, H, [](float a, float c) { return __fadd_rn(a, c); },
          [&](int e) { return b.left(e, 1); }, [&](int e) { return b.left(e, W - 1); },
          [](float v) { return __fmul_rn(v, 0.00390625f); });
    store_band(b, out);
  } else if constexpr (CASE == 1) {  // int32
    Tile<int> b(reinterpret_cast<int*>(smem));
    load_band(b, x, ToInt{});
    for (int r = 0; r < reps; ++r)
      cascade(
          b, H, [](int a, int c) { return a + c; }, [&](int e) { return b.left(e, 1); },
          [&](int e) { return b.left(e, W - 1); }, [](int v) { return v >> 8; });
    store_band(b, out);
  } else {  // int16 (2), uint16 (3): word w holds columns 2w (low) and 2w + 1
    using B = Band<H, W / 2, C, uint32_t, true>;
    B b(reinterpret_cast<uint32_t*>(smem));
    const uint8_t* x2 = x + 2 * b.base;
    for (int e = threadIdx.x; e < B::kBand; e += kThreads)
      b.s[e] = uint32_t(x2[2 * e]) | uint32_t(x2[2 * e + 1]) << 16;
    b.sync_cluster();
    // the high byte of each halfword, sign-replicated (i16) or zero (u16)
    constexpr uint32_t kSel = CASE == 2 ? 0xB391u : 0x4341u;
    for (int r = 0; r < reps; ++r)
      cascade(
          b, H, [](uint32_t a, uint32_t c) { return __vadd2(a, c); },
          // roll by 1: (the left word's high half, this word's low half)
          [&](int e) { return __funnelshift_r(b.left(e, 1), b.s[e], 16); },
          // roll by W - 1: (this word's high half, the right word's low half)
          [&](int e) { return __funnelshift_r(b.s[e], b.left(e, B::kN / H - 1), 16); },
          [](uint32_t v) { return permute(v, 0u, kSel); });
    uint8_t* o2 = out + 2 * b.base;
    for (int e = threadIdx.x; e < B::kBand; e += kThreads) {
      o2[2 * e] = uint8_t(b.s[e]);
      o2[2 * e + 1] = uint8_t(b.s[e] >> 16);
    }
  }
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
// thread of a CTA or a 4- or 8-CTA cluster `reps` barriers. out is x with
// out[0] the chain's last value (reps for the barriers). Bound: the chain
// itself, so no bound but its own latency. No min/max case: ptxas
// regroups a chain of them against operands that do not depend on it
// (the SASS showed min/max off the chain), so it times no latency.
namespace lat {
constexpr int kN = 1024;
constexpr int kCtas[] = {1, 1, 1, 2, 1, 4, 8};

template <int CASE>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const int* __restrict__ x, int* __restrict__ out, int reps) {
  __shared__ int s[kN];
  for (int e = threadIdx.x; e < kN; e += kThreads) s[e] = x[e];
  constexpr bool kCluster = kCtas[CASE] > 1;
  if constexpr (kCluster) cg::this_cluster().sync();
  else __syncthreads();
  int v = reps;
  if constexpr (CASE <= 3) {
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
  const size_t smem = which < 2 ? Tile<int>::kBytes : Band<H, W / 2, C, uint32_t, true>::kBytes;
  return launch(ks[which], C, smem, x, out, reps, stream);
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
                                             kernel<4>, kernel<5>, kernel<6>};
  if (which < 0 || which >= 7) return static_cast<int>(cudaErrorInvalidValue);
  return launch(ks[which], kCtas[which], 0, x, out, reps, stream);
}
