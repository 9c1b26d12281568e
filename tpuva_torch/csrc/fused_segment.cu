// Fused segmentation front-end (kernel K1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel tpuva/ops/pallas/fused_segment.py::
// fused_segment (emit="mask" and emit="diff", and the mask emit's
// padded_occ mode). Per frame and pixel:
//   cv2's u8 Gaussian blur: REFLECT_101, integer taps, (acc + 2^(s-1)) >> s
//   -> optional median 3x3 (BORDER_REPLICATE)
//   -> B <- (1-a)*B + a*F in float32 (two products, one add, no FMA)
//   emit="mask":
//   -> |F - B| > thr
//   -> open (erode, dilate) -> close (dilate, erode), cv2 constant borders:
//      erode reads outside pixels as foreground, dilate as background.
//   emit="diff" (the Otsu routes' front end; the threshold is a per-frame
//   statistic no tile can see):
//   -> min(rint(|F - B|), 255) as uint8, rint half to even (rintf, never
//      roundf); no threshold, no morphology (the caller has none: Rm = 0).
// The plain PyTorch version is tpuva_torch/ops/fused_segment.py::
// fused_segment_plain; the two are bit-equal.
//
// padded_occ (the staged route's handoff to K2, mask emit only): the masks
// go to an (N, Hp, Wp) buffer of row pitch Wp, Hp x Wp the grid cover
// tpuva's fused_tile gives, with every pixel outside the H x W image 0,
// and occ (N, Hp/2, Wp/128) gets a 1 for every 2-row x 128-column block
// that holds foreground. The grid then covers Hp x Wp: CTAs whose tile
// lies outside the image only write zeros; the others zero the bytes of
// their stores that fall outside it. occ is cleared before the launch and
// written from the stores themselves: a thread whose store holds
// foreground sets its block's byte to 1. Tiles are narrower than 128
// columns, so two CTAs may set one byte; every writer stores the same
// value, so no atomic is needed and no second pass reads the mask.
//
// Streams. One launch takes S independent camera streams, each with its
// own N frames, background and outputs: the grid's z index is the stream.
// A stream's frames are read where its stager left them, through an array
// of S frame pointers in the kernel's parameters (no (S, N, H, W) stack is
// copied on the card); its background, masks, background out and occ are
// the s-th of S equal blocks of their buffers. Whether a stream seeds its
// background from its first filtered frame is one flag for every stream or
// one byte a stream read on the card (a carry's bg_valid, with no read on
// the host). Tiles of different streams never share a CTA, so no
// background is shared; S = 1 is the single-stream call.
//
// Order. The TPU kernel relies on a grid that runs in order on one core;
// here one CTA owns a TH x TW tile and walks the N frames in order itself
// (the background recurrence is the only sequential dependency), keeping
// the background of its owned region plus the morphology reach Rm for the
// whole batch. Each frame it takes the u8 window (owned + P on each side,
// P = blur_r + median_r + Rm) and runs every stage on a region that
// shrinks by that stage's reach, so the owned pixels come out exact.
// Background halo pixels are updated redundantly by neighbouring CTAs with
// identical arithmetic; only owned pixels are written. Tiles with no
// foreground skip morphology: open and close of an all-zero tile are zero
// under cv2's borders.
//
// What bounds it on an H100: the data moved is 1 B read + 1 B written per
// pixel per frame (1.06 GB per 256-frame 1080p batch, 0.32 ms at
// 3.35 TB/s); the bench config's ~42 scalar operations a pixel take about
// as long at 67 T/s. Neither binds: a CTA's frame is a chain of stages
// behind two barriers (row sums ready, the foreground vote; more in tiles
// at an edge or with foreground), and the kernel is bound by that latency
// with 32 warps an SM. The design:
// - 32 x 8 threads; every index inside the frame loop comes from
//   threadIdx and loop counters (no division or modulo by a runtime value
//   there). The REFLECT_101 row offsets and column indices of the window,
//   with as many reflections as the reach needs, are built once per CTA
//   into shared-memory tables; interior tiles take a CTA-uniform straight
//   path without them. The layout of shared memory is computed on
//   the host and read from the kernel's parameters (no registers).
// - The window is double-buffered: frame t + 1's rows go out as cp.async
//   copies (16 bytes where the rows are 16-byte aligned, else 4, else
//   plain byte loads without prefetch) while frame t computes; one
//   wait_group a frame, before the foreground vote, whose barrier also
//   serves as the window's. Each window row copies the aligned
//   chunks of its REFLECT_101 source row that cover the window's in-image
//   columns; tiles at the left or right edge then copy their reflected
//   columns from inside the window (TMA would fill them with zeros).
// - The tap count is a template parameter (1, 3, 5, 7, and a generic
//   instantiation for 9..63): the tap loops unroll and read the taps as
//   constant-bank operands. The row pass makes four uint16 sums (at most
//   255 * 256) a thread from aligned words of the window; the column pass
//   slides down a column segment per thread with a ring of ntaps row sums
//   in registers, and without a median it updates the background and
//   thresholds the pixel in the same pass.
// - The background lives in registers where a thread's share of the M
//   region fits <CX, SEG> (bg_regs_kind: 32 x 64 tiles with morphology,
//   64 x 64 without): each thread owns the same pixels for the whole
//   batch, updates them in place and writes the owned ones out once at
//   the end. Larger regions keep it in shared memory.
// - Owned pixels leave 16 (or 4) bytes a store when the image rows are
//   16- (or 4-) byte aligned, a byte at a time otherwise: the mask buffer
//   is laid out so that the owned region starts 16-byte aligned.
// - Registers are capped at 64 (four CTAs an SM); the tile is chosen on
//   the host (ops/fused_segment.py::launch_plan) from
//   cudaOccupancyMaxActiveBlocksPerMultiprocessor for the instantiation:
//   the least rounds x window area. At 1080p the diff emit takes 64 x 64
//   tiles in one wave; the mask emit 32 x 64 in two, since a tile holding
//   foreground runs the morphology in every frame and a 64 x 64 one made
//   that CTA the kernel's longest (PERF.md has the times per tile).
// Morphology keeps its algorithm: erode and dilate in shared memory over
// the M region, only in tiles with foreground; where the M region lies
// inside the image a thread takes four mask bytes at once (__vminu4).
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
constexpr int kTX = 32;  // threads along a row
constexpr int kTY = 8;   // rows of threads
constexpr int kThreads = kTX * kTY;
constexpr int kMinBlocks = 4;  // CTAs an SM the register budget must allow (64 registers)
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxStreams = 64;  // streams a launch takes (ops/fused_segment.py::MAX_STREAMS)

__host__ __device__ constexpr size_t up16(size_t v) { return (v + 15) & ~size_t(15); }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Background registers a thread owns: the M region is cut into kTY row
// segments of ceil(MH / kTY) rows; thread (tx, ty) owns columns tx + kTX j
// of segment ty. A kernel instantiated with <CX, SEG> keeps them in
// registers when ceil(MW / kTX) <= CX and ceil(MH / kTY) <= SEG: kind 1 is
// <2, 8> (64 x 64 tiles without morphology), kind 2 <3, 5> (32 x 64 tiles
// with a reach up to 4); kind 0, <0, 0>, keeps the background in shared
// memory. Larger register sets spill under the kMinBlocks budget.
__host__ __device__ inline int bg_regs_kind(int MH, int MW) {
  const int cx = cdiv(MW, kTX), seg = cdiv(MH, kTY);
  return (cx <= 2 && seg <= 8) ? 1 : (cx <= 3 && seg <= 5) ? 2 : 0;
}

// Shared-memory layout, computed on the host (size) and passed to the
// kernel in its parameters (carving). Mirrored
// by ops/fused_segment.py::smem_bytes; keep the two in step.
struct Layout {
  int WH, WW, RP, BH, BW, HP, MH, MW, MP, ox;
  int raw0, raw1, hs, blur, bg, m0, m1, rowoff, colidx, total;  // byte offsets
  Layout() = default;
  Layout(int TH, int TW, int P, int Rm, int rm) {
    WH = TH + 2 * P;          // raw window
    WW = TW + 2 * P;
    RP = static_cast<int>(up16(size_t(WW) + 15));  // window row pitch: 16-byte chunks
    BH = TH + 2 * (Rm + rm);  // blurred region
    BW = TW + 2 * (Rm + rm);
    HP = (BW + 3) & ~3;       // row-sum pitch: whole 4-column groups
    MH = TH + 2 * Rm;         // background / mask region
    MW = TW + 2 * Rm;
    ox = (16 - Rm % 16) % 16;  // mask column x sits at ox + x: owned x = Rm aligned
    MP = static_cast<int>(up16(size_t(ox) + MW));
    size_t off = 0;
    raw0 = static_cast<int>(off);   off += up16(size_t(WH) * RP);
    raw1 = static_cast<int>(off);   off += up16(size_t(WH) * RP);
    hs = static_cast<int>(off);     off += up16(size_t(WH) * HP * 2);
    blur = static_cast<int>(off);   off += rm ? up16(size_t(BH) * BW) : 0;
    bg = static_cast<int>(off);     off += bg_regs_kind(MH, MW) ? 0 : up16(size_t(MH) * MW * 4);
    m0 = static_cast<int>(off);     off += up16(size_t(MH) * MP);
    m1 = static_cast<int>(off);     off += up16(size_t(MH) * MP);
    rowoff = static_cast<int>(off); off += up16(size_t(WH) * 4);
    colidx = static_cast<int>(off); off += up16(size_t(WW) * 4);
    total = static_cast<int>(off);
  }
};

// The streams' frame pointers, (N, H, W) each: a kernel parameter of its own.
struct StreamFrames {
  const uint8_t* frames[kMaxStreams];
};

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
  int seed_bg;                    // seed every stream (seed == nullptr)
  const uint8_t* seed;            // or one flag a stream, on the card
  int emit_diff;                  // 1: write rint(|F - B|), not the mask
  int vec;                        // bytes per output store: 16, 4 or 1
  int vin;                        // bytes per cp.async of the window: 16 or 4; 1 = no cp.async
  int Hp, Wp;                     // output rows and row pitch (H, W unless padded)
  int occ_w;                      // occ bytes a block row: Wp / 128 (padded_occ)
  Layout L;                       // from the host: read from the constant bank, no registers
};

// Source index of position i on an axis of length n under REFLECT_101,
// repeated for reaches wider than the axis. Called before the frame loop.
__device__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i >= n ? period - i : i;
}

template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// One sum of the generic row pass: sum_k taps[k] * in[k].
__device__ __forceinline__ int row_sum(const uint8_t* in, const SegParams& p) {
  int acc = 0;
  for (int k = 0; k < p.ntaps; ++k) acc += p.taps[k] * int(in[k]);
  return acc;
}

__device__ __forceinline__ int round_shift(int acc, int shift) {
  return shift ? (acc + (1 << (shift - 1))) >> shift : acc;
}

// One erode or dilate over the M region (pitch MP, column origin ox).
// Reads outside the image see the op's identity (cv2's constant border);
// reads outside the M region see it too, which only disturbs the band that
// the reach bookkeeping discards.
__device__ __forceinline__ void morph_step(const uint8_t* in, uint8_t* out, const Layout& L,
                           int oy, int ox, int H, int W, int k,
                           const unsigned* se, bool erode) {
  const int r = k >> 1;
  const int fill = erode ? 1 : 0;
  for (int y = threadIdx.y; y < L.MH; y += kTY) {
    for (int x = threadIdx.x; x < L.MW; x += kTX) {
      int acc = fill;
      for (int dy = -r; dy <= r; ++dy) {
        const int yy = y + dy;
        const bool yin = yy >= 0 && yy < L.MH && oy + yy >= 0 && oy + yy < H;
        for (unsigned bits = se[dy + r]; bits; bits &= bits - 1) {
          const int xx = x + __ffs(bits) - 1 - r;
          int v = fill;
          if (yin && xx >= 0 && xx < L.MW && ox + xx >= 0 && ox + xx < W)
            v = in[yy * L.MP + L.ox + xx];
          acc = erode ? min(acc, v) : max(acc, v);
        }
      }
      out[y * L.MP + L.ox + x] = (uint8_t)acc;
    }
  }
}

// The same step where the whole M region lies inside the image: no border
// to see, so each thread takes four neighbouring mask bytes at once (one
// 32-bit word, __vminu4/__vmaxu4 over the SE's shifted words, read as two
// aligned words and a funnel shift). It computes the rows whose SE window
// lies in the region and whole words of the row pitch; what it leaves or
// writes outside the region less its radius is in the band the reach
// bookkeeping discards, and every read stays inside the shared memory that
// precedes and follows the buffer.
__device__ __forceinline__ void morph_step_inside(const uint8_t* in, uint8_t* out, const Layout& L, int k,
                                  const unsigned* se, bool erode) {
  const int r = k >> 1;
  const int ng = L.MP >> 2;  // words a row
  for (int y = threadIdx.y + r; y < L.MH - r; y += kTY) {
    for (int g = threadIdx.x; g < ng; g += kTX) {
      unsigned acc = erode ? 0x01010101u : 0u;
      for (int dy = -r; dy <= r; ++dy) {
        const uint8_t* row = in + (y + dy) * L.MP;
        for (unsigned bits = se[dy + r]; bits; bits &= bits - 1) {
          const int off = 4 * g + __ffs(bits) - 1 - r;  // first of the four bytes
          const unsigned* w = reinterpret_cast<const unsigned*>(row + (off & ~3));
          const unsigned v = __funnelshift_r(w[0], w[1], 8 * (off & 3));
          acc = erode ? __vminu4(acc, v) : __vmaxu4(acc, v);
        }
      }
      *reinterpret_cast<unsigned*>(out + y * L.MP + 4 * g) = acc;
    }
  }
}

// Owned pixels out, V bytes a store, to an image of Hp rows and pitch Wp
// (the caller's thread split (orow, ostep, ocol) covers a TH x TW tile
// with TW / V stores a row). Bytes outside the H x W image are written as
// 0; with occ (the frame's (Hp/2, Wp/128) occupancy) a store that holds
// foreground sets its 2 x 128 block's byte (a store never crosses one:
// V divides 128 and x0). A tile outside the image (zeros = true) writes
// zeros alone.
template <int V>
__device__ __forceinline__ void write_owned(uint8_t* out, uint8_t* occ, const uint8_t* mo,
                                            const SegParams& p, int y0, int x0,
                                            int orow, int ostep, int ocol, bool scale,
                                            bool zeros) {
  const int gx = x0 + ocol * V;
  if (gx >= p.Wp) return;
  // in-image bytes of the store, as a keep mask a 32-bit word
  const int nin = min(max(p.W - gx, 0), V);
  unsigned keep[V >= 4 ? V / 4 : 1];
#pragma unroll
  for (int k = 0; k < (V >= 4 ? V / 4 : 1); ++k) {
    const int b = min(max(nin - 4 * k, 0), 4);
    keep[k] = b == 4 ? 0xffffffffu : (1u << (8 * b)) - 1u;
  }
  for (int r = orow; r < p.TH && y0 + r < p.Hp; r += ostep) {
    const int gy = y0 + r;
    const bool in = !zeros && gy < p.H;
    const uint8_t* s = mo + r * p.L.MP + ocol * V;
    uint8_t* d = out + size_t(gy) * p.Wp + gx;
    bool fg;
    if (V == 16) {
      uint4 w = make_uint4(0, 0, 0, 0);
      if (in) {
        w = *reinterpret_cast<const uint4*>(s);
        if (scale) { w.x *= 255u; w.y *= 255u; w.z *= 255u; w.w *= 255u; }  // bytes 0/1
        w.x &= keep[0]; w.y &= keep[1]; w.z &= keep[2]; w.w &= keep[3];
      }
      *reinterpret_cast<uint4*>(d) = w;
      fg = (w.x | w.y | w.z | w.w) != 0;
    } else if (V == 4) {
      uint32_t w = 0;
      if (in) {
        w = *reinterpret_cast<const uint32_t*>(s);
        w = (scale ? w * 255u : w) & keep[0];
      }
      *reinterpret_cast<uint32_t*>(d) = w;
      fg = w != 0;
    } else {
      const uint8_t v = (in && nin) ? (scale ? uint8_t(*s * 255) : *s) : 0;
      *d = v;
      fg = v != 0;
    }
    if (occ && fg) occ[(gy >> 1) * p.occ_w + (gx >> 7)] = 1;
  }
}

// The kernel for NT taps (0: any odd count up to 63, runtime loops) with
// the background in registers (CX x SEG a thread, see bg_regs_kind) or, for
// CX == 0, in shared memory.
template <int NT, int CX, int SEG>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_segment_kernel(const StreamFrames src, const float* __restrict__ bg0_all,
                     uint8_t* __restrict__ masks_all, float* __restrict__ bg_out_all,
                     uint8_t* __restrict__ occ_all, const SegParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, W = p.W, P = p.P, Rm = p.Rm, rm = p.rm;
  const int TH = p.TH, TW = p.TW;
  const Layout& L = p.L;
  uint8_t* raws[2] = {smem + L.raw0, smem + L.raw1};
  uint16_t* hs = reinterpret_cast<uint16_t*>(smem + L.hs);
  uint8_t* blur = smem + L.blur;
  float* bg = reinterpret_cast<float*>(smem + L.bg);
  uint8_t* mbuf[2] = {smem + L.m0, smem + L.m1};
  int* rowoff = reinterpret_cast<int*>(smem + L.rowoff);
  int* colidx = reinterpret_cast<int*>(smem + L.colidx);

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTX + tx;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int wy0 = y0 - P, wx0 = x0 - P;           // window origin
  const int my0 = y0 - Rm, mx0 = x0 - Rm;         // M region origin
  const int by0 = my0 - rm, bx0 = mx0 - rm;       // B region origin
  const size_t HW = size_t(H) * W;
  const int nt = NT ? NT : p.ntaps;
  const int shift = p.shift;
  const float c1 = p.c1, a = p.a, thr = p.thr;
  const bool diff = p.emit_diff;
  const size_t out_frame = size_t(p.Hp) * p.Wp;
  const size_t occ_frame = size_t(p.Hp / 2) * p.occ_w;
  // stream blockIdx.z: its frames, its blocks of the other buffers
  const int sidx = blockIdx.z;
  const uint8_t* __restrict__ frames = src.frames[sidx];
  const float* __restrict__ bg0 = bg0_all + size_t(sidx) * HW;
  float* __restrict__ bg_out = bg_out_all + size_t(sidx) * HW;
  uint8_t* __restrict__ masks = masks_all + size_t(sidx) * p.N * out_frame;
  uint8_t* __restrict__ occ = occ_all ? occ_all + size_t(sidx) * p.N * occ_frame : nullptr;
  const bool seed_bg = p.seed ? p.seed[sidx] != 0 : p.seed_bg != 0;
  const int ocols = TW / p.vec;  // stores per owned row; divides kThreads
  const int ocol = tid % ocols, orow = tid / ocols, ostep = kThreads / ocols;
  if (y0 >= H || x0 >= W) {  // a tile of the padding alone (padded_occ's grid)
    for (int t = 0; t < p.N; ++t) {
      uint8_t* out = masks + size_t(t) * out_frame;
      if (p.vec == 16)
        write_owned<16>(out, nullptr, nullptr, p, y0, x0, orow, ostep, ocol, false, true);
      else if (p.vec == 4)
        write_owned<4>(out, nullptr, nullptr, p, y0, x0, orow, ostep, ocol, false, true);
      else
        write_owned<1>(out, nullptr, nullptr, p, y0, x0, orow, ostep, ocol, false, true);
    }
    return;
  }

  // Once per CTA, before the frame loop (the only divisions and modulos):
  // the window's reflected row offsets and column indices, the window's
  // copy plan, the row segments, the output thread split, the background.
  for (int i = tid; i < L.WH; i += kThreads) rowoff[i] = reflect101(wy0 + i, H) * W;
  for (int i = tid; i < L.WW; i += kThreads) colidx[i] = reflect101(wx0 + i, W);
  const bool interior = wy0 >= 0 && wx0 >= 0 && wy0 + L.WH <= H && wx0 + L.WW <= W;
  const bool m_inside = my0 >= 0 && mx0 >= 0 && my0 + L.MH <= H && mx0 + L.MW <= W;
  // cp.async of the window (vin bytes a copy): each window row copies the
  // aligned chunks of the image that cover its in-image columns, from the
  // row that REFLECT_101 maps it to; raw column xoff + c is window column
  // c. Out-of-image columns are copied from their in-window sources after
  // the wait (colfix); columns whose source lies outside the window feed
  // no in-image pixel and are left as they are.
  const int vin = p.vin;
  const int wx0a = (vin > 1) ? (wx0 >= 0 ? wx0 - wx0 % vin : -cdiv(-wx0, vin) * vin) : wx0;
  const int xoff = wx0 - wx0a;
  const int cs = max(wx0a, 0);
  const int ce = (vin > 1) ? min(cdiv(wx0 + L.WW, vin) * vin, W) : 0;
  const int nch = (vin > 1) ? max(cdiv(ce - cs, vin), 0) : 0;  // chunks a row
  const int lanes = max(min(nch, kThreads), 1);
  const int chrs = kThreads / lanes;  // window rows copied at once
  const int ch0 = tid % lanes, chr0 = tid < lanes * chrs ? tid / lanes : L.WH;
  const bool colfix = vin > 1 && (wx0 < 0 || wx0 + L.WW > W);
  const int seg = cdiv(L.BH, kTY);  // column pass rows a thread, over B
  const int vr0 = min(ty * seg, L.BH), vr1 = min(vr0 + seg, L.BH);
  const int segm = cdiv(L.MH, kTY);  // owned background rows a thread, over M
  const int mr0 = min(ty * segm, L.MH), mr1 = min(mr0 + segm, L.MH);
  float bgr[CX ? CX : 1][SEG ? SEG : 1];
  if (!seed_bg) {
    if constexpr (CX > 0) {
#pragma unroll
      for (int j = 0; j < CX; ++j)
#pragma unroll
        for (int i = 0; i < SEG; ++i) {
          const int gy = my0 + mr0 + i, gx = mx0 + tx + kTX * j;
          const bool in = mr0 + i < mr1 && tx + kTX * j < L.MW && gy >= 0 && gy < H &&
                          gx >= 0 && gx < W;
          bgr[j][i] = in ? bg0[size_t(gy) * W + gx] : 0.f;
        }
    } else {
      for (int y = ty; y < L.MH; y += kTY)
        for (int x = tx; x < L.MW; x += kTX) {
          const int gy = my0 + y, gx = mx0 + x;
          const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
          bg[y * L.MW + x] = in ? bg0[size_t(gy) * W + gx] : 0.f;
        }
    }
  }

  // copies of frame t's window into raw (cp.async; one commit group)
  auto issue = [&](uint8_t* raw, int t) {
    const uint8_t* fr = frames + size_t(t) * HW + cs;
    uint8_t* dst = raw + (cs - wx0a);
    for (int r = chr0; r < L.WH; r += chrs) {
      const uint8_t* src = fr + (interior ? (wy0 + r) * W : rowoff[r]);
      uint8_t* d = dst + r * L.RP;
      for (int j = ch0; j < nch; j += lanes) {
        if (vin == 16) cp_async<16>(d + 16 * j, src + 16 * j);
        else cp_async<4>(d + 4 * j, src + 4 * j);
      }
    }
    cp_async_commit();
  };
  // rowoff is read by other threads than its writers: frame 0's copies
  // wait for the tables (shared memory holds the last CTA's bytes before)
  __syncthreads();
  if (vin > 1) {
    issue(raws[0], 0);
    cp_async_wait_all();
  }
  __syncthreads();

  for (int t = 0; t < p.N; ++t) {
    const bool first = seed_bg && t == 0;
    uint8_t* raw = raws[t & 1];
    // 1. u8 window: frame t's copies landed before the last frame's vote
    // barrier; frame t + 1's go out now, into the buffer frame t - 1 read
    if (vin > 1) {
      if (t + 1 < p.N) issue(raws[(t + 1) & 1], t + 1);
    } else {
      const uint8_t* fr = frames + size_t(t) * HW;
      if (interior) {
        const uint8_t* src = fr + size_t(wy0) * W + wx0;
        for (int r = ty; r < L.WH; r += kTY)
          for (int c = tx; c < L.WW; c += kTX) raw[r * L.RP + c] = src[size_t(r) * W + c];
      } else {
        for (int r = ty; r < L.WH; r += kTY) {
          const uint8_t* src = fr + rowoff[r];
          for (int c = tx; c < L.WW; c += kTX) raw[r * L.RP + c] = src[colidx[c]];
        }
      }
      __syncthreads();
    }
    const uint8_t* win = raw + xoff;
    if (colfix) {
      for (int r = ty; r < L.WH; r += kTY)
        for (int c = tx; c < L.WW; c += kTX) {
          const int gx = wx0 + c, s = colidx[c] - wx0;
          if ((gx < 0 || gx >= W) && s >= 0 && s < L.WW) raw[r * L.RP + xoff + c] = win[r * L.RP + s];
        }
      __syncthreads();
    }
    // 2. row pass: window rows, B columns (B col c is window col c + nt/2)
    if constexpr (NT > 0) {
      // four columns a thread: the window bytes they need as aligned words,
      // funnel-shifted by the window's offset in its word, then unpacked
      constexpr int NQ = (NT + 6) / 4;  // shifted words: bytes 0 .. NT + 2
      const int s8 = 8 * (xoff & 3);
      const int groups = L.HP >> 2;
      for (int r = ty; r < L.WH; r += kTY) {
        const uint32_t* rw = reinterpret_cast<const uint32_t*>(raw + r * L.RP + (xoff & ~3));
        uint32_t* hw = reinterpret_cast<uint32_t*>(hs + r * L.HP);
        for (int g = tx; g < groups; g += kTX) {
          uint32_t w[NQ + 1];
#pragma unroll
          for (int q = 0; q <= NQ; ++q) w[q] = rw[g + q];
          int b[4 * NQ];
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const uint32_t v = __funnelshift_r(w[q], w[q + 1], s8);
#pragma unroll
            for (int e = 0; e < 4; ++e) b[4 * q + e] = (v >> (8 * e)) & 0xffu;
          }
          int o[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            o[i] = 0;
#pragma unroll
            for (int k = 0; k < NT; ++k) o[i] += p.taps[k] * b[i + k];
          }
          hw[2 * g] = uint32_t(o[0]) | (uint32_t(o[1]) << 16);
          hw[2 * g + 1] = uint32_t(o[2]) | (uint32_t(o[3]) << 16);
        }
      }
    } else {
      for (int r = ty; r < L.WH; r += kTY)
        for (int c = tx; c < L.BW; c += kTX)
          hs[r * L.HP + c] = (uint16_t)row_sum(win + r * L.RP + c, p);
    }
    __syncthreads();

    // background update of M pixel (y, x), background b, filtered value f,
    // and its threshold (or rounded magnitude); returns the mask byte
    auto update = [&](int y, int x, float& b, int f_int) -> int {
      const int gy = my0 + y, gx = mx0 + x;
      int m = 0;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const float f = float(f_int);
        b = __fadd_rn(__fmul_rn(c1, first ? f : b), __fmul_rn(a, f));
        const float d = fabsf(__fsub_rn(f, b));
        m = diff ? int(fminf(rintf(d), 255.f)) : (d > thr ? 1 : 0);
      }
      mbuf[0][y * L.MP + L.ox + x] = (uint8_t)m;
      return m;
    };

    // 3. column pass + cv2's single rounding: each thread slides down rows
    // [vr0, vr1) of its columns with a ring of the last nt row sums; without
    // a median B == M ([vr0, vr1) is the thread's own segment) and the
    // pixel's background is updated here
    int any = 0;
    if constexpr (CX > 0) {
      if (!rm) {
#pragma unroll
        for (int j = 0; j < CX; ++j) {
          const int c = tx + kTX * j;
          if (c < L.BW && vr0 < vr1) {
            const uint16_t* col = hs + c;
            int ring[NT ? NT : 1];
            if constexpr (NT > 0) {
#pragma unroll
              for (int k = 1; k < NT; ++k) ring[k] = col[(vr0 + k - 1) * L.HP];
            }
#pragma unroll
            for (int i = 0; i < SEG; ++i) {
              const int r = vr0 + i;
              if (r < vr1) {
                int acc = 0;
                if constexpr (NT > 0) {
#pragma unroll
                  for (int k = 0; k + 1 < NT; ++k) ring[k] = ring[k + 1];
                  ring[NT - 1] = col[(r + NT - 1) * L.HP];
#pragma unroll
                  for (int k = 0; k < NT; ++k) acc += p.taps[k] * ring[k];
                } else {
                  for (int k = 0; k < nt; ++k) acc += p.taps[k] * col[(r + k) * L.HP];
                }
                any |= update(r, c, bgr[j][i], round_shift(acc, shift));
              }
            }
          }
        }
      }
    }
    if (CX == 0 || rm) {  // into blur (median), or the shared-memory background
      for (int c = tx; c < L.BW; c += kTX) {
        if (vr0 >= vr1) break;
        const uint16_t* col = hs + c;
        int ring[NT ? NT : 1];
        if constexpr (NT > 0) {
#pragma unroll
          for (int k = 1; k < NT; ++k) ring[k] = col[(vr0 + k - 1) * L.HP];
        }
        for (int r = vr0; r < vr1; ++r) {
          int acc = 0;
          if constexpr (NT > 0) {
#pragma unroll
            for (int k = 0; k + 1 < NT; ++k) ring[k] = ring[k + 1];
            ring[NT - 1] = col[(r + NT - 1) * L.HP];
#pragma unroll
            for (int k = 0; k < NT; ++k) acc += p.taps[k] * ring[k];
          } else {
            for (int k = 0; k < nt; ++k) acc += p.taps[k] * col[(r + k) * L.HP];
          }
          const int v = round_shift(acc, shift);
          if (rm) blur[r * L.BW + c] = (uint8_t)v;
          else any |= update(r, c, bg[r * L.MW + c], v);
        }
      }
    }
    // 4. median 3x3 at clamped (replicated) coordinates, then the update,
    // over each thread's own background segment
    if (rm) {
      __syncthreads();
      auto median_at = [&](int y, int x) -> int {
        const int gy = my0 + y, gx = mx0 + x;
        if (gy < 0 || gy >= H || gx < 0 || gx >= W) return 0;
        int w9[9];
        int k = 0;
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
          for (int dx = -1; dx <= 1; ++dx) {
            const int yy = min(max(gy + dy, 0), H - 1) - by0;
            const int xx = min(max(gx + dx, 0), W - 1) - bx0;
            w9[k++] = blur[yy * L.BW + xx];
          }
        return median9(w9);
      };
      if constexpr (CX > 0) {
#pragma unroll
        for (int j = 0; j < CX; ++j)
#pragma unroll
          for (int i = 0; i < SEG; ++i) {
            const int y = mr0 + i, x = tx + kTX * j;
            if (y < mr1 && x < L.MW) any |= update(y, x, bgr[j][i], median_at(y, x));
          }
      } else {
        for (int x = tx; x < L.MW; x += kTX)
          for (int y = mr0; y < mr1; ++y) any |= update(y, x, bg[y * L.MW + x], median_at(y, x));
      }
    }
    // the foreground vote; its barrier also publishes frame t + 1's window
    if (vin > 1) cp_async_wait_all();
    any = __syncthreads_or(any) && !diff;
    // 5. morphology, ping-pong over the M region
    int cur = 0;
    if (any) {
      for (int s = 0; s < 4; ++s) {
        if (!p.stage_k[s]) continue;
        const bool erode = (s == 0 || s == 3);
        for (int it = 0; it < p.stage_iters[s]; ++it) {
          if (m_inside)
            morph_step_inside(mbuf[cur], mbuf[cur ^ 1], L, p.stage_k[s], p.stage_se[s], erode);
          else
            morph_step(mbuf[cur], mbuf[cur ^ 1], L, my0, mx0, H, W, p.stage_k[s],
                       p.stage_se[s], erode);
          __syncthreads();
          cur ^= 1;
        }
      }
    }
    // 6. owned pixels out: 0/255 from the 0/1 mask, or the magnitudes. The
    // next frame writes no buffer these reads use before its first barrier.
    uint8_t* out = masks + size_t(t) * out_frame;
    uint8_t* occ_t = occ ? occ + size_t(t) * occ_frame : nullptr;
    const uint8_t* mo = mbuf[cur] + Rm * L.MP + L.ox + Rm;
    if (p.vec == 16)
      write_owned<16>(out, occ_t, mo, p, y0, x0, orow, ostep, ocol, !diff, false);
    else if (p.vec == 4)
      write_owned<4>(out, occ_t, mo, p, y0, x0, orow, ostep, ocol, !diff, false);
    else
      write_owned<1>(out, occ_t, mo, p, y0, x0, orow, ostep, ocol, !diff, false);
  }

  // the owned background out, once
  if constexpr (CX > 0) {
#pragma unroll
    for (int j = 0; j < CX; ++j)
#pragma unroll
      for (int i = 0; i < SEG; ++i) {
        const int r = mr0 + i - Rm, c = tx + kTX * j - Rm;
        const int gy = y0 + r, gx = x0 + c;
        if (mr0 + i < mr1 && r >= 0 && r < TH && c >= 0 && c < TW && gy < H && gx < W)
          bg_out[size_t(gy) * W + gx] = bgr[j][i];
      }
  } else {
    __syncthreads();  // the last frame's background, written by its owners
    for (int r = ty; r < TH; r += kTY)
      for (int c = tx; c < TW; c += kTX) {
        const int gy = y0 + r, gx = x0 + c;
        if (gy < H && gx < W) bg_out[size_t(gy) * W + gx] = bg[(r + Rm) * L.MW + c + Rm];
      }
  }
}

using KernelFn = void (*)(const StreamFrames, const float*, uint8_t*, float*, uint8_t*,
                          const SegParams);

template <int NT>
KernelFn kernel_with(int bg_kind) {
  return bg_kind == 1 ? fused_segment_kernel<NT, 2, 8>
       : bg_kind == 2 ? fused_segment_kernel<NT, 3, 5>
                      : fused_segment_kernel<NT, 0, 0>;
}

// The instantiation for a tap count (unrolled for 1, 3, 5 and 7, generic
// for 9..63) and the background's home at this layout (bg_regs_kind).
KernelFn kernel_for(int ntaps, const Layout& L) {
  const int kind = bg_regs_kind(L.MH, L.MW);
  switch (ntaps) {
    case 1: return kernel_with<1>(kind);
    case 3: return kernel_with<3>(kind);
    case 5: return kernel_with<5>(kind);
    case 7: return kernel_with<7>(kind);
    default: return kernel_with<0>(kind);
  }
}

bool tile_ok(int tile_h, int tile_w) {
  return tile_h > 0 && (tile_w == 32 || tile_w == 64 || tile_w == 128);
}

}  // namespace

extern "C" const char* tpuva_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory of one CTA and CTAs resident per SM for the instantiation
// of ntaps at a tile, from cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int tpuva_fused_segment_occupancy(int ntaps, int median, int Rm,
                                             int tile_h, int tile_w,
                                             int* smem_bytes, int* blocks_per_sm) {
  if (ntaps < 1 || ntaps > kMaxTaps || ntaps % 2 == 0 || Rm < 0 || !tile_ok(tile_h, tile_w))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rm = median ? 1 : 0;
  const Layout L(tile_h, tile_w, ntaps / 2 + rm + Rm, Rm, rm);
  *smem_bytes = L.total;
  *blocks_per_sm = 0;
  if (L.total > kMaxSmem) return 0;
  const KernelFn k = kernel_for(ntaps, L);
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L.total);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k, kThreads, L.total);
  return static_cast<int>(err);
}

// S streams in one launch (1 <= S <= kMaxStreams): frames, a host array of
// S pointers to (N,H,W) u8 on the card; bg0 (S,H,W) f32 -> masks
// (S,N,Hp,Wp) u8 0/255 (emit_diff: the rounded magnitudes), bg_out (S,H,W).
// seed: null (seed_bg for every stream) or S bytes on the card, nonzero
// where that stream seeds its background. Unpadded, Hp = H and Wp = W and
// occ is null; padded_occ (mask emit only) passes Hp >= H even, Wp >= W a
// multiple of 128 and occ (S, N, Hp/2, Wp/128) u8, which the launch clears
// and the kernel sets (see the top of this file).
// Host arrays: taps[ntaps]; stage_k[4], stage_iters[4], stage_se[4][31].
// tile_w is 32, 64 or 128. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int tpuva_fused_segment(
    const uint8_t* const* frames, int S, const float* bg0, uint8_t* masks, float* bg_out,
    int N, int H, int W, float c1, float a, float thr,
    const int* taps, int ntaps, int shift, int median,
    const int* stage_k, const int* stage_iters, const unsigned* stage_se,
    int seed_bg, const uint8_t* seed, int emit_diff, int tile_h, int tile_w,
    int Hp, int Wp, uint8_t* occ, void* stream) {
  if (S < 1 || S > kMaxStreams || N <= 0 || H <= 0 || W <= 0 || ntaps < 1 || ntaps > kMaxTaps ||
      ntaps % 2 == 0 || !tile_ok(tile_h, tile_w) || Hp < H || Wp < W ||
      (occ == nullptr && (Hp != H || Wp != W)) ||
      (occ != nullptr && (Hp % 2 || Wp % 128 || emit_diff)))
    return static_cast<int>(cudaErrorInvalidValue);
  SegParams p{};
  p.N = N; p.H = H; p.W = W;
  p.c1 = c1; p.a = a; p.thr = thr;
  p.ntaps = ntaps; p.shift = shift;
  int tap_sum = 0;
  for (int k = 0; k < ntaps; ++k) {
    if (taps[k] < 0) return static_cast<int>(cudaErrorInvalidValue);
    p.taps[k] = taps[k];
    tap_sum += taps[k];
  }
  if (tap_sum * 255 > 0xffff) return static_cast<int>(cudaErrorInvalidValue);  // uint16 row sums
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
  if (emit_diff && p.Rm) return static_cast<int>(cudaErrorInvalidValue);
  p.P = ntaps / 2 + p.rm + p.Rm;  // blur + median + morphology reach
  p.TH = tile_h; p.TW = tile_w;
  p.seed_bg = seed_bg;
  p.seed = seed;
  p.emit_diff = emit_diff ? 1 : 0;
  p.Hp = Hp; p.Wp = Wp;
  p.occ_w = occ ? Wp / 128 : 0;
  // widest stores and copies the rows' alignment allows
  const bool out16 = reinterpret_cast<uintptr_t>(masks) % 16 == 0;
  p.vec = (out16 && Wp % 16 == 0) ? 16 : (out16 && Wp % 4 == 0) ? 4 : 1;
  StreamFrames src{};
  uintptr_t in_addr = 0;
  for (int i = 0; i < S; ++i) {
    if (frames[i] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    src.frames[i] = frames[i];
    in_addr |= reinterpret_cast<uintptr_t>(frames[i]);  // every stream's alignment
  }
  p.vin = (in_addr % 16 == 0 && W % 16 == 0) ? 16 : (in_addr % 4 == 0 && W % 4 == 0) ? 4 : 1;
  p.L = Layout(tile_h, tile_w, p.P, p.Rm, p.rm);
  const Layout& L = p.L;
  if (L.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidConfiguration);
  const KernelFn k = kernel_for(ntaps, L);
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (occ != nullptr &&
      (err = cudaMemsetAsync(occ, 0, size_t(S) * N * (Hp / 2) * (Wp / 128), s)) != cudaSuccess)
    return static_cast<int>(err);
  const dim3 grid((Wp + tile_w - 1) / tile_w, (Hp + tile_h - 1) / tile_h, S);
  k<<<grid, dim3(kTX, kTY), L.total, s>>>(src, bg0, masks, bg_out, occ, p);
  return static_cast<int>(cudaGetLastError());
}
