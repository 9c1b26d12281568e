// The band path's reconciliation and piece tables (kernels KB-recon and
// KB-table) for Hopper, sm_90a.
//
// Replace the XLA stages of tpuva's spatial processor that follow the band
// labels (tpuva/dist/spatial.py; KB-labels, the band labels on global scan
// keys, is K3's sequence in csrc/ccl.cu, tpuva_band_labels):
//   recon_body (:229): a round of the cross-band reconciliation, each band's
//     two edge rows lowered by the neighbour bands' edge rows and the band
//     re-swept to its fixed point;
//   the piece table (:286-294): the C largest of (value + 1) over the
//     band's piece roots, with multiplicity (lax.top_k), adjacent
//     duplicates dropped;
//   the table's sums (:295-312): area, sum x and sum y of the pixels whose
//     value + 1 is in the table (a bf16 one-hot contracted on the MXU).
// The plain PyTorch versions are tpuva_torch/ops/band_ccl.py::
// recon_edges_plain, recon_min_plain, piece_table_plain and
// piece_sums_plain; each pair is bit-equal.
//
// The piece form. After KB-labels a band's labels are constant on each of
// its 8-connected pieces (the piece's minimum global key), and the
// reconciliation only ever lowers whole pieces: it takes a piece's edge
// pixels' minimum with the neighbour band's edge values, and tpuva's
// re-sweep spreads that minimum over the piece. So a piece's value is kept
// once, val[root block] (the block of its minimum key, key >> 2 less the
// band's base), and a pixel's value is val[(label - kbase) >> 2]. No sweep
// runs; a round is two launches a band:
//   kb_edges: the band's two edge rows as their values now, a snapshot
//     (N, 2, W), and the band's changed flag zeroed;
//   kb_recon_min: each foreground edge pixel takes the minimum of its
//     neighbour band's snapshot row at x - 1, x, x + 1 (tpuva's adj); where
//     that is below its own snapshot value, atomicMin on its piece's value
//     and the flag set.
// Every band's snapshot is taken before any band's minimum (the caller
// launches all kb_edges first): tpuva's round reads its neighbours' edges
// from before the round (ppermute of the carried labels), so a value
// crosses one band a round, and tp_recon_rounds counts the same rounds. The
// host reads the flags once a round, tpuva's while_loop condition.
//
// kb_table: a CTA a frame. The frame's roots are K3's (KB-labels lists
// them), their values val + 1. Where there are more than C, a radix select
// (three passes of 11, 11 and 9 bits over the root list, the histogram in
// shared memory, a warp finding the digit) gives T, the C-th largest with
// multiplicity; the top C are then every value above T and at least one T,
// so the table is the distinct values >= T (all of them where the roots
// are at most C). Those (at most C) are sorted ascending by a bitonic sort
// in shared memory (global scratch past kSortSmem), and each first of its
// kind is written at its rank; the rest of the C entries are sent + 2
// (tpuva's fill for a duplicate or an absent entry, sorted last).
//
// kb_sums: a CTA kStripsPerCta of a frame's strips (K3's: 2 rows x 256
// pixels, a warp a strip, 16 pixels a lane), only the strips K3 found
// occupied. The frame's table in shared memory; each foreground pixel's
// value + 1 (its label's root block's val, looked up again only where the
// label changes along the lane's run) found by binary search; a lane sums
// its run of pixels of one entry and adds (count, sum x, sum y + y0) with
// 64-bit shared atomics when the entry changes; one flush of the CTA's
// nonzero entries to the (N, C, 3) int64 sums by 64-bit global atomics.
// Past kSumsSmemC entries the table and the sums stay in global memory.
// Integer atomics make every sum independent of their order.
//
// What bounds them on an H100: memory, and little of it. KB-recon moves a
// few edge rows a band a round; kb_table reads the root list and its
// values once a pass; kb_sums reads the labels of the occupied strips only
// (the bench clip: a few percent of them) and the values of their pieces.
// On a sparse frame what is left is the launches' latency.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kEdgeThreads = 256;
constexpr int kTableThreads = 1024;
constexpr int kSortSmem = 8192;         // ints: kb_table sorts in shared memory up to this
constexpr int kSumsThreads = 256;       // 8 warps, a strip each at a time
constexpr int kStripsPerCta = 64;
constexpr int kSumsSmemC = 1024;        // table entries kb_sums keeps in shared memory
constexpr int SW = 128;                 // a strip, in 2x2 blocks (csrc/ccl.cu)

struct Band {
  int N, Hb, W;      // the band's labels (N, Hb, W)
  int r0, y0;        // its first row's parity and its row in the image
  int kbase, sent;   // global key of block 0's first key; background label
  int nblk;          // val and roots a frame: Hbk * Wb
  __device__ int value(const int* val, int n, int label) const {
    return val[size_t(n) * nblk + ((label - kbase) >> 2)];
  }
};

// The band's edge rows as their values: edges (N, 2, W), row 0 then row
// Hb - 1; background sent. Zeroes the changed flag.
__global__ void __launch_bounds__(kEdgeThreads)
kb_edges(Band B, const int* __restrict__ lab, const int* __restrict__ val,
         int* __restrict__ edges, int* __restrict__ flag) {
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i == 0) *flag = 0;
  if (i >= size_t(B.N) * 2 * B.W) return;
  const int x = int(i % B.W), e = int(i / B.W % 2), n = int(i / (2 * size_t(B.W)));
  const int y = e ? B.Hb - 1 : 0;
  const int l = lab[(size_t(n) * B.Hb + y) * B.W + x];
  edges[i] = l == B.sent ? B.sent : B.value(val, n, l);
}

// Each foreground edge pixel against its neighbour band's snapshot row
// (above for row 0, below for row Hb - 1; null at the image's edge; frames
// nb_stride ints apart): the minimum of its x - 1, x, x + 1, where below
// the pixel's own snapshot value, lowers its piece's value and sets flag.
__global__ void __launch_bounds__(kEdgeThreads)
kb_recon_min(Band B, const int* __restrict__ lab, int* val, const int* __restrict__ edges,
             const int* __restrict__ above, long long above_stride,
             const int* __restrict__ below, long long below_stride, int* flag) {
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= size_t(B.N) * 2 * B.W) return;
  const int x = int(i % B.W), e = int(i / B.W % 2), n = int(i / (2 * size_t(B.W)));
  const int* nb = e ? below : above;
  if (nb == nullptr) return;
  nb += size_t(n) * (e ? below_stride : above_stride);
  const int l = lab[(size_t(n) * B.Hb + (e ? B.Hb - 1 : 0)) * B.W + x];
  if (l == B.sent) return;
  int c = nb[x];
  if (x > 0) c = min(c, nb[x - 1]);
  if (x + 1 < B.W) c = min(c, nb[x + 1]);
  if (c < edges[i]) {
    atomicMin(&val[size_t(n) * B.nblk + ((l - B.kbase) >> 2)], c);
    *reinterpret_cast<volatile int*>(flag) = 1;
  }
}

// Exclusive rank of flag among the CTA's threads in thread order, and the
// number of flags set; every thread of the CTA calls it (barriers inside).
__device__ int2 block_rank(bool flag, int* warp_incl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const unsigned bal = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_incl[warp] = __popc(bal);
  __syncthreads();
  if (warp == 0) {
    int v = lane < nw ? warp_incl[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    if (lane < nw) warp_incl[lane] = v;
  }
  __syncthreads();
  const int2 r = make_int2((warp ? warp_incl[warp - 1] : 0) + __popc(bal & ((1u << lane) - 1u)),
                           warp_incl[nw - 1]);
  __syncthreads();  // warp_incl is reused by the next call
  return r;
}

// A frame's piece table: table (N, C) int32, the distinct values + 1 of
// the top C of the frame's roots (with multiplicity) ascending, then
// sent + 2. cand: P ints of dynamic shared memory where P <= kSortSmem,
// else frame n's row of scratch (N, P); P the power of two >= C.
__global__ void __launch_bounds__(kTableThreads)
kb_table(Band B, const int* __restrict__ val, const int* __restrict__ roots,
         const int* __restrict__ nroots, int C, int P, int* __restrict__ scratch,
         int* __restrict__ table) {
  extern __shared__ int smem[];
  __shared__ int hist[2048];
  __shared__ int warp_incl[32];
  __shared__ int s_digit, s_k, s_cnt;
  const int n = blockIdx.x, tid = threadIdx.x;
  const int nr = nroots[n];
  const int* rl = roots + size_t(n) * B.nblk;
  const int* vf = val + size_t(n) * B.nblk;
  int* cand = scratch ? scratch + size_t(n) * P : smem;
  // T: the C-th largest value, where there are more than C roots
  int prefix = 0, pmask = 0, k = C;
  const bool select = nr > C;
  if (select) {
    for (int pass = 0; pass < 3; ++pass) {
      const int shift = pass == 0 ? 20 : pass == 1 ? 9 : 0;
      const int nb = pass == 2 ? 512 : 2048;
      for (int j = tid; j < 2048; j += blockDim.x) hist[j] = 0;
      __syncthreads();
      for (int j = tid; j < nr; j += blockDim.x) {
        const int v = vf[rl[j]] + 1;
        if ((v & pmask) == prefix) atomicAdd(&hist[(v >> shift) & (nb - 1)], 1);
      }
      __syncthreads();
      if (tid < 32) {  // the digit holding the k-th largest: a lane 1/32 of the bins
        const int per = nb / 32, hi = nb - tid * per;  // lane 0 the top bins
        int sum = 0;
        for (int j = hi - per; j < hi; ++j) sum += hist[j];
        int incl = sum;  // the values in this lane's bins and above
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, incl, o);
          if (tid >= o) incl += t;
        }
        const int excl = incl - sum;
        if (excl < k && k <= incl) {
          int acc = excl, d = hi - 1;
          for (; d >= hi - per; --d) {
            if (acc + hist[d] >= k) break;
            acc += hist[d];
          }
          s_digit = d;
          s_k = k - acc;
        }
      }
      __syncthreads();
      prefix |= s_digit << shift;
      pmask |= (nb - 1) << shift;
      k = s_k;
      __syncthreads();
    }
  }
  // the candidates: every value above T, and T once (all values where
  // there are at most C roots)
  if (tid == 0) s_cnt = 0;
  __syncthreads();
  for (int j = tid; j < nr; j += blockDim.x) {
    const int v = vf[rl[j]] + 1;
    if (!select || v > prefix) cand[atomicAdd(&s_cnt, 1)] = v;
  }
  __syncthreads();
  if (tid == 0 && select) cand[s_cnt++] = prefix;
  __syncthreads();
  const int m = s_cnt;
  for (int j = m + tid; j < P; j += blockDim.x) cand[j] = INT_MAX;
  __syncthreads();
  // bitonic sort, ascending
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int j = tid; j < P / 2; j += blockDim.x) {
        const int lo = 2 * j - (j & (stride - 1)), hi = lo + stride;
        const bool up = (lo & size) == 0;
        const int a = cand[lo], b = cand[hi];
        if ((a > b) == up) {
          cand[lo] = b;
          cand[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  // each first of its kind at its rank, then sent + 2
  int* out = table + size_t(n) * C;
  int running = 0;
  for (int base = 0; base < m; base += blockDim.x) {
    const int j = base + tid;
    const bool first = j < m && (j == 0 || cand[j] != cand[j - 1]);
    const int2 r = block_rank(first, warp_incl);
    if (first) out[running + r.x] = cand[j];
    running += r.y;
  }
  for (int j = running + tid; j < C; j += blockDim.x) out[j] = B.sent + 2;
}

// Binary search of v in the ascending t[0 .. C): its index, or -1.
__device__ __forceinline__ int find_entry(const int* t, int C, int v) {
  int lo = 0, hi = C;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo < C && t[lo] == v ? lo : -1;
}

// Adds a lane's run of pixels of entry j to acc (count, sum x, sum y).
__device__ __forceinline__ void add_run(unsigned long long* acc, int j, unsigned long long cnt,
                                        unsigned long long sx, unsigned long long sy) {
  if (j < 0 || cnt == 0) return;
  atomicAdd(&acc[3 * j], cnt);
  atomicAdd(&acc[3 * j + 1], sx);
  atomicAdd(&acc[3 * j + 2], sy);
}

// The table's sums over the occupied strips (K3's occupancy, (N, Hbk, S))
// of kStripsPerCta strips of frame blockIdx.y: sums (N, C, 3) int64, zero
// before the launch. Shared memory: the table and 3 C u64 where C <=
// kSumsSmemC, else both stay in global memory.
__global__ void __launch_bounds__(kSumsThreads)
kb_sums(Band B, const int* __restrict__ lab, const int* __restrict__ val,
        const uint8_t* __restrict__ occ, int S, const int* __restrict__ table, int C,
        unsigned long long* sums) {
  extern __shared__ unsigned long long sacc[];
  const int n = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool shared = C <= kSumsSmemC;
  unsigned long long* acc = shared ? sacc : sums + size_t(n) * C * 3;
  int* st = reinterpret_cast<int*>(sacc + 3 * size_t(C));
  const int* t = shared ? st : table + size_t(n) * C;
  if (shared) {
    for (int j = tid; j < C; j += blockDim.x) st[j] = table[size_t(n) * C + j];
    for (int j = tid; j < 3 * C; j += blockDim.x) sacc[j] = 0;
    __syncthreads();
  }
  const int Hbk = (B.Hb + B.r0 + 1) / 2, nstrips = Hbk * S;
  const int s0 = blockIdx.x * kStripsPerCta, s1 = min(s0 + kStripsPerCta, nstrips);
  for (int s = s0 + warp; s < s1; s += kSumsThreads / 32) {
    if (!occ[size_t(n) * nstrips + s]) continue;
    const int yk = 2 * (s / S) + (lane >> 4) - B.r0;  // the band's row
    const int x0 = (s % S) * 2 * SW + 16 * (lane & 15);
    if (yk < 0 || yk >= B.Hb || x0 >= B.W) continue;
    const int* row = lab + (size_t(n) * B.Hb + yk) * B.W;
    const unsigned long long yg = unsigned(B.y0 + yk);
    int last = B.sent, j = -1;
    unsigned long long cnt = 0, sx = 0;
    for (int x = x0; x < min(x0 + 16, B.W); ++x) {
      const int l = row[x];
      if (l != last) {
        const int jn = l == B.sent ? -1 : find_entry(t, C, B.value(val, n, l) + 1);
        last = l;
        if (jn != j) {
          add_run(acc, j, cnt, sx, cnt * yg);
          j = jn;
          cnt = sx = 0;
        }
      }
      if (j >= 0) {
        ++cnt;
        sx += unsigned(x);
      }
    }
    add_run(acc, j, cnt, sx, cnt * yg);
  }
  if (shared) {
    __syncthreads();
    unsigned long long* out = sums + size_t(n) * C * 3;
    for (int j = tid; j < 3 * C; j += blockDim.x)
      if (sacc[j]) atomicAdd(&out[j], sacc[j]);
  }
}

cudaError_t band_args(int N, int Hb, int W, int r0, int y0, int kbase, int sent, Band* B) {
  if (N <= 0 || Hb <= 0 || W <= 0 || (r0 != 0 && r0 != 1) || ((y0 - r0) & 1) || sent <= 0)
    return cudaErrorInvalidValue;
  const long long nblk = (long long)((Hb + r0 + 1) / 2) * ((W + 1) / 2);
  if (nblk * 4 >= (1LL << 31) || (long long)sent + 2 >= (1LL << 31))
    return cudaErrorInvalidValue;
  *B = Band{N, Hb, W, r0, y0, kbase, sent, int(nblk)};
  return cudaSuccess;
}

}  // namespace

// KB-recon, its first launch: edges (N, 2, W) int32, the band's edge rows'
// values (rows 0 and Hb - 1, background sent); flag (1,) int32 zeroed.
// lab (N, Hb, W) int32 and val (N, nblk) int32 as tpuva_band_labels gives
// them. Returns cudaGetLastError() (0 = launched).
extern "C" int tpuva_kb_edges(const int* lab, const int* val, int N, int Hb, int W, int r0,
                              int y0, int kbase, int sent, int* edges, int* flag, void* stream) {
  Band B;
  cudaError_t err = band_args(N, Hb, W, r0, y0, kbase, sent, &B);
  if (err != cudaSuccess || !lab || !val || !edges || !flag) return static_cast<int>(
      err != cudaSuccess ? err : cudaErrorInvalidValue);
  const size_t items = size_t(N) * 2 * W;
  kb_edges<<<unsigned((items + kEdgeThreads - 1) / kEdgeThreads), kEdgeThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(B, lab, val, edges, flag);
  return static_cast<int>(cudaGetLastError());
}

// KB-recon, its second launch: each foreground edge pixel of the band
// against its neighbours' snapshot rows (above: the band above's last row,
// below: the band below's first row, each (N, W) with frames *_stride ints
// apart, null at the image's edges), val lowered in place and flag set
// where a piece's value falls. edges: this band's tpuva_kb_edges output of
// the round. Returns cudaGetLastError() (0 = launched).
extern "C" int tpuva_kb_recon_min(const int* lab, int* val, const int* edges, const int* above,
                                  long long above_stride, const int* below,
                                  long long below_stride, int N, int Hb, int W, int r0, int y0,
                                  int kbase, int sent, int* flag, void* stream) {
  Band B;
  cudaError_t err = band_args(N, Hb, W, r0, y0, kbase, sent, &B);
  if (err != cudaSuccess || !lab || !val || !edges || !flag) return static_cast<int>(
      err != cudaSuccess ? err : cudaErrorInvalidValue);
  const size_t items = size_t(N) * 2 * W;
  kb_recon_min<<<unsigned((items + kEdgeThreads - 1) / kEdgeThreads), kEdgeThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(B, lab, val, edges, above, above_stride,
                                                      below, below_stride, flag);
  return static_cast<int>(cudaGetLastError());
}

// KB-table: table (N, C) int32 (ascending, sent + 2 past its entries)
// from val, roots and nroots as tpuva_band_labels gives them (val lowered
// by the reconciliation); scratch: N * P ints (P the power of two >= C), the
// sort's candidates where P > kSortSmem. Returns cudaGetLastError() (0 = launched).
extern "C" int tpuva_kb_table(const int* val, const int* roots, const int* nroots, int N, int Hb,
                              int W, int r0, int y0, int kbase, int sent, int C, int* scratch,
                              int* table, void* stream) {
  Band B;
  cudaError_t err = band_args(N, Hb, W, r0, y0, kbase, sent, &B);
  if (err != cudaSuccess) return static_cast<int>(err);
  int P = 1;
  while (P < C) P <<= 1;
  const bool global = P > kSortSmem;
  if (C < 1 || !val || !roots || !nroots || !table || !scratch)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = global ? 0 : sizeof(int) * size_t(P);
  kb_table<<<N, kTableThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      B, val, roots, nroots, C, P, global ? scratch : nullptr, table);
  return static_cast<int>(cudaGetLastError());
}

// KB-table's sums: sums (N, C, 3) int64 of (1, x, y0 + y) over the band's
// foreground pixels whose value + 1 is in their frame's table (from
// tpuva_kb_table), visiting the strips strip_occ (N, Hbk, S) u8 (KB-labels'
// occupancy) calls occupied. Returns cudaGetLastError() (0 = launched).
extern "C" int tpuva_kb_sums(const int* lab, const int* val, const uint8_t* strip_occ, int N,
                             int Hb, int W, int r0, int y0, int kbase, int sent,
                             const int* table, int C, long long* sums, void* stream) {
  Band B;
  cudaError_t err = band_args(N, Hb, W, r0, y0, kbase, sent, &B);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C < 1 || N >= 65536 || !lab || !val || !strip_occ || !table || !sums)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((err = cudaMemsetAsync(sums, 0, sizeof(long long) * 3 * size_t(N) * C, s)) != cudaSuccess)
    return static_cast<int>(err);
  const int S = (((W + 1) / 2) + SW - 1) / SW, Hbk = (Hb + r0 + 1) / 2;
  const size_t smem = C <= kSumsSmemC ? (3 * sizeof(long long) + sizeof(int)) * size_t(C) : 0;
  const dim3 grid((Hbk * S + kStripsPerCta - 1) / kStripsPerCta, N);
  kb_sums<<<grid, kSumsThreads, smem, s>>>(B, lab, val, strip_occ, S, table, C,
                                           reinterpret_cast<unsigned long long*>(sums));
  return static_cast<int>(cudaGetLastError());
}
