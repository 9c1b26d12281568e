// Tracker scan over a batch's frames (kernel K5) for Hopper, sm_90a.
//
// Replaces tpuva/graph/pipeline.py:341 _finish_batch's lax.scan (:365) of
// tpuva/track/table.py:66 track_update with tpuva/track/assign.py:187
// hungarian_assign or :39 greedy_assign, which is XLA on the TPU. Per
// frame t of N, in order:
//   cost[i][j] = sqrt(dx*dx + dy*dy) between track slot i and detection j,
//     BIG where the slot is inactive or the detection invalid;
//   the assignment: Hungarian (the unique-column-minimum fast path, else
//     Jonker-Volgenant on the capped matrix, then the max_dist gate) or
//     greedy (min(T, D) rounds of the first global minimum <= max_dist);
//   matched updates, survivors compacted down in order, births appended at
//     n_still + rank - 1 while capacity remains, next_id;
//   one row (tid, frame, x, y, area) per detection, valid where it was
//     matched or born.
// The plain PyTorch version is tpuva_torch/track/scan.py::track_scan_plain
// (one torch track_update a frame); the two are bit-equal: every float is
// the same IEEE operation in the same order (__fsub_rn, __fmul_rn,
// __fadd_rn, __fsqrt_rn; the build passes --fmad=false), every argmin
// takes the first index of the minimum, and every position the plain
// version moves by a masked sum is stored as 0.0f + x, as that sum gives it
// (it turns -0.0 into +0.0).
//
// What bounds it on an H100: neither bytes nor operations. A batch moves a
// few tens of KB (dets in, rows out), and a frame does a few hundred
// scalar operations; but each frame's table depends on the one before, so
// the kernel is a chain of N frames, each a chain of dependent steps
// (cost, reductions, assignment, prefix counts, compaction). Latency bounds
// it. One CTA of one warp walks a stream's N frames, the slow path
// (Jonker-Volgenant) included, and the host reads nothing (frame_idx0 is
// read on the card): a batch is one launch, for one stream or S. Two kernels, chosen by the
// table's shape in tpuva_track_scan (tpuva_track_scan_plan says which, and
// tpuva_torch/track/scan.py::scan_plan is its pure mirror):
// - track_scan_regs, where T <= 32 and D <= 32 (the bench: 16 x 8). A
//   frame's chain stays in registers and shared memory, with no global
//   load on it:
//   - lane s holds slot s of the table (pos, tid, missed, active) and lane j
//     detection j of the frame; survivors are compacted and births appended
//     by ballots, __popc and a lane reading its source slot with
//     __shfl_sync (nth_set finds the source), with no table in memory;
//   - the T x D cost matrix is spread over the whole warp, entry
//     e = lane + 32 q to a lane (so T x D = 128 takes four square roots a
//     lane, not eight on 16 lanes), and written to shared memory row-major
//     (consecutive lanes, consecutive words); lane j then scans column j
//     once for its first minimum in torch.argmin's order and the rows that
//     hold it. The fast path's tests are one __all_sync (every valid
//     column's minimum strict), one __reduce_or_sync of the minima's rows
//     (no two valid columns on one row) and one ballot; greedy's rounds
//     are a minimum over a lane's entries and two __reduce_min_sync over
//     the costs' bits (every cost is +0 or more, so the unsigned order of
//     the bits is the float order; a NaN fails every round's gate);
//   - the batch's dets and det_valid are staged into shared memory in
//     chunks of kChunk frames by cp.async, double-buffered: the next chunk
//     loads while the warp works through the current one, so no frame's
//     chain waits on a global load and each detection is read from global
//     memory once;
//   - a chunk's rows and row_valid are built in shared memory and written
//     as 16-byte stores, coalesced;
//   - a frame that the fast path refuses runs Jonker-Volgenant
//     (hungarian_regs) on the matrix in shared memory with its arrays in
//     registers, a column and a row of the search a lane;
// - track_scan_kernel, every other shape: the table double-buffered in
//   shared memory, lanes striding over the T x D, T and D elementwise
//   steps, warp shuffles for the reductions and __syncwarp ordering the
//   steps; where its arrays exceed a CTA's shared memory (T x D beyond
//   ~56k), the same kernel keeps them in a global scratch buffer that the
//   wrapper passes (the kGlobal instantiation), so no table size is
//   refused.
// Streams: one launch takes S independent streams, each with its own
// table, N frames of detections, frame index and outputs (the s-th of S
// equal blocks of every buffer, global scratch included): S CTAs of one
// warp where one stream takes one, CTA s on stream s (stream_params). The
// streams' chains run side by side on S SMs; S = 1 is the one-stream call.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e30f;          // tpuva's BIG
constexpr float kHalfBig = kBig / 2;   // BIG / 2, exact
constexpr float kInf = 1e38f;          // the Jonker-Volgenant search's INF
constexpr int kSmemLimit = 232448;     // dynamic shared memory a CTA may use

struct Params {
  const float* dets;           // (N, D, 3)
  const uint8_t* det_valid;    // (N, D) bool
  int N, T, D;
  const float* pos0;           // (T, 2)
  const int* tid0;             // (T,)
  const int* missed0;          // (T,)
  const uint8_t* active0;      // (T,) bool
  const int* next_id0;         // ()
  const int* frame0;           // () global index of frame 0
  float* pos1;
  int* tid1;
  int* missed1;
  uint8_t* active1;
  int* next_id1;
  float* rows;                 // (N, D, 5)
  uint8_t* row_valid;          // (N, D) bool
  float max_dist;
  int death_patience;
  int hungarian;
};

// Stream s's view of the S streams' buffers: each field is the s-th of S
// equal blocks (dets (S, N, D, 3), the tables (S, T, ...), frame0 (S,), ...).
__device__ __forceinline__ Params stream_params(Params P, int s) {
  const long long nd = static_cast<long long>(P.N) * P.D, t = P.T;
  P.dets += 3 * nd * s;
  P.det_valid += nd * s;
  P.pos0 += 2 * t * s;
  P.tid0 += t * s;
  P.missed0 += t * s;
  P.active0 += t * s;
  P.next_id0 += s;
  P.frame0 += s;
  P.pos1 += 2 * t * s;
  P.tid1 += t * s;
  P.missed1 += t * s;
  P.active1 += t * s;
  P.next_id1 += s;
  P.rows += 5 * nd * s;
  P.row_valid += nd * s;
  return P;
}

// The arrays, in 4-byte words from the base: two track tables (A, B), the
// cost matrix, per-detection arrays, and the Jonker-Volgenant arrays over
// n + 1 = max(T, D) + 1 entries.
struct Layout {
  long long pos[2], tid[2], missed[2], active[2];
  long long cost, sfd, amin, flag;
  long long u, v, minv, p, way, used, cnt;
  long long words;
  __host__ __device__ Layout(int T, int D) {
    const long long n1 = (T > D ? T : D) + 1;
    long long o = 0;
    for (int k = 0; k < 2; ++k) {
      pos[k] = o; o += 2LL * T;
      tid[k] = o; o += T;
      missed[k] = o; o += T;
      active[k] = o; o += T;
    }
    cost = o; o += (long long)T * D;
    sfd = o; o += D;    // slot for each detection (row for each column), -1 = none
    amin = o; o += D;   // first argmin of each column
    flag = o; o += D;   // bit 0: the column is valid; bit 1: its minimum is strict
    u = o; o += n1;
    v = o; o += n1;
    minv = o; o += n1;
    p = o; o += n1;
    way = o; o += n1;
    used = o; o += n1;
    cnt = o; o += n1;
    words = o;
  }
  __host__ __device__ long long bytes() const { return 4 * words; }
};

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Whether (v, i) comes before (w, k) in torch.argmin's order: NaN first
// (it propagates), then the smaller value, ties to the smaller index.
__device__ __forceinline__ bool before(float v, int i, float w, int k) {
  const bool vn = v != v, wn = w != w;
  if (vn || wn) return vn && (!wn || i < k);
  return v < w || (v == w && i < k);
}

// The first (v, i) over the warp in that order: each lane brings the first
// of its own indices (visited in increasing order), so the result is
// torch.argmin's, the first index of the minimum.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  for (int o = 16; o; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Jonker-Volgenant on the capped matrix (tpuva_torch/track/assign.py::
// _hungarian_slow and _hungarian_rect): rows of the smaller side, m <= nn;
// writes the row for each detection column into sfd (-1 = none).
__device__ void hungarian_slow(const Params& P, const Layout& L, float* mem, int lane) {
  const int T = P.T, D = P.D;
  const float* cost = mem + L.cost;
  float* u = mem + L.u;
  float* v = mem + L.v;
  float* minv = mem + L.minv;
  int* p = reinterpret_cast<int*>(mem + L.p);
  int* way = reinterpret_cast<int*>(mem + L.way);
  int* used = reinterpret_cast<int*>(mem + L.used);
  int* cnt = reinterpret_cast<int*>(mem + L.cnt);
  int* sfd = reinterpret_cast<int*>(mem + L.sfd);

  // cap = maxv * (n + 1) + 1, two roundings; maxv over the valid entries
  // (0 where none: the values are >= +0, so the order of the max is free)
  float mx = 0.0f;
  for (int e = lane; e < T * D; e += 32) {
    const float c = cost[e];
    mx = fmaxf(mx, c < kHalfBig ? c : 0.0f);
  }
  mx = warp_max(mx);
  const int n = T > D ? T : D;
  const float cap = __fadd_rn(__fmul_rn(mx, static_cast<float>(n + 1)), 1.0f);
  // T <= D: rows are tracks, columns detections; else the transpose
  const bool tr = T > D;
  const int m = tr ? D : T, nn = tr ? T : D;
  auto a = [&](int r, int c) -> float {  // capped entry, 0-based row r, column c
    const float x = tr ? cost[c * D + r] : cost[r * D + c];
    return x < kHalfBig ? x : cap;
  };

  for (int k = lane; k <= nn; k += 32) {
    v[k] = 0.0f;
    p[k] = 0;
  }
  for (int k = lane; k <= m; k += 32) u[k] = 0.0f;
  __syncwarp();
  for (int i = 1; i <= m; ++i) {
    for (int k = lane; k <= nn; k += 32) {
      minv[k] = kInf;
      way[k] = 0;
      used[k] = 0;
    }
    if (lane == 0) p[0] = i;
    __syncwarp();
    int j0 = 0;
    while (p[j0] != 0) {
      const int i0 = p[j0];
      const float ui0 = u[i0];
      if (lane == 0) used[j0] = 1;
      __syncwarp();
      // cur = a[i0 - 1, :] - u[i0] - v[1:]; better = unused & cur < minv;
      // then the first argmin over mv = used ? INF : minv
      float bv = __int_as_float(0x7f800000);
      int bj = INT_MAX;
      for (int j = 1 + lane; j <= nn; j += 32) {
        float mv = kInf;
        if (!used[j]) {
          const float cur = __fsub_rn(__fsub_rn(a(i0 - 1, j - 1), ui0), v[j]);
          if (cur < minv[j]) {
            minv[j] = cur;
            way[j] = j0;
          }
          mv = minv[j];
        }
        if (before(mv, j, bv, bj)) {
          bv = mv;
          bj = j;
        }
      }
      warp_argmin(bv, bj);
      const int j1 = bj;
      const float delta = bv;
      // cnt[r] = used columns j (0..nn) with p[j] == r; integer counts, so
      // the order of the atomics does not matter
      for (int r = lane; r <= m; r += 32) cnt[r] = 0;
      __syncwarp();
      for (int j = lane; j <= nn; j += 32)
        if (used[j]) atomicAdd(&cnt[p[j]], 1);
      __syncwarp();
      // u += delta * cnt; v -= used ? delta : 0; minv -= used ? 0 : delta
      for (int r = lane; r <= m; r += 32)
        u[r] = __fadd_rn(u[r], __fmul_rn(delta, static_cast<float>(cnt[r])));
      for (int j = lane; j <= nn; j += 32) {
        const bool uj = used[j] != 0;
        v[j] = __fsub_rn(v[j], uj ? delta : 0.0f);
        minv[j] = __fsub_rn(minv[j], uj ? 0.0f : delta);
      }
      __syncwarp();
      j0 = j1;
    }
    if (lane == 0) {  // augment along way
      while (j0 != 0) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
    }
    __syncwarp();
  }
  if (!tr) {
    for (int j = lane; j < D; j += 32) sfd[j] = p[j + 1] - 1;
  } else {
    // det_for_track[t] = p[t + 1] - 1; each detection takes the first
    // track that holds it, or -1
    for (int j = lane; j < D; j += 32) {
      int row = -1;
      for (int t = 0; t < T; ++t)
        if (p[t + 1] - 1 == j) {
          row = t;
          break;
        }
      sfd[j] = row;
    }
  }
  __syncwarp();
}

// hungarian_slow for the register kernel (max(T, D) <= 32): the same float
// operations in the same order, with the search's column j (1..nn) in lane
// j - 1 and its row i (1..m) in lane i - 1, so that a step of the search is
// a few shuffles and one warp argmin instead of strided passes over shared
// arrays. Column 0 only holds the row being inserted (its v and minv are
// never read), and row 0's potential never changes (every used column is
// assigned). cm: the T x D cost matrix in shared memory; slot: D ints of
// shared memory. Returns the row for this lane's detection column (-1 =
// none) where lane < D.
__device__ int hungarian_regs(const Params& P, const float* cm, int* slot, int lane) {
  const int T = P.T, D = P.D;
  float mx = 0.0f;  // cap = maxv * (n + 1) + 1 over the valid entries, as hungarian_slow
  for (int e = lane; e < T * D; e += 32) {
    const float c = cm[e];
    mx = fmaxf(mx, c < kHalfBig ? c : 0.0f);
  }
  mx = warp_max(mx);
  const int n = T > D ? T : D;
  const float cap = __fadd_rn(__fmul_rn(mx, static_cast<float>(n + 1)), 1.0f);
  const bool tr = T > D;  // T <= D: rows are tracks, columns detections; else the transpose
  const int m = tr ? D : T, nn = tr ? T : D;
  const bool col = lane < nn, row = lane < m;
  float v = 0.0f, u = 0.0f, minv = kInf;  // column lane + 1's v, minv; row lane + 1's u
  int p = 0, way = 0;                     // column lane + 1's row (0 = none) and way
  bool used = false;
  for (int i = 1; i <= m; ++i) {
    minv = kInf;
    way = 0;
    used = false;
    int j0 = 0, pj0 = i;  // p[0] = i
    while (true) {
      if (lane == j0 - 1) used = true;
      const float ui0 = __shfl_sync(kFull, u, pj0 - 1);
      // cur = a[i0 - 1, :] - u[i0] - v[1:]; better = unused & cur < minv;
      // then the first argmin over mv = used ? INF : minv
      float mv = __int_as_float(0x7f800000);
      int bj = INT_MAX;
      if (col) {
        mv = kInf;
        if (!used) {
          const float x = tr ? cm[lane * D + pj0 - 1] : cm[(pj0 - 1) * D + lane];
          const float cur = __fsub_rn(__fsub_rn(x < kHalfBig ? x : cap, ui0), v);
          if (cur < minv) {
            minv = cur;
            way = j0;
          }
          mv = minv;
        }
        bj = lane + 1;
      }
      warp_argmin(mv, bj);
      const int j1 = bj;
      const float delta = mv;
      // the used columns' rows, column 0's (i) among them: each row at most
      // once (p is a matching), so cnt[r] is bit r - 1
      const unsigned rows = __reduce_or_sync(kFull, col && used && p > 0 ? 1u << (p - 1) : 0u) |
                            1u << (i - 1);
      if (row) u = __fadd_rn(u, __fmul_rn(delta, static_cast<float>((rows >> lane) & 1u)));
      if (col) {
        v = __fsub_rn(v, used ? delta : 0.0f);
        minv = __fsub_rn(minv, used ? 0.0f : delta);
      }
      j0 = j1;
      pj0 = __shfl_sync(kFull, p, j0 - 1);
      if (pj0 == 0) break;
    }
    while (j0 != 0) {  // augment along way
      const int j1 = __shfl_sync(kFull, way, j0 - 1);
      const int pj1 = j1 == 0 ? i : __shfl_sync(kFull, p, (j1 - 1) & 31);
      if (lane == j0 - 1) p = pj1;
      j0 = j1;
    }
  }
  if (!tr) return lane < D ? p - 1 : -1;
  // det_for_track[t] = p[t + 1] - 1; each detection takes the track that
  // holds it (p is a matching: at most one), or -1
  if (lane < D) slot[lane] = -1;
  __syncwarp();
  if (col && p > 0) slot[p - 1] = lane;
  __syncwarp();
  const int r = lane < D ? slot[lane] : -1;
  __syncwarp();
  return r;
}

// hungarian_assign (tpuva_torch/track/assign.py): the fast path, else
// hungarian_slow; then the gate. Leaves the slot for each detection in sfd.
__device__ void hungarian(const Params& P, const Layout& L, float* mem, int lane) {
  const int T = P.T, D = P.D;
  const float* cost = mem + L.cost;
  int* sfd = reinterpret_cast<int*>(mem + L.sfd);
  int* amin = reinterpret_cast<int*>(mem + L.amin);
  int* flag = reinterpret_cast<int*>(mem + L.flag);
  for (int j = lane; j < D; j += 32) {
    float mn = cost[j];
    int am = 0;
    for (int i = 1; i < T; ++i) {
      const float c = cost[i * D + j];
      if (before(c, i, mn, am)) {
        mn = c;
        am = i;
      }
    }
    int eq = 0;
    for (int i = 0; i < T; ++i) eq += cost[i * D + j] == mn;
    amin[j] = am;
    flag[j] = (mn < kHalfBig ? 1 : 0) | (eq == 1 ? 2 : 0);
  }
  __syncwarp();
  // every valid column strict with an argmin row no other valid column
  // shares, and at most T valid columns
  bool ok = true;
  int nvalid = 0;
  for (int j = lane; j < D; j += 32) {
    if (!(flag[j] & 1)) continue;
    ++nvalid;
    int same = 0;
    for (int k = 0; k < D; ++k) same += (flag[k] & 1) && amin[k] == amin[j];
    ok = ok && (flag[j] & 2) && same == 1;
  }
  const bool fast = __all_sync(kFull, ok) && warp_sum(nvalid) <= T;
  if (fast) {
    for (int j = lane; j < D; j += 32) sfd[j] = amin[j];
    __syncwarp();
  } else {
    hungarian_slow(P, L, mem, lane);
  }
  for (int j = lane; j < D; j += 32) {
    const int r = sfd[j];
    const int rc = r < 0 ? 0 : (r > T - 1 ? T - 1 : r);
    const float picked = cost[rc * D + j];
    const bool keep = r >= 0 && r < T && picked < kHalfBig && picked <= P.max_dist;
    sfd[j] = keep ? r : -1;
  }
  __syncwarp();
}

// greedy_assign: min(T, D) rounds of the first global minimum; a round
// whose minimum exceeds max_dist changes nothing, nor does any after it.
// Overwrites the cost matrix.
__device__ void greedy(const Params& P, const Layout& L, float* mem, int lane) {
  const int T = P.T, D = P.D;
  float* cost = mem + L.cost;
  int* sfd = reinterpret_cast<int*>(mem + L.sfd);
  for (int j = lane; j < D; j += 32) sfd[j] = -1;
  __syncwarp();
  const int rounds = T < D ? T : D;
  for (int r = 0; r < rounds; ++r) {
    float bv = __int_as_float(0x7f800000);
    int be = INT_MAX;
    for (int e = lane; e < T * D; e += 32) {
      const float c = cost[e];
      if (before(c, e, bv, be)) {
        bv = c;
        be = e;
      }
    }
    warp_argmin(bv, be);
    if (!(bv <= P.max_dist)) break;
    const int i = be / D, j = be - i * D;
    __syncwarp();  // every lane has read the cost before it changes
    if (lane == 0) sfd[j] = i;
    for (int e = lane; e < T * D; e += 32) {
      const int ei = e / D;
      if (ei == i || e - ei * D == j) cost[e] = kBig;
    }
    __syncwarp();
  }
}

template <typename X>
__device__ __forceinline__ void swap_ptr(X*& x, X*& y) {
  X* z = x;
  x = y;
  y = z;
}

template <bool kGlobal>
__global__ void __launch_bounds__(32)
track_scan_kernel(const Params P0, float* scratch) {
  extern __shared__ float smem[];
  const Params P = stream_params(P0, blockIdx.x);
  const Layout L(P.T, P.D);
  float* mem = kGlobal ? scratch + L.words * blockIdx.x : smem;
  const int lane = threadIdx.x;
  const int T = P.T, D = P.D;
  // the current table (a) and the one that receives the next frame's (b),
  // swapped after every frame
  float* pos_a = mem + L.pos[0];
  float* pos_b = mem + L.pos[1];
  int* tid_a = reinterpret_cast<int*>(mem + L.tid[0]);
  int* tid_b = reinterpret_cast<int*>(mem + L.tid[1]);
  int* missed_a = reinterpret_cast<int*>(mem + L.missed[0]);
  int* missed_b = reinterpret_cast<int*>(mem + L.missed[1]);
  int* active_a = reinterpret_cast<int*>(mem + L.active[0]);
  int* active_b = reinterpret_cast<int*>(mem + L.active[1]);
  float* cost = mem + L.cost;
  const int* sfd = reinterpret_cast<const int*>(mem + L.sfd);

  for (int s = lane; s < T; s += 32) {
    pos_a[2 * s] = P.pos0[2 * s];
    pos_a[2 * s + 1] = P.pos0[2 * s + 1];
    tid_a[s] = P.tid0[s];
    missed_a[s] = P.missed0[s];
    active_a[s] = P.active0[s] != 0;
  }
  unsigned next_id = static_cast<unsigned>(*P.next_id0);
  const unsigned frame0 = static_cast<unsigned>(*P.frame0);
  const unsigned below = (1u << lane) - 1u;  // lanes before this one
  __syncwarp();

  for (int t = 0; t < P.N; ++t) {
    const float* dt = P.dets + static_cast<long long>(t) * D * 3;
    const uint8_t* vt = P.det_valid + static_cast<long long>(t) * D;
    for (int e = lane; e < T * D; e += 32) {
      const int i = e / D, j = e - i * D;
      float c = kBig;
      if (active_a[i] && vt[j]) {
        const float dx = __fsub_rn(pos_a[2 * i], dt[3 * j]);
        const float dy = __fsub_rn(pos_a[2 * i + 1], dt[3 * j + 1]);
        c = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      }
      cost[e] = c;
    }
    __syncwarp();
    if (P.hungarian)
      hungarian(P, L, mem, lane);
    else
      greedy(P, L, mem, lane);
    __syncwarp();

    // matched updates and missed, then the survivors compacted down into
    // table b in slot order (the exclusive rank of `still` is the target)
    int n_still = 0;
    for (int base = 0; base < T; base += 32) {
      const int s = base + lane;
      bool still = false;
      float px = 0.0f, py = 0.0f;
      int ms = 0;
      if (s < T) {
        bool matched = false;
        float mxs = 0.0f, mys = 0.0f;  // the masked sum over detections
        for (int j = 0; j < D; ++j)
          if (sfd[j] == s) {
            matched = true;
            mxs = __fadd_rn(mxs, dt[3 * j]);
            mys = __fadd_rn(mys, dt[3 * j + 1]);
          }
        const bool act_s = active_a[s] != 0;
        px = matched ? mxs : pos_a[2 * s];
        py = matched ? mys : pos_a[2 * s + 1];
        const int m0 = missed_a[s];
        ms = matched ? 0 : (act_s ? static_cast<int>(static_cast<unsigned>(m0) + 1u) : m0);
        still = act_s && ms < P.death_patience;
      }
      const unsigned bal = __ballot_sync(kFull, still);
      if (still) {
        const int r = n_still + __popc(bal & below);
        pos_b[2 * r] = __fadd_rn(0.0f, px);
        pos_b[2 * r + 1] = __fadd_rn(0.0f, py);
        tid_b[r] = tid_a[s];
        missed_b[r] = ms;
      }
      n_still += __popc(bal);
    }
    for (int s = n_still + lane; s < T; s += 32) {
      pos_b[2 * s] = 0.0f;
      pos_b[2 * s + 1] = 0.0f;
      tid_b[s] = 0;
      missed_b[s] = 0;
    }
    __syncwarp();

    // births: the r-th valid unmatched detection appends at n_still + r - 1
    // while capacity remains; then every detection's row
    const float frame = __int2float_rn(static_cast<int>(frame0 + static_cast<unsigned>(t)));
    int n_birth_det = 0, n_births = 0;
    for (int base = 0; base < D; base += 32) {
      const int j = base + lane;
      const bool in = j < D;
      const int slot = in ? sfd[j] : -1;
      const bool matched = slot >= 0;
      const bool bd = in && vt[j] && !matched;
      const unsigned bal = __ballot_sync(kFull, bd);
      const int rank = n_birth_det + __popc(bal & below) + 1;  // inclusive, 1-based
      const bool cb = bd && n_still + rank <= T;
      const int new_tid = cb ? static_cast<int>(next_id - 1u + static_cast<unsigned>(rank)) : 0;
      if (cb) {
        const int s = n_still + rank - 1;
        pos_b[2 * s] = __fadd_rn(0.0f, dt[3 * j]);
        pos_b[2 * s + 1] = __fadd_rn(0.0f, dt[3 * j + 1]);
        tid_b[s] = new_tid;
      }
      if (in) {
        float* row = P.rows + (static_cast<long long>(t) * D + j) * 5;
        row[0] = __int2float_rn(matched ? tid_a[slot] : new_tid);
        row[1] = frame;
        row[2] = dt[3 * j];
        row[3] = dt[3 * j + 1];
        row[4] = dt[3 * j + 2];
        P.row_valid[static_cast<long long>(t) * D + j] = (matched || cb) ? 1 : 0;
      }
      n_birth_det += __popc(bal);
      n_births += __popc(__ballot_sync(kFull, cb));
    }
    for (int s = lane; s < T; s += 32) active_b[s] = s < n_still + n_births;
    next_id += static_cast<unsigned>(n_births);
    swap_ptr(pos_a, pos_b);
    swap_ptr(tid_a, tid_b);
    swap_ptr(missed_a, missed_b);
    swap_ptr(active_a, active_b);
    __syncwarp();
  }

  for (int s = lane; s < T; s += 32) {
    P.pos1[2 * s] = pos_a[2 * s];
    P.pos1[2 * s + 1] = pos_a[2 * s + 1];
    P.tid1[s] = tid_a[s];
    P.missed1[s] = missed_a[s];
    P.active1[s] = active_a[s] ? 1 : 0;
  }
  if (lane == 0) *P.next_id1 = static_cast<int>(next_id);
}

// ---- track_scan_regs: the table in registers (T <= 32, D <= 32) ----

constexpr int kRegMax = 32;  // T and D the register kernel takes: a lane each
constexpr int kChunk = 32;   // frames staged a chunk: chunk offsets stay 16-byte aligned

__host__ __device__ inline long long up16(long long x) { return (x + 15) / 16 * 16; }

// The register kernel's shared memory, in bytes from the base: the
// Jonker-Volgenant region (Layout(T, D); its two tables are unused), two
// staging buffers of a chunk's dets and det_valid, and a chunk's rows and
// row_valid.
struct RegLayout {
  long long dets[2], valid[2], rows, rvalid, bytes;
  __host__ __device__ RegLayout(int T, int D) {
    long long o = up16(Layout(T, D).bytes());
    for (int b = 0; b < 2; ++b) {
      dets[b] = o;
      o += up16(12LL * kChunk * D);
    }
    for (int b = 0; b < 2; ++b) {
      valid[b] = o;
      o += up16(1LL * kChunk * D);
    }
    rows = o;
    o += up16(20LL * kChunk * D);
    rvalid = o;
    o += up16(1LL * kChunk * D);
    bytes = o;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// nbytes from global src to shared dst: 16-byte cp.async where vec (both
// 16-byte aligned), plain byte copies for the rest (a tail under 16 bytes,
// or everything where not vec).
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const uint8_t* src, int nbytes,
                                            bool vec, int lane) {
  int done = 0;
  if (vec) {
    const int n16 = nbytes >> 4;
    for (int i = lane; i < n16; i += 32) cp_async16(dst + 16 * i, src + 16 * i);
    done = n16 << 4;
  }
  for (int i = done + lane; i < nbytes; i += 32) dst[i] = src[i];
}

// nbytes from shared src to global dst: 16-byte stores where vec, bytes
// for the rest.
__device__ __forceinline__ void flush_bytes(uint8_t* dst, const uint8_t* src, int nbytes,
                                            bool vec, int lane) {
  int done = 0;
  if (vec) {
    const int n16 = nbytes >> 4;
    for (int i = lane; i < n16; i += 32)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    done = n16 << 4;
  }
  for (int i = done + lane; i < nbytes; i += 32) dst[i] = src[i];
}

// Position of the k-th set bit of m (1-based; k <= __popc(m)): the largest
// p with fewer than k set bits below it.
__device__ __forceinline__ int nth_set(unsigned m, int k) {
  int p = 0;
  for (int s = 16; s; s >>= 1)
    if (__popc(m & ((1u << (p + s)) - 1u)) < k) p += s;
  return p;
}

// Chunk c of the batch's dets and det_valid into staging buffer b.
__device__ __forceinline__ void stage_chunk(const Params& P, const RegLayout& R, uint8_t* smem,
                                            int c, int b, bool vec, int lane) {
  const int nf = min(kChunk, P.N - c * kChunk);
  const long long f0 = static_cast<long long>(c) * kChunk * P.D;
  stage_bytes(smem + R.dets[b], reinterpret_cast<const uint8_t*>(P.dets + 3 * f0),
              12 * nf * P.D, vec, lane);
  stage_bytes(smem + R.valid[b], P.det_valid + f0, nf * P.D, vec, lane);
}

// One warp walks the N frames with the table in registers (see the top of
// the file). kD >= D is the extent of the per-lane register arrays (a cost
// row, the detections' x and y), so that every index into them is a
// constant of an unrolled loop.
template <int kD>
__global__ void __launch_bounds__(32)
track_scan_regs(const Params P0) {
  extern __shared__ __align__(16) uint8_t smem8[];
  const Params P = stream_params(P0, blockIdx.x);
  float* mem = reinterpret_cast<float*>(smem8);  // the Jonker-Volgenant region
  const int T = P.T, D = P.D;
  const Layout L(T, D);
  const RegLayout R(T, D);
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;  // lanes before this one
  const bool in_t = lane < T, in_d = lane < D;
  // this lane's first cost entry (lane = row i0 * D + column j0) and the
  // step to its next (32 = di * D + dj)
  const int TD = T * D, i0 = lane / D, j0 = lane - i0 * D, di = 32 / D, dj = 32 - di * D;

  // slot `lane` of the table
  float px = 0.0f, py = 0.0f;
  int tid = 0, missed = 0;
  bool act = false;
  if (in_t) {
    px = P.pos0[2 * lane];
    py = P.pos0[2 * lane + 1];
    tid = P.tid0[lane];
    missed = P.missed0[lane];
    act = P.active0[lane] != 0;
  }
  unsigned next_id = static_cast<unsigned>(*P.next_id0);
  const unsigned frame0 = static_cast<unsigned>(*P.frame0);
  const bool vec_in =
      ((reinterpret_cast<uintptr_t>(P.dets) | reinterpret_cast<uintptr_t>(P.det_valid)) & 15) == 0;
  const bool vec_out =
      ((reinterpret_cast<uintptr_t>(P.rows) | reinterpret_cast<uintptr_t>(P.row_valid)) & 15) == 0;
  float* rs = reinterpret_cast<float*>(smem8 + R.rows);
  uint8_t* rvs = smem8 + R.rvalid;

  const int nchunks = (P.N + kChunk - 1) / kChunk;
  stage_chunk(P, R, smem8, 0, 0, vec_in, lane);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    const int b = c & 1;
    if (c + 1 < nchunks) {  // the next chunk loads while this one runs
      stage_chunk(P, R, smem8, c + 1, b ^ 1, vec_in, lane);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const float* ds = reinterpret_cast<const float*>(smem8 + R.dets[b]);
    const uint8_t* vs = smem8 + R.valid[b];
    const int nf = min(kChunk, P.N - c * kChunk);
    for (int f = 0; f < nf; ++f) {
      const int t = c * kChunk + f;
      // detection `lane` of frame t
      float dxj = 0.0f, dyj = 0.0f, daj = 0.0f;
      bool vj = false;
      if (in_d) {
        dxj = ds[3 * (f * D + lane)];
        dyj = ds[3 * (f * D + lane) + 1];
        daj = ds[3 * (f * D + lane) + 2];
        vj = vs[f * D + lane] != 0;
      }
      const unsigned vmask = __ballot_sync(kFull, vj);

      // the cost matrix: its T x D entries spread over the lanes (entry
      // e = lane + 32 q is row e / D, column e % D), kept in registers and
      // written to shared memory in row-major order (consecutive lanes,
      // consecutive words) for the column scans and Jonker-Volgenant
      const unsigned amask = __ballot_sync(kFull, act);
      float* cm = mem + L.cost;
      float ce[kD];  // this lane's entries (greedy's rounds read them)
      bool nan_e = false;
      __syncwarp();  // the previous frame's reads of cm are done
      {
        int i = i0, j = j0;  // this lane's entry
#pragma unroll
        for (int q = 0; q < kD; ++q) {
          if (32 * q >= TD) break;
          const int e = lane + 32 * q;
          const float xi = __shfl_sync(kFull, px, i & 31), yi = __shfl_sync(kFull, py, i & 31);
          const float xj = __shfl_sync(kFull, dxj, j & 31), yj = __shfl_sync(kFull, dyj, j & 31);
          float cc = kBig;
          if (e < TD && ((amask >> i) & 1u) && ((vmask >> j) & 1u)) {
            const float dx = __fsub_rn(xi, xj);
            const float dy = __fsub_rn(yi, yj);
            cc = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
          }
          ce[q] = cc;
          if (e < TD) {
            cm[e] = cc;
            nan_e |= cc != cc;
          }
          i += di;
          j += dj;
          if (j >= D) {
            j -= D;
            ++i;
          }
        }
      }
      __syncwarp();

      // the assignment: sfd, the slot of detection `lane`, -1 = none
      int sfd = -1;
      if (P.hungarian) {
        // column `lane`: its first minimum in torch.argmin's order (NaN
        // first) and how many rows hold it, in one pass over the rows
        float mn = 0.0f;
        int am = 0, eq = 0;
        if (in_d) {
          mn = cm[lane];
          eq = mn == mn;
          for (int i = 1; i < T; ++i) {
            const float c = cm[i * D + lane];
            if (before(c, i, mn, am)) {
              mn = c;
              am = i;
              eq = c == c;
            } else if (c == mn) {
              ++eq;
            }
          }
        }
        // the fast path: every valid column's minimum strict, no two valid
        // columns on one row, at most T valid columns
        const bool valid = in_d && mn < kHalfBig;
        const bool ok = __all_sync(kFull, !valid || eq == 1);
        const unsigned rows_hit = __reduce_or_sync(kFull, valid ? 1u << am : 0u);
        const int nvalid = __popc(__ballot_sync(kFull, valid));
        float picked = mn;
        if (ok && __popc(rows_hit) == nvalid && nvalid <= T) {
          sfd = in_d ? am : -1;
        } else {  // Jonker-Volgenant on the matrix in shared memory
          sfd = hungarian_regs(P, cm, reinterpret_cast<int*>(mem + L.sfd), lane);
          if (in_d) {
            const int rc = sfd < 0 ? 0 : (sfd > T - 1 ? T - 1 : sfd);
            picked = cm[rc * D + lane];
          }
        }
        const bool keep = sfd >= 0 && sfd < T && picked < kHalfBig && picked <= P.max_dist;
        sfd = keep ? sfd : -1;
      } else if (!__any_sync(kFull, nan_e)) {
        // greedy: min(T, D) rounds of the first global minimum in flat
        // order (a NaN anywhere is that minimum in every round and fails
        // the gate). Every cost is +0 or more, so the unsigned order of its
        // bits is the float order.
        const int rounds = T < D ? T : D;
        for (int r = 0; r < rounds; ++r) {
          unsigned best = 0xffffffffu, be = 0xffffffffu;  // this lane's first minimum
#pragma unroll
          for (int q = 0; q < kD; ++q) {
            if (32 * q >= TD) break;
            const unsigned k = __float_as_uint(ce[q]);
            if (lane + 32 * q < TD && k < best) {
              best = k;
              be = lane + 32 * q;
            }
          }
          const unsigned mn = __reduce_min_sync(kFull, best);
          if (!(__uint_as_float(mn) <= P.max_dist)) break;
          const int ew = static_cast<int>(__reduce_min_sync(kFull, best == mn ? be : 0xffffffffu));
          const int wi = ew / D, wj = ew - wi * D;
          if (lane == wj) sfd = wi;
          int i = i0, j = j0;
#pragma unroll
          for (int q = 0; q < kD; ++q) {
            if (32 * q >= TD) break;
            if (i == wi || j == wj) ce[q] = kBig;
            i += di;
            j += dj;
            if (j >= D) {
              j -= D;
              ++i;
            }
          }
        }
      }

      // matched updates (the masked sum over detections, as the plain
      // version takes it) and missed
      bool matched = false;
      float mxs = 0.0f, mys = 0.0f;
#pragma unroll
      for (int j = 0; j < kD; ++j) {
        const int r = __shfl_sync(kFull, sfd, j);
        if (j < D && r == lane) {
          matched = true;
          mxs = __fadd_rn(mxs, ds[3 * (f * D + j)]);
          mys = __fadd_rn(mys, ds[3 * (f * D + j) + 1]);
        }
      }
      const int m_new =
          matched ? 0 : (act ? static_cast<int>(static_cast<unsigned>(missed) + 1u) : missed);
      const float nx = matched ? mxs : px, ny = matched ? mys : py;
      const bool still = act && m_new < P.death_patience;
      const unsigned sm = __ballot_sync(kFull, still);
      const int n_still = __popc(sm);
      // a row's track id is the old table's
      const int row_tid = __shfl_sync(kFull, tid, sfd < 0 ? 0 : sfd);
      // survivors compacted down in slot order: slot r reads the r-th
      const int src = lane < n_still ? nth_set(sm, lane + 1) : lane;
      const float sx = __shfl_sync(kFull, nx, src), sy = __shfl_sync(kFull, ny, src);
      const int stid = __shfl_sync(kFull, tid, src), smiss = __shfl_sync(kFull, m_new, src);
      // births: the r-th valid unmatched detection appends at n_still + r - 1
      // while capacity remains
      const bool bd = vj && sfd < 0;
      const unsigned bm = __ballot_sync(kFull, bd);
      const int rank = __popc(bm & below) + 1;  // inclusive, 1-based
      const bool cb = bd && n_still + rank <= T;
      const int new_tid = cb ? static_cast<int>(next_id - 1u + static_cast<unsigned>(rank)) : 0;
      const int n_births = __popc(__ballot_sync(kFull, cb));
      const int k = lane - n_still + 1;  // this slot's birth rank
      const bool born = lane >= n_still && k <= n_births;
      const int bsrc = born ? nth_set(bm, k) : lane;
      const float bx = __shfl_sync(kFull, dxj, bsrc), by = __shfl_sync(kFull, dyj, bsrc);
      if (lane < n_still) {
        px = __fadd_rn(0.0f, sx);
        py = __fadd_rn(0.0f, sy);
        tid = stid;
        missed = smiss;
      } else if (born) {
        px = __fadd_rn(0.0f, bx);
        py = __fadd_rn(0.0f, by);
        tid = static_cast<int>(next_id - 1u + static_cast<unsigned>(k));
        missed = 0;
      } else {
        px = 0.0f;
        py = 0.0f;
        tid = 0;
        missed = 0;
      }
      act = lane < n_still + n_births;
      next_id += static_cast<unsigned>(n_births);

      // the detection's row, into the chunk's rows
      if (in_d) {
        float* row = rs + 5 * (f * D + lane);
        row[0] = __int2float_rn(sfd >= 0 ? row_tid : new_tid);
        row[1] = __int2float_rn(static_cast<int>(frame0 + static_cast<unsigned>(t)));
        row[2] = dxj;
        row[3] = dyj;
        row[4] = daj;
        rvs[f * D + lane] = (sfd >= 0 || cb) ? 1 : 0;
      }
    }
    __syncwarp();
    const long long f0 = static_cast<long long>(c) * kChunk * D;
    flush_bytes(reinterpret_cast<uint8_t*>(P.rows + 5 * f0), reinterpret_cast<uint8_t*>(rs),
                20 * nf * D, vec_out, lane);
    flush_bytes(P.row_valid + f0, rvs, nf * D, vec_out, lane);
    __syncwarp();  // the next chunk's rows overwrite these
  }

  if (in_t) {
    P.pos1[2 * lane] = px;
    P.pos1[2 * lane + 1] = py;
    P.tid1[lane] = tid;
    P.missed1[lane] = missed;
    P.active1[lane] = act ? 1 : 0;
  }
  if (lane == 0) *P.next_id1 = static_cast<int>(next_id);
}

enum ScanKernel { kRegs = 0, kShared = 1, kGlobalTable = 2 };

// Which kernel takes a (T, D) table, its dynamic shared memory and its
// global scratch, in bytes (tpuva_torch/track/scan.py::scan_plan mirrors it).
void plan(int T, int D, int* kind, int* kd, long long* smem, long long* scratch) {
  const long long table = Layout(T, D).bytes();
  *kd = 0;
  *scratch = 0;
  if (T <= kRegMax && D <= kRegMax) {
    *kind = kRegs;
    *kd = D <= 8 ? 8 : (D <= 16 ? 16 : 32);
    *smem = RegLayout(T, D).bytes;
  } else if (table <= kSmemLimit) {
    *kind = kShared;
    *smem = table;
  } else {
    *kind = kGlobalTable;
    *smem = 0;
    *scratch = table;
  }
}

template <int kD>
cudaError_t launch_regs(const Params& P, int S, long long smem, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      track_scan_regs<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  track_scan_regs<kD><<<S, 32, static_cast<size_t>(smem), s>>>(P);
  return cudaGetLastError();
}

}  // namespace

// The kernel that takes a (T, D) table: kind 0 the register kernel
// (track_scan_regs<kd>), 1 the table kernel in shared memory, 2 the table
// kernel in a global scratch buffer of `scratch` bytes; smem its dynamic
// shared memory in bytes.
extern "C" int tpuva_track_scan_plan(int T, int D, int* kind, int* kd, long long* smem,
                                     long long* scratch) {
  if (T < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  plan(T, D, kind, kd, smem, scratch);
  return 0;
}

// One launch for the batch of S streams: dets (S, N, D, 3) f32, det_valid
// (S, N, D) bool, the state (pos0 (S, T, 2), tid0, missed0, active0 (S, T),
// next_id0 (S,)) and frame0 (S,) int32, all on the card -> the new state
// (pos1 ..., next_id1), rows (S, N, D, 5) f32, row_valid (S, N, D) bool; a
// CTA a stream. The kernel is the one tpuva_track_scan_plan names for
// (T, D); scratch holds S times its scratch bytes, or is null where that is
// 0. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tpuva_track_scan(
    const float* dets, const uint8_t* det_valid, int S, int N, int T, int D,
    const float* pos0, const int* tid0, const int* missed0, const uint8_t* active0,
    const int* next_id0, const int* frame0,
    float* pos1, int* tid1, int* missed1, uint8_t* active1, int* next_id1,
    float* rows, uint8_t* row_valid,
    float max_dist, int death_patience, int hungarian,
    void* scratch, long long scratch_bytes, void* stream) {
  if (S < 1 || S > 65535 || N < 0 || T < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params P{dets, det_valid, N, T, D, pos0, tid0, missed0, active0, next_id0, frame0,
                 pos1, tid1, missed1, active1, next_id1, rows, row_valid,
                 max_dist, death_patience, hungarian};
  int kind, kd;
  long long smem, need;
  plan(T, D, &kind, &kd, &smem, &need);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kRegs) {
    const cudaError_t err = kd == 8    ? launch_regs<8>(P, S, smem, s)
                            : kd == 16 ? launch_regs<16>(P, S, smem, s)
                                       : launch_regs<32>(P, S, smem, s);
    return static_cast<int>(err);
  }
  if (kind == kGlobalTable) {
    if (scratch == nullptr || scratch_bytes < need * S)
      return static_cast<int>(cudaErrorInvalidValue);
    track_scan_kernel<true><<<S, 32, 0, s>>>(P, static_cast<float*>(scratch));
  } else {
    const cudaError_t err = cudaFuncSetAttribute(
        track_scan_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    track_scan_kernel<false><<<S, 32, static_cast<size_t>(smem), s>>>(P, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
