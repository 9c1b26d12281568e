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
// it. The design keeps every step of that chain on chip and short:
// - one CTA of one warp walks the N frames. The track table (double
//   buffered), the T x D cost matrix and the Jonker-Volgenant arrays live in
//   shared memory; lanes stride over the T x D, T and D elementwise steps,
//   warp shuffles do the reductions (min, max, first-index argmin), ballots
//   the prefix counts of the compaction and the births, and __syncwarp
//   orders the steps (no CTA barrier);
// - the host reads nothing: frame_idx0 is read on the card, and the slow
//   path (Jonker-Volgenant) runs inside the kernel, so a batch is one
//   launch;
// - where the arrays exceed a CTA's shared memory (T x D beyond ~56k), the
//   same kernel keeps them in a global scratch buffer that the wrapper
//   passes (the kGlobal instantiation), so no table size is refused.

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
  long long bytes() const { return 4 * words; }
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
track_scan_kernel(Params P, float* scratch) {
  extern __shared__ float smem[];
  float* mem = kGlobal ? scratch : smem;
  const Layout L(P.T, P.D);
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

}  // namespace

// Bytes of the global scratch buffer the kernel needs for a (T, D) table:
// 0 where its arrays fit in a CTA's shared memory.
extern "C" int tpuva_track_scan_scratch(int T, int D, long long* bytes) {
  if (T < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long need = Layout(T, D).bytes();
  *bytes = need > kSmemLimit ? need : 0;
  return 0;
}

// One launch for the batch: dets (N, D, 3) f32, det_valid (N, D) bool, the
// state (pos0, tid0, missed0, active0, next_id0) and frame0 () int32, all
// on the card -> the new state (pos1 ..., next_id1), rows (N, D, 5) f32,
// row_valid (N, D) bool. scratch: tpuva_track_scan_scratch's bytes, or null
// where that is 0. Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int tpuva_track_scan(
    const float* dets, const uint8_t* det_valid, int N, int T, int D,
    const float* pos0, const int* tid0, const int* missed0, const uint8_t* active0,
    const int* next_id0, const int* frame0,
    float* pos1, int* tid1, int* missed1, uint8_t* active1, int* next_id1,
    float* rows, uint8_t* row_valid,
    float max_dist, int death_patience, int hungarian,
    void* scratch, long long scratch_bytes, void* stream) {
  if (N < 0 || T < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Params P{dets, det_valid, N, T, D, pos0, tid0, missed0, active0, next_id0, frame0,
                 pos1, tid1, missed1, active1, next_id1, rows, row_valid,
                 max_dist, death_patience, hungarian};
  const long long need = Layout(T, D).bytes();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (need > kSmemLimit) {
    if (scratch == nullptr || scratch_bytes < need) return static_cast<int>(cudaErrorInvalidValue);
    track_scan_kernel<true><<<1, 32, 0, s>>>(P, static_cast<float*>(scratch));
  } else {
    const cudaError_t err = cudaFuncSetAttribute(
        track_scan_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(need));
    if (err != cudaSuccess) return static_cast<int>(err);
    track_scan_kernel<false><<<1, 32, static_cast<size_t>(need), s>>>(P, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
