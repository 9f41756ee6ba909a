// Exact brute-force k-nearest-neighbour search for Hopper (sm_90a), for
// k = 4..128: the part of the TPU kernel that csrc/knn.cu (k = 1..3) leaves.
//
// Replaces the TPU kernel `knn_pallas` / `_knn_kernel`
// (pyfocusr_tpu/ops/pallas_kernels.py:647-796) for 4 <= k <= 128, with the
// contract of csrc/knn.cu and of the plain version `knn_plain` in
// ops/knn_kernel.py, which it equals bit for bit:
//   * squared distances are direct f32 sums  sum_d (q_d - r_d)^2 in
//     dimension order, multiply and add rounded separately (no FMA);
//   * ascending top-k, ties to the lower reference index;
//   * non-finite reference coordinates become 1e30 (such rows never win);
//   * a slot without a neighbour (fewer than k finite candidates, or a
//     squared distance >= 1e29) reports (inf, nr);
//   * Euclidean distances (correctly rounded sqrt) f32, indices int32.
//
// What bounds it on the H100: each pair costs 3 D unfused lane instructions
// (D subtractions, D multiplies, D - 1 adds, one compare), the data is a few
// hundred KB, so the distance work is issue-bound as in csrc/knn.cu.  What a
// large k adds is the running list: a candidate that beats the k-th entry
// has to be inserted into a sorted list of k.  Scanning references in index
// order, a query sees about k (1 + ln(nr / k)) insertions (65 at k = 8,
// 690 at k = 128, nr = 10242), against nr candidates, so the list work is
// rare but wide.
//
// What the design does about it:
//   * a warp owns QW queries (4 at k <= 32 where the card has warps to
//     spare; else 1) and keeps each one's list spread over its 32 lanes,
//     sorted by (distance, index): entry p = 32 r + lane in register r of
//     that lane, KP = 1, 2 or 4 registers (k <= 32, <= 64, <= 128);
//   * the lanes take 32 consecutive references a step; one 16-byte shared
//     load of a reference (D <= 3) feeds the QW queries' distances.  Each
//     lane tests its candidates against its own copy of each query's k-th
//     distance (the same register in every lane; strict <, since a
//     candidate comes after every listed index): each query's least
//     distance of kSteps = 4 steps (one fminf a pair) is tested once, and
//     the warp votes once for the 4 steps.  References past the end are
//     staged at 1e30, so the scan tests no index;
//   * k <= 32 (and every counting launch): when some candidate wins, the
//     warp ballots per query and inserts the winners one by one, lowest
//     lane first.  No vote places a winner: each lane keeps its entry if
//     it comes no later than the candidate, else takes the candidate if
//     its predecessor (one shuffle) comes no later, else the predecessor;
//     the new k-th distance is max(candidate, entry k - 2), and the other
//     winners are tested against it again;
//   * k > 32 (1 query a warp): thread queues, as FAISS's WarpSelect keeps
//     them.  Each lane queues its own winners (kQueue = 2 entries) against
//     a bar that stays as it was until the next merge; when some lane's
//     queue is full (one vote a step), the warp sorts the 64 queued entries
//     (bitonic, by (distance, index)), pairs them reversed with the list,
//     keeps the lesser of each pair and merges that bitonic sequence.
//     There a query needs 300-700 insertions (nr = 10242), and a merge of
//     many winners at once pays.  At 4 queries a warp the queues measured
//     1.3-5x slower than one insertion at a time (215-229 registers, a
//     merge's ~20-36 dependent shuffle stages against ~65-220 insertions a
//     query at k = 8-32): tools/chip_phases.py --topk-variant kQueue=0 and
//     PERF.md section 6;
//   * a CTA of 4 warps stages each tile of references in shared memory, the
//     next tile's loads in flight in registers while this one is scanned;
//   * no split of the reference axis: each split rank would fill lists of
//     its own, and on the card (tools/chip_phases.py --sweep) every split
//     was slower than none at both of the path's shapes;
//   * an optional device flag `done` makes every block return at once, and
//     an optional 64-bit device counter receives the number of insertions
//     of the real queries that entered the top k, scanning in index order
//     (the list work these inputs need, for the bound; null on the path).
//     A counting launch inserts every winner at once at any k.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileBytes = 16384;  // shared-memory tile of reference points
constexpr int kSteps = 4;          // steps of 32 references a vote covers
// Entries of a lane's thread queue (a power of 2) where a warp owns one
// query and k > 32; 0 inserts every winner into the list at once, as the
// other instances and the counting launch do.
constexpr int kQueue = 2;
constexpr unsigned kFull = 0xffffffffu;

// Entry r of this lane's registers where r is only known at run time.
template <int KP, typename T>
__device__ __forceinline__ T pick(const T (&v)[KP], int r) {
  T out = v[0];
#pragma unroll
  for (int s = 1; s < KP; ++s) {
    if (s == r) out = v[s];
  }
  return out;
}

// Inserts (cd, ci) into the warp's sorted list (ld, li) of 32 KP entries:
// an entry that precedes the candidate stays, the first one after it takes
// the candidate, and every later one its predecessor.  Every listed index
// is lower than ci (the scan runs in index order; the unfilled entries are
// (inf, nr) and cd is finite), so an entry precedes the candidate when its
// distance is no larger, and each lane decides from its entry and its
// predecessor's alone, with no vote.  Every lane of the warp calls it with
// the same candidate.
template <int KP>
__device__ __forceinline__ void insert(float cd, int ci, float (&ld)[KP], int (&li)[KP],
                                       int lane) {
  float pd[KP];
  int pi[KP];
#pragma unroll
  for (int r = 0; r < KP; ++r) {
    // The entry one place below: the lane below in the same register, or
    // for lane 0 lane 31 of the register below; before entry 0, a distance
    // every candidate comes after.
    pd[r] = __shfl_up_sync(kFull, ld[r], 1);
    pi[r] = __shfl_up_sync(kFull, li[r], 1);
    float wrap_d = -CUDART_INF_F;
    int wrap_i = 0;
    if (r > 0) {
      wrap_d = __shfl_sync(kFull, ld[r - 1], 31);
      wrap_i = __shfl_sync(kFull, li[r - 1], 31);
    }
    if (lane == 0) {
      pd[r] = wrap_d;
      pi[r] = wrap_i;
    }
  }
#pragma unroll
  for (int r = 0; r < KP; ++r) {
    if (!(ld[r] <= cd)) {
      const bool here = pd[r] <= cd;
      ld[r] = here ? cd : pd[r];
      li[r] = here ? ci : pi[r];
    }
  }
}

// (ad, ai) precedes (bd, bi) in (distance, index) order.
__device__ __forceinline__ bool before(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// Compare-exchange of entry e = 32 r + lane with entry e ^ j of another lane
// (j < 32): this lane keeps the earlier of the two where keep_first, else
// the later.  Both lanes agree, because (distance, index) is a total order
// on the entries (equal entries are both the empty (inf, nr)).
__device__ __forceinline__ void cx_lanes(float& d, int& i, int j, bool keep_first) {
  const float od = __shfl_xor_sync(kFull, d, j);
  const int oi = __shfl_xor_sync(kFull, i, j);
  if (before(od, oi, d, i) == keep_first) {
    d = od;
    i = oi;
  }
}

// Compare-exchange of two registers of one lane: a gets the earlier where
// first, else the later.
__device__ __forceinline__ void cx_regs(float& ad, int& ai, float& bd, int& bi, bool first) {
  if (before(bd, bi, ad, ai) == first) {
    const float td = ad;
    const int ti = ai;
    ad = bd;
    ai = bi;
    bd = td;
    bi = ti;
  }
}

// Bitonic sort of the warp's 32 N entries, e = 32 r + lane in register r,
// ascending in (distance, index).  N is a power of 2; strides of 32 and up
// compare registers of one lane, smaller ones lanes through shuffles.
template <int N>
__device__ __forceinline__ void sort_warp(float (&d)[N], int (&i)[N], int lane) {
  constexpr int kLog = N == 1 ? 5 : N == 2 ? 6 : N == 4 ? 7 : 8;
  static_assert(32 * N == 1 << kLog, "a power of 2 of registers");
#pragma unroll
  for (int ls = 1; ls <= kLog; ++ls) {
#pragma unroll
    for (int lj = ls - 1; lj >= 0; --lj) {
      const int s = 1 << ls, j = 1 << lj;
#pragma unroll
      for (int r = 0; r < N; ++r) {
        const bool up = ((32 * r + lane) & s) == 0;  // this block ascends
        if (j >= 32) {
          const int jr = j >> 5;
          if ((r & jr) == 0) cx_regs(d[r], i[r], d[r | jr], i[r | jr], up);
        } else {
          cx_lanes(d[r], i[r], j, ((lane & j) == 0) == up);
        }
      }
    }
  }
}

// Merges a query's thread queues (TQ entries a lane, in arrival order, the
// empty ones (inf, nr)) into its sorted list of 32 KP entries, keeping the
// 32 KP first in (distance, index) order, and empties the queues: the
// queues are sorted as one sequence, their first 32 KP entries reversed
// against the list, the lesser of each pair kept (a bitonic sequence that
// holds the 32 KP first of both), and that merged.  Returns the new bar,
// min(k-th distance, 1e29).
template <int KP, int TQ>
__device__ __forceinline__ float merge_queues(float (&ld)[KP], int (&li)[KP], float (&qd)[TQ],
                                              int (&qi)[TQ], int k, int nr, int lane) {
  static_assert(KP == 1 || KP == 2 || KP == 4, "a bitonic merge takes 32, 64 or 128 entries");
  sort_warp<TQ>(qd, qi, lane);
#pragma unroll
  for (int r = 0; r < KP; ++r) {
    // Entry 32 KP - 1 - e of the sorted queues: register KP - 1 - r of lane
    // 31 - lane; past the queues' 32 TQ entries, the empty entry.
    if (KP - 1 - r < TQ) {
      const float od = __shfl_xor_sync(kFull, qd[KP - 1 - r], 31);
      const int oi = __shfl_xor_sync(kFull, qi[KP - 1 - r], 31);
      if (before(od, oi, ld[r], li[r])) {
        ld[r] = od;
        li[r] = oi;
      }
    }
  }
#pragma unroll
  for (int j = 16 * KP; j > 0; j >>= 1) {
#pragma unroll
    for (int r = 0; r < KP; ++r) {
      if (j >= 32) {
        const int jr = j >> 5;
        if ((r & jr) == 0) cx_regs(ld[r], li[r], ld[r | jr], li[r | jr], true);
      } else {
        cx_lanes(ld[r], li[r], j, (lane & j) == 0);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < TQ; ++s) {
    qd[s] = CUDART_INF_F;
    qi[s] = nr;
  }
  return fminf(__shfl_sync(kFull, pick<KP>(ld, (k - 1) >> 5), (k - 1) & 31), 1e29f);
}

__device__ __forceinline__ void write_entry(float d, int i, int nr, size_t at,
                                            float* out_d, int* out_i) {
  const bool bad = i >= nr || !(d < 1e29f);
  out_d[at] = bad ? CUDART_INF_F : __fsqrt_rn(fmaxf(d, 0.0f));
  out_i[at] = bad ? nr : i;
}

// Grid ceil(nq / (kWarps QW)): warp w of block b owns queries (b kWarps +
// w) QW + t, t < QW.  DC dimensions are computed (D padded with zeros,
// which add (0 - 0)^2 = 0 exactly); SP is the shared-memory stride of a
// point in floats (a multiple of 4, for 16-byte loads).
template <int KP, int QW, int DC, int SP>
__global__ void __launch_bounds__(kThreads)
    knn_topk_kernel(const float* __restrict__ ref,
                    const float* __restrict__ query, int nr, int nq, int d,
                    int k, const int* __restrict__ done,
                    float* __restrict__ out_d, int* __restrict__ out_i,
                    unsigned long long* __restrict__ insertions) {
  constexpr int kTileRefs = kTileBytes / (SP * 4);
  static_assert(kTileRefs % (32 * kSteps) == 0, "a tile holds whole groups of steps");
  __shared__ __align__(16) float tile[kTileBytes / 4];

  // Every thread reads the same flag, so the block returns whole, before
  // any of its barriers.
  if (done != nullptr && *done != 0) return;
  const int lane = threadIdx.x & 31;
  const int q0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * QW;
  float q[QW][DC];
#pragma unroll
  for (int t = 0; t < QW; ++t) {
    const int qi = q0 + t;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      q[t][c] = (qi < nq && c < d) ? query[(size_t)qi * d + c] : 0.0f;
    }
  }
  float ld[QW][KP];
  int li[QW][KP];
  // min(k-th distance, 1e29): the bar a candidate has to beat.  The same
  // register in every lane; strict <, because a candidate comes after
  // every listed index.
  float thr[QW];
#pragma unroll
  for (int t = 0; t < QW; ++t) {
#pragma unroll
    for (int r = 0; r < KP; ++r) {
      ld[t][r] = CUDART_INF_F;
      li[t][r] = nr;
    }
    thr[t] = 1e29f;
  }
  const int k2r = (k - 2) >> 5;  // register and lane of entry k - 2
  const int k2l = (k - 2) & 31;
  const bool counting = insertions != nullptr;
  unsigned inserted = 0;
  // The thread queues: each lane's winners of each query since the last
  // merge, TQ at most (the counting launch inserts every winner at once).
  constexpr int kLanesQueue = QW == 1 && KP > 1 ? kQueue : 0;
  constexpr int TQ = kLanesQueue > 0 ? kLanesQueue : 1;
  const bool queued = kLanesQueue > 0 && !counting;
  float tq_d[QW][TQ];
  int tq_i[QW][TQ];
  int tq_n[QW];
#pragma unroll
  for (int t = 0; t < QW; ++t) {
    tq_n[t] = 0;
#pragma unroll
    for (int s = 0; s < TQ; ++s) {
      tq_d[t][s] = CUDART_INF_F;
      tq_i[t][s] = nr;
    }
  }

  // The next tile in registers, loaded while this one is scanned: at DC =
  // 3 a thread's kPts points (t, t + kThreads, ...) with their 3
  // coordinates, stored as one float4 each; wider, a thread's coordinate
  // t % SP of kStage points, one float each (coalesced loads).  Points past
  // the references are staged at 1e30, so their squared distances are inf,
  // never beat a k-th entry, and the scan tests no index.  Non-finite
  // coordinates become 1e30.
  constexpr bool kByPoint = DC <= 3;
  constexpr int kPts = kTileRefs / kThreads;
  constexpr int kStage = kByPoint ? kPts * DC : kTileBytes / 4 / kThreads;
  static_assert(kThreads % SP == 0, "a thread stages one coordinate");
  float stage[kStage];
  auto load_tile = [&](int base, int n_tile) {
    if constexpr (kByPoint) {
      const float* src = ref + (size_t)(base + threadIdx.x) * d;
#pragma unroll
      for (int i = 0; i < kPts; ++i) {
        const bool in = (int)threadIdx.x + kThreads * i < n_tile;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          stage[i * DC + c] = c >= d ? 0.0f : in ? __ldg(src + c) : 1e30f;
        }
        src += (size_t)kThreads * d;
      }
    } else {
      const int c = threadIdx.x % SP;
      const float* src = ref + (size_t)(base + threadIdx.x / SP) * d + c;
#pragma unroll
      for (int i = 0; i < kStage; ++i) {
        const int j = threadIdx.x / SP + (kThreads / SP) * i;
        stage[i] = c >= d ? 0.0f : j < n_tile ? __ldg(src) : 1e30f;
        src += (size_t)(kThreads / SP) * d;
      }
    }
  };
  load_tile(0, min(kTileRefs, nr));
  for (int base = 0; base < nr; base += kTileRefs) {
    __syncthreads();  // the previous tile is fully consumed
    if constexpr (kByPoint) {
#pragma unroll
      for (int i = 0; i < kPts; ++i) {
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int c = 0; c < DC; ++c) v[c] = isfinite(stage[i * DC + c]) ? stage[i * DC + c] : 1e30f;
        reinterpret_cast<float4*>(tile)[threadIdx.x + kThreads * i] =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kStage; ++i) {
        tile[threadIdx.x + kThreads * i] = isfinite(stage[i]) ? stage[i] : 1e30f;
      }
    }
    __syncthreads();
    const int n_tile = min(kTileRefs, nr - base);
    if (base + kTileRefs < nr) load_tile(base + kTileRefs, min(kTileRefs, nr - base - kTileRefs));
    const float4* tile4 = reinterpret_cast<const float4*>(tile);
    for (int j0 = 0; j0 < n_tile; j0 += 32 * kSteps) {
      // kSteps steps of 32 references at once: their loads in flight
      // together, each query's least distance of them against its bar,
      // one vote for all.
      float acc[kSteps][QW];
      float least[QW];
#pragma unroll
      for (int t = 0; t < QW; ++t) least[t] = CUDART_INF_F;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int j = j0 + 32 * u + lane;  // < kTileRefs: the load is in bounds
        float r[SP];
#pragma unroll
        for (int m = 0; m < SP / 4; ++m) {
          const float4 v = tile4[j * (SP / 4) + m];
          r[4 * m] = v.x;
          r[4 * m + 1] = v.y;
          r[4 * m + 2] = v.z;
          r[4 * m + 3] = v.w;
        }
#pragma unroll
        for (int t = 0; t < QW; ++t) {
          // 0 + x is x exactly for the square x, so the sum starts at the
          // first square, as the plain version's does.
          const float d0 = __fsub_rn(q[t][0], r[0]);
          float a = __fmul_rn(d0, d0);
#pragma unroll
          for (int c = 1; c < DC; ++c) {
            const float diff = __fsub_rn(q[t][c], r[c]);
            a = __fadd_rn(a, __fmul_rn(diff, diff));
          }
          acc[u][t] = a;
          least[t] = fminf(least[t], a);  // a NaN never wins
        }
      }
      // A squared distance >= 1e29 never fills a slot: the slot keeps
      // (inf, nr), which is what the plain version reports.
      bool hit = false;
#pragma unroll
      for (int t = 0; t < QW; ++t) hit |= least[t] < thr[t];
      if (!__any_sync(kFull, hit)) continue;
      if (queued) {
        // Each lane queues its own winners against its (possibly stale)
        // bar; a query's queues merge into its list when one of them is
        // full, with one vote a step for all the warp's queries.
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          bool full = false;
#pragma unroll
          for (int t = 0; t < QW; ++t) {
            if (acc[u][t] < thr[t]) {
#pragma unroll
              for (int s = TQ - 1; s > 0; --s) {
                tq_d[t][s] = tq_d[t][s - 1];
                tq_i[t][s] = tq_i[t][s - 1];
              }
              tq_d[t][0] = acc[u][t];
              tq_i[t][0] = base + j0 + 32 * u + lane;
              ++tq_n[t];
            }
            full |= tq_n[t] == TQ;
          }
          if (__any_sync(kFull, full)) {
#pragma unroll
            for (int t = 0; t < QW; ++t) {
              if (__any_sync(kFull, tq_n[t] == TQ)) {
                thr[t] = merge_queues<KP, TQ>(ld[t], li[t], tq_d[t], tq_i[t], k, nr, lane);
                tq_n[t] = 0;
              }
            }
          }
        }
        continue;
      }
      // In index order: step by step, query by query, lowest lane first.
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
#pragma unroll
        for (int t = 0; t < QW; ++t) {
          bool want = acc[u][t] < thr[t];
          unsigned m = __ballot_sync(kFull, want);
          while (m != 0u) {
            const int src = __ffs((int)m) - 1;
            const float cd = __shfl_sync(kFull, acc[u][t], src);
            // Entry k - 2, which becomes the k-th unless the candidate comes
            // after it (it beats the k-th entry, so it takes place k - 1).
            const float below = __shfl_sync(kFull, pick<KP>(ld[t], k2r), k2l);
            insert<KP>(cd, base + j0 + 32 * u + src, ld[t], li[t], lane);
            if (counting) inserted += q0 + t < nq;
            thr[t] = fminf(fmaxf(cd, below), 1e29f);
            // The new k-th entry has a lower index than the lanes above
            // src, so a distance tie keeps it.
            want = want && lane > src && acc[u][t] < thr[t];
            m = __ballot_sync(kFull, want);
          }
        }
      }
    }
  }
  if (queued) {
#pragma unroll
    for (int t = 0; t < QW; ++t) {
      if (__any_sync(kFull, tq_n[t] > 0)) merge_queues<KP, TQ>(ld[t], li[t], tq_d[t], tq_i[t], k, nr, lane);
    }
  }
  if (counting && lane == 0) atomicAdd(insertions, (unsigned long long)inserted);

#pragma unroll
  for (int t = 0; t < QW; ++t) {
    const int qi = q0 + t;
    if (qi >= nq) continue;
#pragma unroll
    for (int r = 0; r < KP; ++r) {
      const int p = 32 * r + lane;
      if (p < k) write_entry(ld[t][r], li[t][r], nr, (size_t)qi * k + p, out_d, out_i);
    }
  }
}

template <int KP, int QW, int DC, int SP>
int launch(const float* ref, const float* query, int nr, int nq, int d, int k,
           const int* done, float* out_d, int* out_i, unsigned long long* insertions,
           cudaStream_t stream) {
  const int per_cta = kWarps * QW;
  knn_topk_kernel<KP, QW, DC, SP><<<(nq + per_cta - 1) / per_cta, kThreads, 0, stream>>>(
      ref, query, nr, nq, d, k, done, out_d, out_i, insertions);
  return (int)cudaGetLastError();
}

template <int KP, int QW>
int launch_qw(const float* ref, const float* query, int nr, int nq, int d, int k,
              const int* done, float* out_d, int* out_i, unsigned long long* insertions,
              cudaStream_t s) {
  if (d <= 3) return launch<KP, QW, 3, 4>(ref, query, nr, nq, d, k, done, out_d, out_i, insertions, s);
  if (d <= 8) return launch<KP, QW, 8, 8>(ref, query, nr, nq, d, k, done, out_d, out_i, insertions, s);
  return launch<KP, QW, 16, 16>(ref, query, nr, nq, d, k, done, out_d, out_i, insertions, s);
}

// 4 queries a warp only up to k = 32 (KP = 1), where the planner takes it.
template <int KP>
int launch_kp(const float* ref, const float* query, int nr, int nq, int d, int k, int qw,
              const int* done, float* out_d, int* out_i, unsigned long long* insertions,
              cudaStream_t s) {
  if constexpr (KP == 1) {
    if (qw == 4) return launch_qw<KP, 4>(ref, query, nr, nq, d, k, done, out_d, out_i, insertions, s);
  }
  return launch_qw<KP, 1>(ref, query, nr, nq, d, k, done, out_d, out_i, insertions, s);
}

}  // namespace

// Plain C entry point, loaded through ctypes.  ref f32 [nr, d] and query f32
// [nq, d] are contiguous device arrays; out_d f32 [nq, k] and out_i i32
// [nq, k] are allocated by the caller; `done` is a device int32 flag or
// null; `insertions` a device uint64 counter or null; `qw` the queries a
// warp (1 or 4).  Launches on `stream` without synchronising and returns
// the launch's error (0 on success), or -1 for a k, d or qw the kernel does
// not take, which the Python wrapper rejects before calling.
extern "C" int pyfocusr_knn_topk_f32(const float* ref, const float* query, int nr, int nq,
                                     int d, int k, int qw, const int* done, float* out_d,
                                     int* out_i, unsigned long long* insertions, int device,
                                     void* stream) {
  if (d < 1 || d > 16 || k < 4 || k > 128 || (qw != 1 && qw != 4) || (qw == 4 && k > 32)) {
    return -1;
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Lists of 32, 64 or 128 entries (the merge of the queues is bitonic).
  if (k <= 32) return launch_kp<1>(ref, query, nr, nq, d, k, qw, done, out_d, out_i, insertions, s);
  if (k <= 64) return launch_kp<2>(ref, query, nr, nq, d, k, qw, done, out_d, out_i, insertions, s);
  return launch_kp<4>(ref, query, nr, nq, d, k, qw, done, out_d, out_i, insertions, s);
}
