// Per-node fit and score shared by the dense scan kernel (dense_scan.cu),
// the dense preemption kernel (dense_preempt.cu) and the system fit
// kernel (system_fit.cu); and the dense kernels' lane tables, per-node
// fit, score terms, commit and tiled window walk.
//
// Each expression mirrors nomad_tpu/solver/binpack.py _scoring_parts and
// _solve_system_impl op for op, with the same association, and the score
// terms come from wave_common.cuh (binpack_raw, final_score, anti_term),
// so results agree with the plain PyTorch versions to the bit. The
// sources build with -fmad=false; the two contractions XLA's lowering
// makes are written out as fma(): the reserved-core cpu ask
// (ask_cpu + ask_cores * mhz_per_core) and the score's reciprocal
// multiply-add.
#pragma once

#include <climits>

#include "wave_common.cuh"

namespace nt {

// Effective cpu ask on one node: core-asking tasks' cpu becomes
// mhz_per_core * cores there (rank.go:481-524)
template <typename T>
__device__ __forceinline__ T eff_cpu_ask(T ask_cpu, int ask_cores, T mhz,
                                         bool has_cores) {
  return has_cores ? fma_<T>((T)ask_cores, mhz, ask_cpu) : ask_cpu;
}

// Resource fit and the clipped binpack fitness (before its / 18) of one
// node after the ask: the system score and the dense score's first term.
// free_* divide by max(cap, 1e-9) as the reference does.
template <typename T>
__device__ __forceinline__ bool fits_resources(T used_cpu, T used_mem,
                                               T used_disk, T cpu_cap,
                                               T mem_cap, T disk_cap,
                                               T eff_cpu, T ask_mem,
                                               T ask_disk) {
  return used_cpu + eff_cpu <= cpu_cap && used_mem + ask_mem <= mem_cap &&
         used_disk + ask_disk <= disk_cap;
}

template <typename T>
__device__ __forceinline__ T binpack_after(T used_cpu, T used_mem,
                                           T cpu_cap, T mem_cap, T eff_cpu,
                                           T ask_mem, bool spread_alg) {
  const T free_cpu = T(1) - (used_cpu + eff_cpu) / vmax(cpu_cap, T(1e-9));
  const T free_mem = T(1) - (used_mem + ask_mem) / vmax(mem_cap, T(1e-9));
  return binpack_raw<T>(free_cpu, free_mem, spread_alg);
}

// One spread's boost for a node with value index vi (spread.go
// SpreadIterator + evenSpreadScoreBoost; binpack.py _spread_score):
// cur is the value's current count, des its desired count, wfrac the
// spread's weight share; mn / mx / any are the min and max count over
// present (count > 0) values and whether any is present.
template <typename T>
__device__ __forceinline__ T spread_boost(int vi, int cur, T des,
                                          bool has_targets, T wfrac,
                                          int mn, int mx, bool any) {
  if (vi < 0) return T(-1);             // attribute missing on the node
  if (has_targets) {
    return (des < T(0) || des == T(0))
               ? T(-1)
               : (des - (T)(cur + 1)) / vmax(des, T(1e-9)) * wfrac;
  }
  if (!any) return T(0);
  const T min_f = (T)mn, max_f = (T)mx, cur_f = (T)cur;
  if (cur != mn)
    return mn == 0 ? T(-1) : (min_f - cur_f) / vmax(min_f, T(1e-9));
  return mn == mx ? T(-1) : (max_f - min_f) / vmax(min_f, T(1e-9));
}

// The dense score terms of a node other than binpack: the sum of the
// terms, in the reference's order ((anti + resched) + affinity) + spread
// [+ device affinity], and the number of terms present.
template <typename T>
__device__ __forceinline__ void dense_terms(T coll, T count, bool is_pen,
                                            T aff, T spread, bool has_dev,
                                            T dev_score, bool dev_present,
                                            T& other, T& nscores) {
  const T anti = anti_term<T>(coll, count);
  const T resched = is_pen ? T(-1) : T(0);
  nscores = T(1) + (coll > T(0) ? T(1) : T(0));
  nscores = nscores + (is_pen ? T(1) : T(0));
  nscores = nscores + (aff != T(0) ? T(1) : T(0));
  nscores = nscores + (spread != T(0) ? T(1) : T(0));
  other = ((anti + resched) + aff) + spread;
  if (has_dev) {
    nscores = nscores + (dev_present ? T(1) : T(0));
    other = other + dev_score;
  }
}

typedef unsigned char u8;
typedef unsigned long long u64;

// A fused group's lane tables, (E, ...) each, in solver/dense.py
// DENSE_ARGS order.
template <typename T> struct DenseArgs {
  // NodeConst (E, ...)
  const T *cpu_cap, *mem_cap, *disk_cap;
  const u8* feasible;
  const T* affinity;
  const u8 *has_affinity, *distinct_hosts, *distinct_job_level;
  const int* spread_vidx;              // (S, N)
  const T* spread_desired;             // (S, V)
  const u8* spread_has_targets;
  const T *spread_weights, *spread_sum_weights;
  const int *dp_vidx, *dp_limit;       // (Dp, N), (Dp,)
  const T* dev_aff;                    // (R, Gd, N)
  const int* dev_count;                // (R,)
  const T *dev_sum_weight, *mhz_per_core;
  // PlacementBatch (E, P)
  const T *ask_cpu, *ask_mem, *ask_disk;
  const int* n_dyn;
  const u8* has_static;
  const int *limit, *count, *penalty;
  const u8* active;
  const int* ask_cores;
  // NodeState (E, ...), updated in place
  T *used_cpu, *used_mem, *used_disk;
  int *placed, *placed_job;
  u8* static_free;
  int *dyn_avail, *spread_counts, *dp_counts, *dev_free, *cores_free;
  // outputs (E, P)
  long long* chosen;
  T* scores;
  long long* n_yielded;
  int E, N, P, S, V, Dp, Vd, R, Gd, has_cores, spread_alg;
};

constexpr int kDenseTables = 40;   // DENSE_ARGS in solver/dense.py
constexpr int kDenseDims = 11;     // E N P S V Dp Vd R Gd has_cores
                                   // spread_alg

// Unpack the DENSE_ARGS tables from the packed pointer array p (the
// launch convention of kernels.Kernel.launch), then chosen, scores and
// n_yielded, and the kDenseDims ints from d; k is left after the last
// pointer read.
template <typename T>
__host__ void unpack_dense(DenseArgs<T>& a, void* const* p, int& k,
                           const int* d) {
  a.cpu_cap = (const T*)p[k++]; a.mem_cap = (const T*)p[k++];
  a.disk_cap = (const T*)p[k++]; a.feasible = (const u8*)p[k++];
  a.affinity = (const T*)p[k++]; a.has_affinity = (const u8*)p[k++];
  a.distinct_hosts = (const u8*)p[k++];
  a.distinct_job_level = (const u8*)p[k++];
  a.spread_vidx = (const int*)p[k++]; a.spread_desired = (const T*)p[k++];
  a.spread_has_targets = (const u8*)p[k++];
  a.spread_weights = (const T*)p[k++];
  a.spread_sum_weights = (const T*)p[k++];
  a.dp_vidx = (const int*)p[k++]; a.dp_limit = (const int*)p[k++];
  a.dev_aff = (const T*)p[k++]; a.dev_count = (const int*)p[k++];
  a.dev_sum_weight = (const T*)p[k++]; a.mhz_per_core = (const T*)p[k++];
  a.ask_cpu = (const T*)p[k++]; a.ask_mem = (const T*)p[k++];
  a.ask_disk = (const T*)p[k++]; a.n_dyn = (const int*)p[k++];
  a.has_static = (const u8*)p[k++]; a.limit = (const int*)p[k++];
  a.count = (const int*)p[k++]; a.penalty = (const int*)p[k++];
  a.active = (const u8*)p[k++]; a.ask_cores = (const int*)p[k++];
  a.used_cpu = (T*)p[k++]; a.used_mem = (T*)p[k++];
  a.used_disk = (T*)p[k++]; a.placed = (int*)p[k++];
  a.placed_job = (int*)p[k++]; a.static_free = (u8*)p[k++];
  a.dyn_avail = (int*)p[k++]; a.spread_counts = (int*)p[k++];
  a.dp_counts = (int*)p[k++]; a.dev_free = (int*)p[k++];
  a.cores_free = (int*)p[k++];
  a.E = d[0]; a.N = d[1]; a.P = d[2]; a.S = d[3]; a.V = d[4];
  a.Dp = d[5]; a.Vd = d[6]; a.R = d[7]; a.Gd = d[8];
  a.has_cores = d[9]; a.spread_alg = d[10];
}

// One step's asks (PlacementBatch row i).
template <typename T> struct Ask {
  T cpu, mem, disk, count;
  int n_dyn, limit, penalty, cores;
  bool has_static, active;
};

template <typename T>
__device__ __forceinline__ Ask<T> load_ask(const DenseArgs<T>& A,
                                           size_t ip) {
  Ask<T> a;
  a.cpu = A.ask_cpu[ip]; a.mem = A.ask_mem[ip]; a.disk = A.ask_disk[ip];
  a.count = (T)A.count[ip];
  a.n_dyn = A.n_dyn[ip]; a.limit = A.limit[ip];
  a.penalty = A.penalty[ip];
  a.cores = A.has_cores ? A.ask_cores[ip] : 0;
  a.has_static = A.has_static[ip] != 0;
  a.active = A.active[ip] != 0;
  return a;
}

// Row offsets of lane e in the (E, ...) tables: every table is indexed
// from the kernel's parameters directly, so no per-lane copy of the ~45
// pointers takes registers.
struct Off {
  size_t n, p, s, sv, sn, dp, dpv, dpn, r, rgn;
};

__device__ __forceinline__ Off lane_off(int e, int N, int P, int S, int V,
                                        int Dp, int Vd, int R, int Gd) {
  Off o;
  o.n = (size_t)e * N; o.p = (size_t)e * P; o.s = (size_t)e * S;
  o.sv = o.s * V; o.sn = o.s * N; o.dp = (size_t)e * Dp; o.dpv = o.dp * Vd;
  o.dpn = o.dp * N; o.r = (size_t)e * R; o.rgn = o.r * Gd * N;
  return o;
}

// Per-lane, per-step spread statistics in shared memory: the weight
// shares (set once) and the min / max / any over present (count > 0)
// values of each spread.
template <typename T> struct SpreadStats {
  T* wfrac;
  int *smin, *smax, *sany;
};

template <typename T>
__device__ __forceinline__ SpreadStats<T> spread_stats_init(
    const DenseArgs<T>& A, const Off& o, int e, unsigned char* smem) {
  SpreadStats<T> st;
  st.wfrac = reinterpret_cast<T*>(smem);
  st.smin = reinterpret_cast<int*>(st.wfrac + A.S);
  st.smax = st.smin + A.S;
  st.sany = st.smax + A.S;
  for (int s = threadIdx.x; s < A.S; s += blockDim.x)
    st.wfrac[s] = A.spread_weights[o.s + s] /
                  vmax(A.spread_sum_weights[e], T(1e-9));
  return st;
}

template <typename T>
__device__ __forceinline__ void spread_stats_step(const DenseArgs<T>& A,
                                                  const Off& o,
                                                  const SpreadStats<T>& st) {
  for (int s = threadIdx.x; s < A.S; s += blockDim.x) {
    int mn = INT_MAX, mx = 0, any = 0;
    for (int v = 0; v < A.V; ++v) {
      const int c = A.spread_counts[o.sv + s * A.V + v];
      if (c > 0) {
        any = 1;
        mn = min(mn, c);
        mx = max(mx, c);
      }
    }
    st.smin[s] = mn;
    st.smax[s] = mx;
    st.sany[s] = any;
  }
}

template <typename T>
__host__ size_t spread_stats_bytes(int S) {
  return (size_t)S * (sizeof(T) + 3 * sizeof(int));
}

// The part of node n's fit that no eviction can rescue (binpack.py
// _scoring_parts feas_nonres): constraints, ports, distinct_hosts,
// distinct_property, devices, cores; with the node's device score.
template <typename T>
__device__ __forceinline__ bool node_feasible(const DenseArgs<T>& A,
                                              const Off& o, int e,
                                              const Ask<T>& a, int n,
                                              T& dev_score,
                                              bool& dev_present) {
  const size_t N = A.N, k = o.n + n;
  dev_score = T(0);
  dev_present = false;
  if (!A.feasible[k]) return false;
  if (A.dyn_avail[k] < a.n_dyn) return false;
  if (a.has_static && !A.static_free[k]) return false;
  if (A.distinct_hosts[e]) {
    const int dc = A.distinct_job_level[e] ? A.placed_job[k] : A.placed[k];
    if (dc != 0) return false;
  }
  for (int d = 0; d < A.Dp; ++d) {
    const int v = A.dp_vidx[o.dpn + d * N + n];
    if (v < 0 || A.dp_counts[o.dpv + d * A.Vd + v] >= A.dp_limit[o.dp + d])
      return false;
  }
  if (A.has_cores && A.cores_free[k] < a.cores) return false;
  if (A.R) {
    // every request needs a group with enough free instances; the best
    // such group's affinity per request, summed over requests in order
    T sum_aff = T(0);
    for (int r = 0; r < A.R; ++r) {
      const int need = A.dev_count[o.r + r];
      bool any = false;
      T best = neg_inf<T>();
      for (int g = 0; g < A.Gd; ++g) {
        const size_t q = o.rgn + ((size_t)r * A.Gd + g) * N + n;
        if (A.dev_free[q] >= need) {
          any = true;
          best = vmax(best, A.dev_aff[q]);
        }
      }
      if (!any) return false;
      sum_aff = sum_aff + best;
    }
    const T sw = A.dev_sum_weight[e];
    dev_present = sw > T(0);
    dev_score = dev_present ? sum_aff / vmax(sw, T(1e-9)) : T(0);
  }
  return true;
}

// The effective cpu ask on node n.
template <typename T>
__device__ __forceinline__ T node_eff_cpu(const DenseArgs<T>& A,
                                          const Off& o, const Ask<T>& a,
                                          int n) {
  const bool has_cores = A.has_cores != 0;
  return eff_cpu_ask<T>(a.cpu, a.cores,
                        has_cores ? A.mhz_per_core[o.n + n] : T(0),
                        has_cores);
}

// The score terms of node n other than binpack (dense_terms).
template <typename T>
__device__ __forceinline__ void node_terms(const DenseArgs<T>& A,
                                           const Off& o, int e,
                                           const Ask<T>& a, int n,
                                           const SpreadStats<T>& st,
                                           T dev_score, bool dev_present,
                                           T& other, T& nscores) {
  const size_t N = A.N, k = o.n + n;
  T spread = T(0);
  for (int s = 0; s < A.S; ++s) {
    const int vi = A.spread_vidx[o.sn + s * N + n];
    const int cur = vi < 0 ? 0 : A.spread_counts[o.sv + s * A.V + vi];
    const T des = vi < 0 ? T(0) : A.spread_desired[o.sv + s * A.V + vi];
    spread = spread + spread_boost<T>(vi, cur, des,
                                      A.spread_has_targets[o.s + s] != 0,
                                      st.wfrac[s], st.smin[s], st.smax[s],
                                      st.sany[s] != 0);
  }
  const T aff = A.has_affinity[e] ? A.affinity[k] : T(0);
  dense_terms<T>((T)A.placed[k], a.count, n == a.penalty, aff, spread,
                 A.R > 0, dev_score, dev_present, other, nscores);
}

// Fit of node n, and its final score when it fits (dense
// _scoring_parts).
template <typename T>
__device__ __forceinline__ bool score_node(const DenseArgs<T>& A,
                                           const Off& o, int e,
                                           const Ask<T>& a, int n,
                                           const SpreadStats<T>& st,
                                           T& final) {
  T dev_score;
  bool dev_present;
  if (!node_feasible<T>(A, o, e, a, n, dev_score, dev_present))
    return false;
  const size_t k = o.n + n;
  const T eff_cpu = node_eff_cpu<T>(A, o, a, n);
  const T ucpu = A.used_cpu[k], umem = A.used_mem[k];
  const T ccap = A.cpu_cap[k], mcap = A.mem_cap[k];
  if (!fits_resources<T>(ucpu, umem, A.used_disk[k], ccap, mcap,
                         A.disk_cap[k], eff_cpu, a.mem, a.disk))
    return false;
  const T bp = binpack_after<T>(ucpu, umem, ccap, mcap, eff_cpu, a.mem,
                                A.spread_alg != 0);
  T other, nscores;
  node_terms<T>(A, o, e, a, n, st, dev_score, dev_present, other, nscores);
  final = final_score<T>(bp, other, nscores);
  return true;
}

// Commit winner w's spread, distinct_property and device tables
// (binpack.py _commit_tables); thread 0 only.
template <typename T>
__device__ __forceinline__ void commit_tables(const DenseArgs<T>& A,
                                              const Off& o, int w) {
  const size_t N = A.N;
  for (int s = 0; s < A.S; ++s) {
    const int v = A.spread_vidx[o.sn + s * N + w];
    if (v >= 0) A.spread_counts[o.sv + s * A.V + v] += 1;
  }
  for (int d = 0; d < A.Dp; ++d) {
    const int v = A.dp_vidx[o.dpn + d * N + w];
    if (v >= 0) A.dp_counts[o.dpv + d * A.Vd + v] += 1;
  }
  for (int r = 0; r < A.R; ++r) {
    // the group with the first maximal affinity among those with room
    const int need = A.dev_count[o.r + r];
    int g_star = 0;
    T best = neg_inf<T>();
    for (int g = 0; g < A.Gd; ++g) {
      const size_t q = o.rgn + ((size_t)r * A.Gd + g) * N + w;
      const T av = A.dev_free[q] >= need ? A.dev_aff[q] : neg_inf<T>();
      if (av > best) {
        best = av;
        g_star = g;
      }
    }
    A.dev_free[o.rgn + ((size_t)r * A.Gd + g_star) * N + w] -= need;
  }
}

constexpr int kDenseWarps = 16;      // 512 threads per lane
constexpr int kDenseChunks = 4;      // 32-node chunks per warp per tile

// Shared scratch of the window walk.
template <typename T, int NW> struct WalkShared {
  u64 wsum[NW];
  Key<T> red[NW];
  // the step's skipped options by skip rank (at most MAX_SKIP)
  T skip_eff[kMaxSkip];
  int skip_idx[kMaxSkip];
};

// One step's window walk over a lane's N nodes in shuffled order, one
// tile of 32 * NW * kDenseChunks nodes at a time (warp w owns kDenseChunks
// 32-node chunks of the tile, one node per lane, coalesced):
//   1. every thread scores its nodes with score(n, final) -> fit, keeping
//      the scores in registers; the warp counts fit and low nodes with
//      ballots;
//   2. one block scan over the warps' packed (low, fit) counts gives each
//      warp its offsets: with skip_rank = cumsum(low), cumsum(skipped) =
//      min(skip_rank, MAX_SKIP) and cumsum(counted) = cumsum(fit) -
//      cumsum(skipped), this one scan stands for the reference's three
//      (skip_rank, cpos, srank), ranks 1-based as there;
//   3. each node's rank within its chunk (ballot + popc) marks the counted
//      options inside the window (cpos <= limit); the thread keeps its
//      best (score, window order) and the skipped options go to shared
//      memory by skip rank;
// once `limit` options are counted, no later node can enter the window or
// be needed as fallback (the argument of the reference's FAST_T shortcut,
// for any prefix), so the walk stops there. Thread 0 then adds the
// skipped options the deficit calls for (order limit + srank), and one
// block arg-best picks the winner (ties to the smallest order), returned
// to every thread with n_yielded = min(counted, limit) + min(deficit,
// skipped) from the scans' totals. Every thread must call it.
template <typename T, int NW, typename ScoreFn>
__device__ __forceinline__ Key<T> window_walk(int N, int L, ScoreFn score,
                                              WalkShared<T, NW>& sh,
                                              int& ny) {
  constexpr int TILE = 32 * NW * kDenseChunks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned le_mask = 0xffffffffu >> (31 - lane);   // lanes <= me
  Key<T> best;
  best.eff = neg_inf<T>();
  best.order = INT_MAX;
  best.idx = INT_MAX;
  best.y = 0;
  int fit_base = 0, low_base = 0;       // counts over the tiles before
  for (int base = 0; base < N; base += TILE) {
    const int seg = base + warp * kDenseChunks * 32;
    T fin[kDenseChunks];
    unsigned fm[kDenseChunks], lm[kDenseChunks];
    unsigned wfit = 0, wlow = 0;
#pragma unroll
    for (int c = 0; c < kDenseChunks; ++c) {
      const int n = seg + c * 32 + lane;
      bool fit = false, low = false;
      fin[c] = T(0);
      if (n < N) {
        fit = score(n, fin[c]);
        low = fit && fin[c] <= T(0);
      }
      fm[c] = __ballot_sync(kFull, fit);
      lm[c] = __ballot_sync(kFull, low);
      wfit += __popc(fm[c]);
      wlow += __popc(lm[c]);
    }
    const u64 mine = lane == 0 ? ((u64)wlow << 32) | wfit : 0;
    u64 total;
    const u64 incl = block_scan<NW, u64>(mine, total, sh.wsum);
    const u64 excl = __shfl_sync(kFull, incl - mine, 0);
    int fit_off = fit_base + (int)(excl & 0xffffffffu);
    int low_off = low_base + (int)(excl >> 32);
#pragma unroll
    for (int c = 0; c < kDenseChunks; ++c) {
      const int n = seg + c * 32 + lane;
      const bool fit = (fm[c] >> lane) & 1u, low = (lm[c] >> lane) & 1u;
      const int skip_rank = low_off + __popc(lm[c] & le_mask);
      const int srank = min(skip_rank, kMaxSkip);
      const bool skipped = low && skip_rank <= kMaxSkip;
      const int cpos = fit_off + __popc(fm[c] & le_mask) - srank;
      if (fit && !skipped && cpos <= L) {
        Key<T> k;
        k.eff = fin[c];
        k.order = cpos;
        k.idx = n;
        k.y = 1;
        if (better(k, best)) best = k;
      }
      if (skipped) {
        sh.skip_eff[srank - 1] = fin[c];
        sh.skip_idx[srank - 1] = n;
      }
      fit_off += __popc(fm[c]);
      low_off += __popc(lm[c]);
    }
    fit_base += (int)(total & 0xffffffffu);
    low_base += (int)(total >> 32);
    if (fit_base - min(low_base, kMaxSkip) >= L) break;
  }
  __syncthreads();                      // skip_eff / skip_idx complete
  const int tot_skipped = min(low_base, kMaxSkip);
  const int tot_counted = fit_base - tot_skipped;
  const int deficit = max(0, L - min(tot_counted, L));
  if (tid == 0) {
    // fallback: skipped options in skip order, for the deficit
    for (int r = 1; r <= min(deficit, tot_skipped); ++r) {
      Key<T> k;
      k.eff = sh.skip_eff[r - 1];
      k.order = L + r;
      k.idx = sh.skip_idx[r - 1];
      k.y = 1;
      if (better(k, best)) best = k;
    }
  }
  ny = min(tot_counted, L) + min(deficit, tot_skipped);
  return block_best<T, NW>(best, sh.red);
}

}  // namespace nt
