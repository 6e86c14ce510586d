// Per-node fit and score shared by the dense scan kernel (dense_scan.cu),
// the dense preemption kernel (dense_preempt.cu), the node-sharded step
// (dense_shard.cu) and the system fit kernel (system_fit.cu); the dense
// kernels' lane tables, per-node fit, score terms and device commit; and
// the cluster walk of the two dense kernels with its launcher (below).
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

#include <cooperative_groups.h>

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
// launch convention of kernels.Kernel.launch, or a row of the node-sharded
// scan's device table of cells), then chosen, scores and n_yielded, and
// the kDenseDims ints from d; k is left after the last pointer read.
template <typename T>
__host__ __device__ void unpack_dense(DenseArgs<T>& a, void* const* p,
                                      int& k, const int* d) {
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
  // the lane's spread counts (S, V), desired counts (S, V) and
  // distinct_property counts (Dp, Vd): its rows in global memory, or a
  // block's copies in shared memory (dense_scan.cu, dense_preempt.cu)
  const int *counts, *dpc;
  const T* desired;
};

template <typename T>
__device__ __forceinline__ SpreadStats<T> spread_stats_init(
    const DenseArgs<T>& A, const Off& o, int e, unsigned char* smem) {
  SpreadStats<T> st;
  st.wfrac = reinterpret_cast<T*>(smem);
  st.smin = reinterpret_cast<int*>(st.wfrac + A.S);
  st.smax = st.smin + A.S;
  st.sany = st.smax + A.S;
  st.counts = A.spread_counts + o.sv;
  st.dpc = A.dp_counts + o.dpv;
  st.desired = A.spread_desired + o.sv;
  for (int s = threadIdx.x; s < A.S; s += blockDim.x)
    st.wfrac[s] = A.spread_weights[o.s + s] /
                  vmax(A.spread_sum_weights[e], T(1e-9));
  return st;
}

// The min / max / any of spread s over its present values.
template <typename T>
__device__ __forceinline__ void spread_stat(const SpreadStats<T>& st, int s,
                                            int V) {
  int mn = INT_MAX, mx = 0, any = 0;
  for (int v = 0; v < V; ++v) {
    const int c = st.counts[s * V + v];
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

template <typename T>
__device__ __forceinline__ void spread_stats_step(const DenseArgs<T>& A,
                                                  const Off& o,
                                                  const SpreadStats<T>& st) {
  for (int s = threadIdx.x; s < A.S; s += blockDim.x)
    spread_stat<T>(st, s, A.V);
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
                                              const int* dpc,
                                              T& dev_score,
                                              bool& dev_present) {
  const size_t N = A.N, k = o.n + n;
  dev_score = T(0);
  dev_present = false;
  // the node's columns are read before the first test, so that the
  // loads are in flight together (the tests are one conjunction: their
  // order does not change the result)
  const bool feas = A.feasible[k] != 0;
  const int dyn = A.dyn_avail[k];
  const bool sfree = !a.has_static || A.static_free[k];
  const int dc = !A.distinct_hosts[e] ? 0
                 : A.distinct_job_level[e] ? A.placed_job[k] : A.placed[k];
  const int cfree = A.has_cores ? A.cores_free[k] : INT_MAX;
  const int dv0 = A.Dp ? A.dp_vidx[o.dpn + n] : 0;
  if (!feas || dyn < a.n_dyn || !sfree || dc != 0 ||
      (A.has_cores && cfree < a.cores))
    return false;
  for (int d = 0; d < A.Dp; ++d) {
    const int v = d == 0 ? dv0 : A.dp_vidx[o.dpn + d * N + n];
    if (v < 0 || dpc[d * A.Vd + v] >= A.dp_limit[o.dp + d])
      return false;
  }
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

// The columns of node n that its score terms read, loaded together
// ahead of the fit tests: placed count, affinity, mhz per core and the
// first two spreads' value indices.
template <typename T> struct NodePre {
  T aff, mhz;
  int placed, sv0, sv1;
};

template <typename T>
__device__ __forceinline__ NodePre<T> node_pre(const DenseArgs<T>& A,
                                               const Off& o, int e, int n) {
  const size_t k = o.n + n;
  NodePre<T> p;
  p.placed = A.placed[k];
  p.aff = A.has_affinity[e] ? A.affinity[k] : T(0);
  p.mhz = A.has_cores ? A.mhz_per_core[k] : T(0);
  p.sv0 = A.S > 0 ? A.spread_vidx[o.sn + n] : -1;
  p.sv1 = A.S > 1 ? A.spread_vidx[o.sn + (size_t)A.N + n] : -1;
  return p;
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
                                           const NodePre<T>& p,
                                           T dev_score, bool dev_present,
                                           T& other, T& nscores) {
  const size_t N = A.N;
  T spread = T(0);
  for (int s = 0; s < A.S; ++s) {
    const int vi = s == 0 ? p.sv0
                   : s == 1 ? p.sv1 : A.spread_vidx[o.sn + s * N + n];
    const int cur = vi < 0 ? 0 : st.counts[s * A.V + vi];
    const T des = vi < 0 ? T(0) : st.desired[s * A.V + vi];
    spread = spread + spread_boost<T>(vi, cur, des,
                                      A.spread_has_targets[o.s + s] != 0,
                                      st.wfrac[s], st.smin[s], st.smax[s],
                                      st.sany[s] != 0);
  }
  dense_terms<T>((T)p.placed, a.count, n == a.penalty, p.aff, spread,
                 A.R > 0, dev_score, dev_present, other, nscores);
}

// Fit of node n, and its final score when it fits (dense
// _scoring_parts), from the node's usage and caps as the caller holds
// them.
template <typename T>
__device__ __forceinline__ bool score_node_vals(
    const DenseArgs<T>& A, const Off& o, int e, const Ask<T>& a, int n,
    const SpreadStats<T>& st, T ucpu, T umem, T udisk, T ccap, T mcap,
    T dcap, T& final) {
  const NodePre<T> p = node_pre<T>(A, o, e, n);
  T dev_score;
  bool dev_present;
  if (!node_feasible<T>(A, o, e, a, n, st.dpc, dev_score, dev_present))
    return false;
  const T eff_cpu = eff_cpu_ask<T>(a.cpu, a.cores, p.mhz, A.has_cores != 0);
  if (!fits_resources<T>(ucpu, umem, udisk, ccap, mcap, dcap, eff_cpu,
                         a.mem, a.disk))
    return false;
  const T bp = binpack_after<T>(ucpu, umem, ccap, mcap, eff_cpu, a.mem,
                                A.spread_alg != 0);
  T other, nscores;
  node_terms<T>(A, o, e, a, n, st, p, dev_score, dev_present, other,
                nscores);
  final = final_score<T>(bp, other, nscores);
  return true;
}

// score_node_vals with the usage and caps read from global memory.
template <typename T>
__device__ __forceinline__ bool score_node(const DenseArgs<T>& A,
                                           const Off& o, int e,
                                           const Ask<T>& a, int n,
                                           const SpreadStats<T>& st,
                                           T& final) {
  const size_t k = o.n + n;
  return score_node_vals<T>(A, o, e, a, n, st, A.used_cpu[k], A.used_mem[k],
                            A.used_disk[k], A.cpu_cap[k], A.mem_cap[k],
                            A.disk_cap[k], final);
}

// Take winner w's device instances from the group with the first
// maximal affinity among those with room, per request (binpack.py
// _commit_tables); one thread.
template <typename T>
__device__ __forceinline__ void commit_devices(const DenseArgs<T>& A,
                                               const Off& o, int w) {
  const size_t N = A.N;
  for (int r = 0; r < A.R; ++r) {
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

// --------------------------------------------------------------------
// The cluster walk of the dense kernels (dense_scan.cu, dense_preempt.cu):
// a lane's window walk split over a thread-block cluster of C blocks,
// exchanging through distributed shared memory.
//
// The walk goes in rounds over the lane's nodes in window order, cut
// into tiles of C * sub nodes: block c of the cluster owns the sub nodes
// from t * C * sub + c * sub of every tile t, in every step of the launch
// (the ones it may stage in shared memory and commits to). A round covers
// the next K tiles (its chunks k < K). A round:
//   1. every thread scores its node of each chunk (the kernel's tile
//      functor); each warp counts its fit and low nodes per chunk with
//      ballots;
//   2. the block's packed (low, fit) count of each chunk goes to slot
//      (k, c) of every block's shared memory (remote stores), then one
//      cluster barrier; every block reads the K x C counts, whose
//      exclusive prefix in window order (chunk, then block, then warp)
//      gives each node's global skip rank and window position
//      (skip_rank = cumsum(low), cumsum(skipped) = min(skip_rank,
//      MAX_SKIP), cumsum(counted) = cumsum(fit) - cumsum(skipped), ranks
//      1-based as in the reference);
//   3. each thread keeps its best (score, window order) option in the
//      window; a skipped option goes to every block by its global skip
//      rank (the slots are unique, so no atomics);
// every block sees the same totals, so all stop after the same round:
// the one in which `limit` options are counted (no later node can enter
// the window or be needed as fallback). Then each block's best record
// (Key and payload) goes to slot c of every block, one cluster barrier,
// and every block reduces the C records and the fallback skipped options
// (order limit + srank) with better(): the window orders are unique, so
// the winner is the one-block walk's. Only integers and the options' own
// scores cross blocks; no float is re-associated.
//
// Count slots and warp sums alternate between two buffers by round, so
// a block that runs ahead writes the other buffer: a buffer is written
// again only after the next round's barrier, which every block reaches
// after reading it.

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 16;     // non-portable cluster size on sm_90
constexpr int kSmemBudget = 232448; // shared memory a block may use (B)

// A block's published option: its Key and the kernel's payload.
template <typename T, typename X> struct Rec {
  Key<T> k;
  X x;
};

struct NoX {};

// Launch parameters of the cluster kernels: the cluster size, the nodes
// a block owns per tile, its staged node slots (0: the node columns
// stay in global memory) and whether the lane's count tables are
// replicated in shared memory (else they stay in global memory, which
// only C = 1 allows).
struct ClusterCfg {
  int C, sub, slots, rep;
};

template <typename T, typename X, int NW, int K> struct ClusterShared {
  u64 cnt[2][K][kMaxCluster];
  u64 wsum[2][K][NW];
  Rec<T, X> wrec[NW];
  Rec<T, X> rec[kMaxCluster];
  Rec<T, X> skip[kMaxSkip];
  Rec<T, X> win;
};

template <typename T>
__device__ __forceinline__ Key<T> no_key() {
  Key<T> k;
  k.eff = neg_inf<T>();
  k.order = INT_MAX;
  k.idx = INT_MAX;
  k.y = 0;
  return k;
}

template <typename T>
__device__ __forceinline__ bool same_key(const Key<T>& a, const Key<T>& b) {
  return a.y == b.y && a.eff == b.eff && a.order == b.order && a.idx == b.idx;
}

// The warp's best key, returned to every lane.
template <typename T>
__device__ __forceinline__ Key<T> warp_best(Key<T> k) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Key<T> o;
    o.eff = __shfl_xor_sync(kFull, k.eff, off);
    o.order = __shfl_xor_sync(kFull, k.order, off);
    o.idx = __shfl_xor_sync(kFull, k.idx, off);
    o.y = __shfl_xor_sync(kFull, k.y, off);
    if (better(o, k)) k = o;
  }
  return k;
}

// One step's cluster walk over a lane's N nodes (see above), in rounds
// of K chunks. Each thread calls tile(n0, k, n, fit, fin) for each chunk
// k < K with n0 the first node of the block's
// share of chunk k: it sets n to its node there (nodes increase with
// the thread index; n >= N means none), fit, and the final score fin
// when fit; payload(k) gives that node's payload, asked for only when
// the node becomes the thread's best or a skipped option. Returns the
// step's winner to every thread of every block, and ny = min(counted,
// limit) + min(deficit, skipped). round counts the rounds over the
// launch. Every thread of the cluster must call it.
template <typename T, typename X, int NW, int K, typename Tile,
          typename Payload>
__device__ __forceinline__ Rec<T, X> cluster_walk(
    const ClusterCfg& g, int c, int N, int L, Tile tile,
    Payload payload, ClusterShared<T, X, NW, K>& sh, int& ny,
    unsigned& round) {
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned le_mask = 0xffffffffu >> (31 - lane);   // lanes <= me
  const int tile_n = g.C * g.sub;
  Key<T> best = no_key<T>();
  X bestx = X();
  int fit_base = 0, low_base = 0;       // counts over the rounds before
  NT_T0();
  for (int base = 0; base < N; base += K * tile_n) {
    const unsigned par = round & 1u;
    T fin[K];
    int nn[K];
    unsigned fm[K], lm[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      bool fit = false;
      fin[k] = T(0);
      nn[k] = INT_MAX;
      tile(base + k * tile_n + c * g.sub, k, nn[k], fit, fin[k]);
      fit = fit && nn[k] < N;
      const bool low = fit && fin[k] <= T(0);
      fm[k] = __ballot_sync(kFull, fit);
      lm[k] = __ballot_sync(kFull, low);
      if (lane == 0)
        sh.wsum[par][k][warp] = ((u64)__popc(lm[k]) << 32) | __popc(fm[k]);
    }
    NT_CLK(1);
    __syncthreads();
    if (tid < g.C) {
      for (int k = 0; k < K; ++k) {
        u64 tot = 0;
        for (int w = 0; w < NW; ++w) tot += sh.wsum[par][k][w];
        *cl.map_shared_rank(&sh.cnt[par][k][c], tid) = tot;
      }
    }
    cl.sync();
    ++round;
    NT_CLK(2);
    u64 run = 0;                        // over the round's chunks before
#pragma unroll
    for (int k = 0; k < K; ++k) {
      u64 pre = run, all = 0;
      for (int j = 0; j < g.C; ++j) {
        const u64 x = sh.cnt[par][k][j];
        if (j < c) pre += x;
        all += x;
      }
      for (int w = 0; w < warp; ++w) pre += sh.wsum[par][k][w];
      run += all;
      const bool fit = (fm[k] >> lane) & 1u, low = (lm[k] >> lane) & 1u;
      const int skip_rank =
          low_base + (int)(pre >> 32) + __popc(lm[k] & le_mask);
      const int srank = min(skip_rank, kMaxSkip);
      const bool skipped = low && skip_rank <= kMaxSkip;
      const int cpos = fit_base + (int)(pre & 0xffffffffu) +
                       __popc(fm[k] & le_mask) - srank;
      if (fit && !skipped && cpos <= L) {
        Key<T> q;
        q.eff = fin[k];
        q.order = cpos;
        q.idx = nn[k];
        q.y = 1;
        if (better(q, best)) {
          best = q;
          bestx = payload(k);
        }
      }
      if (skipped) {
        Rec<T, X> r;
        r.k.eff = fin[k];
        r.k.order = 0;
        r.k.idx = nn[k];
        r.k.y = 1;
        r.x = payload(k);
        for (int j = 0; j < g.C; ++j)
          *cl.map_shared_rank(&sh.skip[srank - 1], j) = r;
      }
    }
    fit_base += (int)(run & 0xffffffffu);
    low_base += (int)(run >> 32);
    NT_CLK(3);
    NT_CNT(8, 1);
    if (fit_base - min(low_base, kMaxSkip) >= L) break;
  }
  const int tot_skipped = min(low_base, kMaxSkip);
  const int tot_counted = fit_base - tot_skipped;
  const int deficit = max(0, L - min(tot_counted, L));
  ny = min(tot_counted, L) + min(deficit, tot_skipped);

  // the block's best record, to slot c of every block
  const Key<T> wb = warp_best<T>(best);
  const unsigned wm = __ballot_sync(kFull, same_key<T>(best, wb));
  if (lane == __ffs(wm) - 1) {
    sh.wrec[warp].k = best;
    sh.wrec[warp].x = bestx;
  }
  __syncthreads();
  if (warp == 0) {
    const Key<T> q = lane < NW ? sh.wrec[lane].k : no_key<T>();
    const Key<T> b = warp_best<T>(q);
    const int src = __ffs(__ballot_sync(kFull, lane < NW &&
                                               same_key<T>(q, b))) - 1;
    if (lane < g.C) *cl.map_shared_rank(&sh.rec[c], lane) = sh.wrec[src];
  }
  cl.sync();
  // every block: the winner over the C records and the fallback
  if (warp == 0) {
    Key<T> q = no_key<T>();
    const int r = lane - g.C + 1;       // fallback skip rank
    if (lane < g.C) {
      q = sh.rec[lane].k;
    } else if (r >= 1 && r <= min(deficit, tot_skipped)) {
      q = sh.skip[r - 1].k;
      q.order = L + r;
    }
    const Key<T> b = warp_best<T>(q);
    const int src = __ffs(__ballot_sync(kFull, same_key<T>(q, b))) - 1;
    if (lane == src) {
      sh.win.x = lane < g.C ? sh.rec[lane].x : sh.skip[r - 1].x;
      sh.win.k = b;
    }
  }
  __syncthreads();
  NT_CLK(4);
  return sh.win;
}

// The lane's view in a cluster block: its node columns (caps and usage,
// staged or in global memory), the spread statistics and the count
// tables it reads (replicas in shared memory when cfg.rep, else the
// lane's global rows).
template <typename T> struct LaneView {
  const T *ccap, *mcap, *dcap;
  T *ucpu, *umem, *udisk;
  SpreadStats<T> st;
  int *sc, *dpc, *gc;                   // spread, distinct_property and
                                        // (preemption) group counts
  int staged;
};

// Dynamic shared memory layout of a cluster block: staged columns (6 x
// slots T: cpu/mem/disk caps, then cpu/mem/disk usage), with rep the
// spread desired counts (S V T), spread weight shares (S T), spread
// statistics (3 S ints), then with rep the replicated count tables:
// spread (S V), distinct_property (Dp Vd) and group counts (G).
template <typename T>
__host__ __device__ __forceinline__ size_t lane_smem_bytes(
    int slots, int S, int V, int Dp, int Vd, int G, int rep) {
  return 6 * sizeof(T) * (size_t)slots + sizeof(T) * (size_t)S +
         3 * sizeof(int) * (size_t)S +
         (rep ? sizeof(T) * (size_t)S * V +
                    sizeof(int) * ((size_t)S * V + (size_t)Dp * Vd + G)
              : 0);
}

// The ClusterCfg of a lane of N nodes at cluster size C, sub nodes a
// block per tile, G group counts: the count tables replicated where
// they fit in `budget` (only then may C exceed 1), the node columns
// staged where they fit beside them; smem receives the dynamic bytes.
template <typename T>
__host__ ClusterCfg cluster_cfg(int C, int sub, int N, int S, int V, int Dp,
                                int Vd, int G, size_t budget, size_t& smem) {
  ClusterCfg g;
  g.C = C;
  g.sub = sub;
  g.rep = lane_smem_bytes<T>(0, S, V, Dp, Vd, G, 1) <= budget;
  const int tiles = (N + C * sub - 1) / (C * sub);
  g.slots = tiles * sub;
  if (lane_smem_bytes<T>(g.slots, S, V, Dp, Vd, G, g.rep) > budget)
    g.slots = 0;
  smem = lane_smem_bytes<T>(g.slots, S, V, Dp, Vd, G, g.rep);
  if (!g.rep && C > 1) smem = budget + 1;   // refused: C = 1 only
  return g;
}

// The block's local slot of node n (one it owns).
__device__ __forceinline__ int node_slot(const ClusterCfg& g, int n) {
  return (n / (g.C * g.sub)) * g.sub + n % g.sub;
}

// Set up the lane view of block c (every thread calls it): stage the
// block's node columns, copy the count tables into the replicas, and
// compute the spread statistics. gcounts is the lane's (G,) group counts
// (nullptr for none).
template <typename T>
__device__ __forceinline__ LaneView<T> lane_view(const DenseArgs<T>& A,
                                                 const Off& o, int e,
                                                 const ClusterCfg& g, int c,
                                                 int* gcounts, int G,
                                                 unsigned char* smem) {
  LaneView<T> v;
  const int tid = threadIdx.x;
  T* tv = reinterpret_cast<T*>(smem);
  v.staged = g.slots > 0;
  if (v.staged) {
    T* col[6];
    for (int q = 0; q < 6; ++q) col[q] = tv + (size_t)q * g.slots;
    const T* src[6] = {A.cpu_cap, A.mem_cap, A.disk_cap,
                       A.used_cpu, A.used_mem, A.used_disk};
    for (int l = tid; l < g.slots; l += blockDim.x) {
      const int n = (l / g.sub) * g.C * g.sub + c * g.sub + l % g.sub;
      for (int q = 0; q < 6; ++q)
        col[q][l] = n < A.N ? src[q][o.n + n] : T(0);
    }
    v.ccap = col[0]; v.mcap = col[1]; v.dcap = col[2];
    v.ucpu = col[3]; v.umem = col[4]; v.udisk = col[5];
  } else {
    v.ccap = A.cpu_cap + o.n; v.mcap = A.mem_cap + o.n;
    v.dcap = A.disk_cap + o.n;
    v.ucpu = A.used_cpu + o.n; v.umem = A.used_mem + o.n;
    v.udisk = A.used_disk + o.n;
  }
  T* desired = tv + 6 * (size_t)g.slots;
  unsigned char* rest = reinterpret_cast<unsigned char*>(
      g.rep ? desired + (size_t)A.S * A.V : desired);
  v.st = spread_stats_init<T>(A, o, e, rest);
  int* ints = v.st.sany + A.S;
  if (g.rep) {
    for (int q = tid; q < A.S * A.V; q += blockDim.x)
      desired[q] = A.spread_desired[o.sv + q];
    v.st.desired = desired;
    v.sc = ints;
    v.dpc = v.sc + A.S * A.V;
    v.gc = v.dpc + A.Dp * A.Vd;
    for (int q = tid; q < A.S * A.V; q += blockDim.x)
      v.sc[q] = A.spread_counts[o.sv + q];
    for (int q = tid; q < A.Dp * A.Vd; q += blockDim.x)
      v.dpc[q] = A.dp_counts[o.dpv + q];
    for (int q = tid; q < G; q += blockDim.x) v.gc[q] = gcounts[q];
  } else {
    v.sc = A.spread_counts + o.sv;
    v.dpc = A.dp_counts + o.dpv;
    v.gc = gcounts;
  }
  v.st.counts = v.sc;
  v.st.dpc = v.dpc;
  __syncthreads();
  for (int s = tid; s < A.S; s += blockDim.x) spread_stat<T>(v.st, s, A.V);
  __syncthreads();
  return v;
}

// The column index of node n in the view.
template <typename T>
__device__ __forceinline__ int col_at(const LaneView<T>& v,
                                      const ClusterCfg& g, int n) {
  return v.staged ? node_slot(g, n) : n;
}

// The replicated tables take winner w's spread and distinct_property
// values (binpack.py _commit_tables), and the statistics of the spreads
// are recomputed; every block runs it (the threads split the tables).
template <typename T>
__device__ __forceinline__ void commit_counts(const DenseArgs<T>& A,
                                              const Off& o,
                                              const LaneView<T>& v, int w) {
  const size_t N = A.N;
  for (int s = threadIdx.x; s < A.S; s += blockDim.x) {
    const int vi = A.spread_vidx[o.sn + s * N + w];
    if (vi >= 0) v.sc[s * A.V + vi] += 1;
    spread_stat<T>(v.st, s, A.V);
  }
  for (int d = threadIdx.x; d < A.Dp; d += blockDim.x) {
    const int vi = A.dp_vidx[o.dpn + d * N + w];
    if (vi >= 0) v.dpc[d * A.Vd + vi] += 1;
  }
}

// End of a cluster kernel: block 0 writes the replicated tables back to
// the lane's state, and a last cluster barrier keeps every block's
// shared memory alive until no block can address it.
template <typename T>
__device__ __forceinline__ void lane_view_close(const DenseArgs<T>& A,
                                                const Off& o,
                                                const LaneView<T>& v,
                                                const ClusterCfg& g, int c,
                                                int* gcounts, int G) {
  __syncthreads();
  if (g.rep && c == 0) {
    for (int q = threadIdx.x; q < A.S * A.V; q += blockDim.x)
      A.spread_counts[o.sv + q] = v.sc[q];
    for (int q = threadIdx.x; q < A.Dp * A.Vd; q += blockDim.x)
      A.dp_counts[o.dpv + q] = v.dpc[q];
    for (int q = threadIdx.x; q < G; q += blockDim.x) gcounts[q] = v.gc[q];
  }
  cg::this_cluster().sync();
}

// Host: the largest power of two C <= kMaxCluster with E * C <= sms.
__host__ inline int cluster_cap(int E, int sms) {
  int C = 1;
  while (C < kMaxCluster && (long long)E * (2 * C) <= sms) C *= 2;
  return C;
}

__host__ inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Host: the cluster size for E lanes of kern, at most c_max: the
// largest power of two with E * C <= the card's SM count whose E
// clusters can all be resident at once (cudaOccupancyMaxActiveClusters),
// else 1; C = 1 also where the count tables do not fit in shared memory
// (cfg_for(1, ...) gives rep = 0). cfg_for(C, budget, smem) returns the
// ClusterCfg for C and sets its dynamic shared memory bytes. Fills lc
// (grid, block, shared memory, the cluster attribute in *attr) and *g
// for the size chosen, and sets the kernel's attributes for it.
template <typename Kern, typename CfgFor>
__host__ cudaError_t choose_cluster(Kern kern, int E, int threads,
                                    CfgFor cfg_for, int c_max,
                                    cudaLaunchConfig_t* lc,
                                    cudaLaunchAttribute* attr,
                                    ClusterCfg* g, int* chosen) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return err;
  const size_t budget = kSmemBudget - fa.sharedSizeBytes;
  *lc = cudaLaunchConfig_t{};
  *attr = cudaLaunchAttribute{};
  attr->id = cudaLaunchAttributeClusterDimension;
  lc->blockDim = dim3(threads, 1, 1);
  lc->attrs = attr;
  lc->numAttrs = 1;
  auto configure = [&](int C) {
    size_t smem = 0;
    *g = cfg_for(C, budget, smem);
    if (smem > budget) return cudaErrorInvalidValue;
    attr->val.clusterDim.x = C;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    lc->gridDim = dim3((unsigned)(E * C), 1, 1);
    lc->dynamicSmemBytes = smem;
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  };
  size_t probe = 0;
  const int cap = cluster_cap(E, sms);
  int C = !cfg_for(1, budget, probe).rep ? 1 : cap < c_max ? cap : c_max;
  for (; C > 1; C /= 2) {
    err = configure(C);
    if (err != cudaSuccess) return err;
    int n_act = 0;
    err = cudaOccupancyMaxActiveClusters(&n_act, kern, lc);
    if (err != cudaSuccess) return err;
    if (n_act >= E) break;
  }
  if (C == 1) {
    err = configure(1);
    if (err != cudaSuccess) return err;
  }
  *chosen = C;
  return cudaSuccess;
}

// Host: launch kern(cfg, args...) as E clusters of the size
// choose_cluster picks (at most c_max) on `stream`. Returns a cudaError_t
// (a refused launch is reported, never replaced); *chosen receives C.
template <typename Kern, typename CfgFor, typename... Args>
__host__ int launch_clusters(Kern kern, int E, int threads, CfgFor cfg_for,
                             int c_max, cudaStream_t stream, int* chosen,
                             Args... args) {
  cudaLaunchConfig_t lc;
  cudaLaunchAttribute attr;
  ClusterCfg g;
  cudaError_t err = choose_cluster(kern, E, threads, cfg_for, c_max, &lc,
                                   &attr, &g, chosen);
  if (err != cudaSuccess) return (int)err;
  lc.stream = stream;
  err = cudaLaunchKernelEx(&lc, kern, g, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace nt
