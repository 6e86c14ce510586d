// Dense greedy placement scan for NVIDIA Hopper (sm_90a).
//
// Replaces nomad_tpu/solver/binpack.py::_solve_placements_impl (with
// _scoring_parts, _select_window, _window_outputs, _spread_score and
// _commit_tables), the XLA program jitted by _make_fused_fn and vmapped
// over the E lanes of a fused dispatch.
//
// Design: one thread block per lane (grid = E), 16 warps; the whole
// P-step scan runs inside one launch. The lane's mutable NodeState lives
// in the caller's (E, ...) state tensors in global memory (at N = 16,384
// it is ~0.7 MB in float64, more than shared memory holds) and is
// updated in place; the per-spread count statistics and the step's (at
// most MAX_SKIP) skipped options live in shared memory. Each step walks
// the node axis in shuffled order, one tile of 2,048 nodes at a time
// (warp w owns four 32-node chunks of the tile, one node per lane,
// coalesced):
//   1. every thread scores its four nodes: fit (resources, ports,
//      distinct_hosts, distinct_property, devices, cores) and, for fit
//      nodes, the final score, kept in registers; the warp counts fit and
//      low nodes with ballots;
//   2. one block scan over the warps' packed (low, fit) counts gives each
//      warp its offsets: with skip_rank = cumsum(low), cumsum(skipped) =
//      min(skip_rank, MAX_SKIP) and cumsum(counted) = cumsum(fit) -
//      cumsum(skipped), this one scan stands for the reference's three
//      (skip_rank, cpos, srank), ranks 1-based as there;
//   3. each node's rank within its chunk (ballot + popc) marks the
//      counted options inside the window (cpos <= limit); the thread
//      keeps its best (score, window order) and the skipped options go
//      to shared memory by skip rank;
//   once `limit` options are counted, no later node can enter the window
//   or be needed as fallback (the argument of the reference's FAST_T
//   shortcut, for any prefix), so the walk stops there. Then thread 0
//   adds the skipped options the deficit calls for (order limit +
//   srank), one block arg-best picks the winner (ties to the smallest
//   order), and thread 0 writes the step's outputs and commits the
//   winner: usage, placed counts, ports, cores, spread and
//   distinct_property counts, the device group with the first-max
//   affinity. A barrier closes the step. n_yielded needs no reduction:
//   min(counted, limit) + min(deficit, skipped) from the scans' totals.
//
// Bound: a lane's P steps form one dependency chain of ~6 block barriers
// each plus the tiles the window needs; the bytes the function must move
// once (the tables in, the outputs and final state out) take tens of
// microseconds at 3.35 TB/s, and the operations the window needs less,
// so the kernel is latency-bound on the step chain.
#include "dense_common.cuh"

#include <climits>

namespace {

using namespace nt;

typedef unsigned char u8;
typedef unsigned long long u64;

constexpr int kWarps = 16;      // 512 threads per lane
constexpr int kChunks = 4;      // 32-node chunks per warp per tile

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

// One step's asks (PlacementBatch row i).
template <typename T> struct Ask {
  T cpu, mem, disk, count;
  int n_dyn, limit, penalty, cores;
  bool has_static, active;
};

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

// Fit of node n, and its final score when it fits (dense _scoring_parts).
template <typename T>
__device__ __forceinline__ bool score_node(const DenseArgs<T>& A,
                                           const Off& o, int e,
                                           const Ask<T>& a, int n,
                                           const int* smin, const int* smax,
                                           const int* sany, const T* wfrac,
                                           T& final) {
  const size_t N = A.N, k = o.n + n;
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
  const bool has_cores = A.has_cores != 0;
  if (has_cores && A.cores_free[k] < a.cores) return false;
  T dev_score = T(0);
  bool dev_present = false;
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
  const T eff_cpu = eff_cpu_ask<T>(
      a.cpu, a.cores, has_cores ? A.mhz_per_core[k] : T(0), has_cores);
  const T ucpu = A.used_cpu[k], umem = A.used_mem[k];
  const T ccap = A.cpu_cap[k], mcap = A.mem_cap[k];
  if (!fits_resources<T>(ucpu, umem, A.used_disk[k], ccap, mcap,
                         A.disk_cap[k], eff_cpu, a.mem, a.disk))
    return false;
  const T bp = binpack_after<T>(ucpu, umem, ccap, mcap, eff_cpu, a.mem,
                                A.spread_alg != 0);
  T spread = T(0);
  for (int s = 0; s < A.S; ++s) {
    const int vi = A.spread_vidx[o.sn + s * N + n];
    const int cur = vi < 0 ? 0 : A.spread_counts[o.sv + s * A.V + vi];
    const T des = vi < 0 ? T(0) : A.spread_desired[o.sv + s * A.V + vi];
    spread = spread + spread_boost<T>(vi, cur, des,
                                      A.spread_has_targets[o.s + s] != 0,
                                      wfrac[s], smin[s], smax[s],
                                      sany[s] != 0);
  }
  const T aff = A.has_affinity[e] ? A.affinity[k] : T(0);
  final = dense_score<T>(bp, (T)A.placed[k], a.count, n == a.penalty, aff,
                         spread, A.R > 0, dev_score, dev_present);
  return true;
}

// Thread 0 commits lane winner w (the reference step's scatter updates
// and _commit_tables).
template <typename T>
__device__ __forceinline__ void commit(const DenseArgs<T>& A, const Off& o,
                                       const Ask<T>& a, int w) {
  const size_t N = A.N, k = o.n + w;
  const bool has_cores = A.has_cores != 0;
  A.used_cpu[k] = A.used_cpu[k] +
                  eff_cpu_ask<T>(a.cpu, a.cores,
                                 has_cores ? A.mhz_per_core[k] : T(0),
                                 has_cores);
  A.used_mem[k] = A.used_mem[k] + a.mem;
  A.used_disk[k] = A.used_disk[k] + a.disk;
  A.placed[k] += 1;
  A.placed_job[k] += 1;
  if (a.has_static) A.static_free[k] = 0;
  A.dyn_avail[k] -= a.n_dyn;
  if (has_cores) A.cores_free[k] -= a.cores;
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

template <typename T, int NW>
__global__ void __launch_bounds__(32 * NW)
dense_scan_kernel(const DenseArgs<T> A) {
  constexpr int TILE = 32 * NW * kChunks;
  const int e = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const Off o = lane_off(e, A.N, A.P, A.S, A.V, A.Dp, A.Vd, A.R, A.Gd);
  const int N = A.N, S = A.S;
  const unsigned le_mask = 0xffffffffu >> (31 - lane);   // lanes <= me

  __shared__ u64 wsum[NW];
  __shared__ Key<T> red[NW];
  // the step's skipped options by skip rank (at most MAX_SKIP)
  __shared__ T skip_eff[kMaxSkip];
  __shared__ int skip_idx[kMaxSkip];
  // dynamic: wfrac (S T), then smin / smax / sany (S int each)
  extern __shared__ __align__(16) unsigned char smem[];
  T* wfrac = reinterpret_cast<T*>(smem);
  int* smin = reinterpret_cast<int*>(wfrac + S);
  int* smax = smin + S;
  int* sany = smax + S;
  for (int s = tid; s < S; s += 32 * NW)
    wfrac[s] = A.spread_weights[o.s + s] /
               vmax(A.spread_sum_weights[e], T(1e-9));

  for (int i = 0; i < A.P; ++i) {
    const size_t ip = o.p + i;
    Ask<T> a;
    a.cpu = A.ask_cpu[ip]; a.mem = A.ask_mem[ip]; a.disk = A.ask_disk[ip];
    a.count = (T)A.count[ip];
    a.n_dyn = A.n_dyn[ip]; a.limit = A.limit[ip];
    a.penalty = A.penalty[ip];
    a.cores = A.has_cores ? A.ask_cores[ip] : 0;
    a.has_static = A.has_static[ip] != 0;
    a.active = A.active[ip] != 0;
    const int L = a.limit;
    // even-spread statistics over present (count > 0) values
    for (int s = tid; s < S; s += 32 * NW) {
      int mn = INT_MAX, mx = 0, any = 0;
      for (int v = 0; v < A.V; ++v) {
        const int c = A.spread_counts[o.sv + s * A.V + v];
        if (c > 0) {
          any = 1;
          mn = min(mn, c);
          mx = max(mx, c);
        }
      }
      smin[s] = mn;
      smax[s] = mx;
      sany[s] = any;
    }
    __syncthreads();

    Key<T> best;
    best.eff = neg_inf<T>();
    best.order = INT_MAX;
    best.idx = INT_MAX;
    best.y = 0;
    int fit_base = 0, low_base = 0;     // counts over the tiles before
    for (int base = 0; base < N; base += TILE) {
      // 1. fit, score and low of the thread's nodes in this tile
      const int seg = base + warp * kChunks * 32;
      T fin[kChunks];
      unsigned fm[kChunks], lm[kChunks];
      unsigned wfit = 0, wlow = 0;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int n = seg + c * 32 + lane;
        bool fit = false, low = false;
        fin[c] = T(0);
        if (n < N) {
          fit = score_node<T>(A, o, e, a, n, smin, smax, sany, wfrac,
                              fin[c]);
          low = fit && fin[c] <= T(0);
        }
        fm[c] = __ballot_sync(kFull, fit);
        lm[c] = __ballot_sync(kFull, low);
        wfit += __popc(fm[c]);
        wlow += __popc(lm[c]);
      }
      // 2. block scan of the warps' packed (low, fit) counts
      const u64 mine = lane == 0 ? ((u64)wlow << 32) | wfit : 0;
      u64 total;
      const u64 incl = block_scan<NW, u64>(mine, total, wsum);
      const u64 excl = __shfl_sync(kFull, incl - mine, 0);
      int fit_off = fit_base + (int)(excl & 0xffffffffu);
      int low_off = low_base + (int)(excl >> 32);
      // 3. window ranks; the thread's best counted option in the window,
      // the skipped options kept by skip rank for the fallback
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
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
          skip_eff[srank - 1] = fin[c];
          skip_idx[srank - 1] = n;
        }
        fit_off += __popc(fm[c]);
        low_off += __popc(lm[c]);
      }
      fit_base += (int)(total & 0xffffffffu);
      low_base += (int)(total >> 32);
      // once `limit` options are counted, later nodes can neither enter
      // the window nor be needed as fallback (the reference's FAST_T
      // argument, for any prefix)
      if (fit_base - min(low_base, kMaxSkip) >= L) break;
    }
    __syncthreads();                    // skip_eff / skip_idx complete
    const int tot_skipped = min(low_base, kMaxSkip);
    const int tot_counted = fit_base - tot_skipped;
    const int deficit = max(0, L - min(tot_counted, L));
    if (tid == 0) {
      // fallback: skipped options in skip order, for the deficit
      for (int r = 1; r <= min(deficit, tot_skipped); ++r) {
        Key<T> k;
        k.eff = skip_eff[r - 1];
        k.order = L + r;
        k.idx = skip_idx[r - 1];
        k.y = 1;
        if (better(k, best)) best = k;
      }
    }
    const Key<T> win = block_best<T, NW>(best, red);
    // 4. outputs and the commit
    if (tid == 0) {
      const int ny = min(tot_counted, L) + min(deficit, tot_skipped);
      const bool any_yield = ny > 0;
      const bool doit = a.active && any_yield;
      A.chosen[ip] = doit ? win.idx : -1;
      A.scores[ip] = any_yield ? win.eff : neg_inf<T>();
      A.n_yielded[ip] = ny;
      if (doit) commit<T>(A, o, a, win.idx);
    }
    __syncthreads();
  }
}

constexpr int kTables = 40;     // DENSE_ARGS in solver/dense.py
constexpr int kOutputs = 3;     // chosen, scores, n_yielded
constexpr int kDims = 11;       // E N P S V Dp Vd R Gd has_cores spread_alg

template <typename T>
int launch(void* const* p, int n_ptrs, const int* d, int n_dims,
           cudaStream_t stream) {
  if (n_ptrs != kTables + kOutputs || n_dims != kDims)
    return (int)cudaErrorInvalidValue;
  DenseArgs<T> a;
  int k = 0;
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
  a.chosen = (long long*)p[k++]; a.scores = (T*)p[k++];
  a.n_yielded = (long long*)p[k++];
  a.E = d[0]; a.N = d[1]; a.P = d[2]; a.S = d[3]; a.V = d[4];
  a.Dp = d[5]; a.Vd = d[6]; a.R = d[7]; a.Gd = d[8];
  a.has_cores = d[9]; a.spread_alg = d[10];
  if (a.E <= 0 || a.P <= 0) return 0;
  if (a.N <= 0 || a.N > (1 << 30) / 2) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)a.S * (sizeof(T) + 3 * sizeof(int));
  auto kern = dense_scan_kernel<T, kWarps>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<a.E, 32 * kWarps, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nt_dense_scan_f32(void* const* ptrs, int n_ptrs,
                                 const int* dims, int n_dims, void* stream) {
  return launch<float>(ptrs, n_ptrs, dims, n_dims, (cudaStream_t)stream);
}

extern "C" int nt_dense_scan_f64(void* const* ptrs, int n_ptrs,
                                 const int* dims, int n_dims, void* stream) {
  return launch<double>(ptrs, n_ptrs, dims, n_dims, (cudaStream_t)stream);
}
