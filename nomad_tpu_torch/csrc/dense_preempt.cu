// Dense greedy placement with eviction for NVIDIA Hopper (sm_90a).
//
// Replaces nomad_tpu/solver/binpack.py::_solve_placements_preempt_impl
// (with _score_and_select_preempt, _preempt_search and
// _preempt_search_core in its while-loop form, and _commit_tables), the
// XLA program jitted by _make_fused_fn(preempt=True) and vmapped over the
// E lanes of a fused dispatch (solve_eval_batch_preempt).
//
// Design: the dense scan's (dense_scan.cu): one thread block per lane,
// 16 warps, the whole P-step scan in one launch, the lane's NodeState,
// evicted mask (N, A) and group counts (G,) in global memory, updated in
// place, and each step's tiled window walk (dense_common.cuh
// window_walk), which still stops at the limit-th counted option: a
// preempting node is one more option in window order. Per node, a thread
// checks the fit that no eviction can rescue, then the resource fit;
// a node that fails only the latter runs the eviction search over its A
// candidates (preempt_common.cuh, one thread per node, candidate sets as
// 64-bit masks), the fit2 recheck, and scores its post-eviction binpack
// plus the logistic preemption term. After the arg-best, thread 0
// rescores the winner (its inputs have not changed), whose one search
// gives the eviction row and freed resources, and commits: usage less the
// freed resources, ports released, the spread / distinct_property /
// device tables, the evicted mask and the per-group counts. As in the
// reference, the freed resources come off the winner's usage whenever
// the window chose a preempting node, active step or not.
//
// Bound: like the dense scan, a lane's P steps form one dependency
// chain; a step's work is the search over the nodes the walk scores
// before the window closes, each up to A rounds of A distance
// evaluations by one thread, so the kernel is latency-bound on the step
// chain and, within a step, on the longest search of a warp.
#include "dense_common.cuh"
#include "preempt_common.cuh"

namespace {

using namespace nt;

// PreemptTables, PreemptState and the evict_rows output (solver/preempt.py
// PREEMPT_ARGS order).
template <typename T> struct PreemptArgs {
  const T *cpu, *mem, *disk;                   // (E, N, A)
  const int *prio, *maxp, *grp, *dyn_ports;    // (E, N, A)
  const u8 *static_rel, *valid;                // (E, N, A)
  const int* job_prio;                         // (E,)
  u8* evicted;                                 // (E, N, A), in place
  int* counts;                                 // (E, G), in place
  u8* evict_rows;                              // (E, P, A)
  int A, G;
};

template <typename T>
__device__ __forceinline__ CandRow<T> cand_row(const PreemptArgs<T>& Q,
                                               size_t row) {
  CandRow<T> c;
  const size_t b = row * Q.A;
  c.cpu = Q.cpu + b; c.mem = Q.mem + b; c.disk = Q.disk + b;
  c.prio = Q.prio + b; c.maxp = Q.maxp + b; c.grp = Q.grp + b;
  return c;
}

// The search of node n (lane e) against the current evicted mask.
template <typename T>
__device__ __forceinline__ SearchRes<T> node_search(
    const DenseArgs<T>& A, const PreemptArgs<T>& Q, const Off& o, int e,
    const Ask<T>& a, int n) {
  const size_t k = o.n + n, b = k * Q.A;
  const int jp = Q.job_prio[e];
  u64 valid_now = 0, eligible = 0;
  for (int c = 0; c < Q.A; ++c) {
    if (Q.valid[b + c] && !Q.evicted[b + c]) {
      valid_now |= bit(c);
      if (jp - Q.prio[b + c] >= 10) eligible |= bit(c);
    }
  }
  return preempt_search<T>(cand_row<T>(Q, k), Q.A, valid_now, eligible,
                           A.cpu_cap[k], A.mem_cap[k], A.disk_cap[k],
                           Q.counts + (size_t)e * Q.G, a.cpu, a.mem,
                           a.disk);
}

// Option status of node n and its final score when it is an option:
// plain fit, or fit once the search's evictions free enough
// (_score_and_select_preempt). pre tells which; when it is set, r holds
// the search.
template <typename T>
__device__ __forceinline__ bool score_node_preempt(
    const DenseArgs<T>& A, const PreemptArgs<T>& Q, const Off& o, int e,
    const Ask<T>& a, int n, const SpreadStats<T>& st, T& final,
    bool& pre, SearchRes<T>& r) {
  T dev_score;
  bool dev_present;
  pre = false;
  if (!node_feasible<T>(A, o, e, a, n, dev_score, dev_present))
    return false;
  const size_t k = o.n + n;
  const T eff_cpu = node_eff_cpu<T>(A, o, a, n);
  const T ucpu = A.used_cpu[k], umem = A.used_mem[k], udisk = A.used_disk[k];
  const T ccap = A.cpu_cap[k], mcap = A.mem_cap[k], dcap = A.disk_cap[k];
  const bool salg = A.spread_alg != 0;
  if (fits_resources<T>(ucpu, umem, udisk, ccap, mcap, dcap, eff_cpu, a.mem,
                        a.disk)) {
    const T bp = binpack_after<T>(ucpu, umem, ccap, mcap, eff_cpu, a.mem,
                                  salg);
    T other, nscores;
    node_terms<T>(A, o, e, a, n, st, dev_score, dev_present, other,
                  nscores);
    final = final_score<T>(bp, other, nscores);
    return true;
  }
  r = node_search<T>(A, Q, o, e, a, n);
  if (!r.met) return false;
  const T new_c = ucpu + eff_cpu, new_m = umem + a.mem, new_d = udisk + a.disk;
  // fit2: the full-usage recheck after the evictions (rank.go:541)
  if (!(new_c - r.freed_c <= ccap && new_m - r.freed_m <= mcap &&
        new_d - r.freed_d <= dcap))
    return false;
  const T free_c = T(1) - (new_c - r.freed_c) / vmax(ccap, T(1e-9));
  const T free_m = T(1) - (new_m - r.freed_m) / vmax(mcap, T(1e-9));
  T other, nscores;
  node_terms<T>(A, o, e, a, n, st, dev_score, dev_present, other, nscores);
  final = preempt_final<T>(binpack_raw<T>(free_c, free_m, salg), other,
                           preempt_score<T>(r.net_prio), nscores);
  pre = true;
  return true;
}

template <typename T, int NW>
__global__ void __launch_bounds__(32 * NW)
dense_preempt_kernel(const DenseArgs<T> A, const PreemptArgs<T> Q) {
  const int e = blockIdx.x, tid = threadIdx.x;
  const Off o = lane_off(e, A.N, A.P, A.S, A.V, A.Dp, A.Vd, A.R, A.Gd);
  __shared__ WalkShared<T, NW> sh;
  extern __shared__ __align__(16) unsigned char smem[];
  const SpreadStats<T> st = spread_stats_init<T>(A, o, e, smem);

  for (int i = 0; i < A.P; ++i) {
    const size_t ip = o.p + i;
    const Ask<T> a = load_ask<T>(A, ip);
    spread_stats_step<T>(A, o, st);
    __syncthreads();
    int ny;
    const Key<T> win = window_walk<T, NW>(
        A.N, a.limit,
        [&](int n, T& fin) {
          bool pre;
          SearchRes<T> r;
          return score_node_preempt<T>(A, Q, o, e, a, n, st, fin, pre, r);
        },
        sh, ny);
    if (tid == 0) {
      const bool any_yield = ny > 0;
      const bool doit = a.active && any_yield;
      A.chosen[ip] = doit ? win.idx : -1;
      A.scores[ip] = any_yield ? win.eff : neg_inf<T>();
      A.n_yielded[ip] = ny;
      u64 row = 0;
      if (any_yield) {
        const int w = win.idx;
        const size_t k = o.n + w, b = k * Q.A;
        // was the winner a preempting option? (its state is unchanged)
        T fin;
        bool pre;
        SearchRes<T> r;
        score_node_preempt<T>(A, Q, o, e, a, w, st, fin, pre, r);
        T fc = T(0), fm = T(0), fd = T(0);
        if (pre) {
          fc = r.freed_c;
          fm = r.freed_m;
          fd = r.freed_d;
          if (doit) row = r.evict;
        }
        const T add_f = doit ? T(1) : T(0);
        const int add_i = doit ? 1 : 0;
        int dyn_back = 0;
        bool static_back = false;
        for (int c = 0; c < Q.A; ++c)
          if (row & bit(c)) {
            dyn_back += Q.dyn_ports[b + c];
            static_back = static_back || Q.static_rel[b + c];
          }
        A.used_cpu[k] = A.used_cpu[k] + (add_f * a.cpu - fc);
        A.used_mem[k] = A.used_mem[k] + (add_f * a.mem - fm);
        A.used_disk[k] = A.used_disk[k] + (add_f * a.disk - fd);
        A.placed[k] += add_i;
        A.placed_job[k] += add_i;
        A.static_free[k] = (A.static_free[k] || static_back) &&
                           !(doit && a.has_static);
        A.dyn_avail[k] += dyn_back - add_i * a.n_dyn;
        if (doit) commit_tables<T>(A, o, w);
        int* cnt = Q.counts + (size_t)e * Q.G;
        for (int c = 0; c < Q.A; ++c)
          if (row & bit(c)) {
            Q.evicted[b + c] = 1;
            if (Q.grp[b + c] >= 0) cnt[Q.grp[b + c]] += 1;
          }
      }
      u8* out = Q.evict_rows + ip * Q.A;
      for (int c = 0; c < Q.A; ++c) out[c] = (row >> c) & 1;
    }
    __syncthreads();
  }
}

constexpr int kPreemptTables = 12;   // PREEMPT_ARGS in solver/preempt.py
constexpr int kOutputs = 4;          // chosen, scores, n_yielded, evict_rows

template <typename T>
int launch(void* const* p, int n_ptrs, const int* d, int n_dims,
           cudaStream_t stream) {
  if (n_ptrs != kDenseTables + kPreemptTables + kOutputs ||
      n_dims != kDenseDims + 2)
    return (int)cudaErrorInvalidValue;
  DenseArgs<T> a;
  PreemptArgs<T> q;
  int k = 0;
  unpack_dense<T>(a, p, k, d);
  q.cpu = (const T*)p[k++]; q.mem = (const T*)p[k++];
  q.disk = (const T*)p[k++]; q.prio = (const int*)p[k++];
  q.maxp = (const int*)p[k++]; q.grp = (const int*)p[k++];
  q.dyn_ports = (const int*)p[k++]; q.static_rel = (const u8*)p[k++];
  q.valid = (const u8*)p[k++]; q.job_prio = (const int*)p[k++];
  q.evicted = (u8*)p[k++]; q.counts = (int*)p[k++];
  a.chosen = (long long*)p[k++]; a.scores = (T*)p[k++];
  a.n_yielded = (long long*)p[k++]; q.evict_rows = (u8*)p[k++];
  q.A = d[kDenseDims];
  q.G = d[kDenseDims + 1];
  if (a.E <= 0 || a.P <= 0) return 0;
  if (a.N <= 0 || a.N > (1 << 30) / 2 || q.A < 1 || q.A > kMaxA ||
      q.G < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = spread_stats_bytes<T>(a.S);
  auto kern = dense_preempt_kernel<T, kDenseWarps>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<a.E, 32 * kDenseWarps, smem, stream>>>(a, q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nt_dense_preempt_f32(void* const* ptrs, int n_ptrs,
                                    const int* dims, int n_dims,
                                    void* stream) {
  return launch<float>(ptrs, n_ptrs, dims, n_dims, (cudaStream_t)stream);
}

extern "C" int nt_dense_preempt_f64(void* const* ptrs, int n_ptrs,
                                    const int* dims, int n_dims,
                                    void* stream) {
  return launch<double>(ptrs, n_ptrs, dims, n_dims, (cudaStream_t)stream);
}
