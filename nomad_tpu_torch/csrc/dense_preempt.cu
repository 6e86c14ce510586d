// Dense greedy placement with eviction for NVIDIA Hopper (sm_90a).
//
// Replaces nomad_tpu/solver/binpack.py::_solve_placements_preempt_impl
// (with _score_and_select_preempt, _preempt_search and
// _preempt_search_core in its while-loop form, and _commit_tables), the
// XLA program jitted by _make_fused_fn(preempt=True) and vmapped over the
// E lanes of a fused dispatch (solve_eval_batch_preempt).
//
// Design: the dense scan's (dense_scan.cu): one thread-block cluster of
// C blocks per lane (16 at the tier-5 group's E = 8 in float32: with
// W = 16 a block is held to 64 registers a thread, two fit on an SM, and
// clusters of 16 are resident; 8 in float64), the whole P-step scan in
// one launch, each step a cluster walk (dense_common.cuh) that stops at
// the round in which the limit-th option is counted: a preempting node
// is one more option in window order. Where C >= 8, a node is scored by
// a group of W lanes (W = 16 for A <= 16, else 32), so a block owns 32
// or 16 nodes of each tile (512 nodes a tile at C = 16; the tier-5
// window closes after ~500). The group loads the node's candidates,
// coalesced, while its first lane checks the fit that no eviction can
// rescue, then the resource fit; a node that fails only the latter runs
// the eviction search shared by the group (preempt_common.cuh
// preempt_search_group: one lane per candidate in each greedy round,
// shuffle arg-min), the fit2 recheck, and scores its post-eviction
// binpack plus the logistic preemption term. On smaller clusters (many
// lanes, so few SMs each) every thread scores and searches its own node
// (W = 1, preempt_search), 512 nodes a block a tile: a walk that does not
// close early is bound by issue slots there, and the one-thread search
// spends ~5x fewer. The search's eviction row and freed resources ride
// with the option's Key through the walk, so the winner's commit needs
// no second search: the owning block takes the freed resources off the
// winner's usage, releases ports, commits devices and the evicted mask;
// every block applies the winner's spread / distinct_property values and
// the evicted candidates' groups to its replica of the lane's count
// tables. As in the reference, the freed resources come off the winner's
// usage whenever the window chose a preempting node, active step or not.
//
// Shared memory per block: the walk's exchange slots (static: 1,952 B in
// float32, 2,816 B in float64), the spread tables, the replicated
// spread, distinct_property and group (G,) counts (64 KB at the tier-5
// group's G = 16,384), and where they fit the block's nodes' cpu/mem/disk
// caps and usage (24 / 48 B a node in float32 / float64). The candidate
// tables (E, N, A), the evicted mask and every other node column stay in
// global memory.
//
// Bound: the step chain, as for the dense scan. A round costs the
// longest search among the cluster's groups or threads (with W lanes: a
// few greedy rounds of A parallel distance evaluations and shuffle
// reductions, and the candidate-order sums) plus the cluster barrier.
#include "dense_common.cuh"
#include "preempt_common.cuh"

namespace {

using namespace nt;

constexpr int kWarps = 16;          // 512 threads a block
// the smallest cluster whose SMs make up for the group search's cost in
// issue slots; below it each thread searches its own node
constexpr int kGroupSearchCluster = 8;

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

// What a preempting option carries through the walk.
template <typename T> struct PreX {
  u64 evict;
  T fc, fm, fd;
  int pre;
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

// A node's usage and caps as the block holds them, the columns its score
// terms read, its device score and effective cpu ask.
template <typename T> struct NodeFit {
  T ucpu, umem, udisk, ccap, mcap, dcap, eff_cpu, dev_score;
  NodePre<T> p;
  bool dev_present;
};

template <typename T>
__device__ __forceinline__ NodeFit<T> node_fit(const DenseArgs<T>& A,
                                               const Off& o, int e,
                                               const Ask<T>& a,
                                               const LaneView<T>& v,
                                               const ClusterCfg& g, int n) {
  NodeFit<T> f;
  const int ci = col_at<T>(v, g, n);
  f.ucpu = v.ucpu[ci]; f.umem = v.umem[ci]; f.udisk = v.udisk[ci];
  f.ccap = v.ccap[ci]; f.mcap = v.mcap[ci]; f.dcap = v.dcap[ci];
  f.p = node_pre<T>(A, o, e, n);
  f.eff_cpu = eff_cpu_ask<T>(a.cpu, a.cores, f.p.mhz, A.has_cores != 0);
  return f;
}

template <typename T>
__device__ __forceinline__ bool fits_plain(const Ask<T>& a,
                                           const NodeFit<T>& f) {
  return fits_resources<T>(f.ucpu, f.umem, f.udisk, f.ccap, f.mcap, f.dcap,
                           f.eff_cpu, a.mem, a.disk);
}

// The final score of a node that fits without evictions.
template <typename T>
__device__ __forceinline__ T plain_score(const DenseArgs<T>& A, const Off& o,
                                         int e, const Ask<T>& a, int n,
                                         const LaneView<T>& v,
                                         const NodeFit<T>& f) {
  const T bp = binpack_after<T>(f.ucpu, f.umem, f.ccap, f.mcap, f.eff_cpu,
                                a.mem, A.spread_alg != 0);
  T other, nscores;
  node_terms<T>(A, o, e, a, n, v.st, f.p, f.dev_score, f.dev_present, other,
                nscores);
  return final_score<T>(bp, other, nscores);
}

// A node whose search r covers the ask: an option if the fit2 recheck
// holds, with its preempting score and payload (_score_and_select_preempt).
template <typename T>
__device__ __forceinline__ void preempt_option(
    const DenseArgs<T>& A, const Off& o, int e, const Ask<T>& a, int n,
    const LaneView<T>& v, const NodeFit<T>& f, const SearchRes<T>& r,
    bool& fit, T& final, PreX<T>& x) {
  const T new_c = f.ucpu + f.eff_cpu, new_m = f.umem + a.mem,
          new_d = f.udisk + a.disk;
  // fit2: the full-usage recheck after the evictions (rank.go:541)
  if (!(new_c - r.freed_c <= f.ccap && new_m - r.freed_m <= f.mcap &&
        new_d - r.freed_d <= f.dcap))
    return;
  const T free_c = T(1) - (new_c - r.freed_c) / vmax(f.ccap, T(1e-9));
  const T free_m = T(1) - (new_m - r.freed_m) / vmax(f.mcap, T(1e-9));
  T other, nscores;
  node_terms<T>(A, o, e, a, n, v.st, f.p, f.dev_score, f.dev_present, other,
                nscores);
  final = preempt_final<T>(binpack_raw<T>(free_c, free_m, A.spread_alg != 0),
                           other, preempt_score<T>(r.net_prio), nscores);
  fit = true;
  x.evict = r.evict;
  x.fc = r.freed_c;
  x.fm = r.freed_m;
  x.fd = r.freed_d;
  x.pre = 1;
}

// Option status of node n, scored by the W-lane group of the calling
// thread: plain fit, or fit once the search's evictions free enough.
// Every lane of the group calls it; the group's first lane gets fit, the
// final score and the payload.
template <typename T, int W>
__device__ __forceinline__ void score_group(
    const DenseArgs<T>& A, const PreemptArgs<T>& Q, const Off& o, int e,
    const Ask<T>& a, const LaneView<T>& v, const ClusterCfg& g, int n,
    bool& fit, T& final, PreX<T>& x) {
  const bool lead = (threadIdx.x & (W - 1)) == 0;
  const size_t k = o.n + n, b = k * Q.A;
  // the group loads the node's candidates while its first lane checks
  // the node (most nodes of a full fleet need the search)
  const CandRegs<T, W> cr = load_cands<T, W>(
      cand_row<T>(Q, k), Q.A, Q.valid + b, Q.evicted + b, Q.job_prio[e],
      v.gc);
  NodeFit<T> f = node_fit<T>(A, o, e, a, v, g, n);
  int status = 0;                       // 0 none, 1 plain fit, 2 search
  if (lead && node_feasible<T>(A, o, e, a, n, v.dpc, f.dev_score,
                               f.dev_present)) {
    if (fits_plain<T>(a, f)) {
      final = plain_score<T>(A, o, e, a, n, v, f);
      fit = true;
    } else {
      status = 2;
    }
  }
  status = __shfl_sync(group_mask<W>(), status, 0, W);
  if (status != 2) return;
  const SearchRes<T> r = preempt_search_group<T, W>(
      cr, Q.A, f.ccap, f.mcap, f.dcap, a.cpu, a.mem, a.disk);
  if (lead && r.met) preempt_option<T>(A, o, e, a, n, v, f, r, fit, final, x);
}

// score_group for a group of one thread (W = 1): the node's search runs
// on its thread (preempt_common.cuh preempt_search).
template <typename T>
__device__ __forceinline__ void score_one(
    const DenseArgs<T>& A, const PreemptArgs<T>& Q, const Off& o, int e,
    const Ask<T>& a, const LaneView<T>& v, const ClusterCfg& g, int n,
    bool& fit, T& final, PreX<T>& x) {
  const size_t k = o.n + n, b = k * Q.A;
  NodeFit<T> f = node_fit<T>(A, o, e, a, v, g, n);
  if (!node_feasible<T>(A, o, e, a, n, v.dpc, f.dev_score, f.dev_present))
    return;
  if (fits_plain<T>(a, f)) {
    final = plain_score<T>(A, o, e, a, n, v, f);
    fit = true;
    return;
  }
  const int jp = Q.job_prio[e];
  u64 valid_now = 0, eligible = 0;
  for (int c = 0; c < Q.A; ++c) {
    if (Q.valid[b + c] && !Q.evicted[b + c]) {
      valid_now |= bit(c);
      if (jp - Q.prio[b + c] >= 10) eligible |= bit(c);
    }
  }
  const SearchRes<T> r = preempt_search<T>(
      cand_row<T>(Q, k), Q.A, valid_now, eligible, f.ccap, f.mcap, f.dcap,
      v.gc, a.cpu, a.mem, a.disk);
  if (r.met) preempt_option<T>(A, o, e, a, n, v, f, r, fit, final, x);
}

// W lanes score a node: 16 or 32 share its search (score_group), 1
// searches alone (score_one).
template <typename T, int NW, int W>
__global__ void __launch_bounds__(32 * NW, W == 16 ? 2 : 1)
dense_preempt_kernel(const ClusterCfg g, const DenseArgs<T> A,
                     const PreemptArgs<T> Q) {
  const int c = (int)cg::this_cluster().block_rank();
  const int e = blockIdx.x / g.C, tid = threadIdx.x;
  const Off o = lane_off(e, A.N, A.P, A.S, A.V, A.Dp, A.Vd, A.R, A.Gd);
  int* gcounts = Q.counts + (size_t)e * Q.G;
  __shared__ ClusterShared<T, PreX<T>, NW, 1> sh;
  extern __shared__ __align__(16) unsigned char smem[];
  const LaneView<T> v = lane_view<T>(A, o, e, g, c, gcounts, Q.G, smem);
  unsigned round = 0;
  NT_T0();
  NT_CNT(6, 0ull - clock64());

  for (int i = 0; i < A.P; ++i) {
    const size_t ip = o.p + i;
    const Ask<T> a = load_ask<T>(A, ip);
    int ny;
    PreX<T> x;                          // the payload of my node
    const Rec<T, PreX<T>> win = cluster_walk<T, PreX<T>, NW, 1>(
        g, c, A.N, a.limit,
        [&](int n0, int, int& n, bool& fit, T& fin) {
          const int m = n0 + tid / W;   // the group's node
          n = tid % W == 0 ? m : INT_MAX;
          x = PreX<T>();
          if (m >= A.N) return;
          if constexpr (W == 1)
            score_one<T>(A, Q, o, e, a, v, g, m, fit, fin, x);
          else
            score_group<T, W>(A, Q, o, e, a, v, g, m, fit, fin, x);
        },
        [&](int) { return x; }, sh, ny, round);
    NT_RESET();
    const bool any_yield = ny > 0;
    const bool doit = a.active && any_yield;
    const int w = win.k.idx;
    const bool pre = any_yield && win.x.pre;
    const u64 row = pre && doit ? win.x.evict : 0;
    if (c == 0) {
      if (tid == 0) {
        A.chosen[ip] = doit ? w : -1;
        A.scores[ip] = any_yield ? win.k.eff : neg_inf<T>();
        A.n_yielded[ip] = ny;
      }
      for (int q = tid; q < Q.A; q += blockDim.x)
        Q.evict_rows[ip * Q.A + q] = (row >> q) & 1;
    }
    if (any_yield && tid == 0 && (w / g.sub) % g.C == c) {
      // the owning block: usage less the freed resources, ports, devices
      // and the evicted mask at the winner
      const size_t k = o.n + w, b = k * Q.A;
      const int ci = col_at<T>(v, g, w);
      const T fc = pre ? win.x.fc : T(0), fm = pre ? win.x.fm : T(0),
              fd = pre ? win.x.fd : T(0);
      const T add_f = doit ? T(1) : T(0);
      const int add_i = doit ? 1 : 0;
      int dyn_back = 0;
      bool static_back = false;
      for (int q = 0; q < Q.A; ++q)
        if (row & bit(q)) {
          dyn_back += Q.dyn_ports[b + q];
          static_back = static_back || Q.static_rel[b + q];
        }
      const T uc = v.ucpu[ci] + (add_f * a.cpu - fc);
      const T um = v.umem[ci] + (add_f * a.mem - fm);
      const T ud = v.udisk[ci] + (add_f * a.disk - fd);
      v.ucpu[ci] = uc;
      v.umem[ci] = um;
      v.udisk[ci] = ud;
      A.used_cpu[k] = uc;
      A.used_mem[k] = um;
      A.used_disk[k] = ud;
      A.placed[k] += add_i;
      A.placed_job[k] += add_i;
      A.static_free[k] = (A.static_free[k] || static_back) &&
                         !(doit && a.has_static);
      A.dyn_avail[k] += dyn_back - add_i * a.n_dyn;
      if (doit) commit_devices<T>(A, o, w);
      for (int q = 0; q < Q.A; ++q)
        if (row & bit(q)) Q.evicted[b + q] = 1;
    }
    if (doit) commit_counts<T>(A, o, v, w);
    if (row) {
      const size_t b = (o.n + w) * Q.A;
      for (int q = tid; q < Q.A; q += blockDim.x)
        if ((row & bit(q)) && Q.grp[b + q] >= 0)
          atomicAdd(&v.gc[Q.grp[b + q]], 1);
    }
    __syncthreads();
    NT_CLK(5);
  }
  NT_CNT(6, clock64());
  NT_CNT(7, A.P);
  lane_view_close<T>(A, o, v, g, c, gcounts, Q.G);
}

constexpr int kPreemptTables = 12;   // PREEMPT_ARGS in solver/preempt.py
constexpr int kOutputs = 4;          // chosen, scores, n_yielded, evict_rows

// The last launch's cluster size (nt_dense_preempt_cluster).
int g_cluster = 0;

template <typename T, int W>
auto preempt_cfg(const DenseArgs<T>& a, const PreemptArgs<T>& q) {
  return [&a, &q](int C, size_t budget, size_t& smem) {
    return cluster_cfg<T>(C, 32 * kWarps / W, a.N, a.S, a.V, a.Dp, a.Vd,
                          q.G, budget, smem);
  };
}

template <typename T, int W>
int launch_w(const DenseArgs<T>& a, const PreemptArgs<T>& q, int c_max,
             cudaStream_t stream) {
  return launch_clusters(dense_preempt_kernel<T, kWarps, W>, a.E,
                         32 * kWarps, preempt_cfg<T, W>(a, q), c_max, stream,
                         &g_cluster, a, q);
}

// The group search where the cluster holds at least kGroupSearchCluster
// blocks, else one thread a node (the group search buys latency with
// issue slots: on few SMs a walk that runs long is bound by the latter).
template <typename T, int W>
int launch_group(const DenseArgs<T>& a, const PreemptArgs<T>& q,
                 cudaStream_t stream) {
  cudaLaunchConfig_t lc;
  cudaLaunchAttribute attr;
  ClusterCfg g;
  int C = 1;
  const cudaError_t err = choose_cluster(
      dense_preempt_kernel<T, kWarps, W>, a.E, 32 * kWarps,
      preempt_cfg<T, W>(a, q), kMaxCluster, &lc, &attr, &g, &C);
  if (err != cudaSuccess) return (int)err;
  return C >= kGroupSearchCluster ? launch_w<T, W>(a, q, C, stream)
                                  : launch_w<T, 1>(a, q, C, stream);
}

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
  return q.A <= 16 ? launch_group<T, 16>(a, q, stream)
                   : launch_group<T, 32>(a, q, stream);
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

extern "C" int nt_dense_preempt_cluster(void) { return g_cluster; }

NT_STEP_CLOCKS_EXPORT
