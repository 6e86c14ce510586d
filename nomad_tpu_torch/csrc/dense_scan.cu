// Dense greedy placement scan for NVIDIA Hopper (sm_90a).
//
// Replaces nomad_tpu/solver/binpack.py::_solve_placements_impl (with
// _scoring_parts, _select_window, _window_outputs, _spread_score and
// _commit_tables), the XLA program jitted by _make_fused_fn and vmapped
// over the E lanes of a fused dispatch.
//
// Design: one thread-block cluster of C blocks per lane (grid = E * C),
// 16 warps a block; the whole P-step scan runs inside one launch. C is
// dense_common.cuh choose_cluster's: the largest power of two <= 16 with
// E * C <= 132 SMs whose E clusters are all resident at once. A block of
// 512 threads at up to 128 registers fills an SM, and the H100's GPCs do
// not hold 32 clusters of 4 or 8 of 16 such blocks, so the launcher
// takes C = 2 at E = 32, 8 at E = 8 and 16 at E = 1. Each step is the
// cluster walk of dense_common.cuh: rounds of K tiles of C * 512 nodes
// in window order (K = 1 to 4, chosen from the largest limit so that one
// round reaches the window's close, which comes within 1.21 times the
// limit on the dense slice's spread lanes: K = 3 there), block c scoring
// its 512 nodes of each tile, one a thread, the blocks' (low, fit)
// counts and best records exchanged through distributed shared memory
// with one cluster barrier each. The block that owns the winner commits its
// usage, placed counts, ports, cores and devices (global memory, and the
// staged copy); every block applies the winner's spread and
// distinct_property values to its replica of the lane's count tables
// (the same integer updates in the same order, so no third exchange),
// and recomputes the spread statistics from it. A node's columns are
// loaded together ahead of its fit tests (dense_common.cuh
// node_feasible, node_pre), so a node costs one memory round trip.
//
// Shared memory per block: the walk's exchange slots (static: 1,232 B in
// float32, 1,664 B in float64), the spread weight shares, desired counts
// and statistics, the replicated spread (S, V) and distinct_property
// (Dp, Vd) counts, and, where they fit in the 227 KB budget, the block's
// nodes' cpu/mem/disk caps and usage (24 B a node in float32, 48 B in
// float64; at N = 16,384 a block owns 8,192 nodes at C = 2: 192 KB in
// float32, too many in float64; 24 / 48 KB at C = 16). Every other node
// column (feasibility, ports, placed counts, affinity, spread and
// distinct_property value indices, device tables, cores, mhz per core)
// stays in global memory, read through L2.
//
// Bound: a lane's P steps still form one dependency chain. A step costs
// its round's scoring (K nodes a thread on each of the cluster's SMs)
// and about 5 us of exchange, block and cluster reductions and commit
// (two cluster barriers and three block barriers). The bytes and
// operations the function needs take tens of microseconds, so the kernel
// stays latency-bound on the step chain; at E = 32 the scoring is also
// bound by the 64 SMs that two-block clusters can use.
#include "dense_common.cuh"

namespace {

using namespace nt;

constexpr int kWarps = 16;          // 512 threads a block

// The owning block commits lane winner w's node (the reference step's
// scatter updates and the device part of _commit_tables); one thread.
template <typename T>
__device__ __forceinline__ void commit_node(const DenseArgs<T>& A,
                                            const Off& o, const Ask<T>& a,
                                            const LaneView<T>& v, int ci,
                                            int w) {
  const size_t k = o.n + w;
  const T uc = v.ucpu[ci] + node_eff_cpu<T>(A, o, a, w);
  const T um = v.umem[ci] + a.mem, ud = v.udisk[ci] + a.disk;
  v.ucpu[ci] = uc;
  v.umem[ci] = um;
  v.udisk[ci] = ud;
  A.used_cpu[k] = uc;
  A.used_mem[k] = um;
  A.used_disk[k] = ud;
  A.placed[k] += 1;
  A.placed_job[k] += 1;
  if (a.has_static) A.static_free[k] = 0;
  A.dyn_avail[k] -= a.n_dyn;
  if (A.has_cores) A.cores_free[k] -= a.cores;
  commit_devices<T>(A, o, w);
}

template <typename T, int NW, int K>
__global__ void __launch_bounds__(32 * NW)
dense_scan_kernel(const ClusterCfg g, const DenseArgs<T> A) {
  const int c = (int)cg::this_cluster().block_rank();
  const int e = blockIdx.x / g.C, tid = threadIdx.x;
  const Off o = lane_off(e, A.N, A.P, A.S, A.V, A.Dp, A.Vd, A.R, A.Gd);
  __shared__ ClusterShared<T, NoX, NW, K> sh;
  extern __shared__ __align__(16) unsigned char smem[];
  const LaneView<T> v = lane_view<T>(A, o, e, g, c, nullptr, 0, smem);
  unsigned round = 0;
  NT_T0();
  NT_CNT(6, 0ull - clock64());

  for (int i = 0; i < A.P; ++i) {
    const size_t ip = o.p + i;
    const Ask<T> a = load_ask<T>(A, ip);
    int ny;
    const Rec<T, NoX> win = cluster_walk<T, NoX, NW, K>(
        g, c, A.N, a.limit,
        [&](int n0, int, int& n, bool& fit, T& fin) {
          n = n0 + tid;
          if (n >= A.N) return;
          const int ci = col_at<T>(v, g, n);
          fit = score_node_vals<T>(A, o, e, a, n, v.st, v.ucpu[ci],
                                   v.umem[ci], v.udisk[ci], v.ccap[ci],
                                   v.mcap[ci], v.dcap[ci], fin);
        },
        [](int) { return NoX(); }, sh, ny, round);
    NT_RESET();
    const bool doit = a.active && ny > 0;
    const int w = win.k.idx;
    if (c == 0 && tid == 0) {
      A.chosen[ip] = doit ? w : -1;
      A.scores[ip] = ny > 0 ? win.k.eff : neg_inf<T>();
      A.n_yielded[ip] = ny;
    }
    if (doit) {
      if (tid == 0 && (w / g.sub) % g.C == c)
        commit_node<T>(A, o, a, v, col_at<T>(v, g, w), w);
      commit_counts<T>(A, o, v, w);
    }
    __syncthreads();
    NT_CLK(5);
  }
  NT_CNT(6, clock64());
  NT_CNT(7, A.P);
  lane_view_close<T>(A, o, v, g, c, nullptr, 0);
}

constexpr int kOutputs = 3;     // chosen, scores, n_yielded
constexpr int kScanDims = kDenseDims + 1;   // + the largest limit

// The last launch's cluster size (nt_dense_scan_cluster).
int g_cluster = 0;

template <typename T>
auto scan_cfg(const DenseArgs<T>& a) {
  return [&a](int C, size_t budget, size_t& smem) {
    return cluster_cfg<T>(C, 32 * kWarps, a.N, a.S, a.V, a.Dp, a.Vd, 0,
                          budget, smem);
  };
}

template <typename T, int K>
int launch_k(const DenseArgs<T>& a, int C, cudaStream_t stream) {
  return launch_clusters(dense_scan_kernel<T, kWarps, K>, a.E,
                         32 * kWarps, scan_cfg<T>(a), C, stream,
                         &g_cluster, a);
}

template <typename T>
int launch(void* const* p, int n_ptrs, const int* d, int n_dims,
           cudaStream_t stream) {
  if (n_ptrs != kDenseTables + kOutputs || n_dims != kScanDims)
    return (int)cudaErrorInvalidValue;
  DenseArgs<T> a;
  int k = 0;
  unpack_dense<T>(a, p, k, d);
  a.chosen = (long long*)p[k++]; a.scores = (T*)p[k++];
  a.n_yielded = (long long*)p[k++];
  const int l_max = d[kDenseDims];
  if (a.E <= 0 || a.P <= 0) return 0;
  if (a.N <= 0 || a.N > (1 << 30) / 2) return (int)cudaErrorInvalidValue;
  // the cluster size, then the nodes a thread scores per round: rounds
  // of C * 512 * K nodes cover 1.25 times the largest limit (the window
  // closes within 1.21 times the limit on the dense slice's spread lanes)
  cudaLaunchConfig_t lc;
  cudaLaunchAttribute attr;
  ClusterCfg g;
  int C = 1;
  const cudaError_t err =
      choose_cluster(dense_scan_kernel<T, kWarps, 1>, a.E, 32 * kWarps,
                     scan_cfg<T>(a), kMaxCluster, &lc, &attr, &g, &C);
  if (err != cudaSuccess) return (int)err;
  const double want = 1.25 * l_max / (32.0 * kWarps * C);
  if (want <= 1.0) return launch_k<T, 1>(a, C, stream);
  if (want <= 2.0) return launch_k<T, 2>(a, C, stream);
  if (want <= 3.0) return launch_k<T, 3>(a, C, stream);
  return launch_k<T, 4>(a, C, stream);
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

extern "C" int nt_dense_scan_cluster(void) { return g_cluster; }

NT_STEP_CLOCKS_EXPORT
