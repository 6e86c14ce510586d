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
// the node axis in shuffled order in tiles of 2,048 nodes, scoring every
// node (fit over resources, ports, distinct_hosts, distinct_property,
// devices, cores; the final score of fit nodes) and stopping once the
// window is settled (dense_common.cuh window_walk); then thread 0
// writes the step's outputs and commits the winner: usage, placed
// counts, ports, cores, spread and distinct_property counts, the device
// group with the first-max affinity. A barrier closes the step.
//
// Bound: a lane's P steps form one dependency chain of ~6 block barriers
// each plus the tiles the window needs; the bytes the function must move
// once (the tables in, the outputs and final state out) take tens of
// microseconds at 3.35 TB/s, and the operations the window needs less,
// so the kernel is latency-bound on the step chain.
#include "dense_common.cuh"

namespace {

using namespace nt;

// Thread 0 commits lane winner w (the reference step's scatter updates
// and _commit_tables).
template <typename T>
__device__ __forceinline__ void commit(const DenseArgs<T>& A, const Off& o,
                                       const Ask<T>& a, int w) {
  const size_t k = o.n + w;
  const bool has_cores = A.has_cores != 0;
  A.used_cpu[k] = A.used_cpu[k] + node_eff_cpu<T>(A, o, a, w);
  A.used_mem[k] = A.used_mem[k] + a.mem;
  A.used_disk[k] = A.used_disk[k] + a.disk;
  A.placed[k] += 1;
  A.placed_job[k] += 1;
  if (a.has_static) A.static_free[k] = 0;
  A.dyn_avail[k] -= a.n_dyn;
  if (has_cores) A.cores_free[k] -= a.cores;
  commit_tables<T>(A, o, w);
}

template <typename T, int NW>
__global__ void __launch_bounds__(32 * NW)
dense_scan_kernel(const DenseArgs<T> A) {
  const int e = blockIdx.x, tid = threadIdx.x;
  const Off o = lane_off(e, A.N, A.P, A.S, A.V, A.Dp, A.Vd, A.R, A.Gd);
  __shared__ WalkShared<T, NW> sh;
  // dynamic: the spread statistics (SpreadStats)
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
          return score_node<T>(A, o, e, a, n, st, fin);
        },
        sh, ny);
    if (tid == 0) {
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

constexpr int kOutputs = 3;     // chosen, scores, n_yielded

template <typename T>
int launch(void* const* p, int n_ptrs, const int* d, int n_dims,
           cudaStream_t stream) {
  if (n_ptrs != kDenseTables + kOutputs || n_dims != kDenseDims)
    return (int)cudaErrorInvalidValue;
  DenseArgs<T> a;
  int k = 0;
  unpack_dense<T>(a, p, k, d);
  a.chosen = (long long*)p[k++]; a.scores = (T*)p[k++];
  a.n_yielded = (long long*)p[k++];
  if (a.E <= 0 || a.P <= 0) return 0;
  if (a.N <= 0 || a.N > (1 << 30) / 2) return (int)cudaErrorInvalidValue;
  const size_t smem = spread_stats_bytes<T>(a.S);
  auto kern = dense_scan_kernel<T, kDenseWarps>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<a.E, 32 * kDenseWarps, smem, stream>>>(a);
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
