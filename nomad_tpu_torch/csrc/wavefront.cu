// In-kernel wavefront for NVIDIA Hopper (sm_90a).
//
// Replaces nomad_tpu/solver/binpack.py::_solve_wavefront_impl (jitted as
// solve_wavefront): a uniform-ask lane's placement with the per-node
// capacities, the fit order and the compact table all computed on the
// device, then the wave step. S == 0 (no spread columns) and B = WAVE_B
// = 32, as in the reference; reschedule penalties and affinities are
// scored.
//
// Two launches on the caller's stream:
//   1. prep -- a thread-block cluster of CL = min(8, ceil(N / 256))
//      blocks of 256 threads per lane, grid (CL, E): 256 blocks at E 32
//      (blocks of 512 and 1,024 threads, or clusters of 4, took longer:
//      PERF.md section 6). The cluster walks the lane's nodes in
//      rounds of CL x 256, block q taking the round's q-th run of 256
//      nodes, one a thread, so a warp reads 32 neighbouring nodes of
//      each table. A thread computes
//      its node's capacity c once: the largest m with used0 + m * ask <=
//      cap in every dimension, with the reference's float predicate and
//      its +-2 integer correction, then the port, static-port,
//      distinct_hosts and feasibility caps, and clip(c, 0, P). A fit
//      node's rank in shuffled order is the lane's count before the
//      round, plus the counts of the blocks before q (each block
//      publishes its count in its shared memory; after one cluster
//      barrier each warp reads them through distributed shared memory),
//      plus the warps before it (a shared table), plus the ballot of
//      fit lanes below it. Fit nodes ranked below C = P + B write their
//      compact rows [c, used_cpu, used_mem, cpu_cap, mem_cap, placed,
//      affinity, pos]; a block whose first rank reaches C writes none,
//      and the walk ends with the round whose running count reaches C
//      (every block reads the same counts, so they stop together). Rows
//      past the last fit node repeat node N-1's row with c = 0, pos = N.
//      Ranks come from counts in node order only: no atomics. The
//      blocks also count the lane's active flags and look for a
//      reschedule penalty over all P entries (one past n_active still
//      moves scores); block 0 writes the lane scalars (asks, count,
//      limit, n_active) and the lane's route.
//   2. steps -- one block of 64 threads a lane. A lane with no penalty
//      (every penalty_idx < 0) runs row 1's run-block loop
//      (wave_warp.cuh wave_block_lane, one warp, B = 32): one chain of
//      run decisions, each committing up to 15 placements, about P / 7
//      decisions at the headline shape. Any other lane runs row 2's
//      per-placement loop (wave_compact_lane: a step warp and a head
//      warp), a chain of P steps. The reference's outputs are the same
//      bits either way on a penalty-free lane with no spreads
//      (binpack.py _solve_wave_block_impl), so the route is chosen on
//      the device and the call has no host sync.
//
// What held the older design back: one block of 1,024 threads a lane (32
// blocks on 132 SMs), a contiguous run of 16 nodes a thread (a warp's
// loads 64 bytes apart), the capacity computed twice a node (to count,
// then to write), and every lane on the per-placement loop, ~3x slower
// than the run-block loop on the headline lanes (PERF.md section 6).
//
// Integer and float semantics follow XLA's lowering of the reference:
// floor(q) -> int32 saturates (NaN -> 0), int32 adds wrap, the
// dynamic-port cap is a floor division, and the capacity predicate's
// used0 + m * ask is one fused multiply-add.
//
// Bound: the prep reads each lane's node rows up to its last choice and
// writes the compact table, about half a microsecond at 3.35 TB/s at the
// headline shape, under the launch floor; the step loop is the chain
// above (latency-bound, as rows 1 and 2 are).
#include <cooperative_groups.h>

#include <algorithm>

#include "wave_warp.cuh"

namespace {

using namespace nt;

namespace cg = cooperative_groups;

constexpr int kPrepThreads = 256;      // a prep block: 256 nodes a round
constexpr int kPrepWarps = kPrepThreads / 32;
constexpr int kMaxCluster = 8;         // prep blocks a lane (portable)
constexpr int kBigI = 1 << 30;
constexpr int kB = 32;                 // WAVE_B

template <typename T> __device__ __forceinline__ T floor_(T x);
template <> __device__ __forceinline__ float floor_<float>(float x) {
  return floorf(x);
}
template <> __device__ __forceinline__ double floor_<double>(double x) {
  return floor(x);
}

// XLA's float -> int32 conversion: NaN gives 0, out of range saturates
template <typename T>
__device__ __forceinline__ int sat_i32(T q) {
  if (q != q) return 0;
  if (q >= (T)2147483648.0) return INT_MAX;
  if (q <= (T)-2147483648.0) return INT_MIN;
  return (int)q;
}

// int32 +-1 with two's-complement wrap (XLA's int32 add)
__device__ __forceinline__ int wrap_add(int q, int d) {
  return (int)((unsigned)q + (unsigned)d);
}

// used0 + m * ask <= cap, with the multiply-add fused as XLA's lowering
// of the reference fuses it (one rounding)
template <typename T>
__device__ __forceinline__ bool fits(T used0, T cap, T ask, int m) {
  return fma_<T>((T)m, ask, used0) <= cap;
}

// c = max m >= 0 with used0 + m * ask <= cap (binpack.py cap_dim)
template <typename T>
__device__ __forceinline__ int cap_dim(T used0, T cap, T ask) {
  int q = sat_i32<T>(floor_<T>((cap - used0) / vmax(ask, T(1e-9))));
  q = fits<T>(used0, cap, ask, q) ? q : wrap_add(q, -1);
  q = fits<T>(used0, cap, ask, q) ? q : wrap_add(q, -1);
  q = q > 0 ? q : 0;
  q = fits<T>(used0, cap, ask, wrap_add(q, 1)) ? wrap_add(q, 1) : q;
  q = fits<T>(used0, cap, ask, wrap_add(q, 1)) ? wrap_add(q, 1) : q;
  q = fits<T>(used0, cap, ask, q) ? q : 0;
  return ask > T(0) ? q : kBigI;
}

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

template <typename T> struct LaneIn {
  const T *cpu_cap, *mem_cap, *disk_cap, *affinity;
  const unsigned char *feasible, *has_affinity, *distinct_hosts,
      *distinct_job_level;
  const T *used_cpu, *used_mem, *used_disk;
  const int *placed, *placed_job, *dyn_avail;
  const unsigned char* static_free;
  const T *ask_cpu, *ask_mem, *ask_disk;
  const int *n_dyn, *limit, *count;
  const unsigned char *has_static, *active;
};

// 1. prep: lane blockIdx.y, cluster block q (see the note above).
template <typename T>
__global__ void __launch_bounds__(kPrepThreads)
wavefront_prep_kernel(LaneIn<T> in, const int* __restrict__ pen,
                      T* __restrict__ compact, T* __restrict__ scal_f,
                      int* __restrict__ scal_i, int N, int P) {
  __shared__ int wcnt[kPrepWarps];      // this round's fit nodes a warp
  __shared__ int bcnt[2];               // ... a block, by round parity
  __shared__ int wpart[kPrepWarps][2];  // active count, penalty seen
  __shared__ int part[2];               // ... of the block's share of P
  cg::cluster_group cl = cg::this_cluster();
  const int CL = (int)cl.num_blocks(), q = (int)cl.block_rank();
  const int e = blockIdx.y, E = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = P + kB;
  const size_t ln = (size_t)e * N, lp = (size_t)e * P;
  const T ask_cpu = in.ask_cpu[lp], ask_mem = in.ask_mem[lp];
  const T ask_disk = in.ask_disk[lp];
  const int n_dyn = in.n_dyn[lp];
  const bool has_static = in.has_static[lp] != 0;
  const bool dh = in.distinct_hosts[e] != 0;
  const bool job_level = in.distinct_job_level[e] != 0;
  const bool has_aff = in.has_affinity[e] != 0;

  auto cap_of = [&](int n) -> int {
    const size_t i = ln + n;
    int c = min(cap_dim<T>(in.used_cpu[i], in.cpu_cap[i], ask_cpu),
                cap_dim<T>(in.used_mem[i], in.mem_cap[i], ask_mem));
    c = min(c, cap_dim<T>(in.used_disk[i], in.disk_cap[i], ask_disk));
    c = min(c, n_dyn > 0 ? floordiv(in.dyn_avail[i], max(n_dyn, 1))
                         : kBigI);
    if (has_static) c = min(c, in.static_free[i] ? 1 : 0);
    const int d0 = job_level ? in.placed_job[i] : in.placed[i];
    if (dh) c = min(c, d0 > 0 ? 0 : 1);
    if (!in.feasible[i]) c = 0;
    return c < 0 ? 0 : (c > P ? P : c);
  };
  auto write_row = [&](int k, int n, int c) {
    const size_t i = ln + n;
    T* row = compact + ((size_t)e * C + k) * 8;
    row[0] = (T)c;
    row[1] = in.used_cpu[i];
    row[2] = in.used_mem[i];
    row[3] = in.cpu_cap[i];
    row[4] = in.mem_cap[i];
    row[5] = (T)in.placed[i];
    row[6] = has_aff ? in.affinity[i] : T(0);
    row[7] = (T)(c > 0 ? n : N);
  };

  // the block's share of the lane's P entries: active flags and penalties
  {
    int act = 0;
    unsigned pn = 0;
    for (int p = q * kPrepThreads + tid; p < P; p += CL * kPrepThreads) {
      act += in.active[lp + p] != 0;
      pn |= pen[lp + p] >= 0;
    }
    act = __reduce_add_sync(kFull, act);
    pn = __reduce_or_sync(kFull, pn);
    if (lane == 0) {
      wpart[warp][0] = act;
      wpart[warp][1] = (int)pn;
    }
  }
  const unsigned below = (1u << lane) - 1u;
  int offset = 0;                       // fit nodes before this round
  for (int base = 0, r = 0; base < N && offset < C;
       base += CL * kPrepThreads, ++r) {
    const int n = base + q * kPrepThreads + tid;
    const int c = n < N ? cap_of(n) : 0;
    const unsigned fm = __ballot_sync(kFull, c > 0);
    if (lane == 0) wcnt[warp] = __popc(fm);
    __syncthreads();
    int before_w = 0, in_block = 0;
#pragma unroll
    for (int w = 0; w < kPrepWarps; ++w) {
      const int x = wcnt[w];
      before_w += w < warp ? x : 0;
      in_block += x;
    }
    if (tid == 0) {
      bcnt[r & 1] = in_block;
      if (r == 0) {
        int a = 0, f = 0;
        for (int w = 0; w < kPrepWarps; ++w) {
          a += wpart[w][0];
          f |= wpart[w][1];
        }
        part[0] = a;
        part[1] = f;
      }
    }
    cl.sync();
    // the cluster's counts of this round: lane j reads block j's
    const int peer =
        lane < CL ? *cl.map_shared_rank(&bcnt[r & 1], lane) : 0;
    const int before_b = __reduce_add_sync(kFull, lane < q ? peer : 0);
    const int total = __reduce_add_sync(kFull, peer);
    const int k = offset + before_b + before_w + __popc(fm & below);
    if (c > 0 && k < C) write_row(k, n, c);
    offset += total;
  }
  // rows past the fit list: node N-1's row, never fit (c = 0), pos = N
  for (int k = offset + q * kPrepThreads + tid; k < C;
       k += CL * kPrepThreads)
    write_row(k, N - 1, 0);
  if (q == 0 && warp == 0) {
    // the lane's sums over the cluster's shares: lane j reads block j's
    const int* pj = lane < CL ? cl.map_shared_rank(&part[0], lane) : nullptr;
    const int n_active = __reduce_add_sync(kFull, pj ? pj[0] : 0);
    const unsigned any_pen =
        __reduce_or_sync(kFull, pj ? (unsigned)pj[1] : 0u);
    if (lane == 0) {
      scal_f[e * 3 + 0] = ask_cpu;
      scal_f[e * 3 + 1] = ask_mem;
      scal_f[e * 3 + 2] = (T)in.count[lp];
      scal_i[e * 2 + 0] = in.limit[lp];
      scal_i[e * 2 + 1] = n_active;
      scal_i[2 * E + e] = any_pen ? 0 : 1;   // 1: the run-block loop
    }
  }
  cl.sync();          // no block leaves while a peer reads its counts
}

// 2. steps: lane blockIdx.x by the route the prep chose for it.
template <typename T>
__global__ void __launch_bounds__(step_threads(1))
wavefront_step_kernel(const T* __restrict__ compact,
                      const T* __restrict__ scal_f,
                      const int* __restrict__ scal_i,
                      const int* __restrict__ pen,
                      long long* __restrict__ chosen, T* __restrict__ scores,
                      long long* __restrict__ n_yielded, int C,
                      int spread_alg) {
  __shared__ CompactShared<T, 1, 0> sh;
  const int e = blockIdx.x;
  if (scal_i[2 * gridDim.x + e] != 0) {
    if (threadIdx.x < 32)
      wave_block_lane<T, 1>(compact, scal_f, scal_i, chosen, scores,
                            n_yielded, C, 8, spread_alg, e);
    return;
  }
  wave_compact_lane<T, 1, 0>(compact, scal_f, scal_i, pen, nullptr,
                             nullptr, nullptr, nullptr, nullptr, chosen,
                             scores, n_yielded, C, 8, 0, 1, spread_alg, 0,
                             e, sh, nullptr);
}

template <typename T>
int launch_packed(void* const* p, int n_ptrs, const int* d, int n_dims,
                  cudaStream_t stream) {
  // 23 lane tables, penalty_idx, 3 scratch tables (compact (E, P + B,
  // 8), scal_f (E, 3), scal_i: (E, 2) then the E routes), 3 outputs;
  // then E N P spread_alg
  if (n_ptrs != 30 || n_dims != 4) return (int)cudaErrorInvalidValue;
  const int E = d[0], N = d[1], P = d[2], spread_alg = d[3];
  if (E <= 0 || P <= 0) return 0;
  if (N <= 0 || E > 65535) return (int)cudaErrorInvalidValue;
  LaneIn<T> in;
  in.cpu_cap = (const T*)p[0];
  in.mem_cap = (const T*)p[1];
  in.disk_cap = (const T*)p[2];
  in.feasible = (const unsigned char*)p[3];
  in.affinity = (const T*)p[4];
  in.has_affinity = (const unsigned char*)p[5];
  in.distinct_hosts = (const unsigned char*)p[6];
  in.distinct_job_level = (const unsigned char*)p[7];
  in.used_cpu = (const T*)p[8];
  in.used_mem = (const T*)p[9];
  in.used_disk = (const T*)p[10];
  in.placed = (const int*)p[11];
  in.placed_job = (const int*)p[12];
  in.static_free = (const unsigned char*)p[13];
  in.dyn_avail = (const int*)p[14];
  in.ask_cpu = (const T*)p[15];
  in.ask_mem = (const T*)p[16];
  in.ask_disk = (const T*)p[17];
  in.n_dyn = (const int*)p[18];
  in.has_static = (const unsigned char*)p[19];
  in.limit = (const int*)p[20];
  in.count = (const int*)p[21];
  in.active = (const unsigned char*)p[22];
  const int* pen = (const int*)p[23];
  T* compact = (T*)p[24];
  T* scal_f = (T*)p[25];
  int* scal_i = (int*)p[26];
  long long* chosen = (long long*)p[27];
  T* scores = (T*)p[28];
  long long* n_yielded = (long long*)p[29];
  const int CL = std::min(kMaxCluster, (N + kPrepThreads - 1) / kPrepThreads);
  cudaLaunchConfig_t lc = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  lc.gridDim = dim3((unsigned)CL, (unsigned)E, 1);
  lc.blockDim = dim3(kPrepThreads, 1, 1);
  lc.dynamicSmemBytes = 0;
  lc.stream = stream;
  lc.attrs = &attr;
  lc.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&lc, wavefront_prep_kernel<T>, in,
                                       pen, compact, scal_f, scal_i, N, P);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wavefront_step_kernel<T><<<E, step_threads(1), 0, stream>>>(
      compact, scal_f, scal_i, pen, chosen, scores, n_yielded, P + kB,
      spread_alg);
  return (int)cudaGetLastError();
}

}  // namespace

NT_STEP_CLOCKS_EXPORT

extern "C" int nt_wavefront_f32(void* const* ptrs, int n_ptrs,
                                const int* dims, int n_dims, void* stream) {
  return launch_packed<float>(ptrs, n_ptrs, dims, n_dims,
                              (cudaStream_t)stream);
}

extern "C" int nt_wavefront_f64(void* const* ptrs, int n_ptrs,
                                const int* dims, int n_dims, void* stream) {
  return launch_packed<double>(ptrs, n_ptrs, dims, n_dims,
                               (cudaStream_t)stream);
}
