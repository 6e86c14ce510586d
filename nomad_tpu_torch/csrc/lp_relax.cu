// Whole-queue LP relaxation kernel for NVIDIA Hopper (sm_90a).
//
// Replaces nomad_tpu/solver/lpq.py::_lp_solve_body (jitted by _lp_program):
// `steps` iterations of
//   price = ask . mu^T;  X = softmax over each lane's feasible nodes of
//   (V - price) / temp;  load = sum_l (X * pcount)^T . ask;
//   mu = max(0, mu + 0.5 * (load - free) / max(free, 1)),
// then a final X at temp 0.02. Float32 only, as in the reference.
//
// Every operation follows nomad_tpu_torch/solver/lpq.py lp_relax_plain in
// the same order, so the two agree to the bit on the card:
//   * price = fma(a2, m2, fma(a1, m1, a0 * m0));
//   * the row sum of exp(logit - max) is sequential over windows of 32
//     consecutive nodes, then over windows of 32 of those while more than
//     32 remain, then sequential over the rest (XLA's CPU tree);
//   * the load is an fma chain over the lanes in order, one thread per
//     node, so no atomics and nothing depends on the schedule: runs
//     repeat exactly;
//   * the annealing steps divide by their temperature, the final pass
//     multiplies by 1 / 0.02 (XLA folds the division by the constant).
//
// Design: each step is two launches on the caller's stream.
//   (a) lp_row_stats, one block per lane: the row max of the logits, then
//       the window sums of exp(logit - max) into shared memory and the
//       tree above; stores (max, sum) per lane;
//   (b) lp_node_step, one thread per node: for each lane in order,
//       recompute X[l, n] with the ops of (a), accumulate its load, then
//       update its own mu (no other thread touches it).
// A final (a) at temp 0.02 and lp_write_x write X. With lp_init (the
// lanes' any-feasible flags, mu = 0) that is 2 * steps + 3 kernels per
// call, counted as one launch.
//
// Bound: the function needs ~19 floating-point operations per (lane,
// node) and step (chip_smoke.py LP_CELL_OPS), against ~5 bytes per (lane,
// node) read once, so the operations bound it; V (4 B) and feas (1 B),
// which every pass reads again, stay in the 50 MB L2 at the headline
// shape (L 128, N 16,384: 10.5 MB). What this simple first version pays
// for instead: ~100 dependent launches, the logits computed three times
// a step, one block per lane in (a) and a loop of dependent L2 loads per
// thread in (b).
#include <cuda_runtime.h>
#include <math.h>

namespace {

typedef unsigned char u8;

constexpr int kRowThreads = 256;
constexpr int kNodeThreads = 128;
constexpr int kWin = 32;                // XLA's CPU reduce-window width
constexpr float kFinalInv = 1.0f / 0.02f;

struct LpArgs {
  const float* V;           // (L, N)
  const u8* feas;           // (L, N)
  const float* ask;         // (L, 3)
  const float* pcount;      // (L,)
  const float* free_;       // (N, 3)
  const u8* active;         // (L,)
  const float* temps;       // (steps,)
  float* X;                 // (L, N) out
  float* mu;                // (N, 3) out, the dual prices carried
  int* any_f;               // (L,) scratch: the lane has a feasible node
  float* rmax;              // (L,) scratch: row max of the logits
  float* rsum;              // (L,) scratch: row sum of exp(logit - max)
  int L, N, steps;
};

// The logit of (lane, node) as lp_relax_plain's _x_at computes it; `t`
// < 0 is the final pass.
__device__ __forceinline__ float logit_at(const LpArgs& A, int l, int n,
                                          int t, float m0, float m1,
                                          float m2) {
  const float* a = A.ask + 3 * l;
  const float price = fmaf(a[2], m2, fmaf(a[1], m1, a[0] * m0));
  const size_t k = (size_t)l * A.N + n;
  const float d = A.V[k] - price;
  float lg = t < 0 ? d * kFinalInv : d / A.temps[t];
  lg = A.feas[k] ? lg : -INFINITY;
  return A.any_f[l] ? lg : 0.0f;
}

__global__ void lp_init(const LpArgs A) {
  const int l = blockIdx.x;
  int any = 0;
  for (int n = threadIdx.x; n < A.N; n += blockDim.x)
    any |= A.feas[(size_t)l * A.N + n] != 0;
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) A.any_f[l] = any;
  // block l zeroes its share of mu
  const int per = (3 * A.N + gridDim.x - 1) / gridDim.x;
  for (int i = l * per + threadIdx.x; i < min(3 * A.N, (l + 1) * per);
       i += blockDim.x)
    A.mu[i] = 0.0f;
}

__global__ void lp_row_stats(const LpArgs A, int t, int l0) {
  extern __shared__ float part[];         // N / 32 window sums
  __shared__ float red[kRowThreads];
  const int l = l0 + blockIdx.x, tid = threadIdx.x;
  const float* mu = A.mu;
  float m = -INFINITY;
  for (int n = tid; n < A.N; n += blockDim.x)
    m = fmaxf(m, logit_at(A, l, n, t, mu[3 * n], mu[3 * n + 1],
                          mu[3 * n + 2]));
  red[tid] = m;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = fmaxf(red[tid], red[tid + s]);
    __syncthreads();
  }
  const float mx = red[0];
  // level 1: each window of 32 consecutive nodes summed in order from 0
  const int nw = A.N / kWin;
  for (int w = tid; w < nw; w += blockDim.x) {
    float acc = 0.0f;
    for (int j = 0; j < kWin; ++j) {
      const int n = w * kWin + j;
      acc = acc + expf(logit_at(A, l, n, t, mu[3 * n], mu[3 * n + 1],
                                mu[3 * n + 2]) - mx);
    }
    part[w] = acc;
  }
  __syncthreads();
  // further levels while more than 32 partial sums remain (at most one
  // window per thread: N <= 32 * 32 * kRowThreads, checked at launch)
  int m_cnt = nw;
  while (m_cnt > kWin) {
    const int nw2 = m_cnt / kWin;
    float acc = 0.0f;
    if (tid < nw2)
      for (int j = 0; j < kWin; ++j) acc = acc + part[tid * kWin + j];
    __syncthreads();
    if (tid < nw2) part[tid] = acc;
    __syncthreads();
    m_cnt = nw2;
  }
  if (tid == 0) {
    float acc = 0.0f;
    for (int j = 0; j < m_cnt; ++j) acc = acc + part[j];
    A.rmax[l] = mx;
    A.rsum[l] = acc;
  }
}

__global__ void lp_node_step(const LpArgs A, int t) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= A.N) return;
  float m[3] = {A.mu[3 * n], A.mu[3 * n + 1], A.mu[3 * n + 2]};
  float load[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < A.L; ++l) {
    const float e = expf(logit_at(A, l, n, t, m[0], m[1], m[2]) -
                         A.rmax[l]);
    float x = e / A.rsum[l];
    x = (A.any_f[l] && A.active[l]) ? x : 0.0f;
    const float xp = x * A.pcount[l];
    const float* a = A.ask + 3 * l;
    for (int r = 0; r < 3; ++r) load[r] = fmaf(xp, a[r], load[r]);
  }
  for (int r = 0; r < 3; ++r) {
    const float fr = A.free_[3 * n + r];
    const float step = (load[r] - fr) * 0.5f / fmaxf(fr, 1.0f);
    const float v = m[r] + step;
    A.mu[3 * n + r] = v > 0.0f ? v : 0.0f;
  }
}

// X of lanes [l0, l0 + count), written from X[0] on.
__global__ void lp_write_x(const LpArgs A, int l0, int count) {
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (size_t)count * A.N) return;
  const int l = l0 + (int)(k / A.N), n = (int)(k % A.N);
  const float* mu = A.mu;
  const float e = expf(logit_at(A, l, n, -1, mu[3 * n], mu[3 * n + 1],
                                mu[3 * n + 2]) - A.rmax[l]);
  const float x = e / A.rsum[l];
  A.X[k] = (A.any_f[l] && A.active[l]) ? x : 0.0f;
}

constexpr int kTables = 7;      // V feas ask pcount free active temps
constexpr int kOutputs = 5;     // X mu any_f rmax rsum
constexpr int kDims = 3;        // L N steps

int launch(void* const* p, int n_ptrs, const int* d, int n_dims,
           cudaStream_t stream) {
  if (n_ptrs != kTables + kOutputs || n_dims != kDims)
    return (int)cudaErrorInvalidValue;
  LpArgs a;
  int k = 0;
  a.V = (const float*)p[k++]; a.feas = (const u8*)p[k++];
  a.ask = (const float*)p[k++]; a.pcount = (const float*)p[k++];
  a.free_ = (const float*)p[k++]; a.active = (const u8*)p[k++];
  a.temps = (const float*)p[k++];
  a.X = (float*)p[k++]; a.mu = (float*)p[k++]; a.any_f = (int*)p[k++];
  a.rmax = (float*)p[k++]; a.rsum = (float*)p[k++];
  a.L = d[0]; a.N = d[1]; a.steps = d[2];
  // N a power of two with at most one second-level window per thread
  if (a.L <= 0 || a.steps <= 0 || a.N < 2 * kWin || (a.N & (a.N - 1)) ||
      a.N > kWin * kWin * kRowThreads)
    return (int)cudaErrorInvalidValue;
  const size_t shmem = (size_t)(a.N / kWin) * sizeof(float);
  const unsigned node_blocks = (unsigned)((a.N + kNodeThreads - 1) /
                                          kNodeThreads);
  lp_init<<<a.L, kRowThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int t = 0; t < a.steps; ++t) {
    lp_row_stats<<<a.L, kRowThreads, shmem, stream>>>(a, t, 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    lp_node_step<<<node_blocks, kNodeThreads, 0, stream>>>(a, t);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  lp_row_stats<<<a.L, kRowThreads, shmem, stream>>>(a, -1, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t total = (size_t)a.L * a.N;
  lp_write_x<<<(unsigned)((total + kRowThreads - 1) / kRowThreads),
               kRowThreads, 0, stream>>>(a, 0, a.L);
  return (int)cudaGetLastError();
}

// The lane-sharded relaxation (nomad_tpu/parallel/mesh.py::mesh_lpq_fn;
// parallel/mesh.py mesh_lpq drives it): one cell's phase per launch, the
// cell holding V and feas whole, its lanes [l0, l1), X of those lanes
// only, and its own mu and (L,) row statistics. Phase 0 is lp_init over
// every lane; 1 is lp_row_stats over [l0, l1) at step t (t < 0 the final
// pass); the host then copies every row's statistics into every cell in
// lane order; 2 is lp_node_step over all lanes at step t, so mu is the
// one-launch kernel's on every cell; 3 writes the final X of [l0, l1).
// The same operations in the same order as the one-launch kernel, so X
// and mu are its bits on every grid. Bound: the one-launch kernel's
// (operations), but every cell repeats the node step over all lanes,
// so a grid of c cells on one card does c times that pass's work, and a
// step costs 2 launches per cell plus 2 (e_par - 1) copies per cell;
// this first version accepts both for exactness without atomics.
constexpr int kShardDims = 7;   // L N steps phase t l0 l1

int launch_shard(void* const* p, int n_ptrs, const int* d, int n_dims,
                 cudaStream_t stream) {
  if (n_ptrs != kTables + kOutputs || n_dims != kShardDims)
    return (int)cudaErrorInvalidValue;
  LpArgs a;
  int k = 0;
  a.V = (const float*)p[k++]; a.feas = (const u8*)p[k++];
  a.ask = (const float*)p[k++]; a.pcount = (const float*)p[k++];
  a.free_ = (const float*)p[k++]; a.active = (const u8*)p[k++];
  a.temps = (const float*)p[k++];
  a.X = (float*)p[k++]; a.mu = (float*)p[k++]; a.any_f = (int*)p[k++];
  a.rmax = (float*)p[k++]; a.rsum = (float*)p[k++];
  a.L = d[0]; a.N = d[1]; a.steps = d[2];
  const int phase = d[3], t = d[4], l0 = d[5], l1 = d[6];
  if (a.L <= 0 || a.steps <= 0 || a.N < 2 * kWin || (a.N & (a.N - 1)) ||
      a.N > kWin * kWin * kRowThreads || l0 < 0 || l1 <= l0 || l1 > a.L ||
      t >= a.steps)
    return (int)cudaErrorInvalidValue;
  const size_t shmem = (size_t)(a.N / kWin) * sizeof(float);
  if (phase == 0) {
    lp_init<<<a.L, kRowThreads, 0, stream>>>(a);
  } else if (phase == 1) {
    lp_row_stats<<<l1 - l0, kRowThreads, shmem, stream>>>(a, t, l0);
  } else if (phase == 2) {
    if (t < 0) return (int)cudaErrorInvalidValue;
    lp_node_step<<<(unsigned)((a.N + kNodeThreads - 1) / kNodeThreads),
                   kNodeThreads, 0, stream>>>(a, t);
  } else if (phase == 3) {
    const size_t total = (size_t)(l1 - l0) * a.N;
    lp_write_x<<<(unsigned)((total + kRowThreads - 1) / kRowThreads),
                 kRowThreads, 0, stream>>>(a, l0, l1 - l0);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nt_lp_relax_f32(void* const* ptrs, int n_ptrs,
                               const int* dims, int n_dims, void* stream) {
  return launch(ptrs, n_ptrs, dims, n_dims, (cudaStream_t)stream);
}

extern "C" int nt_lp_shard_f32(void* const* ptrs, int n_ptrs,
                               const int* dims, int n_dims, void* stream) {
  return launch_shard(ptrs, n_ptrs, dims, n_dims, (cudaStream_t)stream);
}
