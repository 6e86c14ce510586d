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
//     node and resource, so no atomics and nothing depends on the
//     schedule: runs repeat exactly;
//   * the annealing steps divide by their temperature, the final pass
//     multiplies by 1 / 0.02 (XLA folds the division by the constant).
//
// Design: the whole anneal is one persistent kernel, launched
// cooperatively (cudaLaunchCooperativeKernel) with a grid that the
// occupancy calculator says is resident all at once (a refused launch
// returns its error and the wrapper raises); grid-wide barriers
// (cooperative_groups grid sync) separate a step's two phases:
//   (a) rows, one block of 1,024 threads per lane (a block takes lanes
//       b, b + grid, ...), in segments of 16,384 nodes: thread i holds
//       nodes i, i + 1,024, ... (16 at the headline shape), so every
//       load and store is coalesced; it computes each logit once, in
//       registers (through the X buffer when a row has more than one
//       segment); the block max; e = exp(logit - max), staged in shared
//       memory; each 32-node window's sum as one chain in node order,
//       one thread a window; the tree above the windows as before; then
//       x * pcount = (e / sum) * pcount written once into the X buffer,
//       which holds it until the last pass;
//   (b) nodes, 128 a block: the block stages the (lanes, 128) tile of
//       x * pcount in shared memory, 128 lanes at a time, in coalesced
//       rows, and three threads a node run the load's fma chain over the
//       lanes in order, then update their mu.
// mu lives in the kernel as (3, N), so both phases read it coalesced;
// the last pass moves it to the (N, 3) output. The final pass is (a) at
// temp 0.02 writing X. With the start (the lanes' any-feasible flags,
// mu = 0) and the end that is 2 * steps + 2 grid barriers in one launch.
// Data written by other blocks (mu, the X buffer) is read around L1
// (__ldcg).
//
// Bound: the function needs ~19 floating-point operations per (lane,
// node) and step (chip_smoke.py LP_CELL_OPS), against ~5 bytes per (lane,
// node) read once, so the operations bound it; V (4 B) and feas (1 B),
// which every step reads again, stay in the 50 MB L2 at the headline
// shape (L 128, N 16,384: 10.5 MB), as does the 8 MB X buffer. What the
// kernel pays for instead: two grid barriers a step, the window sums'
// and the load's dependent chains (32 and L adds), and every block
// reading all of mu each step (L x N x 12 B from L2).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "wave_common.cuh"            // NT_CLK step sections

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

// ---------------------------------------------------------------------------
// The persistent kernel.

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;          // a block of the persistent kernel
constexpr int kSeg = 16384;             // nodes of a row segment
constexpr int kPerThread = kSeg / kThreads;
constexpr int kTileN = 128;             // nodes a block's load tile
constexpr int kTileL = 128;             // lanes a block's load tile
constexpr int kHold = 8;                // mu values a thread moves at the end

// A segment's e values in shared memory, a float of padding after every
// 32 so that the thread summing window w reads bank (w + j) % 32.
__device__ __forceinline__ int pad32(int i) { return i + (i >> 5); }

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  float m = red[0];
  for (int q = 1; q < (int)(blockDim.x >> 5); ++q) m = fmaxf(m, red[q]);
  __syncthreads();
  return m;
}

// One lane's row at step t (t < 0 the final pass): its statistics, and
// x * pcount (or, in the final pass, X) written into row l of A.X. The
// row goes in segments of up to kSeg nodes, thread i holding nodes
// i, i + 1,024, ... of a segment (coalesced loads and stores); mu is
// read in the kernel's (3, N) layout. es holds a segment's e values
// (padded), part the N / 32 window sums, bc a broadcast float.
__device__ void row_pass(const LpArgs& A, int l, int t, float* es,
                         float* part, float* red, float* bc) {
  const int tid = threadIdx.x, N = A.N;
  const int seg = min(N, kSeg), nseg = N / seg;
  const int kpt = max(1, seg / kThreads);       // nodes a thread a segment
  const bool act = tid < seg;
  const size_t row = (size_t)l * N;
  const float* a = A.ask + 3 * l;
  const float a0 = a[0], a1 = a[1], a2 = a[2];
  const bool anyf = A.any_f[l] != 0;
  const float temp = t < 0 ? 1.0f : A.temps[t];
  float* xr = A.X + row;
  float v[kPerThread];      // one segment's values (the row's, if one)
  NT_T0();
  // pass 1: the logits, each once (through the X buffer past a segment)
  float mx = -INFINITY;
  for (int sg = 0; act && sg < nseg; ++sg) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (k >= kpt) break;
      const int n = sg * seg + tid + k * kThreads;
      const float price = fmaf(a2, __ldcg(A.mu + 2 * N + n),
                               fmaf(a1, __ldcg(A.mu + N + n),
                                    a0 * __ldcg(A.mu + n)));
      const float d = A.V[row + n] - price;
      float lg = t < 0 ? d * kFinalInv : d / temp;
      lg = A.feas[row + n] ? lg : -INFINITY;
      lg = anyf ? lg : 0.0f;
      mx = fmaxf(mx, lg);
      if (nseg > 1)
        __stcg(xr + n, lg);
      else
        v[k] = lg;
    }
  }
  NT_CLK(8);
  mx = block_max(mx, red);
  NT_CLK(9);
  // pass 2, a segment at a time: e = exp(logit - max) (kept, or back in
  // the X buffer), staged in es; then each 32-node window summed in
  // node order by one thread
  for (int sg = 0; sg < nseg; ++sg) {
    if (act) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        if (k >= kpt) break;
        const int i = tid + k * kThreads, n = sg * seg + i;
        const float e = expf((nseg > 1 ? __ldcg(xr + n) : v[k]) - mx);
        if (nseg > 1)
          __stcg(xr + n, e);
        else
          v[k] = e;
        es[pad32(i)] = e;
      }
    }
    __syncthreads();
    if (tid < seg / kWin) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kWin; ++j) acc = acc + es[pad32(tid * kWin + j)];
      part[pad32(sg * (seg / kWin) + tid)] = acc;
    }
    __syncthreads();
  }
  NT_CLK(10);
  // further levels while more than 32 partial sums remain (at most one
  // window per thread: N <= 32 * 32 * kThreads); part is padded as es
  int m_cnt = N / kWin;
  while (m_cnt > kWin) {
    const int nw2 = m_cnt / kWin;
    float s2 = 0.0f;
    if (tid < nw2)
#pragma unroll
      for (int j = 0; j < kWin; ++j)
        s2 = s2 + part[pad32(tid * kWin + j)];
    __syncthreads();
    if (tid < nw2) part[pad32(tid)] = s2;
    __syncthreads();
    m_cnt = nw2;
  }
  if (tid == 0) {
    float s2 = 0.0f;
    for (int j = 0; j < m_cnt; ++j) s2 = s2 + part[pad32(j)];
    bc[0] = s2;
    A.rmax[l] = mx;
    A.rsum[l] = s2;
  }
  __syncthreads();
  NT_CLK(11);
  const float rs = bc[0];
  const bool live = anyf && A.active[l];
  const float pc = A.pcount[l];
  // pass 3: x = e / sum, masked; times pcount but in the final pass
  for (int sg = 0; act && sg < nseg; ++sg) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (k >= kpt) break;
      const int n = sg * seg + tid + k * kThreads;
      const float e = nseg > 1 ? __ldcg(xr + n) : v[k];
      // 0 / sum is 0 (sum >= 1), so the division is skipped where e
      // underflowed to 0, as most do at the low temperatures
      float x = e == 0.0f ? 0.0f : e / rs;
      x = live ? x : 0.0f;
      __stcg(xr + n, t < 0 ? x : x * pc);
    }
  }
  __syncthreads();              // bc is reused by the next lane
  NT_CLK(12);
}

// The nodes of tile `tile` at one step: the load over the lanes in
// order, then mu (in the (3, N) layout). ask_s holds the lanes' asks;
// tile_s kTileL x kTileN.
__device__ void node_pass(const LpArgs& A, int tile, const float* ask_s,
                          float* tile_s) {
  const int tid = threadIdx.x, N = A.N, L = A.L;
  const int TN = min(kTileN, N);
  const int n_base = tile * TN;
  const bool chain = tid < 3 * TN;
  const int r = tid / TN, j = tid % TN;       // resource, node in tile
  float load = 0.0f;
  const int q4 = TN / 4;                      // float4s in a tile row
  for (int l0 = 0; l0 < L; l0 += kTileL) {
    const int nl = min(kTileL, L - l0);
    __syncthreads();
    for (int i = tid; i < nl * q4; i += blockDim.x) {
      const int li = i / q4, c4 = i % q4;
      const float4 x = __ldcg(reinterpret_cast<const float4*>(
          A.X + (size_t)(l0 + li) * N + n_base) + c4);
      reinterpret_cast<float4*>(tile_s + li * TN)[c4] = x;
    }
    __syncthreads();
    if (chain) {
      // the loads run ahead of the fma chain
#pragma unroll 16
      for (int li = 0; li < nl; ++li)
        load = fmaf(tile_s[li * TN + j], ask_s[3 * (l0 + li) + r], load);
    }
  }
  if (chain) {
    const int n = n_base + j;
    const float fr = A.free_[3 * n + r];
    const float step = (load - fr) * 0.5f / fmaxf(fr, 1.0f);
    const float v = __ldcg(A.mu + (size_t)r * N + n) + step;
    __stcg(A.mu + (size_t)r * N + n, v > 0.0f ? v : 0.0f);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
lp_persistent(const LpArgs A) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float sm[];
  // the node phase's tile and the row phase's padded segment share
  float* tile_s = sm;
  float* es = sm;
  const int seg = min(A.N, kSeg);
  float* part = sm + max(kTileL * kTileN, pad32(seg));     // N / 32
  float* ask_s = part + pad32(A.N / kWin);                  // 3 L
  __shared__ float red[kThreads / 32];
  __shared__ float bc[2];
  const int tid = threadIdx.x, L = A.L, N = A.N;
  for (int i = tid; i < 3 * L; i += blockDim.x) ask_s[i] = A.ask[i];
  // the start: each lane's any-feasible flag, mu = 0 (kept as (3, N)
  // until the end)
  for (int l = blockIdx.x; l < L; l += gridDim.x) {
    int any = 0;
    for (int n = tid; n < N; n += blockDim.x)
      any |= A.feas[(size_t)l * N + n] != 0;
    any = __syncthreads_or(any);
    if (tid == 0) A.any_f[l] = any;
  }
  const size_t gtid = (size_t)blockIdx.x * blockDim.x + tid;
  const size_t gthreads = (size_t)gridDim.x * blockDim.x;
  for (size_t i = gtid; i < (size_t)3 * N; i += gthreads) A.mu[i] = 0.0f;
  NT_T0();
  NT_CNT(6, 0ull - clock64());
  __threadfence();
  grid.sync();
  NT_CLK(0);
  const int tiles = N / min(kTileN, N);
  for (int t = 0; t < A.steps; ++t) {
    for (int l = blockIdx.x; l < L; l += gridDim.x)
      row_pass(A, l, t, es, part, red, bc);
    NT_CLK(1);
    __threadfence();
    grid.sync();
    NT_CLK(2);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
      node_pass(A, tile, ask_s, tile_s);
    NT_CLK(3);
    __threadfence();
    grid.sync();
    NT_CLK(4);
  }
  for (int l = blockIdx.x; l < L; l += gridDim.x)
    row_pass(A, l, -1, es, part, red, bc);
  // mu from (3, N) to the (N, 3) output: every value read, then written
  float hold[kHold];
#pragma unroll
  for (int k = 0; k < kHold; ++k) {
    const size_t i = gtid + k * gthreads;
    if (i < (size_t)3 * N) hold[k] = __ldcg(A.mu + i);
  }
  __threadfence();
  grid.sync();
#pragma unroll
  for (int k = 0; k < kHold; ++k) {
    const size_t i = gtid + k * gthreads;
    if (i < (size_t)3 * N) A.mu[3 * (i % N) + i / N] = hold[k];
  }
  NT_CLK(5);
  NT_CNT(6, clock64());
  NT_CNT(7, A.steps);
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
      a.N > kWin * kWin * kThreads)
    return (int)cudaErrorInvalidValue;
  const int seg = a.N < kSeg ? a.N : kSeg;
  const int nwin = a.N / kWin;
  const size_t shmem = sizeof(float) *
      (std::max(kTileL * kTileN, seg + seg / 32) + nwin + nwin / 32 +
       3 * (size_t)a.L);
  cudaError_t err = cudaFuncSetAttribute(
      lp_persistent, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, lp_persistent, kThreads, shmem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // every block resident at once; no more than the lanes or tiles need;
  // enough threads to hold mu for its last transposition
  const int tiles = a.N / (a.N < kTileN ? a.N : kTileN);
  const int grid = std::min(sms * per_sm, std::max(a.L, tiles));
  if ((size_t)3 * a.N > (size_t)kHold * grid * kThreads)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)lp_persistent, grid,
                                    kThreads, args, shmem, stream);
  if (err != cudaSuccess) return (int)err;
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

NT_STEP_CLOCKS_EXPORT

extern "C" int nt_lp_relax_f32(void* const* ptrs, int n_ptrs,
                               const int* dims, int n_dims, void* stream) {
  return launch(ptrs, n_ptrs, dims, n_dims, (cudaStream_t)stream);
}

extern "C" int nt_lp_shard_f32(void* const* ptrs, int n_ptrs,
                               const int* dims, int n_dims, void* stream) {
  return launch_shard(ptrs, n_ptrs, dims, n_dims, (cudaStream_t)stream);
}
