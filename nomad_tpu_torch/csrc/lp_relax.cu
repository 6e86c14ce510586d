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

#include "mesh_exchange.cuh"
#include "wave_common.cuh"            // NT_CLK step sections

namespace {

using namespace nt;

typedef unsigned char u8;

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

// The one-launch kernel's tile loader: x * pcount of lane l at nodes n
// .. n + 3, as the row phase left it in the X buffer.
struct XLoad {
  const float* X;
  int N;
  __device__ __forceinline__ void begin(int, int) const {}
  __device__ __forceinline__ float4 operator()(int l, int n) const {
    return __ldcg(reinterpret_cast<const float4*>(X + (size_t)l * N + n));
  }
};

// The nodes of tile `tile` at one step: the load over the lanes in
// order, then mu (in the (3, N) layout). ask_s holds the lanes' asks;
// tile_s kTileL x kTileN; load(l, n) gives x * pcount of lane l at nodes
// n .. n + 3 (load.begin(n_base, TN) first, before the tile's first
// block barrier).
template <typename Load>
__device__ void node_pass(const LpArgs& A, int tile, const float* ask_s,
                          float* tile_s, const Load& load) {
  const int tid = threadIdx.x, N = A.N, L = A.L;
  const int TN = min(kTileN, N);
  const int n_base = tile * TN;
  const bool chain = tid < 3 * TN;
  const int r = tid / TN, j = tid % TN;       // resource, node in tile
  float load_r = 0.0f;
  const int q4 = TN / 4;                      // float4s in a tile row
  load.begin(n_base, TN);
  for (int l0 = 0; l0 < L; l0 += kTileL) {
    const int nl = min(kTileL, L - l0);
    __syncthreads();
    for (int i = tid; i < nl * q4; i += blockDim.x) {
      const int li = i / q4, c4 = i % q4;
      reinterpret_cast<float4*>(tile_s + li * TN)[c4] =
          load(l0 + li, n_base + 4 * c4);
    }
    __syncthreads();
    if (chain) {
      // the loads run ahead of the fma chain
#pragma unroll 16
      for (int li = 0; li < nl; ++li)
        load_r = fmaf(tile_s[li * TN + j], ask_s[3 * (l0 + li) + r], load_r);
    }
  }
  if (chain) {
    const int n = n_base + j;
    const float fr = A.free_[3 * n + r];
    const float step = (load_r - fr) * 0.5f / fmaxf(fr, 1.0f);
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
      node_pass(A, tile, ask_s, tile_s, XLoad{A.X, N});
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

// ---------------------------------------------------------------------------
// The lane-sharded relaxation (nomad_tpu/parallel/mesh.py::mesh_lpq_fn;
// parallel/mesh.py mesh_lpq drives it through solver/lpq.py lp_shard).
//
// One cooperative launch per card covers every cell of the grid on that
// card, `bpc` blocks a cell (the launcher splits the card's resident
// blocks evenly over its cells). A cell holds V and feas whole, its lanes [l0, l1),
// X of those lanes, its own mu ((3, N) scratch, the (N, 3) output at the
// end) and any-feasible flags; the cells of one nodes column form an
// exchange group (mesh_exchange.cuh) whose area holds every lane's row
// statistics by step parity. A step:
//   1. the cell's blocks run row_pass over its lanes (the one-launch
//      kernel's row phase), writing the lanes' (max, sum) into the
//      group's slots of this step's parity;
//   2. a barrier of the cell's blocks only (a counter in device memory,
//      bounded like every wait), then block 0 publishes the step;
//   3. every block waits for its group's cells and reads every lane's
//      statistics into shared memory;
//   4. the cell's blocks run node_pass over all N nodes with a tile
//      loader that computes x * pcount of every lane, in lane order, from
//      the statistics (the one-launch kernel's row phase's expressions),
//      into the cell's own mu; then the cell's barrier again.
// It ends with row_pass at the final temperature over the cell's lanes
// (X) and mu moved to its (N, 3) output. Built with -DNT_STEP_CLOCKS,
// the first cell's block 0 stamps: 0 the start, 1 its rows, 2 the
// cell's barrier after them, 3 the exchange, 4 its node tiles, 5 the
// barrier after them; 6 the launch, 7 steps (row_pass its own 8-12). No barrier spans two cells, so
// the cells of one card and of several cards run the same code; the same
// operations in the same order as the one-launch kernel, so X and mu are
// its bits on every grid.
//
// Bound: the one-launch kernel's (operations: ~19 per (lane, node) and
// step), but every cell runs the node pass over all L lanes, so c cells
// on one card do c times that pass's work (its exp and divisions) on a
// c-th of the SMs, and a step waits for the slowest cell of its group.

// A cell's row of the device table: V feas ask pcount free active temps,
// X (its lanes), mu (3, N) scratch, any_f scratch, mu (N, 3) out, its
// group's exchange area, its barrier counter; then l0, l1, its index in
// its group and its place in the grid.
constexpr int kLpCellWords = 17;

struct LpShardLaunch {
  const long long* cells;       // (n_cells, kLpCellWords)
  int* err;                     // kErrWords
  int L, N, steps, G, bpc, budget;
};

struct LpCell {
  LpArgs A;
  float* mu_out;
  unsigned *area, *ctr;
  int l0, l1, gi, place;
};

// x * pcount of lane l at nodes n .. n + 3 from the group's statistics,
// with row_pass's expressions; begin() stages the tile's mu. The lanes'
// asks, pcounts and flags (bit 0 any feasible node, bit 1 live) come
// from shared memory.
struct StatLoad {
  const LpArgs* A;
  const float *ask_s, *s_rmax, *s_rsum, *s_pc;
  const int* s_flag;
  float* s_mu;                  // 3 x TN
  float temp;
  int TN;
  __device__ __forceinline__ void begin(int n_base, int) const {
    for (int i = threadIdx.x; i < 3 * TN; i += blockDim.x)
      s_mu[i] = __ldcg(A->mu + (size_t)(i / TN) * A->N + n_base + i % TN);
  }
  __device__ __forceinline__ float4 operator()(int l, int n) const {
    const size_t row = (size_t)l * A->N;
    const float a0 = ask_s[3 * l], a1 = ask_s[3 * l + 1],
                a2 = ask_s[3 * l + 2];
    const bool anyf = s_flag[l] & 1, live = s_flag[l] & 2;
    const float pc = s_pc[l], mx = s_rmax[l], rs = s_rsum[l];
    const float4 v4 = __ldg(reinterpret_cast<const float4*>(A->V + row + n));
    const uchar4 f4 = *reinterpret_cast<const uchar4*>(A->feas + row + n);
    const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
    const unsigned char ff[4] = {f4.x, f4.y, f4.z, f4.w};
    float out[4];
    const int jn0 = n % TN;     // n is a multiple of 4, as TN is
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int jn = jn0 + q;
      const float price = fmaf(a2, s_mu[2 * TN + jn],
                               fmaf(a1, s_mu[TN + jn], a0 * s_mu[jn]));
      const float d = vv[q] - price;
      float lg = d / temp;
      lg = ff[q] ? lg : -INFINITY;
      lg = anyf ? lg : 0.0f;
      const float e = expf(lg - mx);
      float x = e == 0.0f ? 0.0f : e / rs;
      x = live ? x : 0.0f;
      out[q] = x * pc;
    }
    return make_float4(out[0], out[1], out[2], out[3]);
  }
};

// A barrier of one cell's blocks: a monotone counter in device memory
// (target = the barrier's number times the cell's blocks), waited on
// within the budget. False when the budget ran out or another unit set
// the error word; every thread of the block must call it. The fence is
// the card's: the cell's blocks share it, and block 0 publishes the
// step with a system-scope release, which carries to the group's other
// cards every write its acquire of the counter observed.
__device__ bool cell_sync(unsigned* ctr, unsigned target, const Waiter& w,
                          int step) {
  int ok = 1;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctr, 1u);
    if (ld_acquire_gpu(ctr) < target) {
      const long long t0 = clock64();
      for (;;) {
        __nanosleep(64);
        if (ld_acquire_gpu(ctr) >= target) break;
        if (error_set(w)) {
          ok = 0;
          break;
        }
        if (((clock64() - t0) >> 10) > w.budget) {
          record_error(w, kErrCellSync, step, -1);
          ok = 0;
          break;
        }
      }
    }
  }
  return __syncthreads_and(ok) != 0;
}

__global__ void __launch_bounds__(kThreads, 1)
lp_shard_kernel(const LpShardLaunch P) {
  const int k = blockIdx.x / P.bpc, b = blockIdx.x % P.bpc;
  const int tid = threadIdx.x, L = P.L, N = P.N, bpc = P.bpc;
  __shared__ LpCell cs;
  __shared__ float red[kThreads / 32];
  __shared__ float bc[2];
  extern __shared__ __align__(16) float sm[];
  if (tid == 0) {
    const long long* row = P.cells + (size_t)k * kLpCellWords;
    LpArgs& a = cs.A;
    a.V = (const float*)row[0]; a.feas = (const u8*)row[1];
    a.ask = (const float*)row[2]; a.pcount = (const float*)row[3];
    a.free_ = (const float*)row[4]; a.active = (const u8*)row[5];
    a.temps = (const float*)row[6];
    cs.l0 = (int)row[13]; cs.l1 = (int)row[14];
    cs.gi = (int)row[15]; cs.place = (int)row[16];
    // row_pass writes row l at X + l * N: the cell's X holds [l0, l1)
    a.X = (float*)row[7] - (size_t)cs.l0 * N;
    a.mu = (float*)row[8]; a.any_f = (int*)row[9];
    cs.mu_out = (float*)row[10];
    cs.area = (unsigned*)row[11]; cs.ctr = (unsigned*)row[12];
    a.L = L; a.N = N; a.steps = P.steps;
  }
  __syncthreads();
  const LpArgs& A = cs.A;
  float* tile_s = sm;
  float* es = sm;
  const int seg = min(N, kSeg);
  float* part = sm + max(kTileL * kTileN, pad32(seg));     // N / 32
  float* ask_s = part + pad32(N / kWin);                    // 3 L
  float* s_rmax = ask_s + 3 * L;                            // L
  float* s_rsum = s_rmax + L;                               // L
  float* s_pc = s_rsum + L;                                 // L
  int* s_flag = reinterpret_cast<int*>(s_pc + L);           // L
  float* s_mu = reinterpret_cast<float*>(s_flag + L);       // 3 kTileN
  const Waiter wt{P.err, (long long)P.budget, cs.place};
  float* stats = reinterpret_cast<float*>(cs.area);
  unsigned* seq = cs.area + lp_seq_off(0, L);
  unsigned gen = 0;
  for (int i = tid; i < 3 * L; i += blockDim.x) ask_s[i] = A.ask[i];
  // the start: every lane's any-feasible flag, mu = 0
  for (int l = b; l < L; l += bpc) {
    int any = 0;
    for (int n = tid; n < N; n += blockDim.x)
      any |= A.feas[(size_t)l * N + n] != 0;
    any = __syncthreads_or(any);
    if (tid == 0) A.any_f[l] = any;
  }
  for (size_t i = (size_t)b * kThreads + tid; i < (size_t)3 * N;
       i += (size_t)bpc * kThreads)
    A.mu[i] = 0.0f;
  NT_T0();
  NT_CNT(6, 0ull - clock64());
  if (!cell_sync(cs.ctr, ++gen * bpc, wt, -1)) return;
  // the lanes' pcounts and flags, for every step's node pass
  for (int l = tid; l < L; l += blockDim.x) {
    const bool anyf = __ldcg(A.any_f + l) != 0;
    s_pc[l] = A.pcount[l];
    s_flag[l] = (anyf ? 1 : 0) | (anyf && A.active[l] ? 2 : 0);
  }
  __syncthreads();
  NT_CLK(0);
  const int TN = min(kTileN, N), tiles = N / TN;
  for (int t = 0; t < P.steps; ++t) {
    const int par = t & 1;
    float* rmax = stats + lp_stat_off(par, 0, L);
    float* rsum = stats + lp_stat_off(par, 1, L);
    if (tid == 0) {
      cs.A.rmax = rmax;
      cs.A.rsum = rsum;
    }
    __syncthreads();
    // 1-2. the cell's lanes' statistics, then publish the step
    for (int l = cs.l0 + b; l < cs.l1; l += bpc)
      row_pass(A, l, t, es, part, red, bc);
    NT_CLK(1);
    if (!cell_sync(cs.ctr, ++gen * bpc, wt, t)) return;
    NT_CLK(2);
    const unsigned tgt = (unsigned)(t * kLpPoints + 1);
    if (b == 0 && tid == 0) st_release_sys(seq + cs.gi, tgt);
    // 3. the group's statistics
    bool ok = true;
    if (tid < P.G && tid != cs.gi)
      ok = wait_seq(seq + tid, tgt, wt, kErrStats, t, -1);
    if (!__syncthreads_and(ok)) return;
    for (int l = tid; l < L; l += blockDim.x) {
      s_rmax[l] = ld_strong(rmax + l);
      s_rsum[l] = ld_strong(rsum + l);
    }
    __syncthreads();
    NT_CLK(3);
    // 4. the load over every lane in order, into the cell's mu
    const StatLoad ld{&A, ask_s, s_rmax, s_rsum, s_pc, s_flag, s_mu,
                      A.temps[t], TN};
    for (int tile = b; tile < tiles; tile += bpc)
      node_pass(A, tile, ask_s, tile_s, ld);
    NT_CLK(4);
    if (!cell_sync(cs.ctr, ++gen * bpc, wt, t)) return;
    NT_CLK(5);
  }
  // the final pass over the cell's lanes (X), its statistics into the
  // slots of the parity after the last step's
  if (tid == 0) {
    cs.A.rmax = stats + lp_stat_off(P.steps & 1, 0, L);
    cs.A.rsum = stats + lp_stat_off(P.steps & 1, 1, L);
  }
  __syncthreads();
  for (int l = cs.l0 + b; l < cs.l1; l += bpc)
    row_pass(A, l, -1, es, part, red, bc);
  // mu from the (3, N) scratch to the (N, 3) output
  for (size_t i = (size_t)b * kThreads + tid; i < (size_t)3 * N;
       i += (size_t)bpc * kThreads)
    cs.mu_out[3 * (i % N) + i / N] = __ldcg(A.mu + i);
  NT_CNT(6, clock64());
  NT_CNT(7, P.steps);
}

constexpr int kShardDims = 6;   // L N steps G n_cells budget

int launch_shard(void* const* p, int n_ptrs, const int* d, int n_dims,
                 cudaStream_t stream) {
  if (n_ptrs != 2 || n_dims != kShardDims) return (int)cudaErrorInvalidValue;
  LpShardLaunch P;
  P.cells = (const long long*)p[0];
  P.err = (int*)p[1];
  P.L = d[0]; P.N = d[1]; P.steps = d[2]; P.G = d[3];
  const int n_cells = d[4];
  P.budget = d[5];
  if (P.L <= 0 || P.steps <= 0 || P.N < 2 * kWin || (P.N & (P.N - 1)) ||
      P.N > kWin * kWin * kThreads || P.G < 1 || P.G > 32 ||
      P.L % P.G || n_cells < 1 || P.budget <= 0)
    return (int)cudaErrorInvalidValue;
  const int seg = P.N < kSeg ? P.N : kSeg;
  const int nwin = P.N / kWin;
  const size_t shmem = sizeof(float) *
      (std::max(kTileL * kTileN, seg + seg / 32) + nwin + nwin / 32 +
       7 * (size_t)P.L + 3 * kTileN);
  cudaError_t err = cudaFuncSetAttribute(
      lp_shard_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, lp_shard_kernel, kThreads, shmem)) != cudaSuccess)
    return (int)err;
  // every block resident at once, the card's blocks split evenly over
  // its cells; no more than a cell's lanes or tiles need
  const int tiles = P.N / (P.N < kTileN ? P.N : kTileN);
  P.bpc = std::min(sms * per_sm / n_cells, std::max(P.L / P.G, tiles));
  if (P.bpc < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel((const void*)lp_shard_kernel,
                                    n_cells * P.bpc, kThreads, args, shmem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
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
