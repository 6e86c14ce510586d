// Shared device code of the window kernels: slot state, the score
// terms, the block-wide prefix scan, arg-best reduction and window
// selection (the dense, system and windowed preemption kernels' building
// blocks: dense_common.cuh, preempt_common.cuh), and the step clocks.
// The wave kernels' warp-synchronous step (wave_block.cu,
// wave_compact.cu, wavefront.cu) is in wave_warp.cuh.
//
// The block helpers run one thread per slot of a B-slot window buffer
// (B = 32 * NW, NW warps). Every per-slot
// expression mirrors nomad_tpu/solver/binpack.py op for op, with the same
// association, so scores agree with the plain PyTorch versions to the bit:
// the sources are built with -fmad=false (no implicit a*b+c contraction;
// the one fused multiply-add XLA emits is written as fma()) and
// without fast math, and 10**x goes through pow/powf as torch.pow does.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <climits>

namespace nt {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSkip = 3;            // select.go maxSkip

// Step sections of lane 0's first block, in clock64() cycles, for a
// build with -DNT_STEP_CLOCKS (chip_smoke.py --ab-clocks): each kernel
// that stamps names its sections (dense_scan.cu / dense_preempt.cu:
// 1 scoring, 2 count exchange (the cluster barrier's wait included),
// 3 marking, 4 the winner (block and cluster reductions, the record
// exchange), 5 commit; 6 the whole scan, 7 steps, 8 rounds;
// wave_preempt.cu, lp_relax.cu and wave_warp.cuh their own; NT_TOTAL
// adds the cycles since NT_TOTAL_T0). nt_step_clocks reads them.
// Without the flag the stamps compile to nothing.
#ifdef NT_STEP_CLOCKS
__device__ unsigned long long nt_clk[16];
__device__ __forceinline__ bool nt_clk_on() {
  return blockIdx.x == 0 && threadIdx.x == 0;
}
#define NT_T0() unsigned long long nt_t = clock64()
#define NT_RESET() nt_t = clock64()
#define NT_CLK(i)                                  \
  do {                                             \
    if (nt::nt_clk_on()) {                         \
      const unsigned long long nt_n = clock64();   \
      nt::nt_clk[i] += nt_n - nt_t;                \
      nt_t = nt_n;                                 \
    }                                              \
  } while (0)
#define NT_CNT(i, v)                               \
  do {                                             \
    if (nt::nt_clk_on()) nt::nt_clk[i] += (v);     \
  } while (0)
#define NT_TOTAL_T0() const unsigned long long nt_t00 = clock64()
#define NT_TOTAL(i) NT_CNT(i, clock64() - nt_t00)
#define NT_STEP_CLOCKS_EXPORT                                             \
  extern "C" int nt_step_clocks(unsigned long long* out, int reset) {     \
    cudaError_t e = cudaMemcpyFromSymbol(out, nt::nt_clk,                 \
                                         sizeof(nt::nt_clk));             \
    if (e == cudaSuccess && reset) {                                      \
      static const unsigned long long z[16] = {0};                        \
      e = cudaMemcpyToSymbol(nt::nt_clk, z, sizeof(z));                   \
    }                                                                     \
    return (int)e;                                                        \
  }
#else
#define NT_T0() do {} while (0)
#define NT_RESET() do {} while (0)
#define NT_CLK(i) do {} while (0)
#define NT_CNT(i, v) do {} while (0)
#define NT_TOTAL_T0() do {} while (0)
#define NT_TOTAL(i) do {} while (0)
#define NT_STEP_CLOCKS_EXPORT
#endif

template <typename T> __device__ __forceinline__ T pow10(T x);
template <> __device__ __forceinline__ float pow10<float>(float x) {
  return powf(10.0f, x);
}
template <> __device__ __forceinline__ double pow10<double>(double x) {
  return pow(10.0, x);
}

template <typename T> __device__ __forceinline__ T neg_inf();
template <> __device__ __forceinline__ float neg_inf<float>() {
  return -INFINITY;
}
template <> __device__ __forceinline__ double neg_inf<double>() {
  return -(double)INFINITY;
}

template <typename T> __device__ __forceinline__ T vmax(T a, T b) {
  return a > b ? a : b;
}

template <typename T> __device__ __forceinline__ T fma_(T a, T b, T c);
template <> __device__ __forceinline__ float fma_<float>(float a, float b,
                                                         float c) {
  return fmaf(a, b, c);
}
template <> __device__ __forceinline__ double fma_<double>(double a,
                                                           double b,
                                                           double c) {
  return fma(a, b, c);
}

// BestFit v3 / worst-fit fitness clipped to [0, 18]
// (binpack.py _binpack_score before its division by 18)
template <typename T>
__device__ __forceinline__ T binpack_raw(T free_cpu, T free_mem,
                                         bool spread_alg) {
  T total = pow10<T>(free_cpu) + pow10<T>(free_mem);
  T raw = spread_alg ? total - T(2) : T(20) - total;
  raw = raw < T(0) ? T(0) : raw;
  return raw > T(18) ? T(18) : raw;
}

// (raw / 18 + rest) / nscores as XLA lowers the reference: the division by
// the constant is a multiply by its rounded reciprocal, fused with the add
template <typename T>
__device__ __forceinline__ T final_score(T raw, T rest, T nscores) {
  return fma_<T>(raw, T(1) / T(18), rest) / nscores;
}

// anti-affinity: -(coll + 1) / max(count, 1) when coll > 0
template <typename T>
__device__ __forceinline__ T anti_term(T coll, T count) {
  return coll > T(0) ? -(coll + T(1)) / vmax(count, T(1)) : T(0);
}

// One window slot: the compact-table row plus copies taken j.
template <typename T> struct Slot {
  T c, ucpu, umem, ccap, mcap, placed, aff, pos;
  int j;
};

template <typename T>
__device__ __forceinline__ void load_row(Slot<T>& s, const T* row) {
  s.c = row[0]; s.ucpu = row[1]; s.umem = row[2]; s.ccap = row[3];
  s.mcap = row[4]; s.placed = row[5]; s.aff = row[6]; s.pos = row[7];
  s.j = 0;
}

// Head terms of the slot's next placement (the scan step's per-slot part)
template <typename T> struct Head {
  bool fit;
  T binpack, coll, anti;        // binpack: clipped raw fitness
};

template <typename T>
__device__ __forceinline__ Head<T> head_terms(const Slot<T>& s, T ask_cpu,
                                              T ask_mem, T count,
                                              bool spread_alg) {
  Head<T> h;
  h.fit = (T)s.j < s.c;                 // sentinel rows: c = 0
  T jp1 = (T)(s.j + 1);
  T new_cpu = s.ucpu + jp1 * ask_cpu;
  T new_mem = s.umem + jp1 * ask_mem;
  T free_cpu = T(1) - new_cpu / vmax(s.ccap, T(1e-9));
  T free_mem = T(1) - new_mem / vmax(s.mcap, T(1e-9));
  h.binpack = binpack_raw<T>(free_cpu, free_mem, spread_alg);
  h.coll = s.placed + (T)s.j;
  h.anti = anti_term<T>(h.coll, count);
  return h;
}

// Inclusive block-wide prefix sum of v; total receives the block sum.
// wsum is NW values of shared memory. Every thread must call it.
template <int NW, typename V = int>
__device__ __forceinline__ V block_scan(V v, V& total, V* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    V n = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += n;
  }
  if (NW == 1) {
    total = __shfl_sync(kFull, v, 31);
    return v;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  V add = 0, tot = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    V x = wsum[k];
    if (k < warp) add += x;
    tot += x;
  }
  __syncthreads();
  total = tot;
  return v + add;
}

// Selection key: yielded first, then higher score, then smaller window
// order, then smaller slot index -- a strict total order, so any
// reduction tree gives the same winner.
template <typename T> struct Key {
  T eff;
  int order, idx, y;
};

template <typename T>
__device__ __forceinline__ bool better(const Key<T>& a, const Key<T>& b) {
  if (a.y != b.y) return a.y > b.y;
  if (a.eff != b.eff) return a.eff > b.eff;
  if (a.order != b.order) return a.order < b.order;
  return a.idx < b.idx;
}

// Block-wide best key, returned to every thread. red is NW keys of shared
// memory. Every thread must call it.
template <typename T, int NW>
__device__ __forceinline__ Key<T> block_best(Key<T> k, Key<T>* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Key<T> o;
    o.eff = __shfl_xor_sync(kFull, k.eff, off);
    o.order = __shfl_xor_sync(kFull, k.order, off);
    o.idx = __shfl_xor_sync(kFull, k.idx, off);
    o.y = __shfl_xor_sync(kFull, k.y, off);
    if (better(o, k)) k = o;
  }
  if (NW == 1) return k;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = k;
  __syncthreads();
  Key<T> b = red[0];
#pragma unroll
  for (int q = 1; q < NW; ++q)
    if (better(red[q], b)) b = red[q];
  __syncthreads();
  return b;
}

// The window emulation (select.go:38-77) from one scan of the packed
// (low << 16 | fit) flags: skip_rank = cumsum(low), cumsum(skipped) =
// min(skip_rank, MAX_SKIP), cumsum(counted) = cumsum(fit) - cumsum(skipped).
struct Sel {
  bool yielded;
  int order;
};

template <int NW>
__device__ __forceinline__ Sel select_slot(bool fit, bool low, int L,
                                           int* wsum) {
  int tot;
  int incl = block_scan<NW>((low ? (1 << 16) : 0) | (fit ? 1 : 0), tot, wsum);
  int skip_rank = incl >> 16;
  int srank = min(skip_rank, kMaxSkip);
  bool skipped = low && skip_rank <= kMaxSkip;
  int cpos = (incl & 0xffff) - srank;
  int total_counted = (tot & 0xffff) - min(tot >> 16, kMaxSkip);
  bool window = fit && !skipped && cpos <= L;
  int deficit = max(0, L - min(total_counted, L));
  bool fallback = skipped && srank <= deficit;
  Sel r;
  r.yielded = window || fallback;
  r.order = window ? cpos : L + srank;
  return r;
}

}  // namespace nt
