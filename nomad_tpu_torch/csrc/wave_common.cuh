// Shared device code of the wavefront kernels (wave_compact.cu,
// wave_block.cu, wavefront.cu): slot state, the score terms, the
// block-wide prefix scan and arg-best reduction, the saturation
// shift/refill, and the per-placement step loop (wave_compact_kernel). The score
// terms, the scan and the arg-best are also the dense and system
// kernels' (dense_common.cuh).
//
// Both kernels run one thread block per lane and one thread per slot of
// the B-slot window buffer (B = 32 * NW, NW warps). Every per-slot
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
// wave_preempt.cu and lp_relax.cu their own). nt_step_clocks reads
// them. Without the flag the stamps compile to nothing.
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

// Saturation: shift the slots above w left by one and load compact row
// min(cursor, C-1) into the last slot (binpack.py _wave_refill_shift).
// svidx holds S spread value-index columns of B ints (S may be 0); stage
// is B slots of shared memory. Every thread must call it.
template <typename T, int NW>
__device__ __forceinline__ void refill_shift(Slot<T>& s, int w,
                                             const T* lane_compact, int C,
                                             int W, int cursor,
                                             Slot<T>* stage, int* svidx,
                                             int S) {
  constexpr int B = 32 * NW;
  const int tid = threadIdx.x;
  const T* row = lane_compact + (size_t)min(cursor, C - 1) * W;
  stage[tid] = s;
  __syncthreads();
  if (tid == B - 1) {
    load_row(s, row);
  } else if (tid >= w) {
    s = stage[tid + 1];
  }
  for (int q = 0; q < S; ++q) {
    int* col = svidx + q * B;
    int v = tid == B - 1 ? (int)row[8 + q]
                         : (tid >= w ? col[tid + 1] : col[tid]);
    __syncthreads();
    col[tid] = v;
  }
  __syncthreads();
}

// The per-placement step loop (binpack.py _solve_wave_compact_impl, and
// the step of _solve_wavefront_impl): one thread block per lane, one
// thread per window slot (B = 32 * NW). A slot's compact row and copies
// taken j live in registers; spread counts (S, V), desired (S, V) and the
// slots' spread value indexes (S, B) live in dynamic shared memory
// (dyn_smem). Each placement step scores every slot, runs one block prefix
// scan over packed (low, fit) flags for the window emulation, one
// __syncthreads_count for n_yielded and one butterfly arg-best for the
// winner; the winner's thread bumps j and its spread counts; saturation
// shifts the slots left through shared memory and refills the last slot
// from global memory. Once a step places nothing the lane's state is
// frozen: later steps without a penalty repeat its output, steps with one
// are scored again (the penalty moves scores). The spread pointers are
// not read when S == 0.
template <typename T, int NW>
__global__ void __launch_bounds__(32 * NW)
wave_compact_kernel(const T* __restrict__ compact,
                    const T* __restrict__ scal_f,
                    const int* __restrict__ scal_i,
                    const int* __restrict__ pen,
                    const int* __restrict__ sp_counts,
                    const T* __restrict__ sp_desired,
                    const unsigned char* __restrict__ sp_has_targets,
                    const T* __restrict__ sp_weights,
                    const T* __restrict__ sp_sum_weights,
                    long long* __restrict__ chosen, T* __restrict__ scores,
                    long long* __restrict__ n_yielded, int C, int W, int S,
                    int V, int spread_alg) {
  constexpr int B = 32 * NW;
  const int e = blockIdx.x, tid = threadIdx.x;
  const int P = C - B;
  const T* cm = compact + (size_t)e * C * W;
  const T ask_cpu = scal_f[e * 3 + 0], ask_mem = scal_f[e * 3 + 1];
  const T count = scal_f[e * 3 + 2];
  const int L = scal_i[e * 2 + 0], n_active = scal_i[e * 2 + 1];
  const int* pen_e = pen + (size_t)e * P;
  long long* ch_e = chosen + (size_t)e * P;
  T* sc_e = scores + (size_t)e * P;
  long long* ny_e = n_yielded + (size_t)e * P;
  const bool salg = spread_alg != 0;

  __shared__ Slot<T> stage[B];
  __shared__ Key<T> red[NW];
  __shared__ int wsum[NW];
  // dynamic: desired (S*V T), wfrac (S T), counts (S*V int),
  // svidx (S*B int), has_t / smin / smax / sany (S int each)
  extern __shared__ __align__(16) unsigned char smem[];
  T* desired = reinterpret_cast<T*>(smem);
  T* wfrac = desired + S * V;
  int* counts = reinterpret_cast<int*>(wfrac + S);
  int* svidx = counts + S * V;
  int* has_t = svidx + S * B;
  int* smin = has_t + S;
  int* smax = smin + S;
  int* sany = smax + S;

  for (int k = tid; k < S * V; k += B) {
    counts[k] = sp_counts[(size_t)e * S * V + k];
    desired[k] = sp_desired[(size_t)e * S * V + k];
  }
  for (int q = tid; q < S; q += B) {
    has_t[q] = sp_has_targets[(size_t)e * S + q];
    wfrac[q] = sp_weights[(size_t)e * S + q] /
               vmax(sp_sum_weights[e], T(1e-9));
  }
  Slot<T> s;
  load_row(s, cm + (size_t)tid * W);
  for (int q = 0; q < S; ++q) svidx[q * B + tid] = (int)cm[tid * W + 8 + q];
  int cursor = B;
  // once a step places nothing the state is frozen for good; later steps
  // without a penalty then repeat that step's output (cached here)
  int frozen_ny = -1;
  T frozen_sc = T(0);
  __syncthreads();

  for (int i = 0; i < P; ++i) {
    const int pen_i = pen_e[i];
    if (frozen_ny >= 0 && pen_i < 0) {
      if (tid == 0) {
        ch_e[i] = -1;
        sc_e[i] = frozen_sc;
        ny_e[i] = frozen_ny;
      }
      continue;
    }
    if (S) {
      // even-spread statistics over present (count > 0) values
      for (int q = tid; q < S; q += B) {
        int mn = INT_MAX, mx = 0, any = 0;
        for (int v = 0; v < V; ++v) {
          int c = counts[q * V + v];
          if (c > 0) {
            any = 1;
            mn = min(mn, c);
            mx = max(mx, c);
          }
        }
        smin[q] = mn;
        smax[q] = mx;
        sany[q] = any;
      }
      __syncthreads();
    }
    Head<T> h = head_terms<T>(s, ask_cpu, ask_mem, count, salg);
    // per-placement reschedule penalty via the pos column (exact ints)
    const bool is_pen = pen_i >= 0 && s.pos == (T)pen_i;
    const T resched = is_pen ? T(-1) : T(0);
    T spread_total = T(0);
    for (int q = 0; q < S; ++q) {
      const int vi = svidx[q * B + tid];
      T b;
      if (vi < 0) {
        b = T(-1);                      // attribute missing on the node
      } else {
        const int cur = counts[q * V + vi];
        const T des = desired[q * V + vi];
        if (has_t[q]) {
          b = (des < T(0) || des == T(0))
                  ? T(-1)
                  : (des - (T)(cur + 1)) / vmax(des, T(1e-9)) * wfrac[q];
        } else if (!sany[q]) {
          b = T(0);
        } else {
          const int mn = smin[q], mx = smax[q];
          const T min_f = (T)mn, max_f = (T)mx, cur_f = (T)cur;
          if (cur != mn)
            b = mn == 0 ? T(-1) : (min_f - cur_f) / vmax(min_f, T(1e-9));
          else
            b = mn == mx ? T(-1) : (max_f - min_f) / vmax(min_f, T(1e-9));
        }
      }
      spread_total = spread_total + b;
    }
    const T affs = s.aff;
    T nscores = T(1) + (h.coll > T(0) ? T(1) : T(0));
    nscores = nscores + (is_pen ? T(1) : T(0));
    nscores = nscores + (affs != T(0) ? T(1) : T(0));
    nscores = nscores + (spread_total != T(0) ? T(1) : T(0));
    const T fin = final_score<T>(
        h.binpack, ((h.anti + resched) + affs) + spread_total, nscores);

    const bool low = h.fit && fin <= T(0);
    const Sel sel = select_slot<NW>(h.fit, low, L, wsum);
    const int ny = __syncthreads_count(sel.yielded);
    Key<T> k;
    k.eff = sel.yielded ? fin : neg_inf<T>();
    k.order = sel.order;
    k.idx = tid;
    k.y = sel.yielded ? 1 : 0;
    const Key<T> win = block_best<T, NW>(k, red);
    const int w = win.idx;
    const bool any_yield = ny > 0;
    const T score_out = any_yield ? win.eff : neg_inf<T>();
    if (!(i < n_active && any_yield)) {
      // nothing placed: no commit (the penalty only moves this score)
      if (tid == 0) {
        ch_e[i] = -1;
        sc_e[i] = score_out;
        ny_e[i] = ny;
      }
      if (pen_i < 0) {
        frozen_sc = score_out;
        frozen_ny = ny;
      }
      continue;
    }
    int sat = 0;
    if (tid == w) {
      ch_e[i] = (long long)s.pos;
      sc_e[i] = score_out;
      ny_e[i] = ny;
      s.j += 1;
      sat = (T)s.j >= s.c;
      for (int q = 0; q < S; ++q) {
        const int vw = svidx[q * B + tid];
        if (vw >= 0) counts[q * V + vw] += 1;
      }
    }
    if (__syncthreads_or(sat)) {
      refill_shift<T, NW>(s, w, cm, C, W, cursor, stage, svidx, S);
      ++cursor;
    }
  }
}

template <typename T>
size_t dyn_smem(int S, int V, int B) {
  return (size_t)S * V * sizeof(T) + (size_t)S * sizeof(T) +
         (size_t)S * V * sizeof(int) + (size_t)S * B * sizeof(int) +
         (size_t)4 * S * sizeof(int);
}

}  // namespace nt
