// Run-block wavefront kernel for NVIDIA Hopper (sm_90a).
//
// Replaces nomad_tpu/solver/binpack.py::_solve_wave_block_impl, the XLA
// program jitted in _wave_compact_program and vmapped over the E lanes of
// a fused dispatch. It takes lanes with no spreads and no reschedule
// penalties, the shape of every headline lane.
//
// Design: one thread block per lane (grid = E), one thread per window slot
// (B = 32 or 128), each slot's compact row and copies-taken j in
// registers. One loop iteration is one run decision: the block scores the
// slots' heads (prefix scan for the window, __syncthreads_count for
// n_yielded), reduces to the winner and to the frozen runner-up, and warp
// 0 evaluates the winner's next K = 32 stream values, one per lane. A
// __ballot_sync of the stop conditions (loses to the runner-up, crosses
// the skip threshold, runs out of capacity or of placements) and __ffs
// give the run length t; the t picks go out in one coalesced store.
// Saturation shifts the slots left and refills the last one from global
// memory. The outputs are written directly; the TPU program's one-hot
// matmul expansion of run records has no counterpart here.
//
// Bound: the run decisions of a lane form one dependency chain (about
// P / 7 at the headline shape), so the kernel is latency-bound on it; its
// bytes (the compact table once, the outputs once) would take about a
// microsecond at 3.35 TB/s.
#include "wave_common.cuh"

namespace {

using namespace nt;

constexpr int kK = 32;                  // run width: one warp

template <typename T> struct HeadState {
  T f0;
  bool low;
  Sel sel;
  int ny;
};

// The per-placement step's head at (j, slot): no spreads, no penalties.
template <typename T, int NW>
__device__ __forceinline__ HeadState<T> head_state(const Slot<T>& s,
                                                   T ask_cpu, T ask_mem,
                                                   T count, int L,
                                                   bool salg, int* wsum) {
  HeadState<T> r;
  Head<T> h = head_terms<T>(s, ask_cpu, ask_mem, count, salg);
  T nsc = T(1) + (h.coll > T(0) ? T(1) : T(0));
  nsc = nsc + (s.aff != T(0) ? T(1) : T(0));
  r.f0 = final_score<T>(h.binpack, h.anti + s.aff, nsc);
  r.low = h.fit && r.f0 <= T(0);
  r.sel = select_slot<NW>(h.fit, r.low, L, wsum);
  r.ny = __syncthreads_count(r.sel.yielded);
  return r;
}

template <typename T, int NW>
__global__ void __launch_bounds__(32 * NW)
wave_block_kernel(const T* __restrict__ compact,
                  const T* __restrict__ scal_f,
                  const int* __restrict__ scal_i,
                  long long* __restrict__ chosen, T* __restrict__ scores,
                  long long* __restrict__ n_yielded, int C, int W,
                  int spread_alg) {
  constexpr int B = 32 * NW;
  const int e = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int P = C - B;
  const T* cm = compact + (size_t)e * C * W;
  const T ask_cpu = scal_f[e * 3 + 0], ask_mem = scal_f[e * 3 + 1];
  const T count = scal_f[e * 3 + 2];
  const int L = scal_i[e * 2 + 0], n_active = scal_i[e * 2 + 1];
  long long* ch_e = chosen + (size_t)e * P;
  T* sc_e = scores + (size_t)e * P;
  long long* ny_e = n_yielded + (size_t)e * P;
  const bool salg = spread_alg != 0;

  __shared__ Slot<T> stage[B];
  __shared__ Key<T> red[NW];
  __shared__ int wsum[NW];
  __shared__ Slot<T> win_slot;          // the winner's slot
  __shared__ int win_order, win_low, run_t, run_sat;

  Slot<T> s;
  load_row(s, cm + (size_t)tid * W);
  int cursor = B;
  int p = 0;

  while (p < n_active) {
    const HeadState<T> hs =
        head_state<T, NW>(s, ask_cpu, ask_mem, count, L, salg, wsum);
    if (hs.ny == 0) break;              // nothing yields: frozen from here
    const T effH = hs.sel.yielded ? hs.f0 : neg_inf<T>();
    Key<T> k;
    k.eff = effH;
    k.order = hs.sel.order;
    k.idx = tid;
    k.y = hs.sel.yielded ? 1 : 0;
    const int w = block_best<T, NW>(k, red).idx;
    if (tid == w) {
      win_slot = s;
      win_order = hs.sel.order;
      win_low = hs.low ? 1 : 0;
    }
    // frozen runner-up: best other head, ties to the smallest order
    // (over every slot, as the reference's masked max/min are)
    Key<T> ko;
    ko.eff = tid == w ? neg_inf<T>() : effH;
    ko.order = hs.sel.order;
    ko.idx = tid;
    ko.y = 1;
    const Key<T> ru = block_best<T, NW>(ko, red);
    __syncthreads();                    // win_* visible

    if (tid < 32) {
      const Slot<T> ws = win_slot;
      const T j_wf = (T)ws.j, order_wf = (T)win_order;
      const bool low_w = win_low != 0;
      const T rub = ru.eff;
      const int q = lane;
      // stream value of the winner's (j_w + q + 1)-th placement
      const T jq = j_wf + (T)q;
      const bool validw = jq < ws.c;
      const T jp1q = jq + T(1);
      const T fcq = T(1) - (ws.ucpu + jp1q * ask_cpu) / vmax(ws.ccap, T(1e-9));
      const T fmq = T(1) - (ws.umem + jp1q * ask_mem) / vmax(ws.mcap, T(1e-9));
      const T bpq = binpack_raw<T>(fcq, fmq, salg);
      const T collq = ws.placed + jq;
      const T antiq = anti_term<T>(collq, count);
      const T nscq = (T(1) + (collq > T(0) ? T(1) : T(0))) +
                     (ws.aff != T(0) ? T(1) : T(0));
      const T val = final_score<T>(bpq, antiq + ws.aff, nscq);
      const bool win_q = val > rub ||
                         (val == rub && order_wf < (T)ru.order) || q == 0;
      const bool cross = (low_w ? val > T(0) : val <= T(0)) && q > 0;
      const bool stop = !validw || !win_q || cross || q >= n_active - p;
      const unsigned mask = __ballot_sync(kFull, stop);
      const int tlim = mask ? __ffs(mask) - 1 : kK;
      const int q_sat = (int)(ws.c - T(1) - j_wf);
      const bool has_sat = q_sat < kK && q_sat < tlim;
      const int t = has_sat ? q_sat + 1 : tlim;
      if (q < t) {
        ch_e[p + q] = (long long)ws.pos;
        sc_e[p + q] = val;
        ny_e[p + q] = hs.ny;
      }
      if (q == 0) {
        run_t = t;
        run_sat = has_sat ? 1 : 0;
      }
    }
    __syncthreads();
    const int t = run_t;
    if (tid == w) s.j += t;
    if (run_sat) {
      refill_shift<T, NW>(s, w, cm, C, W, cursor, stage, nullptr, 0);
      ++cursor;
    }
    p += t;
    __syncthreads();                    // run_t / win_* reused next run
  }

  // past the last run: (-1, best head score, n_yielded) of the frozen state
  const HeadState<T> hs =
      head_state<T, NW>(s, ask_cpu, ask_mem, count, L, salg, wsum);
  Key<T> k;
  k.eff = hs.sel.yielded ? hs.f0 : neg_inf<T>();
  k.order = hs.sel.order;
  k.idx = tid;
  k.y = hs.sel.yielded ? 1 : 0;
  const Key<T> best = block_best<T, NW>(k, red);
  const T fill = hs.ny > 0 ? best.eff : neg_inf<T>();
  for (int q = p + tid; q < P; q += B) {
    ch_e[q] = -1;
    sc_e[q] = fill;
    ny_e[q] = hs.ny;
  }
}

template <typename T>
int launch(const T* compact, const T* scal_f, const int* scal_i,
           long long* chosen, T* scores, long long* n_yielded, int E, int C,
           int W, int B, int spread_alg, cudaStream_t stream) {
  if (E <= 0) return 0;
  if (W < 8 || C <= B) return (int)cudaErrorInvalidValue;
  if (B == 32) {
    wave_block_kernel<T, 1><<<E, 32, 0, stream>>>(
        compact, scal_f, scal_i, chosen, scores, n_yielded, C, W,
        spread_alg);
  } else if (B == 128) {
    wave_block_kernel<T, 4><<<E, 128, 0, stream>>>(
        compact, scal_f, scal_i, chosen, scores, n_yielded, C, W,
        spread_alg);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The packed entry point (kernels.Kernel.launch): 3 inputs and 3 outputs
// as device pointers, then E C W B spread_alg.
template <typename T>
int launch_packed(void* const* p, int n_ptrs, const int* d, int n_dims,
                  cudaStream_t stream) {
  if (n_ptrs != 6 || n_dims != 5) return (int)cudaErrorInvalidValue;
  return launch<T>((const T*)p[0], (const T*)p[1], (const int*)p[2],
                   (long long*)p[3], (T*)p[4], (long long*)p[5], d[0], d[1],
                   d[2], d[3], d[4], stream);
}

}  // namespace

extern "C" int nt_wave_block_f32(void* const* ptrs, int n_ptrs,
                                 const int* dims, int n_dims, void* stream) {
  return launch_packed<float>(ptrs, n_ptrs, dims, n_dims,
                              (cudaStream_t)stream);
}

extern "C" int nt_wave_block_f64(void* const* ptrs, int n_ptrs,
                                 const int* dims, int n_dims, void* stream) {
  return launch_packed<double>(ptrs, n_ptrs, dims, n_dims,
                               (cudaStream_t)stream);
}
