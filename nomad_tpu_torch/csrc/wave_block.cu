// Run-block wavefront kernel for NVIDIA Hopper (sm_90a).
//
// Replaces nomad_tpu/solver/binpack.py::_solve_wave_block_impl, the XLA
// program jitted in _wave_compact_program and vmapped over the E lanes of
// a fused dispatch. It takes lanes with no spreads and no reschedule
// penalties, the shape of every headline lane.
//
// Design: one warp per lane (grid = E, 32 threads), window slot k =
// 32 r + lane in register word r (B = 32 or 128), each slot's compact
// row, copies taken j and cached head (fit and score f0) in registers.
// One loop iteration is one run decision, with no block barrier: the
// window from two ballots a word (wave_warp.cuh warp_select), the winner
// and the frozen runner-up from two redux.sync each (warp_best), then
// lanes 2q and 2q + 1 (q < K = 15) evaluate the winner's (j_w + q + 1)-th
// stream value, its cpu pow on one lane and its memory pow on the other,
// and lanes 30 and 31 the head of the next refill row. A ballot of the
// stop conditions (loses to the runner-up, crosses the skip
// threshold, runs out of capacity or of placements) and __ffs give the
// run length t; the t picks go out in one coalesced store. The winner's
// new head is the stream value at q = t (the same expressions as
// head_terms and final_score, in the same order), so no decision
// recomputes a head; a run of the full K computes it once. Saturation
// shifts the slots left by shuffles and the last slot takes the next
// compact row, loaded one refill ahead, with the head lanes 30 and 31
// scored. The outputs are written directly; the TPU program's one-hot
// matmul expansion of run records has no counterpart here.
//
// Bound: the run decisions of a lane form one dependency chain (about
// P / 7 at the headline shape), so the kernel is latency-bound on it; its
// bytes (the compact table once, the outputs once) would take about a
// microsecond at 3.35 TB/s.
#include "wave_warp.cuh"

namespace {

using namespace nt;

// Run width: the stream takes two lanes a value (its two pows side by
// side) and the last pair scores the next refill row's head (the plain
// version's outputs are the same for every run width K >= 1).
constexpr int kK = 15;

// The cached head of a slot at its j: fit and the score f0 (the
// per-placement step's head, no spreads, no penalties).
template <typename T>
__device__ __forceinline__ T head_f0(const Slot<T>& s, T ask_cpu, T ask_mem,
                                     T count, bool salg, bool& fit) {
  const Head<T> h = head_terms<T>(s, ask_cpu, ask_mem, count, salg);
  T nsc = T(1) + (h.coll > T(0) ? T(1) : T(0));
  nsc = nsc + (s.aff != T(0) ? T(1) : T(0));
  fit = h.fit;
  return final_score<T>(h.binpack, h.anti + s.aff, nsc);
}

template <typename T, int R>
__global__ void __launch_bounds__(32)
wave_block_kernel(const T* __restrict__ compact,
                  const T* __restrict__ scal_f,
                  const int* __restrict__ scal_i,
                  long long* __restrict__ chosen, T* __restrict__ scores,
                  long long* __restrict__ n_yielded, int C, int W,
                  int spread_alg) {
  constexpr int B = 32 * R;
  constexpr int kLogB = R == 1 ? 5 : 7;
  static_assert(R == 1 || R == 4, "B must be 32 or 128");
  const int e = blockIdx.x, lane = threadIdx.x;
  const int P = C - B;
  const T* cm = compact + (size_t)e * C * W;
  const T ask_cpu = scal_f[e * 3 + 0], ask_mem = scal_f[e * 3 + 1];
  const T count = scal_f[e * 3 + 2];
  const int L = scal_i[e * 2 + 0], n_active = scal_i[e * 2 + 1];
  long long* ch_e = chosen + (size_t)e * P;
  T* sc_e = scores + (size_t)e * P;
  long long* ny_e = n_yielded + (size_t)e * P;
  const bool salg = spread_alg != 0;

  Slot<T> s[R];
  T f0[R];
  bool fit[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    load_row(s[r], cm + (size_t)(32 * r + lane) * W);
    f0[r] = head_f0<T>(s[r], ask_cpu, ask_mem, count, salg, fit[r]);
  }
  // the next refill row (row min(cursor, C - 1)), loaded one refill ahead
  int cursor = B;
  Slot<T> nx;
  load_row(nx, cm + (size_t)min(cursor, C - 1) * W);
  int p = 0;
  NT_TOTAL_T0();
  NT_T0();

  while (p < n_active) {
    NT_RESET();
    NT_CNT(7, 1);
    bool low[R], y[R];
    int order[R];
#pragma unroll
    for (int r = 0; r < R; ++r) low[r] = fit[r] && f0[r] <= T(0);
    NT_CLK(0);
    const int ny = warp_select<R>(fit, low, L, y, order);
    NT_CLK(1);
    if (ny == 0) break;                 // nothing yields: frozen from here
    const int io = warp_best<T, R>(f0, y, order);
    const int w = io & (B - 1), rw = w >> 5, lw = w & 31;
    const int win_order = io >> kLogB;
    // frozen runner-up: best other head, ties to the smallest order (over
    // every slot, as the reference's masked max/min are: non-yielded
    // heads and the winner at -inf)
    T eff_o[R];
    bool all[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      eff_o[r] = y[r] && 32 * r + lane != w ? f0[r] : neg_inf<T>();
      all[r] = true;
    }
    const int ro = warp_best<T, R>(eff_o, all, order);
    const T rub = __shfl_sync(kFull, pick(eff_o, (ro & (B - 1)) >> 5),
                              ro & 31);
    const int ru_order = ro >> kLogB;
    NT_CLK(2);

    const Slot<T> ws = shfl_slot(pick(s, rw), lw);
    const bool low_w = __shfl_sync(kFull, (int)pick(low, rw), lw) != 0;
    const T j_wf = (T)ws.j, order_wf = (T)win_order;
    // lanes 2q and 2q + 1 (q < K): the stream value of the winner's
    // (j_w + q + 1)-th placement, its cpu pow on the even lane and its
    // memory pow on the odd one; lanes 30 and 31: the head of row nx at
    // j = 0 (the same expressions: the head at j is the stream value at j)
    const int q = lane >> 1;
    const bool mem = lane & 1;
    const bool ref = q == kK;
    const Slot<T> sq = ref ? nx : ws;
    const T jq = ref ? T(0) : j_wf + (T)q;
    const bool validw = jq < sq.c;
    const T jp1q = jq + T(1);
    const T nu = (mem ? sq.umem : sq.ucpu) + jp1q * (mem ? ask_mem : ask_cpu);
    const T pw = pow10<T>(T(1) - nu / vmax(mem ? sq.mcap : sq.ccap, T(1e-9)));
    const T total = __shfl_sync(kFull, pw, lane & ~1) +
                    __shfl_sync(kFull, pw, lane | 1);
    T bpq = salg ? total - T(2) : T(20) - total;
    bpq = bpq < T(0) ? T(0) : bpq;
    bpq = bpq > T(18) ? T(18) : bpq;
    const T collq = sq.placed + jq;
    const T antiq = anti_term<T>(collq, count);
    const T nscq = (T(1) + (collq > T(0) ? T(1) : T(0))) +
                   (sq.aff != T(0) ? T(1) : T(0));
    const T val = final_score<T>(bpq, antiq + sq.aff, nscq);
    const bool win_q = val > rub ||
                       (val == rub && order_wf < (T)ru_order) || q == 0;
    const bool cross = (low_w ? val > T(0) : val <= T(0)) && q > 0;
    const bool stop = ref || !validw || !win_q || cross || q >= n_active - p;
    const unsigned mask = __ballot_sync(kFull, stop) & 0x55555555u;
    const int tlim = (__ffs(mask) - 1) >> 1;  // q = K always stops
    const int q_sat = (int)(ws.c - T(1) - j_wf);
    const bool has_sat = q_sat < kK && q_sat < tlim;
    const int t = has_sat ? q_sat + 1 : tlim;
    if (!mem && q < t) {
      ch_e[p + q] = (long long)ws.pos;
      sc_e[p + q] = val;
      ny_e[p + q] = ny;
    }
    p += t;
    if (!has_sat) {
      // the winner's new head: the stream value at q = t
      Slot<T> wn = ws;
      wn.j += t;
      bool fit_n;
      T f0_n;
      if (t < kK) {
        f0_n = __shfl_sync(kFull, val, 2 * t);
        fit_n = __shfl_sync(kFull, (int)validw, 2 * t) != 0;
      } else {
        f0_n = head_f0<T>(wn, ask_cpu, ask_mem, count, salg, fit_n);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r == rw && lane == lw) {
          s[r].j = wn.j;
          f0[r] = f0_n;
          fit[r] = fit_n;
        }
      NT_CLK(3);
      continue;
    }
    NT_CLK(3);
    // saturation: shift the slots above w left; the last takes nx
    const T f0_x = __shfl_sync(kFull, val, 2 * kK);
    const bool fit_x = __shfl_sync(kFull, (int)validw, 2 * kK) != 0;
    warp_shift<R>(s, w, nx);
    warp_shift<R>(f0, w, f0_x);
    warp_shift<R>(fit, w, fit_x);
    NT_CLK(4);
    ++cursor;
    load_row(nx, cm + (size_t)min(cursor, C - 1) * W);
    NT_CLK(5);
    NT_CNT(8, 1);
  }

  // past the last run: (-1, best head score, n_yielded) of the frozen state
  bool low[R], y[R];
  int order[R];
#pragma unroll
  for (int r = 0; r < R; ++r) low[r] = fit[r] && f0[r] <= T(0);
  const int ny = warp_select<R>(fit, low, L, y, order);
  T fill = neg_inf<T>();
  if (ny > 0) {
    const int io = warp_best<T, R>(f0, y, order);
    const int w = io & (B - 1);
    fill = __shfl_sync(kFull, pick(f0, w >> 5), w & 31);
  }
  for (int q = p + lane; q < P; q += 32) {
    ch_e[q] = -1;
    sc_e[q] = fill;
    ny_e[q] = ny;
  }
  NT_TOTAL(6);
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
    wave_block_kernel<T, 4><<<E, 32, 0, stream>>>(
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

NT_STEP_CLOCKS_EXPORT

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
