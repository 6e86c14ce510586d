// Per-placement wavefront kernel for NVIDIA Hopper (sm_90a).
//
// Replaces nomad_tpu/solver/binpack.py::_solve_wave_compact_impl (with
// _spread_boosts), the XLA program jitted in _wave_compact_program and
// vmapped over the E lanes of a fused dispatch.
//
// Design: one thread block per lane (grid = E), one thread per window slot
// (B = 32 or 128). A slot's compact row and copies-taken count j live in
// registers; spread counts (S, V), desired (S, V) and the slots' spread
// value indexes (S, B) live in shared memory. Each placement step scores
// every slot, runs one block prefix scan over packed (low, fit) flags for
// the window emulation, one __syncthreads_count for n_yielded and one
// butterfly arg-best for the winner; the winner's thread bumps j and its
// spread counts; saturation shifts the slots left through shared memory
// and refills the last slot from global memory. Once a step places
// nothing the lane's state is frozen: later steps without a penalty repeat
// its output, steps with one are scored again (the penalty moves scores).
//
// Bound: a lane's P steps form one dependency chain, each step a few
// block barriers long, so the kernel is latency-bound on that chain; its
// bytes (the compact table once, the outputs once) would take about a
// microsecond at 3.35 TB/s.
#include "wave_common.cuh"

#include <climits>

namespace {

using namespace nt;

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

template <typename T, int NW>
int launch_nw(const T* compact, const T* scal_f, const int* scal_i,
              const int* pen, const int* sp_counts, const T* sp_desired,
              const unsigned char* sp_has_targets, const T* sp_weights,
              const T* sp_sum_weights, long long* chosen, T* scores,
              long long* n_yielded, int E, int C, int W, int S, int V,
              int spread_alg, cudaStream_t stream) {
  const size_t smem = dyn_smem<T>(S, V, 32 * NW);
  auto kern = wave_compact_kernel<T, NW>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<E, 32 * NW, smem, stream>>>(
      compact, scal_f, scal_i, pen, sp_counts, sp_desired, sp_has_targets,
      sp_weights, sp_sum_weights, chosen, scores, n_yielded, C, W, S, V,
      spread_alg);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* compact, const T* scal_f, const int* scal_i,
           const int* pen, const int* sp_counts, const T* sp_desired,
           const unsigned char* sp_has_targets, const T* sp_weights,
           const T* sp_sum_weights, long long* chosen, T* scores,
           long long* n_yielded, int E, int C, int W, int S, int V, int B,
           int spread_alg, cudaStream_t stream) {
  if (E <= 0) return 0;
  if (W != 8 + S || C <= B) return (int)cudaErrorInvalidValue;
  if (B == 32)
    return launch_nw<T, 1>(compact, scal_f, scal_i, pen, sp_counts,
                           sp_desired, sp_has_targets, sp_weights,
                           sp_sum_weights, chosen, scores, n_yielded, E, C,
                           W, S, V, spread_alg, stream);
  if (B == 128)
    return launch_nw<T, 4>(compact, scal_f, scal_i, pen, sp_counts,
                           sp_desired, sp_has_targets, sp_weights,
                           sp_sum_weights, chosen, scores, n_yielded, E, C,
                           W, S, V, spread_alg, stream);
  return (int)cudaErrorInvalidValue;
}

// The packed entry point (kernels.Kernel.launch): 9 inputs and 3 outputs
// as device pointers, then E C W S V B spread_alg.
template <typename T>
int launch_packed(void* const* p, int n_ptrs, const int* d, int n_dims,
                  cudaStream_t stream) {
  if (n_ptrs != 12 || n_dims != 7) return (int)cudaErrorInvalidValue;
  return launch<T>((const T*)p[0], (const T*)p[1], (const int*)p[2],
                   (const int*)p[3], (const int*)p[4], (const T*)p[5],
                   (const unsigned char*)p[6], (const T*)p[7],
                   (const T*)p[8], (long long*)p[9], (T*)p[10],
                   (long long*)p[11], d[0], d[1], d[2], d[3], d[4], d[5],
                   d[6], stream);
}

}  // namespace

extern "C" int nt_wave_compact_f32(void* const* ptrs, int n_ptrs,
                                   const int* dims, int n_dims,
                                   void* stream) {
  return launch_packed<float>(ptrs, n_ptrs, dims, n_dims,
                              (cudaStream_t)stream);
}

extern "C" int nt_wave_compact_f64(void* const* ptrs, int n_ptrs,
                                   const int* dims, int n_dims,
                                   void* stream) {
  return launch_packed<double>(ptrs, n_ptrs, dims, n_dims,
                               (cudaStream_t)stream);
}
