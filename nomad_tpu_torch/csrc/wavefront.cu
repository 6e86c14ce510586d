// In-kernel wavefront for NVIDIA Hopper (sm_90a).
//
// Replaces nomad_tpu/solver/binpack.py::_solve_wavefront_impl (jitted as
// solve_wavefront): a uniform-ask lane's placement with the per-node
// capacities, the fit order and the compact table all computed on the
// device, then the per-placement wave step. S == 0 (no spread columns) and
// B = WAVE_B = 32, as in the reference; reschedule penalties and
// affinities are scored.
//
// Two kernels, launched back to back on the caller's stream:
//   1. prep -- one block of 1,024 threads per lane. Each thread owns a
//      contiguous run of nodes and computes each node's capacity c, the
//      largest m with used0 + m * ask <= cap in every dimension, with the
//      reference's float predicate and its +-2 integer correction, then
//      the port, static-port, distinct_hosts and feasibility caps, and
//      clip(c, 0, P). A block prefix count over the threads' fit counts
//      gives each fit node (c > 0) its rank in shuffled order; the first
//      C = P + B of them are written as compact rows [c, used_cpu,
//      used_mem, cpu_cap, mem_cap, placed, affinity, pos], and the rows
//      past the last fit node repeat node N-1's row with c = 0, pos = N.
//      Thread 0 writes the lane scalars (asks, count, limit, n_active).
//   2. steps -- wave_compact_kernel (wave_warp.cuh) over those tables,
//      the step loop the per-placement wave kernel runs (a step warp
//      and a head warp a lane).
//
// Integer and float semantics follow XLA's lowering of the reference:
// floor(q) -> int32 saturates (NaN -> 0), int32 adds wrap, the
// dynamic-port cap is a floor division, and the capacity predicate's
// used0 + m * ask is one fused multiply-add.
//
// Bound: the prep pass reads the node tables once and writes the compact
// table; the step loop is a dependency chain of P warp-synchronous steps
// (latency-bound, as wave_compact is).
#include "wave_warp.cuh"

namespace {

using namespace nt;

constexpr int kPrepWarps = 32;
constexpr int kPrepThreads = 32 * kPrepWarps;
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

template <typename T>
__global__ void __launch_bounds__(kPrepThreads)
wavefront_prep_kernel(LaneIn<T> in, T* __restrict__ compact,
                      T* __restrict__ scal_f, int* __restrict__ scal_i,
                      int N, int P) {
  __shared__ int wsum[kPrepWarps];
  const int e = blockIdx.x, tid = threadIdx.x;
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

  const int chunk = (N + kPrepThreads - 1) / kPrepThreads;
  const int lo = min(N, tid * chunk), hi = min(N, lo + chunk);
  int mine = 0;
  for (int n = lo; n < hi; ++n) mine += cap_of(n) > 0;
  int total;
  int k = block_scan<kPrepWarps>(mine, total, wsum) - mine;  // exclusive
  T* cm = compact + (size_t)e * C * 8;
  for (int n = lo; n < hi && k < C; ++n) {
    const int c = cap_of(n);
    if (c <= 0) continue;
    const size_t i = ln + n;
    T* row = cm + (size_t)k * 8;
    row[0] = (T)c;
    row[1] = in.used_cpu[i];
    row[2] = in.used_mem[i];
    row[3] = in.cpu_cap[i];
    row[4] = in.mem_cap[i];
    row[5] = (T)in.placed[i];
    row[6] = has_aff ? in.affinity[i] : T(0);
    row[7] = (T)n;
    ++k;
  }
  // rows past the fit list: node N-1's row, never fit (c = 0), pos = N
  const size_t last = ln + (N - 1);
  for (int r = min(total, C) + tid; r < C; r += kPrepThreads) {
    T* row = cm + (size_t)r * 8;
    row[0] = T(0);
    row[1] = in.used_cpu[last];
    row[2] = in.used_mem[last];
    row[3] = in.cpu_cap[last];
    row[4] = in.mem_cap[last];
    row[5] = (T)in.placed[last];
    row[6] = has_aff ? in.affinity[last] : T(0);
    row[7] = (T)N;
  }
  int act = 0;
  for (int p = tid; p < P; p += kPrepThreads) act += in.active[lp + p] != 0;
  int n_active;
  block_scan<kPrepWarps>(act, n_active, wsum);
  if (tid == 0) {
    scal_f[e * 3 + 0] = ask_cpu;
    scal_f[e * 3 + 1] = ask_mem;
    scal_f[e * 3 + 2] = (T)in.count[lp];
    scal_i[e * 2 + 0] = in.limit[lp];
    scal_i[e * 2 + 1] = n_active;
  }
}

template <typename T>
int launch_packed(void* const* p, int n_ptrs, const int* d, int n_dims,
                  cudaStream_t stream) {
  // 23 lane tables, penalty_idx, 3 scratch tables (compact, scal_f,
  // scal_i), 3 outputs; then E N P spread_alg
  if (n_ptrs != 30 || n_dims != 4) return (int)cudaErrorInvalidValue;
  const int E = d[0], N = d[1], P = d[2], spread_alg = d[3];
  if (E <= 0 || P <= 0) return 0;
  if (N <= 0) return (int)cudaErrorInvalidValue;
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
  wavefront_prep_kernel<T><<<E, kPrepThreads, 0, stream>>>(
      in, compact, scal_f, scal_i, N, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wave_compact_kernel<T, 1><<<E, step_threads(1), 0, stream>>>(
      compact, scal_f, scal_i, pen, nullptr, nullptr, nullptr, nullptr,
      nullptr, chosen, scores, n_yielded, P + kB, 8, 0, 1, spread_alg, 0);
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
