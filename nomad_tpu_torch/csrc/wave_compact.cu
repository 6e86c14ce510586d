// Per-placement wavefront kernel for NVIDIA Hopper (sm_90a).
//
// Replaces nomad_tpu/solver/binpack.py::_solve_wave_compact_impl (with
// _spread_boosts), the XLA program jitted in _wave_compact_program and
// vmapped over the E lanes of a fused dispatch.
//
// Design: the step loop is wave_compact_kernel in wave_warp.cuh (shared
// with the in-kernel wavefront, wavefront.cu); this file launches it over
// host-built compact tables (grid = E): one thread per window slot, one
// step warp per lane at B = 32 and four at B = 128, plus a head warp.
// Each step scores every slot from its cached head terms, finds the
// window with two ballots and the winner with two redux.sync in each
// warp (at B = 128 the warps add their counts, then their best slots,
// through shared memory: two named barriers a step), and takes the
// winner's new head from the head warp, which scores each slot's head at
// its next j one commit ahead. No step waits on a load: penalties arrive
// a chunk of 32 steps ahead, the next refill row one refill ahead, and
// outputs leave 32 steps a store. Spread value indexes ride in the
// slots' registers (the first kMaxSpreads; the rest are read from the
// slot's compact row); the spread counts sit in shared memory, one copy,
// and the desired counts beside them where both fit (else target spreads
// read them through the read-only cache, so any V whose counts fit runs:
// ~55,000 values for one spread). One warp holding all 128 slots (four a
// thread) was slower on the spread lanes, whose score is four slots of
// divisions a thread (PERF.md).
//
// Bound: a lane's P steps form one dependency chain (the score's
// division, ballots, redux, and the commit's hand-off to the head warp,
// whose head is two powf and three divisions), so the kernel is
// latency-bound on that chain; its bytes (the compact table once, the
// outputs once) would take about a microsecond at 3.35 TB/s.
#include "wave_warp.cuh"

namespace {

using namespace nt;

template <typename T, int NW, int SM>
int launch_w(const T* compact, const T* scal_f, const int* scal_i,
             const int* pen, const int* sp_counts, const T* sp_desired,
             const unsigned char* sp_has_targets, const T* sp_weights,
             const T* sp_sum_weights, long long* chosen, T* scores,
             long long* n_yielded, int E, int C, int W, int S, int V,
             int spread_alg, cudaStream_t stream) {
  auto kern = wave_compact_kernel<T, NW, SM>;
  // the desired counts join the counts in shared memory where both fit
  // beside the kernel's static tables; else they are read from global
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kern);
  int dev = 0, optin = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int desired_smem =
      fa.sharedSizeBytes + dyn_smem<T>(S, V, true) <= (size_t)optin;
  const size_t smem = dyn_smem<T>(S, V, desired_smem);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<E, step_threads(NW), smem, stream>>>(
      compact, scal_f, scal_i, pen, sp_counts, sp_desired, sp_has_targets,
      sp_weights, sp_sum_weights, chosen, scores, n_yielded, C, W, S, V,
      spread_alg, desired_smem);
  return (int)cudaGetLastError();
}

template <typename T, int NW>
int launch_s(const T* compact, const T* scal_f, const int* scal_i,
             const int* pen, const int* sp_counts, const T* sp_desired,
             const unsigned char* sp_has_targets, const T* sp_weights,
             const T* sp_sum_weights, long long* chosen, T* scores,
             long long* n_yielded, int E, int C, int W, int S, int V,
             int spread_alg, cudaStream_t stream) {
  if (S == 0)
    return launch_w<T, NW, 0>(compact, scal_f, scal_i, pen, sp_counts,
                             sp_desired, sp_has_targets, sp_weights,
                             sp_sum_weights, chosen, scores, n_yielded, E,
                             C, W, S, V, spread_alg, stream);
  if (S <= 2)                 // faster than the 16-wide form here (PERF.md)
    return launch_w<T, NW, 2>(compact, scal_f, scal_i, pen, sp_counts,
                             sp_desired, sp_has_targets, sp_weights,
                             sp_sum_weights, chosen, scores, n_yielded, E,
                             C, W, S, V, spread_alg, stream);
  return launch_w<T, NW, kMaxSpreads>(
      compact, scal_f, scal_i, pen, sp_counts, sp_desired, sp_has_targets,
      sp_weights, sp_sum_weights, chosen, scores, n_yielded, E, C, W, S, V,
      spread_alg, stream);
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
    return launch_s<T, 1>(compact, scal_f, scal_i, pen, sp_counts,
                          sp_desired, sp_has_targets, sp_weights,
                          sp_sum_weights, chosen, scores, n_yielded, E, C,
                          W, S, V, spread_alg, stream);
  if (B == 128)
    return launch_s<T, 4>(compact, scal_f, scal_i, pen, sp_counts,
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

NT_STEP_CLOCKS_EXPORT

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
