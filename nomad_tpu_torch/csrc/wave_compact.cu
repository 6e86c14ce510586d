// Per-placement wavefront kernel for NVIDIA Hopper (sm_90a).
//
// Replaces nomad_tpu/solver/binpack.py::_solve_wave_compact_impl (with
// _spread_boosts), the XLA program jitted in _wave_compact_program and
// vmapped over the E lanes of a fused dispatch.
//
// Design: the step loop is wave_compact_kernel in wave_common.cuh (shared
// with the in-kernel wavefront, wavefront.cu); this file launches it over
// host-built compact tables. One thread block per lane (grid = E), one
// thread per window slot (B = 32 or 128). A slot's compact row and copies-taken count j live in
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

namespace {

using namespace nt;

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
