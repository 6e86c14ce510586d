// Run-block wavefront kernel for NVIDIA Hopper (sm_90a).
//
// Replaces nomad_tpu/solver/binpack.py::_solve_wave_block_impl, the XLA
// program jitted in _wave_compact_program and vmapped over the E lanes of
// a fused dispatch. It takes lanes with no spreads and no reschedule
// penalties, the shape of every headline lane.
//
// Design (the loop is wave_warp.cuh wave_block_lane, which wavefront.cu
// also runs on its penalty-free lanes): one warp per lane (grid = E, 32
// threads), window slot k = 32 r + lane in register word r (B = 32 or
// 128), each slot's compact row, copies taken j and cached head (fit and
// score f0) in registers.
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

template <typename T, int R>
__global__ void __launch_bounds__(32)
wave_block_kernel(const T* __restrict__ compact,
                  const T* __restrict__ scal_f,
                  const int* __restrict__ scal_i,
                  long long* __restrict__ chosen, T* __restrict__ scores,
                  long long* __restrict__ n_yielded, int C, int W,
                  int spread_alg) {
  wave_block_lane<T, R>(compact, scal_f, scal_i, chosen, scores, n_yielded,
                        C, W, spread_alg, blockIdx.x);
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
