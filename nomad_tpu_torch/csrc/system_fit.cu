// System-job fit kernel for NVIDIA Hopper (sm_90a).
//
// Replaces nomad_tpu/solver/binpack.py::_solve_system_impl: each node is
// fit and scored on its own against the initial usage (a system eval runs
// one Stack.Select per node, scheduler_system.go), with row 0 of the
// placement batch as the ask. Fit covers feasibility, dynamic and static
// ports, reserved cores and cpu/mem/disk; the score is the binpack
// fitness alone, clip(raw) / 18, which XLA lowers to a multiply by the
// rounded reciprocal (no add follows, so nothing is fused).
//
// Design: one thread per (eval, node), an elementwise pass. The per-node
// arithmetic is dense_common.cuh's, shared with the dense scan kernel.
//
// Bound: it reads each input once and writes each output once, ~30-60
// bytes a node, with ~20 floating-point operations a node, so it is
// bound by bytes (and at 10,000 nodes, by the launch itself).
#include "dense_common.cuh"

namespace {

using namespace nt;

typedef unsigned char u8;

template <typename T> struct SystemArgs {
  const T *cpu_cap, *mem_cap, *disk_cap;
  const u8* feasible;
  const T* mhz_per_core;
  const T *used_cpu, *used_mem, *used_disk;
  const u8* static_free;
  const int *dyn_avail, *cores_free;
  const T *ask_cpu, *ask_mem, *ask_disk;     // (E, P): row 0 is read
  const int* n_dyn;
  const u8* has_static;
  const int* ask_cores;
  u8* fit;
  T* score;
  int E, N, P, has_cores, spread_alg;
};

template <typename T>
__global__ void system_fit_kernel(const SystemArgs<T> A) {
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (size_t)A.E * A.N) return;
  const size_t e = k / A.N, row0 = e * A.P;
  const bool has_cores = A.has_cores != 0;
  const int cores = has_cores ? A.ask_cores[row0] : 0;
  const T eff_cpu = eff_cpu_ask<T>(A.ask_cpu[row0], cores,
                                   has_cores ? A.mhz_per_core[k] : T(0),
                                   has_cores);
  const T ucpu = A.used_cpu[k], umem = A.used_mem[k];
  const T ccap = A.cpu_cap[k], mcap = A.mem_cap[k];
  const T ask_mem = A.ask_mem[row0];
  bool fit = A.feasible[k] && A.dyn_avail[k] >= A.n_dyn[row0] &&
             (A.static_free[k] || !A.has_static[row0]);
  if (has_cores) fit = fit && A.cores_free[k] >= cores;
  fit = fit && fits_resources<T>(ucpu, umem, A.used_disk[k], ccap, mcap,
                                 A.disk_cap[k], eff_cpu, ask_mem,
                                 A.ask_disk[row0]);
  A.fit[k] = fit ? 1 : 0;
  A.score[k] = binpack_after<T>(ucpu, umem, ccap, mcap, eff_cpu, ask_mem,
                                A.spread_alg != 0) *
               (T(1) / T(18));
}

constexpr int kThreads = 256;
constexpr int kTables = 17;     // SYSTEM_ARGS in solver/system.py
constexpr int kOutputs = 2;     // fit, score
constexpr int kDims = 5;        // E N P has_cores spread_alg

template <typename T>
int launch(void* const* p, int n_ptrs, const int* d, int n_dims,
           cudaStream_t stream) {
  if (n_ptrs != kTables + kOutputs || n_dims != kDims)
    return (int)cudaErrorInvalidValue;
  SystemArgs<T> a;
  int k = 0;
  a.cpu_cap = (const T*)p[k++]; a.mem_cap = (const T*)p[k++];
  a.disk_cap = (const T*)p[k++]; a.feasible = (const u8*)p[k++];
  a.mhz_per_core = (const T*)p[k++];
  a.used_cpu = (const T*)p[k++]; a.used_mem = (const T*)p[k++];
  a.used_disk = (const T*)p[k++]; a.static_free = (const u8*)p[k++];
  a.dyn_avail = (const int*)p[k++]; a.cores_free = (const int*)p[k++];
  a.ask_cpu = (const T*)p[k++]; a.ask_mem = (const T*)p[k++];
  a.ask_disk = (const T*)p[k++]; a.n_dyn = (const int*)p[k++];
  a.has_static = (const u8*)p[k++]; a.ask_cores = (const int*)p[k++];
  a.fit = (u8*)p[k++]; a.score = (T*)p[k++];
  a.E = d[0]; a.N = d[1]; a.P = d[2]; a.has_cores = d[3];
  a.spread_alg = d[4];
  const size_t total = (size_t)a.E * a.N;
  if (total == 0) return 0;
  if (a.P <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  system_fit_kernel<T><<<blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nt_system_fit_f32(void* const* ptrs, int n_ptrs,
                                 const int* dims, int n_dims, void* stream) {
  return launch<float>(ptrs, n_ptrs, dims, n_dims, (cudaStream_t)stream);
}

extern "C" int nt_system_fit_f64(void* const* ptrs, int n_ptrs,
                                 const int* dims, int n_dims, void* stream) {
  return launch<double>(ptrs, n_ptrs, dims, n_dims, (cudaStream_t)stream);
}
