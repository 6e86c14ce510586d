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
// Bound: it reads each input once and writes each output once, ~30-60
// bytes a node, with ~20 floating-point operations a node, so it is
// bound by bytes; at the system eval's 16,384 nodes that is 0.2 us, far
// under the launch itself.
//
// Design: the work is too small to fill the card for long, so the kernel
// aims at the launch floor: many short threads, every SM busy.
//   * One node a thread, its ~17 loads independent and in flight at once
//     (read-only path). Two or four nodes a thread with 8- and 16-byte
//     loads measured slower on the H100 at the system lane's E 1 x N
//     16,384 and at E 1 x N 32 (PERF.md, PR 10): at this size a thread's
//     chain of divisions and pows, not the loads, sets the time.
//   * The block shrinks from 128 threads toward 32 until the grid covers
//     every SM (E 1 x N 16,384: 256 blocks of 64).
//   * The per-node arithmetic is dense_common.cuh's, shared with the
//     dense scan kernel, so the bits are the plain version's.
//   * Its arguments travel as one struct (SystemArgs).
// The wrapper (solver/system.py) points fit and score into one output
// buffer on solve_system's path, so the caller reads both back with one
// copy.
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

// The ask of lane e (row 0 of its batch), the same for every node
template <typename T> struct Ask {
  T cpu, mem, disk;
  int n_dyn, cores;
  bool has_static;
};

template <typename T>
__device__ __forceinline__ Ask<T> lane_ask(const SystemArgs<T>& A,
                                           size_t e) {
  const size_t row0 = e * A.P;
  Ask<T> a;
  a.cpu = __ldg(A.ask_cpu + row0);
  a.mem = __ldg(A.ask_mem + row0);
  a.disk = __ldg(A.ask_disk + row0);
  a.n_dyn = __ldg(A.n_dyn + row0);
  a.has_static = __ldg(A.has_static + row0) != 0;
  a.cores = A.has_cores ? __ldg(A.ask_cores + row0) : 0;
  return a;
}

// One node's fit and score from its loaded table entries
template <typename T>
__device__ __forceinline__ void fit_node(const Ask<T>& a, bool has_cores,
                                         bool spread_alg, T ccap, T mcap,
                                         T dcap, bool feas, T mhz, T ucpu,
                                         T umem, T udisk, bool sfree,
                                         int dyn, int cfree, u8& fit,
                                         T& score) {
  const T eff_cpu = eff_cpu_ask<T>(a.cpu, a.cores, has_cores ? mhz : T(0),
                                   has_cores);
  bool f = feas && dyn >= a.n_dyn && (sfree || !a.has_static);
  if (has_cores) f = f && cfree >= a.cores;
  f = f && fits_resources<T>(ucpu, umem, udisk, ccap, mcap, dcap, eff_cpu,
                             a.mem, a.disk);
  fit = f ? 1 : 0;
  score = binpack_after<T>(ucpu, umem, ccap, mcap, eff_cpu, a.mem,
                           spread_alg) *
          (T(1) / T(18));
}

// One node a thread: every load of the thread is independent, so all are
// in flight at once
template <typename T>
__global__ void system_fit_kernel(const SystemArgs<T> A) {
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (size_t)A.E * A.N) return;
  const bool hc = A.has_cores != 0;
  const Ask<T> a = lane_ask(A, k / A.N);
  fit_node<T>(a, hc, A.spread_alg != 0, __ldg(A.cpu_cap + k),
              __ldg(A.mem_cap + k), __ldg(A.disk_cap + k),
              __ldg(A.feasible + k) != 0,
              hc ? __ldg(A.mhz_per_core + k) : T(0), __ldg(A.used_cpu + k),
              __ldg(A.used_mem + k), __ldg(A.used_disk + k),
              __ldg(A.static_free + k) != 0, __ldg(A.dyn_avail + k),
              hc ? __ldg(A.cores_free + k) : 0, A.fit[k], A.score[k]);
}

constexpr int kMaxThreads = 128;
constexpr int kMinThreads = 32;
constexpr int kTables = 17;     // SYSTEM_ARGS in solver/system.py
constexpr int kOutputs = 2;     // fit, score
constexpr int kDims = 5;        // E N P has_cores spread_alg

// The SM count of the current device, read once per device
int sm_count(int* sms) {
  static int cache[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    cache[dev] = n;
  }
  *sms = cache[dev];
  return 0;
}

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
  int sms = 0;
  int rc = sm_count(&sms);
  if (rc != 0) return rc;
  int threads = kMaxThreads;
  while (threads > kMinThreads &&
         (total + threads - 1) / threads < (size_t)sms)
    threads /= 2;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  system_fit_kernel<T><<<blocks, threads, 0, stream>>>(a);
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
