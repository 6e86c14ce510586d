// Delta scatter for NVIDIA Hopper (sm_90a).
//
// Replaces nomad_tpu/solver/constcache.py::_delta_scatter_program, the XLA
// program that promotes a device-resident table by one journal-covered
// generation: out = a copy of buf with out.flat[idx[i]] = vals[i]. The base
// is never written (it may still be a content-cache entry, or an input of a
// dispatch in flight).
//
// The scatter moves raw bits, so there is one entry point per element size
// (1, 2, 4 and 8 bytes) and no float load or store anywhere: -0.0 and NaN
// payloads reach the output exactly as a wholesale copy would carry them.
// Two kernels, launched back to back on the caller's stream:
//   1. copy  -- buf to out, 16 bytes per thread per iteration when both
//               pointers are 16-byte aligned (a grid-stride loop), the
//               tail (and unaligned buffers) element by element;
//   2. apply -- one thread per update. The update count is padded to a
//               power of two by repeating slot 0, so duplicate indices
//               carry identical values and their racing writes agree.
// Indices outside [0, M) are dropped, as the reference's scatter drops them.
//
// Bound: the copy reads and writes the M elements once and the apply reads
// the k (idx, vals) pairs: (2 M s + k (4 + s)) bytes at 3.35 TB/s.
//
// The coordinate entry points (nt_coord_scatter_*) replace
// nomad_tpu/parallel/mesh.py::mesh_delta_scatter_fn, the same promotion
// of a table sharded over an (evals, nodes) grid: each cell's slice (up to
// 4 axes, beginning at `start` in the whole table) is copied, then every
// update whose coordinates (coords[ndim, k], whole-table, replicated to
// every cell) fall inside the slice is written at its local position; the
// others belong to other cells. Per cell the bound is (2 M_cell s +
// k (4 ndim + s)) bytes: every cell reads the whole replicated payload.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;      // H100 SXM: 132 SMs

template <typename U>
__global__ void __launch_bounds__(kThreads)
copy_kernel(const U* __restrict__ src, U* __restrict__ dst, long long m,
            int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    // whole 16-byte words first
    const long long n16 = (m * (long long)sizeof(U)) / 16;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (long long i = t0; i < n16; i += stride) d4[i] = s4[i];
    done = n16 * 16 / (long long)sizeof(U);
  }
  for (long long i = done + t0; i < m; i += stride) dst[i] = src[i];
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const int* __restrict__ idx, const U* __restrict__ vals,
             U* __restrict__ out, int k, long long m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const int j = idx[i];
  if (j >= 0 && (long long)j < m) out[j] = vals[i];
}

template <typename U>
int launch(const U* buf, const int* idx, const U* vals, U* out, long long m,
           int k, cudaStream_t stream) {
  if (m < 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (m > 0) {
    const int vec = ((reinterpret_cast<uintptr_t>(buf) |
                      reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    const long long units =
        vec ? (m * (long long)sizeof(U) + 15) / 16 : m;
    long long blocks = (units + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    copy_kernel<U><<<(int)blocks, kThreads, 0, stream>>>(buf, out, m, vec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (k > 0) {
    apply_kernel<U><<<(k + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        idx, vals, out, k, m);
  }
  return (int)cudaGetLastError();
}

struct Dims4 {
  long long v[4];
};

template <typename U>
__global__ void __launch_bounds__(kThreads)
coord_apply_kernel(const int* __restrict__ coords,
                   const U* __restrict__ vals, U* __restrict__ out,
                   int ndim, int k, Dims4 shape, Dims4 start) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= k) return;
  long long flat = 0;
  for (int d = 0; d < ndim; ++d) {
    const long long c = (long long)coords[(size_t)d * k + u] - start.v[d];
    if (c < 0 || c >= shape.v[d]) return;        // another cell's update
    flat = flat * shape.v[d] + c;
  }
  out[flat] = vals[u];
}

// The coordinate entry point: part coords vals out as device pointers,
// then ndim k, the slice's shape (4 ints, 1 past ndim) and its start in
// the whole table (4 ints, 0 past ndim).
template <typename U>
int launch_coords(void* const* p, int n_ptrs, const int* d, int n_dims,
                  cudaStream_t stream) {
  if (n_ptrs != 4 || n_dims != 10) return (int)cudaErrorInvalidValue;
  const int ndim = d[0], k = d[1];
  if (ndim < 1 || ndim > 4 || k < 0) return (int)cudaErrorInvalidValue;
  Dims4 shape, start;
  long long m = 1;
  for (int i = 0; i < 4; ++i) {
    shape.v[i] = d[2 + i];
    start.v[i] = d[6 + i];
    if (shape.v[i] < 0 || (i >= ndim && shape.v[i] != 1))
      return (int)cudaErrorInvalidValue;
    m *= shape.v[i];
  }
  const U* part = (const U*)p[0];
  U* out = (U*)p[3];
  // the copy (and nothing else) through the flat scatter's launcher
  int rc = launch<U>(part, nullptr, nullptr, out, m, 0, stream);
  if (rc != 0 || k == 0) return rc;
  coord_apply_kernel<U><<<(k + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>((const int*)p[1], (const U*)p[2], out,
                                    ndim, k, shape, start);
  return (int)cudaGetLastError();
}

// The packed entry point (kernels.Kernel.launch): buf idx vals out as
// device pointers, then M k.
template <typename U>
int launch_packed(void* const* p, int n_ptrs, const int* d, int n_dims,
                  cudaStream_t stream) {
  if (n_ptrs != 4 || n_dims != 2) return (int)cudaErrorInvalidValue;
  return launch<U>((const U*)p[0], (const int*)p[1], (const U*)p[2],
                   (U*)p[3], (long long)d[0], d[1], stream);
}

}  // namespace

extern "C" int nt_delta_scatter_1(void* const* ptrs, int n_ptrs,
                                  const int* dims, int n_dims,
                                  void* stream) {
  return launch_packed<uint8_t>(ptrs, n_ptrs, dims, n_dims,
                                (cudaStream_t)stream);
}

extern "C" int nt_delta_scatter_2(void* const* ptrs, int n_ptrs,
                                  const int* dims, int n_dims,
                                  void* stream) {
  return launch_packed<uint16_t>(ptrs, n_ptrs, dims, n_dims,
                                 (cudaStream_t)stream);
}

extern "C" int nt_delta_scatter_4(void* const* ptrs, int n_ptrs,
                                  const int* dims, int n_dims,
                                  void* stream) {
  return launch_packed<uint32_t>(ptrs, n_ptrs, dims, n_dims,
                                 (cudaStream_t)stream);
}

extern "C" int nt_delta_scatter_8(void* const* ptrs, int n_ptrs,
                                  const int* dims, int n_dims,
                                  void* stream) {
  return launch_packed<unsigned long long>(ptrs, n_ptrs, dims, n_dims,
                                           (cudaStream_t)stream);
}

extern "C" int nt_coord_scatter_1(void* const* ptrs, int n_ptrs,
                                  const int* dims, int n_dims,
                                  void* stream) {
  return launch_coords<uint8_t>(ptrs, n_ptrs, dims, n_dims,
                                (cudaStream_t)stream);
}

extern "C" int nt_coord_scatter_2(void* const* ptrs, int n_ptrs,
                                  const int* dims, int n_dims,
                                  void* stream) {
  return launch_coords<uint16_t>(ptrs, n_ptrs, dims, n_dims,
                                 (cudaStream_t)stream);
}

extern "C" int nt_coord_scatter_4(void* const* ptrs, int n_ptrs,
                                  const int* dims, int n_dims,
                                  void* stream) {
  return launch_coords<uint32_t>(ptrs, n_ptrs, dims, n_dims,
                                 (cudaStream_t)stream);
}

extern "C" int nt_coord_scatter_8(void* const* ptrs, int n_ptrs,
                                  const int* dims, int n_dims,
                                  void* stream) {
  return launch_coords<unsigned long long>(ptrs, n_ptrs, dims, n_dims,
                                           (cudaStream_t)stream);
}
