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
// Indices outside [0, M) are dropped, as the reference's scatter drops them.
//
// Bound: the copy reads and writes the M elements once and the updates read
// the k (idx, vals) pairs: (2 M s + k (4 + s)) bytes at 3.35 TB/s, 3.8 us
// for the residency path's 6.29 MB usage table.
//
// Design: one launch either way. The table is cut into chunks of kThreads
// x kInFlight units: 16-byte words when buf and out are both 16-byte
// aligned (the tail past the last whole word goes element by element with
// the last chunk), else elements. A thread issues its kInFlight loads of
// a chunk before their stores, neighbouring threads on neighbouring units.
//   * scatter_local (few updates): a block per chunk copies it, then
//     writes every update whose index lands in the chunk's elements. Each
//     block reads all k indices (no order is assumed), so the launcher
//     takes this form only while those reads past the first block's come
//     to at most a kLocalShare-th of the table's bytes: the residency
//     path's g3 (k 256 over 6.29 MB) is one. No grid-wide barrier.
//   * scatter_persistent (many updates, up to the chain's 25% of M): one
//     cooperative launch, every block resident at once
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count, at
//     most kBlocksPerSm a SM, no more than the work needs); the blocks
//     copy the chunks, one grid.sync() puts every copy before any update,
//     then the updates go grid-stride.
// An update count padded by repeating slot 0 (solver/resident.py
// _pad_updates) gives duplicate indices identical values, so their racing
// writes agree. So the promotion is one launch, not a copy kernel and an
// update kernel.
//
// The coordinate entry points (nt_coord_scatter_*) replace
// nomad_tpu/parallel/mesh.py::mesh_delta_scatter_fn, the same promotion
// of a table sharded over an (evals, nodes) grid: each cell's slice (up
// to 4 axes, beginning at `start` in the whole table) is copied, and
// every update whose coordinates (coords[ndim, k], whole-table,
// replicated to every cell) fall inside the slice is written at its
// local position; the others belong to other cells. One launch writes
// every cell of one card (up to kMaxCells): the block-local form over
// all of them, each block copying a chunk of one cell's slice, then
// writing the updates that land in that chunk; no second kernel and no
// grid-wide barrier. The payload reaches the card once for all its cells
// (solver/resident.py put_coord_payload). Bound, per card: (2 M_cell s
// n_cells + k (4 ndim + s)) bytes, each slice read and written once and
// the payload read once. The older form made two launches a cell (a
// copy kernel, then an update kernel) after two pageable uploads a cell.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;

namespace cg = cooperative_groups;

constexpr int kInFlight = 4;        // loads a thread issues before stores
constexpr int kBlocksPerSm = 2;     // the cooperative form's grid, per SM
// the block-local form reads every update once a block: taken while the
// reads past the first block's cost at most a kLocalShare-th of the
// table's bytes
constexpr int kLocalShare = 4;

// Units (16-byte words or elements) [lo, hi) from src to dst by one
// block: kInFlight loads a thread, then their stores, neighbouring
// threads on neighbouring units.
template <typename W>
__device__ __forceinline__ void copy_chunk(const W* __restrict__ src,
                                           W* __restrict__ dst,
                                           long long lo, long long hi) {
  for (long long base = lo + threadIdx.x; base < hi;
       base += (long long)kInFlight * blockDim.x) {
    W w[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const long long i = base + (long long)j * blockDim.x;
      if (i < hi) w[j] = src[i];
    }
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const long long i = base + (long long)j * blockDim.x;
      if (i < hi) dst[i] = w[j];
    }
  }
}

// The table's partition into per-block chunks: block b owns units
// [b * chunk, (b + 1) * chunk) of the aligned words (vec) or of the
// elements, and the elements those cover; the last block also owns the
// tail past the last whole word. Returns the block's element range.
template <typename U>
__device__ __forceinline__ void copy_block(const U* __restrict__ src,
                                           U* __restrict__ dst,
                                           long long m, int vec,
                                           long long chunk, long long b,
                                           long long nblocks,
                                           long long& elo, long long& ehi) {
  const long long per = vec ? 16 / (long long)sizeof(U) : 1;
  const long long units = vec ? m / per : m;
  const long long lo = b * chunk;
  const long long hi = lo + chunk < units ? lo + chunk : units;
  if (vec)
    copy_chunk<uint4>(reinterpret_cast<const uint4*>(src),
                      reinterpret_cast<uint4*>(dst), lo, hi);
  else
    copy_chunk<U>(src, dst, lo, hi);
  elo = lo * per;
  ehi = hi * per;
  if (b == nblocks - 1) {
    copy_chunk<U>(src, dst, ehi, m);      // the tail past the last word
    ehi = m;
  }
}

// The block-local form, for few updates: each block copies its chunk,
// then writes the updates that land in it (every block reads all k
// indices; no order among them is assumed). No grid-wide barrier.
template <typename U>
__global__ void __launch_bounds__(kThreads)
scatter_local(const U* __restrict__ src, const int* __restrict__ idx,
              const U* __restrict__ vals, U* __restrict__ dst, long long m,
              int k, int vec, long long chunk) {
  long long elo, ehi;
  copy_block<U>(src, dst, m, vec, chunk, blockIdx.x, gridDim.x, elo, ehi);
  __syncthreads();
  for (int u = threadIdx.x; u < k; u += blockDim.x) {
    const int j = __ldg(idx + u);
    if (j >= elo && j < ehi) dst[j] = __ldg(vals + u);
  }
}

// The cooperative form, for many updates: every block resident at once;
// each copies its chunks, one grid.sync(), then the updates grid-stride.
template <typename U>
__global__ void __launch_bounds__(kThreads)
scatter_persistent(const U* __restrict__ src, const int* __restrict__ idx,
                   const U* __restrict__ vals, U* __restrict__ dst,
                   long long m, int k, int vec, long long chunk,
                   long long nchunks) {
  cg::grid_group grid = cg::this_grid();
  long long elo, ehi;
  for (long long b = blockIdx.x; b < nchunks; b += gridDim.x)
    copy_block<U>(src, dst, m, vec, chunk, b, nchunks, elo, ehi);
  __threadfence();
  grid.sync();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < k; u += stride) {
    const int j = __ldg(idx + u);
    if (j >= 0 && (long long)j < m) dst[j] = __ldg(vals + u);
  }
}

// Per device: its SM count and, per element size, the blocks of
// scatter_persistent an SM holds at once (read once)
struct Occupancy {
  int sms, per_sm;
};

template <typename U>
int occupancy(Occupancy* o) {
  static Occupancy cache[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (cache[dev].sms == 0) {
    Occupancy c;
    if ((err = cudaDeviceGetAttribute(&c.sms,
                                      cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &c.per_sm, scatter_persistent<U>, kThreads, 0)) != cudaSuccess)
      return (int)err;
    if (c.per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    cache[dev] = c;
  }
  *o = cache[dev];
  return 0;
}

// One launch: the table in chunks of kThreads x kInFlight units (16-byte
// words when buf and out are both 16-byte aligned, else elements), the
// block-local form when the other blocks' reads of all k indices cost at
// most a kLocalShare-th of the table's bytes, else the cooperative form.
template <typename U>
int launch(const U* buf, const int* idx, const U* vals, U* out, long long m,
           int k, cudaStream_t stream) {
  if (m < 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;                 // every update is out of range
  int vec = ((reinterpret_cast<uintptr_t>(buf) |
              reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long units = vec ? m * (long long)sizeof(U) / 16 : m;
  long long chunk = (long long)kThreads * kInFlight;
  long long nchunks = units > 0 ? (units + chunk - 1) / chunk : 1;
  if (4 * (long long)k * (nchunks - 1) * kLocalShare <=
      m * (long long)sizeof(U)) {
    scatter_local<U><<<(unsigned)nchunks, kThreads, 0, stream>>>(
        buf, idx, vals, out, m, k, vec, chunk);
    return (int)cudaGetLastError();
  }
  Occupancy o;
  int rc = occupancy<U>(&o);
  if (rc != 0) return rc;
  // enough blocks for the chunks or for one update a thread; never more
  // than are resident at once
  long long blocks = nchunks;
  const long long upd = ((long long)k + kThreads - 1) / kThreads;
  if (upd > blocks) blocks = upd;
  const long long cap =
      (long long)o.sms * (o.per_sm < kBlocksPerSm ? o.per_sm : kBlocksPerSm);
  if (blocks > cap) blocks = cap;
  void* args[] = {&buf, &idx, &vals, &out, &m, &k, &vec, &chunk, &nchunks};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)scatter_persistent<U>, (unsigned)blocks, kThreads, args,
      0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The coordinate form: every cell of one card in one launch.
constexpr int kMaxCells = 32;

struct Dims4 {
  long long v[4];
};

template <typename U> struct Cells {
  const U* src[kMaxCells];
  U* dst[kMaxCells];
  Dims4 start[kMaxCells];
};

// Block b: cell b / per_cell, chunk b % per_cell of its slice (m
// elements of shape `shape`); the copy, then the updates landing there.
template <typename U>
__global__ void __launch_bounds__(kThreads)
coord_cells_kernel(const __grid_constant__ Cells<U> cells,
                   const int* __restrict__ coords,
                   const U* __restrict__ vals, int ndim, int k, Dims4 shape,
                   long long m, int vec, long long chunk, long long per_cell) {
  const long long cell = (long long)blockIdx.x / per_cell;
  const long long b = (long long)blockIdx.x - cell * per_cell;
  U* dst = cells.dst[cell];
  long long elo, ehi;
  copy_block<U>(cells.src[cell], dst, m, vec, chunk, b, per_cell, elo, ehi);
  __syncthreads();
  const Dims4& st = cells.start[cell];
  for (int u = threadIdx.x; u < k; u += blockDim.x) {
    long long flat = 0;
    bool in = true;
    for (int d = 0; d < ndim; ++d) {
      const long long c =
          (long long)__ldg(coords + (size_t)d * k + u) - st.v[d];
      in = in && c >= 0 && c < shape.v[d];
      flat = flat * shape.v[d] + c;
    }
    if (in && flat >= elo && flat < ehi) dst[flat] = __ldg(vals + u);
  }
}

// The coordinate entry point: coords vals, then the n cells' slices and
// their outputs as device pointers; then ndim k n, the slices' shape (4
// ints, 1 past ndim) and each cell's start in the whole table (4 ints a
// cell, 0 past ndim). Chunks of kThreads x kInFlight units (16-byte
// words when every slice and output is 16-byte aligned, else elements),
// made larger when the updates are many, so that the reads of all k
// updates past one block a cell stay within a kLocalShare-th of the
// slices' bytes.
template <typename U>
int launch_coords(void* const* p, int n_ptrs, const int* d, int n_dims,
                  cudaStream_t stream) {
  if (n_dims < 3) return (int)cudaErrorInvalidValue;
  const int ndim = d[0], k = d[1], n = d[2];
  if (ndim < 1 || ndim > 4 || k < 0 || n < 1 || n > kMaxCells ||
      n_ptrs != 2 + 2 * n || n_dims != 7 + 4 * n)
    return (int)cudaErrorInvalidValue;
  Dims4 shape;
  long long m = 1;
  for (int i = 0; i < 4; ++i) {
    shape.v[i] = d[3 + i];
    if (shape.v[i] < 0 || (i >= ndim && shape.v[i] != 1))
      return (int)cudaErrorInvalidValue;
    m *= shape.v[i];
  }
  if (m == 0) return 0;                 // empty slices: nothing to write
  Cells<U> cells;
  uintptr_t align = 0;
  for (int c = 0; c < n; ++c) {
    cells.src[c] = (const U*)p[2 + c];
    cells.dst[c] = (U*)p[2 + n + c];
    align |= reinterpret_cast<uintptr_t>(cells.src[c]) |
             reinterpret_cast<uintptr_t>(cells.dst[c]);
    for (int i = 0; i < 4; ++i) cells.start[c].v[i] = d[7 + 4 * c + i];
  }
  const int vec = (align & 15) == 0;
  const long long units = vec ? m * (long long)sizeof(U) / 16 : m;
  long long chunk = (long long)kThreads * kInFlight;
  long long per_cell = units > 0 ? (units + chunk - 1) / chunk : 1;
  if (k > 0) {
    const long long upd = 4LL * ndim * k * kLocalShare;
    const long long most = n + n * m * (long long)sizeof(U) / upd;
    if (n * per_cell > most) {
      per_cell = std::max(1LL, most / n);
      chunk = units > 0 ? (units + per_cell - 1) / per_cell : chunk;
    }
  }
  coord_cells_kernel<U><<<(unsigned)(n * per_cell), kThreads, 0, stream>>>(
      cells, (const int*)p[0], (const U*)p[1], ndim, k, shape, m, vec, chunk,
      per_cell);
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
