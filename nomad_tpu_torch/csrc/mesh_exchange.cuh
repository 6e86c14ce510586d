// The exchange protocol of the persistent mesh kernels (dense_shard.cu,
// lp_relax.cu nt_lp_shard_f32) for NVIDIA Hopper (sm_90a).
//
// A mesh dispatch launches one persistent kernel per card, covering
// every cell of the (evals, nodes) grid that lives on that card. Cells
// meet only through this protocol, never through a barrier that spans
// the launch, so cells on one card and cells on several cards run the
// same code:
//
//   * Groups. An exchange group is the cells that must meet: for the
//     node-sharded scan the cells of one evals row (one group per lane:
//     a lane's unit on each cell), for the lane-sharded LP the cells of
//     one nodes column.
//   * Slots. Per group (and lane), each cell owns one slot per exchange
//     point and step parity (kParities): the (fit, low) count pair and
//     the W-word record for the scan, its lanes' (max, sum) for the LP.
//     A cell writes only its own slots.
//   * Publishing. After writing, the cell publishes a monotone sequence
//     word, step * points + point + 1, with a release store at system
//     scope; peers read the word with acquire loads at system scope and
//     then read the slot with strong (relaxed, system scope) loads, so
//     no stale L1 line and no torn record is read.
//   * Reuse. Slots alternate by step parity: a slot is written again
//     only after every peer has published a later point, which each peer
//     does only after reading the slot. (A single buffer is not enough:
//     a cell that needs no later cell's counts, or an LP cell that runs
//     ahead into the next step's rows, writes its next slot while a slow
//     peer may still read the last one.)
//   * Bounded waits. Every wait counts clock64 against a budget given
//     as a launch int, in units of 1,024 SM cycles. When the budget runs
//     out, the wait writes (code, step, cell, lane) into the error word
//     (kErrWords ints), and every unit leaves: each wait also leaves
//     when it finds the error word set. The call that reads the results
//     reads the word and raises.
//
// Where the memory lives: a group whose cells share one card keeps its
// area (and the dispatch its error word) in that card's memory; a group
// that spans cards keeps it in pinned host memory, which every card maps
// at the same address under UVA. The code is the same for both.
//
// Area layouts (32-bit words; solver/dense.py and solver/lpq.py build
// the same views over them, and tests/test_torch_mesh_exchange.py reads
// the constants below):
//   scan group (n_par cells, E lanes, W record words):
//     cnt [kParities][n_par][E][kCntWords], rec [kParities][n_par][E][W],
//     seq [n_par][E]
//   LP group (G cells, L lanes):
//     stats [kParities][kStatRows][L] float32 (row max, row sum),
//     seq [G]
#pragma once

#include <cuda_runtime.h>

namespace nt {

constexpr int kParities = 2;       // slot copies, alternating by step
constexpr int kShardPoints = 2;    // scan: counts, then the record
constexpr int kLpPoints = 1;       // LP: the row statistics
constexpr int kCntWords = 2;       // fit, low
constexpr int kStatRows = 2;       // row max, row sum
constexpr int kErrWords = 4;       // code, step, cell, lane

// Error codes (the first word of the error word).
constexpr int kErrCount = 1;       // scan: a peer's counts never came
constexpr int kErrRecord = 2;      // scan: a peer's record never came
constexpr int kErrStats = 3;       // LP: a peer's statistics never came
constexpr int kErrCellSync = 4;    // LP: a block of the cell never came

// ---------------------------------------------------------------------
// Layouts.

__host__ __device__ __forceinline__ size_t shard_cnt_off(int par, int j,
                                                         int e, int n_par,
                                                         int E) {
  return (((size_t)par * n_par + j) * E + e) * kCntWords;
}

__host__ __device__ __forceinline__ size_t shard_rec_off(int par, int j,
                                                         int e, int n_par,
                                                         int E, int W) {
  return (size_t)kParities * n_par * E * kCntWords +
         (((size_t)par * n_par + j) * E + e) * W;
}

__host__ __device__ __forceinline__ size_t shard_seq_off(int j, int e,
                                                         int n_par, int E,
                                                         int W) {
  return (size_t)kParities * n_par * E * (kCntWords + W) + (size_t)j * E + e;
}

__host__ __device__ __forceinline__ size_t lp_stat_off(int par, int row,
                                                       int L) {
  return ((size_t)par * kStatRows + row) * L;
}

__host__ __device__ __forceinline__ size_t lp_seq_off(int g, int L) {
  return (size_t)kParities * kStatRows * L + g;
}

// ---------------------------------------------------------------------
// Memory operations at system scope.

__device__ __forceinline__ unsigned ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_strong(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.sys.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int ld_strong(const int* p) {
  return (int)ld_strong(reinterpret_cast<const unsigned*>(p));
}

__device__ __forceinline__ float ld_strong(const float* p) {
  return __uint_as_float(ld_strong(reinterpret_cast<const unsigned*>(p)));
}

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// ---------------------------------------------------------------------
// Bounded waits.

// What a wait needs: the dispatch's error word, the budget (units of
// 1,024 SM cycles) and the waiter's cell, for the error record.
struct Waiter {
  int* err;
  long long budget;
  int cell;
};

__device__ __forceinline__ bool error_set(const Waiter& w) {
  return ld_strong(w.err) != 0;
}

// The first failure wins the error word; the others leave it as it is.
__device__ __forceinline__ void record_error(const Waiter& w, int code,
                                             int step, int lane) {
  if (atomicCAS_system(w.err, 0, code) == 0) {
    w.err[1] = step;
    w.err[2] = w.cell;
    w.err[3] = lane;
    __threadfence_system();
  }
}

// Wait until *seq >= target (acquire). False when the budget ran out
// (recorded as code) or another unit set the error word.
__device__ __forceinline__ bool wait_seq(const unsigned* seq,
                                         unsigned target, const Waiter& w,
                                         int code, int step, int lane) {
  if (ld_acquire_sys(seq) >= target) return true;
  const long long t0 = clock64();
  for (;;) {
    __nanosleep(64);
    if (ld_acquire_sys(seq) >= target) return true;
    if (error_set(w)) return false;
    if (((clock64() - t0) >> 10) > w.budget) {
      record_error(w, code, step, lane);
      return false;
    }
  }
}

}  // namespace nt
