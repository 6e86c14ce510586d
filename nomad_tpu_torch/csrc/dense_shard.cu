// Node-sharded dense greedy step for NVIDIA Hopper (sm_90a).
//
// Replaces nomad_tpu/parallel/mesh.py::mesh_solve_fn: the dense greedy
// scan (binpack.py _solve_placements_impl via solve_eval_batch) with the
// node axis sharded over the columns of an (evals, nodes) grid, where XLA
// inserted the cross-shard window selection and argmax. Here the host
// (parallel/mesh.py mesh_solve) drives each placement step as three
// launches per cell, and copies the cells' counts and records between the
// cells of an evals row (solver/dense.py ShardCell has the plain version
// of every phase):
//   phase 0, count  -- one block per lane: score every node of the
//                      cell's slice (dense_common.cuh score_node; the
//                      step's penalty index moved into the slice's
//                      numbering), store each node's score and (fit,
//                      low) flags, and the lane's fit and low counts in
//                      the cell's slot of cnt;
//   phase 1, select -- one block per lane: the exclusive prefix of the
//                      counts over the cells before this one and their
//                      totals give the global skip rank and window
//                      position of every node (a block scan per tile of
//                      the slice, in window order); the cell's yielded
//                      nodes (window or fallback) give its best (score,
//                      order, node), written to its slot of rec with the
//                      number yielded and the best node's spread and
//                      distinct_property value indices;
//   phase 2, commit -- thread 0 per lane: the winner over the row's
//                      records (the largest score, the smallest window
//                      order on ties), n_yielded (the sum of the counts),
//                      the step's outputs; the owning cell commits usage,
//                      placed counts, ports, cores and devices at its
//                      node; every cell adds the published value indices
//                      to its copy of the spread and distinct_property
//                      counts.
// A record is W int32 words: the score's bits (1 word for float, 2 for
// double), order, node, n_yielded (INT_MAX order and node when the cell
// yields nothing), then S spread and Dp distinct_property value indices.
// Only integers are summed across cells, so every grid reproduces the
// one-card dense_scan bit for bit.
//
// Bound: the same function as dense_scan over the whole grid -- the
// tables read once and the outputs written once -- but each step now
// costs three dependent launches per cell and two rounds of copies, and
// every phase walks the whole slice (no early stop once the window is
// settled, which needs the whole node axis). So it is latency-bound on
// the host-driven step chain: P * (3 launches per cell + copies). This
// first version makes no attempt at that (a CUDA graph of the step, or a
// persistent kernel per cell with the exchange in device memory, would).
#include <cstring>

#include "dense_common.cuh"

namespace {

using namespace nt;

constexpr int kShardWarps = 8;     // 256 threads per lane

template <typename T>
struct ShardScratch {
  T* fin;          // (E, Ns) the step's score of each fit node
  u8* flags;       // (E, Ns) bit 0 fit, bit 1 low
  int* cnt;        // (n_par, E, 2) fit and low counts per cell
  int* rec;        // (n_par, E, W) records per cell
  int step, j, n_par, W;
};

template <typename T>
__global__ void __launch_bounds__(32 * kShardWarps)
shard_count(const DenseArgs<T> A, const ShardScratch<T> X) {
  const int e = blockIdx.x, tid = threadIdx.x;
  const Off o = lane_off(e, A.N, A.P, A.S, A.V, A.Dp, A.Vd, A.R, A.Gd);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_fit, n_low;
  const SpreadStats<T> st = spread_stats_init<T>(A, o, e, smem);
  spread_stats_step<T>(A, o, st);
  if (tid == 0) {
    n_fit = 0;
    n_low = 0;
  }
  __syncthreads();
  Ask<T> a = load_ask<T>(A, o.p + X.step);
  a.penalty -= X.j * A.N;             // the slice's own node numbers
  int my_fit = 0, my_low = 0;
  for (int n = tid; n < A.N; n += blockDim.x) {
    T f = T(0);
    const bool fit = score_node<T>(A, o, e, a, n, st, f);
    const bool low = fit && f <= T(0);
    X.fin[o.n + n] = fit ? f : T(0);
    X.flags[o.n + n] = (u8)((fit ? 1 : 0) | (low ? 2 : 0));
    my_fit += fit ? 1 : 0;
    my_low += low ? 1 : 0;
  }
  atomicAdd(&n_fit, my_fit);
  atomicAdd(&n_low, my_low);
  __syncthreads();
  if (tid == 0) {
    int* c = X.cnt + ((size_t)X.j * A.E + e) * 2;
    c[0] = n_fit;
    c[1] = n_low;
  }
}

template <typename T, int NW>
__global__ void __launch_bounds__(32 * NW)
shard_select(const DenseArgs<T> A, const ShardScratch<T> X) {
  const int e = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const Off o = lane_off(e, A.N, A.P, A.S, A.V, A.Dp, A.Vd, A.R, A.Gd);
  __shared__ u64 wsum[NW];
  __shared__ Key<T> red[NW];
  __shared__ int s_ny;
  if (tid == 0) s_ny = 0;
  int pre_fit = 0, pre_low = 0, tot_fit = 0, tot_low = 0;
  for (int q = 0; q < X.n_par; ++q) {
    const int* c = X.cnt + ((size_t)q * A.E + e) * 2;
    if (q < X.j) {
      pre_fit += c[0];
      pre_low += c[1];
    }
    tot_fit += c[0];
    tot_low += c[1];
  }
  const int L = A.limit[o.p + X.step];
  const int tot_counted = tot_fit - min(tot_low, kMaxSkip);
  const int deficit = max(0, L - min(tot_counted, L));
  const unsigned le_mask = 0xffffffffu >> (31 - lane);   // lanes <= me
  Key<T> best;
  best.eff = neg_inf<T>();
  best.order = INT_MAX;
  best.idx = INT_MAX;
  best.y = 0;
  int my_ny = 0;
  int fit_base = pre_fit, low_base = pre_low;
  __syncthreads();                       // s_ny
  for (int base = 0; base < A.N; base += blockDim.x) {
    const int n = base + tid;
    const u8 fl = n < A.N ? X.flags[o.n + n] : (u8)0;
    const bool fit = fl & 1, low = (fl >> 1) & 1;
    const unsigned fm = __ballot_sync(kFull, fit);
    const unsigned lm = __ballot_sync(kFull, low);
    const u64 mine =
        lane == 0 ? ((u64)__popc(lm) << 32) | (u64)__popc(fm) : 0;
    u64 total;
    const u64 incl = block_scan<NW, u64>(mine, total, wsum);
    const u64 excl = __shfl_sync(kFull, incl - mine, 0);
    const int fit_off = fit_base + (int)(excl & 0xffffffffu);
    const int low_off = low_base + (int)(excl >> 32);
    const int skip_rank = low_off + __popc(lm & le_mask);
    const int srank = min(skip_rank, kMaxSkip);
    const bool skipped = low && skip_rank <= kMaxSkip;
    const int cpos = fit_off + __popc(fm & le_mask) - srank;
    const bool window = fit && !skipped && cpos <= L;
    const bool fallback = skipped && srank <= deficit;
    if (window || fallback) {
      Key<T> k;
      k.eff = X.fin[o.n + n];
      k.order = window ? cpos : L + srank;
      k.idx = n;
      k.y = 1;
      if (better(k, best)) best = k;
      ++my_ny;
    }
    fit_base += (int)(total & 0xffffffffu);
    low_base += (int)(total >> 32);
  }
  atomicAdd(&s_ny, my_ny);
  const Key<T> win = block_best<T, NW>(best, red);
  __syncthreads();                       // s_ny complete
  if (tid == 0) {
    constexpr int ew = (int)(sizeof(T) / sizeof(int));
    int* r = X.rec + ((size_t)X.j * A.E + e) * X.W;
    const bool has = win.y != 0;
    const T eff = win.eff;
    memcpy(r, &eff, sizeof(T));
    r[ew] = has ? win.order : INT_MAX;
    r[ew + 1] = has ? win.idx : INT_MAX;
    r[ew + 2] = s_ny;
    const size_t N = A.N;
    for (int s = 0; s < A.S; ++s)
      r[ew + 3 + s] = has ? A.spread_vidx[o.sn + s * N + win.idx] : -1;
    for (int d = 0; d < A.Dp; ++d)
      r[ew + 3 + A.S + d] = has ? A.dp_vidx[o.dpn + d * N + win.idx] : -1;
  }
}

template <typename T>
__global__ void shard_commit(const DenseArgs<T> A, const ShardScratch<T> X) {
  if (threadIdx.x != 0) return;
  const int e = blockIdx.x;
  const Off o = lane_off(e, A.N, A.P, A.S, A.V, A.Dp, A.Vd, A.R, A.Gd);
  constexpr int ew = (int)(sizeof(T) / sizeof(int));
  int jw = -1, best_order = INT_MAX;
  T best = neg_inf<T>();
  long long ny = 0;
  for (int q = 0; q < X.n_par; ++q) {
    const int* r = X.rec + ((size_t)q * A.E + e) * X.W;
    T eff;
    memcpy(&eff, r, sizeof(T));
    ny += r[ew + 2];
    if (r[ew] == INT_MAX) continue;
    if (jw < 0 || eff > best || (eff == best && r[ew] < best_order)) {
      jw = q;
      best = eff;
      best_order = r[ew];
    }
  }
  const size_t ip = o.p + X.step;
  const bool any_yield = ny > 0;
  const bool doit = A.active[ip] != 0 && any_yield && jw >= 0;
  const int* rw = jw >= 0 ? X.rec + ((size_t)jw * A.E + e) * X.W : nullptr;
  const int w = rw ? rw[ew + 1] : 0;
  A.chosen[ip] = doit ? (long long)jw * A.N + w : -1;
  A.scores[ip] = any_yield ? best : neg_inf<T>();
  A.n_yielded[ip] = ny;
  if (!doit) return;
  if (jw == X.j) {
    // the owning cell: usage, placed counts, ports, cores, devices
    const Ask<T> a = load_ask<T>(A, ip);
    const size_t k = o.n + w, N = A.N;
    A.used_cpu[k] = A.used_cpu[k] + node_eff_cpu<T>(A, o, a, w);
    A.used_mem[k] = A.used_mem[k] + a.mem;
    A.used_disk[k] = A.used_disk[k] + a.disk;
    A.placed[k] += 1;
    A.placed_job[k] += 1;
    if (a.has_static) A.static_free[k] = 0;
    A.dyn_avail[k] -= a.n_dyn;
    if (A.has_cores) A.cores_free[k] -= a.cores;
    for (int r = 0; r < A.R; ++r) {
      // the group with the first maximal affinity among those with room
      const int need = A.dev_count[o.r + r];
      int g_star = 0;
      T gbest = neg_inf<T>();
      for (int g = 0; g < A.Gd; ++g) {
        const size_t q = o.rgn + ((size_t)r * A.Gd + g) * N + w;
        const T av = A.dev_free[q] >= need ? A.dev_aff[q] : neg_inf<T>();
        if (av > gbest) {
          gbest = av;
          g_star = g;
        }
      }
      A.dev_free[o.rgn + ((size_t)r * A.Gd + g_star) * N + w] -= need;
    }
  }
  // every cell: the published value indices into its copy of the counts
  for (int s = 0; s < A.S; ++s) {
    const int v = rw[ew + 3 + s];
    if (v >= 0) A.spread_counts[o.sv + s * A.V + v] += 1;
  }
  for (int d = 0; d < A.Dp; ++d) {
    const int v = rw[ew + 3 + A.S + d];
    if (v >= 0) A.dp_counts[o.dpv + d * A.Vd + v] += 1;
  }
}

constexpr int kOutputs = 3;       // chosen, scores, n_yielded
constexpr int kScratch = 4;       // fin, flags, cnt, rec
constexpr int kShardDims = 5;     // phase step j n_par W

template <typename T>
int launch(void* const* p, int n_ptrs, const int* d, int n_dims,
           cudaStream_t stream) {
  if (n_ptrs != kDenseTables + kOutputs + kScratch ||
      n_dims != kDenseDims + kShardDims)
    return (int)cudaErrorInvalidValue;
  DenseArgs<T> a;
  int k = 0;
  unpack_dense<T>(a, p, k, d);
  a.chosen = (long long*)p[k++]; a.scores = (T*)p[k++];
  a.n_yielded = (long long*)p[k++];
  ShardScratch<T> x;
  x.fin = (T*)p[k++]; x.flags = (u8*)p[k++]; x.cnt = (int*)p[k++];
  x.rec = (int*)p[k++];
  const int phase = d[kDenseDims];
  x.step = d[kDenseDims + 1]; x.j = d[kDenseDims + 2];
  x.n_par = d[kDenseDims + 3]; x.W = d[kDenseDims + 4];
  if (a.E <= 0) return 0;
  if (a.N <= 0 || a.N > (1 << 30) / 2 || x.step < 0 || x.step >= a.P ||
      x.n_par < 1 || x.j < 0 || x.j >= x.n_par ||
      x.W != (int)(sizeof(T) / sizeof(int)) + 3 + a.S + a.Dp)
    return (int)cudaErrorInvalidValue;
  if (phase == 0) {
    const size_t smem = spread_stats_bytes<T>(a.S);
    auto kern = shard_count<T>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kern<<<a.E, 32 * kShardWarps, smem, stream>>>(a, x);
  } else if (phase == 1) {
    shard_select<T, kShardWarps><<<a.E, 32 * kShardWarps, 0, stream>>>(a, x);
  } else if (phase == 2) {
    shard_commit<T><<<a.E, 32, 0, stream>>>(a, x);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nt_dense_shard_f32(void* const* ptrs, int n_ptrs,
                                  const int* dims, int n_dims, void* stream) {
  return launch<float>(ptrs, n_ptrs, dims, n_dims, (cudaStream_t)stream);
}

extern "C" int nt_dense_shard_f64(void* const* ptrs, int n_ptrs,
                                  const int* dims, int n_dims, void* stream) {
  return launch<double>(ptrs, n_ptrs, dims, n_dims, (cudaStream_t)stream);
}
