// Node-sharded dense greedy scan for NVIDIA Hopper (sm_90a).
//
// Replaces nomad_tpu/parallel/mesh.py::mesh_solve_fn: the dense greedy
// scan (binpack.py _solve_placements_impl via solve_eval_batch) with the
// node axis sharded over the columns of an (evals, nodes) grid, where XLA
// inserted the cross-shard window selection and argmax.
//
// Design: one persistent launch per card per dispatch
// (parallel/mesh.py mesh_solve, through solver/dense.py dense_shard).
// The launch covers every cell of the grid on that card and runs every
// placement step; the cells of an evals row meet only through
// mesh_exchange.cuh's flagged slots, never through a barrier that spans
// the launch. Each (cell, lane) unit is a thread-block cluster of C
// blocks of 512 threads (dense_common.cuh choose_cluster, C <= the
// slice's nodes / 512), which scans the cell's slice of Ns nodes as
// dense_scan.cu's cluster walk does: block c owns the 512 nodes from
// t * C * 512 + c * 512 of every tile t (staged caps and usage,
// replicated count tables, lane_view). A step:
//   1. every block scores each of its nodes (dense_common.cuh
//      score_node_vals; the step's penalty index moved into the slice's
//      numbering), keeps a fit node's score in the cell's scratch and
//      each warp's fit and low ballots per tile in shared memory, with
//      the exclusive prefix of the block's warps before it; the block's
//      per-tile counts go to every block of the cluster (distributed
//      shared memory), one cluster barrier;
//   2. block 0 writes the cell's (fit, low) totals to its count slot and
//      publishes point 0; it reads the counts of the cells before it
//      (the exclusive prefix: the global skip rank and window position)
//      and, unless those and its own already count `limit` nodes (then
//      the deficit is 0 whatever later cells hold), of the cells after
//      it (the totals: the fallback's deficit); one cluster barrier
//      hands the prefix and deficit to every block;
//   3. every block marks its yielded nodes (window or fallback, in
//      window order: the earlier cells, the earlier tiles, the earlier
//      blocks of the tile, the earlier warps' ballots, the lanes before:
//      no block barrier) and keeps its best (score, order, node); the
//      blocks' records go to block 0, one cluster barrier;
//   4. block 0 writes the cell's record (the best score's bits, order,
//      node, the number yielded, the node's spread and distinct_property
//      value indices) to its record slot and publishes point 1; it reads
//      every cell's record: the winner (the largest score, the smallest
//      window order on ties), n_yielded (the integer sum), the step's
//      outputs; one cluster barrier hands the winner to every block;
//   5. the block that owns the winner, in the owning cell, commits usage,
//      placed counts, ports, cores and devices (global memory and the
//      staged copy); every block of every cell adds the published value
//      indices to its replica of the spread and distinct_property counts.
// Only integers and the records' own score bits cross cells (a float64
// record's two words are written before its sequence word), so every
// grid reproduces the one-card dense_scan bit for bit. Every unit must be
// resident at once: the launcher checks cudaOccupancyMaxActiveClusters
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at C = 1) and refuses a
// launch that does not fit; where lanes outnumber the resident units, a
// unit takes lanes u, u + U, ... in turn, in the same order on every cell.
// A wait that outlasts its budget writes the error word, and every unit
// leaves (mesh_exchange.cuh); only block 0 of a cluster waits, and the
// cluster barrier after each wait hands its verdict to every block, so a
// cluster leaves whole. Built with -DNT_STEP_CLOCKS, the first unit's
// block 0 stamps its step sections (wave_common.cuh NT_CLK): 1 scoring,
// 2 the count exchange (cluster barriers included), 3 marking, 4 the
// record exchange, 5 commit; 6 the whole launch, 7 steps.
//
// Bound: the same function as dense_scan over the whole grid -- the
// tables read once and the outputs written once. What the launch pays
// instead is the step chain: per step two rounds of the exchange (a
// release store and the peers' acquire polls, through L2 on one card,
// through PCIe for a group in host memory) and four cluster barriers,
// and every step scores the whole slice (no early stop: the cell's
// counts are needed before any position is known).
#include <algorithm>
#include <cstring>

#include "dense_common.cuh"
#include "mesh_exchange.cuh"

namespace {

using namespace nt;

constexpr int kWarps = 16;                 // 512 threads a block
constexpr int kSub = 32 * kWarps;          // nodes a block owns per tile
constexpr int kMaxPar = 32;                // cells of a group (one warp)
constexpr int kMaxWords = 64;              // a record's words, at most
// A cell's row of the device table: the DENSE_ARGS tables, chosen,
// scores, n_yielded, the fin scratch, its group's exchange area, its
// column j and its place in the grid (for the error word).
constexpr int kCellWords = kDenseTables + 3 + 1 + 3;

struct ShardLaunch {
  const long long* cells;                  // (n_cells, kCellWords)
  int* err;                                // kErrWords
  int d[kDenseDims];                       // every cell's lane dims
  int n_par, W, units, budget;
};

template <typename T> struct ShardShared {
  DenseArgs<T> A;                          // this block's cell
  T* fin;
  unsigned* area;
  int j, place;
  Key<T> red[kWarps];
  Key<T> krec[kMaxCluster];                // the blocks' records (block 0)
  int nyrec[kMaxCluster];
  int s_ny;
  // set by block 0 in every block of the cluster
  int pre_fit, pre_low, deficit, abort;
  int jw, w, doit;
};

__host__ __device__ __forceinline__ size_t align16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

// Dynamic shared memory past the lane view: the cluster's per-(tile,
// block) packed (low, fit) counts, the block's warps' packed exclusive
// prefix per tile, the warps' fit and low ballots per tile, the peers'
// counts and records (block 0) and the winner's value indices.
__host__ __device__ __forceinline__ size_t shard_extra_bytes(
    int tiles, int C, int n_par, int W, int S, int Dp) {
  return align16(sizeof(u64) * (size_t)tiles * (C + kWarps) +
                 sizeof(unsigned) * 2 * (size_t)tiles * kWarps +
                 sizeof(int) * ((size_t)n_par * (kCntWords + W) + S + Dp));
}

// The packed (low, fit) count of a warp's ballots.
__device__ __forceinline__ u64 packed(unsigned fm, unsigned lm) {
  return ((u64)__popc(lm) << 32) | (u64)__popc(fm);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The owning block commits lane winner w's node (the reference step's
// scatter updates and the device part of _commit_tables); one thread.
template <typename T>
__device__ __forceinline__ void commit_node(const DenseArgs<T>& A,
                                            const Off& o, const Ask<T>& a,
                                            const LaneView<T>& v, int ci,
                                            int w) {
  const size_t k = o.n + w;
  const T uc = v.ucpu[ci] + node_eff_cpu<T>(A, o, a, w);
  const T um = v.umem[ci] + a.mem, ud = v.udisk[ci] + a.disk;
  v.ucpu[ci] = uc;
  v.umem[ci] = um;
  v.udisk[ci] = ud;
  A.used_cpu[k] = uc;
  A.used_mem[k] = um;
  A.used_disk[k] = ud;
  A.placed[k] += 1;
  A.placed_job[k] += 1;
  if (a.has_static) A.static_free[k] = 0;
  A.dyn_avail[k] -= a.n_dyn;
  if (A.has_cores) A.cores_free[k] -= a.cores;
  commit_devices<T>(A, o, w);
}

// Every block: the winner's published spread and distinct_property
// value indices (wv: S then Dp) into the replicated tables, and the
// spreads' statistics again (dense_common.cuh commit_counts, with the
// values from the record: the node may lie in another cell's slice).
template <typename T>
__device__ __forceinline__ void commit_published(const DenseArgs<T>& A,
                                                 const LaneView<T>& v,
                                                 const int* wv) {
  for (int s = threadIdx.x; s < A.S; s += blockDim.x) {
    const int vi = wv[s];
    if (vi >= 0) v.sc[s * A.V + vi] += 1;
    spread_stat<T>(v.st, s, A.V);
  }
  for (int d = threadIdx.x; d < A.Dp; d += blockDim.x) {
    const int vi = wv[A.S + d];
    if (vi >= 0) v.dpc[d * A.Vd + vi] += 1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kSub)
dense_shard_kernel(const ClusterCfg g, const ShardLaunch L) {
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.block_rank();
  const int unit = blockIdx.x / g.C;
  const int k = unit / L.units, u = unit % L.units;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned le_mask = 0xffffffffu >> (31 - lane);     // lanes <= me
  __shared__ ShardShared<T> sh;
  extern __shared__ __align__(16) unsigned char smem[];
  if (tid == 0) {
    const long long* row = L.cells + (size_t)k * kCellWords;
    int q = 0;
    unpack_dense<T>(sh.A, reinterpret_cast<void* const*>(row), q, L.d);
    sh.A.chosen = (long long*)row[q++];
    sh.A.scores = (T*)row[q++];
    sh.A.n_yielded = (long long*)row[q++];
    sh.fin = (T*)row[q++];
    sh.area = (unsigned*)row[q++];
    sh.j = (int)row[q++];
    sh.place = (int)row[q++];
  }
  __syncthreads();
  const DenseArgs<T>& A = sh.A;
  T* const fin = sh.fin;
  unsigned* const area = sh.area;
  int* const iarea = reinterpret_cast<int*>(area);
  const int j = sh.j, N = A.N, E = A.E, n_par = L.n_par, W = L.W;
  const int tile_n = g.C * kSub;
  const int tiles = (N + tile_n - 1) / tile_n;
  constexpr int ew = (int)(sizeof(T) / sizeof(int));
  u64* tcnt = reinterpret_cast<u64*>(
      smem + align16(lane_smem_bytes<T>(g.slots, A.S, A.V, A.Dp, A.Vd, 0,
                                        g.rep)));
  u64* wpre = tcnt + (size_t)tiles * g.C;
  unsigned* wfm = reinterpret_cast<unsigned*>(wpre + (size_t)tiles * kWarps);
  unsigned* wlm = wfm + (size_t)tiles * kWarps;
  int* pcnt = reinterpret_cast<int*>(wlm + (size_t)tiles * kWarps);
  int* prec = pcnt + n_par * kCntWords;
  int* wv = prec + n_par * W;
  const Waiter wt{L.err, (long long)L.budget, sh.place};
  NT_T0();
  NT_CNT(6, 0ull - clock64());

  for (int e = u; e < E; e += L.units) {
    const Off o = lane_off(e, N, A.P, A.S, A.V, A.Dp, A.Vd, A.R, A.Gd);
    const LaneView<T> v = lane_view<T>(A, o, e, g, c, nullptr, 0, smem);
    unsigned* const seq_me = area + shard_seq_off(j, e, n_par, E, W);
    for (int i = 0; i < A.P; ++i) {
      const int par = i & 1;
      const size_t ip = o.p + i;
      const Ask<T> a = load_ask<T>(A, ip);
      Ask<T> as = a;
      as.penalty -= j * N;                  // the slice's own node numbers
      // 1. score the slice; each warp's fit and low ballots per tile
      NT_RESET();
      if (tid == 0) sh.s_ny = 0;
      for (int t = 0; t < tiles; ++t) {
        const int n = t * tile_n + c * kSub + tid;
        bool fit = false;
        T f = T(0);
        if (n < N) {
          const int ci = col_at<T>(v, g, n);
          fit = score_node_vals<T>(A, o, e, as, n, v.st, v.ucpu[ci],
                                   v.umem[ci], v.udisk[ci], v.ccap[ci],
                                   v.mcap[ci], v.dcap[ci], f);
          if (fit) fin[o.n + n] = f;
        }
        const unsigned fm = __ballot_sync(kFull, fit);
        const unsigned lm = __ballot_sync(kFull, fit && f <= T(0));
        if (lane == 0) {
          wfm[t * kWarps + warp] = fm;
          wlm[t * kWarps + warp] = lm;
        }
      }
      __syncthreads();
      // the block's count of each tile, to every block of the cluster;
      // each warp's exclusive prefix within its tile
      for (int q = tid; q < tiles * g.C; q += blockDim.x) {
        const int t = q / g.C;
        u64 x = 0;
        for (int w = 0; w < kWarps; ++w)
          x += packed(wfm[t * kWarps + w], wlm[t * kWarps + w]);
        *cl.map_shared_rank(&tcnt[t * g.C + c], q % g.C) = x;
      }
      for (int q = tid; q < tiles * kWarps; q += blockDim.x) {
        const int t = q / kWarps, w = q % kWarps;
        u64 x = 0;
        for (int u2 = 0; u2 < w; ++u2)
          x += packed(wfm[t * kWarps + u2], wlm[t * kWarps + u2]);
        wpre[q] = x;
      }
      NT_CLK(1);
      cl.sync();
      // 2. block 0: publish the cell's counts; the prefix and deficit
      if (c == 0 && warp == 0) {
        u64 own = 0;
        for (int q = 0; q < tiles * g.C; ++q) own += tcnt[q];
        const int own_fit = (int)(own & 0xffffffffu);
        const int own_low = (int)(own >> 32);
        const unsigned tgt = (unsigned)(i * kShardPoints + 1);
        if (lane == 0) {
          int* s = iarea + shard_cnt_off(par, j, e, n_par, E);
          s[0] = own_fit;
          s[1] = own_low;
          st_release_sys(seq_me, tgt);
        }
        bool ok = true;
        int f0 = 0, l0 = 0;
        if (lane < j) {
          ok = wait_seq(area + shard_seq_off(lane, e, n_par, E, W), tgt, wt,
                        kErrCount, i, e);
          if (ok) {
            const int* s = iarea + shard_cnt_off(par, lane, e, n_par, E);
            f0 = ld_strong(s);
            l0 = ld_strong(s + 1);
          }
        }
        ok = __all_sync(kFull, ok);
        const int pre_fit = warp_sum(f0), pre_low = warp_sum(l0);
        int tot_fit = pre_fit + own_fit, tot_low = pre_low + own_low;
        // counted only grows with more cells: once the cells up to this
        // one count `limit`, the deficit is 0 whatever the later hold
        if (ok && tot_fit - min(tot_low, kMaxSkip) < a.limit) {
          int f1 = 0, l1 = 0;
          bool ok1 = true;
          if (lane > j && lane < n_par) {
            ok1 = wait_seq(area + shard_seq_off(lane, e, n_par, E, W), tgt,
                           wt, kErrCount, i, e);
            if (ok1) {
              const int* s = iarea + shard_cnt_off(par, lane, e, n_par, E);
              f1 = ld_strong(s);
              l1 = ld_strong(s + 1);
            }
          }
          ok = __all_sync(kFull, ok1);
          tot_fit += warp_sum(f1);
          tot_low += warp_sum(l1);
        }
        const int tot_counted = tot_fit - min(tot_low, kMaxSkip);
        const int deficit = max(0, a.limit - min(tot_counted, a.limit));
        if (lane < g.C) {
          *cl.map_shared_rank(&sh.pre_fit, lane) = pre_fit;
          *cl.map_shared_rank(&sh.pre_low, lane) = pre_low;
          *cl.map_shared_rank(&sh.deficit, lane) = deficit;
          *cl.map_shared_rank(&sh.abort, lane) = ok ? 0 : 1;
        }
      }
      cl.sync();
      NT_CLK(2);
      if (sh.abort) return;                 // the whole cluster leaves
      // 3. mark the yielded nodes in window order; the block's best
      Key<T> best = no_key<T>();
      int my_ny = 0;
      {
        const int Lm = a.limit, deficit = sh.deficit;
        u64 before = ((u64)sh.pre_low << 32) | (u64)sh.pre_fit;
        for (int t = 0; t < tiles; ++t) {
          u64 pre = before + wpre[t * kWarps + warp], all = 0;
          for (int q = 0; q < g.C; ++q) {
            const u64 x = tcnt[t * g.C + q];
            if (q < c) pre += x;
            all += x;
          }
          const int n = t * tile_n + c * kSub + tid;
          const unsigned fm = wfm[t * kWarps + warp];
          const unsigned lm = wlm[t * kWarps + warp];
          const bool fit = (fm >> lane) & 1u, low = (lm >> lane) & 1u;
          const int skip_rank = (int)(pre >> 32) + __popc(lm & le_mask);
          const int srank = min(skip_rank, kMaxSkip);
          const bool skipped = low && skip_rank <= kMaxSkip;
          const int cpos =
              (int)(pre & 0xffffffffu) + __popc(fm & le_mask) - srank;
          const bool window = fit && !skipped && cpos <= Lm;
          const bool fallback = skipped && srank <= deficit;
          if (window || fallback) {
            Key<T> q;
            q.eff = fin[o.n + n];
            q.order = window ? cpos : Lm + srank;
            q.idx = n;
            q.y = 1;
            if (better(q, best)) best = q;
            ++my_ny;
          }
          before += all;
        }
      }
      my_ny = warp_sum(my_ny);
      if (lane == 0 && my_ny) atomicAdd(&sh.s_ny, my_ny);
      const Key<T> bb = block_best<T, kWarps>(best, sh.red);
      if (tid == 0) {
        *cl.map_shared_rank(&sh.krec[c], 0) = bb;
        *cl.map_shared_rank(&sh.nyrec[c], 0) = sh.s_ny;
      }
      NT_CLK(3);
      cl.sync();
      // 4. block 0: publish the cell's record; the winner of the row
      if (c == 0 && warp == 0) {
        const unsigned tgt = (unsigned)(i * kShardPoints + 2);
        if (lane == 0) {
          Key<T> win = sh.krec[0];
          int ny = sh.nyrec[0];
          for (int q = 1; q < g.C; ++q) {
            if (better(sh.krec[q], win)) win = sh.krec[q];
            ny += sh.nyrec[q];
          }
          const bool has = win.y != 0;
          int* r = prec + j * W;
          const T eff = win.eff;
          memcpy(r, &eff, sizeof(T));
          r[ew] = has ? win.order : INT_MAX;
          r[ew + 1] = has ? win.idx : INT_MAX;
          r[ew + 2] = ny;
          // the node's spread then distinct_property value indices,
          // loaded together
          const size_t NN = N;
          const int nv = A.S + A.Dp;
          for (int q0 = 0; q0 < nv; q0 += 8) {
            int vb[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int q = q0 + k;
              vb[k] = !has || q >= nv ? -1
                      : q < A.S ? A.spread_vidx[o.sn + q * NN + win.idx]
                                : A.dp_vidx[o.dpn + (q - A.S) * NN + win.idx];
            }
#pragma unroll
            for (int k = 0; k < 8; ++k)
              if (q0 + k < nv) r[ew + 3 + q0 + k] = vb[k];
          }
          int* s = iarea + shard_rec_off(par, j, e, n_par, E, W);
          for (int q = 0; q < W; ++q) s[q] = r[q];
          st_release_sys(seq_me, tgt);
        }
        bool ok = true;
        if (lane < n_par && lane != j) {
          ok = wait_seq(area + shard_seq_off(lane, e, n_par, E, W), tgt, wt,
                        kErrRecord, i, e);
          if (ok) {
            const int* s = iarea + shard_rec_off(par, lane, e, n_par, E, W);
            // the record's words loaded together, then kept
            for (int q0 = 0; q0 < W; q0 += 8) {
              int wb[8];
#pragma unroll
              for (int k = 0; k < 8; ++k)
                if (q0 + k < W) wb[k] = ld_strong(s + q0 + k);
#pragma unroll
              for (int k = 0; k < 8; ++k)
                if (q0 + k < W) prec[lane * W + q0 + k] = wb[k];
            }
          }
        }
        ok = __all_sync(kFull, ok);
        __syncwarp();
        int jw = -1, w = 0, doit = 0;
        if (lane == 0) {
          int best_order = INT_MAX;
          T bestv = neg_inf<T>();
          long long ny = 0;
          for (int q = 0; q < n_par; ++q) {
            const int* r = prec + q * W;
            T eff;
            memcpy(&eff, r, sizeof(T));
            ny += r[ew + 2];
            if (r[ew] == INT_MAX) continue;
            if (jw < 0 || eff > bestv || (eff == bestv && r[ew] < best_order)) {
              jw = q;
              bestv = eff;
              best_order = r[ew];
            }
          }
          const bool any_yield = ny > 0;
          doit = a.active && any_yield && jw >= 0;
          w = jw >= 0 ? prec[jw * W + ew + 1] : 0;
          if (ok) {
            A.chosen[ip] = doit ? (long long)jw * N + w : -1;
            A.scores[ip] = any_yield ? bestv : neg_inf<T>();
            A.n_yielded[ip] = ny;
          }
        }
        // the winner to every block of the cluster, a lane a block
        jw = __shfl_sync(kFull, jw, 0);
        w = __shfl_sync(kFull, w, 0);
        doit = __shfl_sync(kFull, doit, 0);
        if (lane < g.C) {
          *cl.map_shared_rank(&sh.jw, lane) = jw;
          *cl.map_shared_rank(&sh.w, lane) = w;
          *cl.map_shared_rank(&sh.doit, lane) = doit;
          *cl.map_shared_rank(&sh.abort, lane) = ok ? 0 : 1;
          if (doit) {
            const int* rw = prec + jw * W + ew + 3;
            for (int q = 0; q < A.S + A.Dp; ++q)
              *cl.map_shared_rank(&wv[q], lane) = rw[q];
          }
        }
      }
      cl.sync();
      NT_CLK(4);
      if (sh.abort) return;
      // 5. commit
      if (sh.doit) {
        const int w = sh.w;
        if (sh.jw == j && tid == 0 && (w / kSub) % g.C == c)
          commit_node<T>(A, o, a, v, col_at<T>(v, g, w), w);
        commit_published<T>(A, v, wv);
      }
      __syncthreads();
      NT_CLK(5);
    }
    NT_CNT(7, A.P);
    lane_view_close<T>(A, o, v, g, c, nullptr, 0);
  }
  NT_CNT(6, clock64());
}

constexpr int kShardDims = kDenseDims + 4;   // + n_par W n_cells budget

// The last launch's cluster size and units per cell
// (nt_dense_shard_cluster).
int g_cluster = 0;

template <typename T>
int launch(void* const* p, int n_ptrs, const int* d, int n_dims,
           cudaStream_t stream) {
  if (n_ptrs != 2 || n_dims != kShardDims) return (int)cudaErrorInvalidValue;
  ShardLaunch L;
  L.cells = (const long long*)p[0];
  L.err = (int*)p[1];
  for (int q = 0; q < kDenseDims; ++q) L.d[q] = d[q];
  const int E = d[0], N = d[1], P = d[2], S = d[3], V = d[4], Dp = d[5],
            Vd = d[6];
  L.n_par = d[kDenseDims];
  L.W = d[kDenseDims + 1];
  const int n_cells = d[kDenseDims + 2];
  L.budget = d[kDenseDims + 3];
  if (E <= 0 || P <= 0 || n_cells <= 0) return 0;
  if (N <= 0 || N > (1 << 30) / 2 || L.n_par < 1 || L.n_par > kMaxPar ||
      L.W != (int)(sizeof(T) / sizeof(int)) + 3 + S + Dp ||
      L.W > kMaxWords || L.budget <= 0)
    return (int)cudaErrorInvalidValue;
  // a cluster no wider than the slice: C * 512 <= Ns
  int c_max = 1;
  while (c_max < kMaxCluster && 2 * c_max * kSub <= N) c_max *= 2;
  auto cfg_for = [&](int C, size_t budget, size_t& smem) {
    const int tiles = (N + C * kSub - 1) / (C * kSub);
    const size_t x = shard_extra_bytes(tiles, C, L.n_par, L.W, S, Dp);
    const ClusterCfg g = cluster_cfg<T>(C, kSub, N, S, V, Dp, Vd, 0,
                                        budget > x ? budget - x : 0, smem);
    smem = align16(smem) + x;
    return g;
  };
  auto kern = dense_shard_kernel<T>;
  cudaLaunchConfig_t lc;
  cudaLaunchAttribute attr;
  ClusterCfg g;
  int C = 1;
  cudaError_t err = choose_cluster(kern, n_cells * E, kSub, cfg_for, c_max,
                                   &lc, &attr, &g, &C);
  if (err != cudaSuccess) return (int)err;
  // every unit resident at once
  int max_units = 0;
  if (C == 1) {
    int sms = 0, per_sm = 0;
    if ((err = sm_count(&sms)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, kSub, lc.dynamicSmemBytes)) != cudaSuccess)
      return (int)err;
    max_units = sms * per_sm;
  } else if ((err = cudaOccupancyMaxActiveClusters(&max_units, kern, &lc)) !=
             cudaSuccess) {
    return (int)err;
  }
  L.units = std::min(E, max_units / n_cells);
  if (L.units < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  lc.gridDim = dim3((unsigned)(n_cells * L.units * C), 1, 1);
  lc.stream = stream;
  g_cluster = C;
  err = cudaLaunchKernelEx(&lc, kern, g, L);
  if (err != cudaSuccess) return (int)err;
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

extern "C" int nt_dense_shard_cluster(void) { return g_cluster; }

NT_STEP_CLOCKS_EXPORT
