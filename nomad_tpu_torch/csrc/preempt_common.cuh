// The eviction search shared by the two preemption kernels
// (wave_preempt.cu, dense_preempt.cu): one node's or window slot's
// greedy eviction search, filterSuperset and net priority, and the
// preemption score; on one thread (preempt_search) or shared by a group
// of 16 or 32 lanes (preempt_search_group, dense_preempt.cu on large
// clusters).
//
// Mirrors nomad_tpu/solver/binpack.py::_preempt_search_core op for op
// (the plain PyTorch version is solver/preempt.py _search_rows), for one
// row of A <= 64 candidates read from global memory; the row's candidate
// sets (valid now, eligible, picked, evicted) are 64-bit masks in
// registers. The sources build with -fmad=false; the distance's sum of
// squares is written as the fma() pair XLA contracts it into.
#pragma once

#include <climits>

#include "wave_common.cuh"

namespace nt {

typedef unsigned long long u64;

constexpr int kMaxA = 64;                 // solver/preempt.py MAX_A
constexpr double kMaxParallelPenalty = 50.0;   // preemption.go:16
constexpr double kPreemptScoreRate = 0.0048;   // rank.go preemptionScore
constexpr double kPreemptScoreOrigin = 2048.0;

__device__ __forceinline__ u64 bit(int a) { return 1ull << a; }

template <typename T> __device__ __forceinline__ T exp_(T x);
template <> __device__ __forceinline__ float exp_<float>(float x) {
  return expf(x);
}
template <> __device__ __forceinline__ double exp_<double>(double x) {
  return exp(x);
}

template <typename T> __device__ __forceinline__ T sqrt_(T x);
template <> __device__ __forceinline__ float sqrt_<float>(float x) {
  return sqrtf(x);
}
template <> __device__ __forceinline__ double sqrt_<double>(double x) {
  return sqrt(x);
}

// basicResourceDistance (preemption.go:611): a component is 0 where its
// need is <= 0; the sum of squares as XLA contracts it.
template <typename T>
__device__ __forceinline__ T distance(T ne_c, T ne_m, T ne_d, T uc, T um,
                                      T ud) {
  const T dc = ne_c > T(0) ? (ne_c - uc) / vmax(ne_c, T(1e-9)) : T(0);
  const T dm = ne_m > T(0) ? (ne_m - um) / vmax(ne_m, T(1e-9)) : T(0);
  const T dd = ne_d > T(0) ? (ne_d - ud) / vmax(ne_d, T(1e-9)) : T(0);
  return sqrt_<T>(fma_<T>(dd, dd, fma_<T>(dc, dc, dm * dm)));
}

// The logistic preemption score on net priority.
template <typename T>
__device__ __forceinline__ T preempt_score(T net_prio) {
  const T d = T(1) + exp_<T>(T(kPreemptScoreRate) *
                             (net_prio - T(kPreemptScoreOrigin)));
  return T(1) / d;
}

// A preempting node's score: (binpack + other + pscore) / (nscores + 1),
// binpack's / 18 fused with the first add as in final_score.
template <typename T>
__device__ __forceinline__ T preempt_final(T raw, T other, T pscore,
                                           T nscores) {
  return (fma_<T>(raw, T(1) / T(18), other) + pscore) / (nscores + T(1));
}

// One row's candidates: (A,) columns in global memory, stride 1.
template <typename T> struct CandRow {
  const T *cpu, *mem, *disk;
  const int *prio, *maxp, *grp;
};

template <typename T> struct SearchRes {
  bool met;
  u64 evict;
  T freed_c, freed_m, freed_d, net_prio;
};

// The max_parallel penalty of candidate a from its group's evictions so
// far in this eval (counts, the lane's (G,) table; read only for a
// candidate under a max_parallel limit).
template <typename T>
__device__ __forceinline__ T maxp_penalty(const CandRow<T>& c, int a,
                                          const int* counts) {
  const int g = c.grp[a], mp = c.maxp[a];
  const int n_pre = g >= 0 && mp > 0 ? counts[g] : 0;
  return (mp > 0 && n_pre >= mp)
             ? (T)(n_pre + 1 - mp) * T(kMaxParallelPenalty)
             : T(0);
}

// The greedy eviction search and filterSuperset of one row
// (_preempt_search_core): valid_now and eligible are the row's candidate
// masks, caps its capacity, ask the placement's ask.
template <typename T>
__device__ SearchRes<T> preempt_search(const CandRow<T>& c, int A,
                                       u64 valid_now, u64 eligible,
                                       T cap_c, T cap_m, T cap_d,
                                       const int* counts, T ask_c, T ask_m,
                                       T ask_d) {
  // the host Preemptor subtracts only the candidates' usage
  T sc = T(0), sm = T(0), sd = T(0);
  for (int a = 0; a < A; ++a)
    if (valid_now & bit(a)) {
      sc = sc + c.cpu[a];
      sm = sm + c.mem[a];
      sd = sd + c.disk[a];
    }
  const T avail_c0 = cap_c - sc, avail_m0 = cap_m - sm,
          avail_d0 = cap_d - sd;
  T av_c = avail_c0, av_m = avail_m0, av_d = avail_d0;
  T ne_c = ask_c, ne_m = ask_m, ne_d = ask_d;
  u64 picked = 0;
  for (int it = 0; it < A; ++it) {
    // the first pick is unconditional (allMet starts False)
    const bool met = av_c >= ask_c && av_m >= ask_m && av_d >= ask_d &&
                     picked != 0;
    const u64 cand = eligible & ~picked;
    if (met || cand == 0) break;        // the rest of the rounds no-op
    // ascending priority groups: only the lowest remaining priority
    int cur = INT_MAX;
    for (int a = 0; a < A; ++a)
      if (cand & bit(a)) cur = min(cur, c.prio[a]);
    // the first minimum of distance + penalty (host order on ties)
    int pick = -1;
    T best = T(0);
    for (int a = 0; a < A; ++a) {
      if (!(cand & bit(a)) || c.prio[a] != cur) continue;
      const T key = distance<T>(ne_c, ne_m, ne_d, c.cpu[a], c.mem[a],
                                c.disk[a]) +
                    maxp_penalty<T>(c, a, counts);
      if (pick < 0 || key < best) {
        pick = a;
        best = key;
      }
    }
    picked |= bit(pick);
    av_c = av_c + c.cpu[pick];
    av_m = av_m + c.mem[pick];
    av_d = av_d + c.disk[pick];
    ne_c = ne_c - c.cpu[pick];
    ne_m = ne_m - c.mem[pick];
    ne_d = ne_d - c.disk[pick];
  }
  SearchRes<T> r;
  r.met = av_c >= ask_c && av_m >= ask_m && av_d >= ask_d && picked != 0;

  // filterSuperset: take the picks in descending distance to the ask
  // (ties in candidate order, as a stable sort) until they cover it; if
  // no prefix covers it, the first pick alone (argmax of all-False is 0)
  u64 rem = picked, evict = 0;
  T cc = avail_c0, cm = avail_m0, cd = avail_d0;
  int first = -1;
  bool covered = false;
  while (rem) {
    int sel = -1;
    T bd = T(0);
    for (int a = 0; a < A; ++a) {
      if (!(rem & bit(a))) continue;
      const T d = distance<T>(ask_c, ask_m, ask_d, c.cpu[a], c.mem[a],
                              c.disk[a]);
      if (sel < 0 || d > bd) {
        sel = a;
        bd = d;
      }
    }
    rem &= ~bit(sel);
    if (first < 0) first = sel;
    evict |= bit(sel);
    cc = cc + c.cpu[sel];
    cm = cm + c.mem[sel];
    cd = cd + c.disk[sel];
    if (cc >= ask_c && cm >= ask_m && cd >= ask_d) {
      covered = true;
      break;
    }
  }
  if (!covered) evict = first >= 0 ? bit(first) : 0;
  r.evict = evict;

  // freed resources and netPriority (rank.go): the largest evicted
  // priority plus the sum over the largest
  // (the reference's max runs over every column, the unevicted ones as
  // 0; with all A columns evicted only over them)
  const u64 all = A == 64 ? ~0ull : bit(A) - 1;
  T fc = T(0), fm = T(0), fd = T(0), sp = T(0);
  T mx = evict == all ? neg_inf<T>() : T(0);
  for (int a = 0; a < A; ++a)
    if (evict & bit(a)) {
      fc = fc + c.cpu[a];
      fm = fm + c.mem[a];
      fd = fd + c.disk[a];
      const T p = (T)c.prio[a];
      mx = vmax(mx, p);
      sp = sp + p;
    }
  r.freed_c = fc;
  r.freed_m = fm;
  r.freed_d = fd;
  r.net_prio = mx > T(0) ? mx + sp / vmax(mx, T(1e-9)) : T(0);
  return r;
}

// The same search for one row shared by a group of W lanes (W = 16 for
// A <= 16, else 32; the group aligned within its warp): lane gl holds
// candidates gl and gl + W (J = 64 / W slots at most, A <= 64), loaded
// coalesced once. Each greedy round evaluates the candidates' distances
// in parallel (the same expression as preempt_search) and picks by a
// group arg-min with the same tie rule (the lowest index); the
// priority floor is a group min. The sums of the picks, filterSuperset
// and the freed resources and net priority run in candidate order on
// every lane (the values broadcast by shuffles), so the float results
// are preempt_search's bit for bit, identical on every lane. load_cands
// reads the row's (A,) columns (valid and evicted too) and the group
// counts of the max_parallel penalty; load_cand_cols takes the masks.
template <int W>
__device__ __forceinline__ unsigned group_mask() {
  return W == 32 ? kFull : (0xffffu << (threadIdx.x & 16));
}

template <int W, typename V>
__device__ __forceinline__ V group_bcast(const V* x, int a) {
  // x[0] holds candidate gl, x[1] candidate gl + W
  const V val = (W == 32 && a >= W) ? x[1] : x[0];
  return __shfl_sync(group_mask<W>(), val, a % W, W);
}

// The group's best (key, index) pair, returned as its index on every
// lane: the least key (MAX: the greatest), ties to the lowest index; a
// lane with index INT_MAX holds none. Keys are never negative or NaN
// (distances plus penalties), so in float their bits order as unsigned
// integers and two warp reductions find the pair; in double shuffles.
template <typename T, int W, bool MAX>
__device__ __forceinline__ int group_arg_best(T key, int idx) {
  const unsigned gm = group_mask<W>();
  if constexpr (sizeof(T) == 4) {
    // bits + 1, so that 0 marks a lane with none when taking the max
    const unsigned kb = __float_as_uint(key) + 1u;
    const unsigned best =
        MAX ? __reduce_max_sync(gm, idx == INT_MAX ? 0u : kb)
            : __reduce_min_sync(gm, idx == INT_MAX ? ~0u : kb);
    return (int)__reduce_min_sync(
        gm, idx != INT_MAX && kb == best ? (unsigned)idx : ~0u);
  } else {
#pragma unroll
    for (int off = W / 2; off > 0; off >>= 1) {
      const T ok = __shfl_xor_sync(gm, key, off, W);
      const int oi = __shfl_xor_sync(gm, idx, off, W);
      if (oi != INT_MAX &&
          (idx == INT_MAX || (MAX ? ok > key : ok < key) ||
           (ok == key && oi < idx))) {
        idx = oi;
        key = ok;
      }
    }
    return idx;
  }
}

// A group's candidate registers: lane gl's candidates gl and gl + W,
// and the row's candidate masks (valid now, eligible).
template <typename T, int W> struct CandRegs {
  static constexpr int J = W == 32 ? 2 : 1;
  T cpu[J], mem[J], disk[J], pen[J];
  int prio[J];
  u64 valid_now, eligible;
};

// The group's registers of a row whose candidate masks the caller
// holds (valid now, eligible): the columns read once, and the
// max_parallel penalties from the lane's group counts.
template <typename T, int W>
__device__ __forceinline__ CandRegs<T, W> load_cand_cols(
    const CandRow<T>& c, int A, u64 valid_now, u64 eligible,
    const int* counts) {
  constexpr int J = CandRegs<T, W>::J;
  const int gl = threadIdx.x & (W - 1);
  CandRegs<T, W> r;
  r.valid_now = valid_now;
  r.eligible = eligible;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int a = gl + W * j;
    const bool in = a < A;
    r.cpu[j] = in ? c.cpu[a] : T(0);
    r.mem[j] = in ? c.mem[a] : T(0);
    r.disk[j] = in ? c.disk[a] : T(0);
    r.prio[j] = in ? c.prio[a] : 0;
    r.pen[j] = in ? maxp_penalty<T>(c, a, counts) : T(0);
  }
  return r;
}

// The same from the row's valid and evicted bytes: the masks by ballot.
template <typename T, int W>
__device__ __forceinline__ CandRegs<T, W> load_cands(
    const CandRow<T>& c, int A, const unsigned char* valid,
    const unsigned char* evicted, int job_prio, const int* counts) {
  constexpr int J = CandRegs<T, W>::J;
  const unsigned gm = group_mask<W>();
  const int gl = threadIdx.x & (W - 1);
  const int gbase = (threadIdx.x & 31) & ~(W - 1);
  const unsigned wbits = W == 32 ? kFull : 0xffffu;
  u64 valid_now = 0, eligible = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int a = gl + W * j;
    const bool in = a < A;
    const bool vn = in && valid[a] && !evicted[a];
    const bool el = vn && job_prio - c.prio[a] >= 10;
    valid_now |= (u64)((__ballot_sync(gm, vn) >> gbase) & wbits) << (W * j);
    eligible |= (u64)((__ballot_sync(gm, el) >> gbase) & wbits) << (W * j);
  }
  return load_cand_cols<T, W>(c, A, valid_now, eligible, counts);
}

template <typename T, int W>
__device__ __forceinline__ SearchRes<T> preempt_search_group(
    const CandRegs<T, W>& cr, int A, T cap_c, T cap_m, T cap_d, T ask_c,
    T ask_m, T ask_d) {
  constexpr int J = CandRegs<T, W>::J;
  const unsigned gm = group_mask<W>();
  const int gl = threadIdx.x & (W - 1);
  const T *cpu = cr.cpu, *mem = cr.mem, *disk = cr.disk, *pen = cr.pen;
  const int* prio = cr.prio;
  const u64 valid_now = cr.valid_now, eligible = cr.eligible;
  T d0[J];
  // the host Preemptor subtracts only the candidates' usage (summed in
  // candidate order over the valid ones)
  T sc = T(0), sm = T(0), sd = T(0);
  for (u64 m = valid_now; m; m &= m - 1) {
    const int a = __ffsll((long long)m) - 1;
    sc = sc + group_bcast<W>(cpu, a);
    sm = sm + group_bcast<W>(mem, a);
    sd = sd + group_bcast<W>(disk, a);
  }
  const T avail_c0 = cap_c - sc, avail_m0 = cap_m - sm,
          avail_d0 = cap_d - sd;
  T av_c = avail_c0, av_m = avail_m0, av_d = avail_d0;
  T ne_c = ask_c, ne_m = ask_m, ne_d = ask_d;
  u64 picked = 0;
  for (int it = 0; it < A; ++it) {
    // the first pick is unconditional (allMet starts False)
    const bool met = av_c >= ask_c && av_m >= ask_m && av_d >= ask_d &&
                     picked != 0;
    const u64 cand = eligible & ~picked;
    if (met || cand == 0) break;        // the rest of the rounds no-op
    // ascending priority groups: only the lowest remaining priority
    int cur = INT_MAX;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (cand & bit(gl + W * j)) cur = min(cur, prio[j]);
    cur = __reduce_min_sync(gm, cur);
    // the first minimum of distance + penalty (host order on ties)
    int pick = INT_MAX;
    T best = T(0);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int a = gl + W * j;
      if (!(cand & bit(a)) || prio[j] != cur) continue;
      const T key = distance<T>(ne_c, ne_m, ne_d, cpu[j], mem[j], disk[j]) +
                    pen[j];
      if (pick == INT_MAX || key < best) {
        pick = a;
        best = key;
      }
    }
    pick = group_arg_best<T, W, false>(best, pick);
    picked |= bit(pick);
    const T pc = group_bcast<W>(cpu, pick), pm = group_bcast<W>(mem, pick),
            pd = group_bcast<W>(disk, pick);
    av_c = av_c + pc;
    av_m = av_m + pm;
    av_d = av_d + pd;
    ne_c = ne_c - pc;
    ne_m = ne_m - pm;
    ne_d = ne_d - pd;
  }
  SearchRes<T> r;
  r.met = av_c >= ask_c && av_m >= ask_m && av_d >= ask_d && picked != 0;

  // filterSuperset: the picks in descending distance to the ask (ties in
  // candidate order) until they cover it; else the first pick alone
#pragma unroll
  for (int j = 0; j < J; ++j)
    d0[j] = distance<T>(ask_c, ask_m, ask_d, cpu[j], mem[j], disk[j]);
  u64 rem = picked, evict = 0;
  T cc = avail_c0, cm = avail_m0, cd = avail_d0;
  int first = -1;
  bool covered = false;
  while (rem) {
    int sel = INT_MAX;
    T bd = T(0);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int a = gl + W * j;
      if (!(rem & bit(a))) continue;
      if (sel == INT_MAX || d0[j] > bd) {
        sel = a;
        bd = d0[j];
      }
    }
    sel = group_arg_best<T, W, true>(bd, sel);
    rem &= ~bit(sel);
    if (first < 0) first = sel;
    evict |= bit(sel);
    cc = cc + group_bcast<W>(cpu, sel);
    cm = cm + group_bcast<W>(mem, sel);
    cd = cd + group_bcast<W>(disk, sel);
    if (cc >= ask_c && cm >= ask_m && cd >= ask_d) {
      covered = true;
      break;
    }
  }
  if (!covered) evict = first >= 0 ? bit(first) : 0;
  r.evict = evict;

  // freed resources and netPriority, in candidate order (the evicted
  // candidates only: the same sums)
  const u64 all = A == 64 ? ~0ull : bit(A) - 1;
  T fc = T(0), fm = T(0), fd = T(0), sp = T(0);
  T mx = evict == all ? neg_inf<T>() : T(0);
  for (u64 m = evict; m; m &= m - 1) {
    const int a = __ffsll((long long)m) - 1;
    fc = fc + group_bcast<W>(cpu, a);
    fm = fm + group_bcast<W>(mem, a);
    fd = fd + group_bcast<W>(disk, a);
    const T pp = (T)group_bcast<W>(prio, a);
    mx = vmax(mx, pp);
    sp = sp + pp;
  }
  r.freed_c = fc;
  r.freed_m = fm;
  r.freed_d = fd;
  r.net_prio = mx > T(0) ? mx + sp / vmax(mx, T(1e-9)) : T(0);
  return r;
}

}  // namespace nt
