// The eviction search shared by the two preemption kernels
// (wave_preempt.cu, dense_preempt.cu): one node's or window slot's
// greedy eviction search, filterSuperset and net priority, and the
// preemption score.
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
// far in this eval (counts, the lane's (G,) table).
template <typename T>
__device__ __forceinline__ T maxp_penalty(const CandRow<T>& c, int a,
                                          const int* counts) {
  const int g = c.grp[a], mp = c.maxp[a];
  const int n_pre = g >= 0 ? counts[g] : 0;
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

}  // namespace nt
