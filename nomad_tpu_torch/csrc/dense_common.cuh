// Per-node fit and score shared by the dense scan kernel (dense_scan.cu)
// and the system fit kernel (system_fit.cu).
//
// Each expression mirrors nomad_tpu/solver/binpack.py _scoring_parts and
// _solve_system_impl op for op, with the same association, and the score
// terms come from wave_common.cuh (binpack_raw, final_score, anti_term),
// so results agree with the plain PyTorch versions to the bit. The
// sources build with -fmad=false; the two contractions XLA's lowering
// makes are written out as fma(): the reserved-core cpu ask
// (ask_cpu + ask_cores * mhz_per_core) and the score's reciprocal
// multiply-add.
#pragma once

#include "wave_common.cuh"

namespace nt {

// Effective cpu ask on one node: core-asking tasks' cpu becomes
// mhz_per_core * cores there (rank.go:481-524)
template <typename T>
__device__ __forceinline__ T eff_cpu_ask(T ask_cpu, int ask_cores, T mhz,
                                         bool has_cores) {
  return has_cores ? fma_<T>((T)ask_cores, mhz, ask_cpu) : ask_cpu;
}

// Resource fit and the clipped binpack fitness (before its / 18) of one
// node after the ask: the system score and the dense score's first term.
// free_* divide by max(cap, 1e-9) as the reference does.
template <typename T>
__device__ __forceinline__ bool fits_resources(T used_cpu, T used_mem,
                                               T used_disk, T cpu_cap,
                                               T mem_cap, T disk_cap,
                                               T eff_cpu, T ask_mem,
                                               T ask_disk) {
  return used_cpu + eff_cpu <= cpu_cap && used_mem + ask_mem <= mem_cap &&
         used_disk + ask_disk <= disk_cap;
}

template <typename T>
__device__ __forceinline__ T binpack_after(T used_cpu, T used_mem,
                                           T cpu_cap, T mem_cap, T eff_cpu,
                                           T ask_mem, bool spread_alg) {
  const T free_cpu = T(1) - (used_cpu + eff_cpu) / vmax(cpu_cap, T(1e-9));
  const T free_mem = T(1) - (used_mem + ask_mem) / vmax(mem_cap, T(1e-9));
  return binpack_raw<T>(free_cpu, free_mem, spread_alg);
}

// One spread's boost for a node with value index vi (spread.go
// SpreadIterator + evenSpreadScoreBoost; binpack.py _spread_score):
// cur is the value's current count, des its desired count, wfrac the
// spread's weight share; mn / mx / any are the min and max count over
// present (count > 0) values and whether any is present.
template <typename T>
__device__ __forceinline__ T spread_boost(int vi, int cur, T des,
                                          bool has_targets, T wfrac,
                                          int mn, int mx, bool any) {
  if (vi < 0) return T(-1);             // attribute missing on the node
  if (has_targets) {
    return (des < T(0) || des == T(0))
               ? T(-1)
               : (des - (T)(cur + 1)) / vmax(des, T(1e-9)) * wfrac;
  }
  if (!any) return T(0);
  const T min_f = (T)mn, max_f = (T)mx, cur_f = (T)cur;
  if (cur != mn)
    return mn == 0 ? T(-1) : (min_f - cur_f) / vmax(min_f, T(1e-9));
  return mn == mx ? T(-1) : (max_f - min_f) / vmax(min_f, T(1e-9));
}

// The dense score of a fit node: binpack plus the other terms over the
// number of terms present, summed in the reference's order
// ((anti + resched) + affinity) + spread [+ device affinity].
template <typename T>
__device__ __forceinline__ T dense_score(T binpack, T coll, T count,
                                         bool is_pen, T aff, T spread,
                                         bool has_dev, T dev_score,
                                         bool dev_present) {
  const T anti = anti_term<T>(coll, count);
  const T resched = is_pen ? T(-1) : T(0);
  T nscores = T(1) + (coll > T(0) ? T(1) : T(0));
  nscores = nscores + (is_pen ? T(1) : T(0));
  nscores = nscores + (aff != T(0) ? T(1) : T(0));
  nscores = nscores + (spread != T(0) ? T(1) : T(0));
  T other = ((anti + resched) + aff) + spread;
  if (has_dev) {
    nscores = nscores + (dev_present ? T(1) : T(0));
    other = other + dev_score;
  }
  return final_score<T>(binpack, other, nscores);
}

}  // namespace nt
