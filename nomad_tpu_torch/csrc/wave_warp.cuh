// The wave kernels' window step without block-wide scans
// (wave_block.cu, wave_compact.cu, wavefront.cu): the warp-level window
// scan, arg-best and saturation shift, the per-placement step loop
// (wave_compact_lane, launched alone as wave_compact_kernel) and the
// run-block loop (wave_block_lane). wavefront.cu runs either loop per
// lane in one step kernel.
//
// Window slot k = 32 r + lane lives in register word r of a thread: the
// run-block kernel holds a lane in one warp (R = B / 32 words a thread),
// the step loop one slot a thread over NW = B / 32 step warps, beside a
// head warp that scores heads ahead of the commits. Within a warp:
//   - the window scan (select.go:38-77) is two ballots a word (fit, low)
//     and popcounts under the lane mask: the inclusive counts
//     select_slot (wave_common.cuh) derives from its packed block scan;
//   - the arg-best is a redux.sync max over an order-preserving int image
//     of the score among yielded slots, then a redux.sync min over
//     order * B + slot among the slots at that key (better()'s order);
//     float64 keys take a 64-bit shuffle butterfly for the max, as redux
//     has no 64-bit form;
//   - saturation shifts slots left with one shuffle per word and field
//     (lane 31 takes lane 0 of the next word).
// The expressions scored per slot are those of head_terms and
// final_score, in the same order, so results equal the plain PyTorch
// versions bit for bit.
#pragma once

#include "wave_common.cuh"

namespace nt {

constexpr int kMaxSpreads = 16;         // spreads held in registers

// the lanes at and below this one
__device__ __forceinline__ unsigned lanemask_le() {
  return kFull >> (31 - (threadIdx.x & 31));
}

// Order-preserving integer image of a score: a > b as keys iff a > b as
// values, with -0.0 and +0.0 one key (better() holds them equal).
__device__ __forceinline__ int order_key(float x) {
  const int b = x == 0.0f ? 0 : __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ long long order_key(double x) {
  const long long b = x == 0.0 ? 0LL : __double_as_longlong(x);
  return b >= 0 ? b : b ^ 0x7fffffffffffffffLL;
}
__device__ __forceinline__ int key_floor(int) { return INT_MIN; }
__device__ __forceinline__ long long key_floor(long long) {
  return LLONG_MIN;
}

// Warp-wide max of keys: redux.sync for 32-bit keys, a butterfly for
// 64-bit ones.
__device__ __forceinline__ int warp_max(int k) {
  return __reduce_max_sync(kFull, k);
}
__device__ __forceinline__ long long warp_max(long long k) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long o = __shfl_xor_sync(kFull, k, off);
    k = o > k ? o : k;
  }
  return k;
}

// v[r] for a warp-uniform r, without indexing registers dynamically
template <int R, typename X>
__device__ __forceinline__ X pick(const X (&v)[R], int r) {
  X x = v[0];
#pragma unroll
  for (int q = 1; q < R; ++q)
    if (q == r) x = v[q];
  return x;
}

// The window over slots k = 32 r + lane: yielded, order and n_yielded as
// select_slot computes them (skip_rank = inclusive count of low slots,
// the counted position = inclusive count of fit slots - min(skip_rank,
// MAX_SKIP), the fallback for the deficit).
template <int R>
__device__ __forceinline__ int warp_select(const bool (&fit)[R],
                                           const bool (&low)[R], int L,
                                           bool (&yielded)[R],
                                           int (&order)[R]) {
  const unsigned le = lanemask_le();
  int incl_f[R], incl_l[R];
  int tot_f = 0, tot_l = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const unsigned fm = __ballot_sync(kFull, fit[r]);
    const unsigned lm = __ballot_sync(kFull, low[r]);
    incl_f[r] = tot_f + __popc(fm & le);
    incl_l[r] = tot_l + __popc(lm & le);
    tot_f += __popc(fm);
    tot_l += __popc(lm);
  }
  const int total_counted = tot_f - min(tot_l, kMaxSkip);
  const int deficit = max(0, L - min(total_counted, L));
  int ny = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int skip_rank = incl_l[r];
    const int srank = min(skip_rank, kMaxSkip);
    const bool skipped = low[r] && skip_rank <= kMaxSkip;
    const int cpos = incl_f[r] - srank;
    const bool window = fit[r] && !skipped && cpos <= L;
    const bool fallback = skipped && srank <= deficit;
    yielded[r] = window || fallback;
    order[r] = window ? cpos : L + srank;
    ny += __popc(__ballot_sync(kFull, yielded[r]));
  }
  return ny;
}

// The best slot among those with `on` set, by better()'s order: higher
// eff, then smaller window order, then smaller slot. Returns order * B +
// slot (INT_MAX when no slot is on); the slot is the low log2(B) bits.
template <typename T, int R>
__device__ __forceinline__ int warp_best(const T (&eff)[R],
                                         const bool (&on)[R],
                                         const int (&order)[R]) {
  constexpr int B = 32 * R;
  const int lane = threadIdx.x & 31;
  auto m = key_floor(order_key(T(0)));
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const auto k = order_key(eff[r]);
    if (on[r] && k > m) m = k;
  }
  m = warp_max(m);
  int io = INT_MAX;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (on[r] && order_key(eff[r]) == m)
      io = min(io, order[r] * B + 32 * r + lane);
  return __reduce_min_sync(kFull, io);
}

template <typename T>
__device__ __forceinline__ Slot<T> shfl_slot(const Slot<T>& s, int src) {
  Slot<T> o;
  o.c = __shfl_sync(kFull, s.c, src);
  o.ucpu = __shfl_sync(kFull, s.ucpu, src);
  o.umem = __shfl_sync(kFull, s.umem, src);
  o.ccap = __shfl_sync(kFull, s.ccap, src);
  o.mcap = __shfl_sync(kFull, s.mcap, src);
  o.placed = __shfl_sync(kFull, s.placed, src);
  o.aff = __shfl_sync(kFull, s.aff, src);
  o.pos = __shfl_sync(kFull, s.pos, src);
  o.j = __shfl_sync(kFull, s.j, src);
  return o;
}

template <typename T>
__device__ __forceinline__ Head<T> shfl_head(const Head<T>& h, int src) {
  Head<T> o;
  o.fit = __shfl_sync(kFull, (int)h.fit, src) != 0;
  o.binpack = __shfl_sync(kFull, h.binpack, src);
  o.coll = __shfl_sync(kFull, h.coll, src);
  o.anti = __shfl_sync(kFull, h.anti, src);
  return o;
}

template <typename X>
__device__ __forceinline__ X shfl_any(const X& x, int src) {
  return __shfl_sync(kFull, x, src);
}
__device__ __forceinline__ bool shfl_any(const bool& x, int src) {
  return __shfl_sync(kFull, (int)x, src) != 0;
}
template <typename T>
__device__ __forceinline__ Slot<T> shfl_any(const Slot<T>& x, int src) {
  return shfl_slot(x, src);
}

// Saturation (binpack.py _wave_refill_shift) on one per-slot field: slots
// k >= w take slot k + 1's value, slot B - 1 takes `last`. Words wholly
// below w keep theirs (w is warp-uniform).
template <int R, typename X>
__device__ __forceinline__ void warp_shift(X (&v)[R], int w,
                                           const X& last) {
  const int lane = threadIdx.x & 31;
  X rot[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (32 * r + 32 > w) rot[r] = shfl_any(v[r], (lane + 1) & 31);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (32 * r + 32 <= w) continue;
    const X nxt = lane < 31 ? rot[r] : (r + 1 < R ? rot[min(r + 1, R - 1)]
                                                  : last);
    if (32 * r + lane >= w) v[r] = nxt;
  }
}

// The desired counts (S, V) of a lane: in dynamic shared memory where
// they fit beside the counts, else read through the read-only cache
// (the launcher decides, so that any V whose counts fit runs).
template <typename T> struct Desired {
  const T* sh;                          // shared copy, when on_sh
  const T* gl;                          // the lane's global table
  bool on_sh;
  __device__ __forceinline__ T operator()(int k) const {
    return on_sh ? sh[k] : __ldg(gl + k);
  }
};

// One spread's boost for a slot with value index vi (spread.go
// SpreadIterator + evenSpreadScoreBoost), the expressions of
// scoring._spread_boost; cur and des are the count and the desired count
// of value max(vi, 0) (des read only by the target form); mn / mx / any
// are the even form's statistics over present (count > 0) values.
// Branch-free: the one division either form takes runs on the operands
// of the slot's case, and selects give the -1 / 0 cases, so a warp's
// slots never diverge here.
template <typename T>
__device__ __forceinline__ T spread_boost(int vi, int cur, T des, bool has_t,
                                          T wfrac, int mn, int mx,
                                          bool any) {
  const T min_f = (T)mn, max_f = (T)mx, cur_f = (T)cur;
  const T num = has_t ? des - (T)(cur + 1)
                      : (cur != mn ? min_f - cur_f : max_f - min_f);
  const T quo = num / vmax(has_t ? des : min_f, T(1e-9));
  const T b_t = (des < T(0) || des == T(0)) ? T(-1) : quo * wfrac;
  const T b_e = !any ? T(0)
                     : ((cur != mn ? mn == 0 : mn == mx) ? T(-1) : quo);
  return vi < 0 ? T(-1) : (has_t ? b_t : b_e);  // -1: attribute missing
}

// The even form's statistics of one spread's V counts, one value a lane
// (looping over V > 32): min and max over present values, any present.
__device__ __forceinline__ void spread_stats(const int* counts, int V,
                                             int& mn, int& mx, bool& any) {
  const int lane = threadIdx.x & 31;
  int lo = INT_MAX, hi = 0;
  unsigned a = 0;
  for (int v = lane; v < V; v += 32) {
    const int c = counts[v];
    if (c > 0) {
      a = 1;
      lo = min(lo, c);
      hi = max(hi, c);
    }
  }
  mn = __reduce_min_sync(kFull, lo);
  mx = __reduce_max_sync(kFull, hi);
  any = __reduce_or_sync(kFull, a) != 0;
}

// Named barriers of the step loop: 1 joins the step warps (NW > 1), 2
// the step warps and the head warp.
#ifndef NT_BAR_SYNC
#define NT_BAR_SYNC(id, n) \
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory")
#endif

// The head warp's clocks (chip_smoke.py --ab-clocks): cycles of block 0's
// head warp waiting for a commit (9) and scoring heads (10).
#ifdef NT_STEP_CLOCKS
#define NT_HCLK(i)                                                \
  do {                                                            \
    if (blockIdx.x == 0 && (threadIdx.x & 31) == 0) {             \
      const unsigned long long nt_n = clock64();                  \
      nt::nt_clk[i] += nt_n - nt_h;                               \
      nt_h = nt_n;                                                \
    }                                                             \
  } while (0)
#define NT_HCLK_T0() unsigned long long nt_h = clock64()
#else
#define NT_HCLK(i) do {} while (0)
#define NT_HCLK_T0() do {} while (0)
#endif

// What the step warps tell the head warp at a commit: the winner w
// after it (copies taken j), whether it saturated; done ends the loop.
template <typename T> struct HeadMsg {
  Slot<T> ws;
  int w, sat, done;
};

// The head warp of wave_compact_kernel: keeps every slot's head at its
// next placement (hnext, its j + 1) and row nx's head at j = 0 (hrow),
// one commit ahead of the step warps. After each commit it scores the
// winner's head at j + 1 (its head should it win again), or on a
// saturation shifts hnext and scores the refilled slot's next head (row
// nx at j = 1) beside the following refill row's head (at j = 0), rows
// it holds a refill ahead. Each result goes to the buffer of the next
// commit's parity, so the step warps read one buffer while it fills the
// other.
template <typename T, int NW>
__device__ void head_warp(const T* cm, int C, int W, T ask_cpu, T ask_mem,
                          T count, bool salg, Head<T> (*hnext)[32 * NW],
                          Head<T>* hrow, const HeadMsg<T>* msg) {
  constexpr int B = 32 * NW;
  constexpr int NT = 32 * (NW + 1);
  const int lane = threadIdx.x & 31;
  for (int k = lane; k < B; k += 32) {
    Slot<T> sk;
    load_row(sk, cm + (size_t)k * W);
    sk.j = 1;
    hnext[0][k] = head_terms<T>(sk, ask_cpu, ask_mem, count, salg);
  }
  int cursor = B;
  Slot<T> nx, nx2;
  load_row(nx, cm + (size_t)min(cursor, C - 1) * W);
  load_row(nx2, cm + (size_t)min(cursor + 1, C - 1) * W);
  {
    const Head<T> hr = head_terms<T>(nx, ask_cpu, ask_mem, count, salg);
    if (lane == 0) hrow[0] = hr;
  }
  NT_HCLK_T0();
  for (int nc = 0;; ++nc) {
    NT_BAR_SYNC(2, NT);
    NT_HCLK(9);
    const HeadMsg<T>& m = msg[nc & 1];
    if (m.done) break;
    const Head<T>* src = hnext[nc & 1];
    Head<T>* dst = hnext[(nc + 1) & 1];
    const int w = m.w;
    if (!m.sat) {
      Slot<T> sw = m.ws;
      sw.j += 1;
      const Head<T> hw = head_terms<T>(sw, ask_cpu, ask_mem, count, salg);
      for (int k = lane; k < B; k += 32) dst[k] = k == w ? hw : src[k];
      if (lane == 0) hrow[(nc + 1) & 1] = hrow[nc & 1];
      NT_HCLK(10);
      continue;
    }
    // lanes below 16: the refilled slot's next head (row nx at j = 1);
    // the others: the following refill row's head (nx2 at j = 0)
    Slot<T> sr = lane < 16 ? nx : nx2;
    sr.j = lane < 16 ? 1 : 0;
    const Head<T> hh = head_terms<T>(sr, ask_cpu, ask_mem, count, salg);
    const Head<T> hl = shfl_head(hh, 0), hr = shfl_head(hh, 16);
    for (int k = lane; k < B; k += 32)
      dst[k] = k < w ? src[k] : (k < B - 1 ? src[k + 1] : hl);
    if (lane == 0) hrow[(nc + 1) & 1] = hr;
    nx = nx2;
    ++cursor;
    load_row(nx2, cm + (size_t)min(cursor + 1, C - 1) * W);
    NT_HCLK(10);
  }
}

// A warp's lane-0 slot, which lane 31 of the warp below takes on a
// saturation shift (NW > 1).
template <typename T, int SM> struct Edge {
  Slot<T> s;
  Head<T> h;
  int sv[SM > 0 ? SM : 1];
  int rw;                               // its compact row (SM = kMaxSpreads)
};

// A warp's part of a step's arg-best (NW > 1): its best key and order *
// B + slot, its n_yielded, and its best slot's state for the commit.
template <typename T, int SM> struct WarpRec {
  Slot<T> s;
  T fin;
  decltype(order_key(T())) key;
  int io, ny;
  int sv[SM > 0 ? SM : 1];
  int cur[SM > 0 ? SM : 1];             // its spread values' counts
  int rw;
};

// The per-placement step loop (binpack.py _solve_wave_compact_impl, and
// the step of _solve_wavefront_impl): one thread per window slot over NW
// step warps (B = 32 NW; NW = 1 at B = 32, 4 at B = 128), and a head
// warp (head_warp). A slot's compact row, copies taken j, its cached
// head terms (fit, clipped binpack, coll, anti: changed only when its j
// changes or it is refilled) and its first SM spread value indexes live
// in registers; spread counts (S, V) in dynamic shared memory, one copy,
// and desired counts (S, V) beside them where they fit (dyn_smem; else
// read from global memory, Desired; target spreads only read them); the
// even-form statistics of those spreads live in registers, refreshed by
// redux after a bump. Spreads past
// SM (S > kMaxSpreads, SM = kMaxSpreads only) take their value index
// from the slot's compact row, whose number rides in a register, and
// their statistics by redux at every step. A step scores every slot (the
// penalty, the spread boosts and final_score over the cached terms),
// runs the ballot window and the redux arg-best; with NW > 1 the step
// warps add their window counts and then their best slots through shared
// memory (named barrier 1, twice a step). Every step warp then commits
// alike: thread 0 bumps the winner's counts and the commit goes to the
// head warp (named barrier 2, which also publishes the bump), whose
// tables give the winner's thread its new head, or on saturation the
// refilled slot's head while the slots shift left by shuffles (lane 31
// takes lane 0 of the warp above from shared memory, the last slot the
// next compact row, loaded one refill ahead).
// Penalties arrive 32 steps a load, loaded a chunk ahead; outputs leave
// 32 steps a store. Once a step places nothing the lane's state is
// frozen: steps without a penalty repeat its output (a whole chunk's
// run of them at once), steps with one are scored again (the penalty
// moves scores). SM = 0 takes no spread code; S <= SM. It runs lane e
// in a block of step_threads(NW) threads; the kernel that calls it holds
// the static tables (sh) and the dynamic shared memory (smem).
template <typename T, int NW, int SM> struct CompactShared {
  int wtot[NW][2];
  WarpRec<T, SM> rec[NW];
  Edge<T, SM> edge[2][NW];
  Head<T> hnext[2][32 * NW];
  Head<T> hrow[2];
  HeadMsg<T> msg[2];
};

template <typename T, int NW, int SM>
__device__ __forceinline__ void wave_compact_lane(
    const T* __restrict__ compact, const T* __restrict__ scal_f,
    const int* __restrict__ scal_i, const int* __restrict__ pen,
    const int* __restrict__ sp_counts, const T* __restrict__ sp_desired,
    const unsigned char* __restrict__ sp_has_targets,
    const T* __restrict__ sp_weights, const T* __restrict__ sp_sum_weights,
    long long* __restrict__ chosen, T* __restrict__ scores,
    long long* __restrict__ n_yielded, int C, int W, int S, int V,
    int spread_alg, int desired_smem, int e, CompactShared<T, NW, SM>& sh,
    unsigned char* smem) {
  constexpr int B = 32 * NW;
  constexpr int NT = 32 * (NW + 1);
  constexpr int SMA = SM > 0 ? SM : 1;
  constexpr bool XS = SM == kMaxSpreads;  // spreads past SM can run
  using K = decltype(order_key(T()));
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int P = C - B;
  const T* cm = compact + (size_t)e * C * W;
  const T ask_cpu = scal_f[e * 3 + 0], ask_mem = scal_f[e * 3 + 1];
  const T count = scal_f[e * 3 + 2];
  const int L = scal_i[e * 2 + 0], n_active = scal_i[e * 2 + 1];
  const int* pen_e = pen + (size_t)e * P;
  long long* ch_e = chosen + (size_t)e * P;
  T* sc_e = scores + (size_t)e * P;
  long long* ny_e = n_yielded + (size_t)e * P;
  const bool salg = spread_alg != 0;
  const bool xs = XS && S > SM;         // spreads past SM this launch
  const unsigned le = lanemask_le();

  // dynamic: desired (S*V T) when desired_smem, then the counts (S*V int)
  T* dsh = reinterpret_cast<T*>(smem);
  int* counts = reinterpret_cast<int*>(
      smem + (desired_smem ? (size_t)S * V * sizeof(T) : 0));
  const Desired<T> desired{dsh, sp_desired + (size_t)e * S * V,
                           desired_smem != 0};
  auto& wtot = sh.wtot;
  auto& rec = sh.rec;
  auto& edge = sh.edge;
  auto& hnext = sh.hnext;
  auto& hrow = sh.hrow;
  auto& msg = sh.msg;
  if (SM > 0 && warp < NW) {
    for (int k = tid; k < S * V; k += B) {
      if (desired_smem) dsh[k] = sp_desired[(size_t)e * S * V + k];
      counts[k] = sp_counts[(size_t)e * S * V + k];
    }
  }
  __syncthreads();
  if (warp == NW) {
    head_warp<T, NW>(cm, C, W, ask_cpu, ask_mem, count, salg, hnext, hrow,
                     msg);
    return;
  }
  bool has_t[SMA];
  T wfrac[SMA];
  int smin[SMA], smax[SMA];
  bool sany[SMA];
  if (SM > 0) {
#pragma unroll
    for (int q = 0; q < SM; ++q) {
      if (q >= S) break;
      has_t[q] = sp_has_targets[(size_t)e * S + q] != 0;
      wfrac[q] = sp_weights[(size_t)e * S + q] /
                 vmax(sp_sum_weights[e], T(1e-9));
      spread_stats(counts + q * V, V, smin[q], smax[q], sany[q]);
    }
  }

  Slot<T> s;
  int sv[SMA];
  int rw = tid;                         // the slot's compact row (xs)
  {
    const T* row = cm + (size_t)tid * W;
    load_row(s, row);
#pragma unroll
    for (int q = 0; q < SM; ++q)
      if (q < S) sv[q] = (int)row[8 + q];
  }
  Head<T> h = head_terms<T>(s, ask_cpu, ask_mem, count, salg);
  // the next refill row (row min(cursor, C - 1)), loaded one refill ahead
  int cursor = B;
  int nx_rw = min(cursor, C - 1);
  Slot<T> nx;
  int nx_sv[SMA];
  {
    const T* row = cm + (size_t)min(cursor, C - 1) * W;
    load_row(nx, row);
#pragma unroll
    for (int q = 0; q < SM; ++q)
      if (q < S) nx_sv[q] = (int)row[8 + q];
  }
  int nc = 0;                           // commits so far
  int pen_next = lane < P ? pen_e[lane] : -1;
  // once a step places nothing the state is frozen for good; later steps
  // without a penalty then repeat that step's output (cached here)
  int frozen_ny = -1;
  T frozen_sc = T(0);
  int par = 0;                          // edge buffer of this step
  NT_TOTAL_T0();
  NT_T0();

  for (int base = 0; base < P; base += 32) {
    const int pen_c = pen_next;         // this chunk's penalties, a lane each
    pen_next = base + 32 + lane < P ? pen_e[base + 32 + lane] : -1;
    const int n_in = min(32, P - base);
    long long st_ch = -1;               // staged outputs of step base + lane
    T st_sc = T(0);
    int st_ny = 0;
    for (int u = 0; u < n_in; ++u) {
      if (frozen_ny >= 0) {
        // the frozen output up to the chunk's next penalty step
        const unsigned pm =
            __ballot_sync(kFull, pen_c >= 0 && lane >= u && lane < n_in);
        const int nxt = pm ? __ffs(pm) - 1 : n_in;
        if (lane >= u && lane < nxt) {
          st_ch = -1;
          st_sc = frozen_sc;
          st_ny = frozen_ny;
        }
        if (nxt >= n_in) break;
        u = nxt;
      }
      const int i = base + u;
      const int pen_i = __shfl_sync(kFull, pen_c, u);
      NT_RESET();
      NT_CNT(7, 1);
      // per-placement reschedule penalty via the pos column (exact ints)
      const bool is_pen = pen_i >= 0 && s.pos == (T)pen_i;
      const T resched = is_pen ? T(-1) : T(0);
      T spread_total = T(0);
      int scur[SMA];                    // the slot's values' counts
#pragma unroll
      for (int q = 0; q < SM; ++q) {
        if (q >= S) break;
        const int v = q * V + max(sv[q], 0);
        scur[q] = counts[v];
        const T des = has_t[q] ? desired(v) : T(0);
        spread_total = spread_total +
                       spread_boost<T>(sv[q], scur[q], des, has_t[q],
                                       wfrac[q], smin[q], smax[q], sany[q]);
      }
      for (int q = SM; xs && q < S; ++q) {
        int mn, mx;
        bool an;
        spread_stats(counts + q * V, V, mn, mx, an);
        const int vi = (int)cm[(size_t)rw * W + 8 + q];
        const int v = q * V + max(vi, 0);
        const bool ht = sp_has_targets[(size_t)e * S + q] != 0;
        const T des = ht ? desired(v) : T(0);
        spread_total =
            spread_total +
            spread_boost<T>(vi, counts[v], des, ht,
                            sp_weights[(size_t)e * S + q] /
                                vmax(sp_sum_weights[e], T(1e-9)),
                            mn, mx, an);
      }
      const T affs = s.aff;
      T nscores = T(1) + (h.coll > T(0) ? T(1) : T(0));
      nscores = nscores + (is_pen ? T(1) : T(0));
      nscores = nscores + (affs != T(0) ? T(1) : T(0));
      nscores = nscores + (spread_total != T(0) ? T(1) : T(0));
      const T fin = final_score<T>(
          h.binpack, ((h.anti + resched) + affs) + spread_total, nscores);
      const bool low = h.fit && fin <= T(0);
      NT_CLK(0);
      par ^= 1;
      if (NW > 1 && lane == 0) {
        edge[par][warp].s = s;
        edge[par][warp].h = h;
#pragma unroll
        for (int q = 0; q < SM; ++q) {
          if (q >= S) break;
          edge[par][warp].sv[q] = sv[q];
        }
        if (xs) edge[par][warp].rw = rw;
      }
      // the window: inclusive counts of fit and low slots from ballots
      const unsigned fm = __ballot_sync(kFull, h.fit);
      const unsigned lm = __ballot_sync(kFull, low);
      int incl_f = __popc(fm & le), incl_l = __popc(lm & le);
      int tot_f = __popc(fm), tot_l = __popc(lm);
      if (NW > 1) {
        if (lane == 0) {
          wtot[warp][0] = tot_f;
          wtot[warp][1] = tot_l;
        }
        NT_BAR_SYNC(1, B);
        tot_f = tot_l = 0;
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          const int a = wtot[k][0], b = wtot[k][1];
          if (k < warp) {
            incl_f += a;
            incl_l += b;
          }
          tot_f += a;
          tot_l += b;
        }
      }
      const int total_counted = tot_f - min(tot_l, kMaxSkip);
      const int deficit = max(0, L - min(total_counted, L));
      const int srank = min(incl_l, kMaxSkip);
      const bool skipped = low && incl_l <= kMaxSkip;
      const int cpos = incl_f - srank;
      const bool window = h.fit && !skipped && cpos <= L;
      const bool yielded = window || (skipped && srank <= deficit);
      const int order = window ? cpos : L + srank;
      int ny = __popc(__ballot_sync(kFull, yielded));
      NT_CLK(1);
      // the arg-best: the largest key, then the least order * B + slot
      const K key = order_key(fin);
      K m = warp_max(yielded ? key : key_floor(key));
      int io = __reduce_min_sync(
          kFull, yielded && key == m ? order * B + tid : INT_MAX);
      Slot<T> ws;
      T fin_w;
      int vw[SMA], cw[SMA];             // the winner's values and counts
      int rw_w = 0;
      if (NW > 1) {
        if (lane == 0) {
          rec[warp].key = m;
          rec[warp].io = io;
          rec[warp].ny = ny;
        }
        if (io != INT_MAX && tid == (io & (B - 1))) {
          rec[warp].s = s;
          rec[warp].fin = fin;
#pragma unroll
          for (int q = 0; q < SM; ++q) {
            if (q >= S) break;
            rec[warp].sv[q] = sv[q];
            rec[warp].cur[q] = scur[q];
          }
          if (xs) rec[warp].rw = rw;
        }
        NT_BAR_SYNC(1, B);
        m = rec[0].key;
        io = rec[0].io;
        ny = rec[0].ny;
#pragma unroll
        for (int k = 1; k < NW; ++k) {
          const K km = rec[k].key;
          const int ki = rec[k].io;
          ny += rec[k].ny;
          if (km > m || (km == m && ki < io)) {
            m = km;
            io = ki;
          }
        }
        const int wr = (io & (B - 1)) >> 5;
        ws = rec[wr].s;
        fin_w = rec[wr].fin;
#pragma unroll
        for (int q = 0; q < SM; ++q) {
          if (q >= S) break;
          vw[q] = rec[wr].sv[q];
          cw[q] = rec[wr].cur[q];
        }
        if (xs) rw_w = rec[wr].rw;
      } else {
        const int lw = io & 31;
        ws = shfl_slot(s, lw);
        fin_w = __shfl_sync(kFull, fin, lw);
#pragma unroll
        for (int q = 0; q < SM; ++q) {
          if (q >= S) break;
          vw[q] = __shfl_sync(kFull, sv[q], lw);
          cw[q] = __shfl_sync(kFull, scur[q], lw);
        }
        if (xs) rw_w = __shfl_sync(kFull, rw, lw);
      }
      const int w = io & (B - 1);
      const T score_out = ny > 0 ? fin_w : neg_inf<T>();
      NT_CLK(2);
      if (!(i < n_active && ny > 0)) {
        // nothing placed: no commit (the penalty only moves this score)
        if (lane == u) {
          st_ch = -1;
          st_sc = score_out;
          st_ny = ny;
        }
        if (pen_i < 0) {
          frozen_sc = score_out;
          frozen_ny = ny;
        }
        NT_CLK(3);
        continue;
      }
      if (lane == u) {
        st_ch = (long long)ws.pos;
        st_sc = score_out;
        st_ny = ny;
      }
      ws.j += 1;
      const bool sat = (T)ws.j >= ws.c;
      // hand the commit to the head warp and take its heads for it;
      // thread 0 bumps the winner's counts (stores of the counts it was
      // scored with, plus one), which every step warp has done reading
      // for this step (past barrier 1, or in its one warp's ballots),
      // and barrier 2 publishes the bump
      HeadMsg<T>& mo = msg[nc & 1];
      if (tid == 0) {
        mo.ws = ws;
        mo.w = w;
        mo.sat = sat;
        mo.done = 0;
#pragma unroll
        for (int q = 0; q < SM; ++q) {
          if (q >= S) break;
          if (vw[q] >= 0) counts[q * V + vw[q]] = cw[q] + 1;
        }
        for (int q = SM; xs && q < S; ++q) {
          const int v = (int)cm[(size_t)rw_w * W + 8 + q];
          if (v >= 0) counts[q * V + v] += 1;
        }
      }
      NT_BAR_SYNC(2, NT);
      const Head<T>* hb = hnext[nc & 1];
      const Head<T> hn = hrow[nc & 1];
      ++nc;
      if (SM > 0) {
        // each warp refreshes the bumped spreads' statistics
#pragma unroll
        for (int q = 0; q < SM; ++q) {
          if (q >= S) break;
          if (vw[q] >= 0 && !has_t[q])
            spread_stats(counts + q * V, V, smin[q], smax[q], sany[q]);
        }
      }
      if (!sat) {
        if (tid == w) {
          s.j = ws.j;
          h = hb[w];
        }
        NT_CLK(3);
        continue;
      }
      NT_CLK(3);
      // saturation: the slots above w take the next slot's state; lane 31
      // takes lane 0 of the warp above, the last slot row nx
      if (32 * warp + 32 > w) {
        const int src = (lane + 1) & 31;
        Slot<T> ns = shfl_slot(s, src);
        Head<T> nh = shfl_head(h, src);
        int nsv[SMA];
#pragma unroll
        for (int q = 0; q < SM; ++q) {
          if (q >= S) break;
          nsv[q] = __shfl_sync(kFull, sv[q], src);
        }
        int nrw = xs ? __shfl_sync(kFull, rw, src) : 0;
        if (lane == 31) {
          if (warp + 1 < NW) {
            const Edge<T, SM>& up = edge[par][min(warp + 1, NW - 1)];
            ns = up.s;
            nh = up.h;
#pragma unroll
            for (int q = 0; q < SM; ++q) {
              if (q >= S) break;
              nsv[q] = up.sv[q];
            }
            if (xs) nrw = up.rw;
          } else {
            ns = nx;
            nh = hn;
#pragma unroll
            for (int q = 0; q < SM; ++q) {
              if (q >= S) break;
              nsv[q] = nx_sv[q];
            }
            nrw = nx_rw;
          }
        }
        if (tid >= w) {
          s = ns;
          h = nh;
#pragma unroll
          for (int q = 0; q < SM; ++q) {
            if (q >= S) break;
            sv[q] = nsv[q];
          }
          rw = nrw;
        }
      }
      NT_CLK(4);
      ++cursor;
      nx_rw = min(cursor, C - 1);
      const T* row = cm + (size_t)nx_rw * W;
      load_row(nx, row);
#pragma unroll
      for (int q = 0; q < SM; ++q)
        if (q < S) nx_sv[q] = (int)row[8 + q];
      NT_CLK(5);
      NT_CNT(8, 1);
    }
    if (warp == 0 && lane < n_in) {
      ch_e[base + lane] = st_ch;
      sc_e[base + lane] = st_sc;
      ny_e[base + lane] = st_ny;
    }
  }
  if (tid == 0) msg[nc & 1].done = 1;
  NT_BAR_SYNC(2, NT);
  NT_TOTAL(6);
}

// The per-placement step loop as its own kernel: lane blockIdx.x.
template <typename T, int NW, int SM = 0>
__global__ void __launch_bounds__(32 * (NW + 1))
wave_compact_kernel(const T* __restrict__ compact,
                    const T* __restrict__ scal_f,
                    const int* __restrict__ scal_i,
                    const int* __restrict__ pen,
                    const int* __restrict__ sp_counts,
                    const T* __restrict__ sp_desired,
                    const unsigned char* __restrict__ sp_has_targets,
                    const T* __restrict__ sp_weights,
                    const T* __restrict__ sp_sum_weights,
                    long long* __restrict__ chosen, T* __restrict__ scores,
                    long long* __restrict__ n_yielded, int C, int W, int S,
                    int V, int spread_alg, int desired_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ CompactShared<T, NW, SM> sh;
  wave_compact_lane<T, NW, SM>(compact, scal_f, scal_i, pen, sp_counts,
                               sp_desired, sp_has_targets, sp_weights,
                               sp_sum_weights, chosen, scores, n_yielded, C,
                               W, S, V, spread_alg, desired_smem, blockIdx.x,
                               sh, smem);
}

// Threads of a wave_compact_kernel block: NW step warps and the head warp.
constexpr int step_threads(int NW) { return 32 * (NW + 1); }

// Dynamic shared memory of a wave_compact_kernel block: the counts, and
// the desired counts when they are held there too.
template <typename T>
size_t dyn_smem(int S, int V, bool desired_smem) {
  return (size_t)S * V * ((desired_smem ? sizeof(T) : 0) + sizeof(int));
}

// Run width: the stream takes two lanes a value (its two pows side by
// side) and the last pair scores the next refill row's head (the plain
// version's outputs are the same for every run width K >= 1).
constexpr int kRunK = 15;

// The cached head of a slot at its j: fit and the score f0 (the
// per-placement step's head, no spreads, no penalties).
template <typename T>
__device__ __forceinline__ T head_f0(const Slot<T>& s, T ask_cpu, T ask_mem,
                                     T count, bool salg, bool& fit) {
  const Head<T> h = head_terms<T>(s, ask_cpu, ask_mem, count, salg);
  T nsc = T(1) + (h.coll > T(0) ? T(1) : T(0));
  nsc = nsc + (s.aff != T(0) ? T(1) : T(0));
  fit = h.fit;
  return final_score<T>(h.binpack, h.anti + s.aff, nsc);
}

// The run-block loop of lane e (wave_block.cu's design note), run by one
// warp: window slot k = 32 r + lane in register word r (B = 32 R).
template <typename T, int R>
__device__ __forceinline__ void wave_block_lane(
    const T* __restrict__ compact, const T* __restrict__ scal_f,
    const int* __restrict__ scal_i, long long* __restrict__ chosen,
    T* __restrict__ scores, long long* __restrict__ n_yielded, int C, int W,
    int spread_alg, int e) {
  constexpr int B = 32 * R;
  constexpr int kLogB = R == 1 ? 5 : 7;
  static_assert(R == 1 || R == 4, "B must be 32 or 128");
  const int lane = threadIdx.x & 31;
  const int P = C - B;
  const T* cm = compact + (size_t)e * C * W;
  const T ask_cpu = scal_f[e * 3 + 0], ask_mem = scal_f[e * 3 + 1];
  const T count = scal_f[e * 3 + 2];
  const int L = scal_i[e * 2 + 0], n_active = scal_i[e * 2 + 1];
  long long* ch_e = chosen + (size_t)e * P;
  T* sc_e = scores + (size_t)e * P;
  long long* ny_e = n_yielded + (size_t)e * P;
  const bool salg = spread_alg != 0;

  Slot<T> s[R];
  T f0[R];
  bool fit[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    load_row(s[r], cm + (size_t)(32 * r + lane) * W);
    f0[r] = head_f0<T>(s[r], ask_cpu, ask_mem, count, salg, fit[r]);
  }
  // the next refill row (row min(cursor, C - 1)), loaded one refill ahead
  int cursor = B;
  Slot<T> nx;
  load_row(nx, cm + (size_t)min(cursor, C - 1) * W);
  int p = 0;
  NT_TOTAL_T0();
  NT_T0();

  while (p < n_active) {
    NT_RESET();
    NT_CNT(7, 1);
    bool low[R], y[R];
    int order[R];
#pragma unroll
    for (int r = 0; r < R; ++r) low[r] = fit[r] && f0[r] <= T(0);
    NT_CLK(0);
    const int ny = warp_select<R>(fit, low, L, y, order);
    NT_CLK(1);
    if (ny == 0) break;                 // nothing yields: frozen from here
    const int io = warp_best<T, R>(f0, y, order);
    const int w = io & (B - 1), rw = w >> 5, lw = w & 31;
    const int win_order = io >> kLogB;
    // frozen runner-up: best other head, ties to the smallest order (over
    // every slot, as the reference's masked max/min are: non-yielded
    // heads and the winner at -inf)
    T eff_o[R];
    bool all[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      eff_o[r] = y[r] && 32 * r + lane != w ? f0[r] : neg_inf<T>();
      all[r] = true;
    }
    const int ro = warp_best<T, R>(eff_o, all, order);
    const T rub = __shfl_sync(kFull, pick(eff_o, (ro & (B - 1)) >> 5),
                              ro & 31);
    const int ru_order = ro >> kLogB;
    NT_CLK(2);

    const Slot<T> ws = shfl_slot(pick(s, rw), lw);
    const bool low_w = __shfl_sync(kFull, (int)pick(low, rw), lw) != 0;
    const T j_wf = (T)ws.j, order_wf = (T)win_order;
    // lanes 2q and 2q + 1 (q < K): the stream value of the winner's
    // (j_w + q + 1)-th placement, its cpu pow on the even lane and its
    // memory pow on the odd one; lanes 30 and 31: the head of row nx at
    // j = 0 (the same expressions: the head at j is the stream value at j)
    const int q = lane >> 1;
    const bool mem = lane & 1;
    const bool ref = q == kRunK;
    const Slot<T> sq = ref ? nx : ws;
    const T jq = ref ? T(0) : j_wf + (T)q;
    const bool validw = jq < sq.c;
    const T jp1q = jq + T(1);
    const T nu = (mem ? sq.umem : sq.ucpu) + jp1q * (mem ? ask_mem : ask_cpu);
    const T pw = pow10<T>(T(1) - nu / vmax(mem ? sq.mcap : sq.ccap, T(1e-9)));
    const T total = __shfl_sync(kFull, pw, lane & ~1) +
                    __shfl_sync(kFull, pw, lane | 1);
    T bpq = salg ? total - T(2) : T(20) - total;
    bpq = bpq < T(0) ? T(0) : bpq;
    bpq = bpq > T(18) ? T(18) : bpq;
    const T collq = sq.placed + jq;
    const T antiq = anti_term<T>(collq, count);
    const T nscq = (T(1) + (collq > T(0) ? T(1) : T(0))) +
                   (sq.aff != T(0) ? T(1) : T(0));
    const T val = final_score<T>(bpq, antiq + sq.aff, nscq);
    const bool win_q = val > rub ||
                       (val == rub && order_wf < (T)ru_order) || q == 0;
    const bool cross = (low_w ? val > T(0) : val <= T(0)) && q > 0;
    const bool stop = ref || !validw || !win_q || cross || q >= n_active - p;
    const unsigned mask = __ballot_sync(kFull, stop) & 0x55555555u;
    const int tlim = (__ffs(mask) - 1) >> 1;  // q = K always stops
    const int q_sat = (int)(ws.c - T(1) - j_wf);
    const bool has_sat = q_sat < kRunK && q_sat < tlim;
    const int t = has_sat ? q_sat + 1 : tlim;
    if (!mem && q < t) {
      ch_e[p + q] = (long long)ws.pos;
      sc_e[p + q] = val;
      ny_e[p + q] = ny;
    }
    p += t;
    if (!has_sat) {
      // the winner's new head: the stream value at q = t
      Slot<T> wn = ws;
      wn.j += t;
      bool fit_n;
      T f0_n;
      if (t < kRunK) {
        f0_n = __shfl_sync(kFull, val, 2 * t);
        fit_n = __shfl_sync(kFull, (int)validw, 2 * t) != 0;
      } else {
        f0_n = head_f0<T>(wn, ask_cpu, ask_mem, count, salg, fit_n);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r == rw && lane == lw) {
          s[r].j = wn.j;
          f0[r] = f0_n;
          fit[r] = fit_n;
        }
      NT_CLK(3);
      continue;
    }
    NT_CLK(3);
    // saturation: shift the slots above w left; the last takes nx
    const T f0_x = __shfl_sync(kFull, val, 2 * kRunK);
    const bool fit_x = __shfl_sync(kFull, (int)validw, 2 * kRunK) != 0;
    warp_shift<R>(s, w, nx);
    warp_shift<R>(f0, w, f0_x);
    warp_shift<R>(fit, w, fit_x);
    NT_CLK(4);
    ++cursor;
    load_row(nx, cm + (size_t)min(cursor, C - 1) * W);
    NT_CLK(5);
    NT_CNT(8, 1);
  }

  // past the last run: (-1, best head score, n_yielded) of the frozen state
  bool low[R], y[R];
  int order[R];
#pragma unroll
  for (int r = 0; r < R; ++r) low[r] = fit[r] && f0[r] <= T(0);
  const int ny = warp_select<R>(fit, low, L, y, order);
  T fill = neg_inf<T>();
  if (ny > 0) {
    const int io = warp_best<T, R>(f0, y, order);
    const int w = io & (B - 1);
    fill = __shfl_sync(kFull, pick(f0, w >> 5), w & 31);
  }
  for (int q = p + lane; q < P; q += 32) {
    ch_e[q] = -1;
    sc_e[q] = fill;
    ny_e[q] = ny;
  }
  NT_TOTAL(6);
}

}  // namespace nt
