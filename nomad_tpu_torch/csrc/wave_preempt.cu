// Windowed preemption kernel for NVIDIA Hopper (sm_90a).
//
// Replaces nomad_tpu/solver/binpack.py::_solve_wave_preempt_impl (with
// _preempt_search_core in its fixed A-round form), the XLA program built
// by _wave_preempt_program and vmapped over the E lanes of a fused
// dispatch.
//
// The window only ever looks at the first limit + MAX_SKIP option nodes
// in shuffled order (an option fits plainly or once its evictions free
// enough), so a step carries a B-slot buffer of the front option nodes,
// refilled in order from the host's compact table of pristine options
// (solver/binpack.py wavefront_preempt_compact_host).
//
// Design: one thread block per lane (grid = E) of 4 warps (8 at
// B = 128); the first B = 32 or 128 threads own one slot each. A slot
// is its compact-table row (12 values in registers), the copies it
// took (j), its evicted candidates (a 64-bit mask), the resources they
// free (cached: they change only with the mask) and a buffer: the
// slot's (A,) candidate columns staged in shared memory when it was
// loaded or refilled (read from global memory where the tables outgrow
// the budget), with the row's valid, priority-eligible and
// max_parallel masks beside them.
// One more buffer, the spare, holds the next compact row ahead of its
// refill: an idle search group loads it while the step's searches run.
//
// The eviction search of a slot (met, eviction row, freed resources,
// net priority) depends only on its candidates, its evicted mask, its
// capacity, the lane's ask and the group counts of its max_parallel
// candidates -- not on j. So each buffer caches its last search result
// with a valid flag, and a search runs only where a slot needs one
// (feasible, no plain fit) and its cache is stale. An entry goes stale
// when its slot is refilled, when its slot wins with a non-empty
// eviction row, and when the winner bumps the count of a group that one
// of its max_parallel candidates belongs to (the winner publishes its
// bumped groups in shared memory; a stale slot's search reads the
// counts again). A cached result is the same computation on the same
// inputs, so the outputs stay the plain version's bit for bit.
//
// A step: the slot threads compute their usage and plain fit and append
// the searches they need to a work list; every 16-lane group of the
// block (32 for A > 16) takes searches from the list and runs
// preempt_search_group (preempt_common.cuh), several at once; the slot
// threads then score (plain, or post-eviction binpack plus the logistic
// preemption term over one more term); one scan over packed (low, fit)
// flags for the window, a count for n_yielded and an arg-best for the
// winner (at B = 32 within the slot warp, shared through one barrier;
// at B = 128 block-wide, threads past B with neutral keys). The
// winner's thread takes one copy and, when it
// preempts, adds its eviction row to its mask and bumps its candidates'
// groups in the lane's (G,) counts in global memory (G reaches ~131,072
// at full width). The previous step's winner shifts out when it is no
// option any more (the deferred zombie of :2446-2494): slots above it
// move left through shared memory, the last slot refills from the next
// compact row in the spare, and the freed buffer becomes the spare.
// The winner's count bumps are atomic adds nothing waits for. A step
// that places nothing
// and shifts nothing freezes the lane: later steps without a reschedule
// penalty repeat its output.
//
// Bound: a lane's P steps form one dependency chain, a few block
// barriers and the searches that must run each, so the kernel is
// latency-bound on that chain; its bytes (the compact and candidate
// tables once, the outputs once) take microseconds at 3.35 TB/s.
#include "preempt_common.cuh"

namespace {

using namespace nt;

typedef unsigned char u8;

// Columns of the compact table (solver/binpack.py WPC_*).
enum {
  kFeas, kUC, kUM, kUD, kCC, kCM, kCD, kPlaced, kPlacedJob, kAff, kPos,
  kCDev, kCols
};

// Warps a block: the slot warps (B / 32) and the search groups' share.
constexpr int kWarps32 = 4;     // B = 32
constexpr int kWarps128 = 8;    // B = 128
// Dynamic shared memory the staged candidate columns may take; above it
// the searches read them from global memory.
constexpr int kStageBudget = 160 * 1024;

template <typename T> struct PSlot {
  T feas, uc, um, ud, cc, cm, cd, placed, placed_job, aff, pos, cdev;
  T fpc, fpm, fpd;              // resources freed by the evicted mask
  int j, buf;
  u64 ev;
};

template <typename T>
__device__ __forceinline__ void load_prow(PSlot<T>& s, const T* cm, int r,
                                          int buf) {
  const T* x = cm + (size_t)r * kCols;
  s.feas = x[kFeas]; s.uc = x[kUC]; s.um = x[kUM]; s.ud = x[kUD];
  s.cc = x[kCC]; s.cm = x[kCM]; s.cd = x[kCD]; s.placed = x[kPlaced];
  s.placed_job = x[kPlacedJob]; s.aff = x[kAff]; s.pos = x[kPos];
  s.cdev = x[kCDev];
  s.fpc = s.fpm = s.fpd = T(0);
  s.j = 0;
  s.buf = buf;
  s.ev = 0;
}

// A search on the work list: the slot's buffer, capacity and candidate
// masks now.
template <typename T> struct Work {
  T cc, cm, cd;
  u64 valid_now, eligible;
  int buf;
};

template <typename T> struct WaveArgs {
  const T* compact;                              // (E, C, kCols)
  const T *c_cpu, *c_mem, *c_disk;               // (E, C, A)
  const int *c_prio, *c_maxp, *c_grp;            // (E, C, A)
  const u8* c_valid;                             // (E, C, A)
  const T* scal_f;                               // (E, 4)
  const int *scal_i, *pen;                       // (E, 4), (E, P)
  int* counts;                                   // (E, G), in place
  long long* chosen;                             // (E, P)
  T* scores;
  long long* n_yielded;
  u8* evict_rows;                                // (E, P, A)
  int E, C, A, G, spread_alg;
  int staged;                                    // columns in shared memory
};

// Per-buffer state in shared memory (NB = B + 1 buffers: one a slot
// and the spare that holds the next refill's row): the row, the masks,
// the cached search and its fresh flag; the staged columns follow in
// dynamic shared memory (NB x A of cpu, mem, disk, then prio, maxp,
// grp).
template <typename T, int NB> struct Bufs {
  int row[NB];
  u64 valid[NB], elig[NB], mp[NB];
  SearchRes<T> res[NB];
  int fresh[NB];
};

template <typename T> struct Staged {
  T *cpu, *mem, *disk;
  int *prio, *maxp, *grp;
};

template <typename T>
__device__ __forceinline__ Staged<T> staged_cols(unsigned char* smem,
                                                 int nb, int A) {
  Staged<T> s;
  const size_t n = (size_t)nb * A;
  s.cpu = (T*)smem;
  s.mem = s.cpu + n;
  s.disk = s.mem + n;
  s.prio = (int*)(s.disk + n);
  s.maxp = s.prio + n;
  s.grp = s.maxp + n;
  return s;
}

// Buffer b's candidate columns: staged, or the row in global memory.
template <typename T, int NB>
__device__ __forceinline__ CandRow<T> cand_row(const WaveArgs<T>& W,
                                               const Staged<T>& st,
                                               const Bufs<T, NB>& bf,
                                               size_t cbase, int b) {
  CandRow<T> c;
  if (W.staged) {
    const size_t o = (size_t)b * W.A;
    c.cpu = st.cpu + o; c.mem = st.mem + o; c.disk = st.disk + o;
    c.prio = st.prio + o; c.maxp = st.maxp + o; c.grp = st.grp + o;
  } else {
    const size_t o = (cbase + bf.row[b]) * W.A;
    c.cpu = W.c_cpu + o; c.mem = W.c_mem + o; c.disk = W.c_disk + o;
    c.prio = W.c_prio + o; c.maxp = W.c_maxp + o; c.grp = W.c_grp + o;
  }
  return c;
}

// Load compact row r's candidates into buffer b (its cache stale), by
// one group of W lanes: the columns staged, the masks by ballot. A
// barrier must follow before they are read.
template <typename T, int NB, int W>
__device__ __forceinline__ void fill_buf(const WaveArgs<T>& Wa,
                                         const Staged<T>& st,
                                         Bufs<T, NB>& bf, size_t cbase,
                                         int b, int r, int job_prio) {
  const int A = Wa.A;
  const unsigned gm = group_mask<W>();
  const int gl = threadIdx.x & (W - 1);
  const int gbase = (threadIdx.x & 31) & ~(W - 1);
  const unsigned wbits = W == 32 ? kFull : 0xffffu;
  const size_t g = (cbase + r) * A, o = (size_t)b * A;
  u64 v = 0, el = 0, mp = 0;
  for (int j = 0; W * j < A; ++j) {
    const int c = gl + W * j;
    const bool in = c < A;
    const int prio = in ? Wa.c_prio[g + c] : 0;
    const int maxp = in ? Wa.c_maxp[g + c] : 0;
    const int grp = in ? Wa.c_grp[g + c] : -1;
    if (in && Wa.staged) {
      st.cpu[o + c] = Wa.c_cpu[g + c];
      st.mem[o + c] = Wa.c_mem[g + c];
      st.disk[o + c] = Wa.c_disk[g + c];
      st.prio[o + c] = prio;
      st.maxp[o + c] = maxp;
      st.grp[o + c] = grp;
    }
    const bool ok = in && Wa.c_valid[g + c];
    const bool e = ok && job_prio - prio >= 10;
    const bool m = maxp > 0 && grp >= 0;
    v |= (u64)((__ballot_sync(gm, ok) >> gbase) & wbits) << (W * j);
    el |= (u64)((__ballot_sync(gm, e) >> gbase) & wbits) << (W * j);
    mp |= (u64)((__ballot_sync(gm, m) >> gbase) & wbits) << (W * j);
  }
  if (gl == 0) {
    bf.row[b] = r;
    bf.valid[b] = v;
    bf.elig[b] = el;
    bf.mp[b] = mp;
    bf.fresh[b] = 0;
  }
}

template <typename T, int NS, int NWK, int W>
__global__ void __launch_bounds__(32 * NWK)
wave_preempt_kernel(const WaveArgs<T> Wa) {
  static_assert(NWK >= NS && NWK >= 2, "slot warps plus search warps");
  constexpr int B = 32 * NS, NB = B + 1;
  constexpr int NG = 32 * NWK / W;               // search groups
  const int e = blockIdx.x, tid = threadIdx.x;
  const bool slot = tid < B;
  const int C = Wa.C, A = Wa.A, P = C - B;
  const T* cm = Wa.compact + (size_t)e * C * kCols;
  const size_t cbase = (size_t)e * C;
  const T ask_c = Wa.scal_f[e * 4 + 0], ask_m = Wa.scal_f[e * 4 + 1];
  const T ask_d = Wa.scal_f[e * 4 + 2], count = Wa.scal_f[e * 4 + 3];
  const int L = Wa.scal_i[e * 4 + 0], n_active = Wa.scal_i[e * 4 + 1];
  const int job_prio = Wa.scal_i[e * 4 + 2], flag = Wa.scal_i[e * 4 + 3];
  const int* pen_e = Wa.pen + (size_t)e * P;
  int* counts = Wa.counts + (size_t)e * Wa.G;
  long long* ch_e = Wa.chosen + (size_t)e * P;
  T* sc_e = Wa.scores + (size_t)e * P;
  long long* ny_e = Wa.n_yielded + (size_t)e * P;
  u8* ev_e = Wa.evict_rows + (size_t)e * P * A;
  const bool salg = Wa.spread_alg != 0;

  __shared__ PSlot<T> stage[B];
  __shared__ Bufs<T, NB> bf;
  __shared__ Work<T> work[B];
  __shared__ Key<T> red[NWK];
  __shared__ int wsum[NWK];
  __shared__ int nwork, nbump;
  __shared__ int bumped[kMaxA];
  __shared__ u64 srow;
  extern __shared__ __align__(16) unsigned char smem[];
  const Staged<T> st = staged_cols<T>(smem, NB, A);
  const int gid = tid / W;                       // the thread's group
  // the order groups take searches in: one a warp before the warps'
  // second halves, so that two searches seldom share (and diverge in)
  // a warp
  const int gq = W == 16 ? ((tid >> 4) & 1) * NWK + (tid >> 5) : gid;

  // slot b in buffer b (row b); the spare, buffer B, holds row B
  PSlot<T> s;
  if (slot) load_prow(s, cm, tid, tid);
  for (int b = gid; b < NB; b += NG)
    fill_buf<T, NB, W>(Wa, st, bf, cbase, b, b, job_prio);
  if (tid == 0) nwork = 0;
  __syncthreads();
  // the next compact row, the spare buffer holding it, and whether the
  // spare still has to be loaded (after a refill took it)
  int cursor = B, pending = -1, spare = B, spare_row = B;
  bool spare_due = false;
  bool frozen = false;
  T frozen_sc = T(0);
  int frozen_ny = 0;
  NT_T0();
  NT_CNT(7, 0ull - clock64());

  for (int i = 0; i < P; ++i) {
    const int pen_i = pen_e[i];
    if (frozen && pen_i < 0) {
      if (tid == 0) {
        ch_e[i] = -1;
        sc_e[i] = frozen_sc;
        ny_e[i] = frozen_ny;
      }
      for (int c = tid; c < A; c += blockDim.x) ev_e[(size_t)i * A + c] = 0;
      continue;
    }
    NT_RESET();
    NT_CNT(8, 1);
    // the slot's usage now: initial usage, the copies taken, less what
    // its evictions freed
    const T jf = slot ? (T)s.j : T(0);
    T new_c = T(0), new_m = T(0), new_d = T(0);
    bool feas = false, fit = false;
    if (slot) {
      new_c = ((s.uc + jf * ask_c) - s.fpc) + ask_c;
      new_m = ((s.um + jf * ask_m) - s.fpm) + ask_m;
      new_d = ((s.ud + jf * ask_d) - s.fpd) + ask_d;
      const T dcount = flag == 2 ? s.placed_job + jf : s.placed + jf;
      // device capacity countdown: a drained node is no option at all
      const bool dev_ok = s.cdev - jf >= T(1);
      feas = s.feas > T(0.5) && dev_ok && (flag == 0 || dcount == T(0));
      fit = feas && new_c <= s.cc && new_m <= s.cm && new_d <= s.cd;
      // the searches this step needs: no plain fit, no fresh cache
      const bool want = feas && !fit && !bf.fresh[s.buf];
      const unsigned m = __ballot_sync(kFull, want);
      int base = 0;
      if ((tid & 31) == 0 && m) base = atomicAdd(&nwork, __popc(m));
      base = __shfl_sync(kFull, base, 0);
      if (want) {
        Work<T>& wk = work[base + __popc(m & ((1u << (tid & 31)) - 1u))];
        wk.cc = s.cc; wk.cm = s.cm; wk.cd = s.cd;
        wk.valid_now = bf.valid[s.buf] & ~s.ev;
        wk.eligible = bf.elig[s.buf] & ~s.ev;
        wk.buf = s.buf;
      }
    }
    __syncthreads();
    const int nw = nwork;
    NT_CNT(9, nw);
    NT_CLK(0);
    if (nw > 0 || spare_due) {
      // the searches, one a group, the groups side by side; the last
      // group (idle unless every group has a search) loads the spare
      for (int q = gq; q < nw; q += NG) {
        const Work<T> wk = work[q];
        const CandRegs<T, W> cr = load_cand_cols<T, W>(
            cand_row<T, NB>(Wa, st, bf, cbase, wk.buf), A, wk.valid_now,
            wk.eligible, counts);
        const SearchRes<T> r = preempt_search_group<T, W>(
            cr, A, wk.cc, wk.cm, wk.cd, ask_c, ask_m, ask_d);
        if ((tid & (W - 1)) == 0) {
          bf.res[wk.buf] = r;
          bf.fresh[wk.buf] = 1;
        }
      }
      if (spare_due && gq == NG - 1)
        fill_buf<T, NB, W>(Wa, st, bf, cbase, spare, spare_row, job_prio);
      spare_due = false;
      __syncthreads();
    }
    NT_CLK(1);
    bool fit_p = false, fit_c = false, low = false;
    T fin = T(0);
    SearchRes<T> r;
    r.evict = 0;
    r.freed_c = r.freed_m = r.freed_d = r.net_prio = T(0);
    if (slot) {
      if (feas && !fit) {
        r = bf.res[s.buf];
        // fit2: the full-usage recheck after the evictions
        fit_p = r.met && new_c - r.freed_c <= s.cc &&
                new_m - r.freed_m <= s.cm && new_d - r.freed_d <= s.cd;
      }
      const T coll = s.placed + jf;
      const T anti = anti_term<T>(coll, count);
      const bool is_pen = pen_i >= 0 && s.pos == (T)pen_i;
      const T resched = is_pen ? T(-1) : T(0);
      T nscores = T(1) + (coll > T(0) ? T(1) : T(0));
      nscores = nscores + (is_pen ? T(1) : T(0));
      nscores = nscores + (s.aff != T(0) ? T(1) : T(0));
      const T other = (anti + resched) + s.aff;
      const T ccap = vmax(s.cc, T(1e-9)), mcap = vmax(s.cm, T(1e-9));
      // one binpack for both kinds of slot (less 0 is the same value),
      // so a warp's slots do not diverge over its two pows
      const T fc = fit_p ? r.freed_c : T(0), fm = fit_p ? r.freed_m : T(0);
      const T bp = binpack_raw<T>(T(1) - (new_c - fc) / ccap,
                                  T(1) - (new_m - fm) / mcap, salg);
      fin = fit_p ? preempt_final<T>(bp, other,
                                     preempt_score<T>(r.net_prio), nscores)
                  : final_score<T>(bp, other, nscores);
      fit_c = fit || fit_p;
      low = fit_c && fin <= T(0);
    }
    NT_CLK(2);

    // the window scan, n_yielded and the arg-best over the B slots
    int ny;
    Key<T> win;
    if constexpr (NS == 1) {
      // one slot warp: warp-wide, then one barrier to share the result
      if (slot) {
        const Sel sel = select_slot<1>(fit_c, low, L, wsum);
        const int nyw = __popc(__ballot_sync(kFull, sel.yielded));
        NT_CLK(3);
        Key<T> k;
        k.eff = sel.yielded ? fin : neg_inf<T>();
        k.order = sel.order;
        k.idx = tid;
        k.y = sel.yielded ? 1 : 0;
        k = block_best<T, 1>(k, red);
        if (tid == 0) {
          red[0] = k;
          wsum[0] = nyw;
        }
      }
      __syncthreads();
      win = red[0];
      ny = wsum[0];
    } else {
      // threads past B take part with neutral keys
      const Sel sel = select_slot<NWK>(fit_c, low, L, wsum);
      ny = __syncthreads_count(sel.yielded);
      NT_CLK(3);
      Key<T> k;
      k.eff = sel.yielded ? fin : neg_inf<T>();
      k.order = slot ? sel.order : INT_MAX;
      k.idx = tid;
      k.y = sel.yielded ? 1 : 0;
      win = block_best<T, NWK>(k, red);
    }
    const int w = win.idx;
    NT_CLK(4);
    const bool any_yield = ny > 0;
    const bool doit = i < n_active && any_yield;
    const T score_out = any_yield ? win.eff : neg_inf<T>();
    if (tid == 0) nwork = 0;
    if (tid == w) {
      // outputs, and the commit: one copy; a preempting winner's
      // eviction row, its freed sums, its groups' counts
      ch_e[i] = doit ? (long long)s.pos : -1;
      sc_e[i] = score_out;
      ny_e[i] = ny;
      const u64 row = (doit && fit_p) ? r.evict : 0;
      srow = row;
      int nb = 0;
      if (doit) {
        s.j += 1;
        if (row) {
          s.ev |= row;
          bf.fresh[s.buf] = 0;
          const CandRow<T> cr = cand_row<T, NB>(Wa, st, bf, cbase, s.buf);
          T fc = T(0), fm = T(0), fd = T(0);
          for (u64 m = s.ev; m; m &= m - 1) {      // in candidate order
            const int c = __ffsll((long long)m) - 1;
            fc = fc + cr.cpu[c];
            fm = fm + cr.mem[c];
            fd = fd + cr.disk[c];
          }
          s.fpc = fc;
          s.fpm = fm;
          s.fpd = fd;
          for (u64 m = row; m; m &= m - 1) {
            const int g = cr.grp[__ffsll((long long)m) - 1];
            if (g >= 0) {
              atomicAdd(counts + g, 1);
              bumped[nb++] = g;
            }
          }
        }
      }
      nbump = nb;
    }
    __syncthreads();
    for (int c = tid; c < A; c += blockDim.x)
      ev_e[(size_t)i * A + c] = (srow >> c) & 1;
    // a slot whose max_parallel candidates share a bumped group
    // searches again
    const int nb = nbump;
    if (slot && nb > 0 && bf.mp[s.buf] && bf.fresh[s.buf]) {
      const CandRow<T> cr = cand_row<T, NB>(Wa, st, bf, cbase, s.buf);
      bool hit = false;
      for (u64 m = bf.mp[s.buf]; m && !hit; m &= m - 1) {
        const int g = cr.grp[__ffsll((long long)m) - 1];
        for (int q = 0; q < nb; ++q) hit = hit || bumped[q] == g;
      }
      if (hit) bf.fresh[s.buf] = 0;
    }
    NT_CLK(5);

    // the previous winner shifts out now if it is no option any more;
    // the refilled last slot takes the spare (loaded with its row), and
    // the freed buffer becomes the spare, loaded during the next step's
    // searches
    const int z = max(pending, 0);
    const bool zomb = __syncthreads_or(pending >= 0 && tid == z && !fit_c);
    if (zomb) {
      if (slot) stage[tid] = s;
      __syncthreads();
      const int freed = stage[z].buf;
      if (tid == B - 1)
        load_prow(s, cm, spare_row, spare);
      else if (slot && tid >= z)
        s = stage[tid + 1];
      ++cursor;
      spare = freed;
      spare_row = min(cursor, C - 1);
      spare_due = true;
    }
    pending = doit ? ((zomb && w > z) ? w - 1 : w) : -1;
    if (!doit && !zomb && pen_i < 0) {
      // nothing changed and nothing will: later steps without a penalty
      // repeat this one
      frozen = true;
      frozen_sc = score_out;
      frozen_ny = ny;
    }
    NT_CLK(6);
  }
  NT_CNT(7, clock64());
}

constexpr int kPtrs = 16;       // compact, 7 candidate tables, scal_f,
                                // scal_i, pen, counts, 4 outputs
constexpr int kDims = 6;        // E C A G B spread_alg

template <typename T, int NS, int NWK, int W>
int launch_w(WaveArgs<T> a, cudaStream_t stream) {
  constexpr int B = 32 * NS;
  const size_t stage =
      (size_t)(B + 1) * a.A * (3 * sizeof(T) + 3 * sizeof(int));
  a.staged = stage <= (size_t)kStageBudget;
  const size_t dyn = a.staged ? stage : 0;
  cudaError_t err = cudaFuncSetAttribute(
      wave_preempt_kernel<T, NS, NWK, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  wave_preempt_kernel<T, NS, NWK, W><<<a.E, 32 * NWK, dyn, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int NS, int NWK>
int launch_nw(const WaveArgs<T>& a, cudaStream_t stream) {
  // a 16-lane group searches a row of A <= 16 (one candidate a lane),
  // a warp one of A <= 64 (two a lane)
  if (a.A <= 16) return launch_w<T, NS, NWK, 16>(a, stream);
  return launch_w<T, NS, NWK, 32>(a, stream);
}

template <typename T>
int launch(void* const* p, int n_ptrs, const int* d, int n_dims,
           cudaStream_t stream) {
  if (n_ptrs != kPtrs || n_dims != kDims) return (int)cudaErrorInvalidValue;
  WaveArgs<T> a;
  int k = 0;
  a.compact = (const T*)p[k++];
  a.c_cpu = (const T*)p[k++]; a.c_mem = (const T*)p[k++];
  a.c_disk = (const T*)p[k++]; a.c_prio = (const int*)p[k++];
  a.c_maxp = (const int*)p[k++]; a.c_grp = (const int*)p[k++];
  a.c_valid = (const u8*)p[k++];
  a.scal_f = (const T*)p[k++]; a.scal_i = (const int*)p[k++];
  a.pen = (const int*)p[k++]; a.counts = (int*)p[k++];
  a.chosen = (long long*)p[k++]; a.scores = (T*)p[k++];
  a.n_yielded = (long long*)p[k++]; a.evict_rows = (u8*)p[k++];
  a.E = d[0]; a.C = d[1]; a.A = d[2]; a.G = d[3];
  const int B = d[4];
  a.spread_alg = d[5];
  a.staged = 0;
  if (a.E <= 0) return 0;
  if (a.C <= B || a.A < 1 || a.A > kMaxA || a.G < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 32) return launch_nw<T, 1, kWarps32>(a, stream);
  if (B == 128) return launch_nw<T, 4, kWarps128>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

NT_STEP_CLOCKS_EXPORT

extern "C" int nt_wave_preempt_f32(void* const* ptrs, int n_ptrs,
                                   const int* dims, int n_dims,
                                   void* stream) {
  return launch<float>(ptrs, n_ptrs, dims, n_dims, (cudaStream_t)stream);
}

extern "C" int nt_wave_preempt_f64(void* const* ptrs, int n_ptrs,
                                   const int* dims, int n_dims,
                                   void* stream) {
  return launch<double>(ptrs, n_ptrs, dims, n_dims, (cudaStream_t)stream);
}
