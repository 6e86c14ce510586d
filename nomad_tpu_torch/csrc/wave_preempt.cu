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
// Design: one thread block per lane (grid = E), one thread per slot
// (B = 32 or 128). A slot is its compact-table row (12 values in
// registers, and the row index that locates its (A,) candidate columns in
// global memory), the copies it took (j) and its evicted candidates (a
// 64-bit mask). Each step every slot computes its usage now, its plain
// fit and, where only the resources fail, the eviction search
// (preempt_common.cuh) and the fit2 recheck; then its score (plain, or
// post-eviction binpack plus the logistic preemption term over one more
// term); one block scan over packed (low, fit) flags for the window, one
// __syncthreads_count for n_yielded, one arg-best for the winner. The
// winner's thread takes one copy and, when it preempts, adds its eviction
// row to its mask and bumps its candidates' groups in the lane's (G,)
// counts in global memory (G reaches ~131,072 at full width). The
// previous step's winner shifts out when it is no option any more (the
// deferred zombie of :2446-2494): slots above it move left through
// shared memory and the last slot refills from the next compact row. A
// step that places nothing and shifts nothing freezes the lane: later
// steps without a reschedule penalty repeat its output.
//
// Bound: a lane's P steps form one dependency chain, a few block
// barriers and the longest slot's search each, so the kernel is
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

template <typename T> struct PSlot {
  T feas, uc, um, ud, cc, cm, cd, placed, placed_job, aff, pos, cdev;
  int row, j;
  u64 ev;
};

template <typename T>
__device__ __forceinline__ void load_prow(PSlot<T>& s, const T* cm, int r) {
  const T* x = cm + (size_t)r * kCols;
  s.feas = x[kFeas]; s.uc = x[kUC]; s.um = x[kUM]; s.ud = x[kUD];
  s.cc = x[kCC]; s.cm = x[kCM]; s.cd = x[kCD]; s.placed = x[kPlaced];
  s.placed_job = x[kPlacedJob]; s.aff = x[kAff]; s.pos = x[kPos];
  s.cdev = x[kCDev];
  s.row = r;
  s.j = 0;
  s.ev = 0;
}

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
};

template <typename T, int NW>
__global__ void __launch_bounds__(32 * NW)
wave_preempt_kernel(const WaveArgs<T> W) {
  constexpr int B = 32 * NW;
  const int e = blockIdx.x, tid = threadIdx.x;
  const int C = W.C, A = W.A, P = C - B;
  const T* cm = W.compact + (size_t)e * C * kCols;
  const size_t cbase = (size_t)e * C;
  const T ask_c = W.scal_f[e * 4 + 0], ask_m = W.scal_f[e * 4 + 1];
  const T ask_d = W.scal_f[e * 4 + 2], count = W.scal_f[e * 4 + 3];
  const int L = W.scal_i[e * 4 + 0], n_active = W.scal_i[e * 4 + 1];
  const int job_prio = W.scal_i[e * 4 + 2], flag = W.scal_i[e * 4 + 3];
  const int* pen_e = W.pen + (size_t)e * P;
  int* counts = W.counts + (size_t)e * W.G;
  long long* ch_e = W.chosen + (size_t)e * P;
  T* sc_e = W.scores + (size_t)e * P;
  long long* ny_e = W.n_yielded + (size_t)e * P;
  u8* ev_e = W.evict_rows + (size_t)e * P * A;
  const bool salg = W.spread_alg != 0;

  __shared__ PSlot<T> stage[B];
  __shared__ Key<T> red[NW];
  __shared__ int wsum[NW];
  __shared__ u64 srow;

  PSlot<T> s;
  load_prow(s, cm, tid);
  int cursor = B, pending = -1;
  bool frozen = false;
  T frozen_sc = T(0);
  int frozen_ny = 0;

  for (int i = 0; i < P; ++i) {
    const int pen_i = pen_e[i];
    if (frozen && pen_i < 0) {
      if (tid == 0) {
        ch_e[i] = -1;
        sc_e[i] = frozen_sc;
        ny_e[i] = frozen_ny;
      }
      for (int c = tid; c < A; c += B) ev_e[(size_t)i * A + c] = 0;
      continue;
    }
    // the slot's usage now: initial usage, the copies taken, less what
    // its evictions freed
    const size_t rb = (cbase + s.row) * A;
    CandRow<T> cr;
    cr.cpu = W.c_cpu + rb; cr.mem = W.c_mem + rb; cr.disk = W.c_disk + rb;
    cr.prio = W.c_prio + rb; cr.maxp = W.c_maxp + rb; cr.grp = W.c_grp + rb;
    T fpc = T(0), fpm = T(0), fpd = T(0);
    for (int c = 0; c < A; ++c)
      if (s.ev & bit(c)) {
        fpc = fpc + cr.cpu[c];
        fpm = fpm + cr.mem[c];
        fpd = fpd + cr.disk[c];
      }
    const T jf = (T)s.j;
    const T new_c = ((s.uc + jf * ask_c) - fpc) + ask_c;
    const T new_m = ((s.um + jf * ask_m) - fpm) + ask_m;
    const T new_d = ((s.ud + jf * ask_d) - fpd) + ask_d;
    const T dcount = flag == 2 ? s.placed_job + jf : s.placed + jf;
    // device capacity countdown: a drained node is no option at all
    const bool dev_ok = s.cdev - jf >= T(1);
    const bool feas = s.feas > T(0.5) && dev_ok &&
                      (flag == 0 || dcount == T(0));
    const bool fit = feas && new_c <= s.cc && new_m <= s.cm &&
                     new_d <= s.cd;
    bool fit_p = false;
    SearchRes<T> r;
    r.evict = 0;
    r.freed_c = r.freed_m = r.freed_d = r.net_prio = T(0);
    if (feas && !fit) {
      u64 valid_now = 0, eligible = 0;
      for (int c = 0; c < A; ++c)
        if (W.c_valid[rb + c] && !(s.ev & bit(c))) {
          valid_now |= bit(c);
          if (job_prio - cr.prio[c] >= 10) eligible |= bit(c);
        }
      r = preempt_search<T>(cr, A, valid_now, eligible, s.cc, s.cm, s.cd,
                            counts, ask_c, ask_m, ask_d);
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
    T fin;
    if (fit_p) {
      const T bp = binpack_raw<T>(T(1) - (new_c - r.freed_c) / ccap,
                                  T(1) - (new_m - r.freed_m) / mcap, salg);
      fin = preempt_final<T>(bp, other, preempt_score<T>(r.net_prio),
                             nscores);
    } else {
      const T bp = binpack_raw<T>(T(1) - new_c / ccap, T(1) - new_m / mcap,
                                  salg);
      fin = final_score<T>(bp, other, nscores);
    }
    const bool fit_c = fit || fit_p;

    const bool low = fit_c && fin <= T(0);
    const Sel sel = select_slot<NW>(fit_c, low, L, wsum);
    const int ny = __syncthreads_count(sel.yielded);
    Key<T> k;
    k.eff = sel.yielded ? fin : neg_inf<T>();
    k.order = sel.order;
    k.idx = tid;
    k.y = sel.yielded ? 1 : 0;
    const Key<T> win = block_best<T, NW>(k, red);
    const int w = win.idx;
    const bool any_yield = ny > 0;
    const bool doit = i < n_active && any_yield;
    const T score_out = any_yield ? win.eff : neg_inf<T>();
    if (tid == w) {
      // outputs, and the commit: one copy; a preempting winner's
      // eviction row and its groups' counts
      ch_e[i] = doit ? (long long)s.pos : -1;
      sc_e[i] = score_out;
      ny_e[i] = ny;
      const u64 row = (doit && fit_p) ? r.evict : 0;
      srow = row;
      if (doit) {
        s.j += 1;
        s.ev |= row;
        for (int c = 0; c < A; ++c)
          if ((row & bit(c)) && cr.grp[c] >= 0) counts[cr.grp[c]] += 1;
      }
    }
    __syncthreads();
    for (int c = tid; c < A; c += B)
      ev_e[(size_t)i * A + c] = (srow >> c) & 1;

    // the previous winner shifts out now if it is no option any more
    const int z = max(pending, 0);
    const bool zomb = __syncthreads_or(pending >= 0 && tid == z && !fit_c);
    if (zomb) {
      stage[tid] = s;
      __syncthreads();
      if (tid == B - 1)
        load_prow(s, cm, min(cursor, C - 1));
      else if (tid >= z)
        s = stage[tid + 1];
      __syncthreads();
      ++cursor;
    }
    pending = doit ? ((zomb && w > z) ? w - 1 : w) : -1;
    if (!doit && !zomb && pen_i < 0) {
      // nothing changed and nothing will: later steps without a penalty
      // repeat this one
      frozen = true;
      frozen_sc = score_out;
      frozen_ny = ny;
    }
  }
}

constexpr int kPtrs = 16;       // compact, 7 candidate tables, scal_f,
                                // scal_i, pen, counts, 4 outputs
constexpr int kDims = 6;        // E C A G B spread_alg

template <typename T, int NW>
int launch_nw(const WaveArgs<T>& a, cudaStream_t stream) {
  wave_preempt_kernel<T, NW><<<a.E, 32 * NW, 0, stream>>>(a);
  return (int)cudaGetLastError();
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
  if (a.E <= 0) return 0;
  if (a.C <= B || a.A < 1 || a.A > kMaxA || a.G < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 32) return launch_nw<T, 1>(a, stream);
  if (B == 128) return launch_nw<T, 4>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

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
