// The native control plane's host folds (port of native/pack_kernels.cc,
// ABI 3, every entry point): the alloc table folded into node-axis usage
// (nt_pack_usage), the per-node count of a job's and a task group's live
// allocs (nt_count_placed), the static-port check (nt_static_ports_free),
// the node-axis fit check (nt_verify_fit), the plan applier's whole-group
// verify (nt_verify_plan), the seeded node shuffle (nt_shuffled_order) and
// the compiled host-baseline oracle (nt_solve_eval).
//
// Host C++, not a device kernel: nomad_tpu_torch/native.py builds it with
// g++ -O3 -march=native -ffp-contract=off -shared -fPIC at first use and
// binds it with ctypes.CDLL, so every call runs with the interpreter lock
// released. The arithmetic and the summation order are the reference's:
// rows fold in row order, entries apply in order, and no multiply-add is
// contracted (-ffp-contract=off), so each function equals its numpy form
// in native.py bit for bit.

#include <cstdint>
#include <cmath>
#include <cstring>

extern "C" {

// Fold the alloc table into node-axis usage tensors.
//
// rows: n_rows allocations, SoA layout:
//   node_slot[i]  int32   -- node index, -1 = node unknown (skip)
//   cpu[i]/mem[i]/disk[i] double
//   live[i]       uint8   -- 1 unless client-terminal
//   ports[i*max_ports..]  int32, -1 = empty slot
// node inputs:
//   dyn_lo/dyn_hi int32 per node (dynamic port range)
// outputs (caller-zeroed, length n_pad):
//   used_cpu/used_mem/used_disk double
//   dyn_used int32
//   port_words uint32 (n_pad * 2048) -- caller seeds agent-reserved ports
void nt_pack_usage(const int32_t* node_slot, const double* cpu,
                   const double* mem, const double* disk,
                   const uint8_t* live, const int32_t* ports,
                   int64_t n_rows, int32_t max_ports,
                   const int32_t* dyn_lo, const int32_t* dyn_hi,
                   double* used_cpu, double* used_mem, double* used_disk,
                   int32_t* dyn_used, uint32_t* port_words,
                   int64_t n_pad) {
  const int64_t words_per_node = 2048;
  for (int64_t i = 0; i < n_rows; ++i) {
    if (!live[i]) continue;
    const int32_t slot = node_slot[i];
    if (slot < 0 || slot >= n_pad) continue;
    used_cpu[slot] += cpu[i];
    used_mem[slot] += mem[i];
    used_disk[slot] += disk[i];
    if (port_words == nullptr) continue;  // no port state this eval
    uint32_t* words = port_words + slot * words_per_node;
    const int32_t lo = dyn_lo[slot], hi = dyn_hi[slot];
    for (int32_t p = 0; p < max_ports; ++p) {
      const int32_t port = ports[i * max_ports + p];
      if (port < 0) break;
      if (port >= 65536) continue;
      const uint32_t bit = 1u << (port & 31);
      uint32_t* w = &words[port >> 5];
      if (!(*w & bit)) {
        *w |= bit;
        if (port >= lo && port <= hi) dyn_used[slot] += 1;
      }
    }
  }
}

// Count allocations per node for a specific (job, tg) -- the anti-affinity
// and distinct-hosts inputs. jobtg_hash rows match -> placed; job_hash
// rows match -> placed_job.
void nt_count_placed(const int32_t* node_slot, const uint64_t* job_hash,
                     const uint64_t* jobtg_hash, const uint8_t* live,
                     int64_t n_rows, uint64_t want_job, uint64_t want_jobtg,
                     int32_t* placed, int32_t* placed_job, int64_t n_pad) {
  for (int64_t i = 0; i < n_rows; ++i) {
    if (!live[i]) continue;
    const int32_t slot = node_slot[i];
    if (slot < 0 || slot >= n_pad) continue;
    if (job_hash[i] == want_job) {
      placed_job[slot] += 1;
      if (jobtg_hash[i] == want_jobtg) placed[slot] += 1;
    }
  }
}

// Check whether each of n_check static ports is free on each listed node.
// out[k] = 1 if all ports free on node check_slots[k].
void nt_static_ports_free(const uint32_t* port_words, int64_t n_pad,
                          const int32_t* check_ports, int32_t n_ports,
                          uint8_t* out) {
  const int64_t words_per_node = 2048;
  for (int64_t slot = 0; slot < n_pad; ++slot) {
    const uint32_t* words = port_words + slot * words_per_node;
    uint8_t free = 1;
    for (int32_t p = 0; p < n_ports; ++p) {
      const int32_t port = check_ports[p];
      if (port < 0 || port >= 65536) continue;
      if (words[port >> 5] & (1u << (port & 31))) {
        free = 0;
        break;
      }
    }
    out[slot] = free;
  }
}

// Batch plan verification: node-axis superset check
// (reference: nomad/plan_apply.go:717 evaluateNodePlan -> AllocsFit).
// For each node k: fits iff used + ask <= cap on every dimension.
// Returns the failing dimension per node: 0 ok, 1 cpu, 2 memory, 3 disk.
void nt_verify_fit(const double* cpu_cap, const double* mem_cap,
                   const double* disk_cap, const double* used_cpu,
                   const double* used_mem, const double* used_disk,
                   const double* ask_cpu, const double* ask_mem,
                   const double* ask_disk, int64_t n, int32_t* out_dim) {
  for (int64_t k = 0; k < n; ++k) {
    if (used_cpu[k] + ask_cpu[k] > cpu_cap[k]) out_dim[k] = 1;
    else if (used_mem[k] + ask_mem[k] > mem_cap[k]) out_dim[k] = 2;
    else if (used_disk[k] + ask_disk[k] > disk_cap[k]) out_dim[k] = 3;
    else out_dim[k] = 0;
  }
}

// ---------------------------------------------------------------------------
// Compiled host-baseline oracle: the reference scheduler's per-eval inner
// loop (reference: scheduler/rank.go:205 BinPackIterator.Next,
// scheduler/stack.go:82-95 log2 candidate limit, scheduler/select.go
// LimitIterator/MaxScoreIterator, scheduler/util.go:167 seeded shuffle,
// nomad/structs/funcs.go:236 ScoreFitBinPack) as straight C++ over packed
// node arrays. This is the compiled-host baseline the device solver's
// vs_native_host is to be measured against: same shuffle, same window semantics,
// same double-precision score math, same tie-breaks as the Python oracle
// (held to it in tests/test_torch_native_oracle.py).
//
// Scope: cpu/mem/disk fit + binpack/spread scoring + job anti-affinity +
// eligibility mask. Port/device/core asks route to the host oracle in
// production and are out of the bench workload this baseline times.

static inline uint64_t nt_splitmix64(uint64_t* state, uint64_t* out) {
  *state += 0x9E3779B97F4A7C15ull;
  uint64_t z = *state;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  *out = z ^ (z >> 31);
  return *state;
}

static const double kBinPackMaxFitScore = 18.0;

static void nt_fisher_yates(uint64_t seed, int32_t n, int32_t* order) {
  for (int32_t i = 0; i < n; ++i) order[i] = i;
  uint64_t state = seed;
  for (int32_t i = n - 1; i > 0; --i) {
    uint64_t out;
    nt_splitmix64(&state, &out);
    const int32_t j = static_cast<int32_t>(out % (uint64_t)(i + 1));
    const int32_t tmp = order[i];
    order[i] = order[j];
    order[j] = tmp;
  }
}

// The deterministic per-eval node shuffle (scheduler/util.py
// shuffled_order) as native code: the Python Fisher-Yates walks every
// node once per eval.
void nt_shuffled_order(uint64_t seed, int32_t n, int32_t* order) {
  nt_fisher_yates(seed, n, order);
}

void nt_solve_eval(int32_t n_nodes, const double* cpu_cap,
                   const double* mem_cap, const double* disk_cap,
                   double* used_cpu, double* used_mem, double* used_disk,
                   int32_t* placed_jobtg, const uint8_t* eligible,
                   uint64_t shuffle_seed, double ask_cpu, double ask_mem,
                   double ask_disk, int32_t desired_count, int32_t limit,
                   int32_t max_skip, double skip_threshold,
                   int32_t n_placements, int32_t spread_alg, int32_t* order,
                   int32_t* out_choice) {
  // Deterministic Fisher-Yates over the base node order, identical to
  // scheduler/util.py shuffle_nodes (splitmix64, j = out % (i+1)).
  nt_fisher_yates(shuffle_seed, n_nodes, order);

  struct Option {
    int32_t node;
    double final_score;
  };
  // LimitIterator defers at most max_skip low-score options; bounded small.
  Option skipped[16];
  if (max_skip > 16) max_skip = 16;

  for (int32_t p = 0; p < n_placements; ++p) {
    int32_t pos = 0;  // source iterator restarts each Select
    int32_t seen = 0, n_skipped = 0, skipped_idx = 0;
    Option best;
    bool have_best = false;

    // source.next(): next shuffled node passing eligibility + fit, scored.
    auto source_next = [&](Option* opt) -> bool {
      while (pos < n_nodes) {
        const int32_t k = order[pos++];
        if (!eligible[k]) continue;
        const double ucpu = used_cpu[k] + ask_cpu;
        const double umem = used_mem[k] + ask_mem;
        const double udisk = used_disk[k] + ask_disk;
        if (ucpu > cpu_cap[k] || umem > mem_cap[k] || udisk > disk_cap[k])
          continue;  // exhausted: BinPackIterator skips, no window slot used
        double score = 0.0;
        if (cpu_cap[k] > 0.0 && mem_cap[k] > 0.0) {
          const double free_cpu = 1.0 - ucpu / cpu_cap[k];
          const double free_ram = 1.0 - umem / mem_cap[k];
          const double total =
              std::pow(10.0, free_cpu) + std::pow(10.0, free_ram);
          score = spread_alg ? (total - 2.0) : (20.0 - total);
          if (score > kBinPackMaxFitScore) score = kBinPackMaxFitScore;
          if (score < 0.0) score = 0.0;
        }
        double final_score = score / kBinPackMaxFitScore;
        const int32_t collisions = placed_jobtg[k];
        if (collisions > 0 && desired_count > 0) {
          const double penalty =
              -1.0 * (double)(collisions + 1) / (double)desired_count;
          final_score = (final_score + penalty) / 2.0;  // mean of 2 scores
        }
        opt->node = k;
        opt->final_score = final_score;
        return true;
      }
      return false;
    };
    // LimitIterator._next_option(): source first, then deferred skips.
    auto next_option = [&](Option* opt) -> bool {
      if (source_next(opt)) return true;
      if (skipped_idx < n_skipped) {
        *opt = skipped[skipped_idx++];
        return true;
      }
      return false;
    };

    // MaxScoreIterator over LimitIterator (select.go semantics, verbatim).
    while (true) {
      if (seen == limit) break;
      Option opt;
      bool have = next_option(&opt);
      if (!have) break;
      if (n_skipped < max_skip) {
        while (have && opt.final_score <= skip_threshold &&
               n_skipped < max_skip) {
          skipped[n_skipped++] = opt;
          have = source_next(&opt);
        }
      }
      seen += 1;
      if (!have) {
        have = next_option(&opt);
        if (!have) break;  // LimitIterator returned None
      }
      if (!have_best || opt.final_score > best.final_score) {
        best = opt;
        have_best = true;
      }
    }

    if (have_best) {
      const int32_t k = best.node;
      used_cpu[k] += ask_cpu;
      used_mem[k] += ask_mem;
      used_disk[k] += ask_disk;
      placed_jobtg[k] += 1;
      out_choice[p] = k;
    } else {
      out_choice[p] = -1;
    }
  }
}

// Whole-group plan verification against the columnar fold state
// (reference: nomad/plan_apply.go evaluateNodePlan over a plan batch).
// One call applies a plan group's deltas to the folded usage and compares
// every touched node, so the applier's verify pre-pass holds the GIL only
// while gathering plan-sized entry arrays, not for the arithmetic.
//
// Inputs:
//   tbl_cpu/tbl_mem/tbl_disk  AllocTable columns (full table)
//   tbl_live_strict           uint8 column; dead rows contribute nothing
//   d_row/d_pos/d_sign        n_delta row-backed deltas: for each entry,
//                             used[dim][d_pos] += d_sign * tbl[dim][d_row]
//                             iff tbl_live_strict[d_row] (stops,
//                             preemptions, in-place replacements,
//                             overlay-removed allocs)
//   a_pos/a_cpu/a_mem/a_disk  n_ask direct value entries; a_into_used[e]
//   a_into_used               routes the entry into used (in-flight
//                             overlay adds) or ask (this plan's
//                             placements)
//   cpu_cap/mem_cap/disk_cap  per-node caps minus node-reserved
//   used_*/ask_*              in/out node-axis accumulators (used_* seeded
//                             from the fold; ask_* caller-zeroed)
// Output: out_dim[k] = 0 ok, 1 cpu, 2 memory, 3 disk.
//
// Entries are applied strictly in order (e then compare), so float
// accumulation order matches the Python oracle's traversal order and the
// numpy form's sequential walk (native.py verify_plan_plain), bit for bit.
void nt_verify_plan(const double* tbl_cpu, const double* tbl_mem,
                    const double* tbl_disk, const uint8_t* tbl_live_strict,
                    const int64_t* d_row, const int32_t* d_pos,
                    const int8_t* d_sign, int64_t n_delta,
                    const int32_t* a_pos, const double* a_cpu,
                    const double* a_mem, const double* a_disk,
                    const int8_t* a_into_used, int64_t n_ask,
                    const double* cpu_cap, const double* mem_cap,
                    const double* disk_cap, double* used_cpu,
                    double* used_mem, double* used_disk, double* ask_cpu,
                    double* ask_mem, double* ask_disk, int64_t n,
                    int32_t* out_dim) {
  for (int64_t e = 0; e < n_delta; ++e) {
    const int64_t row = d_row[e];
    if (!tbl_live_strict[row]) continue;
    const int32_t k = d_pos[e];
    const double s = (double)d_sign[e];
    used_cpu[k] += s * tbl_cpu[row];
    used_mem[k] += s * tbl_mem[row];
    used_disk[k] += s * tbl_disk[row];
  }
  for (int64_t e = 0; e < n_ask; ++e) {
    const int32_t k = a_pos[e];
    if (a_into_used[e]) {
      used_cpu[k] += a_cpu[e];
      used_mem[k] += a_mem[e];
      used_disk[k] += a_disk[e];
    } else {
      ask_cpu[k] += a_cpu[e];
      ask_mem[k] += a_mem[e];
      ask_disk[k] += a_disk[e];
    }
  }
  for (int64_t k = 0; k < n; ++k) {
    if (used_cpu[k] + ask_cpu[k] > cpu_cap[k]) out_dim[k] = 1;
    else if (used_mem[k] + ask_mem[k] > mem_cap[k]) out_dim[k] = 2;
    else if (used_disk[k] + ask_disk[k] > disk_cap[k]) out_dim[k] = 3;
    else out_dim[k] = 0;
  }
}

int32_t nt_abi_version() { return 3; }

}  // extern "C"
