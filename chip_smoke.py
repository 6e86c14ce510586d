#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's placement paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --ab TAG=DIR ... [--ab-clocks TAG=DIR ...]
                          [--ab-kernels NAME,...] [--ab-max-spreads S]
                          (A/B timing; below)

Phases (any failure raises and the script exits nonzero with no result):

  1. card    -- the card's name and power limit (nvidia-smi), CUDA checks;
  2. build   -- nvcc builds every kernel in nomad_tpu_torch/csrc;
  3. kernels -- every kernel held against its plain PyTorch version on the
                same inputs on the card (chosen, n_yielded and final state
                exactly, scores within rtol 1e-12 (float64) / 1e-6
                (float32; both versions run the same IEEE operations in
                the same order, so they are expected to agree to the
                bit)) and timed, in float32 and float64 (float64 at short
                windows: the plain versions step on the host side once a
                placement row, so float64's groups are small; float32
                keeps the shapes below):
                - wave_block / wave_compact x B in {32, 128} at the
                  headline dispatch shape (E = 32 lanes, P_pad = 2048):
                  packed headline lanes plus numpy-seeded fuzz lanes that
                  saturate and cross the skip threshold (the compact
                  kernel also with spreads and reschedule penalties);
                  then wave_compact's edge groups (WAVE_LIMIT_GROUPS:
                  3, 16 and 17 spreads, and spreads over 16,384 values,
                  fuzz lanes at P_pad = 256); every output equal to the
                  plain version's bits; float64: WAVE_F64_GROUPS (every
                  form of both kernels on fuzz lanes at P_pad = 256);
                - dense_scan on one fused group of E = 32 lanes at
                  N = 16,384, P_pad = 2048: 16 packed spread lanes
                  (count 2,000) and 16 fuzz lanes over ports,
                  distinct_hosts, distinct_property, devices, reserved
                  cores, penalties, non-uniform asks and exhaustion;
                  then fuzz groups at N = 256, 1,024 and 4,096 (held
                  against the plain version, untimed); float64: the same
                  fuzz groups;
                - system_fit on the system eval's lane and 8 fuzz lanes;
                - wave_preempt and dense_preempt on one fused group of
                  E = 32 lanes each at N = 16,384, A = 16 (windowed at
                  P_pad = 2048, dense at P_pad = 512): 16 packed tier-5
                  lanes and 16 fuzz lanes
                  (priority tiers, max_parallel, distinct_hosts,
                  affinity, penalties, saturation, inert lanes), eviction
                  rows and final state exactly too; then, untimed,
                  wave_preempt at B = 128, both at A = 64, and
                  dense_preempt at N = 256, 1,024 and 4,096; float64:
                  the untimed worlds up to 8 lanes and 8 windowed tier-5
                  lanes of 500 at P_pad = 512;
                - lp_relax (float32 only, as the reference's LP) at
                  L_pad in {8, 128, 256} x N in {256, 16,384, 65,536},
                  48 steps, on seeded fuzz with and without
                  oversubscription: X and mu bit for bit; timed at
                  L_pad 128, N 16,384;
                - delta_scatter as bytes (no float compare) over bool,
                  float32 and float64 tables from 4 KiB to the dense
                  headline's largest stacked table (8 MiB) and update
                  buckets from 8 to 65,536, with duplicate padding,
                  -0.0, infinities and NaN payloads; its base untouched;
                - the launch floor: system_fit at E 1 x N 32 and
                  delta_scatter at M 16 x k 8, each against its plain
                  version;
                every row is timed twice: its call (median of 20 calls
                between CUDA events, the wrapper's host part included)
                and, where the wrapper makes no host sync, its device
                time (device_ms: 20 calls enqueued behind a spin);
  4. slice   -- the wave main path: 10,000 nodes (bench.py's world), 32
                evals x 2,000 placements packed with pack_lane_arrays and
                solved by fuse_and_solve in float32 (the run-block
                kernel), then a spread lane and a penalty lane (the
                compact kernel, each launch also timed at its own
                shape); outputs equal to the plain versions' bits;
  5. dense   -- the dense main path: 32 spread evals x 2,000 placements
                (window 2,000), a distinct_property lane and a
                reserved-core lane, through fuse_and_solve in float32
                (three dense_scan launches);
  6. system  -- one system eval over the 10,000 nodes through
                solve_system_arrays (the system_fit kernel);
  7. preempt -- the preemption main path (BASELINE tier 5 at full
                width): the 10,000 nodes filled to 95% of their cpu by
                priority 10-40 allocs, every other node with 2 or 4 GPUs;
                32 evals x 2,000 placements of a priority-70 one-GPU job
                (the windowed kernel) and 8 evals x 500 over fillers in
                max_parallel-1 jobs (the dense one), through
                fuse_and_solve in float32; checks the evictions too (no
                node over capacity after them, none twice, none within
                10 priority levels of the job, no GPU oversubscribed);
  8. lpq     -- the LP tier's main path (bench.py time_lpq's shape): 128
                evals x 8 placements of mock.job over the 10,000 nodes,
                packed with pack_lane_arrays and driven through
                LpqBarrier by 128 threads in float32 (one lp_relax
                launch, L_pad 128), then each eval's second task group
                on the same ledger (126 LP lanes, a spread lane and a
                static-port lane through fuse_and_solve and the
                cross-lane fixpoint); results equal to a rerun with the
                plain LP on the card; prints the warm dispatch's
                breakdown and lpq_stats().
  9. residency -- the dense main path (phase 5's lanes) over four
                generations of a port StateStore's alloc-delta journal:
                g1 cold (installs), g2 the same tables at a newer index
                (content hits, chain reuses), g3 lane 0's first 50
                placements charged into its usage under one journal
                entry (a promotion through delta_scatter), g4 a write
                with no change pairs (gaps, wholesale); per generation
                the outcome counts, bytes shipped, scatter launches and
                dispatch ms; decisions equal to the same generations
                with NOMAD_TPU_TORCH_DELTA_STREAM=0 and cold; after g3
                and g4 every chain buffer equal to its host shadow; the
                scatter timed at g3's shape beside torch.index_put (warm)
                and with its staged upload (_scatter_single); the wave
                headline dispatched twice (its compact tables hit);
 10. wavefront -- solve_wavefront at 32 uniform lanes x 2,000 placements
                x 16,384 node slots (B = 32), float32 and float64: the
                kernel against wavefront_plain on the card (bits) and
                against the wave_block route's decisions; timed; and a
                mixed group (6 headline lanes, the penalty lane and a
                lane whose one penalty lies past its active prefix: the
                run-block and per-placement step loops in one launch)
                and fuzz groups at the prep's edges (one cluster block,
                N off the round size, P above N, fit nodes so scarce the
                walk takes several rounds; lanes with no fit node, every
                node fit, a saturating cast) against wavefront_plain as
                bits in both dtypes.
 11. mesh     -- the mesh route on a grid of 4 cells, every cell cuda:0
                (one process drives them; on several cards each cell
                would be its own card): the dense slice (phase 5's lanes,
                float32 and float64) through fuse_and_solve(device=[cuda]
                * 4), pick_mesh giving (4, 1) for the 32 spread lanes (a
                dense_scan per eval row) and (1, 4) for the
                distinct_property and reserved-core lanes (the
                node-sharded scan: one persistent dense_shard launch per
                card per dispatch, 2 in each dtype's slice); the 32-lane
                group on the forced grids (2, 2) and (1, 4); dense_shard
                against its plain phases on the card (the E = 1 groups,
                timed beside dense_scan on the same lane, and fuzz groups
                over every dense feature), and with the exchange in
                pinned host memory; the wave headline eval-sharded (a
                wave_block per cell); one LP generation through
                solve_queue on (4, 1) (one lp_shard launch) and a forced
                (2, 2), and lp_shard at L 128 x N 16,384 against
                lp_relax, its plain phases and the host-memory exchange
                (X and mu bit for bit, timed beside lp_relax); the wait
                drill: each kernel launched for one cell of a two-cell
                group with a 50 ms budget must raise; phase 9's
                four generations through the grid's per-shard pool and
                version chain (g3 promotes through coord_scatter: one
                payload upload and one launch for the card's 4 cells a
                promoted leaf; chain buffers equal to their shadows;
                per-cell counters), and coord_scatter against its plain
                version at g3's shape, timed, beside the whole
                mesh_delta_scatter from the host payload. Every grid's
                decisions equal the one-card route's bit for bit.
 12. dispatch -- the dispatch layer at full width (32 eval threads a
                barrier, e_pad_hint 32, float32): the guard's CUDA init
                probe passes with the breaker closed; SolveBarrier at depth
                1 and 2 on phase 4's 32 headline lanes, phase 5's dense
                groups and phase 7's 32 windowed tier-5 lanes, and one
                LpqBarrier generation of 32 LP lanes, each equal bit for
                bit to fuse_and_solve plus the cross-lane fixpoint (or
                solve_queue) called directly; 4 barriers of the 32
                headline lanes at once at depth 1 and at depth 2 (one
                run each: wall time until every result is in, each lane's
                wait, the pipeline's prepare stages and most dispatches in
                flight, launches; decisions equal); then a fault drill: a
                hang at solver.dispatch under a 0.5 s deadline gives every
                waiter DispatchFailed("timeout") and trips the breaker
                (threshold 2), which drops the resident set and the arena;
                with solver.probe held and then cleared, the breaker closes
                through the real subprocess probe (it loads the kernel
                library and launches the delta scatter) and the headline
                barrier gives the same bits from a fresh upload. Fails if a
                dispatch of the main-path steps timed out or raised, or if
                the breaker is not closed at the end.
 13. structs  -- the port's Node, Job and Allocation structs in, placements
                out, through TpuPlacementService and the SolveBarrier hook
                (batch.make_solve_hook) in float32: the headline as 10,000
                Node structs in a port StateStore and 32 mock.job evals x
                2,000 on 32 eval threads, two generations (the first's
                placements written to the store as Allocations between
                them: the second packs its usage from the store's alloc
                table, its fold equal to a fresh one); every struct lane
                equal bit for bit
                to pack_lane_arrays' lane from phase 4's arrays (the second
                generation's usage a fresh pack_usage fold), every
                placement equal to those array lanes' through a barrier;
                then one barrier of 8 two-group spread evals (dense; the
                second group packs against the first's placements at the
                same node order), a distinct_property lane with a dynamic
                port, a reserved-core lane, a wave spread lane and a
                reschedule-penalty lane (cores within the node's
                reservable set, ports in its dynamic range); one system
                job through solve_system (equal to solve_system_arrays);
                8 preemption evals x 500 over the fleet 95% full of
                priority 10-40 allocs of other jobs (every eviction on the
                chosen node, of another job, 10 or more priority levels
                below). The dense and preemption lanes too equal, bit for
                bit, their lanes from arrays (the distinct_property, core,
                penalty and candidate tables built from the same
                snapshot), and their results, eviction rows included,
                those array lanes' through barriers of their own. Prints pack and materialize host ms per eval
                (median, max), each generation's wall time, placements per
                second, pack_cache_stats() and the resident chain's
                outcomes; no hook falls back to the host and no dispatch
                fails.
 14. scheduler -- Evaluations in, committed plans out, through the port's
                Harness and its GenericScheduler / SystemScheduler (the
                reconciler, the stacks, the breaker check, submit_plan
                through upsert_plan_results) on one thread an eval with
                the SolveBarrier hook or the LP tier's, float32: phase
                13's fleet with 32 mock.job evals x 2,000, then the same
                jobs scaled to 2,600 (the reconciler reads 2,000 allocs
                each and places 600; the usage from the store's alloc
                table, kept in step by the commits); a system job; a
                mixed barrier of
                two-group spread jobs (the second groups promote through
                the delta scatter), a distinct_property job, a
                reserved-core job and a reschedule with penalties; a
                sticky disk's reschedule through the host stack (the one
                host-stack place; no eval falls back and no dispatch
                fails); 8 preemption evals x 500 over the tier-5
                store; 32 tpu-lpq evals x 8. Every lane and committed
                placement (node, normalized-score bits, evictions) equals
                the direct hook route's, solve_system's or a direct
                LpqBarrier's on the same snapshot and eval ids; prints
                each step's wall time, placements per second and the
                reconcile / pack / barrier wait / materialize /
                submit_plan split per eval.
 15. server  -- a job's eval in, verified and committed placements out,
                through the port's Server (server/core.py) on the card,
                float32, width 32: phase 13's fleet and 32 mock.job
                evals x 2,000 written and enqueued in one call, so one
                BatchWorker dequeues them into one SolveBarrier, and the
                plan applier verifies every plan against the latest
                state and group-commits node-disjoint ones; 0 plans
                rejected, no node over capacity, every placement (node,
                normalized-score bits) equal to phase 14's Harness route
                on a store built by the same writes; then tpu-lpq through
                apply_scheduler_config and a leadership restart (one
                batch worker): 32 evals x 8 through one LpqBarrier, equal
                to a direct LpqBarrier on the same lanes; a system job
                through register_job, equal to solve_system on the
                scheduler's snapshot; the blocked drill (one node with
                room for one alloc, two jobs in one batch, the loser
                blocked until register_node adds a node). Prints each
                step's wall time (evals written to the last plan
                committed), placements per second, per eval the wait for
                the index, the scheduler and submit_plan, the applier's
                verify and commit ms, group sizes, rejections and
                cross-worker serializations, acks and nacks.
 16. telemetry -- the metrics registry, the eval-scoped tracer, the
                transfer ledger and the quality observatory on the card,
                through the port's Server and phase 13's fleet: a warm
                round of 32 mock.job evals x 2,000, every job
                deregistered, the stops acknowledged complete through
                update_allocs_from_client, then a measured round of 32
                new jobs: 64,000 placed, 0 rejected, placements_tpu
                64,000 and placements_host_fallback 0, the observatory's
                accounting equal to a recount, the ledger's parity 0 and
                its shipped bytes equal to resident.stats()'s, every
                eval's trace (all kept) holding broker.wait through
                plan.commit from more than one thread, the fused
                dispatch with 32 lanes; the shadow audit replaying a
                simple job x 40 of the kernels' solves on the host
                (decision mismatches 0, score drift within 1e-3), and
                the quality.skew drill latching its alert; a failed
                acknowledgement's alloc-failure reschedule through
                wave_compact; a round of 8 evals x 2,000 on fresh
                stores with the three kill switches off and on in turn,
                the placements equal bit for bit. Prints the slowest eval's
                waterfall, the saturation report's busy shares, the
                ledger's fields, transfer fit and residency, and each
                cost round's wall time and placements/s.
 17. sanitizers -- the dispatch sanitizers on the card: jitcheck armed
                over one warm headline SolveBarrier generation (32 evals
                x 2,000 on 10,000 nodes, float32) and one warm server
                round as phase 16's cost round runs it, lockcheck and
                statecheck over the same round: per site the launches,
                signatures, builds and late builds, the host syncs
                (sanctioned by tag, and not), dtype drift and cache
                mutations; held-across, drift, journal-gap and
                write-skew counts. Fails on an unsanctioned hot sync, a
                steady-state rebuild, a cache mutation, a lock cycle, a
                torn read or an aliasing write, and unless the armed
                generation and round equal the unarmed ones bit for bit.
                Then schedcheck: a 4 jobs x 50 on 1,000 nodes server
                scenario twice under seed 11 on the real kernels, equal
                decision fingerprints and placements, equal to the
                unsanitized run. Prints the armed round's wall time
                beside the unarmed one's.
 18. leader   -- the server's leader duties on the card, through the
                port's Server with its loops running (phase 13's fleet,
                32 mock.job jobs x 2,000, float32, width 32): the
                headline generation with every lane packed both ways
                before the barrier (the alloc table and the incremental
                usage base, equal bit for bit; each route's median pack
                ms); 100 nodes silent past a 12 s heartbeat TTL while the
                phase heartbeats the other 9,900: exactly those go down,
                every lost alloc is replaced once on other nodes by the
                kernels, 0 plans rejected, and a node flapping three
                times is held down by the quarantine; 3 nodes drained
                at max_parallel 1 (every alloc migrated, every drain
                complete); 24 jobs stopped and acknowledged, GC's
                watermark pass and a table compaction, then 4 evals x
                2,000 packed both ways again; a worker.crash the
                supervisor restarts, its eval placed after its lease;
                then the job operations through the HTTP API on that
                loaded server (10,000 nodes, ~24,000 live allocs): a job
                plan of 2,000 (a dry run of the scheduler and the kernels
                on a copy of the state, the live store unchanged) and of
                an ask no node holds (the exhausted dimension named), the
                planned job run, scaled to 2,500, refused at 3,000 and
                scaled to 1,000 (no launch), and a parameterized job
                dispatched (2,000 on the card; the idempotency token; a
                missing meta key refused).
 19. agent    -- the agent's entry points on the card: the dev agent as a
                process (python3 -m nomad_tpu_torch.api.devagent --nodes
                3 --tpu --port 0, on cuda) driven through the CLI (python3
                -m nomad_tpu_torch.cli): a service job with a spread, a
                batch job and a system job from HCL, their allocs
                running, the batch job's complete, its nodes, the guard
                not degraded with mesh.devices 1, every /v1/agent/self
                stats block, the Prometheus text's placement counters,
                SIGTERM to exit 0; the headline through HTTP (an
                HttpServer over a port Server with the 10,000-node fleet,
                the broker paused through the API, 32 mock.job jobs x
                2,000 registered as JSON, the broker resumed, every job's
                allocs read back through /v1/job/<id>/allocations), equal
                bit for bit to a port Server fed the same Job structs in
                process under the same protocol; the card's fingerprint
                (gpu.count 1, one nvidia/gpu group named as nvidia-smi
                names the card) registered on the agent through
                HttpServerConn, an HCL job asking device "nvidia/gpu" on
                it, the same ask at count 2 one placed and one blocked;
                the dev agent's /v1/agent/torch-profile around one job
                through HTTP, its chrome trace naming the wave_block
                kernel; operator snapshot save and restore of the dev
                agent through the CLI, then a job placed by its kernels.
  Phases 4-16, 18 and 19 reset the launch counts just before and read them
  just after; they check every placement made, no node over capacity (cores
  never below zero, the distinct_property limit held), and results equal
  to the plain versions on the same fused inputs. The kernels line's
  ``barrier_launches`` are phase 12's: its depth-2 barrier generation of
  each input and its LpqBarrier generation; its ``structs_launches`` are
  phase 13's struct routes (the array routes its checks compare with run
  outside the count); its ``scheduler_launches`` phase 14's scheduler
  routes (the direct routes outside the count); its ``server_launches``
  phase 15's server runs (the Harness and direct routes its checks
  compare with run outside the count); its ``telemetry_launches`` phase
  16's warm and measured rounds, audit jobs and reschedule (its cost
  rounds outside the count); its ``leader_launches`` phase 18's steps
  1-5; its ``job_ops_launches`` phase 18's step 6 (the job operations);
  its ``agent_launches`` phase 19's HTTP round (the in-process route
  it compares with, and the dev agent's own process, outside the count).

Prints a full JSON report line, the card line, a {"kernels": [...]} line,
and last the contract line {"ok": true, "device": {...}}.
"""
import json
import os
import statistics
import struct
import subprocess
import sys
import threading
import time
from typing import NamedTuple, Optional
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent

N_NODES = 10_000
N_EVALS = 32
N_PLACE = 2_000
P_PAD = 2048                        # _wave_p_bucket(N_PLACE)
ASK = (500.0, 256.0, 150.0)         # mock.job: 500 MHz, 256 MB, 150 MB disk
STATE_INDEX = 10_001
SEED = 20261017
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,     # H100 SXM, outside the tensor cores
              "float64": 34e12}
RTOL = {"float32": 1e-6, "float64": 1e-12}
KERNEL_REPEATS = 20
DEVICE = "cuda"


_T0 = time.perf_counter()


def log(*a):
    """A progress line, stamped with the seconds since the script
    started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s]", *a, flush=True)


def card_line():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# the headline world, as arrays

def headline_world(np, tp):
    n = N_NODES
    n_pad = tp.bucket_size(n)
    i = np.arange(n)
    pad = np.zeros(n_pad - n)
    matrix = tp.NodeMatrix(
        n_real=n, n_pad=n_pad, node_ids=[f"bench-node-{k:06d}" for k in i],
        cpu_cap=np.r_[np.array([2000.0, 4000.0, 8000.0])[i % 3], pad],
        mem_cap=np.r_[np.array([4096.0, 8192.0, 16384.0])[i % 3], pad],
        disk_cap=np.r_[np.full(n, 100.0 * 1024), pad],
        dyn_free=np.r_[np.full(n, 12001), np.zeros(n_pad - n)].astype(
            np.int32),
        valid=np.arange(n_pad) < n)
    z = np.zeros(n_pad)
    zi = np.zeros(n_pad, dtype=np.int32)
    usage = tp.UsageState(z, z, z, zi, zi, zi)
    feasible = np.ones(n_pad, dtype=bool)
    return matrix, usage, feasible


def spread_info(np, tp, matrix, count):
    """Two spreads: even over 10 racks, and 50/30/20 targets over 3 zones."""
    n, n_pad = matrix.n_real, matrix.n_pad
    i = np.arange(n)
    vidx = np.full((2, n_pad), -1, dtype=np.int32)
    vidx[0, :n] = i % 10
    vidx[1, :n] = (i // 7) % 3
    desired = np.full((2, 10), -1.0)
    desired[1, :3] = np.array([0.5, 0.3, 0.2]) * count
    return tp.SpreadInfo(
        n_spreads=2, value_index=vidx, n_values=10, desired=desired,
        has_targets=np.array([False, True]),
        weights=np.array([50.0, 50.0]), sum_weights=100.0,
        initial_counts=np.zeros((2, 10), dtype=np.int32))


def pack_lanes(np, tp, svc, world, dtype_name, *, kind, n_lanes):
    matrix, usage, feasible = world
    lanes = []
    rng = np.random.default_rng(SEED)
    for e in range(n_lanes):
        kw = {}
        count = N_PLACE
        if kind == "affinity":
            # a count under 100 keeps the window at 100 slots (B = 128)
            count = 90
            kw["affinity"] = np.r_[rng.choice(
                [0.0, 0.0, 0.5, -0.5, 1.0], matrix.n_real),
                np.zeros(matrix.n_pad - matrix.n_real)]
        elif kind == "spread":
            count = 80
            kw["spread_info"] = spread_info(np, tp, matrix, count)
        elif kind == "dense_spread":
            # count 2,000: the window max(count, 100) outgrows every wave
            # buffer, so these lanes take the dense scan
            kw["spread_info"] = spread_info(np, tp, matrix, count)
        elif kind == "penalty":
            count = 60
            kw["penalty_node_ids"] = [
                matrix.node_ids[(37 * k + e) % matrix.n_real]
                if k % 3 == 0 else None for k in range(count)]
        lanes.append(svc.pack_lane_arrays(
            matrix, usage, feasible, ask=ASK, count=count, n_places=count,
            eval_id=f"fused-bench-eval-{kind}-{e:016d}"[-36:],
            state_index=STATE_INDEX, dtype_name=dtype_name, device=DEVICE,
            **kw))
    return lanes


# --------------------------------------------------------------------------
# kernel phase

def fuzz_lane(np, rng, C, B, S, V, dt):
    """A compact table of the reference fuzz's kind (tests/test_wave_block
    _make_case) at a given width: capacities 1..8 force saturation and
    refills, collision counts up to 50 with small job counts push scores
    through the skip threshold both ways."""
    W = 8 + S
    cm = np.zeros((C, W), dtype=dt)
    cm[:, 7] = -1.0
    if S:
        cm[:, 8:] = -1.0
    n_fit = int(rng.integers(B // 2, C + 1))
    ask = float(rng.choice([250.0, 500.0, 1000.0]))
    cpu = rng.choice([2000.0, 4000.0, 8000.0], size=n_fit)
    cm[:n_fit, 0] = np.minimum(rng.integers(1, 9, size=n_fit),
                               np.maximum(cpu // ask, 1.0))
    cm[:n_fit, 1] = rng.integers(0, 3, size=n_fit) * ask
    cm[:n_fit, 2] = rng.integers(0, 3, size=n_fit) * 128.0
    cm[:n_fit, 3] = cpu
    cm[:n_fit, 4] = cpu * 2
    cm[:n_fit, 5] = rng.choice([0.0, 0.0, 0.0, 1.0, 2.0, 50.0], size=n_fit)
    cm[:n_fit, 6] = rng.choice([0.0, 0.0, 0.5, -0.25, 1.0, -1.0],
                               size=n_fit)
    cm[:n_fit, 7] = rng.permutation(C)[:n_fit]
    for s in range(S):
        cm[:n_fit, 8 + s] = rng.integers(-1, V, size=n_fit)
    count = float(rng.choice([1.0, 4.0, 30.0, 2000.0]))
    scal_f = np.array([ask, 128.0, count], dtype=dt)
    n_active = int(rng.integers(1, C - B + 1))
    return cm, scal_f, n_active


def kernel_inputs(np, bp, lanes, *, B, S, penalties, dt, seed, P_pad=None,
                  V=10):
    """E = 32 lanes at P_pad (P_PAD unless given): the packed lanes first,
    numpy-seeded fuzz lanes after them (V spread values); penalties on
    every third lane when asked."""
    P_pad = P_pad or P_PAD
    C = P_pad + B
    rng = np.random.default_rng(seed)
    cms, sfs, sis, pens, sps = [], [], [], [], []
    for ln in lanes:
        cm, sf, si, pen, sp = bp.wavefront_compact_host(
            ln.const, ln.init, ln.batch, np.dtype(dt).name, p_pad=P_pad,
            B=B)
        assert cm.shape == (C, 8 + S), cm.shape
        cms.append(cm), sfs.append(sf), sis.append(si), pens.append(pen)
        counts = np.zeros((S, V), dtype=np.int32)
        counts[:, :sp.counts.shape[1]] = sp.counts
        desired = np.full((S, V), -1.0, dtype=dt)
        desired[:, :sp.desired.shape[1]] = sp.desired
        sps.append((counts, desired, sp.has_targets, sp.weights,
                    sp.sum_weights))
    L = int(sis[0][0]) if sis else (14 if B == 32 else 100)
    while len(cms) < N_EVALS:
        cm, sf, n_active = fuzz_lane(np, rng, C, B, S, V, dt)
        pen = np.full(P_pad, -1, dtype=np.int32)
        if penalties and len(cms) % 3 == 0:
            hot = rng.random(P_pad) < 0.3
            pen[hot] = rng.integers(0, C, size=int(hot.sum()))
        cms.append(cm), sfs.append(sf), pens.append(pen)
        sis.append(np.array([L, n_active], dtype=np.int32))
        weights = rng.choice([25.0, 50.0, 100.0], size=S).astype(dt)
        desired = np.where(rng.random((S, V)) < 0.3, -1.0,
                           rng.integers(0, 6, size=(S, V))).astype(dt)
        sps.append((rng.integers(0, 3, size=(S, V)).astype(np.int32),
                    desired, rng.random(S) < 0.5, weights,
                    np.asarray(weights.sum(), dtype=dt)))
    stack = [np.stack(x) for x in zip(*sps)]
    return (np.stack(cms), np.stack(sfs), np.stack(sis), np.stack(pens),
            stack)


DENSE_FEATURES = ("spreads", "targets", "dp", "devices", "cores", "ports",
                  "distinct", "job_level", "affinity", "penalties",
                  "nonuniform", "low_score", "scarce")


def dense_fuzz_tables(np, rng, *, n, n_pad, p, dtype, limit,
                      features=(), n_active=None):
    """One numpy-seeded dense lane as three dicts of arrays named as the
    NodeConst / NodeState / PlacementBatch fields (the tests build the
    reference's tuples from the same dicts). ``features`` switch on, by
    name: spreads (even form) or targets, dp (distinct_property), devices
    (with affinity weights), cores (reserved cores), ports (static and
    dynamic), distinct (distinct_hosts; job_level for the job-level
    form), affinity, penalties, nonuniform asks (with inactive steps),
    low_score (prior collisions push scores through the skip
    threshold), scarce (small nodes: capacity runs out mid-scan).
    Positions from n to n_pad are padding nodes that never fit."""
    f = set(features)
    bad = f - set(DENSE_FEATURES)
    if bad:
        raise ValueError(f"unknown features {sorted(bad)}")
    dt = np.dtype(dtype).type
    valid = np.arange(n_pad) < n
    caps = [600.0, 1000.0, 1500.0] if "scarce" in f else [2000.0, 4000.0,
                                                          8000.0]
    cpu_cap = np.where(valid, rng.choice(caps, n_pad), 0).astype(dt)
    mem_cap = np.where(valid, rng.choice([4096.0, 8192.0, 16384.0], n_pad),
                       0).astype(dt)
    disk_cap = np.where(valid, 90 * 1024.0, 0).astype(dt)
    k = rng.integers(0, 3, n_pad)
    used_cpu = (k * rng.choice([250.0, 500.0, 1000.0], n_pad)).astype(dt)
    used_mem = (k * rng.choice([256.0, 512.0, 1024.0], n_pad)).astype(dt)
    used_disk = (k * 150.0).astype(dt)
    placed = np.zeros(n_pad, dtype=np.int32)
    if "low_score" in f:
        placed[::3] = rng.integers(1, 4, placed[::3].shape[0])
    placed_job = (placed + rng.integers(0, 2, n_pad)).astype(np.int32)
    aff = np.zeros(n_pad, dtype=dt)
    if "affinity" in f:
        m = rng.random(n_pad) < 0.5
        aff[m] = rng.choice([-1.0, -0.5, 0.25, 0.5, 1.0], int(m.sum()))
    S = 2 if ("spreads" in f or "targets" in f) else 0
    V = 5
    if S:
        vidx = np.where(valid, rng.integers(-1, V, (S, n_pad)),
                        -1).astype(np.int32)
        if "targets" in f:
            desired = np.where(rng.random((S, V)) < 0.3, -1.0,
                               rng.integers(0, p + 1, (S, V))).astype(dt)
            has_t = np.array([True, rng.random() < 0.5])
        else:
            desired = np.full((S, V), -1.0, dtype=dt)
            has_t = np.zeros(S, dtype=bool)
        weights = rng.choice([25.0, 50.0, 100.0], S).astype(dt)
        counts0 = rng.integers(0, 3, (S, V)).astype(np.int32)
    else:
        vidx = np.zeros((0, n_pad), dtype=np.int32)
        desired = np.zeros((0, 1), dtype=dt)
        has_t = np.zeros(0, dtype=bool)
        weights = np.zeros(0, dtype=dt)
        counts0 = np.zeros((0, 1), dtype=np.int32)
    const = dict(
        cpu_cap=cpu_cap, mem_cap=mem_cap, disk_cap=disk_cap,
        feasible=(rng.random(n_pad) > 0.15) & valid, affinity=aff,
        has_affinity=np.asarray("affinity" in f),
        distinct_hosts=np.asarray("distinct" in f),
        distinct_job_level=np.asarray("job_level" in f),
        spread_vidx=vidx, spread_desired=desired, spread_has_targets=has_t,
        spread_weights=weights,
        spread_sum_weights=np.asarray(weights.sum(), dtype=dt),
        n_spreads=np.asarray(S, dtype=np.int32))
    state = dict(
        used_cpu=used_cpu, used_mem=used_mem, used_disk=used_disk,
        placed=placed, placed_job=placed_job,
        static_free=(rng.random(n_pad) > 0.3 if "ports" in f
                     else np.ones(n_pad, dtype=bool)),
        dyn_avail=rng.integers(0, 40, n_pad).astype(np.int32),
        spread_counts=counts0)
    if "dp" in f:
        Dp, Vd = 2, 4
        const["dp_vidx"] = np.where(valid, rng.integers(-1, 3, (Dp, n_pad)),
                                    -1).astype(np.int32)
        const["dp_limit"] = np.array([max(p // 4, 1), max(p // 2, 2)],
                                     dtype=np.int32)
        const["dp_tg_scope"] = np.array([False, True])
        state["dp_counts"] = rng.integers(0, 2, (Dp, Vd)).astype(np.int32)
    if "devices" in f:
        R, Gd = 2, 2
        free = np.where(valid & (rng.random((R, Gd, n_pad)) < 0.6),
                        rng.integers(0, 5, (R, Gd, n_pad)), -1)
        const["dev_aff"] = np.where(
            free >= 0, rng.choice([0.0, 25.0, 50.0, -30.0], (R, Gd, n_pad)),
            0.0).astype(dt)
        const["dev_count"] = np.array([1, 2], dtype=np.int32)
        const["dev_sum_weight"] = np.asarray(80.0, dtype=dt)
        state["dev_free"] = free.astype(np.int32)
    if "cores" in f:
        const["mhz_per_core"] = (cpu_cap / rng.choice([4, 8, 16], n_pad)
                                 ).astype(dt)
        state["cores_free"] = np.where(valid, rng.integers(0, 9, n_pad),
                                       0).astype(np.int32)
    if "nonuniform" in f:
        ask_cpu = rng.choice([250.0, 500.0, 1000.0], p).astype(dt)
        ask_mem = rng.choice([128.0, 256.0, 512.0], p).astype(dt)
    else:
        ask_cpu = np.full(p, 0.0 if "cores" in f else 500.0, dtype=dt)
        ask_mem = np.full(p, 256.0, dtype=dt)
    pen = np.full(p, -1, dtype=np.int32)
    if "penalties" in f:
        hot = rng.random(p) < 0.3
        pen[hot] = rng.integers(0, n, int(hot.sum()))
    active = np.arange(p) < (p if n_active is None else n_active)
    if "nonuniform" in f:
        active &= rng.random(p) > 0.1
    batch = dict(
        ask_cpu=ask_cpu, ask_mem=ask_mem, ask_disk=np.full(p, 300.0, dt),
        n_dyn_ports=np.full(p, 3 if "ports" in f else 0, dtype=np.int32),
        has_static=np.full(p, "ports" in f),
        limit=np.full(p, limit, dtype=np.int32),
        count=np.full(p, int(rng.choice([1, 4, max(p, 1)])), dtype=np.int32),
        penalty_idx=pen, active=active,
        ask_cores=(rng.integers(1, 3, p).astype(np.int32) if "cores" in f
                   else np.zeros(0, dtype=np.int32)))
    return const, state, batch


def time_once(torch, fn):
    """(result, ms) of one call, timed between CUDA events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def timed(torch, fn, repeats):
    """Median ms of ``repeats`` warm calls, each between CUDA events."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(time_once(torch, fn)[1]
                             for _ in range(repeats))


_SPIN = {}


def spin_cycles_per_ms(torch):
    """The cycles torch.cuda._sleep spins a millisecond (timed once)."""
    if "rate" not in _SPIN:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        torch.cuda._sleep(20_000_000)
        b.record()
        b.synchronize()
        _SPIN["rate"] = 20_000_000 / a.elapsed_time(b)
    return _SPIN["rate"]


def enqueue(torch, fn, repeats):
    """Call fn ``repeats`` times with PyTorch's warnings on synchronizing
    CUDA operations turned on; returns the host ms taken, or None if a
    sync was warned of (read after the calls: a failure inside fn raises
    as it would anywhere)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            for _ in range(repeats):
                fn()
            host = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the sync warning itself, not the "prototype feature" notice the
    # mode's first switch-on in a process gives (read as a sync, it left
    # the first kernel measured with no device time)
    if any("called a synchronizing" in str(w.message) for w in caught):
        return None
    return host


def device_ms(torch, fn, repeats=KERNEL_REPEATS):
    """Device ms a call of fn, the host's part hidden: a spin queued on
    the stream (torch.cuda._sleep), an event, ``repeats`` calls enqueued
    back to back, an event, the span over ``repeats``. The spin is sized
    from one probe call's host time so the whole enqueue ends before it
    does (checked; one retry with a longer spin). None where the host
    waits on the device meanwhile (a read-back, a synchronous copy, an
    .item(), or more launches than the stream queues): the call time is
    then all the card can show."""
    fn()
    torch.cuda.synchronize()
    probe = enqueue(torch, fn, 1)
    torch.cuda.synchronize()
    if probe is None:
        return None
    rate = spin_cycles_per_ms(torch)
    spin = max(2.0, 3.0 * repeats * probe)
    for _ in range(2):
        s0 = torch.cuda.Event(enable_timing=True)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s0.record()
        torch.cuda._sleep(int(spin * rate))
        a.record()
        if enqueue(torch, fn, repeats) is None:
            torch.cuda.synchronize()
            return None
        host = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        if host < s0.elapsed_time(a):
            return a.elapsed_time(b) / repeats
        spin = 2.0 * host
    return None


def call_and_device(torch, fn, repeats=KERNEL_REPEATS):
    """(call ms: median of warm calls between CUDA events, host time
    included; device ms as device_ms)."""
    return timed(torch, fn, repeats), device_ms(torch, fn, repeats)


def compare(torch, name, got, want, dtype_name):
    """Decisions exactly, scores within the stated rtol; returns the max
    absolute score difference over finite positions."""
    ch, sc, ny = got
    ch_w, sc_w, ny_w = want
    if not torch.equal(ch, ch_w):
        bad = (ch != ch_w).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: chosen differs at {bad}")
    if not torch.equal(ny, ny_w):
        bad = (ny != ny_w).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: n_yielded differs at {bad}")
    fin = torch.isfinite(sc_w)
    if not torch.equal(fin, torch.isfinite(sc)) or not torch.equal(
            sc[~fin], sc_w[~fin]):
        raise AssertionError(f"{name}: non-finite scores differ")
    diff = (sc[fin] - sc_w[fin]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    tol = RTOL[dtype_name] * sc_w[fin].abs()
    if diff.numel() and bool((diff > tol).any()):
        raise AssertionError(f"{name}: scores beyond rtol "
                             f"{RTOL[dtype_name]} (max abs {err})")
    return err


def bound(name, nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


# Floating-point operations per slot, counted from the kernel bodies in
# nomad_tpu_torch/csrc: each add, sub, mul, div, min/max, compare and pow
# is one, an fma two (as the peak rate counts it); integer scans and
# conversions are not counted, so the bound stays a lower one.
#   head_terms (wave_common.cuh): fit 1, new cpu/mem 2+2, free cpu/mem
#     3+3, binpack_raw 6 (2 pow, add, sub, 2 clamps), coll 1, anti 5 = 23
#     (HEAD_OPS; a slot's head changes only when its j does, so the
#     kernels cache it: wave_warp.cuh)
#   run-block decision, per slot: low 1, one compare in each of the two
#     arg-best reductions (winner, runner-up)                      -> 3
#   run-block stream value (one per warp lane per run; lane 31 scores the
#     next refill row's head with the same expressions): jq 1, valid 1,
#     jp1 1, free cpu/mem 5+5, binpack_raw 6, coll 1, anti 5, nsc 4,
#     final 4, win_q 3, cross 1                                    -> 37
#   per-placement step (wave_warp.cuh), per slot: penalty 1, nscores 6,
#     final (3 adds, fma, div) 6, low 1, arg-best 1               -> 15;
#     and the winner's new head, HEAD_OPS, once a placing step
#   per spread: the even form's boost (sub, max, div) and its sum 4
#     (the target form takes 7; the lower count keeps a lower bound)
HEAD_OPS, BLOCK_SLOT_OPS, STREAM_OPS, COMPACT_SLOT_OPS, SPREAD_OPS = (
    23, 3, 37, 15, 4)


def wave_groups(np, torch, bp, svc, tp, world, dtype_name):
    """The kernel phase's four wave groups (E = 32, P_pad = 2048) as
    tensors on the card: (kname, B, S, (compact, scal_f, scal_i, pen),
    spread tables). wave_block at B = 32 (headline lanes) and 128
    (affinity lanes), wave_compact at B = 32 (penalty lanes, S = 0) and
    128 (spread lanes, S = 2), each topped up with fuzz lanes."""
    dt = np.dtype(dtype_name).type
    half, quarter = N_EVALS // 2, N_EVALS // 4
    head = pack_lanes(np, tp, svc, world, dtype_name, kind="plain",
                      n_lanes=half)
    aff = pack_lanes(np, tp, svc, world, dtype_name, kind="affinity",
                     n_lanes=half)
    spread = pack_lanes(np, tp, svc, world, dtype_name, kind="spread",
                        n_lanes=quarter)
    pen = pack_lanes(np, tp, svc, world, dtype_name, kind="penalty",
                     n_lanes=quarter)
    groups = []
    for B in (32, 128):
        for kname in ("wave_block", "wave_compact"):
            if kname == "wave_block":
                lanes, S, penalties = (head if B == 32 else aff), 0, False
            else:
                lanes = pen if B == 32 else spread
                S, penalties = (0 if B == 32 else 2), True
            cm, sf, si, pn, sp = kernel_inputs(
                np, bp, lanes, B=B, S=S, penalties=penalties, dt=dt,
                seed=SEED + B + S)
            dev = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
                        for a in (cm, sf, si, pn))
            spd = bp.WaveSpread(*(torch.from_numpy(
                np.ascontiguousarray(a)).to(DEVICE) for a in sp))
            groups.append((kname, B, S, dev, spd))
    return groups


# (B, S, V) of the kernel phase's wave_compact groups at the edges of the
# kernel's forms, fuzz lanes at P_pad = 256: 3 and 16 spreads (value
# indexes in registers, past the S <= 2 form), 17 (one spread's index read
# from the compact row), and one or two spreads over a per-node attribute
# of the headline's 16,384 nodes (the desired counts beside the counts in
# shared memory for one, read from global memory for two)
WAVE_LIMIT_GROUPS = ((128, 3, 10), (128, 16, 10), (128, 17, 10),
                     (32, 17, 10), (128, 1, 16_384), (128, 2, 16_384))
LIMIT_P_PAD = 256


# float64's wave groups: each form of both wave kernels on fuzz lanes at
# the limit groups' window (P_pad 256), (kname, B, S, V). The plain
# versions step once per compact row, so the headline shape's 2,080-2,176
# rows cost about 6x the host time of these 288-384; float32 keeps the
# headline shape and every limit group.
WAVE_F64_GROUPS = (("wave_block", 32, 0, 10), ("wave_compact", 32, 0, 10),
                   ("wave_block", 128, 0, 10), ("wave_compact", 128, 2, 10),
                   ("wave_compact", 128, 3, 10),
                   ("wave_compact", 128, 1, 16_384),
                   ("wave_compact", 128, 2, 16_384))


def wave_limit_groups(np, torch, bp, dtype_name, *, max_v=None,
                      specs=None):
    """WAVE_LIMIT_GROUPS (or ``specs``: (kname, B, S, V)) as wave_groups'
    tuples, fuzz lanes at P_pad LIMIT_P_PAD (those with V <= max_v when
    given)."""
    dt = np.dtype(dtype_name).type
    groups = []
    if specs is None:
        specs = [("wave_compact", B, S, V) for B, S, V in WAVE_LIMIT_GROUPS]
    for kname, B, S, V in specs:
        if max_v is not None and V > max_v:
            continue
        cm, sf, si, pn, sp = kernel_inputs(
            np, bp, [], B=B, S=S, penalties=kname == "wave_compact", dt=dt,
            seed=SEED + 7 * B + S + V, P_pad=LIMIT_P_PAD, V=V)
        dev = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
                    for a in (cm, sf, si, pn))
        spd = bp.WaveSpread(*(torch.from_numpy(
            np.ascontiguousarray(a)).to(DEVICE) for a in sp))
        groups.append((kname, B, S, dev, spd))
    return groups


def wave_call(wave, kname, dev, spd, B, *, plain=False):
    """A zero-argument call of a wave kernel (or its plain version) on
    one group's tensors."""
    if kname == "wave_block":
        fn = wave.wave_block_plain if plain else wave.wave_block
        return lambda: fn(dev[0], dev[1], dev[2], spread_alg=False, B=B)
    fn = wave.wave_compact_plain if plain else wave.wave_compact
    return lambda: fn(dev[0], dev[1], dev[2], dev[3], spd, spread_alg=False,
                      B=B)


def wave_bound(kname, dev, spd, got, want, B, S, dtype_name):
    """(bound_ms, bound_by, bytes, flops) of one wave kernel launch:
    inputs read once, outputs written once; the operations this data
    needs (steps that place something, or for the run-block kernel at
    least one run decision per change of chosen node)."""
    nbytes = (sum(t.nbytes for t in dev[:3]) + sum(t.nbytes for t in got))
    if kname == "wave_compact":
        nbytes += dev[3].nbytes + sum(t.nbytes for t in spd)
        steps = int((want[0] >= 0).sum())
        flops = steps * (B * (COMPACT_SLOT_OPS + S * SPREAD_OPS)
                         + HEAD_OPS)
    else:
        ch = want[0]
        runs = int(((ch[:, 1:] != ch[:, :-1]) & (ch[:, 1:] >= 0)).sum()
                   + (ch[:, 0] >= 0).sum())
        flops = runs * (B * BLOCK_SLOT_OPS + 32 * STREAM_OPS)
    return (*bound(kname, nbytes, flops, dtype_name), nbytes, flops)


def kernel_phase(np, torch, bp, wave, kernels, svc, tp, world):
    """wave_block and wave_compact against their plain versions, as bits:
    float32 on wave_groups (the headline shape) and every limit group,
    float64 on WAVE_F64_GROUPS; timed."""
    results = []
    for dtype_name in ("float32", "float64"):
        groups = (wave_groups(np, torch, bp, svc, tp, world, dtype_name)
                  + wave_limit_groups(np, torch, bp, dtype_name)
                  if dtype_name == "float32" else wave_limit_groups(
                      np, torch, bp, dtype_name, specs=WAVE_F64_GROUPS))
        for kname, B, S, dev, spd in groups:
            run = wave_call(wave, kname, dev, spd, B)
            got, _ = time_once(torch, run)
            want, plain_ms = time_once(
                torch, wave_call(wave, kname, dev, spd, B, plain=True))
            V = int(spd.counts.shape[-1])
            tag = f"{kname} {dtype_name} B={B} S={S}" + (
                f" V={V}" if S else "")
            err = compare(torch, tag, got, want, dtype_name)
            for f, g, w in zip(("chosen", "scores", "n_yielded"), got, want):
                same_bits(torch, f"{tag} {f}", g, w)
            ms = timed(torch, run, KERNEL_REPEATS)
            dms = device_ms(torch, run) if dtype_name == "float32" else None
            bound_ms, bound_by, nbytes, flops = wave_bound(
                kname, dev, spd, got, want, B, S, dtype_name)
            placed = int((want[0] >= 0).sum())
            shape = list(dev[0].shape)
            log(f"kernel {tag}: E={shape[0]} C={shape[1]} "
                f"placed={placed} match=bits max_abs_err={err:.3e} "
                f"ms={ms:.4f} plain_ms={plain_ms:.1f} "
                f"bound_ms={bound_ms:.6f} ({bound_by}, {nbytes} B, "
                f"{flops} flop)")
            results.append(dict(
                name=kname, dtype=dtype_name, B=B, S=S, V=V, shape=shape,
                placed=placed, max_abs_err=err, ms=ms, device_ms=dms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops))
    return results


# --------------------------------------------------------------------------
# slice phase: the main path

def check_capacity(np, lane, chosen, count):
    placed = chosen >= 0
    assert int(placed.sum()) == count, (int(placed.sum()), count)
    pos, k = np.unique(chosen[placed], return_counts=True)
    c = lane.const
    for cap, used, ask in ((c.cpu_cap, lane.init.used_cpu, ASK[0]),
                           (c.mem_cap, lane.init.used_mem, ASK[1]),
                           (c.disk_cap, lane.init.used_disk, ASK[2])):
        assert bool(np.all(used[pos] + k * ask <= cap[pos])), "over capacity"
    assert bool(np.all(c.feasible[pos]))


def slice_phase(np, torch, wave, kernels, svc, batch, tp, world):
    t0 = time.perf_counter()
    head = pack_lanes(np, tp, svc, world, "float32", kind="plain",
                      n_lanes=N_EVALS)
    extra = (pack_lanes(np, tp, svc, world, "float32", kind="spread",
                        n_lanes=1)
             + pack_lanes(np, tp, svc, world, "float32", kind="penalty",
                          n_lanes=1))
    pack_ms = (time.perf_counter() - t0) * 1e3
    assert head[0].wavefront_B() == 32 and extra[0].wavefront_B() == 128

    kernels.reset_launches()
    res_head = batch.fuse_and_solve(head, device=DEVICE)
    res_extra = batch.fuse_and_solve(extra, device=DEVICE)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    log(f"slice launches: {launches}")
    assert launches["wave_block"] >= 1, launches
    assert launches["wave_compact"] >= 2, launches

    for lane, (ch, sc, ny) in zip(head + extra, res_head + res_extra):
        check_capacity(np, lane, ch, lane.batch.ask_cpu.shape[0])
        assert ch.dtype == np.int64 and ny.dtype == np.int64
        assert bool(np.all(np.isfinite(sc)))
    total = sum(int((r[0] >= 0).sum()) for r in res_head)
    assert total == N_EVALS * N_PLACE, total

    # the same fused inputs through the plain versions on the card; the
    # compact kernel's two launches (the spread lane and the penalty
    # lane) timed at their own shapes, CUDA events, medians of
    # KERNEL_REPEATS
    main_launches = []
    for lanes, res in ((head, res_head), (extra, res_extra)):
        for g in batch.fuse_lanes(lanes):
            inp = wave.wave_inputs(g.const, g.init, g.batch,
                                   dtype_name=g.dtype_name)
            cm, sf, si, pn, sp = wave.wave_tensors(inp, torch.device(DEVICE))
            assert not g.spread_alg
            kname = "wave_block" if inp.use_block else "wave_compact"
            dev = (cm, sf, si, pn)
            want, plain_ms = time_once(
                torch, wave_call(wave, kname, dev, sp, inp.B, plain=True))
            run = wave_call(wave, kname, dev, sp, inp.B)
            got_k = run()
            for f, gk, w in zip(("chosen", "scores", "n_yielded"), got_k,
                                want):
                same_bits(torch, f"slice {kname} {f}", gk, w)
            for j, li in enumerate(g.idxs):
                P = lanes[li].batch.ask_cpu.shape[0]
                got = tuple(torch.from_numpy(np.asarray(x)).to(DEVICE)
                            for x in res[li])
                for f, gl, w in zip(("chosen", "scores", "n_yielded"), got,
                                    want):
                    same_bits(torch, f"slice lane {li} {f}", gl, w[j, :P])
            if kname == "wave_compact":
                S = cm.shape[2] - 8
                ms, dms = call_and_device(torch, run)
                bound_ms, bound_by, nbytes, flops = wave_bound(
                    kname, dev, sp, got_k, want, inp.B, S, "float32")
                lane = "spread" if S else "penalty"
                log(f"slice wave_compact {lane} lane: E={cm.shape[0]} "
                    f"C={cm.shape[1]} B={inp.B} S={S} ms={ms:.4f} "
                    f"plain_ms={plain_ms:.1f} bound_ms={bound_ms:.6f} "
                    f"({bound_by}, {nbytes} B, {flops} flop)")
                main_launches.append(dict(
                    name=kname, lane=lane, dtype="float32", B=inp.B, S=S,
                    shape=list(cm.shape), max_abs_err=0.0, ms=ms,
                    device_ms=dms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, bytes=nbytes, flops=flops))

    # warm end-to-end time of the headline dispatch (host precompute,
    # transfer, kernel, fetch), host clock; results are on the host
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        batch.fuse_and_solve(head, device=DEVICE)
        times.append((time.perf_counter() - t1) * 1e3)
    fuse_ms = statistics.median(times)
    # where a warm dispatch's time goes (host clock, medians of 5): the
    # host stacking of lanes, the host compact-table precompute, and the
    # device part (copy in, kernel, copy of the results back to the host)
    parts = {"fuse_lanes": [], "wave_inputs": [], "device": []}
    for _ in range(5):
        t1 = time.perf_counter()
        g = batch.fuse_lanes(head)[0]
        t2 = time.perf_counter()
        inp = wave.wave_inputs(g.const, g.init, g.batch,
                               dtype_name="float32")
        t3 = time.perf_counter()
        out = wave.run_wave(inp, spread_alg=False,
                            device=torch.device(DEVICE))
        [o.cpu() for o in out]
        t4 = time.perf_counter()
        for k, v in zip(parts, (t2 - t1, t3 - t2, t4 - t3)):
            parts[k].append(v * 1e3)
    parts = {k: statistics.median(v) for k, v in parts.items()}
    log(f"slice: {N_EVALS} evals x {N_PLACE} placements x {N_NODES} nodes: "
        f"all {total} placed, no node over capacity, equal to the plain "
        f"versions; pack_ms={pack_ms:.1f} fuse_and_solve_ms={fuse_ms:.2f} "
        f"placements_per_s={total / (fuse_ms / 1e3):.0f}; breakdown ms: "
        + " ".join(f"{k}={v:.2f}" for k, v in parts.items()))
    return dict(launches=launches, main_launches=main_launches,
                fuse_and_solve_ms=fuse_ms,
                fuse_and_solve_ms_all=times, breakdown_ms=parts,
                pack_ms=pack_ms, placements=total,
                placements_per_s=total / (fuse_ms / 1e3),
                B=inp.B, use_block=inp.use_block)


# --------------------------------------------------------------------------
# slice 2: the dense greedy path and system jobs

DP_PLACE, DP_LIMIT = 200, 25        # distinct_property ${meta.rack} lane
CORES_PLACE, CORES_ASK = 200, 2     # reserved-core lane
SYSTEM_ASK = (100.0, 64.0, 10.0)    # the system eval's task group
# the dense kernel phase's common table shapes (every lane of one fused
# group carries the same tables)
DENSE_S, DENSE_V, DENSE_DP, DENSE_VD, DENSE_R, DENSE_GD = 2, 10, 2, 16, 2, 2
# Floating-point operations counted from the kernel bodies
# (csrc/dense_common.cuh, dense_scan.cu, system_fit.cu) as above: each
# add, sub, mul, div, min/max, compare and pow one, an fma two.
#   dense fit check per node and step (score_node before the score):
#     new cpu/mem/disk 3 adds + 3 compares                      -> 6
#   dense score per yielded node and step: free cpu/mem (2 max, 2 div,
#     2 sub, 2 adds) 8, binpack_raw 6, anti 5, nscores 4, other 3,
#     final (fma, div) 3, low 1, arg-best 1                     -> 31
#     plus 4 per spread (SPREAD_OPS)
#   system per node: fit 6, free cpu/mem 8, binpack_raw 6, * 1/18 1 -> 21
# The dense count takes, per step, the fit check and the score of the
# nodes the window yields (n_yielded, this run's data): every step needs
# at least those, while the nodes before the window closes that do not
# yield depend on the data and are left out, so the bound stays a lower
# one.
DENSE_FIT_OPS, DENSE_SCORE_OPS, SYSTEM_OPS = 6, 31, 21


def rack_of(np, n_pad, n):
    """meta.rack = i % 10 (the even spread's attribute), -1 on padding."""
    v = np.full(n_pad, -1, dtype=np.int32)
    v[:n] = np.arange(n) % 10
    return v


def slice2_lanes(np, tp, svc, world, dtype_name, *, n_spread):
    """The dense slice's lanes: ``n_spread`` spread lanes at count 2,000,
    a distinct_property lane (${meta.rack}, limit 25, 200 placements)
    and a reserved-core lane (2 cores, 200 placements; mhz_per_core
    2000/4000/8000 over 4/8/16 cores by i % 3)."""
    matrix, usage, feasible = world
    n, n_pad = matrix.n_real, matrix.n_pad
    lanes = pack_lanes(np, tp, svc, world, dtype_name, kind="dense_spread",
                       n_lanes=n_spread)
    dp = tp.DistinctPropertyInfo(
        value_index=rack_of(np, n_pad, n)[None], limit=np.array([DP_LIMIT]),
        tg_scope=np.array([False]), counts=np.zeros((1, 16), np.int32))
    lanes.append(svc.pack_lane_arrays(
        matrix, usage, feasible, ask=ASK, count=DP_PLACE, n_places=DP_PLACE,
        eval_id="fused-bench-eval-distinct-property", distinct_property=dp,
        state_index=STATE_INDEX, dtype_name=dtype_name, device=DEVICE))
    i = np.arange(n_pad)
    cores = np.where(i < n, np.array([4, 8, 16])[i % 3], 0)
    mhz = np.where(i < n, np.array([2000.0, 4000.0, 8000.0])[i % 3]
                   / np.maximum(cores, 1), 0.0)
    lanes.append(svc.pack_lane_arrays(
        matrix, usage, feasible, ask=(0.0, ASK[1], ASK[2]),
        count=CORES_PLACE, n_places=CORES_PLACE,
        eval_id="fused-bench-eval-reserved-cores", ask_cores=CORES_ASK,
        mhz_per_core=mhz, cores_free=cores.astype(np.int32),
        state_index=STATE_INDEX, dtype_name=dtype_name, device=DEVICE))
    return lanes


def widen(np, const, init, batch, dt):
    """One lane's tables (dicts of arrays) grown to the dense kernel
    phase's common shapes: spread values padded to DENSE_V, and neutral
    distinct_property, device and core tables where the lane has none
    (every node passes them and they add no score term)."""
    n_pad = const["cpu_cap"].shape[0]
    S, V = init["spread_counts"].shape
    assert S == DENSE_S, S
    counts = np.zeros((S, DENSE_V), dtype=np.int32)
    counts[:, :V] = init["spread_counts"]
    desired = np.full((S, DENSE_V), -1.0, dtype=dt)
    desired[:, :V] = const["spread_desired"]
    init["spread_counts"], const["spread_desired"] = counts, desired
    if np.asarray(const.get("dp_vidx", np.zeros((0, 0)))).shape[0] == 0:
        const["dp_vidx"] = np.zeros((DENSE_DP, n_pad), dtype=np.int32)
        const["dp_limit"] = np.full(DENSE_DP, 1 << 30, dtype=np.int32)
        const["dp_tg_scope"] = np.zeros(DENSE_DP, dtype=bool)
        init["dp_counts"] = np.zeros((DENSE_DP, DENSE_VD), dtype=np.int32)
    else:
        dpc = np.zeros((DENSE_DP, DENSE_VD), dtype=np.int32)
        dpc[:, :init["dp_counts"].shape[1]] = init["dp_counts"]
        init["dp_counts"] = dpc
    if np.asarray(const.get("dev_aff", np.zeros((0, 0, 0)))).shape[0] == 0:
        const["dev_aff"] = np.zeros((DENSE_R, DENSE_GD, n_pad), dtype=dt)
        const["dev_count"] = np.ones(DENSE_R, dtype=np.int32)
        const["dev_sum_weight"] = np.asarray(0.0, dtype=dt)
        init["dev_free"] = np.full((DENSE_R, DENSE_GD, n_pad), 1 << 20,
                                   dtype=np.int32)
    P = batch["ask_cpu"].shape[0]
    if np.asarray(const.get("mhz_per_core", np.zeros(0))).shape[0] == 0:
        const["mhz_per_core"] = np.zeros(n_pad, dtype=dt)
        init["cores_free"] = np.full(n_pad, 1 << 20, dtype=np.int32)
        batch["ask_cores"] = np.zeros(P, dtype=np.int32)
    return const, init, batch


def lane_dicts(np, lane, p_pad):
    """A packed lane's tables as dicts, its placement axis padded to
    p_pad with inactive steps."""
    const = {f: np.asarray(getattr(lane.const, f))
             for f in type(lane.const)._fields}
    init = {f: np.asarray(getattr(lane.init, f))
            for f in type(lane.init)._fields}
    batch = {}
    for f in type(lane.batch)._fields:
        a = np.asarray(getattr(lane.batch, f))
        if a.shape[0]:
            fill = {"active": False, "penalty_idx": -1, "count": 1}.get(f, 0)
            out = np.full((p_pad,) + a.shape[1:], fill, dtype=a.dtype)
            out[:a.shape[0]] = a
            a = out
        batch[f] = a
    return const, init, batch


def dense_group(np, bp, dicts):
    """Stack lane dicts into the (E, ...) NodeConst / NodeState /
    PlacementBatch of one fused dispatch."""
    return tuple(
        cls(**{f: np.stack([np.asarray(d[k].get(f, cls._field_defaults.get(
            f))) for d in dicts]) for f in cls._fields})
        for k, cls in enumerate((bp.NodeConst, bp.NodeState,
                                 bp.PlacementBatch)))


def tree_nbytes(trees):
    return sum(t.nbytes for tree in trees for t in tree)


def dense_bound(torch, const, init, batch, out, dtype_name):
    """(bound_ms, bound_by, bytes, flops): the inputs read once, the
    outputs (decisions and final state) written once; the operations
    this run's data needs (see DENSE_FIT_OPS)."""
    nbytes = tree_nbytes((const, init, batch)) + sum(
        t.nbytes for t in out[:3]) + tree_nbytes((out.state,))
    S = const.spread_vidx.shape[1]
    per_node = DENSE_FIT_OPS + DENSE_SCORE_OPS + S * SPREAD_OPS
    flops = int(out.n_yielded.sum()) * per_node
    return bound("dense_scan", nbytes, flops, dtype_name) + (nbytes, flops)


def compare_dense(torch, name, got, want, dtype_name):
    """compare() on the decisions and scores, plus every final state
    field exactly."""
    err = compare(torch, name, got[:3], want[:3], dtype_name)
    for f, g, w in zip(type(got.state)._fields, got.state, want.state):
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: final state {f} differs")
    return err


# Lane counts of the cluster checks: the launcher's cluster size C is the
# largest power of two <= 16 with E * C <= 132 whose E clusters can all
# be resident (csrc/dense_common.cuh choose_cluster): 16 at E = 1 and 8,
# 4 at E = 32, 2 at E = 64, 1 at E = 80 -- less where the card cannot
# hold that many clusters of that size at once.
CLUSTER_LANES = (1, 8, 32, 64, 80)


DENSE_FUZZ_SETS = (
    ("targets", "dp", "devices", "cores", "ports", "penalties"),
    ("spreads", "dp", "devices", "cores", "distinct", "low_score"),
    ("targets", "dp", "devices", "cores", "distinct", "job_level",
     "affinity"),
    ("spreads", "dp", "devices", "cores", "nonuniform", "scarce"),
)


def dense_mixed_group(np, bp, svc, tp, world, dtype_name, rng):
    """The dense kernel phase's fused group (numpy trees): N_EVALS / 2
    packed spread lanes and as many fuzz lanes over DENSE_FUZZ_SETS."""
    matrix = world[0]
    dt = np.dtype(dtype_name).type
    dicts = [widen(np, *lane_dicts(np, ln, P_PAD), dt) for ln in
             pack_lanes(np, tp, svc, world, dtype_name, kind="dense_spread",
                        n_lanes=N_EVALS // 2)]
    k = 0
    while len(dicts) < N_EVALS:
        c, s, b = dense_fuzz_tables(
            np, rng, n=matrix.n_real, n_pad=matrix.n_pad, p=P_PAD,
            dtype=dtype_name, limit=int(rng.choice([14, 100, 2000])),
            features=DENSE_FUZZ_SETS[k % len(DENSE_FUZZ_SETS)],
            n_active=int(rng.integers(200, 1500)))
        dicts.append(widen(np, c, s, b, dt))
        k += 1
    return dense_group(np, bp, dicts)


def dense_kernel_phase(np, torch, bp, dense, kernels, svc, tp, world, seed):
    """dense_scan in float32 on one fused group of E = 32 lanes at
    N = 16,384, P_pad = 2,048: 16 packed spread lanes (count 2,000) and
    16 numpy-seeded fuzz lanes at fewer active placements, covering
    ports, distinct_hosts (job and group level), distinct_property,
    devices with affinity, reserved cores, penalties, non-uniform asks,
    capacity exhaustion and skip-threshold crossings. Then, untimed, fuzz
    groups of every lane count in CLUSTER_LANES (so every cluster size
    the launcher picks) at the small node buckets (N = 256 and 1,024,
    where a block's share of the nodes is less than one round) and a
    mid-size one (N = 4,096), with limits 3 to 2,000 (above the node
    count: the walk never stops early). float64: the same fuzz
    groups."""
    results = []
    for dtype_name in ("float32", "float64"):
        rng = np.random.default_rng(seed)
        if dtype_name == "float32":
            # the 32-lane group at P 2,048 in float32 only: the plain
            # scan rescores every node a step
            const, init, batch = dense_mixed_group(np, bp, svc, tp, world,
                                                   dtype_name, rng)
            c, s, b = dense.lane_tensors(const, init, batch,
                                         dtype_name=dtype_name,
                                         device=torch.device(DEVICE))

            def run(fn):
                return fn(c, s, b, spread_alg=False)

            got, _ = time_once(torch, lambda: run(dense.dense_scan))
            C = kernels.DENSE_SCAN.last_cluster()
            want, plain_ms = time_once(
                torch, lambda: run(dense.dense_scan_plain))
            tag = f"dense_scan {dtype_name}"
            err = compare_dense(torch, tag, got, want, dtype_name)
            ms = timed(torch, lambda: run(dense.dense_scan),
                       KERNEL_REPEATS)
            bound_ms, bound_by, nbytes, flops = dense_bound(
                torch, c, s, b, want, dtype_name)
            placed = int((want.chosen >= 0).sum())
            log(f"kernel {tag}: E={c.cpu_cap.shape[0]} "
                f"N={c.cpu_cap.shape[1]} P={b.ask_cpu.shape[1]} C={C} "
                f"placed={placed} match=exact max_abs_err={err:.3e} "
                f"ms={ms:.4f} plain_ms={plain_ms:.1f} "
                f"bound_ms={bound_ms:.6f} ({bound_by}, {nbytes} B, "
                f"{flops} flop)")
            results.append(dict(
                name="dense_scan", dtype=dtype_name,
                shape=[int(x) for x in (*c.cpu_cap.shape,
                                        b.ask_cpu.shape[1])],
                cluster=C, placed=placed, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops))
        for E in CLUSTER_LANES:
            sizes = (((200, 256), (1000, 1024), (4000, 4096)) if E <= 8
                     else ((200, 256), (1000, 1024)))
            for n, n_pad in sizes:
                results.append(dense_fuzz_check(
                    np, torch, bp, dense, kernels, rng, dtype_name, E, n,
                    n_pad))
    return results


def dense_fuzz_check(np, torch, bp, dense, kernels, rng, dtype_name, E, n,
                     n_pad):
    """dense_scan on a fuzz group of E lanes (DENSE_FUZZ_SETS) at n nodes
    padded to n_pad, limits 3 to 2,000, against its plain version."""
    dt = np.dtype(dtype_name).type
    fuzz_sets = DENSE_FUZZ_SETS
    dicts = [widen(np, *dense_fuzz_tables(
        np, rng, n=n, n_pad=n_pad, p=128 if E <= 8 else 64,
        dtype=dtype_name, limit=int(rng.choice([3, 14, 100, 2000])),
        features=fuzz_sets[k % len(fuzz_sets)]), dt) for k in range(E)]
    small = dense.lane_tensors(*dense_group(np, bp, dicts),
                               dtype_name=dtype_name,
                               device=torch.device(DEVICE))
    got = dense.dense_scan(*small, spread_alg=False)
    C = kernels.DENSE_SCAN.last_cluster()
    want = dense.dense_scan_plain(*small, spread_alg=False)
    tag = f"dense_scan {dtype_name} E={E} N={n_pad}"
    err = compare_dense(torch, tag, got, want, dtype_name)
    log(f"kernel {tag}: C={C} P={small[2].ask_cpu.shape[1]} "
        f"placed={int((want.chosen >= 0).sum())} match=exact "
        f"max_abs_err={err:.3e}")
    return dict(name="dense_scan", dtype=dtype_name,
                world=f"fuzz E={E} N={n_pad}", cluster=C, max_abs_err=err)


def system_world(np, world, seed):
    """The system eval's inputs over the headline fleet: about 5% of nodes
    infeasible by mask, a static port already taken on about 1%."""
    matrix, usage, feasible = world
    rng = np.random.default_rng(seed)
    n, n_pad = matrix.n_real, matrix.n_pad
    feas = feasible & (rng.random(n_pad) >= 0.05)
    ports_free = rng.random(n_pad) >= 0.01
    return feas, ports_free


def system_kernel_phase(np, torch, bp, dense, system, svc, world, seed):
    """system_fit x {float32, float64} on the system eval's lane (E = 1,
    N = 16,384) and on 8 numpy-seeded fuzz lanes (cores, ports, scarce
    nodes); the system lane is timed."""
    results = []
    matrix, usage, _ = world
    feas, ports_free = system_world(np, world, seed)
    for dtype_name in ("float32", "float64"):
        lane = svc.pack_lane_arrays(
            matrix, usage, feas, ask=SYSTEM_ASK, count=1, n_places=1,
            eval_id="system-bench-eval-0000000000000000",
            state_index=STATE_INDEX, static_ports_free=ports_free,
            n_dyn_ports=1, dtype_name=dtype_name, device=DEVICE)
        rng = np.random.default_rng(seed + 1)
        fuzz = [dense_fuzz_tables(np, rng, n=matrix.n_real,
                                  n_pad=matrix.n_pad, p=1,
                                  dtype=dtype_name, limit=2,
                                  features=("cores", "ports", "scarce"))
                for _ in range(8)]
        groups = (("system", dense_group(np, bp, [lane_dicts(np, lane, 1)])),
                  ("fuzz", dense_group(np, bp, fuzz)))
        for tag, tables in groups:
            c, s, b = dense.lane_tensors(*tables, dtype_name=dtype_name,
                                         device=torch.device(DEVICE))

            def run(fn):
                return fn(c, s, b, spread_alg=False)

            got, _ = time_once(torch, lambda: run(system.system_fit))
            want, plain_ms = time_once(torch,
                                       lambda: run(system.system_fit_plain))
            name = f"system_fit {dtype_name} {tag}"
            if not torch.equal(got[0], want[0]):
                raise AssertionError(f"{name}: fit differs")
            err = float((got[1] - want[1]).abs().max())
            if not bool((got[1] == want[1]).all()):
                tol = RTOL[dtype_name] * want[1].abs()
                if bool(((got[1] - want[1]).abs() > tol).any()):
                    raise AssertionError(f"{name}: scores beyond rtol")
            ms, dms = call_and_device(torch, lambda: run(system.system_fit))
            nbytes = (sum(getattr(t, f).nbytes for t, f in (
                (c, "cpu_cap"), (c, "mem_cap"), (c, "disk_cap"),
                (c, "feasible"), (c, "mhz_per_core"), (s, "used_cpu"),
                (s, "used_mem"), (s, "used_disk"), (s, "static_free"),
                (s, "dyn_avail"), (s, "cores_free")))
                + sum(t[:, :1].nbytes for t in b if t.dim() == 2)
                + got[0].nbytes + got[1].nbytes)
            flops = int(c.cpu_cap.numel()) * SYSTEM_OPS
            bound_ms, bound_by = bound("system_fit", nbytes, flops,
                                       dtype_name)
            n_fit = int(want[0].sum())
            log(f"kernel {name}: E={c.cpu_cap.shape[0]} "
                f"N={c.cpu_cap.shape[1]} fit={n_fit} match=exact "
                f"max_abs_err={err:.3e} ms={ms:.4f} device_ms={dms} "
                f"plain_ms={plain_ms:.2f} bound_ms={bound_ms:.6f} "
                f"({bound_by}, {nbytes} B, {flops} flop)")
            results.append(dict(
                name="system_fit", dtype=dtype_name, world=tag,
                shape=[int(x) for x in c.cpu_cap.shape], fit=n_fit,
                max_abs_err=err, ms=ms, device_ms=dms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                flops=flops))
    return results


def check_dense_lane(np, lane, chosen, n_places):
    """Every placement made, no node over capacity (with the node's
    effective cpu ask under reserved cores), cores never below zero, the
    distinct_property limit held per value."""
    placed = chosen >= 0
    assert int(placed.sum()) == n_places, (int(placed.sum()), n_places)
    pos, k = np.unique(chosen[placed], return_counts=True)
    c, s, b = lane.const, lane.init, lane.batch
    ask_cpu = np.full(pos.shape, float(b.ask_cpu[0]))
    if c.mhz_per_core.shape[0]:
        ask_cpu = ask_cpu + int(b.ask_cores[0]) * c.mhz_per_core[pos]
        assert bool(np.all(s.cores_free[pos] - k * int(b.ask_cores[0])
                           >= 0)), "cores below zero"
    for cap, used, ask in ((c.cpu_cap, s.used_cpu, ask_cpu),
                           (c.mem_cap, s.used_mem, float(b.ask_mem[0])),
                           (c.disk_cap, s.used_disk, float(b.ask_disk[0]))):
        assert bool(np.all(used[pos] + k * ask <= cap[pos])), "over capacity"
    assert bool(np.all(c.feasible[pos]))
    for d in range(c.dp_vidx.shape[0]):
        vals = c.dp_vidx[d][chosen[placed]]
        assert bool((vals >= 0).all())
        per_value = np.bincount(vals) + 0
        assert int(per_value.max()) <= int(c.dp_limit[d]), per_value


def dense_slice_phase(np, torch, dense, kernels, svc, batch, tp, world):
    """The main path of slice 2: 32 spread lanes (count 2,000) plus the
    distinct_property and reserved-core lanes through fuse_and_solve in
    float32; three fused groups, each a dense_scan launch."""
    t0 = time.perf_counter()
    lanes = slice2_lanes(np, tp, svc, world, "float32", n_spread=N_EVALS)
    pack_ms = (time.perf_counter() - t0) * 1e3
    assert not any(ln.wavefront_ok() for ln in lanes)

    kernels.reset_launches()
    res = batch.fuse_and_solve(lanes, device=DEVICE)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    log(f"dense slice launches: {launches}")
    assert launches["dense_scan"] >= 3, launches

    for lane, (ch, sc, ny) in zip(lanes, res):
        check_dense_lane(np, lane, ch, lane.batch.ask_cpu.shape[0])
        assert bool(np.all(np.isfinite(sc)))
    spread_total = sum(int((r[0] >= 0).sum()) for r in res[:N_EVALS])
    assert spread_total == N_EVALS * N_PLACE, spread_total

    # the same fused inputs through the plain version on the card; the
    # kernel's own numbers at the main path's shape come from the largest
    # group (the 32 spread lanes)
    kernel = None
    clusters = {}
    for g in batch.fuse_lanes(lanes):
        c, s, b = dense.lane_tensors(g.const, g.init, g.batch,
                                     dtype_name=g.dtype_name,
                                     device=torch.device(DEVICE))
        # the range checks' maxima from the host lanes, as the main path
        # takes them: the wrapper then reads nothing back
        imax = dense.index_max(g.const, g.init, g.batch)

        def run(fn, **kw):
            return fn(c, s, b, spread_alg=g.spread_alg, **kw)

        run(dense.dense_scan, imax=imax)
        clusters[f"E={len(g.idxs)} lanes {g.idxs[0]}.."] = C = \
            kernels.DENSE_SCAN.last_cluster()
        assert C > 1, f"dense_scan ran unclustered (C={C})"
        want, plain_ms = time_once(torch, lambda: run(dense.dense_scan_plain))
        for j, li in enumerate(g.idxs):
            P = lanes[li].batch.ask_cpu.shape[0]
            got = tuple(torch.from_numpy(np.asarray(x)).to(DEVICE)
                        for x in res[li])
            compare(torch, f"dense slice lane {li}", got,
                    tuple(w[j, :P] for w in want[:3]), "float32")
        if len(g.idxs) == N_EVALS:
            ms, dms = call_and_device(
                torch, lambda: run(dense.dense_scan, imax=imax))
            bound_ms, bound_by, nbytes, flops = dense_bound(
                torch, c, s, b, want, "float32")
            kernel = dict(
                shape=[int(x) for x in (*c.cpu_cap.shape,
                                        b.ask_cpu.shape[1])],
                cluster=C, ms=ms, device_ms=dms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                flops=flops)
            log(f"kernel dense_scan float32 main path: E={c.cpu_cap.shape[0]}"
                f" N={c.cpu_cap.shape[1]} P={b.ask_cpu.shape[1]} "
                f"ms={ms:.4f} plain_ms={plain_ms:.1f} "
                f"bound_ms={bound_ms:.6f} ({bound_by}, {nbytes} B, "
                f"{flops} flop)")

    log(f"dense slice cluster sizes: {clusters}")
    # warm end-to-end time of the dense dispatch, host clock
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        batch.fuse_and_solve(lanes, device=DEVICE)
        times.append((time.perf_counter() - t1) * 1e3)
    fuse_ms = statistics.median(times)
    # where it goes (medians of 5, host clock with a synchronize after
    # each device part): stacking the lanes, shipping the tables (the
    # fused transport through the resident set: the const buffers are
    # content hits, the rest ship as stacked buffers), the kernels,
    # fetching the results
    parts = {"fuse_lanes": [], "to_device": [], "kernels": [], "fetch": []}
    dev = torch.device(DEVICE)
    for _ in range(5):
        t1 = time.perf_counter()
        groups = batch.fuse_lanes(lanes)
        t2 = time.perf_counter()
        tens = [dense.fused_tensors(
            (g.const, g.init, g.batch), (dense.lane_casts(g.dtype_name),) * 3,
            device=dev, cache_version=g.cache_version,
            delta_src=g.delta_src)[0] for g in groups]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        outs = [dense.dense_scan(*t, spread_alg=False) for t in tens]
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        [[x.cpu().numpy() for x in o[:3]] for o in outs]
        t5 = time.perf_counter()
        for k, v in zip(parts, (t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            parts[k].append(v * 1e3)
    parts = {k: statistics.median(v) for k, v in parts.items()}
    total = sum(int((r[0] >= 0).sum()) for r in res)
    log(f"dense slice: {N_EVALS} spread evals x {N_PLACE} + distinct "
        f"property {DP_PLACE} + cores {CORES_PLACE} placements x {N_NODES}"
        f" nodes: all {total} placed, capacity / cores / distinct_property "
        f"held, equal to the plain version; pack_ms={pack_ms:.1f} "
        f"fuse_and_solve_ms={fuse_ms:.2f} "
        f"placements_per_s={total / (fuse_ms / 1e3):.0f}; breakdown ms: "
        + " ".join(f"{k}={v:.2f}" for k, v in parts.items()))
    return dict(launches=launches, fuse_and_solve_ms=fuse_ms,
                fuse_and_solve_ms_all=times, breakdown_ms=parts,
                pack_ms=pack_ms, placements=total,
                placements_per_s=total / (fuse_ms / 1e3),
                groups=len(batch.fuse_lanes(lanes)), kernel=kernel,
                clusters=clusters)


def system_phase(np, torch, system, kernels, svc, world, seed):
    """One system eval over all 10,000 nodes through solve_system_arrays
    in float32 (the system_fit kernel)."""
    matrix, usage, _ = world
    feas, ports_free = system_world(np, world, seed)
    kw = dict(ask=SYSTEM_ASK, eval_id="system-bench-eval-0000000000000000",
              state_index=STATE_INDEX, static_ports_free=ports_free,
              n_dyn_ports=1, dtype_name="float32", device=DEVICE)
    kernels.reset_launches()
    lane, chosen, scores = svc.solve_system_arrays(matrix, usage, feas, **kw)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    log(f"system launches: {launches}")
    assert launches["system_fit"] >= 1, launches
    n = matrix.n_real
    expect = (feas[:n] & ports_free[:n]
              & (SYSTEM_ASK[0] <= matrix.cpu_cap[:n])
              & (SYSTEM_ASK[1] <= matrix.mem_cap[:n])
              & (SYSTEM_ASK[2] <= matrix.disk_cap[:n]))
    assert bool(np.array_equal(chosen >= 0, expect)), (
        "system fit differs from the expected mask")
    assert bool(np.all(np.isfinite(scores))) and bool(
        np.all((scores >= 0) & (scores <= 1)))
    idx, _ = svc.placements(lane, chosen)
    assert bool(np.array_equal(idx[expect], np.arange(n)[expect]))
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        svc.solve_system_arrays(matrix, usage, feas, **kw)
        times.append((time.perf_counter() - t1) * 1e3)
    ms = statistics.median(times)
    log(f"system eval: {n} nodes, {int(expect.sum())} fit (expected mask "
        f"held), solve_system_arrays_ms={ms:.2f} (median of 5, host clock)")
    return dict(launches=launches, solve_system_arrays_ms=ms,
                solve_system_arrays_ms_all=times, fit=int(expect.sum()))


# --------------------------------------------------------------------------
# slice 3: preemption

PREEMPT_A = 16                      # candidate axis: 15 fillers at most
PREEMPT_PRIOS = (10, 20, 30, 40)    # the fillers' priority tiers
PREEMPT_JOB_PRIO = 70
PREEMPT_ASK = (1000.0, 256.0, 150.0)   # BASELINE tier 5's job, + 1 GPU
PREEMPT_FILL = 0.95
FILLER_CPU, FILLER_MEMS, FILLER_DISK = 500.0, (512.0, 1024.0), 150.0
PW_EVALS, PW_PLACE = 32, 2_000      # the windowed group
PD_EVALS, PD_PLACE = 8, 500         # the dense group (max_parallel 1)
PD_JOB_ALLOCS = 10                  # fillers per job in the dense group
PD_P_PAD = 512                      # _wave_p_bucket(PD_PLACE)
PREEMPT_FEATURES = ("tiers", "maxp", "distinct", "job_level", "affinity",
                    "penalties", "scarce", "devices", "inert", "many")


def pow2_at_least(np, x, floor):
    return int(2 ** np.ceil(np.log2(max(x, floor))))


def tier5_world(np, tp, world, seed, *, job_allocs=1, maxp=0):
    """BASELINE tier 5 over the headline fleet (nomad_tpu/benchkit.py
    run_tier_placements(5) with seed_utilization): every node filled to
    95% of its cpu with 500-MHz allocs (3, 7 or 15 a node) at priorities
    10/20/30/40, 512 or 1024 MB, 150 MB disk, none holding a GPU; every
    other node has 2 or 4 GPUs. Fillers come in jobs of ``job_allocs``
    allocs with migrate.max_parallel ``maxp``. Returns (usage,
    PreemptInfo, DeviceInfo), all in original node order."""
    matrix = world[0]
    n, n_pad = matrix.n_real, matrix.n_pad
    rng = np.random.default_rng(seed)
    A = PREEMPT_A
    k = np.where(matrix.valid,
                 (matrix.cpu_cap * PREEMPT_FILL).astype(np.int64)
                 // int(FILLER_CPU), 0)
    valid = np.arange(A)[None, :] < k[:, None]
    fid = np.cumsum(valid.ravel()).reshape(n_pad, A) - 1
    n_groups = -(-int(valid.sum()) // job_allocs)
    info = tp.PreemptInfo(
        cpu=np.where(valid, FILLER_CPU, 0.0),
        mem=np.where(valid, rng.choice(FILLER_MEMS, (n_pad, A)), 0.0),
        disk=np.where(valid, FILLER_DISK, 0.0),
        prio=np.where(valid, rng.choice(PREEMPT_PRIOS, (n_pad, A)),
                      0).astype(np.int32),
        maxp=np.where(valid, maxp, 0).astype(np.int32),
        grp=np.where(valid, fid // job_allocs, -1).astype(np.int32),
        valid=valid, job_prio=PREEMPT_JOB_PRIO,
        counts=np.zeros(pow2_at_least(np, n_groups, 4), dtype=np.int32))
    zi = np.zeros(n_pad, dtype=np.int32)
    usage = tp.UsageState(info.cpu.sum(axis=1), info.mem.sum(axis=1),
                          info.disk.sum(axis=1), zi, zi, zi)
    i = np.arange(n_pad)
    gpus = np.where((i < n) & (i % 2 == 0), rng.choice([2, 4], n_pad), -1)
    devices = tp.DeviceInfo(affinity=np.zeros((1, 1, n_pad)),
                            count=np.array([1], dtype=np.int32),
                            sum_weight=0.0,
                            free=gpus[None, None].astype(np.int32))
    return usage, info, devices


def tier5_lanes(np, tp, svc, world, dtype_name, *, n_lanes, n_place,
                dense=False, seed=SEED):
    """Tier-5 preemption lanes: the windowed kind (one filler per job), or
    with ``dense`` the max_parallel kind (10-filler jobs, max_parallel 1),
    which the wave gate refuses."""
    matrix, _, feasible = world
    usage, info, devices = tier5_world(
        np, tp, world, seed, job_allocs=PD_JOB_ALLOCS if dense else 1,
        maxp=1 if dense else 0)
    kind = "dense" if dense else "wave"
    return [svc.pack_lane_arrays(
        matrix, usage, feasible, ask=PREEMPT_ASK, count=n_place,
        n_places=n_place,
        eval_id=f"tier5-{kind}-eval-{e:016d}", state_index=STATE_INDEX,
        devices=devices, preemption=info, dtype_name=dtype_name,
        device=DEVICE) for e in range(n_lanes)]


def preempt_fuzz_tables(np, rng, *, n, n_pad, p, dtype, limit, features=(),
                        A=8, G=8, n_active=None):
    """One numpy-seeded preemption lane as five dicts of arrays named as
    the NodeConst / NodeState / PlacementBatch / PreemptTables /
    PreemptState fields (the tests build the reference's tuples from the
    same dicts). Nodes are filled to 70-100% of their cpu by candidates
    of 250-900 MHz; the ask is uniform (1000 MHz, 256 MB, 150 MB), as on
    the windowed path. ``features`` switch on, by name: tiers (priorities
    within 10 of the job's, so ineligible candidates, and invalid ones),
    maxp (max_parallel 1-2 over G shared groups with prior counts),
    distinct (distinct_hosts; job_level for the job-level form),
    affinity, penalties, scarce (a dozen feasible nodes for many
    placements: saturation and zombie shifts), devices (1-3 GPUs on half
    the nodes), inert (no active placement: a padding lane), many
    (candidates of 100-250 MHz, so a node fills up to ~80 columns and
    every bit of a 64-wide candidate axis is used)."""
    f = set(features)
    bad = f - set(PREEMPT_FEATURES)
    if bad:
        raise ValueError(f"unknown features {sorted(bad)}")
    dt = np.dtype(dtype).type
    valid_n = np.arange(n_pad) < n
    cpu_cap = np.where(valid_n, rng.choice([2000.0, 4000.0, 8000.0], n_pad),
                       0).astype(dt)
    mem_cap = np.where(valid_n, rng.choice([4096.0, 8192.0], n_pad),
                       0).astype(dt)
    disk_cap = np.where(valid_n, 20000.0, 0).astype(dt)
    ccpu = np.zeros((n_pad, A))
    cmem = np.zeros((n_pad, A))
    cdisk = np.zeros((n_pad, A))
    budget = cpu_cap * rng.uniform(0.7, 1.0, n_pad)
    used = np.zeros(n_pad)
    sizes = ([100.0, 150.0, 250.0] if "many" in f
             else [250.0, 500.0, 700.0, 900.0])
    for a in range(A):
        c = rng.choice(sizes, n_pad)
        take = valid_n & (used + c <= budget)
        ccpu[:, a] = np.where(take, c, 0.0)
        cmem[:, a] = np.where(take, rng.choice([256.0, 512.0, 1024.0],
                                               n_pad), 0.0)
        cdisk[:, a] = np.where(take, rng.choice([0.0, 150.0], n_pad), 0.0)
        used += ccpu[:, a]
    held = ccpu > 0
    prios = [10, 20, 30, 40, 65, 80] if "tiers" in f else [10, 20, 30, 40]
    prio = np.where(held, rng.choice(prios, (n_pad, A)), 0).astype(np.int32)
    valid = held & ((rng.random((n_pad, A)) > 0.1) if "tiers" in f
                    else True)
    if "maxp" in f:
        maxp = np.where(held & (rng.random((n_pad, A)) < 0.6),
                        rng.integers(1, 3, (n_pad, A)), 0)
        counts = rng.integers(0, 3, G)
    else:
        maxp = np.zeros((n_pad, A))
        counts = np.zeros(G)
    grp = np.where(held, rng.integers(0, G, (n_pad, A)), -1)
    feasible = valid_n & (rng.random(n_pad) > 0.1)
    if "scarce" in f:
        keep = np.zeros(n_pad, dtype=bool)
        keep[rng.choice(n, size=min(12, n), replace=False)] = True
        feasible &= keep
    placed = np.where(rng.random(n_pad) < 0.1, 1, 0).astype(np.int32)
    aff = np.zeros(n_pad, dtype=dt)
    if "affinity" in f:
        m = rng.random(n_pad) < 0.3
        aff[m] = rng.choice([-0.5, 0.25, 0.5], int(m.sum()))
    S = 0
    const = dict(
        cpu_cap=cpu_cap, mem_cap=mem_cap, disk_cap=disk_cap,
        feasible=feasible, affinity=aff,
        has_affinity=np.asarray("affinity" in f),
        distinct_hosts=np.asarray("distinct" in f or "job_level" in f),
        distinct_job_level=np.asarray("job_level" in f),
        spread_vidx=np.zeros((S, n_pad), dtype=np.int32),
        spread_desired=np.zeros((S, 1), dtype=dt),
        spread_has_targets=np.zeros(S, dtype=bool),
        spread_weights=np.zeros(S, dtype=dt),
        spread_sum_weights=np.asarray(0.0, dtype=dt),
        n_spreads=np.asarray(S, dtype=np.int32))
    state = dict(
        used_cpu=(used + np.where(placed > 0, 250.0, 0.0)).astype(dt),
        used_mem=(cmem.sum(axis=1) + np.where(placed > 0, 256.0, 0.0)
                  ).astype(dt),
        used_disk=(cdisk.sum(axis=1) + 150.0 * placed).astype(dt),
        placed=placed, placed_job=(placed + (rng.random(n_pad) < 0.05)
                                   ).astype(np.int32),
        static_free=np.ones(n_pad, dtype=bool),
        dyn_avail=np.full(n_pad, 12001, dtype=np.int32),
        spread_counts=np.zeros((S, 1), dtype=np.int32))
    if "devices" in f:
        free = np.where(valid_n & (rng.random(n_pad) < 0.5),
                        rng.integers(1, 4, n_pad), -1)
        const["dev_aff"] = np.zeros((1, 1, n_pad), dtype=dt)
        const["dev_count"] = np.array([1], dtype=np.int32)
        const["dev_sum_weight"] = np.asarray(0.0, dtype=dt)
        state["dev_free"] = free[None, None].astype(np.int32)
    pen = np.full(p, -1, dtype=np.int32)
    if "penalties" in f:
        hot = rng.random(p) < 0.3
        pen[hot] = rng.integers(0, n, int(hot.sum()))
    n_act = 0 if "inert" in f else (p if n_active is None else n_active)
    batch = dict(
        ask_cpu=np.full(p, PREEMPT_ASK[0], dtype=dt),
        ask_mem=np.full(p, PREEMPT_ASK[1], dtype=dt),
        ask_disk=np.full(p, PREEMPT_ASK[2], dtype=dt),
        n_dyn_ports=np.zeros(p, dtype=np.int32),
        has_static=np.zeros(p, dtype=bool),
        limit=np.full(p, limit, dtype=np.int32),
        count=np.full(p, int(rng.choice([1, 4, max(p, 1)])), dtype=np.int32),
        penalty_idx=pen, active=np.arange(p) < n_act,
        ask_cores=np.zeros(0, dtype=np.int32))
    ptab = dict(
        cpu=ccpu.astype(dt), mem=cmem.astype(dt), disk=cdisk.astype(dt),
        prio=prio, maxp=maxp.astype(np.int32), grp=grp.astype(np.int32),
        dyn_ports=np.zeros((n_pad, A), dtype=np.int32),
        static_rel=np.zeros((n_pad, A), dtype=bool), valid=valid,
        job_prio=np.asarray(PREEMPT_JOB_PRIO, dtype=np.int32))
    pstate = dict(evicted=np.zeros((n_pad, A), dtype=bool),
                  counts=counts.astype(np.int32))
    return const, state, batch, ptab, pstate


# Floating-point operations of the preemption kernels, counted from
# csrc/wave_preempt.cu and csrc/preempt_common.cuh as above (each add,
# sub, mul, div, min/max, compare, sqrt and exp one, an fma two):
#   per slot and step of the windowed kernel: usage now 3 x (mul, add,
#     sub, add) 12, distinct count 1, device countdown 2, feasibility 2,
#     fit 3, coll 1, anti 5, nscores 5, other 2, the two max(cap) 2,
#     free cpu/mem 4, binpack_raw 6, final (fma, div) 3, low 1,
#     arg-best 1                                                 -> 48
#   per (node, candidate) and round of the eviction search: the
#     distance's three components (compare, sub, max, div) 12, dm*dm 1,
#     two fma 4, sqrt 1, the penalty add 1, the argmin compare 1, the
#     node's available sums 3                                    -> 23
# The count takes, per placement that evicts, one search round over the
# chosen node's A candidates (the least any search that finds the
# eviction set needs), plus the windowed kernel's B slot heads per step
# that places, or the dense kernel's fit check and score per yielded
# node (DENSE_FIT_OPS, DENSE_SCORE_OPS); the rest depends on the data and
# is left out, so the bound stays a lower one.
WAVE_PREEMPT_SLOT_OPS, PREEMPT_CAND_OPS = 48, 23


def tree_dicts(np, trees):
    return [{f: np.asarray(getattr(t, f)) for f in type(t)._fields}
            for t in trees]


def pad_counts(np, counts, G):
    out = np.zeros(G, dtype=np.int32)
    out[:counts.shape[0]] = counts
    return out


def stack_preempt(np, bp, lanes):
    """Five stacked (E, ...) trees from lanes given as five dicts each,
    the group counts padded to the widest G."""
    G = max(d[4]["counts"].shape[0] for d in lanes)
    for d in lanes:
        d[4]["counts"] = pad_counts(np, d[4]["counts"], G)
    classes = (bp.NodeConst, bp.NodeState, bp.PlacementBatch,
               bp.PreemptTables, bp.PreemptState)
    return tuple(
        cls(**{f: np.stack([np.asarray(d[k].get(f, cls._field_defaults.get(
            f))) for d in lanes]) for f in cls._fields})
        for k, cls in enumerate(classes))


def packed_preempt_dicts(np, lane, p_pad):
    const, init, batch = lane_dicts(np, lane, p_pad)
    ptab, pinit = tree_dicts(np, (lane.ptab, lane.pinit))
    return [const, init, batch, ptab, pinit]


def preempt_group(np, bp, tp, svc, world, dtype_name, seed, *, dense):
    """The kernel phase's fused group: 16 packed tier-5 lanes (the
    windowed kind at 2,000 placements, P_pad 2,048, or with ``dense``
    the max_parallel kind at 500, P_pad 512) and 16 numpy-seeded fuzz
    lanes over the same node axis (N = 16,384, A = 16): priority tiers
    with ineligible candidates, max_parallel with shared groups,
    distinct_hosts, affinity, reschedule penalties, saturation (a dozen
    feasible nodes), and inert lanes. Every lane asks for one GPU (the
    dense kernel's device tables must agree in shape). Returns the five
    stacked trees."""
    matrix = world[0]
    P = PD_P_PAD if dense else P_PAD
    packed = tier5_lanes(np, tp, svc, world, dtype_name,
                         n_lanes=N_EVALS // 2,
                         n_place=PD_PLACE if dense else PW_PLACE,
                         dense=dense)
    lanes = [packed_preempt_dicts(np, ln, P) for ln in packed]
    rng = np.random.default_rng(seed)
    sets = (("tiers", "penalties"), ("maxp", "tiers"),
            ("distinct", "affinity"), ("job_level", "penalties"),
            ("scarce",), ("tiers", "maxp", "affinity", "penalties"),
            ("scarce", "distinct"), ("inert",))
    k = 0
    while len(lanes) < N_EVALS:
        feats = sets[k % len(sets)] + ("devices",)
        lanes.append(list(preempt_fuzz_tables(
            np, rng, n=matrix.n_real, n_pad=matrix.n_pad, p=P,
            dtype=dtype_name, limit=int(rng.choice([3, 5, 14, 20])),
            features=feats, A=PREEMPT_A, G=64,
            n_active=int(rng.integers(P // 4, P)))))
        k += 1
    return stack_preempt(np, bp, lanes)


def compare_preempt(torch, name, got, want, dtype_name):
    """compare() on the decisions and scores, plus the eviction rows
    exactly."""
    err = compare(torch, name, got[:3], want[:3], dtype_name)
    if not torch.equal(got[3], want[3]):
        bad = (got[3] != want[3]).any(dim=-1).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: evict rows differ at {bad}")
    return err


def same_bits(torch, name, got, want):
    """Raise unless two tensors hold the same bits."""
    if got.dtype.is_floating_point:
        bits = {2: torch.int16, 4: torch.int32,
                8: torch.int64}[got.element_size()]
        got, want = got.view(bits), want.view(bits)
    if not torch.equal(got, want):
        bad = (got != want).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: differs at {bad}")


def wave_preempt_final_counts(torch, preempt, ten, out):
    """The (E, G) group counts after the last step that a windowed run's
    eviction rows imply: counts0 plus one for each evicted candidate's
    group (the commit's bumps). A chosen node's compact row is the one
    holding its position (unique among a lane's option rows)."""
    compact, cand, counts0 = ten[0], ten[1], ten[5]
    counts = counts0.long().clone()
    e_i, i_i = out[3].any(dim=-1).nonzero(as_tuple=True)
    pos = compact[e_i, :, preempt.WPC_POS]
    r = (pos == out[0][e_i, i_i].to(pos.dtype)[:, None]).int().argmax(dim=1)
    grp = cand["grp"][e_i, r].long()
    take = out[3][e_i, i_i] & (grp >= 0)
    lane = e_i[:, None].expand_as(grp)
    counts.index_put_((lane[take], grp[take]),
                      torch.ones_like(grp[take]), accumulate=True)
    return counts.to(torch.int32)


def check_wave_preempt(torch, preempt, name, ten, B, want):
    """One more launch of the windowed kernel on ``ten``: every output
    equal to the plain version's ``want`` bit for bit, and its group
    counts after the last step equal to those the eviction rows imply."""
    got = preempt.wave_preempt_launch(*ten, spread_alg=False, B=B)
    for f, g, w in zip(("chosen", "scores", "n_yielded", "evict_rows"),
                       got, want):
        same_bits(torch, f"{name} {f}", g, w)
    same_bits(torch, f"{name} counts", got[4],
              wave_preempt_final_counts(torch, preempt, ten, want))


def rows_nbytes(tables, n, rows):
    """Bytes of ``tables`` (each with a leading lane axis) when ``rows``
    node rows in all are read: a table with an axis of size ``n`` after
    the lane axis counts rows / (lanes * n) of its bytes, any other table
    all of them."""
    total = 0
    for t in tables:
        shape = tuple(t.shape)
        if len(shape) >= 2 and n in shape[1:]:
            total += t.nbytes // (shape[0] * n) * rows
        else:
            total += t.nbytes
    return total


def distinct_groups(np, lane, grp, G):
    """How many distinct (lane, group) pairs the arrays name (grp >= 0)."""
    keep = grp >= 0
    return int(np.unique(lane[keep].astype(np.int64) * G
                         + grp[keep].astype(np.int64)).size)


def wave_preempt_bound(np, preempt, inp, out, dtype_name):
    """(bound_ms, bound_by, bytes, flops) of one windowed-preemption
    launch, counting what this run's data makes the function touch. The
    window takes compact rows in order (the first B, then one per zombie
    shift), so a lane reads every row up to that of the last node it
    chose, and at least B; of each such row its compact entry and (A,)
    candidates, and the group counts of its max_parallel candidates
    (the penalty reads no count where maxp is 0). Plus the (E,) scalars
    and (E, P) penalties read, the outputs written once; the operations
    this run's data needs (see WAVE_PREEMPT_SLOT_OPS). Rows entered by
    zombies never chosen are left out, so the bound stays a lower one."""
    chosen = out[0].cpu().numpy()
    E, C, _ = inp.compact.shape
    pos = inp.compact[..., preempt.WPC_POS]
    reach = np.full(E, inp.B, dtype=np.int64)
    for e in range(E):
        ch = chosen[e][chosen[e] >= 0]
        if ch.size:
            k = int((pos[e] >= 0).sum())   # option rows, ascending pos
            reach[e] = max(inp.B, int(np.searchsorted(pos[e, :k],
                                                      ch.max())) + 1)
    grp, maxp = inp.cand["grp"], inp.cand["maxp"]
    sel = ((np.arange(C)[None, :] < reach[:, None])[..., None]
           & (maxp > 0))
    lane = np.broadcast_to(np.arange(E)[:, None, None], grp.shape)
    n_groups = distinct_groups(np, lane[sel], grp[sel],
                               inp.counts0.shape[1])
    nbytes = (rows_nbytes((inp.compact, *inp.cand.values()), C,
                          int(reach.sum()))
              + inp.scal_f.nbytes + inp.scal_i.nbytes + inp.pen.nbytes
              + 4 * n_groups + sum(t.nbytes for t in out))
    rows = out[3]
    A = rows.shape[-1]
    flops = (int((out[0] >= 0).sum()) * inp.B * WAVE_PREEMPT_SLOT_OPS
             + int(rows.any(dim=-1).sum()) * A * PREEMPT_CAND_OPS)
    return bound("wave_preempt", nbytes, flops, dtype_name) + (nbytes, flops)


def dense_preempt_bound(np, trees, out, dtype_name):
    """(bound_ms, bound_by, bytes, flops) of one dense preemption launch,
    counting what this run's data makes the function touch. Each step's
    window walk starts at node 0 and must look at every node before the
    limit-th option, so a lane reads its node rows up to the last node it
    chose (and at least as many as a window held), and all N where a
    step yielded fewer than its limit; the candidate rows (and evicted
    entries) of the nodes it evicted on, and the group counts of their
    max_parallel candidates. Plus the
    placement batch read; the outputs, the state rows of the nodes
    chosen, the evicted entries set and the group counts bumped written
    once; the operations this run's data needs. Nodes searched but never
    chosen are left out, so the bound stays a lower one."""
    const, init, batch, ptab, pinit = trees
    E, N = const.cpu_cap.shape
    G = pinit.counts.shape[1]
    chosen = out.chosen.cpu().numpy()
    rows = out.evict_rows.cpu().numpy()
    short = (out.n_yielded < batch.limit.long()).any(dim=1).cpu().numpy()
    held = out.n_yielded.max(dim=1).values.cpu().numpy()
    reach = np.where(short, N, np.maximum(chosen.max(axis=1) + 1, held))
    lane = np.broadcast_to(np.arange(E)[:, None], chosen.shape)
    placed = chosen >= 0
    won = np.unique(lane[placed] * N + chosen[placed])
    ev = rows.any(axis=-1)
    ev_nodes = np.unique(lane[ev] * N + chosen[ev])
    grp = ptab.grp.cpu().numpy()
    maxp = ptab.maxp.cpu().numpy()
    we, wn = ev_nodes // N, ev_nodes % N
    sel = maxp[we, wn] > 0
    read_groups = distinct_groups(
        np, np.broadcast_to(we[:, None], sel.shape)[sel],
        grp[we, wn][sel], G)
    e_i, i_i, a_i = np.nonzero(rows)
    bumped = distinct_groups(np, e_i, grp[e_i, chosen[e_i, i_i], a_i], G)
    nbytes = (rows_nbytes((*const, *init), N, int(reach.sum()))
              + tree_nbytes((batch,))
              + rows_nbytes((*ptab, pinit.evicted), N, ev_nodes.size)
              + 4 * read_groups
              + sum(t.nbytes for t in out[:4])
              + rows_nbytes(out.state, N, won.size)
              + int(rows.sum()) + 4 * bumped)
    A = out.evict_rows.shape[-1]
    flops = (int(out.n_yielded.sum()) * (DENSE_FIT_OPS + DENSE_SCORE_OPS)
             + int(ev.sum()) * A * PREEMPT_CAND_OPS)
    return bound("dense_preempt", nbytes, flops, dtype_name) + (nbytes,
                                                                flops)


def preempt_kernel_phase(np, torch, bp, preempt, dense, kernels, svc, tp,
                         world, seed):
    """dense_preempt in float32 on one fused E = 32 group at N = 16,384,
    P_pad = 512, A = 16 (preempt_group; the plain version rescores
    16,384 nodes a step): decisions, eviction rows and the final state
    exactly; timed. The windowed kernel's E = 32 group at the main
    path's shape is held in the preemption slice. Then
    preempt_small_checks (the windowed kernel's scores and group counts
    as bits too). float64: preempt_small_checks at up to 8 lanes, and,
    untimed, 8 windowed tier-5 lanes of 500 placements."""
    results = []
    dev = torch.device(DEVICE)
    for dtype_name in ("float32", "float64"):
        if dtype_name == "float64":
            # float64: the small worlds (each plain step searches every
            # candidate of every node of every lane on the host side of
            # the comparison), the 32-lane groups are float32's
            results += preempt_small_checks(np, torch, bp, preempt, dense,
                                            kernels, dtype_name, seed + 2,
                                            max_lanes=8)
            continue
        # the windowed kernel's E = 32 group at the main path's shape is
        # the preemption slice's own (the kernels line's row 5)
        trees = preempt_group(np, bp, tp, svc, world, dtype_name, seed + 1,
                              dense=True)
        (c, s, b, pt, ps), _ = dense.fused_tensors(
            trees, preempt.preempt_casts(dtype_name), device=dev)

        def run_d(fn):
            return fn(c, s, b, pt, ps, spread_alg=False)

        got, _ = time_once(torch, lambda: run_d(preempt.dense_preempt))
        C = kernels.DENSE_PREEMPT.last_cluster()
        want, plain_ms = time_once(torch,
                                   lambda: run_d(preempt.dense_preempt_plain))
        tag = f"dense_preempt {dtype_name}"
        err = compare_preempt(torch, tag, got, want, dtype_name)
        for f, g, w in zip(type(got.state)._fields + ("evicted", "counts"),
                           tuple(got.state) + tuple(got.pstate),
                           tuple(want.state) + tuple(want.pstate)):
            if not torch.equal(g, w):
                raise AssertionError(f"{tag}: final state {f} differs")
        ms = timed(torch, lambda: run_d(preempt.dense_preempt),
                   KERNEL_REPEATS)
        bound_ms, bound_by, nbytes, flops = dense_preempt_bound(
            np, (c, s, b, pt, ps), want, dtype_name)
        placed = int((want.chosen >= 0).sum())
        evicting = int(want.evict_rows.any(dim=-1).sum())
        log(f"kernel {tag}: E={c.cpu_cap.shape[0]} N={c.cpu_cap.shape[1]} "
            f"P={b.ask_cpu.shape[1]} A={PREEMPT_A} C={C} placed={placed} "
            f"evicting={evicting} match=exact max_abs_err={err:.3e} "
            f"ms={ms:.4f} plain_ms={plain_ms:.1f} bound_ms={bound_ms:.6f} "
            f"({bound_by}, {nbytes} B, {flops} flop)")
        results.append(dict(
            name="dense_preempt", dtype=dtype_name,
            shape=[int(x) for x in (*c.cpu_cap.shape, b.ask_cpu.shape[1],
                                    PREEMPT_A)],
            cluster=C, placed=placed, evicting=evicting, max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            bytes=nbytes, flops=flops))
        results += preempt_small_checks(np, torch, bp, preempt, dense,
                                        kernels, dtype_name, seed + 2)
    # windowed tier-5 lanes in float64 (the slice holds its group in
    # float32): 8 lanes of 500 placements at P_pad 512, to keep the plain
    # version's steps down
    packed = tier5_lanes(np, tp, svc, world, "float64", n_lanes=8,
                         n_place=PD_PLACE)
    inp = preempt.wave_preempt_inputs(
        *stack_preempt(np, bp, [packed_preempt_dicts(np, ln, PD_P_PAD)
                                for ln in packed]), dtype_name="float64")
    ten = preempt.wave_preempt_tensors(inp, dev)
    want = preempt.wave_preempt_plain(*ten, spread_alg=False, B=inp.B)
    tag = "wave_preempt float64 tier-5 lanes"
    check_wave_preempt(torch, preempt, tag, ten, inp.B, want)
    log(f"kernel {tag}: E=8 C={inp.compact.shape[1]} B={inp.B} "
        f"placed={int((want[0] >= 0).sum())} match=bit-exact")
    results.append(dict(name="wave_preempt", dtype="float64",
                        world="tier-5 lanes", max_abs_err=0.0))
    return results


def wave_preempt_small_lanes(np, rng, dtype_name):
    """The windowed kernel's wide-buffer and wide-candidate worlds, 8
    fuzz lanes each: B = 128 (the limit-100 window of affinity lanes,
    N = 4,096, P = 128) and A = 64 (N = 1,024, P = 64, limit 14)."""
    sets = (("affinity",), ("tiers", "affinity", "penalties"),
            ("distinct", "affinity"), ("scarce", "affinity"))
    wide = [list(preempt_fuzz_tables(
        np, rng, n=4000, n_pad=4096, p=128, dtype=dtype_name, limit=100,
        features=sets[k % len(sets)] + ("devices",), A=PREEMPT_A, G=64))
        for k in range(8)]
    many = [list(preempt_fuzz_tables(
        np, rng, n=1000, n_pad=1024, p=64, dtype=dtype_name, limit=14,
        features=("many", "tiers", "penalties") + sets[k % len(sets)][:1],
        A=64, G=64)) for k in range(8)]
    return (("B=128", wide), ("A=64", many))


def preempt_small_checks(np, torch, bp, preempt, dense, kernels,
                         dtype_name, seed, max_lanes=None):
    """Untimed: the windowed kernel at its wide buffer (B = 128, the
    limit-100 window of an affinity lane), both kernels at the widest
    candidate axis they take (A = 64, N = 1,024), and the dense one at
    every lane count of CLUSTER_LANES (up to ``max_lanes`` when given;
    every cluster size the launcher picks) at the small node buckets
    (N = 256 and, up to 32 lanes and at the most lanes, 1,024: one
    block over 1,024 nodes where C is 1 or 2) and, with 8 lanes, a mid-size
    one (N = 4,096), limits 3 to 2,000 (above the node count), held
    against their plain versions."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    results = []
    for world, lanes in wave_preempt_small_lanes(np, rng, dtype_name):
        inp = preempt.wave_preempt_inputs(*stack_preempt(np, bp, lanes),
                                          dtype_name=dtype_name)
        assert inp.B == (128 if world == "B=128" else 32), inp.B
        ten = preempt.wave_preempt_tensors(inp, dev)
        got = preempt.wave_preempt(*ten, spread_alg=False, B=inp.B)
        want = preempt.wave_preempt_plain(*ten, spread_alg=False, B=inp.B)
        tag = f"wave_preempt {dtype_name} {world}"
        err = compare_preempt(torch, tag, got, want, dtype_name)
        check_wave_preempt(torch, preempt, tag, ten, inp.B, want)
        log(f"kernel {tag}: E=8 P={want[0].shape[1]} "
            f"placed={int((want[0] >= 0).sum())} match=exact "
            f"max_abs_err={err:.3e}")
        results.append(dict(name="wave_preempt", dtype=dtype_name,
                            world=f"fuzz {world}", max_abs_err=err))
    cases = [(E, n, n_pad, A, 64) for E in CLUSTER_LANES
             if max_lanes is None or E <= max_lanes
             for n, n_pad, A in (
                 ((200, 256, PREEMPT_A), (1000, 1024, PREEMPT_A),
                  (4000, 4096, PREEMPT_A), (1000, 1024, 64)) if E == 8
                 else ((200, 256, PREEMPT_A), (1000, 1024, PREEMPT_A),
                       (1000, 1024, 64)) if E == 32
                 else ((200, 256, PREEMPT_A),) if 32 < E < max(CLUSTER_LANES)
                 else ((200, 256, PREEMPT_A), (1000, 1024, PREEMPT_A)))]
    # group counts too large for a block's shared memory: one block a
    # lane (C = 1) owns them in global memory
    cases.append((8, 200, 256, PREEMPT_A, 1 << 16))
    for E, n, n_pad, A, G in cases:
        many = ("many",) if A == 64 else ()
        lanes = [list(preempt_fuzz_tables(
            np, rng, n=n, n_pad=n_pad, p=32 if E <= 8 else 16,
            dtype=dtype_name, limit=int(rng.choice([3, 5, 14, 2000])),
            features=(("tiers", "maxp", "penalties", "distinct", "scarce",
                       "affinity", "job_level", "inert")[k % 8],)
            + ("devices",) + many, A=A, G=G)) for k in range(E)]
        trees = stack_preempt(np, bp, lanes)
        args, _ = dense.fused_tensors(
            trees, preempt.preempt_casts(dtype_name), device=dev)
        got = preempt.dense_preempt(*args, spread_alg=False)
        C = kernels.DENSE_PREEMPT.last_cluster()
        want = preempt.dense_preempt_plain(*args, spread_alg=False)
        tag = f"dense_preempt {dtype_name} E={E} N={n_pad} A={A} G={G}"
        err = compare_preempt(torch, tag, got, want, dtype_name)
        for f, g, w in zip(type(got.state)._fields + ("evicted", "counts"),
                           tuple(got.state) + tuple(got.pstate),
                           tuple(want.state) + tuple(want.pstate)):
            if not torch.equal(g, w):
                raise AssertionError(f"{tag}: final state {f} differs")
        log(f"kernel {tag}: C={C} P={args[2].ask_cpu.shape[1]} "
            f"placed={int((want.chosen >= 0).sum())} match=exact "
            f"max_abs_err={err:.3e}")
        results.append(dict(name="dense_preempt", dtype=dtype_name,
                            world=f"fuzz E={E} N={n_pad} A={A} G={G}",
                            cluster=C, max_abs_err=err))
    return results


def check_preempt_lane(np, lane, chosen, rows, n_places):
    """Every placement made, on a node with a free GPU; after its
    evictions no node over capacity; no candidate evicted twice; every
    evicted candidate at least 10 priority levels below the job."""
    placed = chosen >= 0
    assert int(placed.sum()) == n_places, (int(placed.sum()), n_places)
    c, s, b, pt = lane.const, lane.init, lane.batch, lane.ptab
    N, A = pt.cpu.shape
    hits = np.zeros((N, A), dtype=np.int64)
    np.add.at(hits, chosen[placed], rows[placed].astype(np.int64))
    assert int(hits.max(initial=0)) <= 1, "a candidate evicted twice"
    ev = hits > 0
    assert bool(np.all(pt.valid[ev])) and bool(
        np.all(pt.prio[ev] <= int(pt.job_prio) - 10)), "evicted too high"
    k = np.bincount(chosen[placed], minlength=N)
    for cap, used, cand, ask in (
            (c.cpu_cap, s.used_cpu, pt.cpu, float(b.ask_cpu[0])),
            (c.mem_cap, s.used_mem, pt.mem, float(b.ask_mem[0])),
            (c.disk_cap, s.used_disk, pt.disk, float(b.ask_disk[0]))):
        after = used + k * ask - np.where(ev, cand, 0.0).sum(axis=1)
        assert bool(np.all(after[k > 0] <= cap[k > 0])), "over capacity"
    gpus = s.dev_free[0].max(axis=0)
    assert bool(np.all(k <= np.maximum(gpus, 0))), "a GPU oversubscribed"
    assert bool(np.all(c.feasible[k > 0]))


def preempt_slice_phase(np, torch, preempt, dense, kernels, svc, batch, tp,
                        world):
    """The main path of slice 3 at full width: the tier-5 world (10,000
    nodes at 95% cpu from priority 10-40 fillers, every other node with 2
    or 4 GPUs), 32 windowed evals x 2,000 placements of a priority-70,
    1,000-MHz, one-GPU job plus 8 evals x 500 over fillers in
    max_parallel-1 jobs (the dense preemption kernel), through
    fuse_and_solve in float32."""
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    wl = tier5_lanes(np, tp, svc, world, "float32", n_lanes=PW_EVALS,
                     n_place=PW_PLACE)
    dl = tier5_lanes(np, tp, svc, world, "float32", n_lanes=PD_EVALS,
                     n_place=PD_PLACE, dense=True)
    pack_ms = (time.perf_counter() - t0) * 1e3
    lanes = wl + dl
    assert all(ln.wavefront_ok() for ln in wl), "windowed gate refused"
    assert not any(ln.wavefront_ok() for ln in dl), "dense gate passed"

    kernels.reset_launches()
    res = batch.fuse_and_solve(lanes, device=DEVICE)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    log(f"preempt slice launches: {launches}")
    assert launches["wave_preempt"] >= 1, launches
    assert launches["dense_preempt"] >= 1, launches

    for lane, (ch, sc, ny, rows) in zip(lanes, res):
        check_preempt_lane(np, lane, ch, rows, lane.batch.ask_cpu.shape[0])
        assert bool(np.all(np.isfinite(sc)))
    total = sum(int((r[0] >= 0).sum()) for r in res)
    assert total == PW_EVALS * PW_PLACE + PD_EVALS * PD_PLACE, total
    evicting = sum(int(r[3].any(axis=1).sum()) for r in res)

    # the same fused inputs through the plain versions on the card, and
    # each kernel's own numbers at the main path's shape
    kern = {}
    for g in batch.fuse_lanes(lanes):
        if g.wave:
            inp = preempt.wave_preempt_inputs(g.const, g.init, g.batch,
                                              g.ptab, g.pinit,
                                              dtype_name="float32")
            ten = preempt.wave_preempt_tensors(inp, dev)
            kw = dict(grp_max=dense._max_of(inp.cand["grp"]))

            def run(fn, **kw):
                return fn(*ten, spread_alg=False, B=inp.B, **kw)

            kfn, pfn, name = (preempt.wave_preempt,
                              preempt.wave_preempt_plain, "wave_preempt")
        else:
            ten, _ = dense.fused_tensors(
                (g.const, g.init, g.batch, g.ptab, g.pinit),
                preempt.preempt_casts("float32"), device=dev,
                cache_version=g.cache_version, delta_src=g.delta_src)

            kw = dict(imax=dense.index_max(g.const, g.init, g.batch,
                                           g.ptab))

            def run(fn, **kw):
                return fn(*ten, spread_alg=False, **kw)

            kfn, pfn, name = (preempt.dense_preempt,
                              preempt.dense_preempt_plain, "dense_preempt")
        want, plain_ms = time_once(torch, lambda: run(pfn))
        for j, li in enumerate(g.idxs):
            P = lanes[li].batch.ask_cpu.shape[0]
            got = tuple(torch.from_numpy(np.asarray(x)).to(DEVICE)
                        for x in res[li])
            compare_preempt(torch, f"preempt slice lane {li}", got,
                            tuple(w[j, :P] for w in want[:4]), "float32")
        ms, dms = call_and_device(torch, lambda: run(kfn, **kw))
        C = None
        if g.wave:
            check_wave_preempt(torch, preempt, "preempt slice windowed "
                               "group", ten, inp.B, want)
            bnd = wave_preempt_bound(np, preempt, inp, want, "float32")
            shape = list(inp.compact.shape) + [PREEMPT_A]
        else:
            bnd = dense_preempt_bound(np, ten, want, "float32")
            shape = [int(x) for x in (*ten[0].cpu_cap.shape,
                                      ten[2].ask_cpu.shape[1], PREEMPT_A)]
            C = kernels.DENSE_PREEMPT.last_cluster()
            log(f"preempt slice dense group: cluster size C={C}")
            assert C > 1, f"dense_preempt ran unclustered (C={C})"
        kern[name] = dict(shape=shape, cluster=C, ms=ms, device_ms=dms,
                          plain_ms=plain_ms, bound_ms=bnd[0],
                          bound_by=bnd[1], bytes=bnd[2], flops=bnd[3])
        log(f"kernel {name} float32 main path: shape={shape} ms={ms:.4f} "
            f"plain_ms={plain_ms:.1f} bound_ms={bnd[0]:.6f} ({bnd[1]}, "
            f"{bnd[2]} B, {bnd[3]} flop)")

    # warm end-to-end time of the preemption dispatch, host clock
    times = []
    for _ in range(3):
        t1 = time.perf_counter()
        batch.fuse_and_solve(lanes, device=DEVICE)
        times.append((time.perf_counter() - t1) * 1e3)
    fuse_ms = statistics.median(times)
    # where it goes (medians of 3, host clock with a synchronize after
    # each device part): stacking the lanes, the windowed group's host
    # precompute, shipping the tables, the kernels, fetching the results
    parts = {"fuse_lanes": [], "wave_preempt_inputs": [], "to_device": [],
             "kernels": [], "fetch": []}
    for _ in range(3):
        t1 = time.perf_counter()
        groups = batch.fuse_lanes(lanes)
        t2 = time.perf_counter()
        inps = [preempt.wave_preempt_inputs(g.const, g.init, g.batch,
                                            g.ptab, g.pinit,
                                            dtype_name="float32")
                if g.wave else None for g in groups]
        t3 = time.perf_counter()
        tens = [preempt.wave_preempt_tensors(
                    inp, dev, cache_version=g.cache_version,
                    delta_src=g.delta_src) if g.wave else
                dense.fused_tensors(
                    (g.const, g.init, g.batch, g.ptab, g.pinit),
                    preempt.preempt_casts("float32"), device=dev,
                    cache_version=g.cache_version, delta_src=g.delta_src)[0]
                for g, inp in zip(groups, inps)]
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        outs = [preempt.wave_preempt(*t, spread_alg=False, B=inp.B)
                if g.wave else preempt.dense_preempt(*t, spread_alg=False)
                for g, t, inp in zip(groups, tens, inps)]
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        [[x.cpu().numpy() for x in o[:4]] for o in outs]
        t6 = time.perf_counter()
        for k, v in zip(parts, (t2 - t1, t3 - t2, t4 - t3, t5 - t4,
                                t6 - t5)):
            parts[k].append(v * 1e3)
    parts = {k: statistics.median(v) for k, v in parts.items()}
    log(f"preempt slice: {PW_EVALS} windowed evals x {PW_PLACE} + "
        f"{PD_EVALS} dense evals x {PD_PLACE} placements x {N_NODES} nodes:"
        f" all {total} placed ({evicting} with evictions), capacity / "
        f"single eviction / priority floor / GPUs held, equal to the plain "
        f"versions; pack_ms={pack_ms:.1f} fuse_and_solve_ms={fuse_ms:.2f} "
        f"placements_per_s={total / (fuse_ms / 1e3):.0f}; breakdown ms: "
        + " ".join(f"{k}={v:.2f}" for k, v in parts.items()))
    return dict(launches=launches, fuse_and_solve_ms=fuse_ms,
                fuse_and_solve_ms_all=times, breakdown_ms=parts,
                pack_ms=pack_ms, placements=total, evicting=evicting,
                placements_per_s=total / (fuse_ms / 1e3), kernels=kern)


# --------------------------------------------------------------------------
# slice 4: the whole-queue LP tier

LP_STEPS = 48                       # lpq_steps()'s default
LP_LS, LP_NS = (8, 128, 256), (256, 16_384, 65_536)
LP_TIMED = (128, 16_384)            # the main path's L_pad and N
LPQ_EVALS, LPQ_PLACE = 128, 8       # bench.py time_lpq's headline batch
# Floating-point operations the relaxation needs, counted from
# lp_relax_plain (csrc/lp_relax.cu does the same ones, some twice): each
# add, sub, mul, div, max, compare and exp one, an fma two.
#   per (lane, node) and step: price (mul, 2 fma) 5, V - price 1,
#     / temp 1, row max 1, - max 1, exp 1, row sum 1, / sum 1,
#     * pcount 1, load (3 fma) 6                                 -> 19
#   per node and step: mu's three (load - free, * 0.5, max(free, 1),
#     /, +, max 0) 18
#   per (lane, node) in the final pass: price 5, V - price 1, * 50 1,
#     max 1, - max 1, exp 1, sum 1, / sum 1                     -> 12
LP_CELL_OPS, LP_NODE_OPS, LP_FINAL_OPS = 19, 18, 12


def lp_fuzz_inputs(np, rng, L, N, *, over):
    """Seeded relaxation inputs (V, feas, ask, pcount, free, active),
    numpy, float32: the last two lanes inactive padding, lane 1 with no
    feasible node, about a quarter of the nodes with no free cpu, and
    with ``over`` a queue asking for more than the fleet holds, so the
    prices rise."""
    f32 = np.float32
    nl = L - 2
    feas = np.zeros((L, N), dtype=bool)
    feas[:nl] = rng.random((nl, N)) < 0.6
    feas[1] = False
    V = np.full((L, N), -1e9, dtype=f32)
    V[:nl] = np.where(feas[:nl], rng.uniform(-0.5, 1.0, (nl, N)), -1e9)
    ask = np.zeros((L, 3), dtype=f32)
    ask[:nl] = rng.choice([250.0, 500.0, 1000.0], (nl, 3))
    pcount = np.zeros(L, dtype=f32)
    pcount[:nl] = rng.integers(1, 60 if over else 4, nl)
    active = np.zeros(L, dtype=bool)
    active[:nl] = True
    scale = 0.05 if over else 1.0
    free = np.stack([rng.choice([0.0, 900.0, 2000.0, 4000.0], N) * scale,
                     rng.choice([0.0, 1000.0, 4096.0], N) * scale,
                     rng.choice([0.0, 5000.0], N)], axis=1).astype(f32)
    return V, feas, ask, pcount, free, active


def lp_bound(L, N, steps):
    """(bound_ms, bound_by, bytes, flops) of one relaxation: every input
    read once, X and mu written once; the operations above."""
    nbytes = (L * N * (4 + 1) + L * (12 + 4 + 1) + N * 12 + steps * 4
              + L * N * 4 + N * 12)
    flops = (steps * (L * N * LP_CELL_OPS + N * LP_NODE_OPS)
             + L * N * LP_FINAL_OPS)
    return bound("lp_relax", nbytes, flops, "float32") + (nbytes, flops)


def compare_lp(torch, name, got, want):
    """X and mu bit for bit."""
    for tag, g, w in zip(("X", "mu"), got, want):
        gi, wi = g.view(torch.int32), w.view(torch.int32)
        if not torch.equal(gi, wi):
            bad = (gi != wi).nonzero()[:5].tolist()
            raise AssertionError(f"{name}: {tag} differs at {bad}")
    return 0.0


def lp_kernel_phase(np, torch, lpq, seed):
    """lp_relax against lp_relax_plain on the card, X and mu bit for bit,
    at L_pad in {8, 128, 256} x N in {256, 16,384, 65,536}, 48 steps, on
    seeded fuzz, oversubscribed at every other shape (so at every L_pad
    and every N); the kernel timed at the main path's L_pad = 128,
    N = 16,384."""
    results = []
    temps = torch.from_numpy(lpq.lp_temperatures(LP_STEPS)).to(DEVICE)
    for i, (L, N) in enumerate((L, N) for L in LP_LS for N in LP_NS):
        over = bool(i % 2)
        rng = np.random.default_rng(seed + 40 + i)
        ins = [torch.from_numpy(a).to(DEVICE)
               for a in lp_fuzz_inputs(np, rng, L, N, over=over)]
        ins.append(temps)
        got, _ = time_once(torch, lambda: lpq.lp_relax(*ins))
        want, plain_ms = time_once(torch, lambda: lpq.lp_relax_plain(*ins))
        tag = f"lp_relax L={L} N={N} over={over}"
        err = compare_lp(torch, tag, got, want)
        row = dict(name="lp_relax", dtype="float32", shape=[L, N],
                   over=over, max_abs_err=err, plain_ms=plain_ms,
                   mu_max=float(want[1].max()))
        if (L, N) == LP_TIMED:
            row["ms"] = timed(torch, lambda: lpq.lp_relax(*ins),
                              KERNEL_REPEATS)
            (row["bound_ms"], row["bound_by"], row["bytes"],
             row["flops"]) = lp_bound(L, N, LP_STEPS)
        log(f"kernel {tag}: match=bit-exact mu_max={row['mu_max']:.4g} "
            f"plain_ms={plain_ms:.1f}"
            + (f" ms={row['ms']:.4f} bound_ms={row['bound_ms']:.6f} "
               f"({row['bound_by']}, {row['bytes']} B, {row['flops']} "
               f"flop)" if "ms" in row else ""))
        results.append(row)
    return results


def lpq_gen1_lanes(np, svc, world):
    """Generation 1: one task group of 8 mock.job placements for each of
    the 128 evals, every lane packed from the empty fleet."""
    matrix, usage, feasible = world
    return [svc.pack_lane_arrays(
        matrix, usage, feasible, ask=ASK, count=LPQ_PLACE,
        n_places=LPQ_PLACE, eval_id=f"lpq-eval-{k:06d}",
        state_index=STATE_INDEX, device=DEVICE) for k in range(LPQ_EVALS)]


def lpq_gen2_lane(np, tp, svc, world, k, lane1, res1):
    """Generation 2: eval k's second task group, packed with the eval's
    own first-generation placements in its usage (the plan overlay;
    other evals' commits reach it through the barrier's ledger). Evals
    0-125 ask as before (LP lanes); eval 126's group spreads over racks
    and zones, eval 127's asks for a static port (both LP-ineligible:
    fuse_and_solve and the cross-lane fixpoint)."""
    matrix, usage, feasible = world
    idx, _ = svc.placements(lane1, res1[0])
    used = [np.array(a, dtype=np.float64)
            for a in (usage.used_cpu, usage.used_mem, usage.used_disk)]
    placed_job = np.array(usage.placed_job, copy=True)
    for n in idx[idx >= 0]:
        for u, a in zip(used, ASK):
            u[n] += a
        placed_job[n] += 1
    own = tp.UsageState(*used, np.zeros_like(usage.placed_jobtg),
                        placed_job, usage.dyn_used)
    kw = {}
    if k == LPQ_EVALS - 2:
        kw["spread_info"] = spread_info(np, tp, matrix, LPQ_PLACE)
    elif k == LPQ_EVALS - 1:
        kw["static_ports_free"] = np.ones(matrix.n_pad, dtype=bool)
    return svc.pack_lane_arrays(
        matrix, own, feasible, ask=ASK, count=LPQ_PLACE,
        n_places=LPQ_PLACE, eval_id=f"lpq-eval-{k:06d}",
        state_index=STATE_INDEX, device=DEVICE, **kw)


def lpq_slice_phase(np, torch, lpq, kernels, svc, tp, world):
    """The main path of slice 4 at full width (bench.py time_lpq's
    shape): 128 evals x 8 placements over the 10,000-node world, driven
    through LpqBarrier by 128 threads in float32 (one generation, one
    lp_relax launch at L_pad 128), then each eval's second task group on
    the same ledger: 126 LP lanes, a spread lane and a static-port lane
    (fuse_and_solve and the fixpoint)."""
    matrix = world[0]
    t0 = time.perf_counter()
    gen1 = lpq_gen1_lanes(np, svc, world)
    pack_ms = (time.perf_counter() - t0) * 1e3
    assert all(lpq.lp_lane_eligible(ln) for ln in gen1)

    # record each dispatch the barrier makes: its lanes in arrival order,
    # its results and its lp_relax launches
    calls = []
    real_solve = lpq.solve_queue

    def recording(lanes, ledger, device=None):
        n0 = kernels.LP_RELAX.launches
        res = real_solve(lanes, ledger, device=device)
        calls.append((list(lanes), res, kernels.LP_RELAX.launches - n0))
        return res

    barrier = lpq.LpqBarrier(LPQ_EVALS, device=DEVICE)
    out = [None] * LPQ_EVALS

    def work(k):
        try:
            res1 = barrier.solve(gen1[k])
            lane2 = lpq_gen2_lane(np, tp, svc, world, k, gen1[k], res1)
            out[k] = (res1, lane2, barrier.solve(lane2))
        except Exception as e:  # noqa: BLE001 -- re-raised below
            out[k] = e
        finally:
            barrier.done()

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(LPQ_EVALS)]
    lpq.solve_queue = recording
    try:
        kernels.reset_launches()
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        run_ms = (time.perf_counter() - t1) * 1e3
        launches = {k.name: k.launches for k in kernels.KERNELS}
    finally:
        lpq.solve_queue = real_solve
    stats = lpq.lpq_stats()
    for r in out:
        if isinstance(r, Exception):
            raise r
    log(f"lpq slice launches: {launches}; per dispatch: "
        f"{[(len(c[0]), c[2]) for c in calls]}")
    assert [(len(c[0]), c[2]) for c in calls] == [(LPQ_EVALS, 1)] * 2
    assert launches["lp_relax"] == 2, launches
    gen2 = calls[1][0]
    assert sum(lpq.lp_lane_eligible(ln) for ln in gen2) == LPQ_EVALS - 2

    # every placement made, and no node over capacity across both
    # generations
    used = np.zeros((3, matrix.n_pad))
    total = 0
    for lanes, res, _ in calls:
        for lane, (ch, sc, ny) in zip(lanes, res):
            assert ch.dtype == np.int64 and ny.dtype == np.int64
            assert bool((ch >= 0).all()), "a placement was not made"
            assert bool(np.all(np.isfinite(sc)))
            idx, _ = svc.placements(lane, ch)
            for r, a in enumerate(ASK):
                np.add.at(used[r], idx, a)
            total += ch.shape[0]
    assert total == 2 * LPQ_EVALS * LPQ_PLACE, total
    caps = (matrix.cpu_cap, matrix.mem_cap, matrix.disk_cap)
    for r, cap in enumerate(caps):
        assert bool(np.all(used[r] <= cap)), "a node is over capacity"
    nodes_used = int((used[0] > 0).sum())

    # a rerun of both dispatches with the plain LP on the card, same
    # lanes in the same order, fresh ledger: the same results and ledger
    lpq.lp_relax, real_relax = lpq.lp_relax_plain, lpq.lp_relax
    try:
        ledger = {}
        for lanes, res, _ in calls:
            want = lpq.solve_queue(lanes, ledger, device=DEVICE)
            for j, (g, w) in enumerate(zip(res, want)):
                for a, b in zip(g, w):
                    if not np.array_equal(a, b):
                        raise AssertionError(
                            f"lpq slice lane {j}: differs from the plain "
                            "LP's rerun")
    finally:
        lpq.lp_relax = real_relax
    assert ledger == barrier._ledger, "ledger differs from the plain rerun"

    # the kernel on the main path's own relaxation inputs (the first
    # generation's), against one call of the plain version
    seen = []

    def keep(*a):
        seen.append(a)
        return real_relax(*a)

    lpq.lp_relax = keep
    try:
        lpq._solve_lp_group(gen1, {}, device=DEVICE)
    finally:
        lpq.lp_relax = real_relax
    ins = seen[0]
    L, N = ins[0].shape
    got, _ = time_once(torch, lambda: lpq.lp_relax(*ins))
    want, plain_ms = time_once(torch, lambda: lpq.lp_relax_plain(*ins))
    compare_lp(torch, "lp_relax main path", got, want)
    ms, dms = call_and_device(torch, lambda: lpq.lp_relax(*ins))
    bnd = lp_bound(L, N, ins[6].shape[0])
    kern = dict(shape=[L, N], ms=ms, device_ms=dms, plain_ms=plain_ms,
                bound_ms=bnd[0], bound_by=bnd[1], bytes=bnd[2],
                flops=bnd[3])
    log(f"kernel lp_relax float32 main path: L={L} N={N} ms={ms:.4f} "
        f"plain_ms={plain_ms:.1f} bound_ms={bnd[0]:.6f} ({bnd[1]}, "
        f"{bnd[2]} B, {bnd[3]} flop)")

    # warm time of the first generation's dispatch (solve_queue, fresh
    # ledger), host clock, and where it goes: the phases of
    # _solve_lp_group (views and values; the LP: inputs to the card,
    # kernel, fetch; rounding and repair; quality comparison; score
    # follow): the dispatch a median of 3, the split of one more run
    times = []
    for _ in range(3):
        t1 = time.perf_counter()
        lpq.solve_queue(gen1, {}, device=DEVICE)
        times.append((time.perf_counter() - t1) * 1e3)
    solve_ms = statistics.median(times)
    parts = {}
    lpq._solve_lp_group(gen1, {}, device=DEVICE, timings=parts)
    placed = LPQ_EVALS * LPQ_PLACE
    log(f"lpq slice: {LPQ_EVALS} evals x {LPQ_PLACE} placements x "
        f"{N_NODES} nodes, two generations through LpqBarrier: all "
        f"{total} placed on {nodes_used} nodes, no node over capacity, "
        f"equal to the plain LP's rerun; barrier run {run_ms:.1f} ms; "
        f"pack_ms={pack_ms:.1f} (generation 1) solve_queue_ms={solve_ms:.2f}"
        f" placements_per_s={placed / (solve_ms / 1e3):.0f}; breakdown ms: "
        + " ".join(f"{k}={v:.2f}" for k, v in parts.items()))
    log(f"lpq_stats: {json.dumps(stats)}")
    return dict(launches=launches, solve_queue_ms=solve_ms,
                solve_queue_ms_all=times, breakdown_ms=parts,
                pack_ms=pack_ms, barrier_run_ms=run_ms, placements=total,
                nodes_used=nodes_used, stats=stats, kernel=kern,
                placements_per_s=placed / (solve_ms / 1e3))


# --------------------------------------------------------------------------
# slice 5: device residency (the resident buffer set, the version chain and
# the delta scatter) and the in-kernel wavefront

# the dense headline's largest stacked table: the const tree's four
# (E, N) float32 fields (cpu/mem/disk caps, affinity) at E = 32, N = 16,384
DENSE_TABLE_BYTES = 4 * 32 * 16_384 * 4
SCATTER_BYTES = (4_096, 65_536, 1 << 20, DENSE_TABLE_BYTES)
SCATTER_BUCKETS = (8, 64, 4_096, 65_536)
G3_PLACED = 50                      # placements charged in generation 3


class JournalAlloc:
    """What the alloc-delta journal's readers need of an allocation."""

    def __init__(self, aid, node_id):
        self.id = aid
        self.node_id = node_id


def scatter_case(np, torch, resident, rng, dt, m, k):
    """A (buf, idx, vals) scatter input on the card: a random table of m
    elements of dt and k - k // 4 distinct updates padded to k by
    _pad_updates (duplicate indices), with -0.0, infinities and NaNs of
    distinct payloads in the table and in the updates."""
    n_upd = max(1, k - k // 4)
    if dt == np.bool_:
        buf = rng.random(m) < 0.5
        vals = rng.random(n_upd) < 0.5
    else:
        buf = rng.standard_normal(m).astype(dt)
        vals = rng.standard_normal(n_upd).astype(dt)
        bits = np.dtype("u%d" % np.dtype(dt).itemsize)
        nan = np.array([np.nan], dtype=dt).view(bits)[0]
        special = np.array([-0.0, np.inf, -np.inf], dtype=dt)
        buf[:3] = special
        buf.view(bits)[3:5] = [nan | 1, nan | 5]
        vals[:min(3, n_upd)] = special[:min(3, n_upd)]
        vals.view(bits)[-1] = nan | 7
    idx = rng.choice(m, n_upd, replace=False)
    idx_p, vals_p, bucket = resident._pad_updates(idx, vals)
    assert bucket == max(8, k)
    dev = torch.device(DEVICE)
    return (torch.from_numpy(buf).to(dev), torch.from_numpy(idx_p).to(dev),
            torch.from_numpy(vals_p).to(dev))


def bits_equal(torch, a, b):
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    w = bits[a.element_size()]
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(w), b.view(w)))


def scatter_kernel_phase(np, torch, resident, seed):
    """delta_scatter against delta_scatter_plain on the card, as bytes:
    1-, 4- and 8-byte dtypes (bool, float32, float64), tables from 4 KiB
    to the dense headline's largest stacked table, update buckets from 8
    to 65,536; the base must be left as it was."""
    rng = np.random.default_rng(seed + 5)
    cases = 0
    for dt in (np.bool_, np.float32, np.float64):
        s = np.dtype(dt).itemsize
        for nbytes in SCATTER_BYTES:
            m = nbytes // s
            for k in SCATTER_BUCKETS:
                if k > m:
                    continue
                buf, idx, vals = scatter_case(np, torch, resident, rng, dt,
                                              m, k)
                keep = buf.clone()
                got = resident.delta_scatter(buf, idx, vals)
                want = resident.delta_scatter_plain(buf, idx, vals)
                tag = f"delta_scatter {np.dtype(dt).name} M={m} k={k}"
                if not bits_equal(torch, got, want):
                    raise AssertionError(f"{tag}: bytes differ")
                if not bits_equal(torch, buf, keep):
                    raise AssertionError(f"{tag}: the base was written")
                cases += 1
    log(f"kernel delta_scatter: {cases} cases (bool/float32/float64, "
        f"{SCATTER_BYTES[0]} B to {SCATTER_BYTES[-1]} B tables, buckets "
        f"{SCATTER_BUCKETS[0]}..{SCATTER_BUCKETS[-1]}) equal to the plain "
        "version as bytes, bases untouched")
    return [dict(name="delta_scatter", dtype="float32", cases=cases,
                 max_abs_err=0.0)]


def scatter_timing(np, torch, resident, seed, m, k, dtype_name):
    """The scatter at the main path's shape (m elements, a k-update
    bucket): the kernel, the plain version and one torch.index_put of the
    same function (int32 indices, as the kernel takes them), each as a
    warm median of KERNEL_REPEATS calls between CUDA events and, where no
    host sync, its device time (device_ms); the promotion as the version
    chain runs it (resident._scatter_single: the payload's one upload,
    then the kernel); and the bound: the table read and written once, the
    k (index, value) pairs read once."""
    dt = np.dtype(dtype_name).type
    rng = np.random.default_rng(seed + 6)
    buf, idx, vals = scatter_case(np, torch, resident, rng, dt, m, k)
    got = resident.delta_scatter(buf, idx, vals)
    want = resident.delta_scatter_plain(buf, idx, vals)
    assert bits_equal(torch, got, want)
    ms, dms = call_and_device(
        torch, lambda: resident.delta_scatter(buf, idx, vals))
    plain_ms = timed(torch, lambda: resident.delta_scatter_plain(
        buf, idx, vals), KERNEL_REPEATS)
    lib = torch.index_put(buf, (idx,), vals)
    assert bits_equal(torch, lib, want)
    library_ms, library_dms = call_and_device(
        torch, lambda: torch.index_put(buf, (idx,), vals))
    idx_p, vals_p = idx.cpu().numpy(), vals.cpu().numpy()
    prom = resident._scatter_single(buf, idx_p, vals_p)
    assert bits_equal(torch, prom, want)
    promote_ms, promote_dms = call_and_device(
        torch, lambda: resident._scatter_single(buf, idx_p, vals_p))
    s = np.dtype(dt).itemsize
    nbytes = 2 * m * s + k * (4 + s)
    bound_ms, bound_by = bound("delta_scatter", nbytes, 0, "float32")
    log(f"kernel delta_scatter {dtype_name} main path: M={m} k={k} "
        f"ms={ms:.4f} device_ms={dms} plain_ms={plain_ms:.4f} "
        f"library_ms(index_put)={library_ms:.4f} library_device_ms="
        f"{library_dms} promote(upload+scatter) ms={promote_ms:.4f} "
        f"device_ms={promote_dms} bound_ms={bound_ms:.6f} ({bound_by}, "
        f"{nbytes} B)")
    return dict(shape=[m, k], ms=ms, device_ms=dms, plain_ms=plain_ms,
                library_ms=library_ms, library_device_ms=library_dms,
                promote_ms=promote_ms, promote_device_ms=promote_dms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)


LAUNCH_FLOOR = dict(system_fit=(1, 32), delta_scatter=(16, 8))


def launch_floor_phase(np, torch, bp, dense, system, resident, seed):
    """The launch floor: row 4's kernel at E 1 x N 32 and row 8's at
    M 16 x k 8 (float32), each against its plain version, call ms and
    device ms (device_ms: launches back to back behind a spin)."""
    rng = np.random.default_rng(seed + 9)
    E, N = LAUNCH_FLOOR["system_fit"]
    lane = dense_fuzz_tables(np, rng, n=N, n_pad=N, p=1, dtype="float32",
                             limit=2, features=("cores", "ports"))
    c, s, b = dense.lane_tensors(*dense_group(np, bp, [lane]),
                                 dtype_name="float32",
                                 device=torch.device(DEVICE))
    got = system.system_fit(c, s, b, spread_alg=False)
    want = system.system_fit_plain(c, s, b, spread_alg=False)
    same_bits(torch, "launch floor system_fit fit", got[0], want[0])
    same_bits(torch, "launch floor system_fit score", got[1], want[1])
    out = {}
    ms, dms = call_and_device(
        torch, lambda: system.system_fit(c, s, b, spread_alg=False))
    out["system_fit"] = dict(shape=[E, N], ms=ms, device_ms=dms)
    m, k = LAUNCH_FLOOR["delta_scatter"]
    buf, idx, vals = scatter_case(np, torch, resident, rng, np.float32, m, k)
    got = resident.delta_scatter(buf, idx, vals)
    assert bits_equal(torch, got, resident.delta_scatter_plain(buf, idx,
                                                                vals))
    ms, dms = call_and_device(
        torch, lambda: resident.delta_scatter(buf, idx, vals))
    out["delta_scatter"] = dict(shape=[m, k], ms=ms, device_ms=dms)
    log("launch floor (float32): " + "; ".join(
        f"{n} {r['shape']} call ms={r['ms']:.4f} device ms={r['device_ms']}"
        for n, r in out.items()))
    return out


def chain_matches_shadows(np, resident):
    """Every chain slot's device buffer equals its frozen host shadow, byte
    for byte."""
    n = 0
    for buf, shadow in resident.chain_entries():
        got = buf.cpu().numpy()
        assert got.dtype == shadow.dtype and got.shape == shadow.shape
        if not (got.reshape(-1).view(np.uint8)
                == shadow.reshape(-1).view(np.uint8)).all():
            raise AssertionError("a chain buffer differs from its shadow")
        n += 1
    return n


def run_generations(np, batch, kernels, resident, store_cls, lanes, charge,
                    *, cold=False, device=None):
    """The dense headline dispatch over four journal generations of one
    port StateStore: g1 cold; g2 the same tables at a newer index (one
    covered write); g3 lane 0 charged with ``charge`` (shuffled positions
    of its first G3_PLACED placements) under one journal entry of
    G3_PLACED (None, alloc) pairs; g4 a write with no change pairs (a
    gap). ``cold`` resets the resident set before every generation;
    ``device`` (default DEVICE) may be a list of cells (the mesh route,
    whose usage tables the coordinate scatter promotes). Returns
    per-generation (results, record, the lanes dispatched)."""
    store = store_cls()
    for i in range(N_NODES):
        store.upsert_node(JournalAlloc(lanes[0].node_ids[i], None))
    lanes = list(lanes)
    base = lanes[0].init
    out = []
    for gen in range(1, 5):
        if gen == 2:
            store.upsert_allocs([JournalAlloc("g2-alloc", lanes[0].node_ids[0])])
        elif gen == 3:
            pos = charge
            init = type(base)(*(np.array(a) for a in base))
            for f, a in zip(("used_cpu", "used_mem", "used_disk"), ASK):
                np.add.at(getattr(init, f), pos, np.float32(a))
            lanes[0] = lane_with_init(lanes[0], init)
            order = lanes[0].order
            store.upsert_allocs([JournalAlloc(
                f"g3-alloc-{k}", lanes[0].node_ids[int(order[p])])
                for k, p in enumerate(pos)])
        elif gen == 4:
            store.replace_allocs(store.allocs())
        token = store.latest_index()
        for ln in lanes:
            ln.delta_src = (store, token)
            ln.table_version = store.table_index("nodes")
        if cold:
            resident._reset_for_tests()
        before = resident.stats()
        launches0 = (kernels.DELTA_SCATTER.launches
                     + kernels.COORD_SCATTER.launches)
        t0 = time.perf_counter()
        res = batch.fuse_and_solve(lanes, device=device or DEVICE)
        ms = (time.perf_counter() - t0) * 1e3
        after = resident.stats()
        rec = {k: after[k] - before[k] for k in (
            "hits", "misses", "bytes_shipped_total", "delta_promotions",
            "delta_reuses", "delta_gap_fallbacks", "delta_size_fallbacks")}
        rec["installs"] = max(0, after["chain_entries"]
                              - (0 if cold else before["chain_entries"]))
        rec["scatter_launches"] = (kernels.DELTA_SCATTER.launches
                                   + kernels.COORD_SCATTER.launches
                                   - launches0)
        rec["dispatch_ms"] = ms
        rec["token"] = token
        if gen >= 3 and not cold:
            rec["chain_buffers_checked"] = chain_matches_shadows(np, resident)
        out.append((res, rec, list(lanes)))
    return out


def lane_with_init(lane, init):
    """A PackedLane like ``lane`` with usage tables ``init``."""
    import copy
    new = copy.copy(lane)
    new.init = init
    return new


def same_results(np, a, b, what):
    for k, (x, y) in enumerate(zip(a, b)):
        for u, v in zip(x, y):
            if not np.array_equal(u, v):
                raise AssertionError(f"{what}: lane {k} differs")


def residency_phase(np, torch, batch, dense, kernels, resident, store_cls,
                    svc, tp, world):
    """The dense headline dispatch (32 spread lanes + the distinct_property
    and reserved-core lanes, float32) over four journal generations,
    install -> reuse/hit -> promote -> gap, then the same generations with
    NOMAD_TPU_TORCH_DELTA_STREAM=0 and cold (the set reset before each):
    decisions equal; after g3 and g4 every chain buffer equals its
    shadow. Then the wave headline dispatched twice: its compact tables'
    hits on the second."""
    import os
    lanes = slice2_lanes(np, tp, svc, world, "float32", n_spread=N_EVALS)
    g0 = batch.fuse_lanes(lanes)[0]
    stacked, _, _ = dense._fuse_trees((g0.const, g0.init, g0.batch))
    assert max(a.nbytes for a in stacked) == DENSE_TABLE_BYTES
    # g3's charge: lane 0's first placements, read from a plain dispatch
    first = batch.fuse_and_solve(lanes, device=DEVICE)[0][0]
    charge = first[:G3_PLACED][first[:G3_PLACED] >= 0]
    assert charge.size == G3_PLACED

    shapes = []
    orig = resident.delta_scatter

    def record(buf, idx, vals):
        shapes.append((buf.numel(), idx.numel(), str(buf.dtype)))
        return orig(buf, idx, vals)

    resident._reset_for_tests()
    kernels.reset_launches()
    resident.delta_scatter = record
    try:
        gens = run_generations(np, batch, kernels, resident,
                               store_cls, lanes, charge)
    finally:
        resident.delta_scatter = orig
    launches = {k.name: k.launches for k in kernels.KERNELS}
    recs = [r for _, r, _ in gens]
    for g, r in enumerate(recs, 1):
        log(f"residency g{g}: " + " ".join(
            f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in r.items()))
    log(f"residency launches: {launches}; scatter shapes {shapes}")
    # g1 installs every slot; the two E = 1 groups (distinct_property,
    # reserved cores) share slot keys (tag, dtype, shape, occurrence), so
    # the second may already reuse or advance the first's slot
    assert recs[0]["installs"] > 0 and recs[0]["delta_gap_fallbacks"] == 0
    assert recs[1]["delta_reuses"] > 0 and recs[1]["hits"] > 0
    assert recs[1]["delta_promotions"] == 0
    assert recs[2]["delta_promotions"] > 0 and recs[2]["scatter_launches"] > 0
    assert recs[3]["delta_gap_fallbacks"] > 0
    assert launches["delta_scatter"] == recs[2]["scatter_launches"]
    for res, _, dispatched in gens:
        for lane, (ch, sc, ny) in zip(dispatched, res):
            check_dense_lane(np, lane, ch, lane.batch.ask_cpu.shape[0])
            assert bool(np.all(np.isfinite(sc)))

    saved = os.environ.get("NOMAD_TPU_TORCH_DELTA_STREAM")
    os.environ["NOMAD_TPU_TORCH_DELTA_STREAM"] = "0"
    try:
        resident._reset_for_tests()
        off = run_generations(np, batch, kernels, resident,
                              store_cls, lanes, charge)
    finally:
        if saved is None:
            os.environ.pop("NOMAD_TPU_TORCH_DELTA_STREAM")
        else:
            os.environ["NOMAD_TPU_TORCH_DELTA_STREAM"] = saved
    cold = run_generations(np, batch, kernels, resident, store_cls,
                           lanes, charge, cold=True)
    for g in range(4):
        same_results(np, gens[g][0], off[g][0], f"kill switch g{g + 1}")
        same_results(np, gens[g][0], cold[g][0], f"cold g{g + 1}")
    assert all(r["delta_promotions"] == r["delta_reuses"] == 0
               for _, r, _ in off)

    # where a warm dispatch's time goes at g4's token (every slot reused,
    # the const tree a content hit): host stacking, the fused transport,
    # the kernels, the fetch (host clock, medians of 5)
    dev = torch.device(DEVICE)
    parts = {"fuse_lanes": [], "to_device": [], "kernels": [], "fetch": []}
    warm_bytes = []
    for _ in range(5):
        t1 = time.perf_counter()
        groups = batch.fuse_lanes(lanes)
        t2 = time.perf_counter()
        tens = []
        shipped = 0
        for g in groups:
            trees, b = dense.fused_tensors(
                (g.const, g.init, g.batch),
                (dense.lane_casts(g.dtype_name),) * 3, device=dev,
                cache_version=g.cache_version, delta_src=g.delta_src)
            tens.append(trees)
            shipped += b
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        outs = [dense.dense_scan(*t, spread_alg=False) for t in tens]
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        [[x.cpu().numpy() for x in o[:3]] for o in outs]
        t5 = time.perf_counter()
        for k, v in zip(parts, (t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            parts[k].append(v * 1e3)
        warm_bytes.append(shipped)
    parts = {k: statistics.median(v) for k, v in parts.items()}
    log("residency warm dispatch (g4 token) breakdown ms: "
        + " ".join(f"{k}={v:.3f}" for k, v in parts.items())
        + f"; bytes shipped {warm_bytes[-1]}")
    # the host work inside to_device for the 32-lane spread group (host
    # clock, medians of 5): stacking its fields into the fused buffers,
    # fingerprinting the const buffers, diffing the others against their
    # shadows, and copying every buffer to the card
    g = batch.fuse_lanes(lanes)[0]
    trees = (g.const, g.init, g.batch)
    stacked, _, keys = dense._fuse_trees(trees)
    shadows = [a.copy() for a in stacked]

    def host_ms(fn):
        ts = []
        for _ in range(5):
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(ts)

    to_device_parts = dict(
        stack=host_ms(lambda: dense._fuse_trees(trees)),
        fingerprint=host_ms(lambda: [resident._fingerprint(a) for a, k in
                                     zip(stacked, keys) if k[0] == 0]),
        diff=host_ms(lambda: [resident._bitwise_changed(a, b) for a, b, k
                              in zip(stacked, shadows, keys) if k[0] != 0]),
        copy=host_ms(lambda: [resident._put(a, dev) for a in stacked]))
    log("residency to_device host parts (spread group, "
        f"{sum(a.nbytes for a in stacked)} B in {len(stacked)} buffers) "
        "ms: " + " ".join(f"{k}={v:.3f}" for k, v in
                          to_device_parts.items()))

    # the wave headline twice: the compact tables hit the second time
    head = pack_lanes(np, tp, svc, world, "float32", kind="plain",
                      n_lanes=N_EVALS)
    batch.fuse_and_solve(head, device=DEVICE)
    before = resident.stats()
    batch.fuse_and_solve(head, device=DEVICE)
    after = resident.stats()
    wave_hits = after["hits"] - before["hits"]
    wave_bytes = after["bytes_shipped_total"] - before["bytes_shipped_total"]
    log(f"wave headline second dispatch: compact-table hits={wave_hits} "
        f"bytes shipped={wave_bytes}")
    assert wave_hits > 0
    m, k, dt = shapes[0]
    return dict(launches=launches, generations=recs,
                kill_switch=[r for _, r, _ in off],
                cold=[r for _, r, _ in cold],
                warm_breakdown_ms=parts, warm_bytes=warm_bytes[-1],
                to_device_parts_ms=to_device_parts,
                wave_second_hits=wave_hits, wave_second_bytes=wave_bytes,
                scatter_shapes=shapes, main_shape=(m, k, dt))


# Floating-point operations of the in-kernel wavefront's prep pass per
# node, counted from csrc/wavefront.cu as above (each add, sub, mul, div,
# min/max, compare and floor one, an fma two): three cap_dim (sub, max,
# div, floor 4; five fits, each an fma and a compare, 15; the ask test 1)
# = 60, and the min over them 2 -> 62. The step loop is
# wave_compact's (COMPACT_SLOT_OPS per slot and placing step, and
# HEAD_OPS for the winner's new head).
WAVEFRONT_PREP_OPS = 62


def wavefront_bound(np, wave, trees, out, dtype_name):
    """(bound_ms, bound_by, bytes, flops) of one wavefront launch, counting
    what this run's data makes the function read. The fit order takes
    nodes in shuffled order, so a lane reads its node rows up to the last
    node it chose, and all N where an active step yielded fewer than its
    limit (no fit node was left to find). Of each such row: the three
    capacities, the three usages, the feasibility mask and the placed
    count, and a flagged table only where its flag asks for it (affinity
    with has_affinity, placed_job with distinct_hosts at job level,
    dyn_avail with dynamic ports, static_free with static ports). Of the
    batch, the uniform asks, ports, limit and count once a lane, the
    active and penalty rows whole; the lane flags; the outputs written
    once. The compact table and lane scalars the kernel builds are its
    own scratch, not counted; rows that entered the window but were never
    chosen are left out, so the bound stays a lower one."""
    c, s, b = trees
    chosen, _, n_yielded = (t.cpu().numpy() for t in out)
    E, N = c.cpu_cap.shape
    act = b.active.cpu().numpy()
    short = ((n_yielded < b.limit.cpu().numpy()) & act).any(axis=1)
    reach = np.where(short, N, chosen.max(axis=1, initial=-1) + 1)

    def on(t):
        return t.cpu().numpy().astype(bool)

    row = sum(t.element_size() for t in (
        c.cpu_cap, c.mem_cap, c.disk_cap, c.feasible, s.used_cpu,
        s.used_mem, s.used_disk, s.placed))
    row = (row + on(c.has_affinity) * c.affinity.element_size()
           + (on(c.distinct_hosts) & on(c.distinct_job_level))
           * s.placed_job.element_size()
           + (b.n_dyn_ports[:, 0].cpu().numpy() > 0)
           * s.dyn_avail.element_size()
           + on(b.has_static[:, 0]) * s.static_free.element_size())
    once = sum(t.element_size() for t in (
        c.has_affinity, c.distinct_hosts, c.distinct_job_level, b.ask_cpu,
        b.ask_mem, b.ask_disk, b.n_dyn_ports, b.has_static, b.limit,
        b.count))
    nbytes = (int((row * reach).sum()) + E * once + b.active.nbytes
              + b.penalty_idx.nbytes + sum(t.nbytes for t in out))
    steps = int((chosen >= 0).sum())
    flops = (int(reach.sum()) * WAVEFRONT_PREP_OPS
             + steps * (wave.WAVE_B * COMPACT_SLOT_OPS + HEAD_OPS))
    return (*bound("wavefront", nbytes, flops, dtype_name), nbytes, flops)


def wavefront_trees(np, lanes):
    """The lanes' (const, init, batch) tables stacked over a lane axis."""
    return tuple(type(t0)(*(np.stack([np.asarray(a) for a in xs])
                            for xs in zip(*[getattr(ln, k) for ln in lanes])))
                 for k, t0 in (("const", lanes[0].const),
                               ("init", lanes[0].init),
                               ("batch", lanes[0].batch)))


WAVEFRONT_MIXED_HEAD = 6            # headline lanes of the mixed group
WAVEFRONT_LATE_ACTIVE = 1_000       # the late-penalty lane's least prefix


def pad_batch(np, batch, P):
    """``batch`` with its placement rows padded to P: row 0's asks, limit
    and count repeated, the added rows inactive and without a penalty."""
    P0 = np.asarray(batch.ask_cpu).shape[0]

    def pad(f, a):
        a = np.asarray(a)
        if a.shape[:1] != (P0,) or P0 == P:
            return a
        fill = {"active": False, "penalty_idx": -1}.get(f, a[0])
        return np.concatenate([a, np.full((P - P0,) + a.shape[1:], fill,
                                          dtype=a.dtype)])

    return type(batch)(*(pad(f, a) for f, a in zip(batch._fields, batch)))


def wavefront_mixed_trees(np, tp, svc, world, dtype_name, late):
    """A group that sends lanes down both of the wavefront's step forms in
    one launch: WAVEFRONT_MIXED_HEAD penalty-free headline lanes (the
    run-block loop), the penalty lane (60 placements, every third with a
    penalty; padded to the headline's P with inactive rows) and headline
    lane WAVEFRONT_MIXED_HEAD active for its first n_active placements,
    whose one penalty lies past them (the per-placement loop: a penalty
    past n_active still moves the scores the lane reports there), on
    node position pos; late = (n_active, pos), the step of its full run
    where pos goes on winning with a rising score and that node."""
    from types import SimpleNamespace
    head = pack_lanes(np, tp, svc, world, dtype_name, kind="plain",
                      n_lanes=WAVEFRONT_MIXED_HEAD + 1)
    pen = pack_lanes(np, tp, svc, world, dtype_name, kind="penalty",
                     n_lanes=1)[0]
    P = np.asarray(head[0].batch.ask_cpu).shape[0]
    n_active, pos = late
    last = head[-1].batch
    act = np.zeros(P, dtype=bool)
    act[:n_active] = True
    pidx = np.full(P, -1, dtype=np.int32)
    pidx[n_active + P // 4] = pos
    lanes = head[:-1] + [
        SimpleNamespace(const=pen.const, init=pen.init,
                        batch=pad_batch(np, pen.batch, P)),
        SimpleNamespace(const=head[-1].const, init=head[-1].init,
                        batch=last._replace(active=act, penalty_idx=pidx))]
    return wavefront_trees(np, lanes)


# Edge groups of the wavefront's prep: (E, N, P, feasible share) -- one
# cluster block (N < 512), N off the round size, P above N (rows past
# the fleet), and fit nodes so scarce the walk takes several rounds.
WAVEFRONT_EDGE_GROUPS = ((4, 100, 40, 0.85), (4, 1_000, 300, 0.85),
                         (3, 600, 700, 0.85), (4, 9_000, 64, 0.004))


def wavefront_fuzz_trees(np, torch, rng, E, N, P, feas, dtype_name, dev):
    """E numpy-seeded lanes over every feature the in-kernel wavefront
    models (non-integer asks, ports, distinct_hosts, affinity,
    penalties, infeasible nodes, seeded usage; lane 0 with no fit node,
    lane 1 with every node fit and no penalty, a saturating-cast lane
    where E > 3), as (const, init, batch) of tensors on ``dev``: only
    the fields the wavefront reads."""
    from types import SimpleNamespace
    dt = np.dtype(dtype_name)
    cap = rng.choice([2000.0, 4000.0, 8000.0], (E, N))
    used = rng.integers(0, 4, (E, N)) * rng.choice([250.0, 500.0], (E, N))
    ok = rng.random((E, N)) < feas
    ok[0] = False
    ok[1] = True
    aff = np.where(rng.random((E, N)) < 0.5,
                   rng.choice([-1.0, -0.5, 0.25, 0.5, 1.0], (E, N)), 0.0)
    placed = np.where(rng.random((E, N)) < 0.2, rng.integers(1, 4, (E, N)),
                      0)
    ask_cpu = rng.choice([99.5, 333.3, 500.0, 1500.25], E)
    if E > 3:
        # XLA's saturating cast: (cap - used) / ask past 2^31 on every
        # third node of lane 3
        cap[3, ::3] = 1e12
        used[3] = 0.0
        ask_cpu[3] = 1e-3
    pen = np.where(rng.random((E, P)) < 0.1, rng.integers(0, N, (E, P)), -1)
    pen[1] = -1
    row = lambda v: np.repeat(np.asarray(v)[:, None], P, axis=1)  # noqa
    dyn = rng.choice([0, 0, 3, 9], E)
    dyn[1] = 0
    const = dict(cpu_cap=cap.astype(dt),
                 mem_cap=rng.choice([4096.0, 8192.0, 16384.0],
                                    (E, N)).astype(dt),
                 disk_cap=np.full((E, N), 90 * 1024.0, dt), feasible=ok,
                 affinity=aff.astype(dt),
                 has_affinity=rng.random(E) < 0.5,
                 distinct_hosts=np.arange(E) % 4 == 2,
                 distinct_job_level=rng.random(E) < 0.5)
    init = dict(used_cpu=used.astype(dt),
                used_mem=(rng.integers(0, 4, (E, N)) * 512.0).astype(dt),
                used_disk=(rng.integers(0, 3, (E, N)) * 150.0).astype(dt),
                placed=placed.astype(np.int32),
                placed_job=(placed + rng.integers(0, 2, (E, N))).astype(
                    np.int32),
                static_free=rng.random((E, N)) > 0.3,
                dyn_avail=rng.integers(-2, 40, (E, N)).astype(np.int32))
    act = np.ones((E, P), dtype=bool)
    act[2, P // 2:] = False
    batch = dict(ask_cpu=row(ask_cpu).astype(dt),
                 ask_mem=row(rng.choice([128.0, 511.7, 2048.0], E)).astype(
                     dt),
                 ask_disk=np.full((E, P), 300.0, dt),
                 n_dyn_ports=row(dyn).astype(np.int32),
                 has_static=row(np.arange(E) % 4 == 3),
                 limit=row(rng.choice([2, 4, 9, 28], E)).astype(np.int32),
                 count=row(rng.choice([1, 3, P], E)).astype(np.int32),
                 penalty_idx=pen.astype(np.int32), active=act)
    return tuple(SimpleNamespace(**{k: torch.from_numpy(
        np.ascontiguousarray(v)).to(dev) for k, v in t.items()})
        for t in (const, init, batch))


def wavefront_phase(np, torch, wave, dense, batch, kernels, svc, tp, world):
    """solve_wavefront at the headline shape (32 uniform lanes x 2,000
    placements, N = 16,384, B = 32) in float32 and float64: the kernel
    against wavefront_plain on the card (decisions exactly, scores as
    bits) and against the wave_block route's decisions on the same lanes;
    timed by CUDA events; the float32 run through the entry point with
    the launch counts reset is the main-path run. Then the mixed group
    (wavefront_mixed_trees: both step forms in one launch) against
    wavefront_plain as bits in both dtypes."""
    results = []
    main = None
    dev = torch.device(DEVICE)
    late = {}
    for dtype_name in ("float32", "float64"):
        lanes = pack_lanes(np, tp, svc, world, dtype_name, kind="plain",
                           n_lanes=N_EVALS)
        trees = wavefront_trees(np, lanes)
        if dtype_name == "float32":
            kernels.reset_launches()
            got_np = wave.solve_wavefront(*trees, dtype_name=dtype_name,
                                          device=DEVICE)
            main = {k.name: k.launches for k in kernels.KERNELS}
            log(f"wavefront launches: {main}")
            assert main["wavefront"] >= 1, main
        (c, s, b), _ = dense.fused_tensors(
            trees, (dense.lane_casts(dtype_name),) * 3, device=dev)
        got, _ = time_once(torch, lambda: wave.wavefront(
            c, s, b, spread_alg=False))
        want, plain_ms = time_once(torch, lambda: wave.wavefront_plain(
            c, s, b, spread_alg=False))
        tag = f"wavefront {dtype_name}"
        err = compare(torch, tag, got, want, dtype_name)
        for f, g, w in zip(("chosen", "scores", "n_yielded"), got, want):
            same_bits(torch, f"{tag} {f}", g, w)
        if dtype_name == "float32":
            assert np.array_equal(got_np[0], got[0].cpu().numpy())
        blk = batch.fuse_and_solve(lanes, device=DEVICE)
        for e, (ch, _, ny) in enumerate(blk):
            if not (np.array_equal(ch, got[0][e].cpu().numpy())
                    and np.array_equal(ny, got[2][e].cpu().numpy())):
                raise AssertionError(f"{tag}: lane {e} differs from the "
                                     "wave_block route")
        ms = timed(torch, lambda: wave.wavefront(c, s, b, spread_alg=False),
                   KERNEL_REPEATS)
        dms = device_ms(torch, lambda: wave.wavefront(
            c, s, b, spread_alg=False)) if dtype_name == "float32" else None
        E, N = c.cpu_cap.shape
        P = b.ask_cpu.shape[1]
        steps = int((want[0] >= 0).sum())
        bound_ms, bound_by, nbytes, flops = wavefront_bound(
            np, wave, (c, s, b), want, dtype_name)
        log(f"kernel {tag}: E={E} N={N} P={P} placed={steps} match=bits "
            f"(plain and wave_block) max_abs_err={err:.3e} ms={ms:.4f} "
            f"plain_ms={plain_ms:.1f} bound_ms={bound_ms:.6f} ({bound_by}, "
            f"{nbytes} B, {flops} flop)")
        results.append(dict(
            name="wavefront", dtype=dtype_name, shape=[E, N, P],
            placed=steps, max_abs_err=err, ms=ms, device_ms=dms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            bytes=nbytes, flops=flops))
        # a step where the chosen node goes on winning with a rising
        # score: penalizing it there must move the best score
        ch = want[0][WAVEFRONT_MIXED_HEAD].cpu().numpy()
        sc = want[1][WAVEFRONT_MIXED_HEAD].cpu().numpy()
        t = next(t for t in range(WAVEFRONT_LATE_ACTIVE, P - 1)
                 if ch[t] >= 0 and ch[t] == ch[t - 1] and sc[t] > sc[t - 1])
        late[dtype_name] = (t, int(ch[t]))
    for dtype_name in ("float32", "float64"):
        trees = wavefront_mixed_trees(np, tp, svc, world, dtype_name,
                                      late[dtype_name])
        (c, s, b), _ = dense.fused_tensors(
            trees, (dense.lane_casts(dtype_name),) * 3, device=dev)
        got = wave.wavefront(c, s, b, spread_alg=False)
        want = wave.wavefront_plain(c, s, b, spread_alg=False)
        tag = f"wavefront mixed {dtype_name}"
        err = compare(torch, tag, got, want, dtype_name)
        for f, g, w in zip(("chosen", "scores", "n_yielded"), got, want):
            same_bits(torch, f"{tag} {f}", g, w)
        # the late penalty moves the score the frozen lane reports there
        sc = want[1][-1].cpu()
        t = late[dtype_name][0] + b.ask_cpu.shape[1] // 4
        assert sc[t] != sc[t - 1] and sc[t + 1] == sc[t - 1], (
            float(sc[t - 1]), float(sc[t]), float(sc[t + 1]))
        log(f"{tag}: E={c.cpu_cap.shape[0]} (the last two with penalties) "
            f"bits equal to the plain version; max_abs_err={err:.3e}")
        results.append(dict(name="wavefront", dtype=dtype_name,
                            group="mixed", max_abs_err=err))
        rng = np.random.default_rng(SEED + 17)
        for E, N, P, feas in WAVEFRONT_EDGE_GROUPS:
            c, s, b = wavefront_fuzz_trees(np, torch, rng, E, N, P, feas,
                                           dtype_name, dev)
            got = wave.wavefront(c, s, b, spread_alg=False)
            want = wave.wavefront_plain(c, s, b, spread_alg=False)
            tag = f"wavefront edge E={E} N={N} P={P} {dtype_name}"
            for f, g, w in zip(("chosen", "scores", "n_yielded"), got,
                               want):
                same_bits(torch, f"{tag} {f}", g, w)
        log(f"wavefront edge groups {WAVEFRONT_EDGE_GROUPS} {dtype_name}: "
            "bits equal to the plain version")
    return results, dict(launches=main)


# --------------------------------------------------------------------------
# The mesh route (slice 6): a grid of MESH_CELLS cells, every cell cuda:0.

MESH_CELLS = 4
MESH_FUZZ_N, MESH_FUZZ_P = 1_024, 64   # fuzz groups held against the plain
# dense_shard phases (E = 8, every dense feature) on each 4-cell grid with
# more than one node column
MESH_DRILL_BUDGET_S = 0.05             # the wait drill's budget


def same_outputs(np, got, want, what):
    """Host (chosen, scores, n_yielded) equal bit for bit."""
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype != w.dtype or g.shape != w.shape or \
                g.tobytes() != w.tobytes():
            raise AssertionError(f"{what}: output {k} differs")


def shard_rows(mesh, dense, grid, trees, *, spread_alg, dtype_name,
               host_exchange=False):
    """Fresh ShardCells of a stacked numpy group over ``grid``, each
    evals row sharing its exchange area."""
    s = mesh.shard_solver_inputs(grid, *trees)
    return mesh.shard_cells(grid, s, dense.lane_casts(dtype_name),
                            spread_alg=spread_alg,
                            host_exchange=host_exchange)


def rows_outputs(np, rows):
    return tuple(np.concatenate([getattr(r[0], f).cpu().numpy()
                                 for r in rows])
                 for f in ("chosen", "scores", "n_yielded"))


def run_shard_kernel(np, mesh, rows, host_exchange=False):
    """The persistent dense_shard launch over ``rows`` (one per card):
    its outputs, then its error word read."""
    from nomad_tpu_torch.solver import exchange
    err = mesh.run_persistent(rows, host_exchange=host_exchange)
    out = rows_outputs(np, rows)
    exchange.check(err)
    return out


def mesh_dense_check(np, torch, mesh, dense, grid, trees, *, spread_alg,
                     dtype_name, want, what, timing=False, host=False):
    """dense_shard on ``grid`` (one persistent launch) against its plain
    phases on the card (mesh.run_node_sharded, the same exchange area
    read in place) and against ``want`` (the one-card route's host
    outputs), bit for bit; with ``host`` once more with every exchange
    area in pinned host memory. Returns (ms, plain_ms, device ms) when
    ``timing``: ms between CUDA events around the wrapper (the device
    table and the launch; host part included), device ms of the launch
    alone over fresh cells (a run advances its cells' state)."""
    from nomad_tpu_torch.solver import exchange
    kw = dict(spread_alg=spread_alg, dtype_name=dtype_name)
    rows = shard_rows(mesh, dense, grid, trees, **kw)
    err, ms = time_once(torch, lambda: mesh.run_persistent(rows))
    got = rows_outputs(np, rows)
    exchange.check(err)
    prow = shard_rows(mesh, dense, grid, trees, **kw)
    _, plain_ms = time_once(torch, lambda: mesh.run_node_sharded(prow))
    same_outputs(np, got, rows_outputs(np, prow),
                 f"{what}: kernel vs plain phases")
    same_outputs(np, got, want, f"{what}: grid vs one card")
    if host:
        same_outputs(np, run_shard_kernel(np, mesh, shard_rows(
            mesh, dense, grid, trees, host_exchange=True, **kw),
            host_exchange=True), want,
            f"{what}: host-memory exchange vs one card")
    if not timing:
        return None
    fresh = iter([shard_rows(mesh, dense, grid, trees, **kw)
                  for _ in range(8)])
    dms = device_ms(torch, lambda: mesh.run_persistent(next(fresh)), 2)
    return ms, plain_ms, dms


def mesh_drill(np, torch, dense, lpq, mesh, seed):
    """A two-cell group launched for one cell alone, each kernel, with a
    budget of MESH_DRILL_BUDGET_S: the lone cell's wait runs out, writes
    the error word and leaves; reading the result raises
    ExchangeTimeout. Returns each drill's ms to the raise."""
    from nomad_tpu_torch.solver import exchange
    from nomad_tpu_torch.solver import binpack as pbp
    out = {}
    rng = np.random.default_rng(seed + 80)
    fl = [dense_fuzz_tables(np, rng, n=MESH_FUZZ_N - 24, n_pad=MESH_FUZZ_N,
                            p=MESH_FUZZ_P, dtype="float32", limit=6,
                            features=DENSE_FEATURES[1:]) for _ in range(2)]
    trees = tuple(cls(**{f: np.stack([ln[k][f] for ln in fl])
                         for f in cls._fields})
                  for k, cls in enumerate((pbp.NodeConst, pbp.NodeState,
                                           pbp.PlacementBatch)))
    grid = mesh.make_mesh([DEVICE] * 2, eval_parallel=1)
    rows = shard_rows(mesh, dense, grid, trees, spread_alg=False,
                      dtype_name="float32")
    arrays = lp_fuzz_inputs(np, rng, 16, 256, over=True)
    lgrid = mesh.make_mesh([DEVICE] * 2, eval_parallel=2)
    s_in, _ = mesh.shard_lpq_inputs(lgrid, *arrays)
    lrows = mesh.lpq_cells(lgrid, s_in, lpq.lp_temperatures(8))
    for name, run, cell in (
            ("dense_shard", lambda: dense.dense_shard(
                [rows[0][0]], budget_s=MESH_DRILL_BUDGET_S), rows[0][0]),
            ("lp_shard", lambda: lpq.lp_shard(
                [lrows[0][0]], budget_s=MESH_DRILL_BUDGET_S), lrows[0][0])):
        t0 = time.perf_counter()
        try:
            # the plain step loops refuse the lone cell at once; the kernel's
            # wait runs out and the read of its error word raises
            err = run()
            (cell.chosen if name == "dense_shard" else cell.X).cpu()
            exchange.check(err)
        except exchange.ExchangeTimeout as e:
            out[name] = (time.perf_counter() - t0) * 1e3
            log(f"mesh drill {name}: a two-cell group launched for one "
                f"cell alone raised after {out[name]:.1f} ms (budget "
                f"{MESH_DRILL_BUDGET_S * 1e3:.0f} ms): {e}")
            continue
        raise AssertionError(f"mesh drill {name}: the lone cell's wait "
                             "did not raise")
    return out


def mesh_dense_phase(np, torch, batch, dense, mesh, kernels, svc, tp, world,
                     seed):
    """The dense slice over a 4-cell grid of cuda:0, both dtypes:
    fuse_and_solve(device=[cuda] * 4) picks (4, 1) for the 32 spread lanes
    (a dense_scan per eval row) and (1, 4) for the distinct_property and
    reserved-core lanes (the node-sharded scan: one persistent dense_shard
    launch each, 2 in all), each lane equal to the one-card route bit for
    bit; then the 32-lane group on the forced grids (2, 2) and (1, 4);
    dense_shard against its plain phases on the card at the main path's
    E = 1 groups (float32, timed beside dense_scan on the same lane on
    one card; the distinct_property lane once more with the exchange in
    pinned host memory) and on fuzz groups (both dtypes; float64's (2, 2)
    group also in host memory)."""
    cells = [DEVICE] * MESH_CELLS
    out = {"kernels": []}
    for dtn in ("float32", "float64"):
        lanes = slice2_lanes(np, tp, svc, world, dtn, n_spread=N_EVALS)
        one = batch.fuse_and_solve(lanes, device=DEVICE)
        picked = []
        real_pick = mesh.pick_mesh

        def pick(e, n, devices):
            grid = real_pick(e, n, devices)
            picked.append((e, grid.shape if grid is not None else None))
            return grid

        mesh.pick_mesh = pick
        try:
            kernels.reset_launches()
            mesh._reset_for_tests()
            t0 = time.perf_counter()
            got = batch.fuse_and_solve(lanes, device=cells)
            ms = (time.perf_counter() - t0) * 1e3
            launches = {k.name: k.launches for k in kernels.KERNELS}
        finally:
            mesh.pick_mesh = real_pick
        stats = mesh.mesh_stats()
        log(f"mesh dense slice {dtn}: grids {picked}; launches {launches};"
            f" mesh {stats}; fuse_and_solve_ms={ms:.1f} (host clock, "
            f"{MESH_CELLS} cells of one card, not multi-card speed)")
        assert sorted(picked) == sorted([(N_EVALS, (4, 1)), (1, (1, 4)),
                                         (1, (1, 4))]), picked
        # one persistent launch per card per node-sharded dispatch
        assert launches["dense_shard"] == 2 and launches["dense_scan"] == 4
        assert stats["persistent_launches"] == 2, stats
        for k, (g, w) in enumerate(zip(got, one)):
            same_outputs(np, g, w, f"mesh dense slice {dtn} lane {k}")
        if dtn == "float32":
            out.update(launches=launches, fuse_and_solve_ms=ms,
                       grids=picked, mesh_stats=stats)
        one_ms = statistics.median(
            time_once(torch, lambda: batch.fuse_and_solve(
                lanes, device=DEVICE))[1] for _ in range(3))
        out[f"one_card_ms_{dtn}"] = one_ms
        groups = batch.fuse_lanes(lanes)
        try:
            for g in groups:
                trees = (g.const, g.init, g.batch)
                want = [x[:, :] for x in dense.solve_placements(
                    *trees, spread_alg=g.spread_alg, dtype_name=dtn,
                    device=DEVICE)[:3]]
                want = tuple(x.cpu().numpy() for x in want)
                if len(g.idxs) == N_EVALS:
                    for shape in ((2, 2), (1, 4)):
                        grid = mesh.make_mesh(cells, eval_parallel=shape[0])
                        res, gms = time_once(torch, lambda: mesh.mesh_solve(
                            grid, *trees, spread_alg=g.spread_alg,
                            dtype_name=dtn))
                        same_outputs(np, res, want,
                                     f"mesh {shape} 32-lane group {dtn}")
                        log(f"mesh dense {dtn} 32 lanes on {shape}: equal "
                            f"to one card; mesh_solve ms={gms:.1f} (CUDA "
                            "events around the call: inputs shipped, one "
                            "launch)")
                        out[f"forced_{shape[0]}x{shape[1]}_ms_{dtn}"] = gms
                    continue
                if dtn == "float64":
                    # float64's E = 1 groups: equal to one card (above);
                    # its plain-phase check is on the fuzz groups below
                    continue
                # an E = 1 group of the main path on (1, 4): the kernel
                # against its plain phases, timed
                lane = ("distinct_property" if g.const.dp_vidx.shape[1]
                        else "reserved_cores")
                grid = mesh.make_mesh(cells, eval_parallel=1)
                ms_k, plain_ms, dms = mesh_dense_check(
                    np, torch, mesh, dense, grid, trees,
                    spread_alg=g.spread_alg, dtype_name=dtn, want=want,
                    what=f"dense_shard lane {g.idxs} {dtn}", timing=True,
                    host=lane == "distinct_property")
                C = kernels.DENSE_SHARD.last_cluster()
                c, st, b = dense.lane_tensors(*trees, dtype_name=dtn,
                                              device=torch.device(DEVICE))
                ref = dense.dense_scan(c, st, b, spread_alg=g.spread_alg)
                bound_ms, bound_by, nbytes, flops = dense_bound(
                    torch, c, st, b, ref, dtn)
                # the same lane through dense_scan on one card (the aim's
                # yardstick; each call rescans the lane from its tables)
                one_lane_ms = timed(torch, lambda: dense.dense_scan(
                    c, st, b, spread_alg=g.spread_alg), 5)
                row = dict(name="dense_shard", dtype=dtn,
                           shape=[1, int(c.cpu_cap.shape[1]),
                                  int(b.ask_cpu.shape[1]), 1, 4],
                           ms=ms_k, device_ms=dms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           bytes=nbytes, flops=flops, max_abs_err=0.0,
                           cluster=C, one_card_dense_scan_ms=one_lane_ms,
                           lane=lane)
                log(f"kernel dense_shard {dtn} {row['lane']} on (1, 4): "
                    f"N={row['shape'][1]} P={row['shape'][2]} C={C} "
                    f"ms={ms_k:.3f} device_ms={dms} plain_ms="
                    f"{plain_ms:.1f} bound_ms={bound_ms:.6f} ({bound_by}, "
                    f"{nbytes} B, {flops} flop); dense_scan on one card "
                    f"{one_lane_ms:.3f} ms; equal to plain and one card"
                    + ("; and with the exchange in host memory"
                       if lane == "distinct_property" else ""))
                out["kernels"].append(row)
        finally:
            batch.release_groups(groups)
        # fuzz groups over every dense feature on both node-sharded grids
        rng = np.random.default_rng(seed + 60)
        fl = []
        for _ in range(8):
            c, st, b = dense_fuzz_tables(
                np, rng, n=MESH_FUZZ_N - 24, n_pad=MESH_FUZZ_N,
                p=MESH_FUZZ_P, dtype=dtn, limit=6,
                features=DENSE_FEATURES[1:])
            fl.append((c, st, b))
        from nomad_tpu_torch.solver import binpack as pbp
        trees = tuple(cls(**{f: np.stack([ln[k][f] for ln in fl])
                             for f in cls._fields})
                      for k, cls in enumerate((pbp.NodeConst, pbp.NodeState,
                                               pbp.PlacementBatch)))
        want = tuple(x.cpu().numpy() for x in dense.solve_placements(
            *trees, spread_alg=False, dtype_name=dtn, device=DEVICE)[:3])
        for e_par in (2, 1):
            grid = mesh.make_mesh(cells, eval_parallel=e_par)
            mesh_dense_check(np, torch, mesh, dense, grid, trees,
                             spread_alg=False, dtype_name=dtn, want=want,
                             what=f"dense_shard fuzz {grid.shape} {dtn}",
                             host=dtn == "float64" and e_par == 2)
        log(f"kernel dense_shard {dtn} fuzz E=8 N={MESH_FUZZ_N} "
            f"P={MESH_FUZZ_P} on (2, 2) and (1, 4): equal to the plain "
            "phases and to one card"
            + ("; (2, 2) with the exchange in host memory too"
               if dtn == "float64" else ""))
    return out


def mesh_wave_phase(np, batch, mesh, kernels, svc, tp, world):
    """The wave slice's 32-lane headline group, its eval axis split over
    4 cells (each runs wave_block on 8 lanes), equal to the one-card
    route."""
    cells = [DEVICE] * MESH_CELLS
    head = pack_lanes(np, tp, svc, world, "float32", kind="plain",
                      n_lanes=N_EVALS)
    one = batch.fuse_and_solve(head, device=DEVICE)
    kernels.reset_launches()
    mesh._reset_for_tests()
    t0 = time.perf_counter()
    got = batch.fuse_and_solve(head, device=cells)
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k.name: k.launches for k in kernels.KERNELS}
    stats = mesh.mesh_stats()
    assert launches["wave_block"] == MESH_CELLS, launches
    assert stats["eval_sharded_dispatches"] == 1, stats
    for k, (g, w) in enumerate(zip(got, one)):
        same_outputs(np, g, w, f"mesh wave lane {k}")
    log(f"mesh wave slice: 32 lanes over {MESH_CELLS} cells equal to one "
        f"card; launches {launches}; fuse_and_solve_ms={ms:.1f}")
    return dict(launches=launches, fuse_and_solve_ms=ms, mesh_stats=stats)


def mesh_lp_phase(np, torch, lpq, mesh, kernels, svc, world, seed):
    """One LP generation (128 evals x 8) through solve_queue over 4 cells:
    pick_mesh gives (4, 1), one persistent lp_shard launch; then (2, 2)
    forced; the generation's X and mu bit for bit the one-card lp_relax's,
    and the results equal. Then lp_shard at the main path's shape (L 128,
    N 16,384, fuzz): X and mu bit for bit against lp_relax on one card and
    against its plain phases on the card (mesh.run_lpq_cells), on (4, 1)
    and (2, 2); (4, 1) once more with the exchange in pinned host memory;
    timed on (4, 1) (the call: mesh_lpq; the device: the launch alone on
    its cells) beside lp_relax on one card."""
    from nomad_tpu_torch.solver import exchange
    cells = [DEVICE] * MESH_CELLS
    gen1 = lpq_gen1_lanes(np, svc, world)
    # the generation's X and mu, as each route returns them
    seen = {}
    real_relax, real_mesh_lpq = lpq.lp_relax, mesh.mesh_lpq

    def keep(tag, fn):
        def run(*a):
            out = fn(*a)
            seen[tag] = out
            return out
        return run

    lpq.lp_relax = keep("one", real_relax)
    mesh.mesh_lpq = keep("grid", real_mesh_lpq)
    real_pick = mesh.pick_mesh
    try:
        one = lpq.solve_queue(gen1, {}, device=DEVICE)
        kernels.reset_launches()
        mesh._reset_for_tests()
        t0 = time.perf_counter()
        got = lpq.solve_queue(gen1, {}, device=cells)
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k.name: k.launches for k in kernels.KERNELS}
        stats = mesh.mesh_stats()
        compare_lp(torch, "mesh lp generation (4, 1)", seen["grid"],
                   seen["one"])
        mesh.pick_mesh = lambda e, n, devices: mesh.make_mesh(devices, 2)
        forced = lpq.solve_queue(gen1, {}, device=cells)
        compare_lp(torch, "mesh lp generation (2, 2)", seen["grid"],
                   seen["one"])
    finally:
        lpq.lp_relax, mesh.mesh_lpq = real_relax, real_mesh_lpq
        mesh.pick_mesh = real_pick
    # one persistent launch for the LP generation
    assert launches["lp_shard"] == 1 and launches["lp_relax"] == 0, launches
    assert stats["lpq_dispatches"] == 1, stats
    assert stats["persistent_launches"] == 1, stats
    for k, (g, w) in enumerate(zip(got, one)):
        same_outputs(np, g, w, f"mesh lp lane {k}")
    for k, (g, w) in enumerate(zip(forced, one)):
        same_outputs(np, g, w, f"mesh lp (2, 2) lane {k}")
    log(f"mesh lp tier: {LPQ_EVALS} evals on (4, 1) and (2, 2) equal to "
        f"one card; launches {launches}; mesh {stats}; "
        f"solve_queue_ms={ms:.1f}")

    def grid_lpq(grid, s_in, temps, **kw):
        X, mu = mesh.mesh_lpq(grid, s_in, temps, **kw)
        torch.cuda.synchronize()
        exchange.check(getattr(X, "exchange_error", None))
        return X, mu

    L, N = LP_TIMED
    rng = np.random.default_rng(seed + 70)
    arrays = lp_fuzz_inputs(np, rng, L, N, over=True)
    temps = lpq.lp_temperatures(LP_STEPS)
    ins = [torch.from_numpy(a).to(DEVICE) for a in arrays]
    ins.append(torch.from_numpy(temps).to(DEVICE))
    want = lpq.lp_relax(*ins)
    row = None
    for e_par in (4, 2):
        grid = mesh.make_mesh(cells, eval_parallel=e_par)
        s_in, _ = mesh.shard_lpq_inputs(grid, *arrays)
        got_k, k_ms = time_once(torch, lambda: grid_lpq(grid, s_in, temps))
        compare_lp(torch, f"lp_shard {grid.shape} vs lp_relax", got_k, want)
        if e_par != 4:
            continue
        k_ms = timed(torch, lambda: mesh.mesh_lpq(grid, s_in, temps), 5)
        # the launch alone, on cells built once (the anneal carries no
        # state from a run to the next)
        lcells = [c for r in mesh.lpq_cells(grid, s_in, temps) for c in r]
        err = lpq.lp_shard(lcells)
        torch.cuda.synchronize()
        exchange.check(err)
        compare_lp(torch, "lp_shard launch alone vs lp_relax",
                   (lcells[0].X, lcells[0].mu),
                   (want[0][:L // e_par], want[1]))
        k_dms = device_ms(torch, lambda: lpq.lp_shard(lcells), 5)
        compare_lp(torch, "lp_shard host-memory exchange vs lp_relax",
                   grid_lpq(grid, s_in, temps, host_exchange=True), want)
        prow = mesh.lpq_cells(grid, s_in, temps)
        _, plain_ms = time_once(
            torch, lambda: mesh.run_lpq_cells(prow))
        compare_lp(torch, "lp_shard plain phases vs lp_relax",
                   (torch.cat([r[0].X for r in prow]), prow[0][0].mu), want)
        one_ms = timed(torch, lambda: lpq.lp_relax(*ins), 5)
        bound_ms, bound_by, nbytes, flops = lp_bound(L, N, LP_STEPS)
        row = dict(name="lp_shard", dtype="float32",
                   shape=[L, N, 4, 1], ms=k_ms, device_ms=k_dms,
                   plain_ms=plain_ms, one_card_lp_relax_ms=one_ms,
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   flops=flops, max_abs_err=0.0)
        log(f"kernel lp_shard (4, 1) L={L} N={N}: bit-exact vs lp_relax,"
            f" the plain phases and the host-memory exchange; ms={k_ms:.3f}"
            f" device_ms={k_dms} plain_ms={plain_ms:.1f} bound_ms="
            f"{bound_ms:.6f} ({bound_by}); lp_relax on one card "
            f"{one_ms:.3f} ms")
    return dict(launches=launches, solve_queue_ms=ms, mesh_stats=stats,
                kernel=row)


def mesh_residency_phase(np, torch, batch, mesh, kernels, resident,
                         store_cls, svc, tp, world, seed):
    """The residency phase's four generations (the dense slice, float32)
    through the grid: the per-cell resident pool and the grid's version
    chain, g3's promotion through the coordinate scatter; decisions equal
    to the one-card generations, every chain buffer equal to its shadow;
    then coord_scatter against its plain version at g3's shape, timed."""
    cells = [DEVICE] * MESH_CELLS
    lanes = slice2_lanes(np, tp, svc, world, "float32", n_spread=N_EVALS)
    first = batch.fuse_and_solve(lanes, device=DEVICE)[0][0]
    charge = first[:G3_PLACED][first[:G3_PLACED] >= 0]
    resident._reset_for_tests()
    one = run_generations(np, batch, kernels, resident, store_cls, lanes,
                          charge)
    shapes = []
    calls = []
    orig = resident.coord_scatter_cells

    def record(parts, payload, starts):  # noqa: E306
        calls.append(len(parts))
        for part, start in zip(parts, starts):
            shapes.append((tuple(part.shape), int(payload[0].shape[1]),
                           str(part.dtype), tuple(start)))
        return orig(parts, payload, starts)

    resident._reset_for_tests()
    kernels.reset_launches()
    resident.coord_scatter_cells = record
    try:
        gens = run_generations(np, batch, kernels, resident, store_cls,
                               lanes, charge, device=cells)
    finally:
        resident.coord_scatter_cells = orig
    launches = {k.name: k.launches for k in kernels.KERNELS}
    recs = [r for _, r, _ in gens]
    for g, r in enumerate(recs, 1):
        log(f"mesh residency g{g}: " + " ".join(
            f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in r.items()))
    st = resident.stats()
    per_cell: dict = {}
    for row in resident.residency():
        if "cell" in row:
            c = per_cell.setdefault(row["cell"], [0, 0])
            c[0] += 1
            c[1] += row["bytes"]
    log(f"mesh residency launches {launches}; coord scatter shapes "
        f"{sorted(set(shapes))}; per-shard pool: entries="
        f"{st['shard_entries']} bytes={st['shard_resident_bytes']} hwm="
        f"{st['shard_resident_hwm']}; per cell (entries, bytes): "
        f"{per_cell}")
    assert recs[2]["delta_promotions"] > 0 and recs[2]["scatter_launches"] > 0
    # one launch a promoted leaf for all the cells of the card
    assert calls and all(n == MESH_CELLS for n in calls), calls
    assert launches["coord_scatter"] == len(calls), (launches, calls)
    assert launches["delta_scatter"] == 0
    assert recs[3]["delta_gap_fallbacks"] > 0
    assert recs[2]["chain_buffers_checked"] > 0
    for g in range(4):
        same_results(np, gens[g][0], one[g][0], f"mesh residency g{g + 1}")

    # the scatter at g3's shape: a (4, 1) grid's usage table and its
    # bucket, against the plain version; the bound per cell is its slice
    # read and written once plus the whole replicated payload read once
    usage = [x for x in shapes if len(x[0]) == 2 and x[2] == "torch.float32"]
    part_shape, k = max(usage, key=lambda x: x[0][0] * x[0][1])[:2]
    E, n = part_shape[0] * MESH_CELLS, part_shape[1]
    grid = mesh.make_mesh(cells, eval_parallel=MESH_CELLS)
    rng = np.random.default_rng(seed + 80)
    base = rng.standard_normal((E, n)).astype(np.float32)
    sh = mesh.put_by_spec(base, mesh.EN, grid)
    idx = rng.choice(base.size, k - k // 4, replace=False)
    idx_p, vals_p, bucket = resident._pad_updates(
        idx, base.reshape(-1)[idx] + np.float32(1))
    assert bucket == k
    coords = np.ascontiguousarray(np.stack(np.unravel_index(
        idx_p.astype(np.int64), base.shape)).astype(np.int32))
    cut = mesh.cuts(base.shape, mesh.EN, grid)
    parts = [sh.parts[q] for q, _d, _ix in cut]
    starts = [[x.start for x in ix] for _q, _d, ix in cut]
    payload = resident.put_coord_payload(coords, vals_p, torch.device(DEVICE))

    def run(fn):
        return fn(parts, payload, starts)

    got = run(resident.coord_scatter_cells)
    want = run(resident.coord_scatter_cells_plain)
    for gpart, wpart in zip(got, want):
        assert bits_equal(torch, gpart, wpart)
    full = base.copy()
    full.reshape(-1)[idx_p] = vals_p
    assert np.array_equal(torch.cat([x.cpu() for x in got]).numpy(), full)
    ms, dms = call_and_device(torch, lambda: run(resident.coord_scatter_cells))
    plain_ms = timed(torch, lambda: run(resident.coord_scatter_cells_plain),
                     KERNEL_REPEATS)
    # the grid's whole promotion from the host payload: the upload, then
    # the launch
    whole = mesh.mesh_delta_scatter(sh, coords, vals_p)
    assert np.array_equal(whole.cpu().numpy(), full)
    whole_ms, whole_dms = call_and_device(
        torch, lambda: mesh.mesh_delta_scatter(sh, coords, vals_p))
    nbytes = sum(2 * x.numel() * 4 + k * (4 * 2 + 4) for x in parts)
    bound_ms, bound_by = bound("coord_scatter", nbytes, 0, "float32")
    log(f"kernel coord_scatter float32 (4, 1) table ({E}, {n}) k={k}: "
        f"bytes equal to the plain version; ms={ms:.4f} device_ms={dms} "
        f"(4 cells, one launch) plain_ms={plain_ms:.4f} bound_ms="
        f"{bound_ms:.6f} ({bound_by}, {nbytes} B); mesh_delta_scatter from "
        f"the host payload ms={whole_ms:.4f} device_ms={whole_dms}")
    kernel = dict(name="coord_scatter", dtype="float32", shape=[E, n, k],
                  ms=ms, device_ms=dms, plain_ms=plain_ms, bound_ms=bound_ms,
                  bound_by=bound_by, bytes=nbytes, max_abs_err=0.0,
                  whole_ms=whole_ms, whole_device_ms=whole_dms)
    return dict(launches=launches, generations=recs, per_cell=per_cell,
                shard_entries=st["shard_entries"],
                shard_resident_bytes=st["shard_resident_bytes"],
                scatter_shapes=sorted(set(shapes)), kernel=kernel)


# --------------------------------------------------------------------------
# slice 11: the dispatch layer (the guard's deadline and breaker, the solve
# barrier and its pipeline)

DISPATCH_BARRIERS = 4               # barriers of N_EVALS lanes (step 3)
DISPATCH_REPEATS = 1                # runs of step 3 at each depth
DRILL_DEADLINE_S = 0.5              # the fault drill's watchdog deadline
DRILL_ENV = {"NOMAD_TPU_TORCH_DISPATCH_TIMEOUT": str(DRILL_DEADLINE_S),
             "NOMAD_TPU_TORCH_BREAKER_THRESHOLD": "2",
             "NOMAD_TPU_TORCH_BREAKER_BACKOFF": "0.2",
             "NOMAD_TPU_TORCH_BREAKER_BACKOFF_MAX": "1.0",
             "NOMAD_TPU_TORCH_BREAKER_PROBE_TIMEOUT": "120"}


def wait_until(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(1e-4)


def arrived(barrier, k):
    """Has the barrier's k-th lane of its open generation arrived?"""
    with barrier._cv:
        return len(barrier._waiting) >= k


def run_barriers(batch, barriers, lanes, *, in_order=True):
    """Drive ``barriers`` (each with one thread per lane of ``lanes``) at
    once and return (outcomes per barrier, each lane's wait ms, the wall
    ms until every outcome was in, the most pipelined dispatches seen in
    flight). ``in_order``: threads start round-robin over the barriers,
    each after its barrier's previous lane arrived, so every generation
    holds its lanes in input order (the fixpoint breaks priority ties by
    arrival order) and compares with the direct solve of ``lanes``."""
    n = len(lanes)
    outs = [[None] * n for _ in barriers]
    waits = [[None] * n for _ in barriers]

    def work(b, i):
        t0 = time.perf_counter()
        try:
            outs[b][i] = barriers[b].solve(lanes[i])
        except Exception as e:  # noqa: BLE001 -- the caller reads it
            outs[b][i] = e
        finally:
            waits[b][i] = (time.perf_counter() - t0) * 1e3

    peak = [0]
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            peak[0] = max(peak[0], batch.pipeline_state()["in_flight"])
            time.sleep(2e-4)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    threads = []
    t0 = time.perf_counter()
    try:
        for i in range(n):
            for b, bar in enumerate(barriers):
                t = threading.Thread(target=work, args=(b, i), daemon=True)
                t.start()
                threads.append(t)
                if in_order and i < n - 1:
                    wait_until(lambda: arrived(bar, i + 1), 60,
                               f"lane {i} at barrier {b}")
        for t in threads:
            t.join(600)
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        stop.set()
        sampler.join(10)
    assert not any(t.is_alive() for t in threads), "a waiter wedged"
    return outs, waits, wall_ms, peak[0]


def direct_solve(batch, lanes):
    """What a barrier generation must give: fuse_and_solve plus the
    cross-lane fixpoint on a fresh ledger, called directly."""
    res = batch.fuse_and_solve(lanes, device=DEVICE, e_pad_hint=N_EVALS)
    batch._cross_lane_fixpoint(lanes, res, {}, device=DEVICE)
    return res


def outcomes_ok(np, outs, want, what):
    for b, res in enumerate(outs):
        for r in res:
            if isinstance(r, Exception):
                raise AssertionError(f"{what}: barrier {b} raised") from r
        same_results(np, res, want, f"{what} barrier {b}")


def dispatch_phase(np, torch, batch, guard, lpq, kernels, resident, svc,
                   tp, world, card):
    """The dispatch layer at full width (10,000 nodes padded to 16,384,
    float32, 32 eval threads a barrier, e_pad_hint 32):
      1. the guard: the CUDA init probe passes, the breaker is closed;
      2. SolveBarrier at depth 1 and at depth 2 on the headline's 32 wave
         lanes, the dense slice's three groups and the tier-5 windowed
         lanes, each equal to fuse_and_solve plus the fixpoint called
         directly, bit for bit; one LpqBarrier generation under the
         deadline equal to solve_queue;
      3. 4 barriers of the 32 headline lanes at once, at depth 1 and at
         depth 2, 3 runs each: wall time until every result is in, each
         lane's barrier wait, the prepare stages the pipeline ran, the most
         dispatches in flight, the launches; decisions equal at both
         depths and to the direct solve;
      4. the fault drill: a hang at solver.dispatch under a 0.5 s deadline
         and a threshold of 2 gives every waiter DispatchFailed("timeout")
         and trips the breaker (resident set and arena empty); solver.probe
         holds it open; once both faults clear, the real subprocess probe
         closes it (resident set and arena empty again) and the headline
         barrier gives step 2's bits from a fresh upload.
    Fails if a main-path dispatch of steps 1-3 timed out or raised, or if
    the breaker is not closed at the end."""
    import os
    from nomad_tpu_torch.faultinject import faults

    # 1. the guard
    assert guard.backend_available() is True, guard.state()
    st0 = guard.state()
    assert st0["checked"] and st0["ok"], st0
    assert st0["breaker"]["state"] == guard.BREAKER_CLOSED, st0["breaker"]
    log(f"dispatch layer [{card}]: guard checked={st0['checked']} "
        f"ok={st0['ok']} breaker={st0['breaker']['state']} "
        f"dispatch so far {st0['dispatch']}")

    # 2. barriers against the direct solve
    t0 = time.perf_counter()
    head = pack_lanes(np, tp, svc, world, "float32", kind="plain",
                      n_lanes=N_EVALS)
    dense_lanes = slice2_lanes(np, tp, svc, world, "float32",
                               n_spread=N_EVALS)
    windowed = tier5_lanes(np, tp, svc, world, "float32", n_lanes=PW_EVALS,
                           n_place=PW_PLACE)
    matrix, usage, feasible = world
    lp_lanes = [svc.pack_lane_arrays(
        matrix, usage, feasible, ask=ASK, count=LPQ_PLACE,
        n_places=LPQ_PLACE, eval_id=f"lpq-eval-{k:06d}",
        state_index=STATE_INDEX, device=DEVICE) for k in range(N_EVALS)]
    pack_ms = (time.perf_counter() - t0) * 1e3
    inputs = (("wave headline", head), ("dense slice", dense_lanes),
              ("tier-5 windowed", windowed))
    wants, checks, barrier_launches = {}, [], {}
    for what, lanes in inputs:
        t1 = time.perf_counter()
        want = direct_solve(batch, lanes)
        direct_ms = (time.perf_counter() - t1) * 1e3
        wants[what] = want
        for depth in (1, 2):
            bar = batch.SolveBarrier(len(lanes), depth=depth,
                                     e_pad_hint=N_EVALS, device=DEVICE)
            kernels.reset_launches()
            outs, waits, wall_ms, _ = run_barriers(batch, [bar], lanes)
            launches = {k.name: k.launches for k in kernels.KERNELS
                        if k.launches}
            outcomes_ok(np, outs, want, f"{what} depth {depth}")
            if depth == 2:
                for k, v in launches.items():
                    barrier_launches[k] = barrier_launches.get(k, 0) + v
            checks.append(dict(input=what, lanes=len(lanes), depth=depth,
                               wall_ms=wall_ms, direct_ms=direct_ms,
                               wait_ms_median=statistics.median(waits[0]),
                               launches=launches))
            log(f"dispatch layer [{card}]: {what} ({len(lanes)} lanes) "
                f"through SolveBarrier depth {depth}: equal to the direct "
                f"solve bit for bit; wall {wall_ms:.2f} ms (direct "
                f"{direct_ms:.2f} ms), median lane wait "
                f"{statistics.median(waits[0]):.2f} ms; launches {launches}")
    for lane, res in zip(head, wants["wave headline"]):
        check_capacity(np, lane, res[0], lane.batch.ask_cpu.shape[0])
        assert bool(np.all(np.isfinite(res[1])))
    for lane, res in zip(windowed, wants["tier-5 windowed"]):
        check_preempt_lane(np, lane, res[0], res[3],
                           lane.batch.ask_cpu.shape[0])
    t1 = time.perf_counter()
    lp_want = lpq.solve_queue(lp_lanes, {}, device=DEVICE)
    lp_direct_ms = (time.perf_counter() - t1) * 1e3
    lbar = lpq.LpqBarrier(len(lp_lanes), device=DEVICE)
    kernels.reset_launches()
    outs, waits, lp_wall_ms, _ = run_barriers(batch, [lbar], lp_lanes)
    lp_launches = {k.name: k.launches for k in kernels.KERNELS
                   if k.launches}
    outcomes_ok(np, outs, lp_want, "LpqBarrier")
    assert lp_launches.get("lp_relax") == 1, lp_launches
    for k, v in lp_launches.items():
        barrier_launches[k] = barrier_launches.get(k, 0) + v
    log(f"dispatch layer [{card}]: LpqBarrier ({len(lp_lanes)} lanes x "
        f"{LPQ_PLACE}) under the deadline: equal to solve_queue; wall "
        f"{lp_wall_ms:.2f} ms (direct {lp_direct_ms:.2f} ms); launches "
        f"{lp_launches}")

    # 3. pipelining: DISPATCH_BARRIERS barriers of the headline lanes at once
    runs = {1: [], 2: []}
    for _ in range(DISPATCH_REPEATS):
        for depth in (1, 2):
            bars = [batch.SolveBarrier(N_EVALS, depth=depth,
                                       e_pad_hint=N_EVALS, device=DEVICE)
                    for _ in range(DISPATCH_BARRIERS)]
            staged0 = batch.pipeline_state()["staged_total"]
            kernels.reset_launches()
            outs, waits, wall_ms, peak = run_barriers(batch, bars, head)
            launches = {k.name: k.launches for k in kernels.KERNELS
                        if k.launches}
            staged = batch.pipeline_state()["staged_total"] - staged0
            outcomes_ok(np, outs, wants["wave headline"],
                        f"{DISPATCH_BARRIERS} barriers depth {depth}")
            flat = [w for ws in waits for w in ws]
            runs[depth].append(dict(
                wall_ms=wall_ms, wait_ms_median=statistics.median(flat),
                wait_ms_max=max(flat), staged_total=staged,
                peak_in_flight=peak, launches=launches))
    pipeline = {}
    for depth, rs in runs.items():
        med = sorted(rs, key=lambda r: r["wall_ms"])[len(rs) // 2]
        pipeline[depth] = dict(med, wall_ms_all=[r["wall_ms"] for r in rs])
        log(f"dispatch layer [{card}]: {DISPATCH_BARRIERS} barriers x "
            f"{N_EVALS} lanes at depth {depth}: wall until every result "
            f"{med['wall_ms']:.2f} ms (median of {len(rs)}: "
            f"{[round(r['wall_ms'], 2) for r in rs]}); lane wait median "
            f"{med['wait_ms_median']:.2f} ms, max {med['wait_ms_max']:.2f} "
            f"ms; staged_total {med['staged_total']}; most in flight "
            f"{med['peak_in_flight']}; launches {med['launches']}; "
            "decisions equal to the direct solve")
    st1 = guard.state()
    main_timeouts = st1["dispatch"]["timeout"] - st0["dispatch"]["timeout"]
    main_errors = st1["dispatch"]["error"] - st0["dispatch"]["error"]
    if main_timeouts or main_errors:
        raise AssertionError(f"main-path dispatches failed: "
                             f"{main_timeouts} timeouts, {main_errors} "
                             "errors")

    # 4. the fault drill
    saved = {k: os.environ.get(k) for k in DRILL_ENV}
    os.environ.update(DRILL_ENV)
    trips0 = st1["breaker"]["trips"]
    try:
        faults.arm("solver.probe", "error")
        faults.arm("solver.dispatch", "hang")
        half = N_EVALS // 2
        halves = [head[:half], head[half:]]
        bars = [batch.SolveBarrier(half, depth=2, e_pad_hint=N_EVALS,
                                   device=DEVICE) for _ in halves]
        outcomes = [[None] * half for _ in halves]

        def drill(b, i):
            try:
                outcomes[b][i] = bars[b].solve(halves[b][i])
            except Exception as e:  # noqa: BLE001 -- read below
                outcomes[b][i] = e

        threads = [threading.Thread(target=drill, args=(b, i), daemon=True)
                   for b in range(2) for i in range(half)]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        drill_ms = (time.perf_counter() - t1) * 1e3
        assert not any(t.is_alive() for t in threads), "a waiter wedged"
        kinds = {getattr(o, "kind", type(o).__name__)
                 for out in outcomes for o in out}
        assert kinds == {"timeout"}, kinds
        assert all(isinstance(o, guard.DispatchFailed)
                   for out in outcomes for o in out)
        bst = guard.breaker_state()
        assert bst["state"] != guard.BREAKER_CLOSED, bst
        assert bst["trips"] == trips0 + 1, bst
        rs, ar = resident.stats(), batch.arena_state()
        assert rs["entries"] == 0 and rs["chain_entries"] == 0, rs
        assert ar["entries"] == 0, ar
        log(f"dispatch layer [{card}]: hang at solver.dispatch, deadline "
            f"{DRILL_DEADLINE_S} s, threshold 2: all {N_EVALS} waiters got "
            f"DispatchFailed('timeout') in {drill_ms:.1f} ms; breaker "
            f"{bst['state']} (trips {bst['trips']}); resident entries "
            f"{rs['entries']}, arena free entries {ar['entries']}")
        # the hang ends: the abandoned runners finish their dispatches
        faults.disarm("solver.dispatch")
        wait_until(lambda: not any(
            t.name == "dispatch-solver.batch" for t in threading.enumerate()),
            120, "the abandoned dispatch threads")
        # the probe fault clears: the real subprocess probe closes it
        faults.disarm("solver.probe")
        t1 = time.perf_counter()
        wait_until(lambda: guard.breaker_state()["state"]
                   == guard.BREAKER_CLOSED, 300, "the breaker to close")
        recover_s = time.perf_counter() - t1
        bst = guard.breaker_state()
        probe = bst["last_probe"]
        sub = probe["report"].get("subprocess") or {}
        assert probe["ok"] and sub.get("devices", 0) >= 1, probe
        rs, ar = resident.stats(), batch.arena_state()
        assert rs["entries"] == 0 and rs["chain_entries"] == 0, rs
        assert ar["entries"] == 0, ar
        log(f"dispatch layer [{card}]: breaker closed {recover_s:.2f} s "
            f"after the probe fault cleared, through the subprocess probe "
            f"{sub}; recoveries {bst['recoveries']}; resident entries "
            f"{rs['entries']}, arena free entries {ar['entries']}")
    finally:
        faults.disarm_all()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    misses0 = resident.stats()["misses"]
    bar = batch.SolveBarrier(N_EVALS, depth=2, e_pad_hint=N_EVALS,
                             device=DEVICE)
    outs, _, rerun_ms, _ = run_barriers(batch, [bar], head)
    outcomes_ok(np, outs, wants["wave headline"], "after recovery")
    fresh = resident.stats()["misses"] - misses0
    assert fresh > 0, "no fresh upload after the recovery"
    st2 = guard.state()
    assert st2["breaker"]["state"] == guard.BREAKER_CLOSED, st2["breaker"]
    log(f"dispatch layer [{card}]: the headline barrier after recovery: "
        f"step 2's bits, {fresh} fresh uploads, wall {rerun_ms:.2f} ms; "
        f"dispatch counts {st2['dispatch']}; breaker "
        f"{st2['breaker']['state']}")
    return dict(pack_ms=pack_ms, checks=checks, lpq=dict(
        wall_ms=lp_wall_ms, direct_ms=lp_direct_ms, launches=lp_launches),
        pipeline=pipeline, barrier_launches=barrier_launches,
        drill=dict(ms=drill_ms, recover_s=recover_s, probe=sub,
                   trips=bst["trips"], recoveries=bst["recoveries"]),
        fresh_uploads=fresh, dispatch=st2["dispatch"],
        main_timeouts=main_timeouts, main_errors=main_errors)


# --------------------------------------------------------------------------
# phase 13: the structs slice -- Node, Job and Allocation structs in,
# placements out, through TpuPlacementService and the SolveBarrier hook

STRUCT_G2_PLACE = 600               # a second-generation eval's count
STRUCT_SERIAL_EVALS = 4             # evals re-packed alone for host ms
STRUCT_DENSE_EVALS = 8              # two-task-group spread evals
STRUCT_WAVE_SPREAD, STRUCT_PENALTY = 80, 60   # wave_compact lanes' counts
STRUCT_PREEMPT_EVALS, STRUCT_PREEMPT_PLACE = 8, 500
STRUCT_PREEMPT_ASK = (1000, 256, 150)
STRUCT_FILLER_JOBS = 25             # filler jobs a priority tier


def struct_fleet(pmock, n):
    """The headline fleet as Node structs (headline_world's arrays):
    bench-node-%06d, cpu 2000/4000/8000 MHz over 4/8/16 cores and memory
    4096/8192/16384 MB by i % 3, 100 GiB of disk, no reserved
    resources, the default dynamic port range (12,001 free ports);
    meta.rack = i % 10 and meta.zone = (i // 7) % 3 are the spreads'
    and the distinct_property lane's attributes."""
    nodes = []
    for i in range(n):
        node = pmock.node(id=f"bench-node-{i:06d}",
                          name=f"bench-node-{i:06d}")
        cpu = node.node_resources.cpu
        cpu.cpu_shares = (2000, 4000, 8000)[i % 3]
        cpu.total_core_count = (4, 8, 16)[i % 3]
        cpu.reservable_cores = list(range(cpu.total_core_count))
        node.node_resources.memory.memory_mb = (4096, 8192, 16384)[i % 3]
        node.meta = {"rack": str(i % 10), "zone": str((i // 7) % 3)}
        node.compute_class()
        nodes.append(node)
    return nodes


def timed_service_class(svc):
    """TpuPlacementService keeping, for each pack and materialize, the
    host ms on the wall clock (``pack_ms``, ``mat_ms``: with many eval
    threads under one interpreter lock, the others' work is in it) and
    on the calling thread's CPU clock (``pack_cpu_ms``, ``mat_cpu_ms``:
    the eval's own work), the lanes it packed and the solver results it
    materialized."""
    class TimedService(svc.TpuPlacementService):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.lanes, self.results = [], []
            self.pack_ms, self.mat_ms = [], []
            self.pack_cpu_ms, self.mat_cpu_ms = [], []

        def pack(self, *a):
            c0 = time.thread_time()
            lane = super().pack(*a)
            self.pack_cpu_ms.append((time.thread_time() - c0) * 1e3)
            self.lanes.append(lane)
            self.pack_ms.append(self.last_pack[0])
            return lane

        def materialize(self, lane, *res):
            t0, c0 = time.perf_counter(), time.thread_time()
            out = super().materialize(lane, *res)
            self.mat_cpu_ms.append((time.thread_time() - c0) * 1e3)
            self.mat_ms.append((time.perf_counter() - t0) * 1e3)
            self.results.append(res)
            return out
    return TimedService


class InOrderBarrier:
    """A SolveBarrier whose lanes arrive in their threads' ``turn`` order
    (thread-local), so each generation holds its lanes in eval order,
    as run_barriers(in_order=True) arranges for array lanes."""

    def __init__(self, barrier):
        self.barrier = barrier
        self.local = threading.local()

    @property
    def cells(self):
        return self.barrier.cells

    def solve(self, lane):
        k = self.local.turn
        wait_until(lambda: arrived(self.barrier, k), 600, f"eval {k}")
        return self.barrier.solve(lane)


def alloc_of(st, place, job, tg, eval_id):
    """The allocation a scheduler makes of one solved placement."""
    res = place.resources_prebuilt or st.AllocatedResources(
        tasks=place.task_resources,
        shared=place.alloc_resources or st.AllocatedSharedResources(
            disk_mb=tg.ephemeral_disk.size_mb))
    return st.Allocation(
        id=st.generate_uuid(), namespace=job.namespace, eval_id=eval_id,
        name=place.place.name, node_id=place.node.id,
        node_name=place.node.name, job_id=job.id, job=job,
        task_group=tg.name, allocated_resources=res,
        client_status=st.ALLOC_CLIENT_RUNNING, job_version=job.version)


class StructEval(NamedTuple):
    """One eval of the direct hook route: its id, job, service keywords,
    the penalty node of each place (or None), the place names (None: a
    task group's places are its count's names 0 .. count - 1) and the
    allocs its plan stops."""
    eval_id: str
    job: object
    kw: dict
    penalties: Optional[list] = None
    names: Optional[list] = None
    stops: tuple = ()


class _HiddenTable:
    """A snapshot without its alloc table: the placement service then
    packs usage through its incremental route, from the snapshot alone.
    A route compared after its own commits packs so: the table path
    reads the live store's table, which holds them."""

    def __init__(self, snap):
        self.__dict__["_snap"] = snap

    def __getattr__(self, name):
        if name == "alloc_table":
            raise AttributeError(name)
        return getattr(self._snap, name)


def drive_struct_evals(batch, mods, service_cls, snap, evals, barrier,
                       hide_table=False):
    """The direct hook route: one thread per eval (``evals``: StructEval),
    in eval order at the barrier, below any scheduler (no breaker check,
    no reconciler). Each thread builds its
    EvalContext and TimedService and calls the solve hook for each task
    group of its job in turn; a group's placements enter the plan as
    allocations before the next group packs (the last group's are left
    to the caller). With ``hide_table`` the evals read ``snap`` without
    the store's alloc table (_HiddenTable). Returns ([(service,
    [placements per group], [allocs])], wall ms)."""
    st, ctx_cls, place_cls = mods
    if hide_table:
        snap = _HiddenTable(snap)
    ordered = InOrderBarrier(barrier)
    hook = batch.make_solve_hook(ordered)
    ready = snap.ready_nodes_in_pool("default")
    out = [None] * len(evals)

    def work(k):
        eval_id, job, kw, penalties, names, stops = evals[k]
        ordered.local.turn = k
        try:
            plan = st.Plan(eval_id=eval_id, job=job, priority=job.priority)
            for a in stops:
                plan.append_stopped_alloc(a, "stop")
            s = service_cls(ctx_cls(snap, plan), job, False, False, **kw)
            per_tg, allocs = [], []
            for g, tg in enumerate(job.task_groups):
                places = [place_cls(name=n, task_group=tg) for n in (
                    names or [f"{job.id}.{tg.name}[{i}]"
                              for i in range(tg.count)])]
                pen = ([{p} if p else set() for p in penalties]
                       if penalties else None)
                placed = hook(s, tg, places, ready, pen)
                assert placed is not None, f"{eval_id}: host fallback"
                per_tg.append(placed)
                if g == len(job.task_groups) - 1:
                    break
                for p in placed:
                    if p.node is not None:
                        a = alloc_of(st, p, job, tg, eval_id)
                        plan.append_alloc(a)
                        allocs.append(a)
            out[k] = (s, per_tg, allocs)
        except BaseException as e:  # noqa: BLE001 -- raised below
            out[k] = e
        finally:
            barrier.done()

    threads = [threading.Thread(target=work, args=(k,), daemon=True)
               for k in range(len(evals))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(1200)
    wall_ms = (time.perf_counter() - t0) * 1e3
    assert not any(t.is_alive() for t in threads), "an eval thread wedged"
    for k, o in enumerate(out):
        if isinstance(o, BaseException):
            raise AssertionError(f"eval {evals[k].eval_id} failed") from o
    return out, wall_ms


def same_lane(np, a, b, what):
    """Two PackedLanes' tables equal bit for bit (order, const, init,
    batch, ptab, pinit: dtype, shape and bytes)."""
    assert np.array_equal(np.asarray(a.order), np.asarray(b.order)), what
    for name in ("const", "init", "batch", "ptab", "pinit"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), (what, name)
        if x is None:
            continue
        for f in type(x)._fields:
            u, v = np.asarray(getattr(x, f)), np.asarray(getattr(y, f))
            assert (u.dtype == v.dtype and u.shape == v.shape
                    and u.tobytes() == v.tobytes()), (what, name, f)


def check_struct_capacity(np, matrix, used0, placements, ask):
    """No node over capacity: the usage before the generation plus every
    placement's ask (original node order)."""
    pos_of = {nid: i for i, nid in enumerate(matrix.node_ids)}
    pos = np.array([pos_of[p.node.id] for p in placements
                    if p.node is not None], dtype=np.int64)
    k = np.bincount(pos, minlength=matrix.n_pad)
    for cap, used, a in zip((matrix.cpu_cap, matrix.mem_cap,
                             matrix.disk_cap), used0, ask):
        assert bool(np.all(used + k * a <= cap)), "over capacity"


def ms_stats(xs):
    return dict(median=statistics.median(xs), max=max(xs), n=len(xs))


def struct_usage(np, tp, matrix, snap, nodes, job_id="", tg_name=""):
    """A fresh pack_usage fold of the snapshot's live allocs."""
    prop = {n.id: [a for a in snap.allocs_by_node(n.id)
                   if not a.client_terminal_status()] for n in nodes}
    return tp.pack_usage(matrix, prop, job_id, tg_name, "default", nodes)


def first_seen(np, keys, order, n_pad):
    """Per original position, the number of ``keys[i]`` in the order the
    eval's shuffle ``order`` first meets it (-1 on padding): how the
    placement service numbers distinct_property values."""
    num, out = {}, np.full(n_pad, -1, dtype=np.int32)
    for i in order:
        out[i] = num.setdefault(keys[i], len(num))
    return out


def plain_preempt_rows(np, nodes, snap, n_pad):
    """Every node's live allocs as candidate columns (original node
    order, store order within a node, PREEMPT_A columns): MHz, MB, disk
    MB, job priority, migrate max_parallel, a (namespace, job, group) key
    id (-1 pad), the job id and, per node, the allocs themselves; built
    once for every preemption eval."""
    A = PREEMPT_A
    rows = {k: np.zeros((n_pad, A)) for k in ("cpu", "mem", "disk")}
    rows.update(prio=np.zeros((n_pad, A), dtype=np.int32),
                maxp=np.zeros((n_pad, A), dtype=np.int32),
                key=np.full((n_pad, A), -1, dtype=np.int64))
    rows["job"] = np.full((n_pad, A), "", dtype=object)
    rows["allocs"] = []
    keys = {}
    for i, node in enumerate(nodes):
        live = [a for a in snap.allocs_by_node(node.id)
                if not a.terminal_status()]
        assert len(live) <= A, len(live)
        rows["allocs"].append(live)
        for c, a in enumerate(live):
            cr = a.allocated_resources.comparable()
            rows["cpu"][i, c] = cr.cpu_shares
            rows["mem"][i, c] = cr.memory_mb
            rows["disk"][i, c] = cr.disk_mb
            rows["prio"][i, c] = a.job.priority
            atg = a.job.lookup_task_group(a.task_group)
            rows["maxp"][i, c] = (atg.migrate.max_parallel
                                  if atg.migrate is not None else 0)
            rows["key"][i, c] = keys.setdefault(
                (a.namespace, a.job_id, a.task_group), len(keys))
            rows["job"][i, c] = a.job_id
    return rows


def plain_preempt_info(np, tp, rows, job, order, n):
    """A preemption eval's PreemptInfo from ``rows``: candidate groups
    numbered in the eval's shuffled first-seen order (row by row, column
    by column), the eval's own job's allocs invalid, no evictions in
    its plan yet."""
    n_pad, A = rows["key"].shape
    perm = np.r_[np.asarray(order, dtype=np.int64), np.arange(n, n_pad)]
    flat = rows["key"][perm].ravel()
    seen = flat[flat >= 0]
    uniq, first = np.unique(seen, return_index=True)
    lut = np.full(max(int(rows["key"].max()) + 1, 1), -1, dtype=np.int32)
    lut[uniq[np.argsort(first)]] = np.arange(uniq.size, dtype=np.int32)
    key = rows["key"]
    filled = key >= 0
    G = int(2 ** np.ceil(np.log2(max(uniq.size, 4))))
    return tp.PreemptInfo(
        cpu=rows["cpu"], mem=rows["mem"], disk=rows["disk"],
        prio=rows["prio"], maxp=rows["maxp"],
        grp=np.where(filled, lut[np.maximum(key, 0)], -1).astype(np.int32),
        valid=filled & (rows["job"] != job.id), job_prio=job.priority,
        counts=np.zeros(G, dtype=np.int32))


def usage_of(tp, fresh):
    """A pack_usage fold as the six-field UsageState the array route
    takes (no port bitmap)."""
    return tp.UsageState(fresh.used_cpu, fresh.used_mem, fresh.used_disk,
                         fresh.placed_jobtg, fresh.placed_job,
                         fresh.dyn_used)


def same_as_array_route(np, batch, svc, gens, struct_res, barrier_kw, what):
    """Solve the array lanes of each barrier generation in ``gens`` (lists
    of (eval index, group index, lane), in arrival order) through a
    SolveBarrier of their own and require every result, eviction rows
    included, and every placement's node equal the struct route's.
    Returns the array route's barrier wall ms."""
    wall = 0.0
    for g, gen in enumerate(gens):
        lanes = [lane for _, _, lane in gen]
        outs, _, ms, _ = run_barriers(
            batch, [batch.SolveBarrier(len(lanes), device=DEVICE,
                                       **barrier_kw)], lanes)
        wall += ms
        for r in outs[0]:
            if isinstance(r, Exception):
                raise AssertionError(f"{what}: array generation {g}") from r
        same_results(np, [struct_res[e][0].results[t] for e, t, _ in gen],
                     outs[0], f"{what} generation {g}")
        for (e, t, lane), r in zip(gen, outs[0]):
            _, ids = svc.placements(lane, r[0])
            assert ids == [p.node.id if p.node is not None else None
                           for p in struct_res[e][1][t]], (what, e, t)
    return wall


def struct_preempt_store(np, st, pmock, store_cls, nodes):
    """A port StateStore over ``nodes`` whose every node is 95% full of
    cpu (PREEMPT_FILL) with 500 MHz allocs (512 or 1,024 MB, 150 MB
    disk) of STRUCT_FILLER_JOBS priority-10, 20, 30 and 40 jobs each,
    drawn from the seed (at most PREEMPT_A a node). Returns (store, the
    filler allocs)."""
    rng = np.random.default_rng(SEED)
    store = store_cls()
    for node in nodes:
        store.upsert_node(node)
    fillers = {p: [] for p in PREEMPT_PRIOS}
    for p in PREEMPT_PRIOS:
        for k in range(STRUCT_FILLER_JOBS):
            fj = pmock.job(id=f"struct-filler-p{p}-{k:02d}", priority=p)
            fj.task_groups[0].tasks[0].resources.cpu = 500
            store.upsert_job(fj)
            fillers[p].append(fj)
    shared = {m: st.AllocatedResources(
        tasks={"web": st.AllocatedTaskResources(cpu_shares=500,
                                                memory_mb=m)},
        shared=st.AllocatedSharedResources(disk_mb=150))
        for m in (512, 1024)}
    allocs = []
    for i, node in enumerate(nodes):
        target = int(node.node_resources.cpu.cpu_shares * PREEMPT_FILL)
        for k in range(target // 500):
            prio = PREEMPT_PRIOS[int(rng.integers(len(PREEMPT_PRIOS)))]
            fj = fillers[prio][(i + k) % STRUCT_FILLER_JOBS]
            allocs.append(st.Allocation(
                id=f"struct-fill-{i:06d}-{k:02d}", eval_id="fill",
                name=f"{fj.id}.web[{i * 16 + k}]", node_id=node.id,
                job_id=fj.id, job=fj, task_group="web",
                allocated_resources=shared[512 if rng.integers(2)
                                           else 1024],
                client_status=st.ALLOC_CLIENT_RUNNING))
    store.upsert_allocs(allocs)
    return store, allocs


def structs_phase(np, torch, batch, guard, kernels, svc, tp, world, card):
    """The structs slice (phase 13): the port's Node, Job and Allocation
    structs in, placements out, through TpuPlacementService and the
    SolveBarrier hook (batch.make_solve_hook), float32 on the card:
      1. the headline (32 service evals x 2,000 placements of mock.job
         over the 10,000 nodes as Node structs in a port StateStore), two
         generations: the first's placements are written to the store as
         Allocations (32 journaled writes), then 32 new evals x 600 (what
         the fleet's remaining cpu holds) pack against the new snapshot
         (the usage base caught up through the journal). Pack and
         materialize are also timed alone, for the first 4 evals again. Every struct
         lane equals the lane pack_lane_arrays builds from the arrays
         (headline_world; the second generation's usage a fresh
         pack_usage fold) for the same eval id and index, bit for bit;
         every placement equals that lane's through a SolveBarrier of
         array lanes; every placement holds the ask and no node is over
         capacity;
      2. dense and wave_compact lanes from structs, one barrier, with the
         headline's allocs deleted again: 8
         two-group spread evals (count 2,000 each, the dense scan; the
         second group packs against the first's placements in its plan,
         at the same snapshot and node order), a distinct_property lane
         (${meta.rack} limit 25, 200 placements, a dynamic port each) and
         a reserved-core lane (2 cores, 200 placements), a wave spread
         lane (count 80) and a reschedule-penalty lane (count 60);
         checks capacity, cores and the distinct_property limit per
         lane, cores within the node's reservable set, ports in its
         dynamic range; every lane equals, bit for bit, the lane
         pack_lane_arrays builds from arrays (the spreads, the
         distinct_property values in the eval's shuffled first-seen
         order, the cores, the penalties; a second group's usage a
         pack_usage fold of the first group's allocs), and every
         result that lane's through a SolveBarrier of array lanes in
         the same two generations;
      3. one system job over the fleet through solve_system, equal to
         solve_system_arrays on the same snapshot's usage;
      4. preemption: the fleet in a second store, 95% of every node's cpu
         held by priority 10-40 allocs of other jobs (A = 16), 8 evals x
         500 of a priority-70 job (preempt=True, no device asks) through
         the barrier; every preempted alloc is on the chosen node, 10 or
         more priority levels below and of another job, none evicted
         twice in an eval, no node over capacity after the evictions;
         every lane equals the array lane whose PreemptInfo is built
         from the same snapshot's allocs, every result (eviction rows
         included) that lane's through a SolveBarrier of array lanes,
         and every placement's preempted allocs are the candidates its
         eviction row names.
    Launch counts are read around each struct route alone (``launches``:
    the kernels line's structs_launches); the array routes that the
    checks compare with run outside them. No hook may fall back to the
    host, and no dispatch may fail or time out."""
    import copy
    from nomad_tpu_torch import mock as pmock
    from nomad_tpu_torch import structs as st
    from nomad_tpu_torch.scheduler.context import EvalContext
    from nomad_tpu_torch.scheduler.reconcile import AllocPlaceResult
    from nomad_tpu_torch.scheduler.util import shuffled_order
    from nomad_tpu_torch.state.store import StateStore

    st.reseed_ids(SEED)
    mods = (st, EvalContext, AllocPlaceResult)
    Timed = timed_service_class(svc)
    kw = {"device": DEVICE, "dtype": "float32"}
    matrix, zero_usage, feasible = world
    g0 = guard.state()

    t0 = time.perf_counter()
    nodes = struct_fleet(pmock, N_NODES)
    store = StateStore()
    for node in nodes:
        store.upsert_node(node)
    fleet_s = time.perf_counter() - t0
    tp.reset_pack_caches()
    launches = {k.name: 0 for k in kernels.KERNELS}

    def counted(fn):
        kernels.reset_launches()
        out = fn()
        for k in kernels.KERNELS:
            launches[k.name] += k.launches
        return out

    def summary(name, res, wall_ms, n_placed):
        out = dict(evals=len(res), placements=n_placed, wall_ms=wall_ms,
                   placements_per_s=n_placed / (wall_ms / 1e3))
        for key in ("pack_ms", "pack_cpu_ms", "mat_ms", "mat_cpu_ms"):
            out[key] = ms_stats([x for s, _, _ in res
                                 for x in getattr(s, key)])
        log(f"structs {name} [{card}]: {len(res)} evals, {n_placed} "
            f"placements, wall {wall_ms:.1f} ms, "
            f"{out['placements_per_s']:.0f} placements/s; ms per eval "
            "(median / max), wall clock and thread CPU: pack "
            f"{out['pack_ms']['median']:.2f} / {out['pack_ms']['max']:.2f}"
            f", cpu {out['pack_cpu_ms']['median']:.2f} / "
            f"{out['pack_cpu_ms']['max']:.2f}; materialize "
            f"{out['mat_ms']['median']:.2f} / {out['mat_ms']['max']:.2f}"
            f", cpu {out['mat_cpu_ms']['median']:.2f} / "
            f"{out['mat_cpu_ms']['max']:.2f}")
        return out

    # -- 1. the headline, two generations ------------------------------
    report = {"fleet_s": fleet_s}
    used0 = (zero_usage.used_cpu, zero_usage.used_mem, zero_usage.used_disk)
    usage = zero_usage
    for g, count in ((1, N_PLACE), (2, STRUCT_G2_PLACE)):
        jobs = []
        for e in range(N_EVALS):
            j = pmock.job(id=f"struct-g{g}-job-{e:02d}")
            j.task_groups[0].count = count
            store.upsert_job(j)
            jobs.append(j)
        snap = store.snapshot()
        evals = [StructEval(f"struct-bench-eval-g{g}-{e:016d}", jobs[e],
                            kw) for e in range(N_EVALS)]
        barrier = batch.SolveBarrier(N_EVALS, e_pad_hint=N_EVALS,
                                     device=DEVICE)
        res, wall_ms = counted(lambda: drive_struct_evals(
            batch, mods, Timed, snap, evals, barrier))
        placed = [p for _, per_tg, _ in res for p in per_tg[0]]
        n_placed = sum(p.node is not None for p in placed)
        assert n_placed == N_EVALS * count, n_placed
        for p in placed:
            assert p.task_resources["web"].cpu_shares == ASK[0]
            assert p.task_resources["web"].memory_mb == ASK[1]
            assert p.alloc_resources.disk_mb == ASK[2]
        check_struct_capacity(np, matrix, used0, placed, ASK)
        # the same evals as array lanes: equal tables, equal placements
        arr = [svc.pack_lane_arrays(
            matrix, usage, feasible, ask=ASK, count=count,
            n_places=count, eval_id=evals[e][0],
            state_index=snap.latest_index(), dtype_name="float32",
            device=DEVICE) for e in range(N_EVALS)]
        for e, (s, _, _) in enumerate(res):
            same_lane(np, s.lanes[0], arr[e], f"g{g} eval {e}")
        outs, _, arr_wall, _ = run_barriers(
            batch, [batch.SolveBarrier(N_EVALS, e_pad_hint=N_EVALS,
                                       device=DEVICE)], arr)
        same_results(np, [s.results[0][:3] for s, _, _ in res], outs[0],
                     f"structs headline g{g}")
        for e, (s, per_tg, _) in enumerate(res):
            _, ids = svc.placements(arr[e], outs[0][e][0])
            assert ids == [p.node.id if p.node is not None else None
                           for p in per_tg[0]], f"g{g} eval {e}"
        gen = summary(f"headline g{g}", res, wall_ms, n_placed)
        gen["array_wall_ms"] = arr_wall
        gen["pack_cache"] = tp.pack_cache_stats()
        # the host ms of pack and materialize with no other eval thread
        # running: the first evals again, one at a time, on the same
        # snapshot (every memo warm) and results
        alone = Timed(EvalContext(snap, st.Plan(
            eval_id=evals[0][0], job=jobs[0])), jobs[0], False, False,
            **kw)
        for e in range(STRUCT_SERIAL_EVALS):
            alone.ctx.plan = st.Plan(eval_id=evals[e][0], job=jobs[e])
            alone.job = jobs[e]
            tg = jobs[e].task_groups[0]
            places = [AllocPlaceResult(name=f"{jobs[e].id}.web[{i}]",
                                       task_group=tg) for i in range(count)]
            lane = alone.pack(tg, places, snap.ready_nodes_in_pool(
                "default"), None)
            alone.materialize(lane, *res[e][0].results[0])
        gen["alone"] = dict(pack_ms=ms_stats(alone.pack_ms),
                            mat_ms=ms_stats(alone.mat_ms))
        log(f"structs headline g{g} [{card}]: pack cache "
            f"{gen['pack_cache']}; the array lanes' barrier wall "
            f"{arr_wall:.1f} ms; {STRUCT_SERIAL_EVALS} evals alone: pack "
            f"ms median {gen['alone']['pack_ms']['median']:.2f}, "
            f"materialize {gen['alone']['mat_ms']['median']:.2f}")
        report[f"headline_g{g}"] = gen
        if g == 2:
            # the second generation packed its usage from the store's
            # alloc table: the fold kept on the matrix is the table's at
            # its version, equal to a fresh fold of the snapshot
            fold = res[0][0].lanes[0].matrix.__dict__["_fold_cache"]
            assert fold[0] is snap.alloc_table
            assert fold[1] == snap.alloc_table.version
            for a, b in zip((fold[2]["used_cpu"], fold[2]["used_mem"],
                             fold[2]["used_disk"]), used0):
                assert np.array_equal(a, b), "table fold != fresh fold"
            break
        # the first generation's placements become the store's allocs
        t1 = time.perf_counter()
        g1_allocs = [alloc_of(st, p, jobs[e], jobs[e].task_groups[0],
                              evals[e][0])
                     for e, (_, per_tg, _) in enumerate(res)
                     for p in per_tg[0]]
        t2 = time.perf_counter()
        for e in range(N_EVALS):
            store.upsert_allocs(g1_allocs[e * count:(e + 1) * count])
        report["write_g1"] = dict(build_ms=(t2 - t1) * 1e3,
                                  upsert_ms=(time.perf_counter() - t2) * 1e3)
        g1_ids = [a.id for a in g1_allocs]
        snap_w = store.snapshot()
        fresh = struct_usage(np, tp, matrix, snap_w, nodes)
        usage = tp.UsageState(fresh.used_cpu, fresh.used_mem,
                              fresh.used_disk, fresh.placed_jobtg,
                              fresh.placed_job, fresh.dyn_used)
        used0 = (fresh.used_cpu, fresh.used_mem, fresh.used_disk)
        log(f"structs headline [{card}]: {len(g1_allocs)} Allocations "
            f"built in {report['write_g1']['build_ms']:.1f} ms, written "
            f"in {N_EVALS} journaled writes in "
            f"{report['write_g1']['upsert_ms']:.1f} ms")

    # -- 2. dense and wave_compact lanes from structs ------------------
    # on the emptied fleet again (one journaled write)
    store.delete_allocs(g1_ids)
    def spread_tg(tg, name, count):
        tg = copy.deepcopy(tg)
        tg.name, tg.count = name, count
        tg.spreads = [st.Spread(attribute="${meta.rack}", weight=50),
                      st.Spread(attribute="${meta.zone}", weight=50,
                                spread_target=[
                                    st.SpreadTarget("0", 50),
                                    st.SpreadTarget("1", 30),
                                    st.SpreadTarget("2", 20)])]
        return tg

    evals = []
    for e in range(STRUCT_DENSE_EVALS):
        j = pmock.job(id=f"struct-dense-job-{e:02d}")
        tg0 = j.task_groups[0]
        j.task_groups = [spread_tg(tg0, "web", N_PLACE),
                         spread_tg(tg0, "api", N_PLACE)]
        evals.append(StructEval(f"struct-dense-eval-{e:04d}", j, kw))
    dpj = pmock.job(id="struct-distinct-property")
    dpj.task_groups[0].count = DP_PLACE
    dpj.task_groups[0].constraints = [st.Constraint(
        l_target="${meta.rack}", r_target=str(DP_LIMIT),
        operand="distinct_property")]
    dpj.task_groups[0].networks = [st.NetworkResource(
        dynamic_ports=[st.Port(label="http")])]
    evals.append(StructEval("struct-dense-eval-distinct-prop", dpj, kw))
    cj = pmock.job(id="struct-reserved-cores")
    cj.task_groups[0].count = CORES_PLACE
    cj.task_groups[0].tasks[0].resources.cores = CORES_ASK
    evals.append(StructEval("struct-dense-eval-reserved-cores", cj, kw))
    wj = pmock.job(id="struct-wave-spread")
    wj.task_groups[0] = spread_tg(wj.task_groups[0], "web",
                                  STRUCT_WAVE_SPREAD)
    evals.append(StructEval("struct-wave-eval-spread", wj, kw))
    pj = pmock.job(id="struct-wave-penalty")
    pj.task_groups[0].count = STRUCT_PENALTY
    evals.append(StructEval(
        "struct-wave-eval-penalty", pj, kw,
        [nodes[(37 * k) % N_NODES].id if k % 3 == 0 else None
         for k in range(STRUCT_PENALTY)]))
    for ev in evals:
        store.upsert_job(ev.job)
    snap = store.snapshot()
    fresh = struct_usage(np, tp, matrix, snap, nodes)
    used_d = (fresh.used_cpu, fresh.used_mem, fresh.used_disk)
    barrier = batch.SolveBarrier(len(evals), device=DEVICE)
    before = dict(guard.state()["resident"])
    res, wall_ms = counted(lambda: drive_struct_evals(
        batch, mods, Timed, snap, evals, barrier))
    after = guard.state()["resident"]
    chain = {k: after[k] - before.get(k, 0) for k in
             ("delta_promotions", "delta_reuses", "delta_fallbacks",
              "delta_size_fallbacks", "delta_gap_fallbacks", "hits",
              "misses")}
    n_placed = 0
    for (s, per_tg, _), ev in zip(res, evals):
        job = ev.job
        for lane, r, placed in zip(s.lanes, s.results, per_tg):
            n = lane.batch.ask_cpu.shape[0]
            if lane.wavefront_ok():
                check_capacity_lane(np, lane, r[0], n)
            else:
                check_dense_lane(np, lane, r[0], n)
            n_placed += sum(p.node is not None for p in placed)
            cores_of = {}
            ports_of = {}
            for p in placed:
                nr = p.node.node_resources
                tr = p.task_resources["web"] if p.task_resources else None
                if tr is not None and tr.reserved_cores:
                    assert len(tr.reserved_cores) == CORES_ASK
                    assert set(tr.reserved_cores) <= set(
                        nr.cpu.reservable_cores)
                    held = cores_of.setdefault(p.node.id, set())
                    assert not held & set(tr.reserved_cores), "core twice"
                    held.update(tr.reserved_cores)
                    assert tr.cpu_shares == (nr.cpu.cpu_shares
                                             // nr.cpu.total_core_count
                                             * CORES_ASK)
                if job is dpj:
                    (pm,) = p.alloc_resources.ports
                    assert (nr.min_dynamic_port <= pm.value
                            <= nr.max_dynamic_port), pm
                    held = ports_of.setdefault(p.node.id, set())
                    assert pm.value not in held, "port twice"
                    held.add(pm.value)
        if job is cj:
            assert cores_of, "no reserved cores came back"
        if job is dpj:
            assert ports_of, "no ports came back"
    # the same lanes from arrays: each eval's first group in the first
    # barrier generation, the spread evals' second groups (their usage
    # a pack_usage fold of the first group's allocs) in the second
    n_nodes, n_pad = matrix.n_real, matrix.n_pad
    index = snap.latest_index()
    usage_d = usage_of(tp, fresh)
    cores = np.zeros(n_pad, dtype=np.int32)
    mhz = np.zeros(n_pad)
    for i, node in enumerate(nodes):
        c = node.node_resources.cpu
        cores[i] = len(set(c.reservable_cores)
                       - set(node.reserved_resources.cores))
        mhz[i] = c.cpu_shares // c.total_core_count
    gens = [[], []]
    for e, (ev, (_, _, g1)) in enumerate(zip(evals, res)):
        eval_id, job, pen = ev.eval_id, ev.job, ev.penalties
        tg = job.task_groups[0]
        base = dict(feasible=feasible, ask=ASK, count=tg.count,
                    n_places=tg.count, eval_id=eval_id, state_index=index,
                    penalty_node_ids=pen, plan_priority=job.priority,
                    dtype_name="float32", device=DEVICE)
        if tg.spreads:
            base["spread_info"] = spread_info(np, tp, matrix, tg.count)
        if job is dpj:
            order = shuffled_order(eval_id, index, n_nodes)
            racks = [node.meta["rack"] for node in nodes]
            base.update(n_dyn_ports=1, distinct_property=(
                tp.DistinctPropertyInfo(
                    value_index=first_seen(np, racks, order, n_pad)[None],
                    limit=np.array([DP_LIMIT]), tg_scope=np.array([True]),
                    counts=np.zeros((1, 16), np.int32))))
        if job is cj:
            base.update(ask=(0.0, ASK[1], ASK[2]), ask_cores=CORES_ASK,
                        mhz_per_core=mhz, cores_free=cores)
        gens[0].append((e, 0, svc.pack_lane_arrays(matrix, usage_d,
                                                   **base)))
        if len(job.task_groups) == 2:
            prop = {}
            for a in g1:
                prop.setdefault(a.node_id, []).append(a)
            usage_2 = usage_of(tp, tp.pack_usage(
                matrix, prop, job.id, job.task_groups[1].name, "default",
                nodes))
            gens[1].append((e, 1, svc.pack_lane_arrays(matrix, usage_2,
                                                       **base)))
    for gen in gens:
        for e, t, lane in gen:
            same_lane(np, res[e][0].lanes[t], lane, f"dense eval {e} tg {t}")
    arr_wall = same_as_array_route(np, batch, svc, gens, res, {},
                                   "structs dense")
    dense = summary("dense and wave_compact", res, wall_ms, n_placed)
    dense["chain"] = chain
    dense["array_wall_ms"] = arr_wall
    log(f"structs dense [{card}]: the resident chain across the two "
        f"spread groups: {chain}")
    report["dense"] = dense

    # -- 3. a system job through solve_system --------------------------
    sj = pmock.system_job(id="struct-system")
    stg = sj.task_groups[0]
    stg.tasks[0].resources.cpu = int(SYSTEM_ASK[0])
    stg.tasks[0].resources.memory_mb = int(SYSTEM_ASK[1])
    stg.ephemeral_disk.size_mb = int(SYSTEM_ASK[2])
    store.upsert_job(sj)
    snap = store.snapshot()
    ready = snap.ready_nodes_in_pool("default")
    sys_eval = "struct-system-eval-0001"
    s = Timed(EvalContext(snap, st.Plan(eval_id=sys_eval, job=sj,
                                        priority=sj.priority)),
              sj, False, False, **kw)
    t1 = time.perf_counter()
    placed = counted(lambda: s.solve_system(stg, ready))
    sys_ms = (time.perf_counter() - t1) * 1e3
    assert placed is not None and len(placed) == N_NODES
    fresh = struct_usage(np, tp, matrix, snap, nodes, sj.id, stg.name)
    _, chosen, scores = svc.solve_system_arrays(
        matrix, fresh, feasible, ask=SYSTEM_ASK, eval_id=sys_eval,
        state_index=snap.latest_index(), dtype_name="float32",
        device=DEVICE)
    same_lane(np, s.lanes[0], svc.pack_lane_arrays(
        matrix, fresh, feasible, ask=SYSTEM_ASK, count=1,
        n_places=N_NODES, eval_id=sys_eval,
        state_index=snap.latest_index(), dtype_name="float32",
        device=DEVICE), "system")
    want, got = s.results[0], (chosen, scores)
    assert np.array_equal(want[0], got[0]), "system chosen"
    assert np.array_equal(want[1], got[1]), "system scores"
    n_sys = sum(p.node is not None for p in placed)
    assert n_sys > 0
    for k, p in enumerate(placed):
        if p.node is not None:
            assert p.node.id == nodes[k].id
    report["system"] = dict(placements=n_sys, ms=sys_ms,
                            pack_ms=s.pack_ms[0], mat_ms=s.mat_ms[0])
    log(f"structs system [{card}]: {n_sys} of {N_NODES} nodes, "
        f"{sys_ms:.1f} ms structs in to placements out (pack "
        f"{s.pack_ms[0]:.2f} ms, materialize {s.mat_ms[0]:.2f} ms)")

    # -- 4. preemption --------------------------------------------------
    pstore, allocs = struct_preempt_store(np, st, pmock, StateStore, nodes)
    evals = []
    for e in range(STRUCT_PREEMPT_EVALS):
        j = pmock.job(id=f"struct-preempt-job-{e:02d}",
                      priority=PREEMPT_JOB_PRIO)
        tg = j.task_groups[0]
        tg.count = STRUCT_PREEMPT_PLACE
        tg.tasks[0].resources.cpu = STRUCT_PREEMPT_ASK[0]
        tg.tasks[0].resources.memory_mb = STRUCT_PREEMPT_ASK[1]
        tg.ephemeral_disk.size_mb = STRUCT_PREEMPT_ASK[2]
        pstore.upsert_job(j)
        evals.append(StructEval(f"struct-preempt-eval-{e:04d}", j,
                                dict(kw, preempt=True)))
    psnap = pstore.snapshot()
    base = tp.fold_usage_base(matrix, nodes, psnap.allocs_by_node,
                              with_ports=False)
    barrier = batch.SolveBarrier(len(evals), e_pad_hint=len(evals),
                                 device=DEVICE)
    res, wall_ms = counted(lambda: drive_struct_evals(
        batch, mods, Timed, psnap, evals, barrier))
    n_placed = n_evicted = 0
    pos_of = {nid: i for i, nid in enumerate(matrix.node_ids)}
    for (s, per_tg, _), ev in zip(res, evals):
        job = ev.job
        lane = s.lanes[0]
        assert lane.ptab is not None and lane.ptab.cpu.shape[1] == \
            PREEMPT_A, lane.ptab.cpu.shape
        used = np.stack([base["used_cpu"], base["used_mem"],
                         base["used_disk"]]).copy()
        seen = set()
        for p in per_tg[0]:
            if p.node is None:
                continue
            n_placed += 1
            b = pos_of[p.node.id]
            used[:, b] += STRUCT_PREEMPT_ASK
            for a in p.preempted_allocs or ():
                assert a.node_id == p.node.id, "evicted elsewhere"
                assert job.priority - a.job.priority >= 10, "priority"
                assert a.job_id != job.id, "own job evicted"
                assert a.id not in seen, "evicted twice"
                seen.add(a.id)
                cr = a.allocated_resources.comparable()
                used[:, b] -= (cr.cpu_shares, cr.memory_mb, cr.disk_mb)
        n_evicted += len(seen)
        cap = np.stack([matrix.cpu_cap, matrix.mem_cap, matrix.disk_cap])
        assert bool((used <= cap).all()), "over capacity after evictions"
    assert n_placed == STRUCT_PREEMPT_EVALS * STRUCT_PREEMPT_PLACE
    assert n_evicted > 0
    # the same lanes from arrays: the candidates of the same snapshot,
    # one barrier generation, eviction rows included
    rows = plain_preempt_rows(np, nodes, psnap, matrix.n_pad)
    usage_p = usage_of(tp, struct_usage(np, tp, matrix, psnap, nodes))
    index = psnap.latest_index()
    gen = []
    for e, ev in enumerate(evals):
        eval_id, job = ev.eval_id, ev.job
        order = shuffled_order(eval_id, index, matrix.n_real)
        lane = svc.pack_lane_arrays(
            matrix, usage_p, feasible, ask=STRUCT_PREEMPT_ASK,
            count=STRUCT_PREEMPT_PLACE, n_places=STRUCT_PREEMPT_PLACE,
            eval_id=eval_id, state_index=index, order=order,
            preemption=plain_preempt_info(np, tp, rows, job, order,
                                          matrix.n_real),
            plan_priority=job.priority, dtype_name="float32",
            device=DEVICE)
        same_lane(np, res[e][0].lanes[0], lane, f"preemption eval {e}")
        gen.append((e, 0, lane))
    arr_wall = same_as_array_route(np, batch, svc, [gen], res,
                                   {"e_pad_hint": len(evals)},
                                   "structs preemption")
    # the allocs each placement preempts are the candidates its eviction
    # row names on its node
    for e, _, lane in gen:
        r = res[e][0].results[0]
        for p, (b, cols) in zip(res[e][1][0],
                                svc.evictions(lane, r[0], r[3])):
            want = [rows["allocs"][b][c].id for c in cols] if b >= 0 else []
            assert [a.id for a in p.preempted_allocs or ()] == want, e
    pre = summary("preemption", res, wall_ms, n_placed)
    pre["array_wall_ms"] = arr_wall
    pre["evicted"] = n_evicted
    pre["allocs"] = len(allocs)
    report["preempt"] = pre
    log(f"structs preemption [{card}]: {len(allocs)} filler allocs, "
        f"{n_evicted} evicted")

    g1 = guard.state()
    report["host_fallbacks"] = (g1["host_fallback_dispatches"]
                                - g0["host_fallback_dispatches"])
    report["failed_dispatches"] = {
        k: g1["dispatch"][k] - g0["dispatch"][k]
        for k in ("timeout", "error")}
    assert report["host_fallbacks"] == 0, report["host_fallbacks"]
    assert not any(report["failed_dispatches"].values()), \
        report["failed_dispatches"]
    report["pack_cache"] = tp.pack_cache_stats()
    report["launches"] = launches
    log(f"structs [{card}]: launches {launches}; pack cache "
        f"{report['pack_cache']}")
    for kname in ("wave_block", "wave_compact", "dense_scan", "system_fit",
                  "wave_preempt"):
        assert launches[kname] >= 1, (kname, launches)
    return report


# --------------------------------------------------------------------------
# phase 14: the scheduler -- an Evaluation in, a committed plan out,
# through the port's Harness and its GenericScheduler / SystemScheduler,
# the placement service and the barrier hooks

SCHED_G2_COUNT = N_PLACE + STRUCT_G2_PLACE   # the headline jobs scaled
SCHED_SPREAD_JOBS, SCHED_SPREAD_COUNT = 4, 500   # two-group spread jobs
SCHED_PENALTY_COUNT, SCHED_PENALTY_FAILED = 60, 20
SCHED_STICKY_COUNT = 4
SCHED_LPQ_EVALS, SCHED_LPQ_PLACE = 32, 8
SCHED_SECTIONS = ("reconcile", "pack", "pack_cpu", "wait", "materialize",
                  "submit_plan", "eval")


class SchedRoute:
    """The scheduler route's instruments, on the host clock, per eval:
    the reconciler (AllocReconciler.compute), pack and materialize
    (phase 13's TimedService, swapped in for TpuPlacementService while
    the route runs), the barrier wait (``ordered``), submit_plan (the
    Harness) and the whole eval (Harness.process). ``services`` holds
    each eval's TimedService by eval id."""

    def __init__(self, svc, generic, harness_cls):
        route = self
        self.ms = {k: [] for k in SCHED_SECTIONS}
        self.services = {}
        self._svc, self._generic = svc, generic

        class Service(timed_service_class(svc)):
            def __init__(self, ctx, *a, **kw):
                super().__init__(ctx, *a, **kw)
                route.services[ctx.plan.eval_id] = self

        class Reconciler(generic.AllocReconciler):
            def compute(self):
                t0 = time.perf_counter()
                out = super().compute()
                route.ms["reconcile"].append(
                    (time.perf_counter() - t0) * 1e3)
                return out

        class TimedHarness(harness_cls):
            def submit_plan(self, plan):
                t0 = time.perf_counter()
                out = super().submit_plan(plan)
                route.ms["submit_plan"].append(
                    (time.perf_counter() - t0) * 1e3)
                return out

        self.Service, self.Reconciler = Service, Reconciler
        self.Harness = TimedHarness
        self._saved = None

    def __enter__(self):
        self._saved = (self._svc.TpuPlacementService,
                       self._generic.AllocReconciler)
        self._svc.TpuPlacementService = self.Service
        self._generic.AllocReconciler = self.Reconciler
        return self

    def __exit__(self, *exc):
        (self._svc.TpuPlacementService,
         self._generic.AllocReconciler) = self._saved

    def reset(self):
        for v in self.ms.values():
            v.clear()
        self.services.clear()

    def ordered(self, barrier):
        """An InOrderBarrier over ``barrier`` whose solves are timed."""
        route = self

        class Ordered(InOrderBarrier):
            def solve(self, lane):
                t0 = time.perf_counter()
                try:
                    return super().solve(lane)
                finally:
                    route.ms["wait"].append(
                        (time.perf_counter() - t0) * 1e3)
        return Ordered(barrier)

    def sections(self):
        out = {}
        for k, xs in self.ms.items():
            if k in ("pack", "pack_cpu", "materialize"):
                key = {"pack": "pack_ms", "pack_cpu": "pack_cpu_ms",
                       "materialize": "mat_ms"}[k]
                xs = [x for sv in self.services.values()
                      for x in getattr(sv, key)]
            if xs:
                out[k] = dict(ms_stats(xs), sum=sum(xs))
        return out


def sched_eval(st, job, eval_id, trigger=None):
    return st.Evaluation(
        id=eval_id, namespace=job.namespace, priority=job.priority,
        type=job.type, job_id=job.id, status=st.EVAL_STATUS_PENDING,
        triggered_by=trigger or st.TRIGGER_JOB_REGISTER)


def drive_scheduler(route, harness, kind, evals, ordered=None, hook=None):
    """One thread per eval, each running harness.process(kind, ev) on the
    card (with ``hook`` as its solve hook, arriving at ``ordered`` in
    eval order). Every eval must return no error. Returns the wall ms,
    Evaluation in to plan committed."""
    out = [None] * len(evals)

    def work(k):
        if ordered is not None:
            ordered.local.turn = k
        kw = {"device": DEVICE}
        if hook is not None:
            kw["solve_hook"] = hook
        t0 = time.perf_counter()
        try:
            out[k] = harness.process(kind, evals[k], **kw)
        except BaseException as e:  # noqa: BLE001 -- raised below
            out[k] = e
        finally:
            route.ms["eval"].append((time.perf_counter() - t0) * 1e3)
            if ordered is not None:
                ordered.barrier.done()

    threads = [threading.Thread(target=work, args=(k,), daemon=True)
               for k in range(len(evals))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(1200)
    wall_ms = (time.perf_counter() - t0) * 1e3
    assert not any(t.is_alive() for t in threads), "an eval thread wedged"
    for ev, o in zip(evals, out):
        if isinstance(o, BaseException):
            raise AssertionError(f"eval {ev.id} raised") from o
        assert o is None, (ev.id, o)
    return wall_ms


def committed(harness, eval_ids, rows=False):
    """Per eval id: {alloc name: (node id, normalized-score bits,
    [ids of the allocs it preempts])} over the eval's plans (with
    ``rows``, a list of (alloc name, node id, score bits) in plan
    order: a system job's allocs share one name), and the eval's last
    update."""
    if rows:
        out = {e: [] for e in eval_ids}
        for plan in harness.plans:
            if plan.eval_id in out:
                out[plan.eval_id] += [
                    (a.name, nid, struct_score_bits(
                        a.metrics.scores[f"{nid}.normalized-score"]))
                    for nid, allocs in plan.node_allocation.items()
                    for a in allocs]
        return out, {ev.id: ev for ev in harness.evals if ev.id in out}
    out = {e: {} for e in eval_ids}
    for plan in harness.plans:
        if plan.eval_id not in out:
            continue
        evicts = {}
        for allocs in plan.node_preemptions.values():
            for a in allocs:
                evicts.setdefault(a.preempted_by_allocation, []).append(a.id)
        for nid, allocs in plan.node_allocation.items():
            for a in allocs:
                score = a.metrics.scores.get(f"{nid}.normalized-score")
                out[plan.eval_id][a.name] = (
                    nid, None if score is None else
                    struct_score_bits(score), evicts.get(a.id, []))
    last = {ev.id: ev for ev in harness.evals if ev.id in out}
    return out, last


def struct_score_bits(x):
    """A score's float64 bytes (bit-for-bit comparison)."""
    return struct.pack("<d", float(x))


def direct_map(res, evals):
    """The direct route's placements in committed()'s form."""
    out = {}
    for ev, (_, per_tg, _) in zip(evals, res):
        m = out.setdefault(ev.eval_id, {})
        for placed in per_tg:
            for p in placed:
                if p.node is not None:
                    m[p.place.name] = (p.node.id, struct_score_bits(p.score),
                                       [a.id for a in
                                        p.preempted_allocs or ()])
    return out


def same_as_direct(np, route, res, evals, got, what):
    """The scheduler route's lanes equal the direct route's bit for bit,
    and so do its committed placements, scores and evictions."""
    want = direct_map(res, evals)
    for ev, (s, _, _) in zip(evals, res):
        eval_id = ev.eval_id
        mine = route.services[eval_id]
        assert len(mine.lanes) == len(s.lanes), (what, eval_id)
        for t, (a, b) in enumerate(zip(mine.lanes, s.lanes)):
            same_lane(np, a, b, f"{what} {eval_id} tg {t}")
        assert got[eval_id] == want[eval_id], (what, eval_id)


def check_complete(last, evals):
    """Every eval complete; a job-register eval with 0 queued (a
    reschedule's places are not counted as queued, as upstream's
    reconciler counts them, so its committed ones take it below 0)."""
    for ev in evals:
        upd = last[ev.id]
        assert upd.status == "complete", (ev.id, upd.status,
                                          upd.status_description)
        if ev.triggered_by == "job-register":
            assert all(v == 0 for v in upd.queued_allocations.values()), \
                (ev.id, upd.queued_allocations)


def scheduler_phase(np, torch, batch, guard, lpq, kernels, svc, tp, world,
                    card):
    """The scheduler (phase 14): Evaluations in, committed plans out,
    through the port's Harness (scheduler/harness.py) and its
    GenericScheduler or SystemScheduler, each eval on its own thread
    with the SolveBarrier hook (batch.make_solve_hook) or the LP tier's
    (lpq.make_lpq_hook), float32 on the card; the reconciler, the
    stack, the breaker check and submit_plan (upsert_plan_results) all
    run. Each step is held against phase 13's direct hook route (or
    solve_system, or LpqBarrier) on the same eval ids and snapshot:
      1. the headline, generation 1: phase 13's fleet (10,000 Node
         structs) in a port StateStore with tpu-binpack, 32 mock.job
         service evals x 2,000 (job-register) -- every eval complete
         with 0 queued, 64,000 allocs committed, every lane and every
         placement (alloc name -> node, normalized-score bits) equal to
         the direct route's;
      2. generation 2: the same 32 jobs scaled to 2,600 in the store
         (the same version: the reconciler reads each job's 2,000 allocs
         and places 600 more, names 2,000-2,599); the usage base caught
         up through the journal the 32 commits wrote, equal to a fresh
         fold; no node over capacity after the commits;
      3. a system job through SystemScheduler (the system fit) over the
         filled fleet, system preemption off (a full node fails, as in
         tests/test_system_tpu.py): its placements and scores equal
         solve_system's;
      4. the mixed barrier, on a fresh store over the fleet: a penalty
         job (60) and a sticky-disk job (4) placed through the solo
         dispatch, then 20 and 1 of their allocs failed; the sticky
         job's reschedule falls back to the host stack (GenericStack)
         onto its node: the guard's count of host-stack places rises
         by 1 (its count of host-fallback evals stays 0 in the phase);
         then one barrier of 4 two-group spread jobs (500 each group:
         dense, the second group promotes through the delta scatter), a
         distinct_property job with a dynamic port, a reserved-core job
         and the penalty job's reschedule (20 places, each with its
         failed node as the penalty: the compact kernel); equal to the
         direct route with the same places and plan stops;
      5. preemption: phase 13's tier-5 store (83,328 priority 10-40
         allocs) with service preemption on, 8 x 500 priority-70 evals;
         placements and eviction rows equal the direct route's;
      6. the LP tier: 32 tpu-lpq evals x 8 through make_lpq_hook and
         one LpqBarrier; every result equal to a fresh LpqBarrier's on
         the same lanes, and the committed placements to them.
    Launch counts are read around the scheduler routes alone
    (``launches``: the kernels line's scheduler_launches); the host
    fallback count rises by exactly 1 over the phase, and no dispatch
    fails."""
    import copy
    from nomad_tpu_torch import mock as pmock
    from nomad_tpu_torch import structs as st
    from nomad_tpu_torch.scheduler import generic
    from nomad_tpu_torch.scheduler.context import EvalContext
    from nomad_tpu_torch.scheduler.harness import Harness
    from nomad_tpu_torch.scheduler.reconcile import AllocPlaceResult
    from nomad_tpu_torch.state.store import StateStore

    st.reseed_ids(SEED + 14)
    mods = (st, EvalContext, AllocPlaceResult)
    Timed = timed_service_class(svc)
    # the schedulers' dtype is the device's default (float32 on the card),
    # and so is the direct route's
    kw = {"device": DEVICE}
    matrix, _zero, _feasible = world
    g0 = guard.state()
    launches = {k.name: 0 for k in kernels.KERNELS}
    report = {}

    def counted(fn):
        kernels.reset_launches()
        try:
            return fn()
        finally:
            for k in kernels.KERNELS:
                launches[k.name] += k.launches

    def fleet_store(cfg):
        store = StateStore()
        for node in nodes:
            store.upsert_node(node)
        store.set_scheduler_config(cfg)
        return store

    def summary(name, route, wall_ms, n_placed, evals):
        sec = route.sections()
        out = dict(evals=len(evals), placements=n_placed, wall_ms=wall_ms,
                   placements_per_s=n_placed / (wall_ms / 1e3),
                   sections=sec)
        log(f"scheduler {name} [{card}]: {len(evals)} evals, {n_placed} "
            f"placements committed, wall {wall_ms:.1f} ms (Evaluation in "
            f"to plan committed), {out['placements_per_s']:.0f} "
            "placements/s; ms per eval, median / max / sum: "
            + "; ".join(f"{k} {v['median']:.2f} / {v['max']:.2f} / "
                        f"{v['sum']:.1f}" for k, v in sec.items()))
        return out

    nodes = struct_fleet(pmock, N_NODES)
    tp.reset_pack_caches()
    route = SchedRoute(svc, generic, Harness)
    with route:
        # -- 1-2. the headline, two generations ------------------------
        # (system preemption off: the system job's full nodes fail
        # instead of evicting through the host stack)
        store = fleet_store(st.SchedulerConfiguration(
            scheduler_algorithm=st.SCHED_ALG_TPU_BINPACK,
            preemption_config=st.PreemptionConfig(
                system_scheduler_enabled=False)))
        h = route.Harness(store)
        jobs = []
        for e in range(N_EVALS):
            j = pmock.job(id=f"sched-job-{e:02d}")
            j.task_groups[0].count = N_PLACE
            store.upsert_job(j)
            jobs.append(j)
        for g, count in ((1, N_PLACE), (2, SCHED_G2_COUNT)):
            if g == 2:
                # scaled in the store at the same version: the g1 allocs
                # stay current and the reconciler places the rest
                for j in jobs:
                    j.task_groups[0].count = count
            snap = store.snapshot()
            evals = [sched_eval(st, j, f"sched-bench-eval-g{g}-{e:016d}")
                     for e, j in enumerate(jobs)]
            route.reset()
            barrier = batch.SolveBarrier(N_EVALS, e_pad_hint=N_EVALS,
                                         device=DEVICE)
            ordered = route.ordered(barrier)
            wall_ms = counted(lambda: drive_scheduler(
                route, h, "service", evals, ordered,
                batch.make_solve_hook(ordered)))
            got, last = committed(h, [ev.id for ev in evals])
            check_complete(last, evals)
            new = count - (N_PLACE if g == 2 else 0)
            for ev, j in zip(evals, jobs):
                assert route.services[ev.id].ctx.state is snap
                names = {f"{j.id}.web[{i}]" for i in range(count - new,
                                                           count)}
                assert set(got[ev.id]) == names, (ev.id, len(got[ev.id]))
            n_placed = sum(len(m) for m in got.values())
            assert n_placed == N_EVALS * new, n_placed
            live = [a for j in jobs
                    for a in store.allocs_by_job(j.namespace, j.id)]
            assert len(live) == N_EVALS * count, len(live)
            gen = summary(f"headline g{g}", route, wall_ms, n_placed,
                          evals)
            gen["pack_cache"] = tp.pack_cache_stats()
            # the direct hook route on the same snapshot and eval ids
            dev = [StructEval(ev.id, j, kw, names=[
                f"{j.id}.web[{i}]" for i in range(count - new, count)])
                   for ev, j in zip(evals, jobs)]
            res, gen["direct_wall_ms"] = drive_struct_evals(
                batch, mods, Timed, snap, dev, batch.SolveBarrier(
                    N_EVALS, e_pad_hint=N_EVALS, device=DEVICE),
                hide_table=True)
            same_as_direct(np, route, res, dev, got, f"headline g{g}")
            if g == 2:
                # usage from the store's alloc table, its fold equal to
                # a fresh fold of the snapshot the evals read
                fold = route.services[evals[0].id].lanes[0] \
                    .matrix.__dict__["_fold_cache"]
                assert fold[0] is snap.alloc_table
                fresh = struct_usage(np, tp, matrix, snap, nodes)
                for a, b in zip((fold[2]["used_cpu"], fold[2]["used_mem"],
                                 fold[2]["used_disk"]),
                                (fresh.used_cpu, fresh.used_mem,
                                 fresh.used_disk)):
                    assert np.array_equal(a, b), "table fold != fresh fold"
            report[f"headline_g{g}"] = gen
        after = struct_usage(np, tp, matrix, store.snapshot(), nodes)
        for cap, used in ((matrix.cpu_cap, after.used_cpu),
                          (matrix.mem_cap, after.used_mem),
                          (matrix.disk_cap, after.used_disk)):
            assert bool(np.all(used <= cap)), "over capacity"

        # -- 3. a system job through SystemScheduler -------------------
        sj = pmock.system_job(id="sched-system")
        stg = sj.task_groups[0]
        stg.tasks[0].resources.cpu = int(SYSTEM_ASK[0])
        stg.tasks[0].resources.memory_mb = int(SYSTEM_ASK[1])
        stg.ephemeral_disk.size_mb = int(SYSTEM_ASK[2])
        store.upsert_job(sj)
        snap = store.snapshot()
        ev = sched_eval(st, sj, "sched-system-eval-0001")
        route.reset()
        wall_ms = counted(lambda: drive_scheduler(route, h, "system", [ev]))
        got, last = committed(h, [ev.id], rows=True)
        check_complete(last, [ev])
        by_node = {nid: score for _, nid, score in got[ev.id]}
        ds = Timed(EvalContext(_HiddenTable(snap), st.Plan(
            eval_id=ev.id, job=sj, priority=sj.priority)), sj, False,
            False, **kw)
        direct = ds.solve_system(stg, snap.ready_nodes_in_pool(
            sj.node_pool))
        want = {p.node.id: struct_score_bits(p.score) for p in direct
                if p.node is not None}
        assert by_node == want and len(got[ev.id]) == len(by_node)
        assert len(want) > 0
        same_lane(np, route.services[ev.id].lanes[0], ds.lanes[0], "system")
        same_results(np, route.services[ev.id].results, ds.results,
                     "system")
        report["system"] = dict(summary("system", route, wall_ms,
                                        len(want), [ev]),
                                failed_nodes=N_NODES - len(want))

        # -- 4. the mixed barrier, and a sticky disk's host fallback ---
        mstore = fleet_store(st.SchedulerConfiguration(
            scheduler_algorithm=st.SCHED_ALG_TPU_BINPACK))
        mh = route.Harness(mstore)
        penalty_job = pmock.job(id="sched-penalty")
        penalty_job.task_groups[0].count = SCHED_PENALTY_COUNT
        sticky_job = pmock.job(id="sched-sticky")
        sticky_job.task_groups[0].count = SCHED_STICKY_COUNT
        sticky_job.task_groups[0].ephemeral_disk.sticky = True
        first = []
        for j in (penalty_job, sticky_job):
            mstore.upsert_job(j)
            first.append(sched_eval(st, j, f"sched-first-{j.id}"))
        route.reset()
        counted(lambda: drive_scheduler(route, mh, "service", first))
        check_complete(committed(mh, [e.id for e in first])[1], first)

        def fail(allocs):
            out = []
            for a in allocs:
                b = copy.copy(a)
                b.client_status = st.ALLOC_CLIENT_FAILED
                b.client_terminal_time = time.time() - 3600
                out.append(b)
            mstore.upsert_allocs(out)
            return out
        failed = fail(mstore.allocs_by_job(
            "default", penalty_job.id)[:SCHED_PENALTY_FAILED])
        sticky_failed = fail(mstore.allocs_by_job(
            "default", sticky_job.id)[1:2])[0]

        # the sticky place: the host stack, back onto its node
        fb0 = guard.state()["placements_host_fallback"]
        ev = sched_eval(st, sticky_job, "sched-sticky-resched",
                        st.TRIGGER_RETRY_FAILED_ALLOC)
        route.reset()
        counted(lambda: drive_scheduler(route, mh, "service", [ev]))
        got, last = committed(mh, [ev.id])
        check_complete(last, [ev])
        (name, (nid, _, _)), = got[ev.id].items()
        assert name == sticky_failed.name and nid == sticky_failed.node_id
        assert not route.services[ev.id].lanes, "the sticky place packed"
        fell_back = guard.state()["placements_host_fallback"] - fb0
        assert fell_back == 1, fell_back
        sticky_rep = dict(host_places=fell_back,
                          eval_ms=route.ms["eval"][0])

        mixed = []
        for e in range(SCHED_SPREAD_JOBS):
            j = pmock.job(id=f"sched-spread-{e:02d}")
            tg0 = j.task_groups[0]
            j.task_groups = []
            for name in ("web", "api"):
                tg = copy.deepcopy(tg0)
                tg.name, tg.count = name, SCHED_SPREAD_COUNT
                tg.spreads = [st.Spread(attribute="${meta.rack}", weight=50),
                              st.Spread(attribute="${meta.zone}", weight=50,
                                        spread_target=[
                                            st.SpreadTarget("0", 50),
                                            st.SpreadTarget("1", 30),
                                            st.SpreadTarget("2", 20)])]
                j.task_groups.append(tg)
            mixed.append(j)
        dpj = pmock.job(id="sched-distinct-property")
        dpj.task_groups[0].count = DP_PLACE
        dpj.task_groups[0].constraints = [st.Constraint(
            l_target="${meta.rack}", r_target=str(DP_LIMIT),
            operand="distinct_property")]
        dpj.task_groups[0].networks = [st.NetworkResource(
            dynamic_ports=[st.Port(label="http")])]
        cj = pmock.job(id="sched-reserved-cores")
        cj.task_groups[0].count = CORES_PLACE
        cj.task_groups[0].tasks[0].resources.cores = CORES_ASK
        mixed += [dpj, cj]
        for j in mixed:
            mstore.upsert_job(j)
        evals = [sched_eval(st, j, f"sched-mixed-eval-{k:02d}")
                 for k, j in enumerate(mixed)]
        evals.append(sched_eval(st, penalty_job, "sched-mixed-eval-resched",
                                st.TRIGGER_RETRY_FAILED_ALLOC))
        msnap = mstore.snapshot()
        route.reset()
        barrier = batch.SolveBarrier(len(evals), device=DEVICE)
        ordered = route.ordered(barrier)
        # the one-group evals commit while the two-group evals pack their
        # second group; through the store's alloc table (the live table,
        # as the reference reads it) those packs would see the commits
        # when they land first, so here every eval packs from its
        # snapshot alone, as the direct route compared below does
        real_snapshot = mstore.snapshot
        mstore.snapshot = lambda: _HiddenTable(real_snapshot())
        try:
            wall_ms = counted(lambda: drive_scheduler(
                route, mh, "service", evals, ordered,
                batch.make_solve_hook(ordered)))
        finally:
            del mstore.snapshot
        ids = [e.id for e in evals]
        got, last = committed(mh, ids)
        check_complete(last, evals)
        n_placed = sum(len(m) for m in got.values())
        assert n_placed == (SCHED_SPREAD_JOBS * 2 * SCHED_SPREAD_COUNT
                            + DP_PLACE + CORES_PLACE
                            + SCHED_PENALTY_FAILED), n_placed
        resched = got[evals[-1].id]
        assert sorted(resched) == sorted(a.name for a in failed)
        dev = [StructEval(ev.id, j, kw) for ev, j in zip(evals, mixed)]
        dev.append(StructEval(evals[-1].id, penalty_job, kw,
                              [a.node_id for a in failed],
                              names=[a.name for a in failed],
                              stops=failed))
        res, direct_ms = drive_struct_evals(
            batch, mods, Timed, msnap, dev,
            batch.SolveBarrier(len(dev), device=DEVICE), hide_table=True)
        same_as_direct(np, route, res, dev, got, "mixed")
        mixed_rep = summary("mixed barrier", route, wall_ms, n_placed,
                            evals)
        mixed_rep["direct_wall_ms"] = direct_ms
        report["mixed"] = mixed_rep
        report["sticky"] = sticky_rep

        # -- 5. preemption ---------------------------------------------
        pstore, fill = struct_preempt_store(np, st, pmock, StateStore, nodes)
        pstore.set_scheduler_config(st.SchedulerConfiguration(
            scheduler_algorithm=st.SCHED_ALG_TPU_BINPACK,
            preemption_config=st.PreemptionConfig(
                service_scheduler_enabled=True)))
        ph = route.Harness(pstore)
        pjobs = []
        for e in range(STRUCT_PREEMPT_EVALS):
            j = pmock.job(id=f"sched-preempt-job-{e:02d}",
                          priority=PREEMPT_JOB_PRIO)
            tg = j.task_groups[0]
            tg.count = STRUCT_PREEMPT_PLACE
            tg.tasks[0].resources.cpu = STRUCT_PREEMPT_ASK[0]
            tg.tasks[0].resources.memory_mb = STRUCT_PREEMPT_ASK[1]
            tg.ephemeral_disk.size_mb = STRUCT_PREEMPT_ASK[2]
            pstore.upsert_job(j)
            pjobs.append(j)
        psnap = pstore.snapshot()
        evals = [sched_eval(st, j, f"sched-preempt-eval-{e:04d}")
                 for e, j in enumerate(pjobs)]
        route.reset()
        barrier = batch.SolveBarrier(len(evals), e_pad_hint=len(evals),
                                     device=DEVICE)
        ordered = route.ordered(barrier)
        wall_ms = counted(lambda: drive_scheduler(
            route, ph, "service", evals, ordered,
            batch.make_solve_hook(ordered)))
        got, last = committed(ph, [e.id for e in evals])
        check_complete(last, evals)
        n_placed = sum(len(m) for m in got.values())
        n_evicted = sum(len(v[2]) for m in got.values()
                        for v in m.values())
        assert n_placed == STRUCT_PREEMPT_EVALS * STRUCT_PREEMPT_PLACE
        assert n_evicted > 0
        dev = [StructEval(ev.id, j, dict(kw, preempt=True))
               for ev, j in zip(evals, pjobs)]
        res, direct_ms = drive_struct_evals(
            batch, mods, Timed, psnap, dev, batch.SolveBarrier(
                len(dev), e_pad_hint=len(dev), device=DEVICE),
            hide_table=True)
        same_as_direct(np, route, res, dev, got, "preemption")
        pre = summary("preemption", route, wall_ms, n_placed, evals)
        pre.update(direct_wall_ms=direct_ms, evicted=n_evicted,
                   allocs=len(fill))
        report["preempt"] = pre

        # -- 6. the LP tier --------------------------------------------
        lstore = fleet_store(st.SchedulerConfiguration(
            scheduler_algorithm=st.SCHED_ALG_TPU_LPQ))
        lh = route.Harness(lstore)
        ljobs = []
        for e in range(SCHED_LPQ_EVALS):
            j = pmock.job(id=f"sched-lpq-job-{e:02d}")
            j.task_groups[0].count = SCHED_LPQ_PLACE
            lstore.upsert_job(j)
            ljobs.append(j)
        evals = [sched_eval(st, j, f"sched-lpq-eval-{e:04d}")
                 for e, j in enumerate(ljobs)]
        route.reset()
        barrier = lpq.LpqBarrier(len(evals), device=DEVICE)
        ordered = route.ordered(barrier)
        wall_ms = counted(lambda: drive_scheduler(
            route, lh, "tpu-lpq", evals, ordered,
            lpq.make_lpq_hook(ordered)))
        got, last = committed(lh, [e.id for e in evals])
        check_complete(last, evals)
        lanes = [route.services[ev.id].lanes[0] for ev in evals]
        assert all(lpq.lp_lane_eligible(lane) for lane in lanes)
        outs, _, direct_ms, _ = run_barriers(
            batch, [lpq.LpqBarrier(len(lanes), device=DEVICE)], lanes)
        for r in outs[0]:
            if isinstance(r, Exception):
                raise AssertionError("direct LpqBarrier raised") from r
        same_results(np, [route.services[ev.id].results[0]
                          for ev in evals], outs[0], "scheduler lp tier")
        n_placed = 0
        for ev, lane, r in zip(evals, lanes, outs[0]):
            _, node_ids = svc.placements(lane, r[0])
            want = {p.name: nid for p, nid in zip(lane.places, node_ids)
                    if nid is not None}
            assert {k: v[0] for k, v in got[ev.id].items()} == want, ev.id
            n_placed += len(want)
        assert n_placed > 0
        lp = summary("lp tier", route, wall_ms, n_placed, evals)
        lp["direct_wall_ms"] = direct_ms
        report["lpq"] = lp

    g1 = guard.state()
    report["host_fallbacks"] = (g1["host_fallback_dispatches"]
                                - g0["host_fallback_dispatches"])
    report["host_places"] = (g1["placements_host_fallback"]
                             - g0["placements_host_fallback"])
    report["failed_dispatches"] = {
        k: g1["dispatch"][k] - g0["dispatch"][k]
        for k in ("timeout", "error")}
    assert report["host_fallbacks"] == 0, report["host_fallbacks"]
    assert report["host_places"] == 1, report["host_places"]
    assert not any(report["failed_dispatches"].values()), \
        report["failed_dispatches"]
    report["pack_cache"] = tp.pack_cache_stats()
    report["launches"] = launches
    log(f"scheduler [{card}]: launches {launches}; host-fallback evals "
        f"{report['host_fallbacks']}; host-stack places "
        f"{report['host_places']} (the sticky place); pack cache "
        f"{report['pack_cache']}")
    for kname in ("wave_block", "wave_compact", "dense_scan", "system_fit",
                  "wave_preempt", "lp_relax", "delta_scatter"):
        assert launches[kname] >= 1, (kname, launches)
    return report


# --------------------------------------------------------------------------
# phase 15: the server -- a registered job in, verified and committed
# placements out, through the port's Server: EvalBroker, BatchWorker,
# GenericScheduler, SolveBarrier, the kernels, materialize, the Planner's
# verify and group commit, the StateStore

SERVER_WIDTH = 32                    # the batch workers' width
SERVER_LPQ_EVALS, SERVER_LPQ_PLACE = 32, 8
SERVER_SETTLE_S = 600


class ServerRoute:
    """The server route's instruments, on the host clock: per eval the
    wait for the store's index (block_until), the whole invoke
    (invoke_scheduler) and submit_plan (queue wait, verify and commit);
    the applier's verify (_evaluate_plan: the pre-pass and the per-node
    checks) and commits (_commit_one, _commit_group: their ms, plans and
    end time); the broker's acks and nacks. With ``order`` (eval id ->
    turn) the barrier hooks (batch.make_solve_hook, lpq.make_lpq_hook)
    hand each eval's lane to its barrier in turn order, as phase 14's
    InOrderBarrier does, so a generation holds its lanes in eval order
    and compares with the Harness route's. Installed on enter, restored
    on exit: enter it before the server starts, as a worker binds its
    barrier hook when it enters a dequeue."""

    PER_EVAL = ("wait_for_index", "invoke", "submit_plan")
    KEYS = ("verify", "commit")

    def __init__(self, server, worker_mod, batch, lpq):
        self.server, self.worker_mod = server, worker_mod
        self.batch, self.lpq = batch, lpq
        self.order = {}
        self.local = threading.local()
        self.reset()

    COUNTERS = ("batches_committed", "plans_rejected",
                "cross_worker_serialized")

    def reset(self):
        self.ms = {k: [] for k in self.KEYS}
        self.per = {k: {} for k in self.PER_EVAL}
        self.groups, self.commit_end = [], []
        self.acks = self.nacks = 0
        # the eval ids acked and nacked: the leader's own evals (the
        # deployment watcher's) go through the broker beside the step's
        self.acked, self.nacked = [], []
        self.counters0 = {k: getattr(self.server.planner, k)
                          for k in self.COUNTERS}

    def _timed(self, key, fn, after=None):
        route = self

        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
            finally:
                t1 = time.perf_counter()
                route.ms[key].append((t1 - t0) * 1e3)
            if after is not None:
                after(a, t1)
            return out
        return run

    def _per_eval(self, key, fn):
        """``fn`` timed into the eval its thread runs (set by the timed
        invoke_scheduler), summed per eval id: a commit wakes many
        waiters at once, so the evals' calls end in no fixed order."""
        route = self

        def run(*a, **kw):
            if key == "invoke":
                route.local.eval_id = a[1].id
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                ms = (time.perf_counter() - t0) * 1e3
                eid = getattr(route.local, "eval_id", None)
                if eid is not None:
                    per = route.per[key]
                    per[eid] = per.get(eid, 0.0) + ms
                if key == "invoke":
                    route.local.eval_id = None
        return run

    def _ordered(self, make):
        route = self

        def make_hook(barrier):
            ob = InOrderBarrier(barrier)
            inner = make(ob)

            def hook(service, *a):
                ob.local.turn = route.order[service.ctx.plan.eval_id]
                return inner(service, *a)
            return hook
        return make_hook

    def __enter__(self):
        s, w, p = self.server, self.worker_mod, self.server.planner
        b = s.broker
        self._saved = (w.invoke_scheduler, w.WorkerPlanner.submit_plan,
                       self.batch.make_solve_hook, self.lpq.make_lpq_hook)
        w.invoke_scheduler = self._per_eval("invoke", w.invoke_scheduler)
        w.WorkerPlanner.submit_plan = self._per_eval(
            "submit_plan", w.WorkerPlanner.submit_plan)
        self.batch.make_solve_hook = self._ordered(self.batch.make_solve_hook)
        self.lpq.make_lpq_hook = self._ordered(self.lpq.make_lpq_hook)
        s.state.block_until = self._per_eval("wait_for_index",
                                             s.state.block_until)
        p._evaluate_plan = self._timed("verify", p._evaluate_plan)
        p._commit_one = self._timed(
            "commit", p._commit_one,
            lambda a, t: (self.groups.append(1), self.commit_end.append(t)))
        p._commit_group = self._timed(
            "commit", p._commit_group,
            lambda a, t: (self.groups.append(len(a[0])),
                          self.commit_end.append(t)))
        ack, nack = b.ack, b.nack

        def counted_ack(*a):
            self.acks += 1
            self.acked.append(a[0])
            return ack(*a)

        def counted_nack(*a):
            self.nacks += 1
            self.nacked.append(a[0])
            return nack(*a)
        b.ack, b.nack = counted_ack, counted_nack
        return self

    def __exit__(self, *exc):
        w = self.worker_mod
        (w.invoke_scheduler, w.WorkerPlanner.submit_plan,
         self.batch.make_solve_hook, self.lpq.make_lpq_hook) = self._saved
        for obj, names in ((self.server.state, ("block_until",)),
                           (self.server.planner, ("_evaluate_plan",
                                                  "_commit_one",
                                                  "_commit_group")),
                           (self.server.broker, ("ack", "nack"))):
            for name in names:
                obj.__dict__.pop(name, None)

    def summary(self, name, card, t0, n_placed, n_evals, sched):
        """The step's numbers: wall ms from the evals' write to the last
        commit, placements/s, per eval wait-for-index / scheduler (the
        invoke less those two) / submit_plan, the applier's split, acks
        and nacks, and phase 14's pack and materialize sections."""
        wall_ms = (max(self.commit_end) - t0) * 1e3
        ms, per = self.ms, self.per
        if self.order:
            # the step's evals only (not the leader's own)
            per = {k: {e: v for e, v in d.items() if e in self.order}
                   for k, d in per.items()}
        sched_ms = [inv - per["wait_for_index"].get(e, 0.0)
                    - per["submit_plan"].get(e, 0.0)
                    for e, inv in per["invoke"].items()]
        planner = self.server.planner
        out = dict(evals=n_evals, placements=n_placed, wall_ms=wall_ms,
                   placements_per_s=n_placed / (wall_ms / 1e3),
                   per_eval={k: dict(ms_stats(v), sum=sum(v)) for k, v in
                             (("wait_for_index",
                               list(per["wait_for_index"].values())),
                              ("scheduler", sched_ms),
                              ("submit_plan",
                               list(per["submit_plan"].values()))) if v},
                   applier=dict(
                       verify_ms=sum(ms["verify"]),
                       verify_per_plan=(ms_stats(ms["verify"])
                                        if ms["verify"] else None),
                       commit_ms=sum(ms["commit"]),
                       commits=len(ms["commit"]), group_sizes=self.groups,
                       **{k: getattr(planner, k) - self.counters0[k]
                          for k in self.COUNTERS}),
                   acked=self.acks, nacked=self.nacks,
                   acked_of_step=(sum(e in self.order for e in self.acked)
                                  if self.order else self.acks),
                   sections=sched.sections())
        a = out["applier"]
        log(f"server {name} [{card}]: {n_evals} evals, {n_placed} "
            f"placements committed, wall {wall_ms:.1f} ms (evals written "
            f"to the last plan committed), {out['placements_per_s']:.0f} "
            "placements/s; ms per eval, median / max / sum: "
            + "; ".join(f"{k} {v['median']:.2f} / {v['max']:.2f} / "
                        f"{v['sum']:.1f}"
                        for k, v in out["per_eval"].items())
            + f"; applier: verify {a['verify_ms']:.1f} ms over "
            f"{len(ms['verify'])} plans, commit {a['commit_ms']:.1f} ms in "
            f"{a['commits']} commits (plans a commit {self.groups}), "
            f"batches_committed {a['batches_committed']}, plans_rejected "
            f"{a['plans_rejected']}, cross-worker serializations "
            f"{a['cross_worker_serialized']}; acked {self.acks}, nacked "
            f"{self.nacks}; sections "
            + "; ".join(f"{k} {v['median']:.2f} / {v['max']:.2f}"
                        for k, v in out["sections"].items()))
        return out


def server_allocs(store, eval_ids):
    """Per eval id: {alloc name: (node id, normalized-score bits, [])} of
    the store's live allocs (committed()'s form)."""
    out = {e: {} for e in eval_ids}
    for a in store.allocs():
        if a.eval_id in out and not a.terminal_status():
            out[a.eval_id][a.name] = (
                a.node_id, struct_score_bits(
                    a.metrics.scores[f"{a.node_id}.normalized-score"]), [])
    return out


def settle(server, eval_ids, what, extra=None):
    """Wait (SERVER_SETTLE_S at most) until every eval left pending and
    the broker holds nothing ready or leased."""
    def done():
        st = server.broker.stats()
        if st["total_ready"] or st["total_unacked"]:
            return False
        if any(server.state.eval_by_id(e).status == "pending"
               for e in eval_ids):
            return False
        return extra is None or extra()
    wait_until(done, SERVER_SETTLE_S, what)


def server_phase(np, torch, batch, guard, lpq, kernels, svc, tp, world,
                 card):
    """The server (phase 15): the port's Server (server/core.py) on the
    card, float32, tpu-binpack, its store holding phase 13's fleet;
    every step held against another route on the same store writes:
      1. the headline: 32 mock.job service jobs x 2,000, their 32 evals
         written and enqueued in one call, so one BatchWorker (width 32)
         dequeues all of them into one SolveBarrier; every eval complete
         and 64,000 allocs committed by the plan applier (verified
         against the latest state, group-committed), no plan rejected
         (the barrier's fixpoint settled every conflict), no node over
         capacity; placements (alloc name -> node, normalized-score
         bits) equal to phase 14's Harness route on a store built by
         the same writes in the same order (the index seeds the
         shuffle);
      2. the LP tier: apply_scheduler_config to tpu-lpq and a leadership
         restart (one batch worker); 32 evals x 8 through _run_lpq_batch
         and one LpqBarrier, equal to a direct LpqBarrier on the same
         lanes;
      3. a system job through register_job: its eval through the worker
         to SystemScheduler (the system fit), equal to solve_system on
         the snapshot the scheduler read;
      4. the blocked drill: a one-node store with room for one alloc,
         two jobs in one batch: one placed, the other's eval blocked;
         register_node adds a node, BlockedEvals.unblock releases the
         eval and it is placed; no node over capacity.
    A generation's lanes reach its barrier in eval order (ServerRoute),
    so the fixpoint breaks ties as the compared route does. Launch
    counts are read around the server's runs alone (``launches``: the
    kernels line's server_launches); no eval falls back to the host and
    no dispatch fails."""
    import copy
    from nomad_tpu_torch import mock as pmock
    from nomad_tpu_torch import structs as st
    from nomad_tpu_torch.scheduler import generic
    from nomad_tpu_torch.scheduler.context import EvalContext
    from nomad_tpu_torch.scheduler.harness import Harness
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.server import worker as worker_mod
    from nomad_tpu_torch.state.store import StateStore

    st.reseed_ids(SEED + 15)
    Timed = timed_service_class(svc)
    matrix = world[0]
    g0 = guard.state()
    launches = {k.name: 0 for k in kernels.KERNELS}
    report = {}
    nodes = struct_fleet(pmock, N_NODES)

    def cfg(alg):
        # system preemption off: the system job's full nodes fail, as in
        # phase 14
        return st.SchedulerConfiguration(
            scheduler_algorithm=alg, preemption_config=st.PreemptionConfig(
                system_scheduler_enabled=False))

    def make_jobs(prefix, n, count):
        jobs = []
        for e in range(n):
            j = pmock.job(id=f"{prefix}-{e:02d}")
            j.task_groups[0].count = count
            jobs.append(j)
        return jobs

    def fleet_store(jobs):
        store = StateStore()
        for node in nodes:
            store.upsert_node(node)
        store.set_scheduler_config(cfg(st.SCHED_ALG_TPU_BINPACK))
        for j in jobs:
            store.upsert_job(j)
        return store

    def count_launches():
        for k in kernels.KERNELS:
            launches[k.name] += k.launches

    def run(route, server, evals, n_allocs, what):
        """Write and enqueue ``evals`` in one call, wait until they settle
        with ``n_allocs`` live allocs of theirs; the launches in between
        are counted. Returns the time of the write."""
        ids = [ev.id for ev in evals]
        route.order = {e: k for k, e in enumerate(ids)}
        route.reset()
        kernels.reset_launches()
        t0 = time.perf_counter()
        server.state.upsert_evals(evals)
        server.broker.enqueue_all(evals)
        settle(server, ids, what, lambda: sum(
            len(m) for m in server_allocs(server.state, ids).values())
            >= n_allocs)
        count_launches()
        return t0

    t_phase = time.perf_counter()
    tp.reset_pack_caches()
    sched = SchedRoute(svc, generic, Harness)
    jobs = make_jobs("srv-job", N_EVALS, N_PLACE)
    store = fleet_store(jobs)
    server = Server(state=store, device=DEVICE, batch_width=SERVER_WIDTH,
                    heartbeat_ttl=3600.0)
    try:
        # the instruments go in before the workers start: a worker binds
        # its barrier hook when it enters a dequeue
        with sched, ServerRoute(server, worker_mod, batch, lpq) as route:
            server.start()
            assert len(server.workers) == 2
            # -- 1. the headline ----------------------------------------
            evals = [sched_eval(st, j, f"srv-eval-{e:016d}")
                     for e, j in enumerate(jobs)]
            ids = [ev.id for ev in evals]
            sched.reset()
            t0 = run(route, server, evals, N_EVALS * N_PLACE, "headline")
            got = server_allocs(store, ids)
            for ev, j in zip(evals, jobs):
                upd = store.eval_by_id(ev.id)
                assert upd.status == "complete", (ev.id, upd.status)
                assert all(v == 0 for v in upd.queued_allocations.values())
                assert set(got[ev.id]) == {f"{j.id}.web[{i}]"
                                           for i in range(N_PLACE)}
            n_placed = sum(len(m) for m in got.values())
            assert n_placed == N_EVALS * N_PLACE, n_placed
            assert route.nacks == 0, route.nacked
            assert sorted(e for e in route.acked if e in route.order) == \
                sorted(ids)
            head = route.summary("headline", card, t0, n_placed, N_EVALS,
                                 sched)
            assert head["applier"]["plans_rejected"] == 0
            after = struct_usage(np, tp, matrix, store.snapshot(), nodes)
            for cap, used in ((matrix.cpu_cap, after.used_cpu),
                              (matrix.mem_cap, after.used_mem),
                              (matrix.disk_cap, after.used_disk)):
                assert bool(np.all(used <= cap)), "over capacity"
            # -- 2. the LP tier -----------------------------------------
            server.apply_scheduler_config(cfg(st.SCHED_ALG_TPU_LPQ))
            server.revoke_leadership()
            server.establish_leadership()
            assert len(server.workers) == 1
            ljobs = make_jobs("srv-lpq-job", SERVER_LPQ_EVALS,
                              SERVER_LPQ_PLACE)
            for j in ljobs:
                store.upsert_job(j)
            levals = [sched_eval(st, j, f"srv-lpq-eval-{e:04d}")
                      for e, j in enumerate(ljobs)]
            sched.reset()
            t0 = run(route, server, levals, 1, "lp tier")
            lane_of = {ev.id: sched.services[ev.id].lanes[0]
                       for ev in levals}
            lanes = [lane_of[ev.id] for ev in levals]
            assert all(lpq.lp_lane_eligible(lane) for lane in lanes)
            wait_until(lambda: server.workers[0].batches_processed >= 1,
                       SERVER_SETTLE_S, "the LP batch joined")
            outs, _, direct_ms, _ = run_barriers(
                batch, [lpq.LpqBarrier(len(lanes), device=DEVICE)], lanes)
            for r in outs[0]:
                if isinstance(r, Exception):
                    raise AssertionError("direct LpqBarrier raised") from r
            same_results(np, [sched.services[ev.id].results[0]
                              for ev in levals], outs[0], "server lp tier")
            lgot = server_allocs(store, [ev.id for ev in levals])
            n_lp = 0
            for ev, lane, r in zip(levals, lanes, outs[0]):
                _, node_ids = svc.placements(lane, r[0])
                want = {p.name: nid for p, nid in zip(lane.places, node_ids)
                        if nid is not None}
                assert {k: v[0] for k, v in lgot[ev.id].items()} == want
                n_lp += len(want)
            assert n_lp > 0
            lp = route.summary("lp tier", card, t0, n_lp, SERVER_LPQ_EVALS,
                               sched)
            lp["direct_wall_ms"] = direct_ms
            # -- 3. a system job through register_job -------------------
            server.apply_scheduler_config(cfg(st.SCHED_ALG_TPU_BINPACK))
            sj = pmock.system_job(id="srv-system")
            stg = sj.task_groups[0]
            stg.tasks[0].resources.cpu = int(SYSTEM_ASK[0])
            stg.tasks[0].resources.memory_mb = int(SYSTEM_ASK[1])
            stg.ephemeral_disk.size_mb = int(SYSTEM_ASK[2])
            sched.reset()
            route.reset()
            route.order = {}
            kernels.reset_launches()
            t0 = time.perf_counter()
            sev = server.register_job(sj)
            settle(server, [sev.id], "system job")
            count_launches()
            sgot = server_allocs(store, [sev.id])[sev.id]
            snap = sched.services[sev.id].ctx.state
            ds = Timed(EvalContext(_HiddenTable(snap), st.Plan(
                eval_id=sev.id, job=sj, priority=sj.priority)), sj, False,
                False, device=DEVICE)
            direct = ds.solve_system(stg, snap.ready_nodes_in_pool(
                sj.node_pool))
            want = {p.node.id: struct_score_bits(p.score) for p in direct
                    if p.node is not None}
            by_node = {}
            for a in store.allocs_by_job(sj.namespace, sj.id):
                by_node[a.node_id] = struct_score_bits(
                    a.metrics.scores[f"{a.node_id}.normalized-score"])
            assert by_node == want and len(want) > 0
            assert len(sgot) == 1            # one alloc name, every node
            same_results(np, sched.services[sev.id].results, ds.results,
                         "server system")
            system = route.summary("system", card, t0, len(want), 1, sched)
            system["failed_nodes"] = N_NODES - len(want)
        # the compared route: phase 14's Harness on a store built by the
        # same writes (outside the launch count)
        hjobs = make_jobs("srv-job", N_EVALS, N_PLACE)
        hstore = fleet_store(hjobs)
        hevals = [sched_eval(st, j, ev.id) for ev, j in zip(evals, hjobs)]
        hstore.upsert_evals(hevals)
        h = Harness(hstore)
        with sched:
            barrier = batch.SolveBarrier(N_EVALS, e_pad_hint=SERVER_WIDTH,
                                         device=DEVICE)
            ordered = sched.ordered(barrier)
            harness_ms = drive_scheduler(sched, h, "service", hevals,
                                         ordered,
                                         batch.make_solve_hook(ordered))
        hgot, _ = committed(h, ids)
        diff = {e: sum(hgot[e].get(n) != v for n, v in got[e].items())
                for e in ids}
        assert hgot == got, ("server placements != the Harness route's",
                             {e: d for e, d in diff.items() if d})
        head["harness_wall_ms"] = harness_ms
        report.update(headline=head, lpq=lp, system=system)
    finally:
        server.shutdown()

    # -- 4. the blocked drill ---------------------------------------------
    bstore = StateStore()
    bstore.set_scheduler_config(cfg(st.SCHED_ALG_TPU_BINPACK))
    small = pmock.node(id="srv-blocked-node-0")
    small.node_resources.cpu.cpu_shares = 600
    small.node_resources.memory.memory_mb = 400
    small.compute_class()
    bserver = Server(state=bstore, device=DEVICE, batch_width=4,
                     heartbeat_ttl=3600.0)
    bserver.start()
    try:
        bserver.register_node(small)
        bjobs = make_jobs("srv-blocked-job", 2, 1)
        for j in bjobs:
            bstore.upsert_job(j)
        bevals = [sched_eval(st, j, f"srv-blocked-eval-{e}")
                  for e, j in enumerate(bjobs)]
        kernels.reset_launches()
        t0 = time.perf_counter()
        bstore.upsert_evals(bevals)
        bserver.broker.enqueue_all(bevals)
        settle(bserver, [e.id for e in bevals], "blocked drill",
               lambda: bserver.blocked_evals.stats()["total_blocked"] == 1)
        placed = [a for a in bstore.allocs() if not a.terminal_status()]
        assert len(placed) == 1 and placed[0].node_id == small.id
        big = pmock.node(id="srv-blocked-node-1")
        big.compute_class()
        bserver.register_node(big)
        wait_until(lambda: len([a for a in bstore.allocs()
                                if not a.terminal_status()]) == 2
                   and bserver.blocked_evals.stats()["total_blocked"] == 0
                   and not bserver.broker.stats()["total_unacked"],
                   SERVER_SETTLE_S, "the blocked eval placed")
        count_launches()
        blocked_ms = (time.perf_counter() - t0) * 1e3
        for node in (small, big):
            used = [0, 0]
            for a in bstore.allocs_by_node(node.id):
                if not a.terminal_status():
                    cr = a.allocated_resources.comparable()
                    used[0] += cr.cpu_shares
                    used[1] += cr.memory_mb
            assert used[0] <= node.node_resources.cpu.cpu_shares
            assert used[1] <= node.node_resources.memory.memory_mb
        statuses = sorted(e.status for j in bjobs
                          for e in bstore.evals_by_job(j.namespace, j.id))
        report["blocked"] = dict(wall_ms=blocked_ms, evals=statuses,
                                 on_new_node=sum(
                                     a.node_id == big.id
                                     for a in bstore.allocs()))
        log(f"server blocked drill [{card}]: {statuses}, "
            f"{blocked_ms:.1f} ms to both placed")
    finally:
        bserver.shutdown()
    left = [t.name for t in threading.enumerate() if t.is_alive()
            and t.name.startswith(("batch-worker-", "batch-eval-",
                                   "lpq-eval-", "plan-", "eval-broker-"))]
    assert not left, left

    g1 = guard.state()
    report["host_fallbacks"] = (g1["host_fallback_dispatches"]
                                - g0["host_fallback_dispatches"])
    report["failed_dispatches"] = {
        k: g1["dispatch"][k] - g0["dispatch"][k]
        for k in ("timeout", "error")}
    assert report["host_fallbacks"] == 0, report["host_fallbacks"]
    assert not any(report["failed_dispatches"].values()), \
        report["failed_dispatches"]
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t_phase
    log(f"server [{card}]: launches {launches}; phase "
        f"{report['seconds']:.1f} s")
    for kname in ("wave_block", "system_fit", "lp_relax"):
        assert launches[kname] >= 1, (kname, launches)
    return report


TEL_AUDIT_JOBS, TEL_AUDIT_PLACE = 1, 40     # the audit's simple jobs
TEL_SKEW_JOBS = 1                    # the skew drill's (and its alert's
                                     # threshold, ALERT_AFTER: default 3)
                                     # threshold (QUALITY_ALERT_AFTER)
TEL_COST_ROUNDS = 1                  # measured rounds per switch setting
TEL_COST_EVALS = 8                   # a cost round's evals (x N_PLACE)
TEL_SPANS = ("broker.wait", "worker.wait_for_index", "worker.invoke",
             "solver.pack", "solver.barrier", "solver.fuse_dispatch",
             "solver.materialize", "plan.submit", "plan.evaluate",
             "plan.commit")
TEL_SWITCHES = ("NOMAD_TPU_TORCH_TRACE", "NOMAD_TPU_TORCH_XFEROBS",
                "NOMAD_TPU_TORCH_QUALITY")


class EnvPatch:
    """Set environment variables for a block and restore them after."""

    def __init__(self, **env):
        self.env, self.saved = env, {}

    def __enter__(self):
        for k, v in self.env.items():
            self.saved[k] = os.environ.get(k)
            os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def telemetry_reset(metrics, tracer, xferobs, observatory):
    metrics.reset()
    tracer._reset_for_tests()
    xferobs._reset_for_tests()
    observatory._reset_for_tests()


def waterfall(tr):
    """The trace's spans by start: (name, thread, start ms from the
    trace's first span, ms)."""
    spans = sorted(tr["spans"], key=lambda s: s["t0"])
    t0 = spans[0]["t0"] if spans else 0.0
    return [(s["name"], s["thread"], round((s["t0"] - t0) * 1e3, 3),
             s["dur_ms"]) for s in spans]


def telemetry_phase(np, torch, batch, guard, lpq, kernels, resident, svc,
                    tp, world, card, t_start):
    """The telemetry layer (phase 16): the reference's headline protocol
    on a port Server with the metrics registry, the tracer (every eval's
    trace kept), the transfer ledger and the quality observatory on:
      1. a warm round of N_EVALS mock.job evals x N_PLACE, every job
         deregistered, every stop waited for and acknowledged complete
         through update_allocs_from_client (capacity frees only there),
         then the measured round of N_EVALS new jobs: all placed, 0 plans
         rejected, placements_tpu = N_EVALS x N_PLACE and
         placements_host_fallback = 0 over the round, the observatory's
         delta-kept accounting equal to a recount (parity_mismatch 0),
         the ledger's parity 0 (and its per-shard parity, the mesh phases
         having run) and its shipped bytes equal to resident.stats()'s
         over the round, and every measured eval's trace holding the ten
         spans of TEL_SPANS from more than one thread, its fused dispatch
         with N_EVALS lanes;
      2. the shadow audit on the card: NOMAD_TPU_TORCH_QUALITY_AUDIT_SAMPLE
         = 1 and TEL_AUDIT_JOBS simple jobs x TEL_AUDIT_PLACE: every
         kernel solve replayed on the host, decision mismatches 0 and
         score drift within the tolerance (1e-3); then quality.skew armed
         and TEL_SKEW_JOBS jobs with NOMAD_TPU_TORCH_QUALITY_ALERT_AFTER
         set to their number: the alert latches after that many
         violating audits;
      3. a failed acknowledgement: one audit alloc acknowledged failed
         (its job reschedules at once) enqueues an alloc-failure eval,
         whose lane carries the penalty and launches wave_compact;
      4. the cost: a round of TEL_COST_EVALS evals x N_PLACE alone on a
         fresh fleet store, with the three kill switches off and on in
         turn (TEL_COST_ROUNDS of each), placements and normalized-score
         bits equal in every round; wall ms (evals written to the last commit) and
         placements/s printed for each, and the difference of the means.
    Prints the slowest measured eval's waterfall, the saturation report's
    busy shares, the ledger's bench fields, its transfer fit and the
    residency report's top rows, and the chrome trace's span count.
    Launch counts are read around steps 1-3 (``launches``: the kernels
    line's telemetry_launches)."""
    import copy
    from nomad_tpu_torch import mock as pmock
    from nomad_tpu_torch import structs as st
    from nomad_tpu_torch.faultinject import faults
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.server import worker as worker_mod
    from nomad_tpu_torch.server.quality import observatory
    from nomad_tpu_torch.server.telemetry import metrics
    from nomad_tpu_torch.server.tracing import tracer
    from nomad_tpu_torch.solver import xferobs
    from nomad_tpu_torch.state.store import StateStore

    t_phase = time.perf_counter()
    report = {}
    launches = {k.name: 0 for k in kernels.KERNELS}
    g0 = guard.state()
    # phase 15's server sampled its own evals for the audit: let their
    # replays end before this phase's audit starts from a clean state
    assert observatory.audit.wait_idle(timeout=600.0)
    # the mesh phases ran with the ledger on: their per-shard rows agree
    report["mesh_shard_parity"] = xferobs.shard_parity()
    assert report["mesh_shard_parity"] == 0, report["mesh_shard_parity"]
    nodes = struct_fleet(pmock, N_NODES)
    cfg = st.SchedulerConfiguration(
        scheduler_algorithm=st.SCHED_ALG_TPU_BINPACK)

    def fleet_store(jobs):
        store = StateStore()
        for node in nodes:
            store.upsert_node(node)
        store.set_scheduler_config(cfg)
        for j in jobs:
            store.upsert_job(j)
        return store

    def make_jobs(prefix, n, count, now=False):
        jobs = []
        for e in range(n):
            j = pmock.job(id=f"{prefix}-{e:02d}")
            j.task_groups[0].count = count
            if now:                  # a failed alloc reschedules at once
                j.task_groups[0].reschedule_policy = st.ReschedulePolicy(
                    attempts=2, interval_s=600, delay_s=0,
                    delay_function="constant", unlimited=False)
            jobs.append(j)
        return jobs

    def count_launches():
        for k in kernels.KERNELS:
            launches[k.name] += k.launches

    def counters():
        return metrics.snapshot()["counters"]

    def run(route, server, evals, n_allocs, what):
        """Write and enqueue ``evals`` in one call and wait until their
        ``n_allocs`` allocs are live; returns (t0, t_end) on the host
        clock (t_end: the last commit when the route saw one)."""
        ids = [ev.id for ev in evals]
        if route is not None:
            route.order = {e: k for k, e in enumerate(ids)}
            route.reset()
        t0 = time.perf_counter()
        server.state.upsert_evals(evals)
        server.broker.enqueue_all(evals)
        settle(server, ids, what, lambda: sum(
            len(m) for m in server_allocs(server.state, ids).values())
            >= n_allocs)
        t1 = (max(route.commit_end) if route is not None
              and route.commit_end else time.perf_counter())
        return t0, t1

    def register_each(server, jobs, what):
        """One job at a time, each settled before the next: every
        generation holds one lane, so no fixpoint re-solve moves a
        placement the audit's single-lane replay would not make."""
        for j in jobs:
            ev = server.register_job(j)
            settle(server, [ev.id], what, lambda e=ev: len(server_allocs(
                server.state, [e.id])[e.id]) >= j.task_groups[0].count)

    # every eval's trace kept; the audit waits for step 2's single-lane
    # generations (a fused generation's fixpoint may move a placement the
    # single-lane replay cannot see)
    with EnvPatch(NOMAD_TPU_TORCH_TRACE_SAMPLE="1",
                  NOMAD_TPU_TORCH_QUALITY_AUDIT_SAMPLE="0"):
        telemetry_reset(metrics, tracer, xferobs, observatory)
        tp.reset_pack_caches()
        warm = make_jobs("tel-warm", N_EVALS, N_PLACE)
        store = fleet_store(warm)
        server = Server(state=store, device=DEVICE, batch_width=SERVER_WIDTH,
                        heartbeat_ttl=3600.0)
        try:
            with ServerRoute(server, worker_mod, batch, lpq) as route:
                server.start()
                assert observatory.active and store._quality_hook is not None
                kernels.reset_launches()
                # -- 1. warm round, drain, acknowledgement, measured round
                t0, t1 = run(route, server,
                             [sched_eval(st, j, f"tel-warm-eval-{e:016d}")
                              for e, j in enumerate(warm)],
                             N_EVALS * N_PLACE, "warm round")
                report["warm_wall_ms"] = (t1 - t0) * 1e3
                t_drain = time.perf_counter()
                dereg = [server.deregister_job(j.namespace, j.id)
                         for j in warm]
                settle(server, [e.id for e in dereg], "deregistered",
                       lambda: not any(a.desired_status == "run"
                                       for a in store.allocs()))
                t_ack = time.perf_counter()
                acks = []
                for a in store.allocs():
                    upd = copy.copy(a)
                    upd.client_status = st.ALLOC_CLIENT_COMPLETE
                    upd.client_terminal_time = time.time()
                    acks.append(upd)
                server.update_allocs_from_client(acks)
                t_acked = time.perf_counter()
                assert all(a.client_terminal_status()
                           for a in store.allocs())
                assert all(j.status == "dead" for j in store.jobs())
                report["drain"] = dict(
                    stop_ms=(t_ack - t_drain) * 1e3,
                    ack_ms=(t_acked - t_ack) * 1e3, acked=len(acks))
                mismatch = observatory.parity_mismatch()
                report["parity_mismatch_after_churn"] = mismatch
                assert mismatch == 0, mismatch
                jobs = make_jobs("tel-job", N_EVALS, N_PLACE)
                for j in jobs:
                    store.upsert_job(j)
                evals = [sched_eval(st, j, f"tel-eval-{e:016d}")
                         for e, j in enumerate(jobs)]
                ids = [ev.id for ev in evals]
                c0 = counters()
                x0 = xferobs.state()
                r0 = resident.stats()
                rej0 = server.planner.plans_rejected
                t0, t1 = run(route, server, evals, N_EVALS * N_PLACE,
                             "measured round")
                c1 = counters()
                x1 = xferobs.state()
                r1 = resident.stats()
                n_placed = sum(len(m) for m in
                               server_allocs(store, ids).values())
                assert n_placed == N_EVALS * N_PLACE, n_placed
                assert server.planner.plans_rejected == rej0

                def delta(name):
                    return c1.get(name, 0) - c0.get(name, 0)
                head = dict(
                    placements=n_placed, wall_ms=(t1 - t0) * 1e3,
                    placements_tpu=delta("nomad.scheduler.placements_tpu"),
                    placements_host_fallback=delta(
                        "nomad.scheduler.placements_host_fallback"),
                    dispatch_bytes=delta("nomad.solver.dispatch_bytes_total"),
                    const_cache_hit=delta("nomad.solver.const_cache_hit"),
                    const_cache_miss=delta("nomad.solver.const_cache_miss"),
                    ledger_shipped=(x1["shipped_bytes_total"]
                                    - x0["shipped_bytes_total"]),
                    ledger_resident=(x1["resident_bytes_total"]
                                     - x0["resident_bytes_total"]),
                    ledger_fetched=(x1["fetched_bytes_total"]
                                    - x0["fetched_bytes_total"]),
                    resident_shipped=(r1["bytes_shipped_total"]
                                      - r0["bytes_shipped_total"]),
                    ledger_parity=xferobs.parity(),
                    shard_parity=xferobs.shard_parity())
                head["placements_per_s"] = n_placed / (head["wall_ms"] / 1e3)
                assert head["placements_tpu"] == N_EVALS * N_PLACE, head
                assert head["placements_host_fallback"] == 0, head
                assert head["ledger_parity"] == 0, head
                assert head["shard_parity"] == 0, head
                assert head["ledger_shipped"] == head["resident_shipped"] \
                    == head["dispatch_bytes"], head
                mismatch = observatory.parity_mismatch()
                assert mismatch == 0, mismatch
                # every measured eval's trace, retained (sample 1)
                per_eval = {}
                for eid in ids:
                    tr = tracer.get(eid)
                    assert tr is not None and tr["status"] == "complete", \
                        (eid, tr and tr["status"])
                    names = {s["name"] for s in tr["spans"]}
                    missing = [n for n in TEL_SPANS if n not in names]
                    assert not missing, (eid, missing)
                    threads = {s["thread"] for s in tr["spans"]}
                    assert len(threads) > 1, (eid, threads)
                    fuse = [s for s in tr["spans"]
                            if s["name"] == "solver.fuse_dispatch"]
                    assert any(s["tags"]["lanes"] == N_EVALS
                               for s in fuse), (eid, fuse)
                    per_eval[eid] = tr
                # each span's ms over the measured evals (summed within
                # an eval), and the eval's time outside every span of
                # its own thread's invoke (alloc building, plan assembly)
                by_span = {}
                for tr in per_eval.values():
                    sums = {}
                    for sp in tr["spans"]:
                        sums[sp["name"]] = sums.get(sp["name"], 0.0) + \
                            sp["dur_ms"]
                    for n, v in sums.items():
                        by_span.setdefault(n, []).append(v)
                head["span_ms"] = {n: dict(ms_stats(v), evals=len(v))
                                   for n, v in sorted(by_span.items())}
                slow_id = max(ids, key=lambda e: per_eval[e]["dur_ms"])
                head["slowest_eval"] = dict(
                    eval_id=slow_id, dur_ms=per_eval[slow_id]["dur_ms"],
                    waterfall=waterfall(per_eval[slow_id]))
                head["trace_spans_median"] = statistics.median(
                    len(per_eval[e]["spans"]) for e in ids)
                report["measured"] = head
                log(f"telemetry measured round [{card}]: {n_placed} "
                    f"placed, wall {head['wall_ms']:.1f} ms, "
                    f"{head['placements_per_s']:.0f} placements/s; "
                    f"placements_tpu {head['placements_tpu']}, host "
                    f"fallback {head['placements_host_fallback']}; ledger "
                    f"shipped {head['ledger_shipped']} B (resident set "
                    f"{head['resident_shipped']} B), resident "
                    f"{head['ledger_resident']} B, fetched "
                    f"{head['ledger_fetched']} B, parity "
                    f"{head['ledger_parity']}")
            # -- 2. the shadow audit on the card, and the skew drill ------
            # an idle worker re-binds its barrier hook once a dequeue
            # times out (0.5 s): after 1 s none holds the route's
            time.sleep(1.0)
            with EnvPatch(NOMAD_TPU_TORCH_QUALITY_AUDIT_SAMPLE="1",
                          NOMAD_TPU_TORCH_QUALITY_ALERT_AFTER=str(
                              TEL_SKEW_JOBS)):
                ajobs = make_jobs("tel-audit", TEL_AUDIT_JOBS,
                                  TEL_AUDIT_PLACE, now=True)
                register_each(server, ajobs, "audit jobs")
                assert observatory.audit.wait_idle(timeout=120.0)
                audit = observatory.audit.report()
                mine = [r for r in observatory.audit.results().values()
                        if r["job_id"].startswith("tel-audit-")]
                audited = len(mine)
                assert audited == TEL_AUDIT_JOBS == audit["audited"], audit
                assert audit["decision_mismatch_total"] == 0, audit
                assert audit["score_drift_max"] <= audit["drift_tol"], audit
                assert audit["alert"] is None, audit
                report["audit"] = dict(
                    audited=audited, skipped=audit["skipped_complex"],
                    places=sum(r["places"] for r in mine),
                    score_drift_max=audit["score_drift_max"],
                    decision_mismatch_total=audit["decision_mismatch_total"],
                    drift_tol=audit["drift_tol"])
                faults.arm("quality.skew", "error")
                try:
                    sjobs = make_jobs("tel-skew", TEL_SKEW_JOBS,
                                      TEL_AUDIT_PLACE)
                    register_each(server, sjobs, "skew jobs")
                    assert observatory.audit.wait_idle(timeout=120.0)
                finally:
                    faults.disarm("quality.skew")
                drill = observatory.audit.report()
                assert drill["alert"] is not None, drill
                assert drill["alert"]["reason"] == "score_drift", drill
                assert drill["alert_after"] == TEL_SKEW_JOBS, drill
                assert drill["alert"]["at_audit"] == audit["audited"] + \
                    drill["alert_after"], drill
                report["skew_drill"] = dict(alert=drill["alert"],
                                            alert_after=drill["alert_after"])
                log(f"telemetry audit [{card}]: {audited} kernel solves "
                    "replayed on the host, decision mismatches "
                    f"{audit['decision_mismatch_total']}, score drift max "
                    f"{audit['score_drift_max']:.3g} (tol "
                    f"{audit['drift_tol']}); skew drill alert "
                    f"{drill['alert']}")
            # -- 3. a failed acknowledgement reschedules -------------------
            victim = sorted(store.allocs_by_job("default", ajobs[0].id),
                            key=lambda a: a.name)[0]
            upd = copy.copy(victim)
            upd.client_status = st.ALLOC_CLIENT_FAILED
            upd.client_terminal_time = time.time()
            compact0 = kernels.WAVE_COMPACT.launches
            server.update_allocs_from_client([upd])
            fails = [e for e in store.evals_by_job("default", ajobs[0].id)
                     if e.triggered_by == "alloc-failure"]
            assert len(fails) == 1, fails
            settle(server, [fails[0].id], "alloc-failure reschedule",
                   lambda: any(a.previous_allocation == victim.id
                               for a in store.allocs_by_job(
                                   "default", ajobs[0].id)))
            repl = [a for a in store.allocs_by_job("default", ajobs[0].id)
                    if a.previous_allocation == victim.id]
            assert len(repl) == 1 and repl[0].node_id != victim.node_id
            assert kernels.WAVE_COMPACT.launches > compact0, \
                "the reschedule lane did not launch wave_compact"
            count_launches()
            report["reschedule"] = dict(
                eval_id=fails[0].id, node=repl[0].node_id,
                wave_compact_launches=kernels.WAVE_COMPACT.launches
                - compact0)
            # -- what the layer shows ---------------------------------------
            sat = observatory.saturation.report()
            report["saturation"] = dict(
                bottleneck=sat["bottleneck"],
                busy_pct={k: v["busy_pct"]
                          for k, v in sat["stages"].items()},
                share_pct={k: v["share_of_recorded_pct"]
                           for k, v in sat["stages"].items()})
            xs = xferobs.state()
            report["xferobs"] = dict(
                bench_fields=xferobs.bench_fields(), tunnel=xs["tunnel"],
                groups=xs["groups"], fetches=xs["fetches"],
                residency_top=xs["residency"].get("top", [])[:5],
                residency=({k: v for k, v in xs["residency"].items()
                            if k != "top"}))
            report["quality"] = observatory.bench_fields()
            doc = tracer.chrome_trace()
            report["chrome_trace"] = dict(
                traces=len([e for e in doc["traceEvents"]
                            if e["ph"] == "M"]),
                spans=len([e for e in doc["traceEvents"]
                           if e["ph"] == "X"]),
                counter_events=len(xferobs.counter_events()))
            report["tracer"] = tracer.stats()
        finally:
            faults.disarm_all()
            server.shutdown()
        assert store._quality_hook is None and not observatory.active
        slow = report["measured"]["slowest_eval"]
        log(f"telemetry slowest measured eval [{card}]: {slow['eval_id']} "
            f"{slow['dur_ms']:.1f} ms; waterfall (span, thread, start ms, "
            "ms; events of no duration left out): "
            + "; ".join(f"{n} {t} {s:.1f} {d:.1f}"
                        for n, t, s, d in slow["waterfall"] if d > 0))
        log(f"telemetry spans over the measured evals [{card}] (ms a "
            "span, summed within an eval: median / max): "
            + "; ".join(f"{n} {v['median']:.1f} / {v['max']:.1f}"
                        for n, v in report["measured"]["span_ms"].items()
                        if v["max"] > 0))
        log(f"telemetry saturation [{card}]: bottleneck "
            f"{report['saturation']['bottleneck']}; busy % "
            + ", ".join(f"{k} {v}" for k, v in
                        report["saturation"]["busy_pct"].items()))
        log(f"telemetry ledger [{card}]: {report['xferobs']['bench_fields']}"
            f"; transfer fit {report['xferobs']['tunnel']}; residency "
            f"{report['xferobs']['residency']}; top "
            f"{report['xferobs']['residency_top']}")
        log(f"telemetry chrome trace: {report['chrome_trace']}")

    # -- 4. the cost of the layer on the measured round --------------------
    cost = {"on": [], "off": []}
    placed = []
    order = ["off", "on"] * TEL_COST_ROUNDS
    for setting in order:
        env = {k: ("0" if setting == "off" else "1") for k in TEL_SWITCHES}
        with EnvPatch(**env):
            telemetry_reset(metrics, tracer, xferobs, observatory)
            tp.reset_pack_caches()
            jobs = make_jobs("tel-job", TEL_COST_EVALS, N_PLACE)
            cstore = fleet_store(jobs)
            cserver = Server(state=cstore, device=DEVICE,
                             batch_width=SERVER_WIDTH, heartbeat_ttl=3600.0)
            try:
                with ServerRoute(cserver, worker_mod, batch, lpq) as route:
                    cserver.start()
                    assert (cstore._quality_hook is None) == \
                        (setting == "off")
                    evals = [sched_eval(st, j, f"tel-eval-{e:016d}")
                             for e, j in enumerate(jobs)]
                    t0, t1 = run(route, cserver, evals,
                                 TEL_COST_EVALS * N_PLACE,
                                 f"cost round ({setting})")
                    got = server_allocs(cstore, [ev.id for ev in evals])
                    if setting == "off":
                        assert tracer.stats()["retained"] == 0
                        assert xferobs.state() == {"enabled": False}
            finally:
                cserver.shutdown()
            # an "on" round's sampled audits replay in the background:
            # let them end before the next round's clock starts
            assert observatory.audit.wait_idle(timeout=600.0)
        wall = (t1 - t0) * 1e3
        cost[setting].append(dict(wall_ms=wall, placements_per_s=(
            TEL_COST_EVALS * N_PLACE) / (wall / 1e3)))
        placed.append(got)
        log(f"telemetry cost round [{card}]: switches {setting}, wall "
            f"{wall:.1f} ms, {TEL_COST_EVALS * N_PLACE / (wall / 1e3):.0f} "
            "placements/s")
    assert all(p == placed[0] for p in placed[1:]), \
        "placements differ between kill-switch settings"
    mean = {k: statistics.mean(r["wall_ms"] for r in v)
            for k, v in cost.items()}
    report["cost"] = dict(rounds=cost, order=order,
                          mean_wall_ms=mean,
                          on_minus_off_ms=mean["on"] - mean["off"],
                          on_over_off=mean["on"] / mean["off"])
    log(f"telemetry cost [{card}]: mean wall on {mean['on']:.1f} ms, off "
        f"{mean['off']:.1f} ms, on - off {mean['on'] - mean['off']:.1f} ms "
        f"({100 * (mean['on'] / mean['off'] - 1):.1f} %); placements equal "
        "bit for bit in every round")
    g1 = guard.state()
    report["host_fallbacks"] = (g1["host_fallback_dispatches"]
                                - g0["host_fallback_dispatches"])
    assert report["host_fallbacks"] == 0, report["host_fallbacks"]
    assert not any(g1["dispatch"][k] - g0["dispatch"][k]
                   for k in ("timeout", "error"))
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t_phase
    log(f"telemetry [{card}]: launches {launches}; phase "
        f"{report['seconds']:.1f} s")
    for kname in ("wave_block", "wave_compact"):
        assert launches[kname] >= 1, (kname, launches)
    return report


SAN_SCHED_SEED = 11                 # the controlled schedule's seed
SAN_SCHED_JOBS, SAN_SCHED_PLACE, SAN_SCHED_NODES = 4, 50, 1_000


def sanitizer_counts(jit, lock, state):
    """The counts the sanitizer phase prints and gates on."""
    return dict(
        launches=jit["launches"], builds=jit["builds"],
        rebuilds=jit["rebuild_count"], late_builds=jit["late_build_count"],
        host_syncs=sum(r["count"] for r in jit["host_syncs"]),
        sanctioned=jit["sanctioned_fetches"],
        sanctioned_by_tag=jit["sanctioned_by_tag"],
        cuda_sync_warnings=jit["cuda_sync_warnings"],
        dtype_drift=jit["x64_leak_count"], mutations=jit["mutation_count"],
        **({} if lock is None else dict(
            cycles=lock["cycle_count"],
            held_across=len(lock["held_across"]),
            escaped=len(lock["escaped"]), locks=lock["locks"])),
        **({} if state is None else dict(
            torn_reads=state["torn_read_count"],
            aliasing_writes=state["aliasing_write_count"],
            drifts=state["drift_count"],
            journal_gaps=state["journal_gap_count"],
            write_skews=state["write_skew_count"],
            stale_memos=state["stale_memo_count"], reads=state["reads"])))


def sanitizer_gate(jit, lock, state, what):
    """Fail on an unsanctioned hot sync, a steady-state rebuild, a cache
    mutation, a lock cycle, a torn read or an aliasing write."""
    bad = []
    bad += [f"host sync {r['kind']} at {r['site']} x{r['count']} "
            f"(dispatch {r['label']!r})" for r in jit["host_syncs"]]
    bad += [f"rebuild at {r['site']}: {r['signature']} x{r['count']}"
            for r in jit["rebuilds"]]
    bad += [f"cache mutation {r['kind']} at {r['site']}"
            for r in jit["mutations"]]
    if lock is not None:
        bad += ["lock cycle " + " -> ".join(c["locks"])
                for c in lock["cycles"]]
    if state is not None:
        bad += [f"torn read {r['kind']} in {r['op']} at {r['site']}"
                for r in state["torn_reads"]]
        bad += [f"aliasing write {r['kind']} at {r['site']}"
                for r in state["aliasing_writes"]]
    assert not bad, f"{what}: " + "; ".join(bad)


def sanitizer_phase(np, torch, batch, guard, lpq, kernels, svc, tp, world,
                    card):
    """The dispatch sanitizers on the card (phase 17), at full width:
      a. jitcheck armed over one warm headline SolveBarrier generation
         (10,000 nodes padded to 16,384, N_EVALS mock.job evals x
         N_PLACE, float32, depth 2) and over one warm server round as
         phase 16's cost round runs it (a fresh fleet store, N_EVALS
         jobs x N_PLACE in one write): per site the launches,
         signatures, builds and late builds, the hot syncs (sanctioned
         by tag, and not, with sites), dtype drift and cache mutations;
         fails on an unsanctioned hot sync, a steady-state rebuild or a
         cache mutation, and unless the generation's results equal the
         same generation run with the checkers off, bit for bit;
      b. lockcheck and statecheck armed over the same server round (with
         jitcheck): fails on a cycle, a torn read or an aliasing write;
         prints the held-across, drift, journal-gap and write-skew
         counts; the round's placements equal the unarmed round's;
      c. schedcheck: one controlled small server scenario
         (SAN_SCHED_JOBS jobs x SAN_SCHED_PLACE on SAN_SCHED_NODES
         nodes, one batch worker) twice under seed SAN_SCHED_SEED on the
         real kernels; fails unless both runs give equal decision
         fingerprints and equal placements, equal to the scenario run
         with no checker on;
      d. the cost: the armed round's wall time beside the unarmed one's
         (a reading, not a claim).
    Launch counts of the armed runs are in ``launches``."""
    from nomad_tpu_torch import jitcheck, lockcheck, schedcheck, statecheck
    from nomad_tpu_torch import mock as pmock
    from nomad_tpu_torch import structs as st
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.server import worker as worker_mod
    from nomad_tpu_torch.state.store import StateStore

    t_phase = time.perf_counter()
    report = {}
    launches = {k.name: 0 for k in kernels.KERNELS}
    g0 = guard.state()

    def count_launches():
        for k in kernels.KERNELS:
            launches[k.name] += k.launches

    def disarm():
        for m in (schedcheck, statecheck, lockcheck, jitcheck):
            m.disable()
            m._reset_for_tests()

    # -- a. the headline generation -------------------------------------
    head = pack_lanes(np, tp, svc, world, "float32", kind="plain",
                      n_lanes=N_EVALS)

    def barrier():
        # a fresh barrier a generation: its ledger carries the fixpoint
        return batch.SolveBarrier(N_EVALS, depth=2, e_pad_hint=N_EVALS,
                                  device=DEVICE)

    outs, _, off_ms, _ = run_barriers(batch, [barrier()], head)
    off = outs[0]
    try:
        jitcheck.enable()
        kernels.reset_launches()
        outs, _, on_ms, _ = run_barriers(batch, [barrier()], head)
        count_launches()
        gen = jitcheck.state(sites=True)
    finally:
        disarm()
    outcomes_ok(np, outs, off, "armed generation vs unarmed")
    report["generation"] = dict(
        counts=sanitizer_counts(gen, None, None), sites=gen["sites"],
        host_syncs=gen["host_syncs"], late_builds=gen["late_builds"],
        dtype_drift=gen["dtype_drift"], wall_ms_off=off_ms,
        wall_ms_on=on_ms)
    log(f"sanitizers [{card}]: headline generation ({N_EVALS} lanes x "
        f"{N_PLACE}) under jitcheck: {report['generation']['counts']}; "
        f"sites " + "; ".join(
            f"{r['site']} launches {r['launches']} sigs {r['sigs']} builds "
            f"{r['builds']} host_setup_repeats {r['host_setup_repeats']}"
            for r in gen["sites"]) + "; results equal to the unarmed "
        "generation bit for bit; unsanctioned host syncs "
        f"{[(r['kind'], r['site'], r['count']) for r in gen['host_syncs']]}")
    sanitizer_gate(gen, None, None, "headline generation")

    # -- a, b, d. the server round ----------------------------------------
    nodes = struct_fleet(pmock, N_NODES)
    cfg = st.SchedulerConfiguration(
        scheduler_algorithm=st.SCHED_ALG_TPU_BINPACK)

    def round_once(prefix, armed):
        tp.reset_pack_caches()
        jobs = []
        for e in range(N_EVALS):
            j = pmock.job(id=f"{prefix}-{e:02d}")
            j.task_groups[0].count = N_PLACE
            jobs.append(j)
        if armed:
            # before the store and the server build their locks
            lockcheck.enable()
            statecheck.enable()
            jitcheck.enable()
            kernels.reset_launches()
        store = StateStore()
        for node in nodes:
            store.upsert_node(node)
        store.set_scheduler_config(cfg)
        for j in jobs:
            store.upsert_job(j)
        server = Server(state=store, device=DEVICE,
                        batch_width=SERVER_WIDTH, heartbeat_ttl=3600.0)
        try:
            with ServerRoute(server, worker_mod, batch, lpq) as route:
                server.start()
                evals = [sched_eval(st, j, f"{prefix}-eval-{e:016d}")
                         for e, j in enumerate(jobs)]
                ids = [ev.id for ev in evals]
                route.order = {e: k for k, e in enumerate(ids)}
                route.reset()
                t0 = time.perf_counter()
                store.upsert_evals(evals)
                server.broker.enqueue_all(evals)
                settle(server, ids, f"sanitizer round ({prefix})",
                       lambda: sum(len(m) for m in server_allocs(
                           store, ids).values()) >= N_EVALS * N_PLACE)
                t1 = (max(route.commit_end) if route.commit_end
                      else time.perf_counter())
                got = server_allocs(store, ids)
        finally:
            server.shutdown()
        out = dict(wall_ms=(t1 - t0) * 1e3, placed=got)
        if armed:
            count_launches()
            out["jit"] = jitcheck.state(sites=True)
            out["lock"] = lockcheck.state()
            out["state"] = statecheck.state()
        return out

    unarmed = round_once("san", False)
    try:
        armed = round_once("san", True)
    finally:
        disarm()
    assert armed["placed"] == unarmed["placed"], \
        "the armed round placed differently from the unarmed round"
    assert sum(len(m) for m in armed["placed"].values()) == \
        N_EVALS * N_PLACE
    rnd = sanitizer_counts(armed["jit"], armed["lock"], armed["state"])
    rnd_syncs = armed["jit"]["host_syncs"]
    report["round"] = dict(
        counts=rnd, sites=armed["jit"]["sites"],
        host_syncs=armed["jit"]["host_syncs"],
        late_builds=armed["jit"]["late_builds"],
        dtype_drift=armed["jit"]["dtype_drift"],
        held_across=[{k: v for k, v in r.items() if k != "stack"}
                     for r in armed["lock"]["held_across"]],
        drifts=armed["state"]["drifts"][:8],
        journal_gaps=[{k: v for k, v in r.items() if k != "stack"}
                      for r in armed["state"]["journal_gaps"]],
        write_skews=[{k: v for k, v in r.items() if k != "stack"}
                     for r in armed["state"]["write_skews"]],
        wall_ms_off=unarmed["wall_ms"], wall_ms_on=armed["wall_ms"])
    log(f"sanitizers [{card}]: server round ({N_EVALS} jobs x {N_PLACE} on "
        f"{N_NODES} nodes) under jitcheck, lockcheck and statecheck: {rnd}; "
        f"held across: {report['round']['held_across']}; unsanctioned "
        "host syncs "
        f"{[(r['kind'], r['site'], r['count']) for r in rnd_syncs]}; "
        "placements equal to the unarmed round bit for bit")
    sanitizer_gate(armed["jit"], armed["lock"], armed["state"],
                   "server round")
    log(f"sanitizers cost [{card}]: server round wall {unarmed['wall_ms']:.1f}"
        f" ms unarmed, {armed['wall_ms']:.1f} ms with jitcheck, lockcheck "
        "and statecheck armed (a reading, not a claim)")

    # -- c. the controlled schedule ----------------------------------------
    report["schedule"] = sched = schedule_drill(
        pmock, st, Server, StateStore, schedcheck, lockcheck, statecheck)
    count_launches()
    log(f"sanitizers [{card}]: schedcheck seed {SAN_SCHED_SEED} on "
        f"{SAN_SCHED_JOBS} jobs x {SAN_SCHED_PLACE} on {SAN_SCHED_NODES} "
        f"nodes: fingerprints {sched['fingerprints']} over "
        f"{sched['decisions']} decisions ({sched['timeout_wakes']} virtual "
        f"timeouts, {sched['preemptions']} preemptions); placements equal "
        "in both runs and to the unsanitized run")

    g1 = guard.state()
    assert not any(g1["dispatch"][k] - g0["dispatch"][k]
                   for k in ("timeout", "error"))
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t_phase
    log(f"sanitizers [{card}]: launches {launches}; phase "
        f"{report['seconds']:.1f} s")
    return report


def schedule_drill(pmock, st, Server, StateStore, schedcheck, lockcheck,
                   statecheck):
    """Run the small server scenario with no checker, then twice under
    schedcheck's seed SAN_SCHED_SEED (lockcheck and statecheck armed:
    its interposition layer and its witnesses). Job e may run on rack e
    only (meta.rack, struct_fleet's), so no two lanes meet on a node and
    the placements do not depend on the order the schedule gives the
    lanes: the unsanitized run places as the controlled ones must.
    Returns the fingerprints and the decision counts; raises unless the
    fingerprints and every run's placements are equal."""
    from nomad_tpu_torch.solver import batch, resident
    from nomad_tpu_torch.structs.job import reseed_ids
    from nomad_tpu_torch.tensor import pack as tp
    nodes = struct_fleet(pmock, SAN_SCHED_NODES)
    cfg = st.SchedulerConfiguration(
        scheduler_algorithm=st.SCHED_ALG_TPU_BINPACK)

    def scenario(controlled):
        # every run starts alike: the same ids (per-thread streams
        # restart) and cold pack caches, resident set and arena
        reseed_ids(SAN_SCHED_SEED)
        tp.reset_pack_caches()
        resident.invalidate_all("schedule drill")
        batch.arena_clear("schedule drill")
        jobs = []
        for e in range(SAN_SCHED_JOBS):
            j = pmock.job(id=f"sched-{e:02d}")
            j.task_groups[0].count = SAN_SCHED_PLACE
            j.constraints.append(st.Constraint(
                l_target="${meta.rack}", r_target=str(e), operand="="))
            jobs.append(j)
        if controlled:
            lockcheck.enable()
            statecheck.enable()
            schedcheck.enable()
            schedcheck.begin_run(SAN_SCHED_SEED)
        store = StateStore()
        for node in nodes:
            store.upsert_node(node)
        store.set_scheduler_config(cfg)
        for j in jobs:
            store.upsert_job(j)
        # the dispatch path alone: no leader loop or supervisor thread
        # joins the controlled schedule
        with EnvPatch(NOMAD_TPU_TORCH_WORKER_SUPERVISE="0"):
            server = Server(state=store, device=DEVICE, num_workers=1,
                            batch_width=SAN_SCHED_JOBS,
                            heartbeat_ttl=3600.0)
        server._start_background = lambda: None
        summary = None
        try:
            server.start()
            evals = [sched_eval(st, j, f"sched-eval-{e:016d}")
                     for e, j in enumerate(jobs)]
            ids = [ev.id for ev in evals]
            store.upsert_evals(evals)
            server.broker.enqueue_all(evals)
            settle(server, ids, "schedule drill", lambda: sum(
                len(m) for m in server_allocs(store, ids).values())
                >= SAN_SCHED_JOBS * SAN_SCHED_PLACE)
            got = server_allocs(store, ids)
            if controlled:
                summary = schedcheck.end_run()
                sc = schedcheck.state()
                lc, stc = lockcheck.state(), statecheck.state()
        finally:
            server.shutdown()
            if controlled:
                for m in (schedcheck, statecheck, lockcheck):
                    m.disable()
                    m._reset_for_tests()
        if controlled:
            assert not sc["deadlock_count"], sc["reports"]
            sanitizer_gate({"host_syncs": [], "rebuilds": [],
                            "mutations": []}, lc, stc, "schedule drill")
            return got, summary, sc
        return got, None, None

    plain, _, _ = scenario(False)
    runs = [scenario(True) for _ in range(2)]
    fps = [r[1]["fingerprint"] for r in runs]
    assert fps[0] == fps[1], f"schedule fingerprints differ: {fps}"
    for got, _, _ in runs:
        assert got == plain, "a controlled run placed differently"
    assert sum(len(m) for m in plain.values()) == \
        SAN_SCHED_JOBS * SAN_SCHED_PLACE
    return dict(fingerprints=fps,
                decisions=[r[1]["decisions"] for r in runs],
                timeout_wakes=[r[2]["timeout_wakes"] for r in runs],
                preemptions=[r[2]["preemptions"] for r in runs])


LEADER_TTL_S = 12.0                 # the heartbeat step's TTL: a round
                                    # of 9,900 heartbeats slowed by the
                                    # fan-out's load stays well inside
LEADER_PUMP_S = 1.0                 # the phase's heartbeat round
LEADER_SILENT = 100                 # nodes let go silent
LEADER_DRAIN = 3                    # nodes drained, max_parallel 1
LEADER_DONE_JOBS = 24               # jobs whose allocs end complete
LEADER_GC_KEEP = 1_000              # the GC watermark (terminal kept)
LEADER_GC_EVALS = 4                 # the generation after the compaction
LEADER_CRASH_PLACE = 100            # the supervisor drill's job
LEADER_NACK_S = 2.0                 # the drill's lease
LEADER_SETTLE_S = 300
JOBOPS_PLACE = 2_000                # the planned job's and the child's count
JOBOPS_MAX = 2_500                  # the planned job's scaling max
JOBOPS_DOWN = 1_000                 # the scale-down's count
JOBOPS_BIG_CPU = 16_000             # an ask no node holds (MHz)
JOBOPS_LOCK_WAIT_MS = 500.0         # the live store's lock, held by a plan


class PackBothWays:
    """TpuPlacementService.pack wrapped, while ``active``: each lane is
    packed through the route _pack_inner takes (the alloc table: its
    calls of _pack_usage_from_table are counted) and again with the
    table hidden (the incremental usage base), both timed on the wall
    clock, and every table of the two lanes compared bit for bit. A
    difference is recorded, not raised (an eval thread's exception
    would only nack the eval)."""

    def __init__(self, np, svc):
        self.np, self.cls = np, svc.TpuPlacementService
        self.active = False
        self.lock = threading.Lock()
        self.reset()

    def reset(self):
        self.table_ms, self.inc_ms, self.bad = [], [], []
        self.usage_ms = {"table": [], "incremental": []}
        self.table_calls = 0

    def __enter__(self):
        route, np = self, self.np
        real_pack = self.cls.pack
        real_table = self.cls._pack_usage_from_table
        real_inc = self.cls._pack_usage_incremental
        self._saved = (real_pack, real_table, real_inc)

        def timed_usage(key, fn):
            def run(service, *a):
                t0 = time.perf_counter()
                out = fn(service, *a)
                if route.active:
                    with route.lock:
                        route.usage_ms[key].append(
                            (time.perf_counter() - t0) * 1e3)
                        route.table_calls += key == "table"
                return out
            return run

        def pack(service, tg, places, nodes, pen=None):
            t0 = time.perf_counter()
            lane = real_pack(service, tg, places, nodes, pen)
            t1 = time.perf_counter()
            if lane is None or not route.active:
                return lane
            state = service.ctx.state
            service.ctx.state = _HiddenTable(state)
            try:
                other = real_pack(service, tg, places, nodes, pen)
            finally:
                service.ctx.state = state
            t2 = time.perf_counter()
            try:
                same_lane(np, lane, other, service.ctx.plan.eval_id)
            except AssertionError as e:
                with route.lock:
                    route.bad.append(str(e))
            with route.lock:
                route.table_ms.append((t1 - t0) * 1e3)
                route.inc_ms.append((t2 - t1) * 1e3)
            return lane
        self.cls.pack = pack
        self.cls._pack_usage_from_table = timed_usage("table", real_table)
        self.cls._pack_usage_incremental = timed_usage("incremental",
                                                       real_inc)
        return self

    def __exit__(self, *exc):
        (self.cls.pack, self.cls._pack_usage_from_table,
         self.cls._pack_usage_incremental) = self._saved

    def summary(self, what, card, n_lanes):
        assert not self.bad, (what, self.bad[:3])
        assert len(self.table_ms) == n_lanes, (what, len(self.table_ms))
        assert self.table_calls >= n_lanes, (what, self.table_calls)
        assert len(self.usage_ms["incremental"]) == n_lanes, what
        out = dict(lanes=len(self.table_ms),
                   table_pack_ms=ms_stats(self.table_ms),
                   incremental_pack_ms=ms_stats(self.inc_ms),
                   table_usage_ms=ms_stats(self.usage_ms["table"]),
                   incremental_usage_ms=ms_stats(
                       self.usage_ms["incremental"]),
                   table_calls=self.table_calls)
        log(f"leader {what} [{card}]: {n_lanes} lanes packed both ways, "
            f"equal bit for bit; ms median / max (wall, {n_lanes} eval "
            f"threads): the pack through the table "
            f"{out['table_pack_ms']['median']:.1f} / "
            f"{out['table_pack_ms']['max']:.1f} (first: cold memos), "
            f"again through the incremental base "
            f"{out['incremental_pack_ms']['median']:.1f} / "
            f"{out['incremental_pack_ms']['max']:.1f}; the usage step "
            f"alone: table {out['table_usage_ms']['median']:.2f} / "
            f"{out['table_usage_ms']['max']:.2f}, incremental "
            f"{out['incremental_usage_ms']['median']:.2f} / "
            f"{out['incremental_usage_ms']['max']:.2f}")
        return out


def leader_settle(server, what, extra=None, timeout=LEADER_SETTLE_S,
                  poll=0.1, sample=None):
    """Wait until the broker holds nothing ready, leased or waiting, no
    eval in the store is pending, and ``extra()`` holds (polled every
    ``poll`` s: a poll holds the interpreter lock the eval threads
    want); ``sample()`` runs at every poll."""
    def done():
        if sample is not None:
            sample()
        st = server.broker.stats()
        if st["total_ready"] or st["total_unacked"] or st["total_waiting"]:
            return False
        if any(e.status == "pending" for e in server.state.evals()):
            return False
        return extra is None or extra()
    deadline = time.monotonic() + timeout
    while not done():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(poll)


def live_by_job(store, job_ids):
    """Per job id: [(alloc name, node id)] of its live allocs."""
    out = {j: [] for j in job_ids}
    for a in store.allocs():
        if a.job_id in out and not a.terminal_status():
            out[a.job_id].append((a.name, a.node_id))
    return out


def check_replaced_once(jobs, live, away, what, store=None):
    """Every job at its count, each name once, none on ``away``. On a
    failure with ``store``, every alloc of a name that is doubled or
    missing is logged with the eval that wrote it."""
    for j in jobs:
        names = [n for n, _ in live[j.id]]
        count = j.task_groups[0].count
        if store is not None and not len(names) == len(set(names)) == count:
            seen = set(names)
            odd = {n for n in names if names.count(n) > 1} | {
                f"{j.id}.{j.task_groups[0].name}[{i}]" for i in range(count)
                if f"{j.id}.{j.task_groups[0].name}[{i}]" not in seen}
            for a in sorted(store.allocs_by_job(j.namespace, j.id),
                            key=lambda a: (a.name, a.create_index)):
                if a.name in odd:
                    ev = store.eval_by_id(a.eval_id)
                    log(f"  {what}: {a.name} {a.id[:8]} on {a.node_id} "
                        f"desired {a.desired_status} client "
                        f"{a.client_status} index {a.create_index}/"
                        f"{a.modify_index} eval {a.eval_id[:8]} "
                        f"{ev and (ev.triggered_by, ev.node_id, ev.status, ev.create_index, ev.modify_index)} "
                        f"prev {getattr(a, 'previous_allocation', '')[:8]}")
        assert len(names) == len(set(names)) == count, \
            (what, j.id, len(names), len(set(names)))
        assert not any(node in away for _, node in live[j.id]), (what, j.id)


def launch_counts(kernels):
    return {k.name: k.launches for k in kernels.KERNELS}


def launch_delta(kernels, before):
    return {k.name: k.launches - before[k.name] for k in kernels.KERNELS}


def sample_total_ms(snap, name):
    """The sum of a metrics series' samples (mean x count)."""
    ser = snap["samples"].get(name)
    return ser["mean_ms"] * ser["count"] if ser else 0.0


def job_ops_step(server, store, kernels, pmock, st, card, away):
    """Step 6 of phase 18: the job operations through an HttpServer on
    the loaded leader and ApiClient (every request through the API):
      a. job plan of a fresh job of JOBOPS_PLACE with a scaling block (min
         0, max JOBOPS_MAX): every placement predicted, nothing failed,
         diff Added; the live store's index, live allocs, alloc-table
         version and fold unchanged; the dry run launched wave_block. Then
         an ask no node holds, solved on the card: the group named with
         the exhausted dimension, every ready node evaluated and each one
         filtered or exhausted (counted from the solved lane's tables);
      b. the planned job registered: exactly the planned placements
         committed, no node over capacity, 0 plans rejected;
      c. scale to JOBOPS_MAX (the new placements through the batch worker
         and the kernels; status and one event with the eval id), to
         JOBOPS_MAX + 500 (400: out of bounds; no eval, no event), to
         JOBOPS_DOWN (stops only: no kernel launch); the job's policy
         listed;
      d. a parameterized batch job of JOBOPS_PLACE (meta_required input):
         no eval; a dispatch with input placed on the card; the same
         idempotency token again: the same child, no eval; a dispatch
         without input: 400.
    Returns the step's report; its ``launches`` are the kernels line's
    job_ops_launches."""
    from nomad_tpu_torch.api.client import ApiClient, ApiError
    from nomad_tpu_torch.api.http import HttpServer, to_jsonable
    from nomad_tpu_torch.server.telemetry import metrics

    t_step = time.perf_counter()
    k0 = launch_counts(kernels)
    out = {}
    rejected0 = server.planner.plans_rejected
    http = HttpServer(server, port=0)
    http.start()
    try:
        api = ApiClient(f"http://127.0.0.1:{http.port}",
                        timeout=LEADER_SETTLE_S)

        def live(job_id):
            return [a for a in store.allocs_by_job("default", job_id)
                    if not a.terminal_status()]

        def settle_count(job_id, n, what):
            leader_settle(server, what, lambda: len(live(job_id)) == n)

        def quiet(hold_s=1.0, timeout=30.0):
            # the leader's loops (the deployment watcher's counts) may
            # still write after the last step settled: wait until the
            # index holds for hold_s
            deadline = time.monotonic() + timeout
            idx, since = store.latest_index(), time.monotonic()
            while time.monotonic() - since < hold_s:
                assert time.monotonic() < deadline, "the store never quiet"
                time.sleep(0.1)
                if store.latest_index() != idx:
                    idx, since = store.latest_index(), time.monotonic()

        def table_state():
            with store._lock:
                return (store.latest_index(), store.alloc_table.version,
                        sum(1 for a in store.allocs()
                            if not a.terminal_status()),
                        store.alloc_table.usage_by_node())

        # -- a. plan -------------------------------------------------------
        job = pmock.job(id="ops-web")
        job.task_groups[0].count = JOBOPS_PLACE
        job.task_groups[0].scaling = {"min": 0, "max": JOBOPS_MAX}
        body = to_jsonable(job)
        quiet()
        before = table_state()
        m0 = metrics.snapshot()
        kp = launch_counts(kernels)
        # what a writer of the live store waits for while the plan runs:
        # the dump copies the tables under the lock and encodes outside
        waits, planning = [], threading.Event()

        def probe_lock():
            while not planning.is_set():
                t = time.perf_counter()
                with store._lock:
                    waits.append((time.perf_counter() - t) * 1e3)
                time.sleep(0.005)
        prober = threading.Thread(target=probe_lock, name="lock-probe")
        prober.start()
        t0 = time.perf_counter()
        try:
            plan = api.plan_job(job.id, job=body)
        finally:
            plan_ms = (time.perf_counter() - t0) * 1e3
            planning.set()
            prober.join()
        plan_launches = launch_delta(kernels, kp)
        m1 = metrics.snapshot()
        after = table_state()
        assert plan["placed"] == JOBOPS_PLACE, plan
        assert plan["annotations"]["desired_tg_updates"]["web"]["place"] \
            == JOBOPS_PLACE, plan["annotations"]
        assert plan["failed_tg_allocs"] == {}, plan["failed_tg_allocs"]
        assert plan["diff_type"] == "Added", plan
        assert after == before, "the dry run changed the live store"
        assert plan_launches["wave_block"] >= 1, plan_launches
        split = {k: sample_total_ms(m1, f"nomad.job.plan.{k}")
                 - sample_total_ms(m0, f"nomad.job.plan.{k}")
                 for k in ("dump", "restore", "schedule")}
        copied = m1["gauges"]["nomad.job.plan.allocs_copied"]["max"]
        lock_wait = max(waits)
        assert lock_wait < JOBOPS_LOCK_WAIT_MS, (lock_wait, split)
        out["plan"] = dict(ms=plan_ms, split_ms=split, live_allocs=before[2],
                           allocs_copied=copied, launches={
                               k: v for k, v in plan_launches.items() if v},
                           lock_wait_max_ms=lock_wait,
                           lock_probes=len(waits))
        log(f"job ops plan [{card}]: {JOBOPS_PLACE} placements predicted "
            f"in {plan_ms:.0f} ms (dump {split['dump']:.0f}, restore "
            f"{split['restore']:.0f}, scheduler {split['schedule']:.0f} "
            f"ms) over a copy of {copied:.0f} allocs ({before[2]} live); "
            f"the live store unchanged, its lock waited for at most "
            f"{lock_wait:.1f} ms over {len(waits)} probes; dry-run launches "
            f"{out['plan']['launches']}")
        big = pmock.job(id="ops-big")
        big.task_groups[0].count = 1
        big.task_groups[0].tasks[0].resources.cpu = JOBOPS_BIG_CPU
        quiet()
        before = table_state()
        kp = launch_counts(kernels)
        t0 = time.perf_counter()
        nofit = api.plan_job(big.id, job=to_jsonable(big))
        nofit_ms = (time.perf_counter() - t0) * 1e3
        nofit_launches = launch_delta(kernels, kp)
        ready = sum(1 for n in store.nodes() if n.ready())
        failed = nofit["failed_tg_allocs"]["web"]
        assert nofit["placed"] == 0, nofit
        # the card solved the lane and its tables explain every node:
        # each one filtered or exhausted, cpu among the dimensions
        assert sum(nofit_launches.values()) >= 1, nofit_launches
        assert failed["dimension_exhausted"].get("cpu", 0) >= 1, failed
        assert failed["nodes_evaluated"] == ready, (failed, ready)
        assert failed["nodes_filtered"] + sum(
            failed["dimension_exhausted"].values()) == ready, failed
        assert table_state() == before
        out["plan_no_fit"] = dict(ms=nofit_ms, failed=failed,
                                  ready_nodes=ready, launches={
                                      k: v for k, v in
                                      nofit_launches.items() if v})
        log(f"job ops plan [{card}]: an ask of {JOBOPS_BIG_CPU} MHz: group "
            f"web fails, {failed['nodes_evaluated']} nodes evaluated "
            f"(ready {ready}), exhausted {failed['dimension_exhausted']}; "
            f"{nofit_ms:.0f} ms; launches {out['plan_no_fit']['launches']}")

        # -- b. run what was planned ----------------------------------------
        t0 = time.perf_counter()
        reg = api.register_job(body)
        settle_count(job.id, JOBOPS_PLACE, "the planned job")
        run_ms = (time.perf_counter() - t0) * 1e3
        placed = live(job.id)
        assert len(placed) == plan["placed"]
        assert server.planner.plans_rejected == rejected0
        check_replaced_once([store.job_by_id("default", job.id)],
                            live_by_job(store, [job.id]), away,
                            "the planned job")
        check_node_capacity(store)
        out["run"] = dict(eval_id=reg["eval_id"], placed=len(placed),
                          register_to_placed_ms=run_ms)

        # -- c. scale --------------------------------------------------------
        t0 = time.perf_counter()
        up = api.scale_job(job.id, "web", JOBOPS_MAX, message="up")
        settle_count(job.id, JOBOPS_MAX, "the scale-up")
        up_ms = (time.perf_counter() - t0) * 1e3
        status = api.job_scale_status(job.id)["task_groups"]["web"]
        assert status["desired"] == status["placed"] == JOBOPS_MAX, status
        assert [(e["previous_count"], e["count"], e["eval_id"])
                for e in status["events"]] == \
            [(JOBOPS_PLACE, JOBOPS_MAX, up["eval_id"])], status["events"]
        evals0 = len(store.evals_by_job("default", job.id))
        try:
            api.scale_job(job.id, "web", JOBOPS_MAX + 500)
            raise AssertionError("a scale outside the bounds was taken")
        except ApiError as e:
            assert e.status == 400, e
        assert len(store.evals_by_job("default", job.id)) == evals0
        assert len(api.job_scale_status(job.id)["task_groups"]["web"][
            "events"]) == 1
        kd = launch_counts(kernels)
        t0 = time.perf_counter()
        api.scale_job(job.id, "web", JOBOPS_DOWN, message="down")
        settle_count(job.id, JOBOPS_DOWN, "the scale-down")
        down_ms = (time.perf_counter() - t0) * 1e3
        down_launches = launch_delta(kernels, kd)
        assert not any(down_launches.values()), down_launches
        pols = api.scaling_policies(job=job.id)
        assert [(p["job_id"], p["min"], p["max"]) for p in pols] == \
            [(job.id, 0, JOBOPS_MAX)], pols
        assert server.planner.plans_rejected == rejected0
        check_node_capacity(store)
        out["scale"] = dict(up_to_placed_ms=up_ms, down_to_stopped_ms=down_ms,
                            events=2)
        log(f"job ops scale [{card}]: {JOBOPS_PLACE} -> {JOBOPS_MAX} placed "
            f"in {up_ms:.0f} ms; {JOBOPS_MAX + 500} refused (400); "
            f"-> {JOBOPS_DOWN} stopped in {down_ms:.0f} ms with no "
            "launch; one policy listed")

        # -- d. dispatch -----------------------------------------------------
        param = pmock.job(id="ops-param")
        param.type = "batch"
        param.task_groups[0].count = JOBOPS_PLACE
        param.parameterized = st.ParameterizedJobConfig(
            meta_required=["input"])
        assert api.register_job(to_jsonable(param))["eval_id"] == ""
        t0 = time.perf_counter()
        first = api.dispatch_job(param.id, b"", {"input": "s3://in"},
                                 idempotency_token="ops-1")
        child = first["dispatched_job_id"]
        assert child.startswith(f"{param.id}/dispatch-") and \
            first["eval_id"], first
        settle_count(child, JOBOPS_PLACE, "the dispatched child")
        dispatch_ms = (time.perf_counter() - t0) * 1e3
        again = api.dispatch_job(param.id, b"", {"input": "s3://in"},
                                 idempotency_token="ops-1")
        assert again == {"dispatched_job_id": child, "eval_id": ""}, again
        try:
            api.dispatch_job(param.id, b"", {})
            raise AssertionError("a dispatch without its meta was taken")
        except ApiError as e:
            assert e.status == 400, e
        assert server.planner.plans_rejected == rejected0
        check_node_capacity(store)
        out["dispatch"] = dict(child=child, placed=len(live(child)),
                               dispatch_to_placed_ms=dispatch_ms)
        log(f"job ops dispatch [{card}]: child {child} placed "
            f"{JOBOPS_PLACE} in {dispatch_ms:.0f} ms; the token again: "
            "the same child, no eval; a missing meta key refused (400)")
    finally:
        http.shutdown()
    out["launches"] = launch_delta(kernels, k0)
    out["seconds"] = time.perf_counter() - t_step
    log(f"job ops [{card}]: launches "
        f"{ {k: v for k, v in out['launches'].items() if v} }; step "
        f"{out['seconds']:.1f} s")
    assert out["launches"]["wave_block"] >= 4, out["launches"]
    return out


def check_node_capacity(store):
    """No node's live usage (the alloc table's fold) above its
    capacity."""
    with store._lock:
        usage = store.alloc_table.usage_by_node()
    for nid, (cpu, mem, disk) in usage.items():
        node = store.node_by_id(nid)
        if node is None:
            continue
        res = node.node_resources
        assert cpu <= res.cpu.cpu_shares and \
            mem <= res.memory.memory_mb and \
            disk <= res.disk.disk_mb, (nid, cpu, mem, disk)


def leader_phase(np, torch, batch, guard, kernels, svc, tp, card):
    """The leader (phase 18): the port's Server (server/core.py) on the
    card, float32, tpu-binpack, width 32, phase 13's fleet and 32
    mock.job service jobs x 2,000 (migrate.max_parallel 1), with its
    leader loops running:
      1. the table path: the headline generation's 32 lanes each packed
         both ways before the barrier (PackBothWays: the alloc table and
         the incremental base, equal bit for bit; each route's median
         pack ms); 64,000 placed, 0 rejected, the table's fold equal to
         a recount (fold_parity_mismatch 0);
      2. heartbeats: heartbeat_ttl 12 s; the phase heartbeats 9,900
         nodes every second and lets 100 go silent (none of the 9,900
         may leave ready meanwhile): exactly those 100 go down,
         every lost alloc is replaced once on other nodes by the kernels
         through the node-down fan-out, 0 plans rejected; one of them
         flaps down twice more (update_node_status, heartbeat) and its
         third recovery is held by the quarantine; then the TTL goes
         back to an hour;
      3. the drainer: 3 nodes drained at once; every alloc on them
         migrates (at most one of a job in flight at a time), every
         drain completes, the nodes stay ineligible, 0 rejected;
      4. GC: 24 jobs deregistered, their stops acknowledged complete and
         every other live alloc running (update_allocs_from_client);
         run_gc_once with a
         watermark of 1,000 deletes the oldest terminal allocs past it
         and compacts the alloc table (no free row left, the fold equal
         to a recount); a new generation of 4 evals x 2,000 is packed
         both ways again, equal, and placed;
      5. the supervisor: worker.crash armed once; the batch worker that
         leases the next eval dies, the supervisor restarts its slot,
         the eval comes back after its 2 s lease and is placed;
      6. the job operations through the HTTP API (job_ops_step): a plan
         (a dry run on a copy of the loaded state), the planned job
         registered, scaled up, refused past its bounds and scaled down,
         and a parameterized job dispatched.
    Launch counts are read around steps 1-5 (the kernels line's
    leader_launches) and around step 6 apart (job_ops_launches); no eval
    falls back to the host and no dispatch fails."""
    from nomad_tpu_torch import mock as pmock
    from nomad_tpu_torch import structs as st
    from nomad_tpu_torch.faultinject import faults
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.server.telemetry import metrics
    from nomad_tpu_torch.state.store import StateStore

    st.reseed_ids(SEED + 18)
    t_phase = time.perf_counter()
    g0 = guard.state()
    c0 = dict(metrics.snapshot()["counters"])
    report = {}
    nodes = struct_fleet(pmock, N_NODES)

    def make_jobs(prefix, n, count):
        jobs = []
        for e in range(n):
            j = pmock.job(id=f"{prefix}-{e:02d}")
            j.task_groups[0].count = count
            j.task_groups[0].migrate = st.MigrateStrategy(max_parallel=1)
            jobs.append(j)
        return jobs

    def generation(server, jobs, prefix, what):
        evals = [sched_eval(st, j, f"{prefix}-{e:016d}")
                 for e, j in enumerate(jobs)]
        for j in jobs:
            server.state.upsert_job(j)
        t0 = time.perf_counter()
        server.state.upsert_evals(evals)
        server.broker.enqueue_all(evals)
        ids = {j.id for j in jobs}
        leader_settle(server, what, lambda: sum(
            len(v) for v in live_by_job(server.state, ids).values())
            >= sum(j.task_groups[0].count for j in jobs))
        return (time.perf_counter() - t0) * 1e3

    def counter(name):
        return metrics.snapshot()["counters"].get(name, 0) - c0.get(name, 0)

    tp.reset_pack_caches()
    jobs = make_jobs("ldr-job", N_EVALS, N_PLACE)
    store = StateStore()
    for node in nodes:
        store.upsert_node(node)
    store.set_scheduler_config(st.SchedulerConfiguration(
        scheduler_algorithm=st.SCHED_ALG_TPU_BINPACK))
    with EnvPatch(NOMAD_TPU_TORCH_WORKER_CHECK_S="0.1",
                  NOMAD_TPU_TORCH_WORKER_RESTART_BASE_S="0.1",
                  NOMAD_TPU_TORCH_WORKER_RESTART_MAX_S="1"):
        server = Server(state=store, device=DEVICE,
                        batch_width=SERVER_WIDTH, heartbeat_ttl=3600.0)
    both = PackBothWays(np, svc)
    kernels.reset_launches()
    pump_stop = threading.Event()
    try:
        with both:
            server.start()
            assert len(server.workers) == 2 and server.supervisor._thread
            # -- 1. the table path --------------------------------------
            both.active = True
            wall = generation(server, jobs, "ldr-eval", "headline")
            both.active = False
            live = live_by_job(store, [j.id for j in jobs])
            check_replaced_once(jobs, live, set(), "headline")
            assert server.planner.plans_rejected == 0
            with store._lock:
                assert store.alloc_table.fold_parity_mismatch() == 0
            report["table_path"] = dict(
                both.summary("table path", card, N_EVALS), wall_ms=wall)
            # -- 2. heartbeats -----------------------------------------
            step = time.perf_counter()
            silent = {n.id for n in nodes[::N_NODES // LEADER_SILENT]}
            assert len(silent) == LEADER_SILENT
            beating = [n.id for n in nodes if n.id not in silent]
            before = live
            lost = sum(1 for v in before.values() for _, node in v
                       if node in silent)
            rejected0 = server.planner.plans_rejected
            server.heartbeat_ttl = LEADER_TTL_S
            for n in nodes:
                server.heartbeat(n.id)
            beats = [0, 0.0]         # rounds, the longest round's s

            def pump():
                while not pump_stop.wait(LEADER_PUMP_S):
                    t0 = time.perf_counter()
                    for nid in beating:
                        server.heartbeat(nid)
                    beats[0] += 1
                    beats[1] = max(beats[1], time.perf_counter() - t0)

            def still_beating():
                # a beating node that left ready: the rounds fell behind
                # the TTL (a node-down cascade would follow)
                gone = [nid for nid in beating[::97]
                        if store.node_by_id(nid).status != "ready"]
                assert not gone, ("heartbeat rounds fell behind the TTL",
                                  gone[:3], beats)
            pumper = threading.Thread(target=pump, daemon=True,
                                      name="leader-heartbeats")
            pumper.start()
            deadline = time.monotonic() + LEADER_TTL_S + LEADER_SETTLE_S
            while not all(store.node_by_id(nid).status == "down"
                          for nid in silent):
                assert time.monotonic() < deadline, "silent nodes not down"
                time.sleep(0.05)
            t_down = time.perf_counter()
            leader_settle(server, "lost allocs replaced",
                          sample=still_beating)
            live = live_by_job(store, [j.id for j in jobs])
            check_replaced_once(jobs, live, silent, "node-down fan-out",
                                store)
            down = {n.id for n in store.nodes() if n.status != "ready"}
            assert down == silent, (len(down), len(silent))
            assert server.planner.plans_rejected == rejected0
            t_replaced = time.perf_counter()
            flapper = sorted(silent)[0]
            flaps = []
            for _ in range(2):
                server.heartbeat(flapper)
                flaps.append(store.node_by_id(flapper).status)
                server.update_node_status(flapper, "down")
            server.heartbeat(flapper)
            flaps.append(store.node_by_id(flapper).status)
            assert flaps == ["ready", "ready", "down"], flaps
            assert server.flaps.quarantine_remaining(flapper) > 0
            leader_settle(server, "flap evals")
            server.heartbeat_ttl = 3600.0
            for nid in beating:
                server.heartbeat(nid)
            pump_stop.set()
            pumper.join(30.0)
            assert not pumper.is_alive()
            hb = dict(silent=LEADER_SILENT, down=len(down), lost=lost,
                      replaced=lost, heartbeat_rounds=beats[0],
                      longest_round_s=beats[1],
                      flaps=flaps,
                      quarantined=counter("nomad.heartbeat.flap_quarantined"),
                      deferred=counter("nomad.heartbeat.quarantine_deferred"),
                      rejected=server.planner.plans_rejected - rejected0,
                      ttl_to_down_ms=(t_down - step) * 1e3,
                      down_to_replaced_ms=(t_replaced - t_down) * 1e3,
                      seconds=time.perf_counter() - step)
            assert hb["deferred"] >= 1 and hb["quarantined"] >= 1
            report["heartbeats"] = hb
            log(f"leader heartbeats [{card}]: {LEADER_SILENT} silent nodes "
                f"down {hb['ttl_to_down_ms']:.0f} ms after their last beat "
                f"(TTL {LEADER_TTL_S:.0f} s); {lost} lost allocs replaced "
                f"once each in {hb['down_to_replaced_ms']:.0f} ms, 0 "
                f"rejected; flapper {flaps} (quarantined, "
                f"{hb['deferred']} recovery deferred); {beats[0]} rounds of "
                f"{len(beating)} heartbeats, the longest {beats[1]:.2f} s; "
                f"{hb['seconds']:.1f} s")
            # -- 3. the drainer ----------------------------------------
            step = time.perf_counter()
            holders = {node for v in live.values() for _, node in v}
            drained = [n.id for n in nodes[7::7] if n.id in holders
                       and n.id not in silent][:LEADER_DRAIN]
            assert len(drained) == LEADER_DRAIN
            on_drained = {name for v in live.values() for name, node in v
                          if node in drained}
            rejected0 = server.planner.plans_rejected
            for nid in drained:
                server.drain_node(nid, st.DrainStrategy(deadline_s=3600.0))
            in_flight = [0, 0]       # most of a job at once; samples

            def flight():
                per = {}
                for a in store.allocs():
                    if a.desired_transition.migrate and \
                            not a.terminal_status():
                        per[a.job_id] = per.get(a.job_id, 0) + 1
                in_flight[0] = max([in_flight[0]] + list(per.values()))
                in_flight[1] += 1
            leader_settle(server, "the drains", lambda: all(
                not store.node_by_id(nid).drain for nid in drained),
                poll=0.25, sample=flight)
            live = live_by_job(store, [j.id for j in jobs])
            check_replaced_once(jobs, live, silent | set(drained), "drain",
                                store)
            for nid in drained:
                node = store.node_by_id(nid)
                assert node.scheduling_eligibility == "ineligible", nid
            assert in_flight[0] <= 1, in_flight[0]
            assert server.planner.plans_rejected == rejected0
            report["drain"] = dict(nodes=LEADER_DRAIN,
                                   migrated=len(on_drained),
                                   max_in_flight_a_job=in_flight[0],
                                   in_flight_samples=in_flight[1],
                                   rejected=0,
                                   seconds=time.perf_counter() - step)
            log(f"leader drain [{card}]: {LEADER_DRAIN} nodes, "
                f"{len(on_drained)} allocs migrated (at most "
                f"{in_flight[0]} of a job in flight in {in_flight[1]} "
                f"samples), every drain complete,"
                f" 0 rejected; {report['drain']['seconds']:.1f} s")
            # -- 4. GC --------------------------------------------------
            step = time.perf_counter()
            done_ids = {j.id for j in jobs[:LEADER_DONE_JOBS]}
            for j in jobs[:LEADER_DONE_JOBS]:
                server.deregister_job(j.namespace, j.id)
            leader_settle(server, "the stops")
            acks, done = [], []
            for a in store.allocs():
                if a.client_terminal_status():
                    continue
                u = a.copy_skip_job()
                if a.job_id in done_ids:
                    u.client_status = "complete"
                    done.append(u)
                elif not a.terminal_status():
                    u.client_status = "running"
                    acks.append(u)
            server.update_allocs_from_client(acks)
            server.update_allocs_from_client(done)
            terminal = sum(1 for a in store.allocs() if a.terminal_status())
            rows_before = store.alloc_table.n_rows
            t_gc = time.perf_counter()
            out = server.run_gc_once(terminal_watermark=LEADER_GC_KEEP)
            gc_ms = (time.perf_counter() - t_gc) * 1e3
            assert out["watermark_allocs"] == terminal - LEADER_GC_KEEP > 0, \
                (out, terminal)
            assert out["compacted"] is not None, out
            with store._lock:
                assert store.alloc_table.free_rows == 0
                assert store.alloc_table.fold_parity_mismatch() == 0
            gjobs = make_jobs("ldr-gen", LEADER_GC_EVALS, N_PLACE)
            both.reset()
            both.active = True
            gwall = generation(server, gjobs, "ldr-gen-eval",
                               "the generation after GC")
            both.active = False
            check_replaced_once(gjobs, live_by_job(
                store, [j.id for j in gjobs]), silent | set(drained),
                "the generation after GC")
            with store._lock:
                assert store.alloc_table.fold_parity_mismatch() == 0
            report["gc"] = dict(
                acked=len(acks), completed=len(done), terminal=terminal,
                gc=out, gc_ms=gc_ms, rows_before=rows_before,
                compactions=counter("nomad.gc.table_compactions"),
                after=dict(both.summary("after GC", card, LEADER_GC_EVALS),
                           wall_ms=gwall),
                seconds=time.perf_counter() - step)
            log(f"leader gc [{card}]: {LEADER_DONE_JOBS} jobs stopped, "
                f"{len(done)} stops acknowledged complete, {len(acks)} "
                f"allocs running, {terminal} terminal; run_gc_once "
                f"{gc_ms:.0f} ms: {out['watermark_allocs']} past the "
                f"watermark deleted, table {out['compacted']}; "
                f"{report['gc']['seconds']:.1f} s")
            # -- 5. the supervisor -------------------------------------
            step = time.perf_counter()
            sup = server.supervisor
            deaths0, restarts0 = sup.deaths_detected, sup.restarts_total
            server.broker.nack_timeout = LEADER_NACK_S
            faults.arm("worker.crash", "error", count=1)
            try:
                cjob = pmock.job(id="ldr-crash")
                cjob.task_groups[0].count = LEADER_CRASH_PLACE
                cev = server.register_job(cjob)
                leader_settle(server, "the crashed worker's eval", lambda: (
                    sup.restarts_total > restarts0
                    and all(w.is_alive() for w in server.workers)
                    and len(live_by_job(store, [cjob.id])[cjob.id])
                    >= LEADER_CRASH_PLACE))
            finally:
                faults.disarm_all()
            assert store.eval_by_id(cev.id).status == "complete"
            check_replaced_once([cjob], live_by_job(store, [cjob.id]),
                                set(), "after the crash")
            report["supervisor"] = dict(
                deaths=sup.deaths_detected - deaths0,
                restarts=sup.restarts_total - restarts0,
                placed=LEADER_CRASH_PLACE,
                seconds=time.perf_counter() - step)
            assert report["supervisor"]["deaths"] >= 1
            log(f"leader supervisor [{card}]: worker.crash: "
                f"{report['supervisor']['deaths']} death, "
                f"{report['supervisor']['restarts']} restart, the eval "
                f"placed after its {LEADER_NACK_S:.0f} s lease; "
                f"{report['supervisor']['seconds']:.1f} s")
            launches = launch_counts(kernels)
            # -- 6. the job operations ---------------------------------
            report["job_ops"] = job_ops_step(
                server, store, kernels, pmock, st, card,
                silent | set(drained))
    finally:
        pump_stop.set()
        server.shutdown()
    left = [t.name for t in threading.enumerate() if t.is_alive()
            and t.name.startswith(("batch-worker-", "batch-eval-", "plan-",
                                   "eval-broker-", "worker-supervisor-",
                                   "heartbeat", "core-gc", "periodic",
                                   "deploy-watch", "drainer",
                                   "leader-heartbeats"))]
    assert not left, left
    g1 = guard.state()
    report["host_fallbacks"] = (g1["host_fallback_dispatches"]
                                - g0["host_fallback_dispatches"])
    report["failed_dispatches"] = {
        k: g1["dispatch"][k] - g0["dispatch"][k]
        for k in ("timeout", "error")}
    assert report["host_fallbacks"] == 0, report["host_fallbacks"]
    assert not any(report["failed_dispatches"].values()), \
        report["failed_dispatches"]
    report["watcher_errors"] = counter("nomad.server.watcher_error")
    assert report["watcher_errors"] == 0
    # every placement of the phase made by the kernels
    report["placements_tpu"] = counter("nomad.scheduler.placements_tpu")
    report["placements_host_fallback"] = counter(
        "nomad.scheduler.placements_host_fallback")
    assert report["placements_host_fallback"] == 0
    assert report["placements_tpu"] >= (N_EVALS + LEADER_GC_EVALS) * N_PLACE
    report["launches"] = launches
    report["job_ops_launches"] = report["job_ops"]["launches"]
    report["seconds"] = time.perf_counter() - t_phase
    log(f"leader [{card}]: launches {launches}; phase "
        f"{report['seconds']:.1f} s")
    assert launches["wave_block"] >= 1, launches
    return report


AGENT_NODES = 3                     # the dev agent's simulated nodes
AGENT_BATCH_RUN_FOR = "4s"          # the batch job's mock run time
AGENT_SETTLE_S = 180
AGENT_PROFILE_PLACE = 3             # the profiled job's count
AGENT_READERS = 4                   # read-back requests in flight
AGENT_SELF_BLOCKS = ("nomad", "solver_guard", "xferobs", "node_flaps",
                     "worker_pool", "eval_quarantine", "lockcheck",
                     "jitcheck", "statecheck", "schedcheck")

AGENT_SERVICE_HCL = """
job "agent-service" {
  group "web" {
    count = 3
    spread {
      attribute = "${node.unique.id}"
      weight    = 100
    }
    task "t" {
      driver = "mock"
      resources { cpu = 200 memory = 128 }
    }
  }
}
"""
AGENT_BATCH_HCL = """
job "agent-batch" {
  type = "batch"
  group "g" {
    count = 3
    task "t" {
      driver = "mock"
      config { run_for = "%s" }
      resources { cpu = 100 memory = 64 }
    }
  }
}
""" % AGENT_BATCH_RUN_FOR
AGENT_PROFILED_HCL = """
job "agent-profiled" {
  group "g" {
    count = %d
    task "t" {
      driver = "mock"
      resources { cpu = 100 memory = 64 }
    }
  }
}
""" % AGENT_PROFILE_PLACE
AGENT_SYSTEM_HCL = """
job "agent-system" {
  type = "system"
  group "sys" {
    task "t" {
      driver = "mock"
      resources { cpu = 100 memory = 64 }
    }
  }
}
"""
AGENT_GPU_HCL = """
job "%s" {
  group "g" {
    count = %d
    task "t" {
      driver = "mock"
      resources {
        cpu    = 100
        memory = 64
        device "nvidia/gpu" { count = 1 }
      }
    }
  }
}
"""


class AgentProcess:
    """``python3 -m nomad_tpu_torch.api.devagent`` as a child process on
    the card: stdout read line by line on a thread (the ==> line carries
    the bound address), stderr to a file under ``work``."""

    def __init__(self, args, work):
        import queue
        self.err_path = work / "agent.err"
        err = open(self.err_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "nomad_tpu_torch.api.devagent"] + args,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True)
        err.close()
        self.addr = None
        self._addr_lock = threading.Lock()
        self.lines = queue.Queue()
        threading.Thread(target=lambda: [self.lines.put(ln)
                                         for ln in self.proc.stdout],
                         daemon=True, name="agent-stdout").start()

    def address(self, timeout):
        """The agent's address, from its ==> line (read once; the lock
        keeps two callers from splitting its lines)."""
        import queue
        with self._addr_lock:
            deadline = time.monotonic() + timeout
            while self.addr is None and time.monotonic() < deadline:
                try:
                    line = self.lines.get(timeout=1.0)
                except queue.Empty:
                    if self.proc.poll() is not None:
                        break
                    continue
                if line.startswith("==> nomad-tpu dev agent: http"):
                    self.addr = line.split()[4]
            if self.addr is None:
                raise AssertionError("the dev agent printed no address: "
                                     + self.err_path.read_text()[-4000:])
            return self.addr

    def stop(self):
        """SIGTERM; the exit code (the child is killed past 60 s)."""
        import signal
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()


def cli_run(addr, *argv):
    """``python3 -m nomad_tpu_torch.cli -address ADDR ARGV``; its stdout
    (a non-zero exit raises)."""
    r = subprocess.run([sys.executable, "-m", "nomad_tpu_torch.cli",
                        "-address", addr] + list(argv), cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (argv, r.stdout, r.stderr)
    return r.stdout


def read_allocs(addr, job_ids):
    """Every job's live allocs through GET /v1/job/<id>/allocations, as
    {job id: {alloc name: [node id, normalized score]}}, AGENT_READERS
    requests in flight (phase 19's reader process)."""
    from concurrent.futures import ThreadPoolExecutor
    from nomad_tpu_torch.api.client import ApiClient
    api = ApiClient(addr, timeout=SERVER_SETTLE_S)

    def one(job_id):
        return job_id, {
            a["name"]: [a["node_id"], a["metrics"]["scores"][
                f"{a['node_id']}.normalized-score"]]
            for a in api.job_allocations(job_id)
            if a["desired_status"] == "run"
            and a["client_status"] not in ("complete", "failed", "lost")}
    with ThreadPoolExecutor(AGENT_READERS) as ex:
        return dict(ex.map(one, job_ids))


def prom_counter(addr, name):
    """A counter of the agent's Prometheus text (0 when absent)."""
    import urllib.request
    with urllib.request.urlopen(f"{addr}/v1/metrics?format=prometheus",
                                timeout=60) as r:
        for ln in r.read().decode().splitlines():
            if ln.startswith(name + " "):
                return float(ln.split()[1])
    return 0.0


def cli_alloc_statuses(addr, job_id):
    """The Status column of `job status JOB`'s Allocations table."""
    out = cli_run(addr, "job", "status", job_id)
    rows = out.split("\nAllocations\n", 1)[1].splitlines()[1:]
    return sorted(r.split()[-1] for r in rows if r.strip())


def agent_settle(server, ids, job_ids, n_allocs, what):
    """settle()'s condition, polled every 10 ms and counting the jobs'
    allocs through the store's job index (a poll that walks every alloc
    of the store, or spins, would take the interpreter from the server it
    waits for)."""
    def done():
        st = server.broker.stats()
        if st["total_ready"] or st["total_unacked"]:
            return False
        if any(server.state.eval_by_id(e).status == "pending" for e in ids):
            return False
        return sum(len(server.state.allocs_by_job("default", j))
                   for j in job_ids) >= n_allocs
    deadline = time.monotonic() + SERVER_SETTLE_S
    while not done():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def http_round(api, route, kernels, jobs, to_jsonable):
    """The paused protocol over HTTP: pause the broker, register
    ``jobs`` as JSON, resume; the 32 evals reach one batch. Returns
    (eval ids, t0 of the first registration)."""
    cfg = "/v1/operator/scheduler/configuration"
    api.post(cfg, {"scheduler_algorithm": "tpu-binpack",
                   "pause_eval_broker": True})
    t0 = time.perf_counter()
    ids = [api.register_job(to_jsonable(j))["eval_id"] for j in jobs]
    route.order = {e: k for k, e in enumerate(ids)}
    route.reset()
    kernels.reset_launches()
    api.post(cfg, {"scheduler_algorithm": "tpu-binpack"})
    return ids, t0


def agent_phase(np, torch, batch, guard, lpq, kernels, svc, tp, card):
    """The agent's entry points on the card (phase 19):
      a. the dev agent as a process (python3 -m
         nomad_tpu_torch.api.devagent --nodes 3 --tpu --port 0, on cuda):
         three HCL jobs through the CLI's job run (a service job with a
         spread: row 2; a batch job: row 1; a system job: row 4), their
         allocs running and the batch job's complete (the mock driver's
         run_for), node status listing its nodes, operator solver status
         with the guard not degraded and mesh.devices 1, /v1/agent/self
         with every stats block, the Prometheus text with the placement
         counters, SIGTERM ending it with exit 0;
      b. full width through HTTP: an HttpServer over a port Server
         (tpu-binpack, batching at width 32, float32 on the card, TTL
         3,600 s) holding the headline fleet (10,000 nodes, registered
         in process as the dev agent's clients register), the broker
         paused through the API, 32 mock.job jobs x 2,000 registered as
         JSON through ApiClient, the broker resumed; every job's allocs
         read back through /v1/job/<id>/allocations, placements (node
         and normalized-score bits per alloc name) equal to a port
         Server fed the same Job structs in process under the same
         protocol (register_job from request-named threads: the same
         eval ids); registration to last commit for both routes;
      c. the card's fingerprint: FingerprintManager(probe_cuda=True)
         reports gpu.count 1 and one nvidia/gpu device group named as
         nvidia-smi names the card; the node registered on agent (a)
         through HttpServerConn; an HCL job asking device "nvidia/gpu"
         lands on it; the same ask at count 2 places one and blocks one;
      d. /v1/agent/torch-profile on agent (a): started as the phase
         starts (its CUPTI start-up, many seconds, overlaps step b), one
         job through HTTP, stopped: the chrome trace names the
         wave_block kernel;
      e. operator snapshot save and restore of agent (a) through the
         CLI, every job kept, then a job through job run placed by the
         agent's kernels (its placements_tpu counter).
    The read-back of step b runs in a reader process
    (``chip_smoke.py --read-allocs``) with AGENT_READERS requests in
    flight, so its JSON decoding overlaps the handler's encoding.
    ``launches`` (the kernels line's agent_launches) are (b)'s HTTP
    round (the dev agent's kernels run in its own process)."""
    from nomad_tpu_torch import mock as pmock
    from nomad_tpu_torch import structs as st
    from nomad_tpu_torch.api.client import ApiClient, HttpServerConn
    from nomad_tpu_torch.api.http import HttpServer, to_jsonable
    from nomad_tpu_torch.client import FingerprintManager
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.server import worker as worker_mod
    from nomad_tpu_torch.state.store import StateStore

    t_phase = time.perf_counter()
    work = ROOT / "build" / "agent-phase"
    work.mkdir(parents=True, exist_ok=True)
    report = {}
    launches = {k.name: 0 for k in kernels.KERNELS}
    g0 = guard.state()

    def count_launches():
        for k in kernels.KERNELS:
            launches[k.name] += k.launches

    # a. the dev agent starts first: its start-up overlaps step b
    # no --device: the agent asks for the card (cpu only in a rehearsal)
    agent = AgentProcess(["--nodes", str(AGENT_NODES), "--tpu", "--port",
                          "0"] + (["--device", "cpu"] if DEVICE == "cpu"
                                  else []), work)
    trace_dir = work / "torch-trace"
    prof = {}

    def start_profile():
        # d. the profiler starts as soon as the agent serves
        try:
            addr = agent.address(AGENT_SETTLE_S)
            t0 = time.perf_counter()
            prof["start"] = ApiClient(addr, timeout=AGENT_SETTLE_S).post(
                "/v1/agent/torch-profile",
                {"action": "start", "dir": str(trace_dir)})
            prof["start_s"] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 -- raised in step d
            prof["error"] = e
    profiler = threading.Thread(target=start_profile, daemon=True,
                                name="agent-profile-start")
    profiler.start()
    try:
        # -- b. full width through HTTP ----------------------------------
        def fleet_server():
            store = StateStore()
            store.set_scheduler_config(st.SchedulerConfiguration(
                scheduler_algorithm=st.SCHED_ALG_TPU_BINPACK))
            server = Server(state=store, device=DEVICE,
                            batch_width=SERVER_WIDTH, heartbeat_ttl=3600.0)
            return server

        def make_jobs():
            jobs = []
            for e in range(N_EVALS):
                j = pmock.job(id=f"agent-job-{e:02d}")
                j.task_groups[0].count = N_PLACE
                jobs.append(j)
            return jobs

        def register_fleet(server):
            for node in struct_fleet(pmock, N_NODES):
                server.register_node(node)

        server = fleet_server()
        http = None
        try:
            with ServerRoute(server, worker_mod, batch, lpq) as route:
                server.start()
                register_fleet(server)
                http = HttpServer(server, port=0)
                http.start()
                api = ApiClient(f"http://127.0.0.1:{http.port}",
                                timeout=300.0)
                st.reseed_ids(SEED + 19)
                jobs = make_jobs()
                ids, t0 = http_round(api, route, kernels, jobs,
                                     to_jsonable)
                agent_settle(server, ids, [j.id for j in jobs],
                             N_EVALS * N_PLACE, "agent http round")
                count_launches()
                http_ms = (max(route.commit_end) - t0) * 1e3
                assert route.nacks == 0, route.nacked
                t_read = time.perf_counter()
                r = subprocess.run(
                    [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--read-allocs", api.address]
                    + [j.id for j in jobs], cwd=ROOT, capture_output=True,
                    text=True, timeout=SERVER_SETTLE_S, check=True)
                rows = json.loads(r.stdout)
                got = {eid: {name: (node, struct_score_bits(score), [])
                             for name, (node, score) in rows[j.id].items()}
                       for j, eid in zip(jobs, ids)}
                read_s = time.perf_counter() - t_read
                assert got == server_allocs(server.state, ids)
                n_placed = sum(len(m) for m in got.values())
                assert n_placed == N_EVALS * N_PLACE, n_placed
                http_sum = route.summary(
                    "agent http", card, t0, n_placed, N_EVALS,
                    SimpleNamespace(sections=dict))
        finally:
            if http is not None:
                http.shutdown()
            server.shutdown()

        # the compared route: the same Job structs in process
        direct = fleet_server()
        try:
            with ServerRoute(direct, worker_mod, batch, lpq) as route:
                direct.start()
                register_fleet(direct)
                pause = st.SchedulerConfiguration(
                    scheduler_algorithm=st.SCHED_ALG_TPU_BINPACK,
                    pause_eval_broker=True)
                direct.apply_scheduler_config(pause)
                st.reseed_ids(SEED + 19)
                djobs = make_jobs()
                t0 = time.perf_counter()
                dids = []
                for j in djobs:
                    out = {}
                    t = threading.Thread(target=lambda j=j: out.update(
                        ev=direct.register_job(j)), name="http-request")
                    t.start()
                    t.join()
                    dids.append(out["ev"].id)
                assert dids == ids, "eval ids differ between the routes"
                route.order = {e: k for k, e in enumerate(dids)}
                route.reset()
                direct.apply_scheduler_config(st.SchedulerConfiguration(
                    scheduler_algorithm=st.SCHED_ALG_TPU_BINPACK))
                agent_settle(direct, dids, [j.id for j in djobs],
                             N_EVALS * N_PLACE, "agent in-process round")
                direct_ms = (max(route.commit_end) - t0) * 1e3
                want = server_allocs(direct.state, dids)
        finally:
            direct.shutdown()
        diff = {e: sum(want[e].get(n) != v for n, v in got[e].items())
                for e in ids}
        assert got == want, ("HTTP placements != the in-process route's",
                             {e: d for e, d in diff.items() if d})
        report["http"] = dict(
            evals=N_EVALS, placements=n_placed,
            registration_to_last_commit_ms=http_ms,
            in_process_ms=direct_ms, read_back_s=read_s,
            placements_per_s=http_sum["placements_per_s"],
            per_eval=http_sum["per_eval"], applier=http_sum["applier"])
        log(f"agent http [{card}]: {n_placed} placements through "
            f"POST /v1/jobs, registration to last commit {http_ms:.1f} ms "
            f"(in process {direct_ms:.1f} ms), read back through "
            f"/v1/job/<id>/allocations in {read_s:.2f} s, equal to the "
            "in-process route bit for bit")

        # -- d. the profiler around one job through the agent's API -----
        t_a = time.perf_counter()
        profiler.join(AGENT_SETTLE_S)
        assert not profiler.is_alive(), "the profiler did not start"
        if "error" in prof:
            raise prof["error"]
        assert prof["start"]["tracing"] is True, prof
        addr = agent.address(AGENT_SETTLE_S)
        aapi = ApiClient(addr, timeout=120.0)

        def poll(cond, what):
            deadline = time.monotonic() + AGENT_SETTLE_S
            while not cond():
                if time.monotonic() > deadline:
                    raise AssertionError(f"timed out waiting for {what}")
                time.sleep(0.05)

        def statuses(job_id):
            return sorted(a["client_status"]
                          for a in aapi.job_allocations(job_id))

        poll(lambda: len(aapi.nodes()) == AGENT_NODES, "the agent's nodes")
        tp1 = time.perf_counter()
        aapi.register_job_hcl(AGENT_PROFILED_HCL)
        poll(lambda: statuses("agent-profiled") == ["running"]
             * AGENT_PROFILE_PLACE, "the profiled job running")
        tp2 = time.perf_counter()
        reply = aapi.post("/v1/agent/torch-profile",
                          {"action": "stop", "dir": str(trace_dir)})
        tp3 = time.perf_counter()
        trace = json.loads(Path(reply["trace"]).read_text())
        kernels_ev = [ev for ev in trace.get("traceEvents", [])
                      if ev.get("cat") == "kernel"]
        names = sorted({ev.get("name", "") for ev in kernels_ev})
        assert any("wave_block" in n for n in names), names[:20]
        kernel_us = sum(ev.get("dur", 0) for ev in kernels_ev)
        # the job's device window: its first kernel to its last
        k0 = min(ev["ts"] for ev in kernels_ev)
        k1 = max(ev["ts"] + ev.get("dur", 0) for ev in kernels_ev)
        report["profile"] = dict(
            trace=str(Path(reply["trace"]).relative_to(ROOT)),
            kernels=names, kernel_events=len(kernels_ev),
            kernel_us=kernel_us, kernel_window_us=k1 - k0,
            events=len(trace["traceEvents"]), start_s=prof["start_s"],
            job_s=tp2 - tp1, stop_s=tp3 - tp2)
        log(f"agent profile [{card}]: kernels in the trace {names}, "
            f"{kernel_us:.1f} us of kernel time, {len(kernels_ev)} kernel "
            f"events over {(k1 - k0) / 1e3:.3f} ms; "
            f"{len(trace['traceEvents'])} events; start "
            f"{prof['start_s']:.2f} s (overlapped), the job "
            f"{tp2 - tp1:.2f} s, stop and export {tp3 - tp2:.2f} s")

        # -- a. the dev agent, through the CLI ---------------------------

        for name, src, n in (("agent-service", AGENT_SERVICE_HCL, 3),
                             ("agent-batch", AGENT_BATCH_HCL, 3),
                             ("agent-system", AGENT_SYSTEM_HCL,
                              AGENT_NODES)):
            path = work / f"{name}.nomad"
            path.write_text(src)
            assert "Evaluation" in cli_run(addr, "job", "run", str(path))
            poll(lambda name=name, n=n: statuses(name) == ["running"] * n,
                 f"{name}'s allocs running")
            assert cli_alloc_statuses(addr, name) == ["running"] * n
        svc_nodes = {a["node_id"] for a in
                     aapi.job_allocations("agent-service")}
        assert len(svc_nodes) == AGENT_NODES, svc_nodes   # the spread
        poll(lambda: statuses("agent-batch") == ["complete"] * 3,
             "the agent's batch job complete")
        assert cli_alloc_statuses(addr, "agent-batch") == ["complete"] * 3
        out = cli_run(addr, "node", "status")
        assert out.count("ready") == AGENT_NODES, out
        out = cli_run(addr, "operator", "solver", "status")
        lines = {ln.split("=")[0].strip(): ln.split("=", 1)[1].strip()
                 for ln in out.splitlines() if "=" in ln}
        assert lines["degraded"] == "False", out
        if DEVICE == "cuda":
            # the init probe ran and saw the one card
            assert lines["ok"] == "True" and lines["checked"] == "True", \
                out
            assert lines["mesh.devices"] == "1", out
        assert int(lines["dispatch.ok"]) >= 3, out
        self_info = aapi.get("/v1/agent/self")
        assert set(self_info["stats"]) == set(AGENT_SELF_BLOCKS), \
            sorted(self_info["stats"])
        import urllib.request
        with urllib.request.urlopen(
                f"{addr}/v1/metrics?format=prometheus", timeout=60) as r:
            prom = r.read().decode()
        placed_tpu = [ln for ln in prom.splitlines()
                      if ln.startswith("nomad_scheduler_placements_tpu ")]
        assert placed_tpu and float(placed_tpu[0].split()[1]) >= 9, \
            placed_tpu
        report["devagent"] = dict(
            seconds=time.perf_counter() - t_a,
            placements_tpu=float(placed_tpu[0].split()[1]),
            dispatch_ok=int(lines["dispatch.ok"]))

        # -- c. the card's fingerprint, registered on the agent ----------
        smi_name = card.split(",")[0].strip()
        gnode = FingerprintManager(data_dir=str(work), probe_cuda=True
                                   ).fingerprint_node(name="agent-gpu-node")
        assert gnode.attributes["gpu.count"] == "1", gnode.attributes
        (group,) = gnode.node_resources.devices
        assert (group.vendor, group.type, group.name) == (
            "nvidia", "gpu", smi_name), (group, smi_name)
        assert len(group.instance_ids) == 1
        # the node agent's driver fingerprint (its mock driver), as a
        # client agent adds its drivers' before registering
        gnode.drivers["mock"] = st.DriverInfo(detected=True, healthy=True)
        gnode.compute_class()
        conn = HttpServerConn(addr)
        conn.register_node(gnode)
        beat = threading.Event()

        def heartbeats():
            while not beat.wait(1.0):
                conn.heartbeat(gnode.id)
        hb = threading.Thread(target=heartbeats, daemon=True,
                              name="agent-gpu-heartbeat")
        hb.start()
        try:
            one = work / "gpu-one.nomad"
            one.write_text(AGENT_GPU_HCL % ("gpu-one", 1))
            cli_run(addr, "job", "run", str(one))
            poll(lambda: len(aapi.job_allocations("gpu-one")) == 1,
                 "the device job placed")
            (a1,) = aapi.job_allocations("gpu-one")
            assert a1["node_id"] == gnode.id, a1["node_id"]
            devs = [d for t in a1["allocated_resources"]["tasks"].values()
                    for d in t["devices"]]
            assert [d["device_ids"] for d in devs] == \
                [group.instance_ids], devs
            # the job stopped, and the node agent reports its alloc
            # complete: the card is free again
            cli_run(addr, "job", "stop", "gpu-one")
            poll(lambda: [a["desired_status"] for a in
                          aapi.job_allocations("gpu-one")] == ["stop"],
                 "the device job stopped")
            allocs, _ = conn.pull_allocs(gnode.id, 0, 5.0)
            done = [x for x in allocs if x.job_id == "gpu-one"]
            for x in done:
                x.client_status = "complete"
            conn.update_allocs(done)
            two = work / "gpu-two.nomad"
            two.write_text(AGENT_GPU_HCL % ("gpu-two", 2))
            cli_run(addr, "job", "run", str(two))
            poll(lambda: any(e["status"] == "blocked" for e in
                             aapi.job_evaluations("gpu-two")),
                 "the second device alloc blocked")
            placed = aapi.job_allocations("gpu-two")
            assert [a["node_id"] for a in placed] == [gnode.id], placed
            report["fingerprint"] = dict(
                name=group.name, instance_ids=group.instance_ids,
                memory_mib=group.attributes["memory_mib"],
                gpu_count=gnode.attributes["gpu.count"],
                placed_two=len(placed),
                blocked=sum(e["status"] == "blocked" for e in
                            aapi.job_evaluations("gpu-two")))
        finally:
            beat.set()
            hb.join()
        log(f"agent [{card}]: dev agent at {addr}: service/batch/system "
            f"through the CLI, solver status not degraded with "
            f"mesh.devices 1; fingerprint {group.vendor}/{group.type}/"
            f"{group.name} x{len(group.instance_ids)}, the device job on "
            "it, the count-2 ask one placed and one blocked")

        # -- e. an operator snapshot saved and restored ------------------
        t_e = time.perf_counter()
        snap = work / "agent.snap"
        out = cli_run(addr, "operator", "snapshot", "save", str(snap))
        assert out.startswith(f"Snapshot written to {snap} ("), out
        jobs_before = sorted(j["id"] for j in aapi.jobs())
        out = cli_run(addr, "operator", "snapshot", "restore", str(snap))
        assert out.startswith("Snapshot restored (index "), out
        assert sorted(j["id"] for j in aapi.jobs()) == jobs_before
        tpu0 = prom_counter(addr, "nomad_scheduler_placements_tpu")
        after = work / "agent-after-restore.nomad"
        after.write_text(AGENT_PROFILED_HCL.replace(
            '"agent-profiled"', '"agent-after-restore"'))
        assert "Evaluation" in cli_run(addr, "job", "run", str(after))
        poll(lambda: statuses("agent-after-restore") == ["running"]
             * AGENT_PROFILE_PLACE, "the job after the restore running")
        tpu1 = prom_counter(addr, "nomad_scheduler_placements_tpu")
        assert tpu1 - tpu0 >= AGENT_PROFILE_PLACE, (tpu0, tpu1)
        report["snapshot"] = dict(bytes=snap.stat().st_size,
                                  placed_after=AGENT_PROFILE_PLACE,
                                  seconds=time.perf_counter() - t_e)
        log(f"agent snapshot [{card}]: operator snapshot save "
            f"({report['snapshot']['bytes']} bytes) and restore through "
            f"the CLI, every job kept; a job of {AGENT_PROFILE_PLACE} then "
            f"placed by the agent's kernels; "
            f"{report['snapshot']['seconds']:.1f} s")
    finally:
        rc = agent.stop()
    assert rc == 0, ("the dev agent's exit code", rc,
                     agent.err_path.read_text()[-4000:])
    report["devagent"]["exit"] = rc

    g1 = guard.state()
    report["host_fallbacks"] = (g1["host_fallback_dispatches"]
                                - g0["host_fallback_dispatches"])
    assert report["host_fallbacks"] == 0, report["host_fallbacks"]
    assert not any(g1["dispatch"][k] - g0["dispatch"][k]
                   for k in ("timeout", "error"))
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t_phase
    log(f"agent [{card}]: launches {launches}; phase "
        f"{report['seconds']:.1f} s")
    assert launches["wave_block"] >= 2, launches
    return report


def check_capacity_lane(np, lane, chosen, n_places):
    """A wave lane's placements: every one made, every node within its
    capacity (the lane's own asks over its initial usage)."""
    placed = chosen >= 0
    assert int(placed.sum()) == n_places, (int(placed.sum()), n_places)
    pos, k = np.unique(chosen[placed], return_counts=True)
    c, s, b = lane.const, lane.init, lane.batch
    for cap, used, ask in ((c.cpu_cap, s.used_cpu, b.ask_cpu[0]),
                           (c.mem_cap, s.used_mem, b.ask_mem[0]),
                           (c.disk_cap, s.used_disk, b.ask_disk[0])):
        assert bool(np.all(used[pos] + k * float(ask) <= cap[pos])), \
            "over capacity"
    assert bool(np.all(c.feasible[pos]))



# --------------------------------------------------------------------------
# A/B timing of the redesigned kernels (python3 chip_smoke.py --ab TAG=DIR
# ... [--ab-kernels NAME,...]): each DIR's sources of AB_SOURCES (DIR
# "repo" is nomad_tpu_torch/csrc) built into build/ab/lib/TAG and launched
# through the port's wrappers on the main paths' own inputs, in turns
# (first to last, then last to first), every output equal to the plain
# version's. A variant built with -DNT_STEP_CLOCKS (--ab-clocks) exports
# nt_step_clocks(unsigned long long out[16], int reset) where its kernel
# stamps step sections: lane 0's clock64() totals per section
# (csrc/wave_common.cuh NT_CLK), read after one launch. The wavefront's
# case also takes each variant's device ms and each of its kernels'
# device ms a call (kernel_split: the prep and the step loop apart);
# coord_scatter's cases run each variant's package (PACKAGED): the card's
# 4 cells with the payload already there, and the whole
# mesh_delta_scatter from the host payload.

AB_SOURCES = {"dense_scan": "dense_scan.cu",
              "dense_preempt": "dense_preempt.cu",
              "wave_preempt": "wave_preempt.cu",
              "lp_relax": "lp_relax.cu",
              "wave_block": "wave_block.cu",
              "wave_compact": "wave_compact.cu",
              "wavefront": "wavefront.cu",
              "system_fit": "system_fit.cu",
              "delta_scatter": "delta_scatter.cu",
              "dense_shard": "dense_shard.cu",
              "coord_scatter": "delta_scatter.cu",
              "lp_shard": "lp_relax.cu"}
WAVE_KERNELS = ("wave_block", "wave_compact", "wavefront")
# kernels whose A/B runs each variant's own package (its wrapper and the
# host code around the kernel, imported from the tree that holds DIR as
# its nomad_tpu_torch/csrc), so call time and device time both compare
PACKAGED = ("system_fit", "delta_scatter", "dense_shard", "lp_shard",
            "coord_scatter")
MESH_G3 = ((32, 16_384), 64)        # the mesh residency g3 leaf, its bucket
SCATTER_G3 = (1_572_864, 256)       # the residency path's g3 scatter
AB_REPEATS = 10
AB_TILE = 2048                      # the older one-block walk's tile
# the sections' names: the wave kernels' (wave_warp.cuh's step loop,
# wave_block.cu's run decision: score the slots, the window scan, the
# arg-best (row 1: and the runner-up), commit (row 1: the winner's
# stream, the run length and its stores; row 2: the hand-off to the head
# warp), the saturation shift, the refill row; "steps" counts steps
# scored (row 1: run decisions), "refills" saturations; row 2's head
# warp: "hwait" waiting for a commit, "hwork" scoring heads), the dense
# kernels' (the older one-block walk
# had a per-step statistics pass (0), a block scan per tile (2) and
# thread 0's rescore of the winner (9); the cluster walk's 2 is the
# count exchange, and its "tiles" are rounds), wave_preempt's, whose
# "steps" leave out frozen steps and whose "searches" counts the
# eviction searches run, and lp_relax's (block 0's phases and its waits
# at the grid barriers after them, then its row phase's own passes)
AB_SECTIONS = {
    "wave": ("score", "scan", "best", "commit", "shift", "refill", "total",
             "steps", "refills", "hwait", "hwork"),
    "dense": ("stats", "score", "scan", "mark", "best", "commit", "total",
              "steps", "tiles", "rescore"),
    "wave_preempt": ("usage", "search", "score", "scan", "best", "commit",
                     "shift", "total", "steps", "searches"),
    "lp_relax": ("start", "rows", "rows_sync", "nodes", "nodes_sync",
                 "final", "total", "steps", "logits", "max", "windows",
                 "tree", "x"),
    # the persistent mesh kernels' first unit's block 0 (dense_shard.cu,
    # lp_relax.cu lp_shard_kernel), read per step
    "dense_shard": ("-", "score", "count_x", "mark", "record_x", "commit",
                    "total", "steps"),
    "lp_shard": ("start", "rows", "rows_sync", "exchange", "nodes",
                 "nodes_sync", "total", "steps", "logits", "max", "windows",
                 "tree", "x"),
}


def ab_build(kernels, tag, csrc, defines, names):
    """Build the kernels ``names`` of ``csrc`` (one nvcc each, together)
    and return ({name: Kernel}, {name: ctypes lib})."""
    import ctypes
    out = ROOT / "build" / "ab" / "lib" / tag
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *defines, "-I",
               str(csrc), "-o", str(out / f"{name}.so"),
               str(csrc / AB_SOURCES[name])]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    ks, libs = {}, {}
    for name, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ab {tag}: nvcc failed for {name}:\n{text}")
        for line in text.splitlines():
            if "registers" in line or "smem" in line:
                log(f"  ab {tag} {name}: {line.strip()}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        proto = getattr(kernels, name.upper())
        cls = (ab_trimmed(kernels) if name == "dense_scan" and "l_max"
               not in (csrc / "dense_scan.cu").read_text()
               else kernels.Kernel)
        k = cls(name, proto.source, proto.replaces, proto.symbols,
                proto.cluster_symbol)
        k.bind(lib)
        ks[name], libs[name] = k, lib
    return ks, libs


def ab_trimmed(kernels):
    """The Kernel class of a dense_scan built before its largest-limit
    argument: the same launch without that last int."""
    class Trimmed(kernels.Kernel):
        def launch(self, dtype, tensors, ints):
            super().launch(dtype, tensors, list(ints)[:-1])

    return Trimmed


def ab_clocks(torch, lib, run, names):
    """Lane 0's section totals over one launch of ``run``."""
    import ctypes
    buf = (ctypes.c_ulonglong * 16)()
    fn = lib.nt_step_clocks
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    torch.cuda.synchronize()
    assert fn(buf, 1) == 0
    run()
    torch.cuda.synchronize()
    assert fn(buf, 1) == 0
    return dict(zip(names, [int(x) for x in buf]))


def ab_close_positions(np, torch, dense, preempt, run_plain):
    """Run a plain version and record, per step and lane, the walk
    position (0-based) of the node that brings the counted options to the
    step's limit (N where the step never gets there)."""
    from nomad_tpu_torch.solver import scoring
    rec = []

    def spy(final, fit, L):
        low = fit & (final <= scoring.SKIP_THRESHOLD)
        skipped = low & (torch.cumsum(low.long(), dim=1) <= scoring.MAX_SKIP)
        cc = torch.cumsum((fit & ~skipped).long(), dim=1)
        hit = cc >= L
        N = fit.shape[1]
        rec.append(torch.where(hit.any(dim=1),
                               hit.to(torch.uint8).argmax(dim=1),
                               torch.full_like(cc[:, 0], N)).cpu())
        return scoring._select(final, fit, L)

    saved = dense._select, preempt._select
    dense._select = preempt._select = spy
    try:
        want = run_plain()
    finally:
        dense._select, preempt._select = saved
    close = torch.stack(rec, dim=1).numpy()          # (E, P)
    return want, close


def ab_summary(np, close, N):
    reach = np.minimum(close + 1, N)
    walked = np.minimum(-(-reach // AB_TILE) * AB_TILE, N)
    return dict(
        steps=int(close.size), never_close=float((close >= N).mean()),
        close_mean=float(reach.mean()),
        close_p50=float(np.percentile(reach, 50)),
        close_p90=float(np.percentile(reach, 90)),
        close_max=int(reach.max()), tile_walk_mean=float(walked.mean()),
        walk_over_close=float(walked.sum() / reach.sum()))


def ab_same(torch, name, fields, got, want):
    """Raise unless every output equals the plain version's, as bits."""
    for f, g, w in zip(fields, got, want):
        for x, y in (zip(g, w) if isinstance(g, tuple) else ((g, w),)):
            same_bits(torch, f"ab {name}: {f}", x, y)


def ab_dense_case(np, torch, dense, preempt, name, kname, ten, salg):
    fn, pfn = ((dense.dense_scan, dense.dense_scan_plain)
               if kname == "dense_scan" else
               (preempt.dense_preempt, preempt.dense_preempt_plain))
    E, N = ten[0].cpu_cap.shape
    P = ten[2].ask_cpu.shape[1]

    def want():
        w, close = ab_close_positions(
            np, torch, dense, preempt, lambda: pfn(*ten, spread_alg=salg))
        return w, dict(close=ab_summary(np, close, int(N)))

    return dict(name=name, kernel=kname, shape=dict(E=int(E), N=int(N),
                                                    P=int(P)),
                run=lambda: fn(*ten, spread_alg=salg), want=want,
                same=lambda g, w: ab_same(torch, name, g._fields, g, w))


def ab_dense_cases(np, torch, bp, batch, dense, preempt, svc, tp, world):
    """The main paths' dense groups as tensors on the card: the dense
    slice's spread group (E 32), distinct_property and reserved-core
    lanes (E 1 each), and the preemption slice's dense group (E 8); then
    the kernel phases' mixed float32 groups (E 32 each)."""
    dev = torch.device(DEVICE)
    lanes = slice2_lanes(np, tp, svc, world, "float32", n_spread=N_EVALS)
    names = {N_EVALS: "distinct_property", N_EVALS + 1: "reserved_cores"}
    cases = []
    for g in batch.fuse_lanes(lanes):
        ten, _ = dense.fused_tensors(
            (g.const, g.init, g.batch), (dense.lane_casts(g.dtype_name),) * 3,
            device=dev)
        name = "spread" if len(g.idxs) > 1 else names[g.idxs[0]]
        cases.append((name, "dense_scan", ten, g.spread_alg))
    dl = tier5_lanes(np, tp, svc, world, "float32", n_lanes=PD_EVALS,
                     n_place=PD_PLACE, dense=True)
    for g in batch.fuse_lanes(dl):
        ten, _ = dense.fused_tensors(
            (g.const, g.init, g.batch, g.ptab, g.pinit),
            preempt.preempt_casts("float32"), device=dev)
        cases.append(("tier5_dense", "dense_preempt", ten, g.spread_alg))
    # off the main paths: the kernel phases' mixed groups, whose fuzz
    # lanes include windows that never close (scarce capacity)
    trees = dense_mixed_group(np, bp, svc, tp, world, "float32",
                              np.random.default_rng(SEED))
    cases.append(("mixed_dense", "dense_scan", dense.lane_tensors(
        *trees, dtype_name="float32", device=dev), False))
    trees = preempt_group(np, bp, tp, svc, world, "float32", SEED + 1,
                          dense=True)
    ten, _ = dense.fused_tensors(trees, preempt.preempt_casts("float32"),
                                 device=dev)
    cases.append(("mixed_preempt", "dense_preempt", ten, False))
    return [ab_dense_case(np, torch, dense, preempt, *c) for c in cases]


def ab_wave_preempt_case(torch, preempt, name, inp):
    ten = preempt.wave_preempt_tensors(inp, torch.device(DEVICE))
    E, C, _ = inp.compact.shape
    fields = ("chosen", "scores", "n_yielded", "evict_rows")
    return dict(
        name=name, kernel="wave_preempt",
        shape=dict(E=int(E), C=int(C), B=int(inp.B),
                   A=int(inp.cand["cpu"].shape[-1])),
        run=lambda: preempt.wave_preempt(*ten, spread_alg=False, B=inp.B),
        want=lambda: (preempt.wave_preempt_plain(*ten, spread_alg=False,
                                                 B=inp.B), {}),
        same=lambda g, w: ab_same(torch, name, fields, g, w))


def ab_wave_preempt_cases(np, torch, bp, batch, preempt, svc, tp, world):
    """The preemption slice's windowed tier-5 group (E 32, 2,000
    placements, B 32, A 16); off the main path the kernel phase's mixed
    group (16 tier-5 + 16 fuzz lanes with max_parallel groups) and its
    B = 128 and A = 64 fuzz groups."""
    lanes = tier5_lanes(np, tp, svc, world, "float32", n_lanes=PW_EVALS,
                        n_place=PW_PLACE)
    (g,) = batch.fuse_lanes(lanes)
    assert g.wave, "the tier-5 windowed group did not take the wave route"
    cases = [("tier5_wave", preempt.wave_preempt_inputs(
        g.const, g.init, g.batch, g.ptab, g.pinit, dtype_name="float32"))]
    trees = preempt_group(np, bp, tp, svc, world, "float32", SEED,
                          dense=False)
    cases.append(("mixed_wave", preempt.wave_preempt_inputs(
        *trees, dtype_name="float32")))
    for tag, lanes in wave_preempt_small_lanes(
            np, np.random.default_rng(SEED + 2), "float32"):
        cases.append((f"fuzz_{tag}", preempt.wave_preempt_inputs(
            *stack_preempt(np, bp, lanes), dtype_name="float32")))
    return [ab_wave_preempt_case(torch, preempt, *c) for c in cases]


def ab_lp_case(torch, lpq, name, ins):
    L, N = ins[0].shape
    return dict(name=name, kernel="lp_relax",
                shape=dict(L=int(L), N=int(N), steps=int(ins[6].shape[0])),
                run=lambda: lpq.lp_relax(*ins),
                want=lambda: (lpq.lp_relax_plain(*ins), {}),
                same=lambda g, w: compare_lp(torch, f"ab {name}", g, w))


def ab_lp_cases(np, torch, lpq, svc, world):
    """The LP tier's first generation's relaxation inputs (L_pad 128 x
    N 16,384 x 48 steps, captured from _solve_lp_group), and an
    oversubscribed fuzz case at L_pad 256 x N 65,536."""
    seen = []
    real = lpq.lp_relax

    def keep(*a):
        seen.append(a)
        return lpq.lp_relax_plain(*a)

    lpq.lp_relax = keep
    try:
        lpq._solve_lp_group(lpq_gen1_lanes(np, svc, world), {},
                            device=DEVICE)
    finally:
        lpq.lp_relax = real
    temps = torch.from_numpy(lpq.lp_temperatures(LP_STEPS)).to(DEVICE)
    rng = np.random.default_rng(SEED + 40 + 8)
    ins = [torch.from_numpy(a).to(DEVICE)
           for a in lp_fuzz_inputs(np, rng, 256, 65_536, over=True)]
    return [ab_lp_case(torch, lpq, "lp_tier", seen[0]),
            ab_lp_case(torch, lpq, "lp_fuzz_over", ins + [temps])]


def ab_wave_case(torch, name, kname, shape, run, plain, split=False):
    """A wave case; ``split`` adds device ms and each CUDA kernel's
    device time a call (kernel_split) to every variant's turns."""
    fields = ("chosen", "scores", "n_yielded")
    return dict(name=name, kernel=kname, shape=shape, run=run,
                want=lambda: (plain(), {}), split=split,
                same=lambda g, w: ab_same(torch, name, fields, g, w))


def kernel_split(torch, run, repeats=AB_REPEATS):
    """{CUDA kernel name: device ms a call} over ``repeats`` warm calls of
    ``run``, from torch.profiler's CUPTI trace; {"error": ...} where the
    profiler fails, {} where the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(repeats):
                run()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            us = (getattr(ev, "self_device_time_total", 0)
                  or getattr(ev, "self_cuda_time_total", 0))
            if us > 0:
                out[ev.key[:120]] = us / 1e3 / repeats
        return out
    except Exception as exc:            # a measurement, not the port
        return {"error": repr(exc)[:200]}


def ab_wave_cases(np, torch, bp, batch, dense, wave, svc, tp, world, names):
    """The wave slice's headline group (E 32 x 2,000, B 32: row 1's
    main-path launch), its spread-lane and penalty-lane groups (row 2's
    two main-path launches), the kernel phase's four float32 groups and
    its edge groups over 10 spread values, and the wavefront phase's 32
    lanes x 2,000 x 16,384 (row 10)."""
    dev = torch.device(DEVICE)
    cases = []
    head = pack_lanes(np, tp, svc, world, "float32", kind="plain",
                      n_lanes=N_EVALS)
    extra = (pack_lanes(np, tp, svc, world, "float32", kind="spread",
                        n_lanes=1)
             + pack_lanes(np, tp, svc, world, "float32", kind="penalty",
                          n_lanes=1))
    for lanes, tags in ((head, ("headline",)),
                        (extra, ("spread_lane", "penalty_lane"))):
        for g, tag in zip(batch.fuse_lanes(lanes), tags):
            inp = wave.wave_inputs(g.const, g.init, g.batch,
                                   dtype_name="float32")
            cm, sf, si, pn, sp = wave.wave_tensors(inp, dev)
            kname = "wave_block" if inp.use_block else "wave_compact"
            shape = dict(E=int(cm.shape[0]), C=int(cm.shape[1]), B=inp.B,
                         S=int(cm.shape[2]) - 8)
            cases.append(ab_wave_case(
                torch, tag, kname, shape,
                wave_call(wave, kname, (cm, sf, si, pn), sp, inp.B),
                wave_call(wave, kname, (cm, sf, si, pn), sp, inp.B,
                          plain=True)))
    for kname, B, S, ten, spd in (
            wave_groups(np, torch, bp, svc, tp, world, "float32")
            + wave_limit_groups(np, torch, bp, "float32", max_v=10)):
        kind = "block" if kname == "wave_block" else "compact"
        P = int(ten[0].shape[1]) - B
        cases.append(ab_wave_case(
            torch, f"kernel_{kind}_B{B}_S{S}"
            + (f"_P{P}" if P != P_PAD else ""), kname,
            dict(E=int(ten[0].shape[0]), C=int(ten[0].shape[1]), B=B, S=S),
            wave_call(wave, kname, ten, spd, B),
            wave_call(wave, kname, ten, spd, B, plain=True)))
    if "wavefront" in names:
        trees = wavefront_trees(np, head)
        (c, s, b), _ = dense.fused_tensors(
            trees, (dense.lane_casts("float32"),) * 3, device=dev)
        E, N = c.cpu_cap.shape
        cases.append(ab_wave_case(
            torch, "wavefront", "wavefront",
            dict(E=int(E), N=int(N), P=int(b.ask_cpu.shape[1]), B=32),
            lambda: wave.wavefront(c, s, b, spread_alg=False),
            lambda: wave.wavefront_plain(c, s, b, spread_alg=False),
            split=True))
    return [c for c in cases if c["kernel"] in names]


def ab_phase(np, torch, kernels, cases, built):
    """Time every variant on every case in turns, each output equal to
    the plain version's; the clock variants' step sections."""
    variants = [t for t, (_, clk) in built.items() if not clk]
    out = {}
    for case in cases:
        name, kname, run = case["name"], case["kernel"], case["run"]
        proto = getattr(kernels, kname.upper())

        def use(tag):
            setattr(kernels, kname.upper(), built[tag][0][0][kname])

        log(f"ab {name} ({kname}): the plain version, then the turns")
        want, info = case["want"]()
        row = dict(kernel=kname, **case["shape"], **info, ms={}, turns=[])
        for tag in variants + variants[::-1]:
            use(tag)
            case["same"](run(), want)
            ms = timed(torch, run, AB_REPEATS)
            row["turns"].append((tag, ms))
            k = built[tag][0][0][kname]
            if k.cluster_symbol and hasattr(k.lib(), k.cluster_symbol):
                row.setdefault("cluster", {})[tag] = k.last_cluster()
        for tag in variants:
            row["ms"][tag] = statistics.median(
                ms for t, ms in row["turns"] if t == tag)
        if case.get("split"):
            row["device_ms"], row["split"] = {}, {}
            for tag in variants + variants[::-1]:
                use(tag)
                row["device_ms"].setdefault(tag, []).append(
                    device_ms(torch, run, AB_REPEATS))
            for tag in variants:
                use(tag)
                row["split"][tag] = kernel_split(torch, run)
                log(f"  split {tag}: device "
                    f"{row['device_ms'][tag]} ms; kernels (ms a call) "
                    + json.dumps(row["split"][tag]))
        row["clocks"] = {}
        sections = AB_SECTIONS.get(kname, AB_SECTIONS[
            "wave" if kname in WAVE_KERNELS else "dense"])
        for tag, ((ks, libs), clk) in built.items():
            if not clk or not hasattr(libs[kname], "nt_step_clocks"):
                continue
            use(tag)
            c = ab_clocks(torch, libs[kname], run, sections)
            k = ks[kname]
            if k.cluster_symbol and hasattr(k.lib(), k.cluster_symbol):
                c["cluster"] = k.last_cluster()
            row["clocks"][tag] = c
        setattr(kernels, kname.upper(), proto)
        log(f"ab {name} ({kname}) {case['shape']}: "
            + " ".join(f"{t}={m:.4f}" for t, m in row["ms"].items())
            + f" ms; cluster {row.get('cluster')}"
            + (f"; close {row['close']}" if "close" in row else ""))
        for tag, c in row["clocks"].items():
            tot = max(c["total"], 1)
            shown = [k for k in sections if k not in (
                "total", "steps", "tiles", "searches", "refills", "hwait",
                "hwork")]
            c["total_ms"] = c["total"] / spin_cycles_per_ms(torch)
            log(f"  clocks {tag}: C={c.get('cluster')} steps={c['steps']} "
                f"total_ms={c['total_ms']:.4f} "
                + (f"rounds={c['tiles']} " if "tiles" in c else "")
                + (f"searches={c['searches']} " if "searches" in c else "")
                + (f"refills={c['refills']} " if "refills" in c else "")
                + " ".join(f"{k}={c[k] / tot:.3f}" for k in shown))
        out[name] = row
    return out


def ab_package(tag, csrc):
    """The port package beside ``csrc`` (a tree's nomad_tpu_torch/csrc):
    the repository's own for its csrc, else imported as ab_pkg_<tag>.
    Returns a namespace of its kernels, system, service and resident
    modules."""
    import importlib
    import importlib.util
    from types import SimpleNamespace
    pkg_dir = csrc.parent
    mods = ("kernels", "solver.system", "solver.service", "solver.resident",
            "parallel.mesh")
    if pkg_dir == (ROOT / "nomad_tpu_torch").resolve():
        name = "nomad_tpu_torch"
    else:
        if csrc.name != "csrc" or not (pkg_dir / "kernels.py").is_file():
            raise SystemExit(f"--ab {tag}: {PACKAGED} need DIR to be a "
                             "tree's nomad_tpu_torch/csrc (its package "
                             "beside it)")
        name = f"ab_pkg_{tag}"
        spec = importlib.util.spec_from_file_location(
            name, pkg_dir / "__init__.py",
            submodule_search_locations=[str(pkg_dir)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    got = [importlib.import_module(f"{name}.{m}") for m in mods]
    return SimpleNamespace(**dict(zip(("kernels", "system", "service",
                                       "resident", "mesh"), got)))


def ab_case(name, kname, shape, make, want, same, repeats=None):
    """A packaged case: ``make(pkg)`` returns the call to time, run with
    that package's wrapper and host code (``repeats`` warm calls a turn,
    AB_REPEATS by default)."""
    return dict(name=name, kernel=kname, shape=shape, make=make, want=want,
                same=same, repeats=repeats or AB_REPEATS)


def ab_mesh_cases(np, torch, batch, dense, lpq, svc, tp, world, names):
    """Rows 9a and 9c through each variant's mesh route on 4 cells of the
    card (its mesh_solve / mesh_lpq: inputs shipped, the kernel or the
    host-driven step loop, results read): the dense slice's
    distinct_property and reserved-core lanes on (1, 4) (the main path's
    E = 1 groups), its 32 spread lanes on the forced grids (1, 4) and
    (2, 2) (3 calls a turn: the host-driven loop takes seconds), and the
    LP tier's L 128 x N 16,384 relaxation on (4, 1); float32, every
    output equal to the one-card route's."""
    from nomad_tpu_torch.solver import exchange
    cells = [DEVICE] * MESH_CELLS
    cases = []
    if "dense_shard" in names:
        lanes = slice2_lanes(np, tp, svc, world, "float32",
                             n_spread=N_EVALS)
        groups = batch.fuse_lanes(lanes)
        try:
            for g in groups:
                trees = tuple(type(t)(*(np.array(a) for a in t))
                              for t in (g.const, g.init, g.batch))
                want = tuple(x.cpu().numpy() for x in dense.solve_placements(
                    *trees, spread_alg=g.spread_alg, dtype_name="float32",
                    device=DEVICE)[:3])
                if len(g.idxs) == N_EVALS:
                    shapes = ((1, 4), (2, 2))
                    lane = "32 spread lanes"
                else:
                    shapes = ((1, 4),)
                    lane = ("distinct_property" if g.const.dp_vidx.shape[1]
                            else "reserved_cores")

                for shape in shapes:
                    def make(pkg, _t=trees, _s=shape, _a=g.spread_alg):
                        grid = pkg.mesh.make_mesh(cells,
                                                  eval_parallel=_s[0])
                        return lambda: pkg.mesh.mesh_solve(
                            grid, *_t, spread_alg=_a, dtype_name="float32")

                    cases.append(ab_case(
                        f"mesh dense {lane} {shape}", "dense_shard",
                        dict(lane=lane, grid=list(shape),
                             E=int(trees[0].cpu_cap.shape[0]),
                             N=int(trees[0].cpu_cap.shape[1]),
                             P=int(trees[2].ask_cpu.shape[1])),
                        make, lambda _w=want: _w,
                        lambda got, want, _n=lane: same_outputs(
                            np, got, want, f"ab mesh dense {_n}"),
                        repeats=3 if len(g.idxs) == N_EVALS else None))
        finally:
            batch.release_groups(groups)
    if "lp_shard" in names:
        L, N = LP_TIMED
        arrays = lp_fuzz_inputs(np, np.random.default_rng(SEED + 70), L, N,
                                over=True)
        temps = lpq.lp_temperatures(LP_STEPS)
        ins = [torch.from_numpy(a).to(DEVICE) for a in arrays]
        ins.append(torch.from_numpy(temps).to(DEVICE))
        want = lpq.lp_relax(*ins)

        def make(pkg):
            grid = pkg.mesh.make_mesh(cells, eval_parallel=MESH_CELLS)
            s_in, _ = pkg.mesh.shard_lpq_inputs(grid, *arrays)
            return lambda: pkg.mesh.mesh_lpq(grid, s_in, temps)

        def same(got, want):
            compare_lp(torch, "ab mesh lp", got, want)
            exchange.check(getattr(got[0], "exchange_error", None))

        cases.append(ab_case(
            "mesh lp (4, 1)", "lp_shard",
            dict(L=L, N=N, steps=LP_STEPS, grid=[MESH_CELLS, 1]),
            make, lambda: want, same))
    return cases


class CoveringStore:
    """A journal that covers every span with no change pairs."""

    def alloc_deltas_since(self, version, upto=None):
        return True, []


def ab_system_cases(np, torch, bp, dense, system, svc, world):
    """Row 4: system_fit on the system eval's lane (E 1, N 16,384) and
    on the 8 fuzz lanes (cores, ports, scarce), float32 and float64; and
    the system phase's solve_system_arrays (float32: pack, upload, fit,
    read back)."""
    dev = torch.device(DEVICE)
    matrix, usage, _ = world
    feas, ports_free = system_world(np, world, SEED)
    cases = []
    for dtype_name in ("float32", "float64"):
        lane = svc.pack_lane_arrays(
            matrix, usage, feas, ask=SYSTEM_ASK, count=1, n_places=1,
            eval_id="system-bench-eval-0000000000000000",
            state_index=STATE_INDEX, static_ports_free=ports_free,
            n_dyn_ports=1, dtype_name=dtype_name, device=DEVICE)
        rng = np.random.default_rng(SEED + 1)
        fuzz = [dense_fuzz_tables(np, rng, n=matrix.n_real,
                                  n_pad=matrix.n_pad, p=1,
                                  dtype=dtype_name, limit=2,
                                  features=("cores", "ports", "scarce"))
                for _ in range(8)]
        for tag, tables in (
                ("system_lane", dense_group(np, bp,
                                            [lane_dicts(np, lane, 1)])),
                ("fuzz8", dense_group(np, bp, fuzz))):
            c, st, b = dense.lane_tensors(*tables, dtype_name=dtype_name,
                                          device=dev)
            name = f"{tag}_{dtype_name}"
            cases.append(ab_case(
                name, "system_fit",
                dict(E=int(c.cpu_cap.shape[0]), N=int(c.cpu_cap.shape[1])),
                lambda pkg, c=c, st=st, b=b: (
                    lambda: pkg.system.system_fit(c, st, b,
                                                  spread_alg=False)),
                lambda c=c, st=st, b=b: system.system_fit_plain(
                    c, st, b, spread_alg=False),
                lambda g, w, name=name: ab_same(
                    torch, name, ("fit", "score"), g, w)))
    kw = dict(ask=SYSTEM_ASK, eval_id="system-bench-eval-0000000000000000",
              state_index=STATE_INDEX, static_ports_free=ports_free,
              n_dyn_ports=1, dtype_name="float32", device=DEVICE)

    def want():
        # the same call with the plain version on the card
        real = system.system_fit_tables

        def plain(tables, *, spread_alg):
            fit, score = system.system_fit_plain(
                *system._trees_of(tables), spread_alg=spread_alg)
            return torch.cat([score.reshape(-1).view(torch.uint8),
                              fit.reshape(-1).view(torch.uint8)])

        system.system_fit_tables = plain
        try:
            return svc.solve_system_arrays(matrix, usage, feas, **kw)
        finally:
            system.system_fit_tables = real

    def same(g, w):
        for what, x, y in (("chosen", g[1], w[1]), ("scores", g[2], w[2])):
            if x.dtype != y.dtype or x.tobytes() != y.tobytes():
                raise AssertionError(f"ab solve_system_arrays: {what} "
                                     "differs from the plain version's")

    cases.append(ab_case(
        "solve_system_arrays", "system_fit",
        dict(E=1, N=int(matrix.n_pad)),
        lambda pkg: (lambda: pkg.service.solve_system_arrays(
            matrix, usage, feas, **kw)), want, same))
    # the launch floor's shape
    E, N = LAUNCH_FLOOR["system_fit"]
    lane = dense_fuzz_tables(np, np.random.default_rng(SEED + 9), n=N,
                             n_pad=N, p=1, dtype="float32", limit=2,
                             features=("cores", "ports"))
    c, st, b = dense.lane_tensors(*dense_group(np, bp, [lane]),
                                  dtype_name="float32", device=dev)
    cases.append(ab_case(
        "floor_system_float32", "system_fit", dict(E=E, N=N),
        lambda pkg: (lambda: pkg.system.system_fit(c, st, b,
                                                   spread_alg=False)),
        lambda: system.system_fit_plain(c, st, b, spread_alg=False),
        lambda g, w: ab_same(torch, "floor_system_float32",
                             ("fit", "score"), g, w)))
    return cases


def ab_scatter_cases(np, torch, resident):
    """Row 8: the scatter at g3's shape (M 1,572,864, k 256) in bool,
    float32 and float64; at k = 25% of M (distinct, unpadded); from an
    unaligned view (the table starting at element 1 of its buffer); the
    promotion as the chain runs it (_scatter_single: the payload's
    upload, then the kernel); and the g3 promotion through chain_apply
    (the host diff, the upload and the kernel; two usage tables 150
    elements apart, promoted in turn)."""
    dev = torch.device(DEVICE)
    M, k = SCATTER_G3
    rng = np.random.default_rng(SEED + 60)
    cases = []

    def flat(name, buf, idx, vals):
        return ab_case(
            name, "delta_scatter", dict(M=int(buf.numel()),
                                        k=int(idx.numel())),
            lambda pkg: (lambda: pkg.resident.delta_scatter(buf, idx,
                                                            vals)),
            lambda: resident.delta_scatter_plain(buf, idx, vals),
            lambda g, w, name=name: ab_bits(torch, name, g, w))

    for dt in (np.bool_, np.float32, np.float64):
        cases.append(flat(f"g3_{np.dtype(dt).name}",
                          *scatter_case(np, torch, resident, rng, dt, M, k)))
    cases.append(flat("floor_scatter_float32", *scatter_case(
        np, torch, resident, rng, np.float32,
        *LAUNCH_FLOOR["delta_scatter"])))
    big = M // 4
    idx = torch.from_numpy(rng.choice(M, big, replace=False).astype(
        np.int32)).to(dev)
    vals = torch.from_numpy(rng.standard_normal(big).astype(
        np.float32)).to(dev)
    cases.append(flat("k_quarter_float32",
                      torch.from_numpy(rng.standard_normal(M).astype(
                          np.float32)).to(dev), idx, vals))
    buf, idx, vals = scatter_case(np, torch, resident, rng, np.float32,
                                  M + 1, k)
    view = buf[1:]                      # index M falls out and is dropped
    assert view.data_ptr() % 16 and view.is_contiguous()
    cases.append(flat("unaligned_float32", view, idx, vals))
    buf, idx, vals = scatter_case(np, torch, resident, rng, np.float32, M,
                                  k)
    idx_p, vals_p = idx.cpu().numpy(), vals.cpu().numpy()
    cases.append(ab_case(
        "promote_upload_float32", "delta_scatter", dict(M=M, k=k),
        lambda pkg: (lambda: pkg.resident._scatter_single(buf, idx_p,
                                                          vals_p)),
        lambda: resident.delta_scatter_plain(buf, idx, vals),
        lambda g, w: ab_bits(torch, "promote_upload_float32", g, w)))

    usage = rng.standard_normal((3, M // 3)).astype(np.float32)
    moved = usage.copy()
    pos = rng.choice(M // 3, G3_PLACED, replace=False)
    for f, a in enumerate(ASK):
        moved[f, pos] += np.float32(a)
    tables = (usage, moved)
    store = CoveringStore()

    def chain(pkg):
        r = pkg.resident
        r._reset_for_tests()
        key = ("ab-g3", "float32", usage.shape, 0)
        state = {"token": 1}

        def put(a):
            return r._put(a, dev)

        r.chain_apply(key, tables[0], store, 1, put)

        def run():
            state["token"] += 1
            arr = tables[(state["token"] - 1) % 2]
            buf, shipped, outcome = r.chain_apply(key, arr, store,
                                                  state["token"], put)
            assert outcome == "promote" and shipped == k * 8, (
                outcome, shipped)
            return buf, arr

        return run

    def chain_same(g, w):
        got = g[0].cpu().numpy()
        if got.tobytes() != g[1].tobytes():
            raise AssertionError("ab chain_g3_float32: the promoted buffer "
                                 "differs from its table")

    cases.append(ab_case("chain_g3_float32", "delta_scatter",
                         dict(M=M, k=k), chain, lambda: None, chain_same))
    return cases


def ab_coord_cases(np, torch, mesh, resident):
    """Row 9b at the mesh residency g3's shape (a (32, 16,384) float32
    usage table on (4, 1), 4 cells of the card, a bucket of 64 updates):
    the card's cells with the payload already there (the per-card entry
    point where the variant has one, else the per-cell scatter), and the
    whole mesh_delta_scatter from the host payload, uploads included."""
    (E, n), k = MESH_G3
    cells = [DEVICE] * MESH_CELLS
    grid = mesh.make_mesh(cells, eval_parallel=MESH_CELLS)
    rng = np.random.default_rng(SEED + 81)
    base = rng.standard_normal((E, n)).astype(np.float32)
    sh = mesh.put_by_spec(base, mesh.EN, grid)
    idx = rng.choice(base.size, k - k // 4, replace=False)
    idx_p, vals_p, bucket = resident._pad_updates(
        idx, base.reshape(-1)[idx] + np.float32(1))
    assert bucket == k
    coords = np.ascontiguousarray(np.stack(np.unravel_index(
        idx_p.astype(np.int64), base.shape)).astype(np.int32))
    full = base.copy()
    full.reshape(-1)[idx_p] = vals_p
    want = torch.from_numpy(full)
    cut = mesh.cuts(base.shape, mesh.EN, grid)
    parts = [sh.parts[q] for q, _d, _ix in cut]
    starts = [[x.start for x in ix] for _q, _d, ix in cut]
    pay = resident.put_coord_payload(coords, vals_p, torch.device(DEVICE))

    def cells_call(pkg):
        r = pkg.resident
        if hasattr(r, "coord_scatter_cells"):
            return lambda: r.coord_scatter_cells(parts, pay, starts)
        return lambda: [r.coord_scatter(x, pay[0], pay[1], st)
                        for x, st in zip(parts, starts)]

    def same(got, w):
        got = got.parts if hasattr(got, "parts") else got
        if not bits_equal(torch, torch.cat([x.cpu() for x in got]), w):
            raise AssertionError("ab coord_scatter: bytes differ from the "
                                 "plain version's")

    shape = dict(E=E, N=n, k=k, grid=[MESH_CELLS, 1])
    return [ab_case("coord_g3_cells", "coord_scatter", shape, cells_call,
                    lambda: want, same),
            ab_case("coord_g3_whole", "coord_scatter", shape,
                    lambda pkg: (lambda: pkg.mesh.mesh_delta_scatter(
                        sh, coords, vals_p)), lambda: want, same)]


def ab_bits(torch, name, got, want):
    if not bits_equal(torch, got, want):
        raise AssertionError(f"ab {name}: bytes differ from the plain "
                             "version's")


def ab_packaged_phase(torch, cases, built, pkgs):
    """Each packaged case in turns (first to last, then last to first):
    the variant's package with its kernel bound to the variant's build;
    every output equal to the plain version's; call ms (median of
    AB_REPEATS between CUDA events) and device ms (device_ms; None where
    the call makes the host wait on the device). A clock variant's step
    sections (µs a step, at the rate torch.cuda._sleep spins) over one
    call, where its kernel stamps them (AB_SECTIONS)."""
    variants = [t for t, (_, clk) in built.items() if not clk]
    clk_tags = [t for t, (_, clk) in built.items() if clk]
    out = {}
    for case in cases:
        name, kname = case["name"], case["kernel"]
        log(f"ab {name} ({kname}): the plain version, then the turns")
        want = case["want"]()
        row = dict(kernel=kname, **case["shape"], ms={}, device_ms={},
                   turns=[])
        for tag in variants + variants[::-1]:
            pkg = pkgs[tag]
            attr = kname.upper()
            proto = getattr(pkg.kernels, attr)
            setattr(pkg.kernels, attr, built[tag][0][0][kname])
            try:
                run = case["make"](pkg)
                case["same"](run(), want)
                ms = timed(torch, run, case["repeats"])
                dms = device_ms(torch, run, case["repeats"])
            finally:
                setattr(pkg.kernels, attr, proto)
            row["turns"].append((tag, ms, dms))
        for tag in variants:
            row["ms"][tag] = statistics.median(
                ms for t, ms, _ in row["turns"] if t == tag)
            d = [x for t, _, x in row["turns"] if t == tag and x is not None]
            row["device_ms"][tag] = statistics.median(d) if d else None
        log(f"ab {name} ({kname}) {case['shape']}: call "
            + " ".join(f"{t}={m:.4f}" for t, m in row["ms"].items())
            + " ms; device " + " ".join(
                f"{t}={m}" for t, m in row["device_ms"].items()) + " ms")
        sections = AB_SECTIONS.get(kname)
        for tag in clk_tags if sections else ():
            lib = built[tag][0][1][kname]
            if not hasattr(lib, "nt_step_clocks"):
                continue
            pkg = pkgs[tag]
            attr = kname.upper()
            proto = getattr(pkg.kernels, attr)
            setattr(pkg.kernels, attr, built[tag][0][0][kname])
            try:
                run = case["make"](pkg)
                run()
                c = ab_clocks(torch, lib, run, sections)
            finally:
                setattr(pkg.kernels, attr, proto)
            per_us = spin_cycles_per_ms(torch) / 1e3
            steps = max(c["steps"], 1)
            row.setdefault("clocks", {})[tag] = dict(
                steps=c["steps"], **{k: c[k] / steps / per_us
                                     for k in sections
                                     if k not in ("-", "total", "steps")})
            log(f"  clocks {tag} (us a step, first unit's block 0): "
                + " ".join(f"{k}={v:.2f}" for k, v in
                           row["clocks"][tag].items()))
        out[name] = row
    return out


def ab_main(args, torch, np):
    from nomad_tpu_torch import kernels
    from nomad_tpu_torch.solver import batch, dense, lpq, preempt, wave
    from nomad_tpu_torch.solver import service as svc
    from nomad_tpu_torch.solver import binpack as bp
    from nomad_tpu_torch.tensor import pack as tp

    names = (args.ab_kernels.split(",") if args.ab_kernels
             else list(AB_SOURCES))
    bad = set(names) - set(AB_SOURCES)
    if bad:
        raise SystemExit(f"--ab-kernels: unknown {sorted(bad)}; "
                         f"choose from {sorted(AB_SOURCES)}")

    def spec(s, defines):
        tag, d = s.split("=", 1)
        csrc = ROOT / "nomad_tpu_torch" / "csrc" if d == "repo" else (
            ROOT / d)
        return tag, csrc.resolve(), defines

    card = card_line()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    built = {}
    for tag, csrc, defines in ([spec(s, ()) for s in args.ab]
                               + [spec(s, ("-DNT_STEP_CLOCKS",))
                                  for s in args.ab_clocks]):
        built[tag] = (ab_build(kernels, tag, csrc, defines, names),
                      bool(defines))
    world = headline_world(np, tp)
    log("ab: building the cases")
    packaged = []
    if set(PACKAGED) & set(names):
        from nomad_tpu_torch.solver import resident, system
        pkgs = {tag: ab_package(tag, csrc)
                for tag, csrc, _ in (spec(x, ())
                                     for x in args.ab + args.ab_clocks)}
        if "system_fit" in names:
            packaged += ab_system_cases(np, torch, bp, dense, system, svc,
                                        world)
        if "delta_scatter" in names:
            packaged += ab_scatter_cases(np, torch, resident)
        if "coord_scatter" in names:
            from nomad_tpu_torch.parallel import mesh
            packaged += ab_coord_cases(np, torch, mesh, resident)
        packaged += ab_mesh_cases(np, torch, batch, dense, lpq, svc, tp,
                                  world, names)
    cases = []
    if {"dense_scan", "dense_preempt"} & set(names):
        cases += [c for c in ab_dense_cases(np, torch, bp, batch, dense,
                                            preempt, svc, tp, world)
                  if c["kernel"] in names]
    if "wave_preempt" in names:
        cases += ab_wave_preempt_cases(np, torch, bp, batch, preempt, svc,
                                       tp, world)
    if "lp_relax" in names:
        cases += ab_lp_cases(np, torch, lpq, svc, world)
    if set(WAVE_KERNELS) & set(names):
        cases += ab_wave_cases(np, torch, bp, batch, dense, wave, svc, tp,
                               world, names)
    if args.ab_max_spreads is not None:
        cases = [c for c in cases
                 if c["shape"].get("S", 0) <= args.ab_max_spreads]
    res = ab_phase(np, torch, kernels, cases, built)
    if packaged:
        res.update(ab_packaged_phase(torch, packaged, built, pkgs))
    log("ab: " + json.dumps(dict(card=card, cases=res)))
    print(card, flush=True)
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=SEED,
                    help="seed of the numpy fuzz lanes (default %(default)s)")
    ap.add_argument("--ab", action="append", default=[],
                    metavar="TAG=DIR",
                    help="A/B mode: time the redesigned kernels built from "
                    "DIR (under the repository; 'repo' for the port's csrc) "
                    "on the main paths' groups, in turns; repeatable")
    ap.add_argument("--ab-clocks", action="append", default=[],
                    metavar="TAG=DIR",
                    help="A/B mode: a DIR built with -DNT_STEP_CLOCKS whose "
                    "step sections are read after one launch")
    ap.add_argument("--ab-kernels", default="",
                    metavar="NAME,...",
                    help="A/B mode: the kernels to time (default all of "
                    + ", ".join(AB_SOURCES) + ")")
    ap.add_argument("--read-allocs", nargs="+", default=None,
                    metavar="ADDR JOB",
                    help="print the live allocs of each JOB of the agent "
                    "at ADDR as JSON (phase 19's reader process)")
    ap.add_argument("--ab-max-spreads", type=int, default=None,
                    metavar="S",
                    help="A/B mode: only the cases with at most S spreads "
                    "(a tree whose kernel takes fewer)")
    args = ap.parse_args(argv)
    if args.read_allocs:
        # a client of an agent another process serves: no card needed
        sys.path.insert(0, str(ROOT))
        print(json.dumps(read_allocs(args.read_allocs[0],
                                     args.read_allocs[1:])))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "nomad_tpu_torch" / "kernels.py").is_file():
        print("chip_smoke: run from a checkout of the repository "
              "(nomad_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    if args.ab or args.ab_clocks:
        return ab_main(args, torch, np)

    from nomad_tpu_torch import kernels
    from nomad_tpu_torch.solver import batch, dense, service as svc, system
    from nomad_tpu_torch.solver import guard
    from nomad_tpu_torch.solver import binpack as bp, lpq, preempt, wave
    from nomad_tpu_torch.parallel import mesh
    from nomad_tpu_torch.solver import resident
    from nomad_tpu_torch.state.store import StateStore
    from nomad_tpu_torch.tensor import pack as tp

    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | python {sys.version.split()[0]}")
    # matrix products stay full float32 (the port makes none; stated)
    torch.backends.cuda.matmul.allow_tf32 = False

    info = kernels.build()
    log(f"build: {info['seconds']:.1f} s, built {info['built']} "
        f"into {info['dir']}")
    for line in info["log"].splitlines():
        if ("registers" in line or line.startswith("==")
                or "Compiling entry function" in line):
            log("  " + line.strip())

    world = headline_world(np, tp)
    phase_s = {}

    def phase(name, fn, *a):
        t1 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t1
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return out

    kres = phase("wave kernels", kernel_phase, np, torch, bp, wave, kernels,
                 svc, tp, world)
    kres += phase("dense kernel", dense_kernel_phase, np, torch, bp, dense,
                  kernels, svc, tp, world, args.seed)
    kres += phase("system kernel", system_kernel_phase, np, torch, bp,
                  dense, system, svc, world, args.seed)
    kres += phase("preemption kernels", preempt_kernel_phase, np, torch, bp,
                  preempt, dense, kernels, svc, tp, world, args.seed)
    kres += phase("lp kernel", lp_kernel_phase, np, torch, lpq, args.seed)
    kres += phase("scatter kernel", scatter_kernel_phase, np, torch,
                  resident, args.seed)
    floor = phase("launch floor", launch_floor_phase, np, torch, bp, dense,
                  system, resident, args.seed)
    sres = phase("wave slice", slice_phase, np, torch, wave, kernels, svc,
                 batch, tp, world)
    dres = phase("dense slice", dense_slice_phase, np, torch, dense,
                 kernels, svc, batch, tp, world)
    yres = phase("system", system_phase, np, torch, system, kernels, svc,
                 world, args.seed)
    pres = phase("preemption slice", preempt_slice_phase, np, torch,
                 preempt, dense, kernels, svc, batch, tp, world)
    qres = phase("lp tier", lpq_slice_phase, np, torch, lpq, kernels, svc,
                 tp, world)
    rres = phase("residency", residency_phase, np, torch, batch, dense,
                 kernels, resident, StateStore, svc, tp, world)
    m, k, sdt = rres["main_shape"]
    rres["kernel"] = phase("scatter timing", scatter_timing, np, torch,
                           resident, args.seed, m, k,
                           sdt.replace("torch.", ""))
    wres, wpath = phase("wavefront", wavefront_phase, np, torch, wave,
                        dense, batch, kernels, svc, tp, world)
    kres += wres
    mdres = phase("mesh dense", mesh_dense_phase, np, torch, batch, dense,
                  mesh, kernels, svc, tp, world, args.seed)
    mwres = phase("mesh wave", mesh_wave_phase, np, batch, mesh, kernels,
                  svc, tp, world)
    mlres = phase("mesh lp", mesh_lp_phase, np, torch, lpq, mesh, kernels,
                  svc, world, args.seed)
    mlres["drill_ms"] = phase("mesh drill", mesh_drill, np, torch, dense,
                              lpq, mesh, args.seed)
    mrres = phase("mesh residency", mesh_residency_phase, np, torch, batch,
                  mesh, kernels, resident, StateStore, svc, tp, world,
                  args.seed)
    kres += mdres["kernels"] + [mlres["kernel"], mrres["kernel"]]
    dlres = phase("dispatch layer", dispatch_phase, np, torch, batch, guard,
                  lpq, kernels, resident, svc, tp, world, card)
    stres = phase("structs", structs_phase, np, torch, batch, guard,
                  kernels, svc, tp, world, card)
    scres = phase("scheduler", scheduler_phase, np, torch, batch, guard,
                  lpq, kernels, svc, tp, world, card)
    svres = phase("server", server_phase, np, torch, batch, guard, lpq,
                  kernels, svc, tp, world, card)
    tlres = phase("telemetry", telemetry_phase, np, torch, batch, guard,
                  lpq, kernels, resident, svc, tp, world, card, t_start)
    snres = phase("sanitizers", sanitizer_phase, np, torch, batch, guard,
                  lpq, kernels, svc, tp, world, card)
    ldres = phase("leader", leader_phase, np, torch, batch, guard,
                  kernels, svc, tp, card)
    agres = phase("agent", agent_phase, np, torch, batch, guard, lpq,
                  kernels, svc, tp, card)

    def pick(kname, **kw):
        return next(r for r in kres if r["name"] == kname
                    and r["dtype"] == "float32"
                    and all(r.get(k) == v for k, v in kw.items()))

    # each kernel's row: its float32 time at the main path's shape (the
    # dense kernel on the main path's own spread group), and its launches
    # in the main-path run of its own path
    rows = ((kernels.WAVE_BLOCK, pick("wave_block", B=32), sres),
            (kernels.WAVE_COMPACT, next(r for r in sres["main_launches"]
                                        if r["lane"] == "spread"), sres),
            (kernels.DENSE_SCAN, dres["kernel"], dres),
            (kernels.SYSTEM_FIT, pick("system_fit", world="system"), yres),
            (kernels.WAVE_PREEMPT, pres["kernels"]["wave_preempt"], pres),
            (kernels.DENSE_PREEMPT, pres["kernels"]["dense_preempt"], pres),
            (kernels.LP_RELAX, qres["kernel"], qres),
            (kernels.DELTA_SCATTER, rres["kernel"], rres),
            (kernels.WAVEFRONT, pick("wavefront"), wpath),
            (kernels.DENSE_SHARD, pick("dense_shard",
                                       lane="distinct_property"), mdres),
            (kernels.COORD_SCATTER, mrres["kernel"], mrres),
            (kernels.LP_SHARD, mlres["kernel"], mlres))
    line = {"kernels": []}
    for k, r, path in rows:
        line["kernels"].append(dict(
            name=k.name, route="cuda",
            source=f"nomad_tpu_torch/csrc/{k.source}",
            replaces=k.replaces.split()[0],
            launches=path["launches"][k.name],
            barrier_launches=dlres["barrier_launches"].get(k.name, 0),
            structs_launches=stres["launches"].get(k.name, 0),
            scheduler_launches=scres["launches"].get(k.name, 0),
            server_launches=svres["launches"].get(k.name, 0),
            telemetry_launches=tlres["launches"].get(k.name, 0),
            leader_launches=ldres["launches"].get(k.name, 0),
            job_ops_launches=ldres["job_ops_launches"].get(k.name, 0),
            agent_launches=agres["launches"].get(k.name, 0),
            max_abs_err=max(x["max_abs_err"] for x in kres
                            if x["name"] == k.name),
            ms=r["ms"], device_ms=r.get("device_ms"),
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r.get("library_ms"),
            shape=" ".join(str(x) for x in r["shape"]) + " float32",
            **({"launch_floor_device_ms": floor[k.name]["device_ms"]}
               if k.name in floor else {}),
            **({"cluster": r["cluster"]} if r.get("cluster") else {})))
    report = dict(card=card, device=name, seed=args.seed, kernels=kres,
                  launch_floor=floor,
                  slice=sres, dense_slice=dres, system=yres,
                  preempt_slice=pres, lpq_slice=qres, residency=rres,
                  wavefront=wpath, mesh_dense=mdres, mesh_wave=mwres,
                  mesh_lp=mlres, mesh_residency=mrres, dispatch=dlres,
                  structs=stres, scheduler=scres, server=svres,
                  telemetry=tlres, sanitizers=snres, leader=ldres,
                  agent=agres,
                  build_s=info["seconds"], phase_s=phase_s,
                  total_s=time.perf_counter() - t_start)
    log(f"total {report['total_s']:.1f} s")
    print("report: " + json.dumps(report), flush=True)
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
