"""nomad_tpu_torch: the PyTorch and CUDA port of nomad-tpu's placement solver.

The JAX package ``nomad_tpu`` is the reference; this package reproduces its
device path on an NVIDIA H100 and imports nothing from it (nor ``jax``).
Slice 1 covers the wavefront placement path, slice 2 the dense greedy path
(the lanes the wave gate refuses) and system jobs, slice 3 placement with
preemption (windowed and dense eviction search), slice 4 the whole-queue
LP tier and the cross-lane fixpoint, slice 5 device residency (every
dispatch's tables ship through a content-keyed resident buffer set on
the card, advanced by journal-covered deltas) and the in-kernel
wavefront, slice 6 the mesh route (a dispatch sharded over an (evals,
nodes) grid of cells) and the stack arena, slice 11 the dispatch layer
(the solve barrier and its pipeline under the dispatch guard's deadline
and circuit breaker): a lane's packed arrays go in, the chosen node per
placement (and, with preemption, the allocs it evicts) comes out.

    scheduler/util.py   deterministic node shuffle (splitmix64 Fisher-Yates)
    tensor/pack.py      NodeMatrix / UsageState / SpreadInfo / distinct
                        property / device / preemption array tables,
                        journal_touched_nodes
    state/store.py      StateStore's index bookkeeping and alloc-delta
                        journal (alloc_deltas_since)
    solver/binpack.py   lane NamedTuples, host precompute of the compact table
    solver/scoring.py   score and window helpers shared by all the paths
    solver/wave.py      the two wave kernels' plain versions and wrappers,
                        the in-kernel wavefront (solve_wavefront)
    solver/dense.py     the dense scan kernel's plain version and wrapper,
                        the fused transport (fused_tensors)
    solver/resident.py  the resident buffer set (device_put_cached), the
                        version chain and the delta scatter
    solver/system.py    the system fit kernel's plain version and wrapper
    solver/preempt.py   the two preemption kernels' plain versions and
                        wrappers, and their lane solves
    solver/service.py   PackedLane, pack_lane_arrays, placements,
                        evictions, dispatch_lane, solve_system_arrays
    solver/batch.py     fuse_lanes / fuse_and_solve across evals, the
                        stack arena, the cross-lane fixpoint,
                        SolveBarrier and the dispatch pipeline
    solver/guard.py     the dispatch guard: init probe, watchdog
                        deadline (run_dispatch), circuit breaker
    faultinject.py      named fault points (error / delay / hang)
    parallel/mesh.py    grids of cells, the spec table, the sharded
                        transports, mesh_solve / mesh_lpq /
                        mesh_delta_scatter
    solver/lpq.py       the LP relaxation's plain version and wrapper,
                        rounding and repair, solve_queue, LpqBarrier
    kernels.py          nvcc build, ctypes binding, launch counts
    carry.py            lane_from_reference: reference lane tables -> PackedLane
    csrc/               the hand-written CUDA kernels (sm_90a)

Every entry point takes ``device``; left out, it is ``cuda``, and with no
card that raises rather than running on the CPU.
"""
