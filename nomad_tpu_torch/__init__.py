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
and circuit breaker), slice 12 the structs: an eval's Node, Job and
Allocation structs go in (or a lane's packed arrays), and placements come
out: the node per placement, its task resources, reserved cores, device
instances and ports, and the allocs it preempts.

    structs/            resources, ports (NetworkIndex), Node, Job,
                        Allocation, Evaluation, Plan, the scheduler
                        configuration, allocs_fit
    mock.py             canned structs
    state/store.py      StateStore and StateSnapshot: nodes, jobs,
                        allocs, the scheduler configuration, the index
                        bookkeeping and the alloc-delta journal
    scheduler/          EvalContext (context.py), the feasibility
                        checkers (feasible.py), the DeviceAllocator and
                        select_reserved_cores (rank.py), the Preemptor
                        (preemption.py), AllocPlaceResult (reconcile.py),
                        the node shuffle and resolve_target (util.py)
    tensor/pack.py      NodeMatrix / UsageState / SpreadInfo / distinct
                        property / device / preemption tables, built from
                        structs (pack_nodes, pack_usage, pack_feasibility,
                        ...) with the matrix-keyed memos,
                        journal_touched_nodes
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
    solver/service.py   TpuPlacementService (pack, materialize, solve,
                        solve_system), TpuPlacement, PackedLane,
                        pack_lane_arrays, placements, evictions,
                        dispatch_lane, solve_system_arrays
    solver/batch.py     fuse_lanes / fuse_and_solve across evals, the
                        stack arena, the cross-lane fixpoint,
                        SolveBarrier and the dispatch pipeline,
                        make_solve_hook
    solver/guard.py     the dispatch guard: init probe, watchdog
                        deadline (run_dispatch), circuit breaker
    faultinject.py      named fault points (error / delay / hang)
    parallel/mesh.py    grids of cells, the spec table, the sharded
                        transports, mesh_solve / mesh_lpq /
                        mesh_delta_scatter
    solver/lpq.py       the LP relaxation's plain version and wrapper,
                        rounding and repair, solve_queue, LpqBarrier
    kernels.py          nvcc build, ctypes binding, launch counts
    carry.py            lane_from_reference, struct_from_reference,
                        store_from_reference: reference lanes, structs
                        and snapshots -> the port's
    lockcheck.py        the runtime sanitizers, each off by default:
    jitcheck.py         lock order, dispatch discipline (host syncs in a
    statecheck.py       dispatch, rebuilds, cache mutation), snapshot
    schedcheck.py       isolation, and the deterministic schedule explorer
    csrc/               the hand-written CUDA kernels (sm_90a)

Every entry point takes ``device``; left out, it is ``cuda``, and with no
card that raises rather than running on the CPU.
"""

# The sanitizers install here when their env knob is 1, before any other
# module of the package builds its locks (lockcheck instruments locks
# built after it is on); unset or 0 is one env read each.
from . import lockcheck as _lockcheck  # noqa: E402

_lockcheck.maybe_install_from_env()
from . import jitcheck as _jitcheck  # noqa: E402

_jitcheck.maybe_install_from_env()
from . import statecheck as _statecheck  # noqa: E402

_statecheck.maybe_install_from_env()
from . import schedcheck as _schedcheck  # noqa: E402

_schedcheck.maybe_install_from_env()
