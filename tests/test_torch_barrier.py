"""The port's SolveBarrier and dispatch pipeline (nomad_tpu_torch/solver/
batch.py) against the reference's (nomad_tpu/solver/batch.py) on the CPU.

Lanes are packed by the reference's TpuPlacementService.pack on
mock-node worlds (tests/test_dispatch_pipeline.py build_world; the
tier-5 preemption world of tests/test_torch_preempt_worlds.py; the
arena world of tests/test_torch_arena.py), carried over with
carry.lane_from_reference and solved with device="cpu". The gates are
the ROADMAP's: assert_array_equal on chosen, n_yielded and the eviction
rows; scores within rtol=1e-12 (float64).

  * the port's barrier at depth 1 and at depth 3 against the reference
    SolveBarrier, and the port's dispatch_lane against the reference's,
    on the same lanes (wave, dense and preemption lanes);
  * generations overlap at depth 2; the straggler-race regression;
    padding lanes are inert (tests/test_dispatch_pipeline.py);
  * a dispatch exception reaches every participant and counts once
    toward the breaker; a straggler timeout dispatches without the
    straggler (tests/test_batch_worker.py);
  * a multi-generation sequence through the port barrier with pipelined
    prepare leaves arena_state() and resident.stats() counters equal to
    the reference barrier's on the same sequence.
"""
import copy
import threading
import time

import numpy as np
import pytest
import torch

from nomad_tpu import mock
from nomad_tpu.solver import batch as ref_batch
from nomad_tpu.solver import constcache
from nomad_tpu.solver import guard as ref_guard
from nomad_tpu.solver.service import dispatch_lane as ref_dispatch_lane

from nomad_tpu_torch.carry import lane_from_reference
from nomad_tpu_torch.solver import batch, guard, resident, service

from test_dispatch_pipeline import build_world, pack_lane
from test_torch_arena import (
    STAT_KEYS, _carry as _carry_arena, _charge, _set_token,
    _world as arena_world)
from test_torch_preempt_worlds import _pack as pack_preempt
from test_torch_preempt_worlds import _world as preempt_world

from torch_sanitizers import armed

# the suite runs under the port's sanitizers (tests/torch_sanitizers.py)
_torch_sanitizers = armed("lockcheck", "jitcheck")

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_MESH", "0")
    monkeypatch.setenv("NOMAD_TPU_TORCH_MESH", "0")
    for g in (guard, ref_guard):
        g._reset_for_tests()
    for mod in (batch, ref_batch):
        mod.arena_clear("test")
        mod._ARENA._stats.update(reuses=0, allocs=0, evictions=0,
                                 pad_fills_skipped=0)
    resident._reset_for_tests()
    constcache._reset_for_tests()
    yield
    for g in (guard, ref_guard):
        g._reset_for_tests()
    batch.arena_clear("test")
    ref_batch.arena_clear("test")
    resident._reset_for_tests()
    constcache._reset_for_tests()


def _carry(lanes):
    out = []
    for ln in lanes:
        plan = ln.service.ctx.plan
        out.append(lane_from_reference(
            ln.const, ln.init, ln.batch, ln.order, dtype_name=ln.dtype_name,
            spread_alg=ln.spread_alg, node_ids=[n.id for n in ln.nodes],
            ptab=ln.ptab, pinit=ln.pinit, plan_priority=plan.priority,
            plan_has_stops=bool(plan.node_update or plan.node_preemptions),
            table_version=ln.table_version, delta_src=ln.delta_src,
            device="cpu"))
    return out


def _run(barrier, lanes, timeout=60.0):
    out = {}

    def worker(i):
        try:
            out[i] = barrier.solve(lanes[i])
        except Exception as e:  # noqa: BLE001 -- the test reads it
            out[i] = e

    ts = [threading.Thread(target=worker, args=(i,), daemon=True)
          for i in range(len(lanes))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "a waiter wedged"
    assert sorted(out) == list(range(len(lanes)))
    return [out[i] for i in range(len(lanes))]


def _assert_result(got, want):
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(np.asarray(got[1], dtype=np.float64),
                               np.asarray(want[1], dtype=np.float64),
                               rtol=1e-12)
    if len(want) > 3:
        np.testing.assert_array_equal(got[3], want[3])


def _spread_lane(h, nodes, i, count=140):
    """A spread lane whose window (max(count, 100) slots) outgrows every
    wave buffer: the dense scan."""
    from nomad_tpu.scheduler.context import EvalContext
    from nomad_tpu.scheduler.reconcile import AllocPlaceResult
    from nomad_tpu.solver.service import TpuPlacementService
    from nomad_tpu.structs import Plan, Spread

    job = mock.job(id=f"pipe-spread-{i}")
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = 100
    tg.tasks[0].resources.memory_mb = 64
    tg.spreads = [Spread(attribute="${node.datacenter}", weight=50)]
    h.state.upsert_job(job)
    plan = Plan(eval_id=f"pipe-spread-eval-{i:021d}", priority=50, job=job)
    ctx = EvalContext(h.state.snapshot(), plan)
    places = [AllocPlaceResult(name=f"{job.id}.{tg.name}[{k}]",
                               task_group=tg) for k in range(count)]
    svc = TpuPlacementService(ctx, job, batch_mode=False, spread_alg=False)
    lane = svc.pack(tg, places, nodes)
    assert lane is not None and not lane.wavefront_ok()
    return lane


def _mixed_lanes():
    """Reference lanes: three uniform wave lanes, a dense spread lane,
    two tier-5 preemption lanes (the windowed kernel) from a fleet
    filled to 95% of its cpu, and one from a fleet whose fillers migrate
    one at a time (max_parallel 1: the dense preemption kernel)."""
    h, nodes = build_world()
    lanes = [pack_lane(h, nodes, i) for i in range(3)]
    lanes.append(_spread_lane(h, nodes, 3))
    ph, pnodes = preempt_world(5, 12)
    lanes += [pack_preempt(ph, pnodes, 4, job_id=f"pre-job-{k}", seed=k)
              for k in range(2)]
    mh, mnodes = preempt_world(6, 12, max_parallel=1, per_job=2)
    lanes.append(pack_preempt(mh, mnodes, 4, job_id="pre-job-maxp", seed=2))
    assert [ln.ptab is not None for ln in lanes] == [False] * 4 + [True] * 3
    assert [ln.wavefront_ok() for ln in lanes[4:]] == [True, True, False]
    return lanes


@pytest.mark.parametrize("depth", [1, 3])
def test_port_barrier_matches_reference_barrier_and_dispatch_lane(depth):
    lanes = _mixed_lanes()
    ports = _carry(lanes)
    want = _run(ref_batch.SolveBarrier(participants=len(lanes), depth=depth),
                lanes)
    got = _run(batch.SolveBarrier(participants=len(ports), depth=depth,
                                  device="cpu"), ports)
    for g, w in zip(got, want):
        assert not isinstance(w, Exception), w
        assert not isinstance(g, Exception), g
        _assert_result(g, w)
    # one lane, one dispatch: the port's dispatch_lane as the reference's
    for lane, port in zip(lanes, ports):
        _assert_result(service.dispatch_lane(port, device="cpu"),
                       ref_dispatch_lane(lane))
    assert any(bool(np.asarray(w[3]).any()) for w in want[4:])
    assert guard.state()["dispatch"]["error"] == 0
    assert batch.arena_state()["in_use"] == 0


def test_pipelined_round_matches_synchronous_path():
    h, nodes = build_world()
    ports = _carry([pack_lane(h, nodes, 60 + i) for i in range(3)])
    solo = [service.dispatch_lane(p, device="cpu") for p in ports]
    hints = []
    sync = _run(batch.SolveBarrier(3, depth=1, device="cpu",
                                   plan_group_hint=hints.append), ports)
    piped = _run(batch.SolveBarrier(3, depth=3, device="cpu",
                                    plan_group_hint=hints.append), ports)
    for s, p, o in zip(sync, piped, solo):
        _assert_result(p, s)
        np.testing.assert_array_equal(s[0], o[0])
    assert batch.pipeline_state()["staged_total"] >= 1
    # each generation tells the plan applier how many plans to expect
    assert hints == [3, 3]


def test_pipeline_overlaps_generations(monkeypatch):
    """Depth 2 keeps two dispatches in flight: two one-participant
    barriers submitted together with a slow fuse overlap."""
    stamps = []
    orig = batch.fuse_and_solve

    def slow_fuse(lanes, **kw):
        stamps.append(("start", time.monotonic()))
        time.sleep(0.3)
        stamps.append(("end", time.monotonic()))
        return orig(lanes, **kw)

    h, nodes = build_world()
    ports = _carry([pack_lane(h, nodes, 10 + i, count=2) for i in range(2)])
    monkeypatch.setattr(batch, "fuse_and_solve", slow_fuse)
    barriers = [batch.SolveBarrier(1, depth=2, device="cpu")
                for _ in range(2)]
    out = {}

    def worker(i):
        out[i] = barriers[i].solve(ports[i])

    ts = [threading.Thread(target=worker, args=(i,), daemon=True)
          for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert not any(t.is_alive() for t in ts)
    assert sorted(out) == [0, 1]
    starts = sorted(t for k, t in stamps if k == "start")
    ends = sorted(t for k, t in stamps if k == "end")
    assert len(starts) == 2 and len(ends) == 2
    assert starts[1] < ends[0], stamps
    assert batch.pipeline_state()["in_flight"] == 0


def test_straggler_timeout_racing_generation_never_reads_unset_cell(
        monkeypatch):
    """With a dispatch in flight, a waiter's barrier timeout re-checks
    its cell under the condition variable and keeps waiting."""
    h, nodes = build_world()
    lane_a = _carry([pack_lane(h, nodes, 20, count=2)])[0]
    solo_a = service.dispatch_lane(lane_a, device="cpu")
    orig = batch.fuse_and_solve

    def slow_fuse(lanes, **kw):
        time.sleep(0.8)             # in flight across > 1 timeout window
        return orig(lanes, **kw)

    monkeypatch.setattr(batch, "BARRIER_TIMEOUT_S", 0.2)
    monkeypatch.setattr(batch, "fuse_and_solve", slow_fuse)
    monkeypatch.setenv("NOMAD_TPU_TORCH_BATCH_FIXPOINT", "0")
    # participants=2: A arrives, B never does -> A's timeout fires a
    # partial dispatch (generation 1, pipelined); A's next timeout lands
    # while it is still in flight
    barrier = batch.SolveBarrier(2, depth=2, device="cpu")
    res = _run(barrier, [lane_a])
    assert not isinstance(res[0], Exception), res[0]
    np.testing.assert_array_equal(res[0][0], solo_a[0])


def test_eval_axis_padding_lanes_are_inert():
    """Padding lanes (e_pad_hint 8 over 3 real lanes) place nothing and
    charge nothing to the fixpoint's ledger; so in a dense group."""
    h, nodes = build_world()
    lanes = _carry([pack_lane(h, nodes, 40 + i, count=3) for i in range(3)])
    assert lanes[0].wavefront_ok()
    solo = [service.dispatch_lane(ln, device="cpu") for ln in lanes]
    results = batch.fuse_and_solve(lanes, device="cpu", e_pad_hint=8)
    for res, ref in zip(results, solo):
        _assert_result(res, ref)
    ledger = {}
    batch._cross_lane_fixpoint(lanes, results, ledger, device="cpu")
    real = {ln.node_ids[np.asarray(ln.order)[pos]]
            for ln, res in zip(lanes, results)
            for pos in np.asarray(res[0]) if pos >= 0}
    assert real and set(ledger) <= real
    # dense: non-uniform asks fail the wave gate
    dense = _carry([pack_lane(h, nodes, 50 + i, count=3) for i in range(3)])
    for ln in dense:
        ln.batch = ln.batch._replace(
            ask_cpu=np.asarray(ln.batch.ask_cpu) * np.array([1.0, 1.5, 1.0]))
        ln._wave = None
        assert not ln.wavefront_ok()
    dense_solo = [service.dispatch_lane(ln, device="cpu") for ln in dense]
    for res, ref in zip(batch.fuse_and_solve(dense, device="cpu",
                                             e_pad_hint=8), dense_solo):
        _assert_result(res, ref)


def test_dispatch_exception_fans_out_and_counts_once(monkeypatch):
    """A dispatch failure re-raises in EVERY blocked participant as
    DispatchFailed("error") and counts once toward the breaker."""
    def boom(lanes, **kw):
        raise RuntimeError("device exploded")

    h, nodes = build_world()
    ports = _carry([pack_lane(h, nodes, 70 + i, count=2) for i in range(2)])
    monkeypatch.setattr(batch, "fuse_and_solve", boom)
    barrier = batch.SolveBarrier(participants=3, device="cpu")
    errors = []

    def worker(lane):
        try:
            barrier.solve(lane)
        except guard.DispatchFailed as e:
            errors.append((e.kind, str(e.__cause__)))

    ts = [threading.Thread(target=worker, args=(p,), daemon=True)
          for p in ports]
    for t in ts:
        t.start()
    barrier.done()      # the third participant finished without solving
    for t in ts:
        t.join(10)
    assert not any(t.is_alive() for t in ts)
    assert errors == [("error", "device exploded")] * 2
    assert guard.breaker_state()["consecutive_failures"] == 1
    assert batch.arena_state()["in_use"] == 0


def test_straggler_timeout_dispatches_without_it(monkeypatch):
    dispatched = []
    orig = batch.fuse_and_solve

    def recording(lanes, **kw):
        dispatched.append(len(lanes))
        return orig(lanes, **kw)

    h, nodes = build_world()
    ports = _carry([pack_lane(h, nodes, 80 + i, count=2) for i in range(2)])
    monkeypatch.setattr(batch, "fuse_and_solve", recording)
    monkeypatch.setattr(batch, "BARRIER_TIMEOUT_S", 0.3)
    # three participants; only two ever arrive
    barrier = batch.SolveBarrier(participants=3, device="cpu")
    t0 = time.monotonic()
    res = _run(barrier, ports, timeout=10)
    assert time.monotonic() - t0 < 5.0
    assert dispatched == [2]
    for r, p in zip(res, ports):
        _assert_result(r, service.dispatch_lane(p, device="cpu"))


@pytest.mark.parametrize("depth", [1, 2])
def test_generation_sequence_counters_match_reference_barrier(depth):
    """The four-generation residency sequence of test_torch_arena
    (install -> reuse/hit -> promote -> gap; a wave group of 5 lanes and
    a dense group of 3, both off their E bucket) through one barrier per
    generation in each package, at ``depth`` (2: the pipeline's prepare
    stage stacks each generation): equal results, and the arena's and
    the resident set's counters equal the reference's after every
    generation."""
    n_plain = 5
    h, nodes, filler, lanes = arena_world(n_plain, 3)
    lanes = [copy.copy(ln) for ln in lanes]
    for ln in lanes:
        ln.init = type(ln.init)(*(np.array(a) for a in ln.init))
    store = h.state
    seen = []

    if depth > 1:
        # each package's pipeline at this depth before the first reading
        # (a pipeline of another depth is replaced, its count with it)
        ref_batch._get_pipeline(depth)
        batch._get_pipeline(depth)

    def staged():
        return (ref_batch.pipeline_state()["staged_total"],
                batch.pipeline_state()["staged_total"])

    def generation():
        s0 = staged()
        want = _run(ref_batch.SolveBarrier(len(lanes), use_mesh=False,
                                           depth=depth), lanes)
        ports = _carry_arena(lanes)
        got = _run(batch.SolveBarrier(len(ports), depth=depth,
                                      device="cpu"), ports)
        s1 = staged()
        # one prepare stage a generation in each package at depth 2
        assert (s1[0] - s0[0], s1[1] - s0[1]) == (
            (1, 1) if depth > 1 else (0, 0))
        for g, w in zip(got, want):
            assert not isinstance(w, Exception), w
            assert not isinstance(g, Exception), g
            _assert_result(g, w)
        st_w, st_g = constcache.stats(), resident.stats()
        for k in STAT_KEYS:
            assert st_g[k] == st_w[k], (k, st_g[k], st_w[k], len(seen))
        aw, ag = ref_batch.arena_state(), batch.arena_state()
        for k in ("reuses", "allocs", "evictions", "pad_fills_skipped",
                  "entries", "in_use", "resident_bytes"):
            assert ag[k] == aw[k], (k, ag[k], aw[k], len(seen))
        seen.append(dict(st_g))

    generation()                                   # g1: cold
    store.upsert_allocs([mock.alloc_for(filler, nodes[1], index=900)])
    _set_token(lanes, store)
    generation()                                   # g2: reuse / hit
    assert seen[1]["delta_reuses"] > 0 and seen[1]["hits"] > 0
    store.upsert_allocs([mock.alloc_for(filler, nodes[k], index=910 + k)
                         for k in (3, 5)])
    _set_token(lanes, store)
    for k in (0, n_plain):                         # lane 0 of each group
        _charge(lanes, k, [3, 5], (100.0, 64.0, 150.0))
    generation()                                   # g3: promote
    assert seen[2]["delta_promotions"] > 0
    with store._lock:
        store._bump("allocs")
    _set_token(lanes, store)
    _charge(lanes, n_plain, [7], (100.0, 64.0, 150.0))
    generation()                                   # g4: gap
    assert seen[3]["delta_gap_fallbacks"] > 0
    assert batch.arena_state()["pad_fills_skipped"] >= 2


def test_concurrent_misses_count_resident_bytes_once(monkeypatch):
    """Two pipelined dispatches that miss the same content at once both
    upload it; the resident set keeps one entry and counts its bytes
    once."""
    real_put = resident._put

    def slow_put(arr, device):
        time.sleep(0.2)             # both lookups miss before either puts
        return real_put(arr, device)

    monkeypatch.setattr(resident, "_put", slow_put)
    table = np.full(8192, 3.0)
    table.setflags(write=False)
    start = threading.Barrier(2)

    def put():
        start.wait(10)
        resident.device_put_cached([table], device="cpu", version=1)

    ts = [threading.Thread(target=put, daemon=True) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert not any(t.is_alive() for t in ts)
    st = resident.stats()
    assert st["misses"] == 2 and st["entries"] == 1
    assert st["resident_bytes"] == table.nbytes
