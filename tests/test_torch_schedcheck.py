"""The port's deterministic schedule explorer (nomad_tpu_torch/schedcheck.py)
on the CPU: the reference's own tests (tests/test_schedcheck.py, less the
CLI, HTTP and debug-bundle surfaces), the gauntlet rebuilt over the port's
store and applier (the planted write skew and torn read found within 64
schedules, replay reproducing the witness, a manifested deadlock), the
same verdict as the reference's explorer on the mirrored scenarios, the
seam refusing a foreign patch, and the whole slice: a small server round
with all four checkers armed, clean, placing bit for bit as the
reference's unarmed run and the port's unarmed run."""
import queue
import sys
import threading
import time

import numpy as np
import pytest

from nomad_tpu import lockcheck as ref_lockcheck
from nomad_tpu import schedcheck as ref_schedcheck
from nomad_tpu import statecheck as ref_statecheck
from nomad_tpu_torch import jitcheck, lockcheck, schedcheck, statecheck

HERE = __file__


@pytest.fixture(autouse=True)
def _clean_checker():
    """Every test leaves the original entry points restored and every
    checker's state empty (both packages'), pass or fail."""
    yield
    for mod in (schedcheck, lockcheck, statecheck, jitcheck,
                ref_schedcheck, ref_lockcheck, ref_statecheck):
        mod.disable()
        mod._reset_for_tests()


def _globals():
    """The stdlib entry points schedcheck patches, as they stand."""
    return (threading.Thread.start, threading.Thread.join,
            threading.Event.wait, threading.Event.set, time.sleep,
            queue.Queue.get, queue.Queue.put)


def _pristine():
    """The entry points the reference's schedcheck restores exactly
    (it captures queue.Queue.get at its first enable, which may be
    lockcheck's patch: a reference fault, ROADMAP Queue 3)."""
    return (threading.Thread.start is schedcheck._REAL_THREAD_START
            and threading.Thread.join is schedcheck._REAL_THREAD_JOIN
            and threading.Event.wait is schedcheck._REAL_EVENT_WAIT
            and threading.Event.set is schedcheck._REAL_EVENT_SET
            and time.sleep is schedcheck._REAL_SLEEP)


# ----------------------------------------------------------------------
# kill switch + parity


def test_killswitch_is_inert(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TORCH_SCHEDCHECK", "0")
    before = _globals()
    schedcheck.maybe_install_from_env()
    assert not schedcheck.enabled()
    assert _globals() == before and _pristine()
    st = schedcheck.state()
    assert st["enabled"] is False and st["runs"] == 0
    assert schedcheck.witness() is None
    schedcheck.yield_point("off")
    assert schedcheck.state()["decisions"] == 0


def test_env_knob_installs(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TORCH_SCHEDCHECK", "1")
    monkeypatch.setenv("NOMAD_TPU_TORCH_SCHEDCHECK_SEED", "7")
    before = _globals()
    schedcheck.maybe_install_from_env()
    assert schedcheck.enabled()
    st = schedcheck.state()
    assert st["run_active"] and st["seed"] == 7
    assert threading.Thread.start is not schedcheck._REAL_THREAD_START
    schedcheck.disable()
    assert _globals() == before


def test_enabled_cycle_is_bitwise_identical():
    """A dispatch and plan commit under a controlled run returns bit for
    bit what the raw path returns (the dispatch watchdog keeps real
    time)."""
    from test_torch_statecheck import _dispatch_and_commit

    off_solved, off_idx = _dispatch_and_commit(0)
    schedcheck.enable()
    schedcheck.begin_run(seed=3)
    try:
        on_solved, on_idx = _dispatch_and_commit(0)
        st = schedcheck.state()
    finally:
        schedcheck.end_run()
        schedcheck.disable()
    assert off_idx == on_idx
    for a, b in zip(off_solved, on_solved):
        np.testing.assert_array_equal(a, b)
    assert st["run_active"] and st["deadlock_count"] == 0


# ----------------------------------------------------------------------
# controller determinism


def test_same_seed_same_fingerprint():
    r1 = schedcheck.run_schedule(schedcheck.scenario_broker_smoke, 5)
    r2 = schedcheck.run_schedule(schedcheck.scenario_broker_smoke, 5)
    assert r1.decisions > 0
    assert r1.fingerprint == r2.fingerprint
    assert r1.violations == [] and r2.violations == []


@pytest.mark.parametrize("policy", ["random", "pct", "rr"])
def test_all_policies_run_clean_smoke(policy):
    res = schedcheck.run_schedule(schedcheck.scenario_broker_smoke, 1,
                                  policy=policy)
    assert res.violations == [], (policy, res.violations)
    assert res.decisions > 0


def test_server_scenario_same_seed_same_fingerprint():
    """chip_smoke's schedule drill at a small size on the CPU: a real
    server with one batch worker, twice under seed 11 -- equal
    fingerprints, and placements equal to the unsanitized run."""
    import chip_smoke as cs
    from nomad_tpu_torch import mock as pmock
    from nomad_tpu_torch import structs as st
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.state.store import StateStore

    old = (cs.DEVICE, cs.SAN_SCHED_NODES, cs.SAN_SCHED_PLACE)
    cs.DEVICE, cs.SAN_SCHED_NODES, cs.SAN_SCHED_PLACE = "cpu", 80, 12
    try:
        out = cs.schedule_drill(pmock, st, Server, StateStore, schedcheck,
                                lockcheck, statecheck)
    finally:
        cs.DEVICE, cs.SAN_SCHED_NODES, cs.SAN_SCHED_PLACE = old
    assert out["fingerprints"][0] == out["fingerprints"][1]
    assert out["preemptions"] == [0, 0]


# ----------------------------------------------------------------------
# the gauntlet


def test_gauntlet_write_skew_found_within_64_schedules():
    res = schedcheck.explore(schedcheck.scenario_planted_write_skew,
                             seeds=64)
    seeds = res.seeds_with_violations
    assert seeds, "planted write-skew not found in 64 schedules"
    v = [v for v in res.violations if v["kind"] == "write_skew"]
    assert v, res.violations
    assert v[0]["schedule"]["schedule_seed"] in seeds
    assert v[0]["schedule"]["step"] > 0


def test_gauntlet_torn_read_found_within_64_schedules():
    res = schedcheck.explore(schedcheck.scenario_planted_torn_read,
                             seeds=64)
    seeds = res.seeds_with_violations
    assert seeds, "planted torn read not found in 64 schedules"
    v = [v for v in res.violations if v["kind"] == "torn_read"]
    assert v, res.violations
    assert v[0]["schedule"]["schedule_seed"] in seeds


def test_gauntlet_uncontrolled_runs_find_nothing():
    """200 uncontrolled runs of each planted scenario: the racy windows
    are microseconds wide and the OS never splits them."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(10.0)
    statecheck.enable()
    try:
        for _ in range(200):
            schedcheck.scenario_planted_write_skew()
            schedcheck.scenario_planted_torn_read()
        st = statecheck.state()
    finally:
        sys.setswitchinterval(old)
        statecheck.disable()
    assert st["write_skew_count"] == 0, st["write_skews"]
    assert st["torn_read_count"] == 0, st["torn_reads"]


def test_gauntlet_replay_reproduces_identical_witness_twice():
    for scenario, kind, fields in (
            (schedcheck.scenario_planted_write_skew, "write_skew",
             ("node", "plans")),
            (schedcheck.scenario_planted_torn_read, "torn_read",
             ("op", "versions"))):
        res = schedcheck.explore(scenario, seeds=64)
        assert res.seeds_with_violations, kind
        seed = res.seeds_with_violations[0]
        first = schedcheck.replay(scenario, seed)
        second = schedcheck.replay(scenario, seed,
                                   expect_fingerprint=first.fingerprint)

        def witness(run):
            return [(v["kind"],) + tuple(str(v.get(f)) for f in fields)
                    for v in run.violations if v["kind"] == kind]

        assert witness(first), (kind, first.violations)
        assert witness(first) == witness(second)
        assert first.fingerprint == second.fingerprint
        assert schedcheck.state()["divergence_count"] == 0


def test_replay_divergence_detected():
    base = schedcheck.run_schedule(schedcheck.scenario_planted_write_skew, 2)
    schedcheck.replay(schedcheck.scenario_planted_torn_read, 2,
                      expect_fingerprint=base.fingerprint)
    st = schedcheck.state()
    assert st["divergence_count"] == 1
    rep = [r for r in st["reports"] if r["kind"] == "divergence"]
    assert rep and rep[0]["expected"] == base.fingerprint


def _scenario_event_deadlock():
    """Two threads each waiting (untimed) for the other to signal."""
    e1, e2 = threading.Event(), threading.Event()

    def a():
        e1.wait()
        e2.set()

    def b():
        e2.wait()
        e1.set()

    threads = [threading.Thread(target=a, daemon=True, name="dl-a"),
               threading.Thread(target=b, daemon=True, name="dl-b")]
    for t in threads:
        t.start()
    for t in threads:
        while t.is_alive():
            t.join(timeout=5.0)


def test_deadlock_manifested_and_replayable():
    res = schedcheck.run_schedule(_scenario_event_deadlock, 1)
    assert [v for v in res.violations if v["kind"] == "deadlock"], \
        res.violations
    st = schedcheck.state()
    assert st["deadlock_count"] >= 1
    rep = [r for r in st["reports"] if r["kind"] == "deadlock"]
    assert rep and rep[0]["schedule_seed"] == 1
    assert {"dl-a", "dl-b"} & {w["thread"] for w in rep[0]["waiting"]}
    assert rep[0]["trace_tail"]


# ----------------------------------------------------------------------
# co-enablement: one wrapped lock layer in either order


def _assert_single_layer():
    lk = threading.Lock()
    assert type(lk).__name__ == "_LockWrapper", type(lk)
    assert not hasattr(lk._lc_inner, "_lc_inner"), lk._lc_inner
    cv = threading.Condition()
    assert type(cv).__name__ == "_InstrumentedCondition", type(cv)
    assert not hasattr(cv._lock._lc_inner, "_lc_inner")


def test_coenable_lockcheck_then_schedcheck_single_layer():
    lockcheck.enable(roots=[HERE])
    schedcheck.enable()
    schedcheck.begin_run(seed=0)
    _assert_single_layer()


def test_coenable_schedcheck_then_lockcheck_single_layer():
    schedcheck.enable()
    schedcheck.begin_run(seed=0)
    lockcheck.enable(roots=[HERE])
    _assert_single_layer()


def test_shared_queue_get_patch_outlives_either_owner():
    """queue.Queue.get is one patch for lockcheck and schedcheck: it stays
    while either is on and the original comes back after both."""
    before = _globals()
    lockcheck.enable()
    schedcheck.enable()
    schedcheck.disable()
    assert queue.Queue.get is schedcheck._patched_queue_get
    lockcheck.disable()
    assert _globals() == before
    assert threading.Lock is lockcheck._REAL_LOCK


def test_violation_reports_carry_schedule_witness():
    lockcheck.enable(roots=[HERE])
    schedcheck.enable()
    schedcheck.begin_run(seed=9)
    a, b = threading.Lock(), threading.Lock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    st = lockcheck.state()
    assert st["cycle_count"] == 1
    sched = st["cycles"][0]["schedule"]
    assert sched and sched["schedule_seed"] == 9
    schedcheck.end_run()


# ----------------------------------------------------------------------
# per-thread id streams


def _draws_in_thread(name, n):
    from nomad_tpu_torch.structs.job import generate_uuid
    out = []

    def run():
        out.extend(generate_uuid() for _ in range(n))

    t = threading.Thread(target=run, name=name, daemon=True)
    t.start()
    t.join()
    return out


def test_per_thread_id_streams_are_interleaving_independent():
    from nomad_tpu_torch.structs.job import generate_uuid, reseed_ids

    reseed_ids(42)
    main_first = [generate_uuid() for _ in range(3)]
    thread_after = _draws_in_thread("stream-probe", 3)
    reseed_ids(42)
    thread_before = _draws_in_thread("stream-probe", 3)
    main_second = [generate_uuid() for _ in range(3)]
    assert main_first == main_second
    assert thread_after == thread_before
    assert set(main_first).isdisjoint(thread_after)
    reseed_ids(42)
    assert _draws_in_thread("stream-other", 3) != thread_before


def test_reseed_keeps_single_thread_stream_stable():
    from nomad_tpu_torch.structs.job import generate_uuid, reseed_ids

    reseed_ids(7)
    a = [generate_uuid() for _ in range(4)]
    reseed_ids(7)
    assert a == [generate_uuid() for _ in range(4)]


def test_same_name_respawn_does_not_replay_id_stream():
    from nomad_tpu_torch.structs.job import reseed_ids

    reseed_ids(99)
    first = _draws_in_thread("scheduler-worker-1", 4)
    respawn = _draws_in_thread("scheduler-worker-1", 4)
    assert set(first).isdisjoint(respawn)
    reseed_ids(99)
    assert _draws_in_thread("scheduler-worker-1", 4) == first
    assert _draws_in_thread("scheduler-worker-1", 4) == respawn


# ----------------------------------------------------------------------
# the same verdict as the reference's explorer; two packages, one seam


def _explore_kinds(mod, scenario, seeds):
    res = mod.explore(scenario, seeds=seeds)
    return sorted({v["kind"] for v in res.violations})


@pytest.mark.parametrize("name,seeds", [
    ("broker-smoke", 4), ("planted-write-skew", 64),
    ("planted-torn-read", 64), ("deadlock", 1)])
def test_same_verdict_as_the_reference(name, seeds):
    """Each scenario under the reference's explorer (its store, applier
    and broker), then the port's rebuild of it under the port's: the same
    classes of violation found (or none)."""
    if name == "deadlock":
        ref_fn = port_fn = _scenario_event_deadlock
    else:
        ref_fn = ref_schedcheck.SCENARIOS[name]
        port_fn = schedcheck.SCENARIOS[name]
    ref = _explore_kinds(ref_schedcheck, ref_fn, seeds)
    for mod in (ref_schedcheck, ref_lockcheck, ref_statecheck):
        mod.disable()
        mod._reset_for_tests()
    assert _pristine()
    before = _globals()
    assert _explore_kinds(schedcheck, port_fn, seeds) == ref
    for mod in (schedcheck, lockcheck, statecheck):
        mod.disable()
    assert _globals() == before


def test_both_packages_in_turn_restore_the_stdlib():
    for _ in range(2):
        ref_schedcheck.enable()
        assert not _pristine()
        ref_schedcheck.disable()
        assert _pristine()
        before = _globals()
        schedcheck.enable()
        assert not _pristine()
        schedcheck.disable()
        assert _globals() == before


def test_enable_refuses_a_foreign_patch():
    ref_schedcheck.enable()
    try:
        with pytest.raises(RuntimeError, match="another owner"):
            schedcheck.enable()
        assert not schedcheck.enabled()
    finally:
        ref_schedcheck.disable()
    assert _pristine()


# ----------------------------------------------------------------------
# the whole slice: a server round with all four armed

SLICE_JOBS, SLICE_PLACE, SLICE_NODES = 8, 20, 64


def _slice_store():
    """The reference store of the round: SLICE_NODES nodes of distinct
    sizes (no two tie on score), SLICE_JOBS jobs of SLICE_PLACE -- job e
    on rack e only (meta.rack), so no two lanes meet on a node and the
    placements do not rest on the order the lanes reach the barrier --
    and the jobs' evals (fixed ids, not yet written)."""
    from nomad_tpu import mock as ref_mock
    from nomad_tpu import structs as ref_structs
    from nomad_tpu.state import StateStore as RefStateStore
    from nomad_tpu.structs.job import reseed_ids

    reseed_ids(11)
    store = RefStateStore()
    store.set_scheduler_config(ref_structs.SchedulerConfiguration(
        scheduler_algorithm="tpu-binpack"))
    for i in range(SLICE_NODES):
        n = ref_mock.node()
        n.id = f"slice-node-{i:04d}"
        n.node_resources.cpu.cpu_shares = 3000 + 37 * i
        n.node_resources.memory.memory_mb = 8192 + 64 * i
        n.meta = {"rack": str(i % SLICE_JOBS)}
        n.compute_class()
        store.upsert_node(n)
    evals = []
    for e in range(SLICE_JOBS):
        job = ref_mock.job(id=f"slice-job-{e}")
        job.task_groups[0].count = SLICE_PLACE
        job.constraints.append(ref_structs.Constraint(
            l_target="${meta.rack}", r_target=str(e), operand="="))
        store.upsert_job(job)
        evals.append(ref_structs.Evaluation(
            id=f"slice-job-{e}-eval-{e:04d}", namespace=job.namespace,
            priority=job.priority, type=job.type,
            triggered_by="job-register", job_id=job.id, status="pending"))
    return store, evals


def _slice_round(server, evals):
    """Write and enqueue ``evals`` in one call, wait until every
    placement is live; each job's placements, (node id, normalized score
    bits) sorted."""
    server.state.upsert_evals(evals)
    server.broker.enqueue_all(evals)
    deadline = time.time() + 120
    while True:
        live = [a for a in server.state.allocs()
                if a.desired_status == "run"]
        if len(live) >= SLICE_JOBS * SLICE_PLACE and all(
                server.state.eval_by_id(ev.id).status != "pending"
                for ev in evals):
            break
        assert time.time() < deadline, "the slice round did not settle"
        time.sleep(0.02)
    out = {}
    for a in live:
        out.setdefault(a.job_id, []).append((a.node_id, np.float64(
            a.metrics.scores[f"{a.node_id}.normalized-score"]).tobytes()))
    return {j: sorted(v) for j, v in out.items()}


def test_server_round_with_all_four_armed_is_clean_and_places_alike(
        monkeypatch):
    """8 jobs x 20 on 64 nodes through one batch worker (so the commits'
    order is fixed): the reference's unarmed run, the port's unarmed run
    on a carried copy of the reference's store, and the port's run with
    all four checkers armed (schedcheck seed 11) place alike, bit for
    bit, and the armed run is clean."""
    from nomad_tpu.server import Server as RefServer
    from nomad_tpu.tensor import pack as ref_pack
    from nomad_tpu_torch.carry import (store_from_reference,
                                       struct_from_reference)
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.tensor import pack as port_pack

    monkeypatch.setattr(RefServer, "_start_background", lambda self: None)
    monkeypatch.setattr(Server, "_start_background", lambda self: None)
    ref_pack._reset_pack_caches_for_tests()
    port_pack.reset_pack_caches()
    kw = dict(num_workers=1, eval_batching=True, batch_width=SLICE_JOBS)
    store, evals = _slice_store()
    ref = RefServer(state=store, heartbeat_ttl=3600.0, **kw)
    ref.start()
    snap = store.snapshot()

    def port_round(armed):
        if armed:
            lockcheck.enable()
            jitcheck.enable()
            statecheck.enable()
            schedcheck.enable()
            schedcheck.begin_run(11)
        memo = {}
        port = Server(state=store_from_reference(snap, memo), device="cpu",
                      heartbeat_ttl=3600.0, **kw)
        port.start()
        try:
            got = _slice_round(port, [struct_from_reference(ev, memo)
                                      for ev in evals])
            states = None
            if armed:
                summary = schedcheck.end_run()
                states = dict(lock=lockcheck.state(), jit=jitcheck.state(),
                              state=statecheck.state(),
                              sched=schedcheck.state(), summary=summary)
        finally:
            port.shutdown()
        return got, states

    try:
        want = _slice_round(ref, evals)
    finally:
        ref.shutdown()
    plain, _ = port_round(False)
    port_pack.reset_pack_caches()
    armed, st = port_round(True)
    assert sum(len(v) for v in want.values()) == SLICE_JOBS * SLICE_PLACE
    assert plain == want
    assert armed == plain
    assert st["lock"]["cycles"] == [], st["lock"]["cycles"]
    assert st["state"]["torn_reads"] == []
    assert st["state"]["aliasing_writes"] == []
    assert st["jit"]["host_syncs"] == [], [
        (r["kind"], r["site"], r["stack"]) for r in st["jit"]["host_syncs"]]
    assert st["jit"]["rebuilds"] == []
    assert st["jit"]["mutations"] == []
    assert st["sched"]["deadlock_count"] == 0
    assert st["summary"]["decisions"] > 0
