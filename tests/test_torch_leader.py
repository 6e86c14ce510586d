"""The port's leader duties (server/core.py) held against the JAX
package's on the CPU.

Each scenario builds one world in the reference's store -- nodes with
fixed ids, the tpu-binpack algorithm -- starts a reference Server on it,
carries the store to a port Server on device="cpu", and drives both the
same way: the same calls, with both id streams reseeded alike before
each, so the evals both servers mint carry the same ids. One plain
worker per server takes one eval at a time, so the evals run in the same
order in both.

Time is a fake clock patched into both packages' server modules (core,
and plan_apply, whose BadNodeTracker scores the flaps): wall time moves
only when a scenario advances it. The leader loops are not started
(``_start_background`` is patched to a no-op in both); a scenario runs
one turn of a loop with ``tick`` (the loop's shutdown event answers
"not yet" once, then "stop"), and the supervisor's own thread waits an
hour between checks while a scenario calls ``_check_once``. Every wait
has a deadline; no test sleeps to let time pass.

The scenarios are those of tests/test_flap_lifecycle.py,
tests/test_churn_storm.py (the flap storm, with heartbeats driving the
nodes down), tests/test_gc_bounded.py, tests/test_worker_pool.py (the
supervisor), the drain, deployment, periodic, stop-alloc and GC
scenarios of tests/test_server_e2e.py (a client's acks played by
update_allocs_from_client) and the event parts of
tests/test_snapshot_events.py. Compared: node statuses and quarantines,
evals by trigger and status, live allocs name -> node, GC's return
dicts, deployment statuses, job versions and stability, periodic
children, event topics in order, supervisor restarts and the leader's
counters.
"""
import collections
import contextlib
import copy
import threading
import time as _real_time

import pytest
import torch

from nomad_tpu import mock
from nomad_tpu.faultinject import faults as ref_faults
from nomad_tpu.server import Server as RefServer
from nomad_tpu.server import core as ref_core
from nomad_tpu.server import plan_apply as ref_plan_apply
from nomad_tpu.server.core import NodeFlapTracker as RefFlapTracker
from nomad_tpu.server.telemetry import metrics as ref_metrics
from nomad_tpu.solver import guard as ref_guard
from nomad_tpu.state import StateStore as RefStateStore
from nomad_tpu.structs import (
    AllocDeploymentStatus, DrainStrategy, MigrateStrategy, PeriodicConfig,
    SchedulerConfiguration)
from nomad_tpu.structs.job import reseed_ids as ref_reseed_ids
from nomad_tpu.tensor import pack as ref_pack

from nomad_tpu_torch import structs as pst
from nomad_tpu_torch.carry import store_from_reference, struct_from_reference
from nomad_tpu_torch.faultinject import faults as port_faults
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.server import core as port_core
from nomad_tpu_torch.server import plan_apply as port_plan_apply
from nomad_tpu_torch.server.core import NodeFlapTracker
from nomad_tpu_torch.server.telemetry import metrics as port_metrics
from nomad_tpu_torch.solver import guard
from nomad_tpu_torch.tensor import pack as port_pack

torch.set_num_threads(1)

SETTLE_S = 60.0
TTL = 60.0
LEADER_COUNTERS = (
    "nomad.heartbeat.flap_quarantined", "nomad.heartbeat.flap_recorded",
    "nomad.heartbeat.quarantine_deferred", "nomad.gc.table_compactions",
    "nomad.gc.watermark_allocs_deleted", "nomad.worker.supervisor_death",
    "nomad.worker.supervisor_wedge", "nomad.worker.supervisor_restart")


class Clock:
    """``time`` for the server modules: time() runs ``offset`` seconds
    ahead of the wall clock; everything else is the real module's."""

    def __init__(self):
        self.offset = 0.0

    def time(self):
        return _real_time.time() + self.offset

    def advance(self, s):
        self.offset += s

    def __getattr__(self, name):
        return getattr(_real_time, name)


def setenv(monkeypatch, name, value):
    """A knob under both packages' prefixes."""
    monkeypatch.setenv("NOMAD_TPU_" + name, value)
    monkeypatch.setenv("NOMAD_TPU_TORCH_" + name, value)


@pytest.fixture
def clock(monkeypatch):
    """The fake clock in both packages, the leader loops off, the
    supervisor's own checks an hour apart, caches and faults fresh."""
    c = Clock()
    for mod in (ref_core, port_core, ref_plan_apply, port_plan_apply):
        monkeypatch.setattr(mod, "time", c)
    monkeypatch.setattr(RefServer, "_start_background", lambda self: None)
    monkeypatch.setattr(Server, "_start_background", lambda self: None)
    setenv(monkeypatch, "WORKER_CHECK_S", "3600")
    ref_pack._reset_pack_caches_for_tests()
    port_pack.reset_pack_caches()
    guard._reset_for_tests()
    ref_guard._reset_for_tests()
    before = set(threading.enumerate())
    yield c
    ref_faults.disarm_all()
    port_faults.disarm_all()
    guard._reset_for_tests()
    ref_guard._reset_for_tests()
    left = [t.name for t in threading.enumerate()
            if t.is_alive() and t not in before
            and t.name.startswith(("scheduler-worker-", "batch-worker-",
                                   "worker-supervisor-", "plan-"))]
    assert not left, left


def wait_until(cond, timeout=SETTLE_S, msg="condition"):
    deadline = _real_time.monotonic() + timeout
    while _real_time.monotonic() < deadline:
        if cond():
            return
        threading.Event().wait(0.02)
    raise AssertionError(f"timeout waiting for {msg}")


def settled(server):
    st = server.broker.stats()
    if st["total_ready"] or st["total_unacked"] or st["total_waiting"]:
        return False        # (a delayed eval is pending in the store)
    # a follow-up waiting out a disconnect grace stays pending
    later = _real_time.time() + 5.0
    return all(e.status != "pending"
               or (e.wait_until and e.wait_until > later)
               for e in server.state.evals())


class Pair:
    """A reference Server and a port Server over one world."""

    def __init__(self, ref, port, memo):
        self.ref, self.port, self.memo = ref, port, memo
        self.seed = 5000

    def servers(self):
        return (self.ref, self.port)

    def carry(self, obj):
        return struct_from_reference(obj, self.memo)

    def both(self, fn):
        """fn(server, carry) in each, both id streams reseeded alike;
        returns (ref result, port result)."""
        self.seed += 1
        ref_reseed_ids(self.seed)
        a = fn(self.ref, lambda x: x)
        pst.reseed_ids(self.seed)
        b = fn(self.port, self.carry)
        return a, b

    def settle(self):
        for s in self.servers():
            wait_until(lambda s=s: settled(s), msg="settled")
        # a follow-up's broker write lands after its eval's update
        threading.Event().wait(0.1)
        for s in self.servers():
            wait_until(lambda s=s: settled(s), msg="settled")

    def tick(self, loop):
        """One turn of a leader loop in each server."""
        def run(server, _):
            real = server._shutdown
            server._shutdown = _OneTurn()
            try:
                getattr(server, loop)()
            finally:
                server._shutdown = real
        self.both(run)

    def assert_same(self, events=True):
        want, got = outcome(self.ref), outcome(self.port)
        for key in want:
            if key == "events" and not events:
                continue
            assert got[key] == want[key], key
        return got


class _OneTurn:
    def __init__(self):
        self.turns = 1

    def wait(self, _timeout=None):
        self.turns -= 1
        return self.turns < 0

    def is_set(self):
        return self.turns < 0


def outcome(server):
    st = server.state
    live = sorted((a.name, a.node_id) for a in st.allocs()
                  if not a.terminal_status())
    evals = collections.Counter(
        (e.triggered_by, e.status, e.job_id) for e in st.evals())
    deployments = sorted((d.job_id, d.job_version, d.status)
                         for d in st.deployments())
    versions = sorted((j.id, j.version, j.stable, j.stop)
                      for j in st.jobs())
    return dict(
        nodes=sorted((n.id, n.status, n.scheduling_eligibility,
                      n.drain_strategy is not None) for n in st.nodes()),
        live=live, evals=sorted(evals.items()), deployments=deployments,
        jobs=versions,
        quarantined=sorted(server.flaps._quarantine),
        rejected=server.planner.plans_rejected,
        events=events(server))


# published by the worker as it runs an eval; the rest by the caller
WORKER_TOPICS = ("PlanApplied", "EvalUpdated")


def events(server):
    """The event stream as (topic, key) in order, split by publisher:
    the caller's and the worker's each keep their order, while the
    interleaving of the two follows thread timing."""
    evs = [(e["topic"], e["key"]) for e in server.events_since(0)]
    return ([e for e in evs if e[0] not in WORKER_TOPICS],
            [e for e in evs if e[0] in WORKER_TOPICS])


def counters(registry):
    snap = registry.snapshot()["counters"]
    return {k: snap.get(k, 0) for k in LEADER_COUNTERS}


@contextlib.contextmanager
def leader_pair(n_nodes=6, node_cpu=4000, **server_kw):
    """A reference Server on a fresh world of ``n_nodes`` nodes and a
    port Server on a carried copy, both started; shut down on exit."""
    ref_reseed_ids(4000)
    store = RefStateStore()
    store.set_scheduler_config(
        SchedulerConfiguration(scheduler_algorithm="tpu-binpack"))
    for i in range(n_nodes):
        n = mock.node()
        n.id = f"leader-node-{i:04d}"
        n.node_resources.cpu.cpu_shares = node_cpu
        n.compute_class()
        store.upsert_node(n)
    kw = dict(num_workers=1, eval_batching=False, heartbeat_ttl=TTL)
    kw.update(server_kw)
    ref = RefServer(state=store, **kw)
    port = None
    try:
        ref.start()
        memo = {}
        port = Server(state=store_from_reference(store.snapshot(), memo),
                      device="cpu", **kw)
        port.start()
        assert port.state.latest_index() == store.latest_index()
        yield Pair(ref, port, memo)
    finally:
        ref.shutdown()
        if port is not None:
            port.shutdown()


def register(pair, job):
    """Register ``job`` (a reference struct) in both servers."""
    return pair.both(lambda s, c: s.register_job(c(copy.deepcopy(job))))


def ack(pair, pred=lambda a: True, status="running", healthy=None):
    """A client's acks: every live alloc matching ``pred`` takes
    ``status`` (and a deployment health), in both servers."""
    def run(server, _):
        ups = []
        for a in server.state.allocs():
            if a.terminal_status() or not pred(a):
                continue
            u = a.copy_skip_job()
            u.client_status = status
            if healthy is not None:
                u.deployment_status = _ads(server)
                u.deployment_status.healthy = healthy
            ups.append(u)
        ups.sort(key=lambda a: a.name)
        if ups:
            server.update_allocs_from_client(ups)
        return len(ups)
    return pair.both(run)


def _ads(server):
    return (pst.AllocDeploymentStatus() if isinstance(server, Server)
            else AllocDeploymentStatus())


def service_job(job_id, count, **tg_kw):
    job = mock.job(id=job_id)
    tg = job.task_groups[0]
    tg.count = count
    for k, v in tg_kw.items():
        setattr(tg, k, v)
    return job


# ----------------------------------------------------------------------
# flaps (tests/test_flap_lifecycle.py)

def test_flap_tracker_matches_reference(clock, monkeypatch):
    """The tracker alone: escalating, capped quarantines, release, the
    state surface and the kill switch."""
    setenv(monkeypatch, "FLAP_THRESHOLD", "2")
    setenv(monkeypatch, "FLAP_BASE_S", "4")
    setenv(monkeypatch, "FLAP_MAX_S", "10")
    ref, port = RefFlapTracker(), NodeFlapTracker()
    for step in range(5):
        assert port.record_down("n1") == ref.record_down("n1")
        assert port.quarantine_remaining("n1") == \
            pytest.approx(ref.quarantine_remaining("n1"), abs=0.05)
        if step == 1:
            port.record_down("n2")
            ref.record_down("n2")
            want, got = ref.state(), port.state()
            assert got["scores"] == want["scores"]
            assert set(got["quarantined"]) == set(want["quarantined"])
    clock.advance(11)
    assert port.quarantine_remaining("n1") == \
        ref.quarantine_remaining("n1") == 0.0
    port.record_down("n1")
    ref.record_down("n1")
    port.release("n1")
    ref.release("n1")
    assert port.quarantine_remaining("n1") == ref.quarantine_remaining("n1")
    setenv(monkeypatch, "FLAP", "0")
    ref, port = RefFlapTracker(), NodeFlapTracker()
    assert [port.record_down("n") for _ in range(4)] == \
        [ref.record_down("n") for _ in range(4)] == [0] * 4
    assert port.state()["enabled"] is ref.state()["enabled"] is False


FLAP_CASES = ["single_flap", "repeat_flapper", "killswitch",
              "reregistration"]


@pytest.mark.parametrize("case", FLAP_CASES)
def test_flap_lifecycle_matches_reference(clock, monkeypatch, case):
    if case == "repeat_flapper":
        setenv(monkeypatch, "FLAP_THRESHOLD", "2")
        setenv(monkeypatch, "FLAP_BASE_S", "30")
        setenv(monkeypatch, "FLAP_MAX_S", "30")
    elif case == "killswitch":
        setenv(monkeypatch, "FLAP", "0")
    elif case == "reregistration":
        setenv(monkeypatch, "FLAP_THRESHOLD", "1")
        setenv(monkeypatch, "FLAP_BASE_S", "600")
    c0 = counters(ref_metrics), counters(port_metrics)
    with leader_pair(n_nodes=2) as pair:
        pair.both(lambda s, c: setattr(s, "flaps", type(s.flaps)()))
        nid = "leader-node-0000"
        seen = []

        def step(fn):
            pair.both(lambda s, c: fn(s))
            pair.settle()
            got = pair.assert_same()
            seen.append(dict(got["nodes"] and
                             {n: st for n, st, *_ in got["nodes"]})[nid])

        rounds = {"single_flap": 1, "repeat_flapper": 2, "killswitch": 6,
                  "reregistration": 1}[case]
        for _ in range(rounds):
            step(lambda s: s.update_node_status(nid, "down"))
            step(lambda s: s.heartbeat(nid))
        if case == "repeat_flapper":
            clock.advance(31)
            step(lambda s: s.heartbeat(nid))
        if case == "reregistration":
            node = pair.ref.state.node_by_id(nid)
            pair.both(lambda s, c: s.register_node(c(copy.copy(node))))
            pair.settle()
            seen.append(pair.assert_same()["nodes"][0][1])
        deltas = [{k: after[k] - before[k] for k in after}
                  for before, after in zip(
                      c0, (counters(ref_metrics), counters(port_metrics)))]
        assert deltas[1] == deltas[0]
    expect_down = {"single_flap": [], "killswitch": [],
                   "repeat_flapper": [3], "reregistration": [1]}[case]
    assert [i for i, st in enumerate(seen) if st == "down"
            and i % 2 == 1] == expect_down


# ----------------------------------------------------------------------
# heartbeats: the node-down fan-out (tests/test_churn_storm.py)

@pytest.mark.parametrize("grace", [False, True])
def test_silent_nodes_go_down_and_allocs_are_replaced(clock, grace):
    """Two service jobs on twelve nodes; nine keep heartbeating and three
    go silent past the TTL. The watcher marks the three down (or
    disconnected, with disconnect grace), and every lost alloc is
    replaced exactly once on other nodes, with no plan rejected."""
    with leader_pair(n_nodes=12) as pair:
        tg_kw = {"max_client_disconnect_s": 300.0} if grace else {}
        for k in range(2):
            register(pair, service_job(f"hb-job-{k}", 6, **tg_kw))
            pair.settle()
        ack(pair)
        pair.settle()
        before = pair.assert_same()
        silent = {f"leader-node-{i:04d}" for i in (1, 4, 7)}
        clock.advance(TTL - 1)
        pair.both(lambda s, c: [s.heartbeat(n.id) for n in s.state.nodes()
                                if n.id not in silent])
        clock.advance(2)
        pair.tick("_run_heartbeat_watcher")
        pair.settle()
        got = pair.assert_same()
        status = {n: st for n, st, *_ in got["nodes"]}
        gone = {n for n, st in status.items() if st != "ready"}
        assert gone == silent
        # a silent node holding a graced alloc disconnects; others go down
        holders = {node for _, node in before["live"]}
        assert {n for n in silent if status[n] == "disconnected"} == \
            (silent & holders if grace else set())
        if not grace:
            lost = [name for name, node in before["live"] if node in silent]
            assert lost
            live = dict(got["live"])
            assert len(got["live"]) == len(before["live"])
            assert all(live[name] not in silent for name in lost)
        assert got["rejected"] == 0


def test_flap_storm_holds_the_flapper_down(clock, monkeypatch):
    """A node that misses its TTL three times is held down by the
    quarantine on its third recovery; every lost alloc was replaced
    exactly once."""
    setenv(monkeypatch, "FLAP_THRESHOLD", "3")
    setenv(monkeypatch, "FLAP_BASE_S", "120")
    with leader_pair(n_nodes=4) as pair:
        register(pair, service_job("storm-job", 6))
        pair.settle()
        ack(pair)
        pair.settle()
        flapper = pair.ref.state.allocs()[0].node_id
        statuses = []
        for _ in range(3):
            clock.advance(TTL - 1)
            pair.both(lambda s, c: [s.heartbeat(n.id)
                                    for n in s.state.nodes()
                                    if n.id != flapper])
            clock.advance(2)
            pair.tick("_run_heartbeat_watcher")
            pair.settle()
            ack(pair)
            pair.settle()
            pair.both(lambda s, c: s.heartbeat(flapper))
            pair.settle()
            got = pair.assert_same()
            statuses.append({n: st for n, st, *_ in got["nodes"]}[flapper])
        assert statuses == ["ready", "ready", "down"]
        assert got["quarantined"] == [flapper]
        names = [name for name, _ in got["live"]]
        assert len(names) == len(set(names)) == 6
        assert got["rejected"] == 0


def test_deregister_node_reschedules(clock):
    with leader_pair(n_nodes=3) as pair:
        register(pair, service_job("purge-job", 2))
        pair.settle()
        victim = pair.ref.state.allocs()[0].node_id
        pair.both(lambda s, c: s.deregister_node(victim))
        pair.settle()
        got = pair.assert_same()
        assert victim not in {n for n, *_ in got["nodes"]}
        assert all(node != victim for _, node in got["live"])


# ----------------------------------------------------------------------
# the drainer (tests/test_server_e2e.py)

@pytest.mark.parametrize("mode", ["paced", "forced"])
def test_drain_migrates_every_alloc(clock, mode):
    """max_parallel 1: at most one of the group's allocs migrates at a
    time (paced), or all at once past the deadline (forced); the drain
    completes and the node stays ineligible."""
    with leader_pair(n_nodes=3, node_cpu=8000) as pair:
        job = service_job("drain-job", 6,
                          migrate=MigrateStrategy(max_parallel=1))
        register(pair, job)
        pair.settle()
        ack(pair)
        pair.settle()
        victim = pair.ref.state.allocs()[0].node_id
        on_victim = [a.name for a in pair.ref.state.allocs()
                     if a.node_id == victim]
        deadline = 600.0 if mode == "paced" else 1.0
        pair.both(lambda s, c: s.drain_node(victim, c(DrainStrategy(
            deadline_s=deadline))))
        if mode == "forced":
            clock.advance(5)
        max_in_flight = 0
        for _ in range(4 * len(on_victim) + 4):
            pair.settle()
            ack(pair)
            pair.settle()
            pair.assert_same()
            max_in_flight = max(max_in_flight, sum(
                1 for a in pair.port.state.allocs()
                if a.desired_transition.migrate and not a.terminal_status()))
            if not pair.port.state.node_by_id(victim).drain:
                break
            pair.tick("_run_drainer")
        got = pair.assert_same()
        node = {n: (st, elig, dr) for n, st, elig, dr in got["nodes"]}
        assert node[victim] == ("ready", "ineligible", False)
        live = dict(got["live"])
        assert all(live[name] != victim for name in on_victim)
        assert len(live) == 6 and got["rejected"] == 0
        topics = [t for t, _ in got["events"][0]]
        assert "NodeDrain" in topics and "NodeDrainComplete" in topics
        if mode == "paced":
            assert max_in_flight <= 1


# ----------------------------------------------------------------------
# GC (tests/test_gc_bounded.py, tests/test_server_e2e.py)

def _seed_terminal(pair, n_terminal, n_live):
    """Terminal and live allocs of one job on one node, written one at a
    time (so the oldest are the first written)."""
    node = pair.ref.state.nodes()[0]
    job = mock.job(id="gc-job")
    pair.both(lambda s, c: s.state.upsert_job(c(copy.deepcopy(job))))
    allocs = []
    for i in range(n_terminal + n_live):
        a = mock.alloc_for(job, node, index=i)
        a.id = f"gc-alloc-{i:04d}"
        a.client_status = "complete" if i < n_terminal else "running"
        allocs.append(a)
    for a in allocs:
        pair.both(lambda s, c: s.state.upsert_allocs([c(copy.copy(a))]))
    return allocs


GC_CASES = [("watermark", 30, 10, 10), ("disabled", 30, 10, 0),
            ("env_default", 30, 10, None), ("compaction", 40, 8, 4)]


@pytest.mark.parametrize("case,n_terminal,n_live,watermark", GC_CASES,
                         ids=[c[0] for c in GC_CASES])
def test_gc_watermark_and_compaction(clock, monkeypatch, case, n_terminal,
                                     n_live, watermark):
    if case == "env_default":
        setenv(monkeypatch, "GC_ALLOC_WATERMARK", "5")
    with leader_pair(n_nodes=2) as pair:
        _seed_terminal(pair, n_terminal, n_live)
        if case == "compaction":
            for s in pair.servers():
                orig = s.state.compact_alloc_table
                monkeypatch.setattr(
                    s.state, "compact_alloc_table",
                    lambda min_free=4096, free_ratio=0.5, _o=orig:
                    _o(min_free=8, free_ratio=0.3))
                s.state.alloc_table._fold_inc_get()
        c0 = counters(ref_metrics), counters(port_metrics)
        want, got = pair.both(
            lambda s, c: s.run_gc_once(terminal_watermark=watermark))
        assert got == want
        assert sorted(a.id for a in pair.port.state.allocs()) == \
            sorted(a.id for a in pair.ref.state.allocs())
        deltas = [{k: after[k] - before[k] for k in after}
                  for before, after in zip(
                      c0, (counters(ref_metrics), counters(port_metrics)))]
        assert deltas[1] == deltas[0]
        t = pair.port.state.alloc_table
        assert t.fold_parity_mismatch() == 0
        if case == "compaction":
            assert got["compacted"] is not None and t.free_rows == 0
            assert t.n_rows == 4 + n_live


def test_gc_collects_terminal_state(clock):
    """A batch job run to completion: its evals, allocs and then the dead
    job go in the age-based passes, as in the reference."""
    with leader_pair(n_nodes=2) as pair:
        job = mock.batch_job(count=2)
        job.id = "gc-batch"
        register(pair, job)
        pair.settle()
        ack(pair, status="complete")
        pair.settle()
        pair.assert_same()
        clock.advance(7200)
        for _ in range(2):
            want, got = pair.both(lambda s, c: s.run_gc_once(threshold=0.0))
            assert got == want
            pair.assert_same(events=False)
        assert pair.port.state.job_by_id("default", "gc-batch") is None


# ----------------------------------------------------------------------
# periodic dispatch and stop_alloc (tests/test_server_e2e.py)

@pytest.mark.parametrize("overlap", [False, True])
def test_periodic_children_match_reference(clock, overlap):
    with leader_pair(n_nodes=2) as pair:
        job = mock.batch_job(count=1)
        job.id = "periodic-job"
        job.periodic = PeriodicConfig(enabled=True, spec="@every 5s",
                                      prohibit_overlap=overlap)
        register(pair, job)
        for dt in (0, 1, 5, 0.5, 6):
            clock.advance(dt)
            pair.tick("_run_periodic")
            pair.settle()
            pair.assert_same()
        clock.advance(1)        # a child id names its launch second
        child = pair.both(lambda s, c: s.periodic_force("default",
                                                         "periodic-job"))
        assert child[0] == child[1]
        pair.settle()
        got = pair.assert_same()
        children = sorted(j for j, *_ in got["jobs"]
                          if j.startswith("periodic-job/periodic-"))
        assert len(children) == (2 if overlap else 4)
        # a new leadership restores the launch times from the children
        pair.both(lambda s, c: (s.revoke_leadership(),
                                s.establish_leadership()))
        assert pair.port._periodic_last == pair.ref._periodic_last
        assert pair.port._periodic_last


def test_stop_alloc_replaces_the_allocation(clock):
    with leader_pair(n_nodes=3) as pair:
        register(pair, service_job("stop-job", 2))
        pair.settle()
        ack(pair)
        pair.settle()
        victim = sorted(pair.ref.state.allocs(), key=lambda a: a.name)[0]
        eids = pair.both(lambda s, c: s.stop_alloc(victim.id))
        assert eids[0] == eids[1]
        pair.settle()
        got = pair.assert_same()
        assert len(got["live"]) == 2
        assert pair.port.state.alloc_by_id(victim.id).desired_status == \
            "stop"
        assert ("alloc-stop", "complete", "stop-job") in \
            dict(got["evals"])


# ----------------------------------------------------------------------
# job versions and the deployment watcher (tests/test_server_e2e.py)

def _rollout(pair, job_id, count, auto_revert=False):
    """v0 running and healthy, then a destructive v1 with a deployment."""
    job = service_job(job_id, count)
    job.task_groups[0].update.max_parallel = 1
    job.task_groups[0].update.auto_revert = auto_revert
    register(pair, job)
    pair.settle()
    ack(pair, healthy=True)
    pair.settle()
    pair.both(lambda s, c: s.set_job_stability("default", job_id, 0, True))
    job2 = copy.deepcopy(job)
    job2.task_groups[0].tasks[0].resources.cpu = 150
    register(pair, job2)
    pair.settle()
    return job2


def _deployment(server, job_id):
    return server.state.latest_deployment_by_job("default", job_id)


@pytest.mark.parametrize("case", ["successful", "auto_revert",
                                  "operator_ops"])
def test_deployment_watcher_matches_reference(clock, case):
    with leader_pair(n_nodes=4) as pair:
        job_id = f"deploy-{case}"
        _rollout(pair, job_id, 2, auto_revert=case == "auto_revert")
        if case == "operator_ops":
            for op in (lambda s: s.pause_deployment(
                           _deployment(s, job_id).id, True),
                       lambda s: s.pause_deployment(
                           _deployment(s, job_id).id, False),
                       lambda s: s.fail_deployment(
                           _deployment(s, job_id).id)):
                pair.both(lambda s, c, op=op: op(s))
                pair.settle()
                pair.assert_same()
            for s in pair.servers():
                with pytest.raises(ValueError):
                    s.fail_deployment(_deployment(s, job_id).id)
        else:
            healthy = case == "successful"
            for _ in range(12):
                ack(pair, pred=lambda a: a.job_version == 1,
                    healthy=healthy)
                pair.settle()
                pair.tick("_run_deployment_watcher")
                pair.settle()
                got = pair.assert_same()
                d = _deployment(pair.port, job_id)
                if d is not None and not d.active():
                    break
        got = pair.assert_same()
        want_status = {"successful": "successful", "auto_revert": "failed",
                       "operator_ops": "failed"}[case]
        assert (job_id, 1, want_status) in got["deployments"]
        versions = pair.port.job_versions("default", job_id)
        assert [j.version for j in versions] == \
            [j.version for j in pair.ref.job_versions("default", job_id)]
        if case == "successful":
            assert pair.port.state.job_version("default", job_id, 1).stable
        if case == "auto_revert":
            assert versions[0].version == 2      # v0 registered again


def test_revert_and_stability_match_reference(clock):
    with leader_pair(n_nodes=2) as pair:
        job = service_job("rev-job", 1)
        register(pair, job)
        pair.settle()           # each eval reads the index it was made at
        job2 = copy.deepcopy(job)
        job2.task_groups[0].count = 2
        register(pair, job2)
        pair.settle()
        pair.both(lambda s, c: s.revert_job("default", "rev-job", 0))
        pair.both(lambda s, c: s.set_job_stability("default", "rev-job", 1,
                                                   True))
        for s in pair.servers():
            with pytest.raises(ValueError):
                s.revert_job("default", "rev-job", 2)
            with pytest.raises(ValueError):
                s.revert_job("default", "rev-job", 0,
                             enforce_prior_version=1)
        pair.settle()
        pair.assert_same()
        assert [(j.version, j.stable, j.task_groups[0].count)
                for j in pair.port.job_versions("default", "rev-job")] == \
            [(j.version, j.stable, j.task_groups[0].count)
             for j in pair.ref.job_versions("default", "rev-job")]


# ----------------------------------------------------------------------
# the worker supervisor (tests/test_worker_pool.py)

def test_supervisor_restarts_a_dead_worker(clock, monkeypatch):
    """An armed worker.crash kills the worker mid-eval; the supervisor
    respawns the slot, and the orphaned eval, redelivered after the
    nack timeout, is placed exactly once."""
    setenv(monkeypatch, "WORKER_RESTART_BASE_S", "0.05")
    setenv(monkeypatch, "WORKER_RESTART_MAX_S", "0.3")
    with leader_pair(n_nodes=2) as pair:
        c0 = counters(ref_metrics), counters(port_metrics)
        for s in pair.servers():
            s.broker.nack_timeout = 0.4
        pair.both(lambda s, c: (port_faults if isinstance(s, Server)
                                else ref_faults).arm(
                                    "worker.crash", "error", count=1))
        register(pair, service_job("crash-job", 2))
        for s in pair.servers():
            wait_until(lambda s=s: not s.workers[0].is_alive(),
                       msg="worker died")
            wait_until(lambda s=s: (s.supervisor._check_once()
                                    or s.supervisor.restarts_total >= 1),
                       msg="slot respawned")
        pair.settle()
        got = pair.assert_same()
        assert sorted(n for n, _ in got["live"]) == \
            ["crash-job.web[0]", "crash-job.web[1]"]
        for s in pair.servers():
            assert (s.supervisor.deaths_detected,
                    s.supervisor.restarts_total) == (1, 1)
            assert s.workers[0].is_alive()
        deltas = [{k: after[k] - before[k] for k in after}
                  for before, after in zip(
                      c0, (counters(ref_metrics), counters(port_metrics)))]
        assert deltas[1] == deltas[0]


class _Wedged(threading.Thread):
    """Alive, no progress: planted in a pool slot."""

    def __init__(self):
        super().__init__(daemon=True, name="wedged-standin")
        self.last_progress = _real_time.monotonic() - 3600.0
        self.evals_processed = 0
        self.stop_called = False
        self._ev = threading.Event()

    def stop(self):
        self.stop_called = True
        self._ev.set()

    def run(self):
        self._ev.wait(60.0)


def test_supervisor_restarts_a_wedged_worker_and_backs_off(clock,
                                                           monkeypatch):
    setenv(monkeypatch, "WORKER_STALL_S", "0.3")
    setenv(monkeypatch, "WORKER_RESTART_BASE_S", "0.1")
    setenv(monkeypatch, "WORKER_RESTART_MAX_S", "0.35")
    with leader_pair(n_nodes=1) as pair:
        for s in pair.servers():
            standin = _Wedged()
            with s._leader_lock:
                old = s.workers[0]
                old.stop()
                old.join(10.0)
                standin.start()
                s.workers[0] = standin
            wait_until(lambda s=s: (s.supervisor._check_once()
                                    or s.supervisor.restarts_total >= 1),
                       msg="wedged slot respawned")
            assert standin.stop_called
            assert s.supervisor.wedges_detected == 1
            standin.stop()
        holds = []
        for s in pair.servers():
            sup = s.supervisor
            got = []
            for _ in range(5):
                sup._schedule_restart_locked(7, 100.0)
                got.append(round(sup._pending.pop(7) - 100.0, 6))
            holds.append(got)
        assert holds[1] == holds[0] == [0.1, 0.2, 0.35, 0.35, 0.35]


def test_supervise_killswitch_starts_no_watcher(clock, monkeypatch):
    setenv(monkeypatch, "WORKER_SUPERVISE", "0")
    with leader_pair(n_nodes=1) as pair:
        for s in pair.servers():
            assert not s.supervisor.enabled
            assert s.supervisor._thread is None
        assert pair.port.supervisor.state()["enabled"] is False


# ----------------------------------------------------------------------
# the event stream (tests/test_snapshot_events.py)

def test_event_stream_matches_reference(clock):
    """Topics in order through a register / place / stop / node-down
    sequence; topic and key filters; replay from an index; the ring's
    trim."""
    with leader_pair(n_nodes=3) as pair:
        subs = pair.both(lambda s, c: (
            s.subscribe_events({"Node*": ["*"], "NodeStatusUpdate": ["*"]}),
            s.subscribe_events({"JobRegistered": ["ev-job"]})))
        register(pair, service_job("ev-job", 2))
        pair.settle()
        mark = pair.both(lambda s, c: s.state.latest_index())
        register(pair, service_job("ev-other", 1))
        pair.settle()
        victim = sorted(pair.ref.state.allocs(), key=lambda a: a.name)[0]
        pair.both(lambda s, c: s.stop_alloc(victim.id))
        pair.settle()
        pair.both(lambda s, c: s.update_node_status("leader-node-0002",
                                                    "down"))
        pair.settle()
        got = pair.assert_same()
        topics = [t for t, _ in got["events"][0] + got["events"][1]]
        for t in ("JobRegistered", "PlanApplied", "EvalUpdated",
                  "AllocStopRequested", "NodeStatusUpdate"):
            assert t in topics
        for want_sub, got_sub in zip(*subs):
            w, g = [], []
            for out, sub in ((w, want_sub), (g, got_sub)):
                while True:
                    e = sub.next(timeout=0.05)
                    if e is None:
                        break
                    out.append((e["topic"], e["key"]))
            assert g == w
        assert sorted((e["topic"], e["key"]) for e in
                      pair.port.events_since(mark[1])) == \
            sorted((e["topic"], e["key"]) for e in
                   pair.ref.events_since(mark[0]))
        replay = pair.both(lambda s, c: s.subscribe_events(
            since_index=s.state.latest_index() - 3))
        assert [replay[1].next(0.05) is None] == [replay[0].next(0.05)
                                                   is None]
        pair.both(lambda s, c: [s.unsubscribe_events(x) for x in
                                (subs[0] if not isinstance(s, Server)
                                 else subs[1])])
        pair.both(lambda s, c: [s.publish_event("Tick", {"name": str(i)})
                                for i in range(4100)])
        assert len(pair.port._events) == len(pair.ref._events)
