"""The port's Server (server/core.py) held against the JAX package's on
the CPU: the same world in both, the same evals enqueued atomically, and
the committed state compared.

Each world is built once with the reference's mock and store (the
worlds of tests/test_solver_parity.py, the parity-scale tiers of
tests/test_parity_scale.py at tens of nodes, tests/test_system_tpu.py
and the LP tier's server worlds of tests/test_lpq.py), handed to a
reference Server, which starts (its keyring write is one index), then
carried to a port StateStore (carry.store_from_reference) for a port
Server on device="cpu". The evals, with fixed ids, are written and
enqueued in one call in each, so each batch worker dequeues the same
batch over a store at the same index: the node shuffle, seeded by eval
id and index, is the same. The reference's batch worker may take its
mesh route on conftest's 8 virtual devices; the port's one-card route
equals its mesh forms, so placements still agree.

A batch of several evals that contend for nodes is settled by the
barrier's cross-lane fixpoint in arrival order (ties in input order),
which thread timing would decide; InOrderLanes hands each batch's lanes
to its barrier in the batch's dequeue order in both packages, so the
LP worlds run at their natural batch width and compare exactly.

Neither Server's background loops (heartbeats, GC, periodic dispatch,
the deployment watcher, the drainer; the reference's volumes) are
started: tests/test_torch_leader.py drives them. Compared once both servers settle: every
live alloc (name -> node, its task and shared resources; float64
normalized scores, rtol 1e-12), every eval's job, type, trigger,
status, queued allocations and failed task groups, the blocked evals,
and the applier's rejections. Every wait has a deadline, and every
server is shut down.
"""
import contextlib
import itertools
import threading
import time

import numpy as np
import pytest
import torch

from nomad_tpu import mock
from nomad_tpu.server import Server as RefServer
from nomad_tpu.server import worker as ref_worker
from nomad_tpu.solver import batch as ref_batch
from nomad_tpu.solver import guard as ref_guard
from nomad_tpu.solver import lpq as ref_lpq
from nomad_tpu.state import StateStore as RefStateStore
from nomad_tpu.structs import (
    Evaluation, PreemptionConfig, SchedulerConfiguration,
    ALLOC_CLIENT_RUNNING)
from nomad_tpu.structs.job import reseed_ids as ref_reseed_ids
from nomad_tpu.tensor import pack as ref_pack

from nomad_tpu_torch import mock as pmock
from nomad_tpu_torch import structs as pst
from nomad_tpu_torch.carry import store_from_reference, struct_from_reference
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.server import worker as port_worker
from nomad_tpu_torch.solver import batch, guard, lpq
from nomad_tpu_torch.tensor import pack as port_pack

from test_torch_scheduler import (
    PARITY_WORLDS, _shared_digest, _task_digest, parity_world,
    system_world, tier_world)

from torch_sanitizers import armed

# the suite runs under the port's sanitizers (tests/torch_sanitizers.py)
_torch_sanitizers = armed("statecheck")

torch.set_num_threads(1)

SETTLE_S = 60.0
WIDTH = 4
SERVER_THREADS = ("batch-worker-", "scheduler-worker-", "batch-eval-",
                  "lpq-eval-", "plan-", "eval-broker-")


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """Both packages' caches and guards start fresh, and both Servers run
    their main path alone: their leader loops (heartbeats, GC, periodic,
    the deployment watcher and the drainer; the reference's volume
    watcher) do not start (the deployment watcher would add evals at a
    time of its own). tests/test_torch_leader.py drives those loops."""
    monkeypatch.setattr(RefServer, "_start_background", lambda self: None)
    monkeypatch.setattr(Server, "_start_background", lambda self: None)
    ref_pack._reset_pack_caches_for_tests()
    port_pack.reset_pack_caches()
    guard._reset_for_tests()
    ref_guard._reset_for_tests()
    lpq._reset_for_tests()
    ref_lpq._reset_for_tests()
    # threads an earlier test file left behind are not this test's
    before = set(threading.enumerate())
    yield
    guard._reset_for_tests()
    ref_guard._reset_for_tests()
    assert not server_threads(before), server_threads(before)


def server_threads(before=()):
    """The live server threads not in ``before``."""
    return [t.name for t in threading.enumerate()
            if t.is_alive() and t not in before
            and t.name.startswith(SERVER_THREADS)]


def wait_until(cond, timeout=SETTLE_S, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timeout waiting for {msg}")


def settled(server, eval_ids):
    """Every given eval left pending, and the broker holds no ready or
    leased eval."""
    st = server.broker.stats()
    if st["total_ready"] or st["total_unacked"]:
        return False
    for eid in eval_ids:
        ev = server.state.eval_by_id(eid)
        if ev is None or ev.status == "pending":
            return False
    return True


def server_digest(server):
    """(digest, scores) of what a server committed."""
    scores = []
    allocs = []
    for a in server.state.allocs():
        if a.terminal_status():
            continue
        ar = a.allocated_resources
        allocs.append((a.name, a.node_id, a.job_id, a.task_group,
                       _task_digest(ar.tasks), _shared_digest(ar.shared)))
        s = a.metrics.scores.get(f"{a.node_id}.normalized-score")
        if s is not None:
            scores.append(((a.name, a.node_id), float(s)))
    evals = sorted(
        (e.job_id, e.type, e.triggered_by, e.status,
         tuple(sorted(e.queued_allocations.items())),
         tuple(sorted(e.failed_tg_allocs)), bool(e.blocked_eval))
        for e in server.state.evals())
    blocked = server.blocked_evals.stats()
    return dict(allocs=sorted(allocs), evals=evals,
                blocked=(blocked["total_blocked"],
                         blocked["total_escaped"]),
                rejected=server.planner.plans_rejected), sorted(scores)


def assert_same(ref, port):
    want, want_scores = server_digest(ref)
    got, got_scores = server_digest(port)
    for key in want:
        assert got[key] == want[key], key
    assert [k for k, _ in got_scores] == [k for k, _ in want_scores]
    np.testing.assert_allclose([v for _, v in got_scores],
                               [v for _, v in want_scores], rtol=1e-12)
    return got


class _Gate:
    """One barrier's view for InOrderLanes: ``order`` is its batch's
    eval ids in dequeue order."""

    def __init__(self, order, local, barrier):
        self.barrier, self.local = barrier, local
        self.turn = {e: k for k, e in enumerate(order)}
        self.lane_of = {}
        self.left, self.submitted = set(), set()
        done = barrier.done

        def gated_done():
            self.left.add(local.eval_id)
            done()
        barrier.done = gated_done

    def __getattr__(self, name):
        return getattr(self.barrier, name)

    def _wait(self, ready, what):
        k = self.turn.get(getattr(self.local, "eval_id", None))
        if k is None:
            return
        ahead = [e for e, j in self.turn.items() if j < k]
        wait_until(lambda: all(ready(e) for e in ahead), msg=what)

    def _queued(self, e):
        if e in self.left:
            return True
        lane = self.lane_of.get(e)
        with self.barrier._cv:
            return any(q is lane for q, _ in self.barrier._waiting)

    def solve(self, lane):
        self._wait(self._queued, "the lanes ahead")
        self.lane_of[self.local.eval_id] = lane
        return self.barrier.solve(lane)


class InOrderLanes:
    """Each batch's lanes reach its barrier (SolveBarrier or LpqBarrier)
    in the batch's dequeue order, in both packages: a lane waits until
    every eval ahead of it in the batch has its lane queued at the
    barrier or has left it. With ``plans`` the evals' first plans also
    reach the applier in that order (every eval ahead has had its plan
    applied, or has left): for batches of one generation only, as an
    eval held at its submission reaches no later generation. Installed
    on the modules here; ``attach`` each server before it starts, as a
    worker binds its hook when it enters a dequeue."""

    def __init__(self, monkeypatch, plans=False):
        self.local = threading.local()
        self.gate_of = {}
        for pkg, wmod, bmod, lmod in (
                ("ref", ref_worker, ref_batch, ref_lpq),
                ("port", port_worker, batch, lpq)):
            monkeypatch.setattr(wmod, "invoke_scheduler",
                                self._invoke(wmod.invoke_scheduler))
            monkeypatch.setattr(bmod, "make_solve_hook",
                                self._make(bmod.make_solve_hook, pkg))
            monkeypatch.setattr(lmod, "make_lpq_hook",
                                self._make(lmod.make_lpq_hook, pkg))
            # no straggler dispatch of a part of a generation
            monkeypatch.setattr(bmod, "BARRIER_TIMEOUT_S", 120.0)
            monkeypatch.setattr(lmod, "LPQ_BARRIER_TIMEOUT_S", 120.0)
            if plans:
                monkeypatch.setattr(
                    wmod.WorkerPlanner, "submit_plan",
                    self._submit(wmod.WorkerPlanner.submit_plan, pkg))

    def attach(self, server):
        """Record, on the worker's thread, each batch it dequeues."""
        broker = server.broker
        for name in ("dequeue_batch", "dequeue_lpq"):
            def run(*a, _fn=getattr(broker, name), **kw):
                got = _fn(*a, **kw)
                self.local.batch = [ev.id for ev, _ in got or ()]
                return got
            setattr(broker, name, run)
        return server

    def _invoke(self, fn):
        def run(server, ev, *a, **kw):
            self.local.eval_id = ev.id
            return fn(server, ev, *a, **kw)
        return run

    def _make(self, make, pkg):
        def make_hook(barrier):
            gate = _Gate(getattr(self.local, "batch", []), self.local,
                         barrier)
            for e in gate.turn:
                self.gate_of[pkg, e] = gate
            return make(gate)
        return make_hook

    def _submit(self, fn, pkg):
        route = self

        def run(planner, plan):
            gate = route.gate_of.get(
                (pkg, getattr(route.local, "eval_id", None)))
            if gate is None:
                return fn(planner, plan)
            gate._wait(lambda e: e in gate.submitted or e in gate.left,
                       "the plans ahead")
            try:
                return fn(planner, plan)
            finally:
                gate.submitted.add(route.local.eval_id)
        return run


@contextlib.contextmanager
def server_pair(ref_store, order=None, **server_kw):
    """A reference Server started on ``ref_store`` and a port Server on a
    carried copy, at the same index; (ref, port, memo), both shut down
    on exit. ``order``: an InOrderLanes both are attached to."""
    kw = dict(num_workers=WIDTH, eval_batching=True, batch_width=WIDTH)
    kw.update(server_kw)
    ref = RefServer(state=ref_store, heartbeat_ttl=3600.0, **kw)
    port = None
    try:
        if order is not None:
            order.attach(ref)
        ref.start()
        memo = {}
        port = Server(state=store_from_reference(ref_store.snapshot(), memo),
                      device="cpu", heartbeat_ttl=3600.0, **kw)
        if order is not None:
            order.attach(port)
        port.start()
        assert port.state.latest_index() == ref_store.latest_index()
        yield ref, port, memo
    finally:
        ref.shutdown()
        if port is not None:
            port.shutdown()


def settle_both(ref, port, ids):
    for server in (ref, port):
        wait_until(lambda s=server: settled(s, ids), msg="settled")
    # a blocked eval's sweep and a follow-up's broker write land last
    time.sleep(0.2)
    for server in (ref, port):
        wait_until(lambda s=server: settled(s, ids), msg="settled")


def enqueue_both(ref, port, evals, memo):
    """``evals`` (reference structs) written and enqueued in one call in
    each server; the port's carried."""
    pevals = [struct_from_reference(ev, memo) for ev in evals]
    for server, evs in ((ref, evals), (port, pevals)):
        server.state.upsert_evals(evs)
        server.broker.enqueue_all(evs)


def run_servers(ref_store, evals, order=None, **server_kw):
    """Start a reference Server on ``ref_store``, carry the store to a
    port Server, enqueue ``evals`` in both and wait until both settle.
    Returns the two servers (shut down)."""
    with server_pair(ref_store, order, **server_kw) as (ref, port, memo):
        enqueue_both(ref, port, evals, memo)
        settle_both(ref, port, [ev.id for ev in evals])
    return ref, port


# --------------------------------------------------------------------------
# the worlds of tests/test_solver_parity.py

def _algs(name):
    w = PARITY_WORLDS[name]
    return (w[5], w[6]) if len(w) > 5 else ("binpack", "tpu-binpack")


SERVER_PARITY_CASES = [(name, list(w[2])[0]) for name, w in
                       PARITY_WORLDS.items()]


@pytest.mark.parametrize("name,seed", SERVER_PARITY_CASES,
                         ids=[f"{n}-{s}" for n, s in SERVER_PARITY_CASES])
def test_parity_world_through_both_servers(name, seed):
    _, tpu_alg = _algs(name)
    store, ev = parity_world(name, seed, tpu_alg)
    ref, port = run_servers(store, [ev])
    got = assert_same(ref, port)
    assert got["allocs"], "no placements -- bad world"
    assert all(e[3] != "failed" for e in got["evals"])


@pytest.mark.parametrize("name", ["basic_service", "with_spread_block",
                                  "sticky_limit_two_tgs"])
def test_parity_world_through_plain_workers(name):
    """eval_batching=False: plain Workers, one eval at a time and no
    barrier, the same committed state in both."""
    _, tpu_alg = _algs(name)
    store, ev = parity_world(name, list(PARITY_WORLDS[name][2])[0],
                             tpu_alg)
    ref, port = run_servers(store, [ev], num_workers=2,
                            eval_batching=False)
    assert not any(t.name.startswith("batch-worker-")
                   for t in port.workers)
    assert assert_same(ref, port)["allocs"]


@pytest.mark.parametrize("name,seed", [("basic_service", 1),
                                       ("with_ports", 402),
                                       ("distinct_hosts", 77)])
def test_host_algorithm_world_through_both_servers(name, seed):
    host_alg, _ = _algs(name)
    store, ev = parity_world(name, seed, host_alg)
    ref, port = run_servers(store, [ev])
    assert assert_same(ref, port)["allocs"]


# --------------------------------------------------------------------------
# tests/test_parity_scale.py tiers, tests/test_system_tpu.py

TIERS = [(1, 5, 3, 0), (2, 40, 30, 1), (3, 40, 30, 100), (4, 40, 30, 201),
         (5, 24, 12, 42)]


@pytest.mark.parametrize("tier,n_nodes,count,seed", TIERS)
def test_tier_world_through_both_servers(tier, n_nodes, count, seed):
    store, ev, _ = tier_world(tier, n_nodes, count, seed, "tpu-binpack")
    ref, port = run_servers(store, [ev])
    assert assert_same(ref, port)["allocs"]


@pytest.mark.parametrize("seed,ports", [(0, False), (77, True)])
@pytest.mark.parametrize("alg", ["tpu-binpack", "binpack"])
def test_system_world_through_both_servers(seed, ports, alg):
    store, ev = system_world(seed, ports, alg)
    ref, port = run_servers(store, [ev])
    got = assert_same(ref, port)
    nodes = [a[1] for a in got["allocs"] if a[2] == "sys-parity"]
    assert nodes and len(nodes) == len(set(nodes))


# --------------------------------------------------------------------------
# the LP tier's server worlds (tests/test_lpq.py:165, :229)

def lpq_world(n_nodes, cpu, mem, n_jobs, per_eval, tag):
    ref_reseed_ids(len(tag))
    mock._counter = itertools.count()
    store = RefStateStore()
    store.set_scheduler_config(SchedulerConfiguration(
        scheduler_algorithm="tpu-lpq"))
    for i in range(n_nodes):
        n = mock.node()
        n.id = f"{tag}-node-{i:04d}"
        n.node_resources.cpu.cpu_shares = cpu
        n.node_resources.memory.memory_mb = mem
        n.compute_class()
        store.upsert_node(n)
    evals = []
    for i in range(n_jobs):
        job = mock.job(id=f"{tag}-{i}")
        job.task_groups[0].count = per_eval
        store.upsert_job(job)
        evals.append(Evaluation(
            id=f"{tag}-eval-{i:04d}", namespace=job.namespace,
            priority=job.priority, type=job.type,
            triggered_by="job-register", job_id=job.id, status="pending"))
    return store, evals


@pytest.mark.parametrize("world", [(8, 4000, 8192, 4, 3, "lpq-e2e"),
                                   (2, 2200, 4096, 6, 2, "lpq-press")])
def test_lpq_world_through_both_servers(world, monkeypatch):
    """Every eval in one LP generation at the natural batch width, its
    lanes in the batch's order in both: equal placements, blocked evals
    for what did not fit, and no capacity violated."""
    n_nodes, cpu, mem = world[:3]
    store, evals = lpq_world(*world)
    ref, port = run_servers(store, evals, InOrderLanes(monkeypatch))
    got = assert_same(ref, port)
    by_node = {}
    for a in port.state.allocs():
        if not a.terminal_status():
            cr = a.allocated_resources.comparable()
            e = by_node.setdefault(a.node_id, [0, 0])
            e[0] += cr.cpu_shares
            e[1] += cr.memory_mb
    assert all(c <= cpu and m <= mem for c, m in by_node.values())
    assert got["allocs"]
    if world[-1] == "lpq-press":
        assert len(got["allocs"]) == 8
        assert any(e[3] == "blocked" for e in got["evals"])


def test_lpq_preemption_world_through_both_servers(monkeypatch):
    """tests/test_lpq.py's preemption world: a priority-70 job evicts
    through the LP tier's repair pass, the same allocs in both."""
    ref_reseed_ids(7)
    store = RefStateStore()
    store.set_scheduler_config(SchedulerConfiguration(
        scheduler_algorithm="tpu-lpq", preemption_config=PreemptionConfig(
            service_scheduler_enabled=True)))
    node = mock.node()
    node.id = "preempt-0000"
    node.compute_class()
    store.upsert_node(node)
    lows = []
    for i in range(2):
        j = mock.job(id=f"low-{i}", priority=20)
        j.task_groups[0].tasks[0].resources.cpu = 1800
        j.task_groups[0].tasks[0].resources.memory_mb = 512
        store.upsert_job(j)
        a = mock.alloc_for(j, node, i)
        a.client_status = ALLOC_CLIENT_RUNNING
        lows.append(a)
    store.upsert_allocs(lows)
    high = mock.job(id="lpq-high", priority=70)
    high.task_groups[0].count = 1
    high.task_groups[0].tasks[0].resources.cpu = 2000
    store.upsert_job(high)
    ev = Evaluation(id="lpq-high-eval-0001", namespace=high.namespace,
                    priority=high.priority, type=high.type,
                    triggered_by="job-register", job_id=high.id,
                    status="pending")
    ref, port = run_servers(store, [ev])
    got = assert_same(ref, port)
    evicted = sorted(a.id for a in port.state.allocs()
                     if a.desired_status == "evict")
    assert evicted and evicted == sorted(
        a.id for a in ref.state.allocs() if a.desired_status == "evict")
    assert any(a[2] == "lpq-high" for a in got["allocs"])


# --------------------------------------------------------------------------
# register, deregister and the worker pool without batching

def test_register_and_deregister_through_both_servers():
    """register_job (validation, admission with a connect sidecar) then
    deregister_job: the sidecar's ask is placed, then every alloc stops,
    the same in both; plain Workers (no batching)."""
    ref_reseed_ids(5)
    store = RefStateStore()
    store.set_scheduler_config(SchedulerConfiguration(
        scheduler_algorithm="tpu-binpack"))
    for i in range(4):
        n = mock.node()
        n.id = f"reg-node-{i:04d}"
        n.attributes["driver.raw_exec"] = "1"     # the sidecar's driver
        n.compute_class()
        store.upsert_node(n)
    kw = dict(num_workers=2, eval_batching=False)
    ref = RefServer(state=store, heartbeat_ttl=3600.0, **kw)
    ref.start()
    port = Server(state=store_from_reference(store.snapshot()),
                  device="cpu", heartbeat_ttl=3600.0, **kw)
    port.start()
    try:
        from nomad_tpu.structs import Service as RefService
        # both id streams alike: the evals' ids (the shuffle's seed) agree
        for server, svc_cls, job_mod, reseed in (
                (ref, RefService, mock, ref_reseed_ids),
                (port, pst.Service, pmock, pst.reseed_ids)):
            reseed(55)
            job = job_mod.job(id="reg-job")
            job.task_groups[0].count = 3
            job.task_groups[0].services = [svc_cls(
                name="web", port_label="http",
                connect={"sidecar_service": {}})]
            ev = server.register_job(job)
            wait_until(lambda s=server, e=ev: settled(s, [e.id]),
                       msg="registered")
            tasks = [t.name for t in server.state.job_by_id(
                "default", "reg-job").task_groups[0].tasks]
            assert "connect-proxy-web" in tasks
        assert_same(ref, port)
        assert len([a for a in port.state.allocs()
                    if not a.terminal_status()]) == 3
        for server, reseed in ((ref, ref_reseed_ids),
                               (port, pst.reseed_ids)):
            reseed(56)
            ev = server.deregister_job("default", "reg-job")
            wait_until(lambda s=server, e=ev: settled(s, [e.id]),
                       msg="deregistered")
        got = assert_same(ref, port)
        assert not got["allocs"]
        assert port.state.job_by_id("default", "reg-job").stop
    finally:
        ref.shutdown()
        port.shutdown()


def test_validation_rejects_what_the_reference_rejects():
    """_validate_job: the same refusals, nothing written."""
    port = Server(device="cpu", heartbeat_ttl=3600.0)
    ref = RefServer(heartbeat_ttl=3600.0)
    try:
        def bad_jobs(m, st):
            out = []
            j = m.job(id="bad-ns")
            j.namespace = "nope"
            out.append(j)
            j = m.job(id="bad-pool")
            j.node_pool = "all"
            out.append(j)
            j = m.job(id="bad-pool-2")
            j.node_pool = "missing"
            out.append(j)
            j = m.job(id="bad-nets")
            j.task_groups[0].networks = [st.NetworkResource(),
                                         st.NetworkResource()]
            out.append(j)
            j = m.job(id="bad-scaling")
            j.task_groups[0].scaling = {"min": 3, "max": 1}
            out.append(j)
            return out

        from nomad_tpu import structs as rst
        want = []
        for j in bad_jobs(mock, rst):
            with pytest.raises(ValueError) as e:
                ref.register_job(j)
            want.append(str(e.value))
        got = []
        for j in bad_jobs(pmock, pst):
            with pytest.raises(ValueError) as e:
                port.register_job(j)
            got.append(str(e.value))
        assert got == want
        assert not port.state.jobs() and not port.state.evals()
    finally:
        ref.shutdown()
        port.shutdown()


def test_blocked_eval_unblocks_on_new_node():
    """tests/test_server_e2e.py:155: a job larger than the fleet places
    what fits and blocks; a registered node releases the blocked eval
    and the rest is placed -- the same allocs in both, no node over
    capacity."""
    ref_reseed_ids(11)
    store = RefStateStore()
    store.set_scheduler_config(SchedulerConfiguration(
        scheduler_algorithm="tpu-binpack"))
    for i in range(3):
        n = mock.node()
        n.id = f"blk-node-{i:04d}"
        n.compute_class()
        store.upsert_node(n)
    job = mock.job(id="blk-job")
    job.task_groups[0].count = 4
    job.task_groups[0].tasks[0].resources.cpu = 3500
    store.upsert_job(job)
    ev = Evaluation(id="blk-eval-0001", namespace=job.namespace,
                    priority=job.priority, type=job.type,
                    triggered_by="job-register", job_id=job.id,
                    status="pending")
    kw = dict(num_workers=WIDTH, eval_batching=True, batch_width=WIDTH)
    ref = RefServer(state=store, heartbeat_ttl=3600.0, **kw)
    ref.start()
    memo = {}
    port = Server(state=store_from_reference(store.snapshot(), memo),
                  device="cpu", heartbeat_ttl=3600.0, **kw)
    port.start()
    try:
        pev = struct_from_reference(ev, memo)
        for server, e in ((ref, ev), (port, pev)):
            server.state.upsert_evals([e])
            server.broker.enqueue_all([e])
            wait_until(lambda s=server: settled(s, [ev.id])
                       and s.blocked_evals.stats()["total_blocked"] == 1,
                       msg="3 of 4 placed, one blocked")
        got = assert_same(ref, port)
        assert len(got["allocs"]) == 3
        for server, m in ((ref, mock), (port, pmock)):
            extra = m.node()
            extra.id = "blk-node-extra"
            extra.compute_class()
            server.register_node(extra)
            wait_until(lambda s=server: len(
                [a for a in s.state.allocs_by_job("default", "blk-job")
                 if not a.terminal_status()]) == 4
                and s.blocked_evals.stats()["total_blocked"] == 0
                and s.broker.stats()["total_unacked"] == 0,
                msg="the 4th placed on the new node")
        got = assert_same(ref, port)
        assert sum(1 for a in got["allocs"]
                   if a[1] == "blk-node-extra") == 1
        for nid in {a[1] for a in got["allocs"]}:
            used = sum(a.allocated_resources.comparable().cpu_shares
                       for a in port.state.allocs_by_node(nid)
                       if not a.terminal_status())
            assert used <= port.state.node_by_id(
                nid).node_resources.cpu.cpu_shares
    finally:
        ref.shutdown()
        port.shutdown()
