"""The port's BatchWorker and Server (server/worker.py, server/core.py)
on the scenarios of tests/test_batch_worker.py and tests/test_server_e2e.py,
each run through both packages' servers on the CPU.

Each world is built with the reference's mock and store, a reference
Server starts on it and a port Server on a carried copy, at the same
index (test_torch_server.server_pair); the evals, with fixed ids, are
written and enqueued in one call in each, so one batch worker dequeues
all of them into one barrier. InOrderLanes hands a batch's lanes to the
barrier in the batch's order in both packages, so the cross-lane
fixpoint, which breaks ties in arrival order, settles a fused generation
the same way in both, and the committed state compares exactly: every
live alloc (name -> node, its resources; float64 normalized scores, rtol
1e-12), the eval statuses, the blocked evals and the applier's
rejections. Each scenario's own assertions hold for the port too (fused
lanes, one winner and one blocked loser, a two-group job sequenced
within its batch, the fixpoint avoiding an applier retry). The
server's leadership, its LP-tier switch and its fault points are checked
on the port alone. Every wait has a deadline, and every server is shut
down.
"""
import copy
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.server import Server as RefServer
from nomad_tpu.solver import guard as ref_guard
from nomad_tpu.state import StateStore as RefStateStore
from nomad_tpu.structs.job import reseed_ids as ref_reseed_ids
from nomad_tpu.tensor import pack as ref_pack

from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.faultinject import faults
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.solver import batch, guard, lpq
from nomad_tpu_torch.tensor import pack as port_pack

from test_torch_server import (
    InOrderLanes, assert_same, enqueue_both, server_pair, settle_both)

torch.set_num_threads(1)

SERVER_THREADS = ("batch-worker-", "scheduler-worker-", "batch-eval-",
                  "lpq-eval-", "plan-", "eval-broker-")

PORT = SimpleNamespace(
    mock=port_mock, st=port_structs,
    server=lambda **kw: Server(device="cpu", **kw))


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    monkeypatch.setattr(RefServer, "_start_background", lambda self: None)
    ref_pack._reset_pack_caches_for_tests()
    port_pack.reset_pack_caches()
    guard._reset_for_tests()
    ref_guard._reset_for_tests()
    lpq._reset_for_tests()
    # threads an earlier test file left behind are not this test's
    before = set(threading.enumerate())
    yield
    faults.disarm_all()
    guard._reset_for_tests()
    ref_guard._reset_for_tests()
    live = [t.name for t in threading.enumerate()
            if t.is_alive() and t not in before
            and t.name.startswith(SERVER_THREADS)]
    assert not live, live


def wait_until(cond, timeout=30.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timeout waiting for {msg}")


def make_server(P, n_nodes=6, width=4, cpu=4000, mem=8192, alg="tpu-binpack"):
    """A started port Server (the checks on the port alone) with
    ``n_nodes`` registered nodes."""
    server = P.server(num_workers=width, eval_batching=True)
    server.state.set_scheduler_config(P.st.SchedulerConfiguration(
        scheduler_algorithm=alg))
    server.start()
    nodes = []
    for i in range(n_nodes):
        n = P.mock.node()
        n.id = f"batch-node-{i:04d}"
        n.node_resources.cpu.cpu_shares = cpu
        n.node_resources.memory.memory_mb = mem
        n.compute_class()
        nodes.append(n)
        server.register_node(n)
    return server, nodes


def ref_world(n_nodes, cpu, mem, seed, spare=False):
    """A reference store of ``n_nodes`` nodes of ``cpu`` / ``mem`` (plus a
    4000 / 8192 spare), tpu-binpack."""
    ref_reseed_ids(seed)
    store = RefStateStore()
    store.set_scheduler_config(ref_structs.SchedulerConfiguration(
        scheduler_algorithm="tpu-binpack"))
    shapes = [(f"batch-node-{i:04d}", cpu, mem) for i in range(n_nodes)]
    if spare:
        shapes.append(("batch-node-spare", 4000, 8192))
    for nid, c, m in shapes:
        n = ref_mock.node()
        n.id = nid
        n.node_resources.cpu.cpu_shares = c
        n.node_resources.memory.memory_mb = m
        n.compute_class()
        store.upsert_node(n)
    return store


def ref_evals(store, jobs):
    """The jobs written to the reference store; their evals (fixed ids)."""
    evs = []
    for i, job in enumerate(jobs):
        store.upsert_job(job)
        evs.append(ref_structs.Evaluation(
            id=f"{job.id}-eval-{i:04d}", namespace=job.namespace,
            priority=job.priority, type=job.type,
            triggered_by="job-register", job_id=job.id, status="pending"))
    return evs


def count_jobs(count, *names):
    jobs = []
    for name in names:
        job = ref_mock.job(id=name)
        job.task_groups[0].count = count
        jobs.append(job)
    return jobs


def run_pair(monkeypatch, store, jobs, width, plans=False):
    """Both servers on ``store``, the jobs' evals enqueued atomically in
    each, lanes (and, with ``plans``, plans) in batch order; the
    committed state compared. Returns (ref, port), shut down."""
    order = InOrderLanes(monkeypatch, plans=plans)
    evals = ref_evals(store, jobs)
    with server_pair(store, order, num_workers=width,
                     batch_width=width) as (ref, port, memo):
        enqueue_both(ref, port, evals, memo)
        settle_both(ref, port, [ev.id for ev in evals])
    assert_same(ref, port)
    return ref, port


def committed(server, job):
    return placed(server, job.id)


def enqueue_atomically(P, server, jobs):
    """The jobs' evals written and enqueued in one call, so one batch
    worker dequeues all of them into one barrier."""
    evs = []
    for i, job in enumerate(jobs):
        server.state.upsert_job(job)
        evs.append(P.st.Evaluation(
            id=f"{job.id}-eval-{i:04d}", namespace=job.namespace,
            priority=job.priority, type=job.type,
            triggered_by="job-register", job_id=job.id, status="pending"))
    server.state.upsert_evals(evs)
    server.broker.enqueue_all(evs)
    return evs


def placed(server, job_id):
    return [a for a in server.state.allocs_by_job("default", job_id)
            if a.desired_status == "run"]


def capacity_ok(server):
    for node in server.state.nodes():
        used = [0, 0]
        for a in server.state.allocs_by_node(node.id):
            if not a.terminal_status():
                cr = a.allocated_resources.comparable()
                used[0] += cr.cpu_shares
                used[1] += cr.memory_mb
        if (used[0] > node.node_resources.cpu.cpu_shares
                or used[1] > node.node_resources.memory.memory_mb):
            return False
    return True


def statuses(server, job_ids):
    return {j: sorted(e.status for e in server.state.evals_by_job(
        "default", j)) for j in job_ids}


# --------------------------------------------------------------------------
# tests/test_batch_worker.py

def test_batched_evals_fuse_into_one_dispatch(monkeypatch):
    """Four jobs enqueued together place through one fused multi-lane
    dispatch, every alloc within capacity, the same in both."""
    lanes_seen = []
    orig = batch.fuse_and_solve

    def counted(lanes, *a, **kw):
        lanes_seen.append(len(lanes))
        return orig(lanes, *a, **kw)

    monkeypatch.setattr(batch, "fuse_and_solve", counted)
    store = ref_world(8, 4000, 8192, seed=21)
    names = [f"batch-job-{i}" for i in range(4)]
    _, port = run_pair(monkeypatch, store, count_jobs(3, *names), width=4)
    assert [len(placed(port, j)) for j in names] == [3, 3, 3, 3]
    assert capacity_ok(port)
    assert max(lanes_seen) >= 2, lanes_seen


def test_batched_conflict_resolved_by_plan_applier(monkeypatch):
    """Two evals in one batch race for the last capacity of the one node
    (room for one 500-cpu mock alloc). The barrier's fixpoint is off, so
    both plans name the node; they reach the applier in batch order,
    which commits the first and rejects the second, whose eval retries
    against the refreshed state and blocks -- the same in both."""
    for pkg in ("NOMAD_TPU", "NOMAD_TPU_TORCH"):
        monkeypatch.setenv(f"{pkg}_BATCH_FIXPOINT", "0")
    store = ref_world(1, 600, 400, seed=22)
    jobs = count_jobs(1, "conflict-a", "conflict-b")
    ref, port = run_pair(monkeypatch, store, jobs, width=4, plans=True)
    assert [len(placed(port, j.id)) for j in jobs] == [1, 0]
    assert statuses(port, ["conflict-a", "conflict-b"]) == {
        "conflict-a": ["complete"], "conflict-b": ["blocked", "complete"]}
    # the applier rejected the second plan's node once in each
    assert [s.planner.bad_nodes.score("batch-node-0000")
            for s in (ref, port)] == [1, 1]
    assert port.blocked_evals.stats()["total_blocked"] == 1
    assert capacity_ok(port)


def test_multi_tg_eval_sequences_within_batch(monkeypatch):
    """The second group's lane sees the first group's placements: two
    500-cpu allocs a 1,100-cpu node, the same in both."""
    store = ref_world(2, 1100, 4096, seed=23)
    job = ref_mock.job(id="two-tg")
    tg1 = job.task_groups[0]
    tg1.count = 2
    tg2 = copy.deepcopy(tg1)
    tg2.name = "second"
    tg2.count = 2
    job.task_groups.append(tg2)
    _, port = run_pair(monkeypatch, store, [job], width=2)
    by_node = {}
    for a in placed(port, "two-tg"):
        by_node[a.node_id] = by_node.get(a.node_id, 0) + 1
    assert sorted(by_node.values()) == [2, 2] and capacity_ok(port)


def test_cross_lane_fixpoint_avoids_applier_retry(monkeypatch):
    """Two evals of one generation collide on the tight node; the
    barrier's fixpoint moves one to the spare before submission, so the
    applier rejects nothing -- the same in both."""
    hits = []
    orig = batch._resolve_lane_conflicts

    def counted(*a, **kw):
        hits.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(batch, "_resolve_lane_conflicts", counted)
    store = ref_world(1, 600, 400, seed=24, spare=True)
    jobs = count_jobs(1, "fixpoint-a", "fixpoint-b")
    ref, port = run_pair(monkeypatch, store, jobs, width=4)
    nodes = sorted(placed(port, j.id)[0].node_id for j in jobs)
    assert nodes == ["batch-node-0000", "batch-node-spare"]
    assert port.planner.plans_rejected == ref.planner.plans_rejected == 0
    assert hits


# --------------------------------------------------------------------------
# tests/test_server_e2e.py

def test_service_job_end_to_end(monkeypatch):
    """register_job to committed allocs: the eval completes and the job
    turns running (the port has no client: allocs stay pending), the
    same in both."""
    store = ref_world(3, 4000, 8192, seed=25)
    order = InOrderLanes(monkeypatch)
    with server_pair(store, order, num_workers=2,
                     batch_width=2) as (ref, port, _):
        ids = []
        for server, m, reseed in ((ref, ref_mock, ref_reseed_ids),
                                  (port, port_mock,
                                   port_structs.reseed_ids)):
            # both id streams alike: the eval ids (the shuffle's seed)
            reseed(55)
            job = m.job(id="e2e-service")
            job.task_groups[0].count = 4
            ids.append(server.register_job(job).id)
        assert ids[0] == ids[1]
        settle_both(ref, port, ids[:1])
        for server in (ref, port):
            wait_until(lambda s=server: s.state.job_by_id(
                "default", "e2e-service").status == "running",
                msg="job running")
    got = assert_same(ref, port)
    assert len(got["allocs"]) == 4
    assert statuses(port, ["e2e-service"]) == {"e2e-service": ["complete"]}


# --------------------------------------------------------------------------
# the port's leadership, its LP tier and its fault points

def test_lp_tier_switch_restarts_leadership_with_one_worker():
    """apply_scheduler_config to tpu-lpq and a leadership restart: one
    batch worker, whose batches run through _run_lpq_batch and one
    LpqBarrier; every eval completes within capacity."""
    server, _ = make_server(PORT, n_nodes=4, width=4)
    try:
        assert len(server.workers) == 2
        server.apply_scheduler_config(PORT.st.SchedulerConfiguration(
            scheduler_algorithm="tpu-lpq"))
        server.revoke_leadership()
        server.establish_leadership()
        assert len(server.workers) == 1
        jobs = [PORT.mock.job(id=f"lp-{i}") for i in range(4)]
        for j in jobs:
            j.task_groups[0].count = 2
        evs = enqueue_atomically(PORT, server, jobs)
        wait_until(lambda: all(server.state.eval_by_id(e.id).status
                               == "complete" for e in evs),
                   msg="lp evals complete")
        assert [len(committed(server, j)) for j in jobs] == [2] * 4
        assert lpq.lpq_stats()["solves"] >= 1
        assert capacity_ok(server)
        wait_until(lambda: server.workers[0].batches_processed >= 1,
                   msg="the LP batch joined")
    finally:
        server.shutdown()


@pytest.mark.parametrize("point", ["worker.invoke", "plan.apply",
                                   "broker.dequeue"])
def test_fault_point_nacks_and_redelivers(point):
    """An armed error at the worker's invoke, the applier's submit or the
    broker's dequeue costs one delivery: the eval is nacked (or not
    leased), redelivered and placed."""
    server, _ = make_server(PORT, n_nodes=2, width=2)
    try:
        faults.arm(point, "error", count=1)
        job = PORT.mock.job(id=f"fault-{point}")
        job.task_groups[0].count = 2
        ev = server.register_job(job)
        wait_until(lambda: len(committed(server, job)) == 2
                   and server.state.eval_by_id(ev.id).status == "complete",
                   msg="placed after the fault")
    finally:
        server.shutdown()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_crash_orphans_the_batch_until_redelivery():
    """An armed worker.crash kills the batch worker after the lease: the
    eval stays leased until its nack timeout, then the other worker
    takes the redelivery and places it."""
    server, _ = make_server(PORT, n_nodes=2, width=2)
    try:
        server.broker.nack_timeout = 0.5
        faults.arm("worker.crash", "error", count=1)
        job = PORT.mock.job(id="crash-job")
        job.task_groups[0].count = 1
        ev = server.register_job(job)
        wait_until(lambda: len(committed(server, job)) == 1
                   and server.state.eval_by_id(ev.id).status == "complete",
                   msg="placed after the crash")
        assert sum(w.is_alive() for w in server.workers) == 1
    finally:
        server.shutdown()


def test_failed_dispatch_on_a_card_nacks_instead_of_placing_on_the_host(
        monkeypatch):
    """On a card a failed dispatch raises out of the eval, which is
    nacked for redelivery: no host placement. Modelled on the CPU by
    refusing host fallback for the server's cells."""
    from nomad_tpu_torch.scheduler import generic
    monkeypatch.setattr(guard, "host_fallback_allowed", lambda cells: False)
    monkeypatch.setattr(generic, "host_fallback_allowed", lambda cells: False)
    calls = []

    def boom(*a, **kw):
        calls.append(1)
        raise RuntimeError("device exploded")

    monkeypatch.setattr(batch, "fuse_and_solve", boom)
    server, _ = make_server(PORT, n_nodes=2, width=2)
    try:
        server.broker.delivery_limit = 1
        job = PORT.mock.job(id="nack-job")
        ev = server.register_job(job)
        wait_until(lambda: server.broker.stats()["total_failed"] == 1,
                   msg="the eval failed its delivery")
        assert calls and not server.state.allocs()
        assert server.state.eval_by_id(ev.id).status == "pending"
        assert guard.state()["host_fallback_dispatches"] == 0
    finally:
        server.shutdown()
