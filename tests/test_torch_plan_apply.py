"""The port's plan applier (server/plan_apply.py Planner) and its verify
fold (state/alloc_table.py) held against the JAX package's on the CPU.

Each scenario of tests/test_plan_batch.py, tests/test_plan_apply.py and
tests/test_verify_fold.py runs once through each package: the same
construction code builds the world from the package's own mock and store
(the id streams re-seeded alike, the ids the scenarios name fixed), so
both worlds are written in the same order to the same indexes, and the
same plans are submitted. What each run observes -- every plan's
``rejected_nodes``, ``alloc_index`` and ``refresh_index``, the committed
world (alloc id -> node, desired and client status, modify index), the
eval updates and the counters -- must be equal, and each scenario's own
assertions hold for the port. The fuzz holds the pre-pass against the
authoritative per-node check in both directions, with its ties kept,
and against the reference's pre-pass decision by decision.
"""
import copy
import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.faultinject import InjectedFault as RefInjectedFault
from nomad_tpu.faultinject import faults as ref_faults
from nomad_tpu.server import plan_apply as ref_plan_apply
from nomad_tpu.state import StateStore as RefStateStore
from nomad_tpu.state.alloc_table import AllocTable as RefAllocTable
from nomad_tpu.structs.job import reseed_ids as ref_reseed_ids

from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.faultinject import InjectedFault as PortInjectedFault
from nomad_tpu_torch.faultinject import faults as port_faults
from nomad_tpu_torch.server import plan_apply as port_plan_apply
from nomad_tpu_torch.state.alloc_table import AllocTable as PortAllocTable
from nomad_tpu_torch.state.store import StateStore as PortStateStore

REF = SimpleNamespace(
    mock=ref_mock, st=ref_structs, pa=ref_plan_apply, Store=RefStateStore,
    Table=RefAllocTable, faults=ref_faults, Injected=RefInjectedFault,
    reseed=ref_reseed_ids)
PORT = SimpleNamespace(
    mock=port_mock, st=port_structs, pa=port_plan_apply,
    Store=PortStateStore, Table=PortAllocTable, faults=port_faults,
    Injected=PortInjectedFault, reseed=port_structs.reseed_ids)
SEED = 1414


@pytest.fixture(autouse=True)
def _reference_python_prepass(monkeypatch):
    """The reference verifies through its Python pre-pass, the one the
    port keeps (its native pre-pass is decision-identical to it)."""
    monkeypatch.setenv("NOMAD_TPU_NATIVE_CP", "0")
    yield
    ref_faults.disarm_all()
    port_faults.disarm_all()


def setenv(monkeypatch, name, value):
    """A knob in both packages' spelling."""
    monkeypatch.setenv(f"NOMAD_TPU_{name}", value)
    monkeypatch.setenv(f"NOMAD_TPU_TORCH_{name}", value)


def both(scenario, *args):
    """Run ``scenario(P, *args)`` for each package; the observations must
    be equal. Returns the port's."""
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


# --------------------------------------------------------------------------
# worlds (tests/test_plan_batch.py, tests/test_plan_apply.py)

def make_world(P, n_nodes=8, prefix="pb-node", store=None):
    P.reseed(SEED)
    store = store if store is not None else P.Store()
    nodes = []
    for i in range(n_nodes):
        node = P.mock.node()
        node.id = f"{prefix}-{i:04d}"
        node.compute_class()
        store.upsert_node(node)
        nodes.append(node)
    return store, nodes


def cpu_alloc(P, node, job, cpu=100, aid=None):
    st = P.st
    return st.Allocation(
        id=aid or st.generate_uuid(), name=f"{job.id}.web[0]",
        job_id=job.id, job=job, task_group="web", node_id=node.id,
        allocated_resources=st.AllocatedResources(
            tasks={"web": st.AllocatedTaskResources(cpu_shares=cpu,
                                                    memory_mb=64)},
            shared=st.AllocatedSharedResources(disk_mb=10)))


def plan_on(P, nodes, k, priority=50, prefix="pb"):
    """One plan placing one alloc on each node, with fixed alloc ids."""
    job = P.mock.job(id=f"{prefix}-job-{k}")
    plan = P.st.Plan(eval_id=f"{prefix}-eval-{k:016d}"[-36:],
                     priority=priority, job=job)
    for j, node in enumerate(nodes):
        plan.append_alloc(cpu_alloc(
            P, node, job, aid=f"{prefix}-{k}-{j}-{'0' * 24}"[:36]))
    return plan


def submit_group(planner, plans, evals=None, workers=None):
    """Submit plans concurrently after a group hint, as a fused barrier
    generation does, staggered on the queue's seq so the drain order is
    the list's. Returns (results, errors) by plan index."""
    results = [None] * len(plans)
    errors = [None] * len(plans)
    planner.expect_plans(len(plans))

    def run(i):
        try:
            kw = {} if workers is None else {"worker": workers[i]}
            results[i] = planner.apply(
                plans[i], [evals[i]] if evals else None, **kw)
        except BaseException as e:  # noqa: BLE001 -- compared below
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(plans))]
    for i, t in enumerate(threads):
        t.start()
        deadline = time.time() + 5
        while time.time() < deadline:
            with planner._cv:
                if planner._seq >= i + 1:
                    break
            time.sleep(0.001)
    for t in threads:
        t.join(20)
    assert not any(t.is_alive() for t in threads)
    return results, errors


def world_state(store):
    return sorted((a.id, a.node_id, a.desired_status, a.client_status,
                   a.modify_index) for a in store.allocs())


def result_digest(r):
    if r is None:
        return None
    return (sorted(r.rejected_nodes), r.alloc_index, r.refresh_index,
            sorted((nid, sorted(a.id for a in allocs))
                   for nid, allocs in r.node_allocation.items()))


def counters(planner):
    return (planner.plans_applied, planner.plans_rejected,
            planner.batches_committed)


# --------------------------------------------------------------------------
# tests/test_plan_batch.py

def disjoint_world(P, batch, n_plans=6):
    st = P.st
    store, nodes = make_world(P, n_nodes=2 * n_plans)
    planner = P.pa.Planner(store)
    try:
        plans = [plan_on(P, nodes[2 * k:2 * k + 2], k)
                 for k in range(n_plans)]
        evals = [st.Evaluation(id=p.eval_id, status="complete",
                               job_id=p.job.id) for p in plans]
        results, errors = submit_group(planner, plans, evals)
        assert not any(errors), errors
        for r in results:
            assert r.alloc_index > 0
            for allocs in r.node_allocation.values():
                for a in allocs:
                    assert store.alloc_by_id(a.id).modify_index \
                        == r.alloc_index
        for p in plans:
            assert store.eval_by_id(p.eval_id).status == "complete"
        return dict(world=world_state(store),
                    applied=planner.plans_applied,
                    rejected=planner.plans_rejected,
                    batched=planner.batches_committed > 0,
                    indexes=len({r.alloc_index for r in results}))
    finally:
        planner.shutdown()


def test_disjoint_batch_parity(monkeypatch):
    """Disjoint plans through the group commit and through the serial
    kill switch land the same allocs and eval updates, in each package,
    and the two packages agree."""
    setenv(monkeypatch, "PLAN_BATCH_WINDOW_MS", "500")
    setenv(monkeypatch, "PLAN_BATCH", "1")
    batched = both(disjoint_world, True)
    setenv(monkeypatch, "PLAN_BATCH", "0")
    serial = both(disjoint_world, False)
    assert [a[:4] for a in batched["world"]] == \
        [a[:4] for a in serial["world"]]
    assert batched["applied"] == serial["applied"] == 6
    assert batched["rejected"] == serial["rejected"] == 0
    assert batched["batched"] and not serial["batched"]
    assert serial["indexes"] == 6 and batched["indexes"] < 6


def batch_of_one(P):
    store, nodes = make_world(P, n_nodes=2)
    planner = P.pa.Planner(store)
    try:
        r = planner.apply(plan_on(P, nodes, 0))
        assert not r.rejected_nodes and r.alloc_index > 0
        return result_digest(r), counters(planner), world_state(store)
    finally:
        planner.shutdown()


def test_batch_of_one_is_serial(monkeypatch):
    setenv(monkeypatch, "PLAN_BATCH", "1")
    _, (applied, _, batches), _ = both(batch_of_one)
    assert applied == 1 and batches == 0


def conflict_order(P, workers=None):
    store, nodes = make_world(P, n_nodes=6)
    planner = P.pa.Planner(store)
    try:
        plans = [plan_on(P, [nodes[0], nodes[1]], 0),   # nodes 0, 1
                 plan_on(P, [nodes[1], nodes[2]], 1),   # overlaps A on 1
                 plan_on(P, [nodes[3]], 2)]             # disjoint
        results, errors = submit_group(planner, plans, workers=workers)
        assert not any(errors), errors
        ra, rb, rc = results
        assert not (ra.rejected_nodes or rb.rejected_nodes
                    or rc.rejected_nodes)
        # A committed strictly before B, which fell out of A's group
        assert ra.alloc_index < rb.alloc_index
        assert len(store.allocs()) == 5
        return ([result_digest(r) for r in results], world_state(store),
                planner._conflict_streak)
    finally:
        planner.shutdown()


def test_conflict_falls_back_to_serial_order(monkeypatch):
    setenv(monkeypatch, "PLAN_BATCH", "1")
    setenv(monkeypatch, "PLAN_BATCH_WINDOW_MS", "500")
    digests, _, _ = both(conflict_order)
    # B and C were requeued together and are disjoint: one group
    assert digests[1][1] == digests[2][1]


def test_cross_worker_conflict_serialized(monkeypatch):
    """Overlapping plans of different pool workers serialize in queue
    order and are counted; the backoff streak resets (tests/
    test_worker_pool.py)."""
    setenv(monkeypatch, "PLAN_BATCH", "1")
    setenv(monkeypatch, "PLAN_BATCH_WINDOW_MS", "500")
    workers = ["pool-worker-a", "pool-worker-b", "pool-worker-a"]
    _, _, streak = both(conflict_order, workers)
    assert streak == 0
    # the port counts the serialization where the reference's metric does
    store, nodes = make_world(PORT, n_nodes=6)
    planner = PORT.pa.Planner(store)
    try:
        plans = [plan_on(PORT, [nodes[0], nodes[1]], 0),
                 plan_on(PORT, [nodes[1], nodes[2]], 1),
                 plan_on(PORT, [nodes[3]], 2)]
        _, errors = submit_group(planner, plans, workers=workers)
        assert not any(errors)
        assert planner.cross_worker_serialized >= 1
        assert planner.batch_conflict_serialized == 0
    finally:
        planner.shutdown()


def staging_fault(P):
    store, nodes = make_world(P, n_nodes=6)
    planner = P.pa.Planner(store)
    P.faults.arm("plan.commit", "error", count=1)
    try:
        plans = [plan_on(P, [nodes[2 * k], nodes[2 * k + 1]], k)
                 for k in range(3)]
        results, errors = submit_group(planner, plans)
        injected = [i for i, e in enumerate(errors)
                    if isinstance(e, P.Injected)]
        assert len(injected) == 1, (errors, results)
        seen = {a.id for a in store.allocs()}
        landed = 0
        for r, plan in zip(results, plans):
            for allocs in plan.node_allocation.values():
                for a in allocs:
                    assert (a.id in seen) == (r is not None)
                    landed += r is not None
        assert landed == 4
        follow = planner.apply(plan_on(P, [nodes[4]], 9))
        assert not follow.rejected_nodes
        return (injected, [result_digest(r) for r in results],
                result_digest(follow), world_state(store))
    finally:
        P.faults.disarm_all()
        planner.shutdown()


def test_chaos_mid_batch_staging_fault(monkeypatch):
    """An armed plan.commit fails one plan of the group: its waiter gets
    the fault, the survivors commit exactly once, the applier goes on."""
    setenv(monkeypatch, "PLAN_BATCH", "1")
    setenv(monkeypatch, "PLAN_BATCH_WINDOW_MS", "500")
    both(staging_fault)


def exploding_store(P):
    class Exploding(P.Store):
        """The group commit raises before any write once."""

        def __init__(self):
            super().__init__()
            self.explode = 1
            self.batch_calls = 0
            self.serial_calls = 0

        def apply_plan_results_batch(self, entries):
            self.batch_calls += 1
            if self.explode > 0:
                self.explode -= 1
                raise RuntimeError("simulated batch failure")
            return super().apply_plan_results_batch(entries)

        def upsert_plan_results(self, result, eval_updates=None):
            self.serial_calls += 1
            return super().upsert_plan_results(result, eval_updates)
    return Exploding()


def transaction_split(P):
    store, nodes = make_world(P, n_nodes=6, store=exploding_store(P))
    planner = P.pa.Planner(store)
    try:
        plans = [plan_on(P, [nodes[2 * k], nodes[2 * k + 1]], k)
                 for k in range(3)]
        results, errors = submit_group(planner, plans)
        assert not any(errors), errors
        assert store.batch_calls >= 1 and store.serial_calls == 3
        assert len(store.allocs()) == 6
        return ([result_digest(r) for r in results], world_state(store),
                counters(planner))
    finally:
        planner.shutdown()


def test_chaos_batch_transaction_split(monkeypatch):
    """A whole-group failure splits to serial: every plan commits once."""
    setenv(monkeypatch, "PLAN_BATCH", "1")
    setenv(monkeypatch, "PLAN_BATCH_WINDOW_MS", "500")
    _, _, (applied, _, _) = both(transaction_split)
    assert applied == 3


def window_release(P):
    store, nodes = make_world(P, n_nodes=2)
    planner = P.pa.Planner(store)
    try:
        planner.expect_plans(100)           # only one plan comes
        t0 = time.monotonic()
        r = planner.apply(plan_on(P, nodes, 0))
        assert not r.rejected_nodes
        assert time.monotonic() - t0 < 5.0
        return result_digest(r)
    finally:
        planner.shutdown()


def test_group_window_releases_without_arrivals(monkeypatch):
    setenv(monkeypatch, "PLAN_BATCH", "1")
    setenv(monkeypatch, "PLAN_BATCH_WINDOW_MS", "50")
    both(window_release)


# --------------------------------------------------------------------------
# tests/test_plan_apply.py

def one_node_world(P, gpu=False, store=None):
    P.reseed(SEED)
    store = store if store is not None else P.Store()
    node = P.mock.gpu_node(count=2) if gpu else P.mock.node()
    node.id = "pa-node-0001"
    node.compute_class()
    store.upsert_node(node)
    return store, node


def port_alloc(P, node, port, k):
    st = P.st
    job = P.mock.job(id=f"pa-job-{k}")
    return st.Allocation(
        id=f"pa-alloc-{k:04d}", name=f"{job.id}.web[0]", job_id=job.id,
        job=job, task_group="web", node_id=node.id,
        allocated_resources=st.AllocatedResources(
            tasks={"web": st.AllocatedTaskResources(cpu_shares=100,
                                                    memory_mb=64)},
            shared=st.AllocatedSharedResources(
                disk_mb=10,
                ports=[st.AllocatedPortMapping(
                    label="http", value=port,
                    host_ip=node.node_resources.networks[0].ip)])))


def device_alloc(P, node, instance_ids, k):
    st = P.st
    job = P.mock.job(id=f"pa-job-{k}")
    dev = node.node_resources.devices[0]
    return st.Allocation(
        id=f"pa-alloc-{k:04d}", name=f"{job.id}.web[0]", job_id=job.id,
        job=job, task_group="web", node_id=node.id,
        allocated_resources=st.AllocatedResources(
            tasks={"web": st.AllocatedTaskResources(
                cpu_shares=100, memory_mb=64,
                devices=[st.AllocatedDeviceResource(
                    vendor=dev.vendor, type=dev.type, name=dev.name,
                    device_ids=list(instance_ids))])},
            shared=st.AllocatedSharedResources(disk_mb=10)))


def plan_for(P, alloc, eval_id="pa-eval-0000000000000001"):
    plan = P.st.Plan(eval_id=eval_id, priority=50, job=alloc.job)
    plan.append_alloc(alloc)
    return plan


def static_port_conflict(P):
    store, node = one_node_world(P)
    planner = P.pa.Planner(store)
    try:
        out = [planner.apply(plan_for(P, port_alloc(P, node, port, k)))
               for k, port in enumerate((8080, 8080, 9090))]
        return [result_digest(r) for r in out], world_state(store)
    finally:
        planner.shutdown()


def test_conflicting_static_port_rejected():
    digests, _ = both(static_port_conflict)
    assert digests[0][0] == [] and digests[2][0] == []
    assert digests[1][0] == ["pa-node-0001"] and digests[1][3] == []


def device_conflict(P):
    store, node = one_node_world(P, gpu=True)
    inst = node.node_resources.devices[0].instance_ids
    planner = P.pa.Planner(store)
    try:
        out = [planner.apply(plan_for(P, device_alloc(P, node, [i], k)))
               for k, i in enumerate((inst[0], inst[0], inst[1]))]
        return [result_digest(r) for r in out], world_state(store)
    finally:
        planner.shutdown()


def test_conflicting_device_instance_rejected():
    digests, _ = both(device_conflict)
    assert [d[0] for d in digests] == [[], ["pa-node-0001"], []]


def slow_store(P, delay):
    class SlowCommit(P.Store):
        """Slow, optionally failing commits, with an event timeline."""

        def __init__(self):
            super().__init__()
            self.commit_delay = delay
            self.events = []
            self.fail_next = False
            self._elock = threading.Lock()

        def record(self, name):
            with self._elock:
                self.events.append(name)

        def upsert_plan_results(self, result, eval_updates=None):
            self.record("commit-start")
            time.sleep(self.commit_delay)
            if self.fail_next:
                self.fail_next = False
                self.record("commit-fail")
                raise RuntimeError("simulated commit failure")
            index = super().upsert_plan_results(result, eval_updates)
            self.record("commit-end")
            return index
    return SlowCommit()


def pipeline_overlap(P):
    store, node = one_node_world(P, store=slow_store(P, 0.15))
    planner = P.pa.Planner(store)
    orig = planner._evaluate_plan

    def traced(snapshot, plan):
        store.record("verify-start")
        return orig(snapshot, plan)

    planner._evaluate_plan = traced
    try:
        threads = [threading.Thread(target=planner.apply, args=(plan_for(
            P, port_alloc(P, node, 8000 + i, i),
            eval_id=f"pa-eval-000000000000000{i}"),)) for i in range(3)]
        for t in threads:
            t.start()
            time.sleep(0.02)     # arrive while the first commit runs
        for t in threads:
            t.join(10)
        open_commit = overlapped = False
        for name in store.events:
            if name == "commit-start":
                open_commit = True
            elif name in ("commit-end", "commit-fail"):
                open_commit = False
            elif name == "verify-start" and open_commit:
                overlapped = True
        assert overlapped, store.events
        return sorted(a.id for a in store.allocs_by_node(node.id))
    finally:
        planner.shutdown()


def test_pipeline_overlaps_verify_with_commit():
    """verify(N+1) runs while commit(N) is in flight; all three land."""
    assert len(both(pipeline_overlap)) == 3


def reverify_after_failure(P):
    store, node = one_node_world(P, store=slow_store(P, 0.1))
    planner = P.pa.Planner(store)
    try:
        store.fail_next = True
        errors = []

        def first():
            try:
                planner.apply(plan_for(P, port_alloc(P, node, 8080, 0),
                                       eval_id="pa-eval-fail0000000001"))
            except RuntimeError as e:
                errors.append(str(e))

        t1 = threading.Thread(target=first)
        t1.start()
        deadline = time.time() + 5
        while time.time() < deadline and "commit-start" not in store.events:
            time.sleep(0.005)
        assert "commit-start" in store.events
        # the same port: rejected against the overlay, but the first
        # commit fails, so it is re-verified clean and commits
        r2 = planner.apply(plan_for(P, port_alloc(P, node, 8080, 1),
                                    eval_id="pa-eval-fail0000000002"))
        t1.join(10)
        assert errors and not r2.rejected_nodes
        return errors, result_digest(r2), world_state(store)
    finally:
        planner.shutdown()


def test_pipeline_reverifies_after_commit_failure():
    _, _, world = both(reverify_after_failure)
    assert [w[0] for w in world] == ["pa-alloc-0001"]


def test_bad_node_tracker_prunes_expired_windows():
    """(tests/test_plan_apply.py) Expired windows are swept on add() and
    score(), and stale hits never make a node bad -- in both packages."""
    def run(P):
        tr = P.pa.BadNodeTracker(threshold=3, window=0.05)
        for i in range(200):
            tr.add(f"bn-node-{i:04d}")
        out = [len(tr._hits)]
        time.sleep(0.06)
        tr.add("bn-node-fresh")
        out.append(sorted(tr._hits))
        tr2 = P.pa.BadNodeTracker(threshold=3, window=0.05)
        out += [tr2.add("bn-a"), tr2.score("bn-a")]
        time.sleep(0.06)
        out += [tr2.score("bn-a"), "bn-a" in tr2._hits]
        tr3 = P.pa.BadNodeTracker(threshold=2, window=0.05)
        out.append(tr3.add("bn-b"))
        time.sleep(0.06)
        out += [tr3.add("bn-b"), tr3.add("bn-b")]
        return out

    assert both(run) == [200, ["bn-node-fresh"], False, 1, 0, False,
                         False, False, True]


# --------------------------------------------------------------------------
# tests/test_verify_fold.py

def fold_world(P, n_nodes=16):
    store, nodes = make_world(P, n_nodes=n_nodes, prefix="vf-node")
    job = P.mock.job(id="vf-job")
    store.upsert_job(job)
    return store, nodes, job


def fold_walk(P):
    store, nodes, job = fold_world(P)
    allocs = []
    for k, status in enumerate(["pending", "running", "complete"]):
        a = P.mock.alloc_for(job, nodes[0], index=k)
        a.client_status = status
        allocs.append(a)
    stopped = P.mock.alloc_for(job, nodes[0], index=3)
    stopped.desired_status = "stop"
    allocs.append(stopped)
    store.upsert_allocs(allocs)
    c, m, d, spec, found = store.alloc_table.fold_verify(
        [nodes[0].id, nodes[1].id, "unknown-node"])
    return [x.tolist() for x in (c, m, d, spec, found)]


def test_fold_matches_python_walk_semantics():
    c, m, _, spec, found = both(fold_walk)
    assert c[0] == 2 * 500 and m[0] == 2 * 256 and c[1] == 0
    assert found[0] and not found[2] and not spec[0]


def subtract_once(P):
    store, nodes, job = fold_world(P)
    node = nodes[0]
    existing = [P.mock.alloc_for(job, node, index=k) for k in range(7)]
    store.upsert_allocs(existing)
    victim = existing[0]
    planner = P.pa.Planner(store)
    try:
        inflight = P.st.PlanResult(node_update={node.id: [victim]})
        overlay = P.pa._OverlaySnapshot(store.snapshot(), inflight)
        plan = P.st.Plan(eval_id="vf-eval-1", priority=50, job=job)
        stop = copy.copy(victim)
        stop.desired_status = "stop"
        plan.node_update[node.id] = [stop]
        for k in range(2):
            plan.append_alloc(P.mock.alloc_for(job, node, index=100 + k))
        node_ids = [node.id] + [n.id for n in nodes[1:9]]
        out = [planner._fast_check(overlay, plan, node_ids)]
        plan.append_alloc(P.mock.alloc_for(job, node, index=102))
        out.append(planner._fast_check(overlay, plan, node_ids))
        return [(sorted(r.items()), sorted(f)) for r, f in out]
    finally:
        planner.shutdown()


def test_fast_check_subtracts_each_alloc_once():
    """A victim both stopped by the plan and removed by the in-flight
    plan is subtracted once: an exact fit is proven, one more 500 is
    rejected on cpu."""
    (rej1, fit1), (rej2, _) = both(subtract_once)
    assert "vf-node-0000" not in dict(rej1) and "vf-node-0000" in fit1
    assert dict(rej2)["vf-node-0000"] == "cpu"


def inflight_until_committed(P):
    st = P.st
    store, nodes, job = fold_world(P)
    node = nodes[1]
    planner = P.pa.Planner(store)
    try:
        big = P.mock.alloc_for(job, node, index=0)
        big.allocated_resources.tasks["web"].cpu_shares = 3800
        inflight = st.PlanResult(node_allocation={node.id: [big]})
        overlay = P.pa._OverlaySnapshot(store.snapshot(), inflight)
        plan = st.Plan(eval_id="vf-eval-2", priority=50, job=job)
        plan.append_alloc(P.mock.alloc_for(job, node, index=1))
        node_ids = [node.id] + [n.id for n in nodes[2:10]]
        out = [planner._fast_check(overlay, plan, node_ids)]
        store.upsert_allocs([big])
        out.append(planner._fast_check(overlay, plan, node_ids))
        smaller = copy.copy(big)
        smaller.allocated_resources = st.AllocatedResources(
            tasks={"web": st.AllocatedTaskResources(cpu_shares=500,
                                                    memory_mb=256)},
            shared=st.AllocatedSharedResources(disk_mb=150))
        store.upsert_allocs([smaller])
        out.append(planner._fast_check(overlay, plan, node_ids))
        return [(sorted(r.items()), sorted(f)) for r, f in out]
    finally:
        planner.shutdown()


def test_fast_check_counts_inflight_until_committed():
    """In-flight placements count until their commit lands, and once
    committed they count once."""
    out = both(inflight_until_committed)
    assert dict(out[0][0])["vf-node-0001"] == "cpu"
    assert dict(out[1][0])["vf-node-0001"] == "cpu"
    assert "vf-node-0001" not in dict(out[2][0])
    assert "vf-node-0001" in out[2][1]


def committed_stop(P):
    P.reseed(SEED)
    store = P.Store()
    n = P.mock.node()
    n.id = "n-stop-live"
    n.compute_class()
    store.upsert_node(n)
    j = P.mock.job(id="stop-live-job")
    store.upsert_job(j)
    a = P.mock.alloc_for(j, n)
    a.client_status = "running"
    store.upsert_allocs([a])
    row = store.alloc_table._row_of[a.id]
    before = int(store.alloc_table.live_strict[row])
    plan = P.st.Plan(eval_id="e" * 36, priority=50, job=j)
    plan.append_stopped_alloc(a, "node drain")
    idx = store.upsert_plan_results(P.st.PlanResult(
        node_update=plan.node_update, node_allocation={},
        node_preemptions={}), [])
    return (before, int(store.alloc_table.live_strict[row]),
            store._allocs[a.id].terminal_status(), idx,
            store.alloc_table.fold_verify([n.id])[0].tolist())


def test_plan_committed_stop_refreshes_table_liveness():
    assert both(committed_stop)[:3] == (1, 0, True)


def upsert_many_vs_scalar(P, batch):
    P.reseed(SEED)
    t = P.Table()
    n = P.mock.node()
    n.id = "n-um"
    t.register_node(n)
    j = P.mock.job(id="um-job")
    allocs = []
    for k in range(40):
        a = P.mock.alloc_for(j, n)
        a.id = f"um-{k:04d}"
        if k % 5 == 0:
            a.client_status = "complete"
        if k % 3 == 0:
            a.desired_status = "stop"
        allocs.append(a)
    b = P.mock.alloc_for(j, n)
    b.id = "um-reuse"
    t.fold_verify([n.id])                   # the folds are kept from here
    if batch:
        t.upsert_many(allocs)
        t.remove("um-0007")
        t.upsert_many([b])
        t.upsert_many(allocs[:10])
    else:
        for a in allocs:
            t.upsert(a)
        t.remove("um-0007")
        t.upsert(b)
        for a in allocs[:10]:
            t.upsert(a)
    rows = sorted(t._row_of.values())
    cols = {c: getattr(t, c)[rows].tolist()
            for c in ("node_slot", "cpu", "mem", "disk", "live_strict",
                      "special")}
    return (sorted(t._row_of.items()), cols,
            [x.tolist() for x in t.fold_verify([n.id])],
            t.fold_parity_mismatch())


@pytest.mark.parametrize("batch", [False, True])
def test_upsert_many_matches_scalar_upsert(batch):
    """Batched and scalar inserts leave the same table, equal to the
    reference's columns; the kept folds equal a recount."""
    got = both(upsert_many_vs_scalar, batch)
    assert got == upsert_many_vs_scalar(PORT, not batch)
    assert got[3] == 0


def fuzz_world(P, seed):
    st = P.st
    P.reseed(SEED + seed)
    rng = random.Random(seed * 131 + 7)
    store = P.Store()
    nodes = []
    for i in range(24):
        n = P.mock.node()
        n.id = f"fz-n{i:03d}"
        n.node_resources.cpu.cpu_shares = rng.choice([1000, 2000, 4000])
        n.node_resources.memory.memory_mb = rng.choice([2048, 4096])
        n.compute_class()
        store.upsert_node(n)
        nodes.append(n)
    jobs = []
    for k in range(4):
        j = P.mock.job(id=f"fz-j{k}")
        j.task_groups[0].tasks[0].resources.cpu = rng.choice([250, 500, 900])
        store.upsert_job(j)
        jobs.append(j)
    prior = []
    for _ in range(40):
        a = P.mock.alloc_for(rng.choice(jobs), rng.choice(nodes))
        a.client_status = "running"
        prior.append(a)
    store.upsert_allocs(prior)
    stop_plan = st.Plan(eval_id="f" * 36, priority=50, job=jobs[0])
    for a in rng.sample(prior, 8):
        stop_plan.append_stopped_alloc(a, "churn")
    store.upsert_plan_results(st.PlanResult(
        node_update=stop_plan.node_update, node_allocation={},
        node_preemptions={}), [])
    plan = st.Plan(eval_id="a" * 36, priority=50, job=jobs[1])
    for _ in range(30):
        plan.append_alloc(P.mock.alloc_for(jobs[1], rng.choice(nodes)))
    return store, plan


def fuzz_decisions(P, seed):
    store, plan = fuzz_world(P, seed)
    planner = P.pa.Planner(store)
    try:
        snapshot = store.snapshot()
        node_ids = sorted(plan.node_allocation)
        fast_reject, fast_fit = planner._fast_check(snapshot, plan,
                                                    node_ids)
        assert fast_reject and fast_fit, "the fast path is vacuous"
        checks = []
        for nid in node_ids:
            ok, reason = planner._evaluate_node_plan(snapshot, plan, nid)
            if nid in fast_reject:
                assert not ok, (nid, fast_reject[nid])
            if nid in fast_fit:
                assert ok, (nid, reason)
            checks.append((nid, ok, reason))
        result = planner._evaluate_plan(snapshot, plan)
        return (sorted(fast_reject.items()), sorted(fast_fit), checks,
                sorted(result.rejected_nodes),
                sorted(result.node_allocation))
    finally:
        planner.shutdown()


@pytest.mark.parametrize("seed", range(6))
def test_fast_check_agrees_with_authoritative_check_fuzz(seed):
    """The pre-pass only rejects what the authoritative check rejects and
    only proves what it accepts, on worlds with plan-committed stops
    awaiting acks; its decisions, the authoritative checks and the
    plan's rejected nodes equal the reference's."""
    both(fuzz_decisions, seed)


def test_fold_tracks_commits_and_deletes():
    """The kept folds equal a recount after group commits, stops,
    deletes and a replace (every alloc write keeps the table in step)."""
    store, nodes = make_world(PORT, n_nodes=4)
    plans = [plan_on(PORT, nodes[k:k + 2], k) for k in range(3)]
    store.alloc_table.fold_verify([n.id for n in nodes])
    store.apply_plan_results_batch(
        [(PORT.st.PlanResult(node_allocation=dict(p.node_allocation)), None)
         for p in plans])
    stop = PORT.st.Plan(eval_id="x" * 36, job=plans[0].job)
    victim = store.allocs()[0]
    stop.append_stopped_alloc(victim, "drain")
    store.upsert_plan_results(PORT.st.PlanResult(
        node_update=stop.node_update))
    assert store.alloc_table.fold_parity_mismatch() == 0
    store.delete_allocs([store.allocs()[1].id])
    assert store.alloc_table.fold_parity_mismatch() == 0
    store.replace_allocs(store.allocs()[:2])
    assert store.alloc_table.fold_parity_mismatch() == 0
    used = store.alloc_table.fold_verify([n.id for n in nodes])[0]
    want = np.zeros(len(nodes))
    for a in store.allocs():
        if not a.terminal_status():
            want[[n.id for n in nodes].index(a.node_id)] += \
                a.allocated_resources.comparable().cpu_shares
    assert used.tolist() == want.tolist()
