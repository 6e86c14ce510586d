"""The port's host scheduler, held against the JAX package's on the CPU:
an Evaluation goes into both packages' Harness over the same world and
the committed plans, eval updates, created evals and stores compare.

The world is built once in the reference (its mock, its store), carried
to a port StateStore (carry.store_from_reference), and each package's
id stream is re-seeded alike before its run, so both mint the same
uuids. Algorithms: the host stack (binpack, spread) against the
reference's host stack; the device path (tpu-binpack, tpu-spread,
tpu-lpq) on the CPU plain versions against the reference's JAX
programs, through the port's SolveBarrier hook (a one-lane barrier per
task group, as the reference's), its LpqBarrier hook, or its solo
dispatch. System jobs run through both packages' SystemScheduler.

Tolerance: decisions exact (every alloc's id, name, node, resources,
preemptions, reschedule tracker and metrics counters; every stop; the
deployment; eval statuses, queued allocations, failed task groups and
blocked evals; the stores after the commit). Scores: float64,
assert_allclose rtol 1e-12.

The worlds are tests/test_torch_service.py's: tests/test_solver_parity.py
(every seed), tests/test_system_tpu.py, tests/test_preemption.py and the
tiers of tests/test_parity_scale.py at tens of nodes.
"""
import itertools
import random
import time

import numpy as np
import pytest
import torch

from nomad_tpu import benchkit, mock
from nomad_tpu.scheduler import Harness as RefHarness
from nomad_tpu.scheduler.factory import new_scheduler as ref_new_scheduler
from nomad_tpu.solver import batch as ref_batch
from nomad_tpu.solver import guard as ref_guard
from nomad_tpu.solver import lpq as ref_lpq
from nomad_tpu.structs import (
    DeviceRequest, Evaluation, NetworkResource, Port, PreemptionConfig,
    SchedulerConfiguration, ALLOC_CLIENT_RUNNING)
from nomad_tpu.structs.job import reseed_ids as ref_reseed_ids
from nomad_tpu.tensor import pack as ref_pack

from nomad_tpu_torch import structs as pst
from nomad_tpu_torch.carry import store_from_reference, struct_from_reference
from nomad_tpu_torch.scheduler.harness import Harness
from nomad_tpu_torch.solver import batch, guard, lpq
from nomad_tpu_torch.tensor import pack as port_pack

from test_torch_service import PARITY_WORLDS, _fill_node, _random_fleet, \
    _seed_usage

# One intra-op thread: the port's CPU tensors are small, and the test
# run already keeps one xdist worker busy per core.
torch.set_num_threads(1)

NOW = 1_760_000_000.0           # the pinned clock (reschedule times)
RUN_SEED = 4242                 # both id streams, before each run


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """Both packages' pack caches and guards start fresh, every
    reference solve runs on the single-device program, and the clock
    is pinned (the reconciler and the reschedule tracker read it)."""
    monkeypatch.setenv("NOMAD_TPU_MESH", "0")
    monkeypatch.setattr(time, "time", lambda: NOW)
    ref_pack._reset_pack_caches_for_tests()
    port_pack.reset_pack_caches()
    guard._reset_for_tests()
    ref_guard._reset_for_tests()
    lpq._reset_for_tests()
    yield
    guard._reset_for_tests()
    ref_guard._reset_for_tests()


# --------------------------------------------------------------------------
# digests

def _task_digest(tasks):
    return tuple(sorted(
        (name, tr.cpu_shares, tr.memory_mb, tr.memory_max_mb,
         tuple(tr.reserved_cores),
         tuple((d.vendor, d.type, d.name, tuple(d.device_ids))
               for d in tr.devices))
        for name, tr in (tasks or {}).items()))


def _shared_digest(shared):
    if shared is None:
        return None
    return (shared.disk_mb,
            tuple((p.label, p.value, p.to, p.host_ip) for p in shared.ports),
            tuple(n.mode for n in shared.networks))


def _metric_digest(m, scores, tag):
    """The counters of an AllocMetric; its scores go to ``scores``."""
    for k in sorted(m.scores):
        scores.append((tag, k, float(m.scores[k])))
    return (m.nodes_evaluated, m.nodes_filtered, m.nodes_in_pool,
            m.nodes_exhausted, m.coalesced_failures,
            tuple(sorted(m.class_filtered.items())),
            tuple(sorted(m.constraint_filtered.items())),
            tuple(sorted(m.class_exhausted.items())),
            tuple(sorted(m.dimension_exhausted.items())))


def _alloc_digest(a, scores):
    tracker = None
    if a.reschedule_tracker is not None:
        tracker = tuple((e.reschedule_time, e.prev_alloc_id, e.prev_node_id)
                        for e in a.reschedule_tracker.events)
    ar = a.allocated_resources
    return (a.id, a.name, a.node_id, a.node_name, a.namespace, a.job_id,
            a.task_group, a.eval_id, a.job_version, a.deployment_id,
            a.desired_status, a.client_status, a.previous_allocation,
            bool(a.deployment_status is not None
                 and a.deployment_status.canary),
            tracker, _task_digest(ar.tasks), _shared_digest(ar.shared),
            _metric_digest(a.metrics, scores, a.id))


def _stub_digest(a):
    return (a.id, a.node_id, a.job_id, a.task_group, a.desired_status,
            a.desired_description, a.client_status, a.followup_eval_id,
            a.preempted_by_allocation)


def _deployment_digest(d):
    if d is None:
        return None
    return (d.id, d.namespace, d.job_id, d.job_version, d.status,
            d.status_description, d.eval_priority,
            tuple(sorted((k, st.desired_total, st.desired_canaries,
                          st.auto_revert, st.auto_promote, st.promoted)
                         for k, st in d.task_groups.items())))


def _eval_digest(ev, scores):
    return (ev.id, ev.job_id, ev.type, ev.priority, ev.triggered_by,
            ev.status, ev.status_description, ev.blocked_eval,
            ev.previous_eval, ev.wait_until,
            tuple(sorted(ev.queued_allocations.items())),
            tuple(sorted((k, _metric_digest(m, scores, f"failed {k}"))
                         for k, m in ev.failed_tg_allocs.items())),
            tuple(sorted(ev.class_eligibility.items())),
            ev.escaped_computed_class)


def harness_digest(h):
    """(digest, scores) of everything a Harness run produced: its plans
    (placements in plan order, stops, preemptions, deployment and its
    updates), eval updates, created and reblocked evals, and the store
    after the commits."""
    scores = []
    plans = []
    for plan in h.plans:
        plans.append((
            plan.eval_id, plan.priority, plan.all_at_once,
            tuple((nid, tuple(_alloc_digest(a, scores) for a in allocs))
                  for nid, allocs in plan.node_allocation.items()),
            tuple((nid, tuple(_stub_digest(a) for a in allocs))
                  for nid, allocs in plan.node_update.items()),
            tuple((nid, tuple(_stub_digest(a) for a in allocs))
                  for nid, allocs in plan.node_preemptions.items()),
            _deployment_digest(plan.deployment),
            tuple((u.deployment_id, u.status, u.status_description)
                  for u in plan.deployment_updates)))
    st = h.state
    store = (st.latest_index(),
             tuple(sorted((a.id, a.node_id, a.name, a.desired_status,
                           a.client_status, a.modify_index,
                           a.followup_eval_id) for a in st.allocs())),
             tuple(sorted((e.id, e.status, e.modify_index)
                          for e in st.evals())),
             tuple(sorted(_deployment_digest(st.deployment_by_id(d.id))
                          + (st.deployment_by_id(d.id).modify_index,)
                          for d in _deployments(st))))
    return dict(
        plans=plans,
        evals=[_eval_digest(e, scores) for e in h.evals],
        created=[_eval_digest(e, scores) for e in h.create_evals],
        reblocked=[e.id for e in h.reblock_evals],
        store=store), scores


def _deployments(store):
    snap = store.snapshot()
    return snap.deployments()


def assert_same_runs(ref_h, port_h):
    want, want_scores = harness_digest(ref_h)
    got, got_scores = harness_digest(port_h)
    for key in want:
        assert got[key] == want[key], key
    assert [s[:2] for s in got_scores] == [s[:2] for s in want_scores]
    np.testing.assert_allclose([s[2] for s in got_scores],
                               [s[2] for s in want_scores], rtol=1e-12)


def placements(h):
    """alloc name -> node id over the Harness's plans."""
    return {a.name: nid for plan in h.plans
            for nid, allocs in plan.node_allocation.items() for a in allocs}


def placed_nodes(h):
    """The node of every alloc the Harness's plans place, sorted."""
    return sorted(nid for plan in h.plans
                  for nid, allocs in plan.node_allocation.items()
                  for _ in allocs)


# --------------------------------------------------------------------------
# running one eval through both packages

class Route:
    """How each package solves a tpu-* task group: ``solo`` (the
    service's own dispatch), ``barrier`` (a one-lane SolveBarrier hook
    per task group) or ``lpq`` (a one-lane LpqBarrier hook)."""

    def __init__(self, kind: str):
        self.kind = kind
        self.port_solves = 0        # the port hook's task groups

    def ref_kw(self):
        if self.kind == "barrier":
            return dict(solve_hook=lambda *a: ref_batch.make_solve_hook(
                ref_batch.SolveBarrier(1))(*a))
        if self.kind == "lpq":
            return dict(solve_hook=lambda *a: ref_lpq.make_lpq_hook(
                ref_lpq.LpqBarrier(1))(*a))
        return {}

    def port_kw(self):
        kw = dict(device="cpu")
        if self.kind == "barrier":
            kw["solve_hook"] = self._counted(lambda: batch.make_solve_hook(
                batch.SolveBarrier(1, device="cpu")))
        elif self.kind == "lpq":
            kw["solve_hook"] = self._counted(lambda: lpq.make_lpq_hook(
                lpq.LpqBarrier(1, device="cpu")))
        return kw

    def _counted(self, make_hook):
        def hook(*a):
            self.port_solves += 1
            return make_hook()(*a)
        return hook


HOST = Route("host")


def run_both(ref_store, ev, kind, route=HOST, seed=RUN_SEED,
             port_store=None, configure=None):
    """Carry ``ref_store`` to a port store (unless given), then run ``ev``
    through a fresh Harness of each package with the id streams seeded
    alike. ``configure(h)`` sets up each Harness (plan rejection).
    Returns (reference harness, port harness, reference result, port
    result)."""
    memo = {}
    if port_store is None:
        port_store = store_from_reference(ref_store.snapshot(), memo)
    pev = struct_from_reference(ev, memo)
    rh, ph = RefHarness(ref_store), Harness(port_store)
    if configure is not None:
        configure(rh)
        configure(ph)
    sched_kind = "service" if kind == "tpu-lpq" else kind
    if kind in ("system", "sysbatch"):
        route = HOST                # system jobs take no solve hook
    ref_reseed_ids(seed)
    rkw = route.ref_kw()
    r = rh.process(lambda snap, planner: ref_new_scheduler(
        sched_kind, snap, planner, **rkw), ev)
    pst.reseed_ids(seed)
    p = ph.process(sched_kind, pev, **route.port_kw())
    return rh, ph, r, p


def assert_same_results(r, p):
    assert (r is None) == (p is None), (r, p)
    if r is not None:
        assert type(r).__name__ == type(p).__name__
        assert str(r) == str(p)


# --------------------------------------------------------------------------
# the worlds of tests/test_solver_parity.py

def parity_world(name, seed, alg):
    make_job, n_nodes, _seeds, fleet_fn, seed_usage = \
        PARITY_WORLDS[name][:5]
    ref_reseed_ids(seed)
    rng = random.Random(seed)
    mock._counter = itertools.count()
    h = RefHarness()
    h.state.set_scheduler_config(
        SchedulerConfiguration(scheduler_algorithm=alg))
    nodes = (fleet_fn or _random_fleet)(rng, n_nodes)
    for i, node in enumerate(nodes):
        node.id = f"node-{seed}-{i:04d}"
        h.state.upsert_node(node)
    if seed_usage:
        _seed_usage(rng, h, nodes)
    job = make_job(rng)
    job.id = f"parity-job-{seed}"
    h.state.upsert_job(job)
    ev = mock.evaluation(job_id=job.id, type=job.type)
    ev.id = f"parity-eval-{seed:08d}"
    return h.state, ev


def _world_algs(name):
    w = PARITY_WORLDS[name]
    return (w[5], w[6]) if len(w) > 5 else ("binpack", "tpu-binpack")


PARITY_CASES = [(name, seed) for name, w in PARITY_WORLDS.items()
                for seed in w[2]]
IDS = [f"{n}-{s}" for n, s in PARITY_CASES]


@pytest.mark.parametrize("name,seed", PARITY_CASES, ids=IDS)
def test_host_algorithm_world_equals_reference(name, seed):
    host_alg, _ = _world_algs(name)
    store, ev = parity_world(name, seed, host_alg)
    rh, ph, r, p = run_both(store, ev, "service")
    assert r is None and p is None
    assert placements(rh), "no placements -- bad world"
    assert_same_runs(rh, ph)


@pytest.mark.parametrize("name,seed", PARITY_CASES, ids=IDS)
def test_tpu_algorithm_world_through_the_barrier_equals_reference(name,
                                                                   seed):
    host_alg, tpu_alg = _world_algs(name)
    store, ev = parity_world(name, seed, tpu_alg)
    route = Route("barrier")
    rh, ph, r, p = run_both(store, ev, "service", route)
    assert r is None and p is None and route.port_solves >= 1
    assert_same_runs(rh, ph)
    # and the host stack's decisions, as the reference's solver gives
    hstore, hev = parity_world(name, seed, host_alg)
    host, _, _, _ = run_both(hstore, hev, "service")
    assert placements(ph) == placements(host)


@pytest.mark.parametrize("name,seed", [("basic_service", 0),
                                       ("with_ports", 401),
                                       ("with_affinities", 200),
                                       ("devices", 600),
                                       ("reserved_cores", 901),
                                       ("distinct_property", 402),
                                       ("sticky_limit_two_tgs", 31)])
def test_tpu_algorithm_world_through_the_solo_dispatch(name, seed):
    _, tpu_alg = _world_algs(name)
    store, ev = parity_world(name, seed, tpu_alg)
    rh, ph, r, p = run_both(store, ev, "service", Route("solo"))
    assert r is None and p is None and placements(ph)
    assert_same_runs(rh, ph)


@pytest.mark.parametrize("name,seed", [("basic_service", 1),
                                       ("with_spread_block", 300),
                                       ("with_ports", 400),
                                       ("distinct_hosts", 77),
                                       ("large_fleet", 9),
                                       ("reserved_cores", 900),
                                       ("sticky_limit_two_tgs", 32)])
def test_lpq_world_equals_reference(name, seed):
    store, ev = parity_world(name, seed, "tpu-lpq")
    route = Route("lpq")
    rh, ph, r, p = run_both(store, ev, "tpu-lpq", route)
    assert r is None and p is None and placements(ph)
    assert route.port_solves >= 1
    assert_same_runs(rh, ph)


@pytest.mark.parametrize("alg", ["binpack", "tpu-binpack"])
def test_batch_scheduler_world_equals_reference(alg):
    store, ev = parity_world("with_ports", 402, alg)
    job = store.job_by_id("default", "parity-job-402")
    job.type = "batch"
    ev.type = "batch"
    route = Route("barrier") if alg.startswith("tpu") else HOST
    rh, ph, r, p = run_both(store, ev, "batch", route)
    assert r is None and p is None and placements(ph)
    assert_same_runs(rh, ph)


# --------------------------------------------------------------------------
# system jobs (tests/test_system_tpu.py)

def system_world(seed, ports, alg, sysbatch=False):
    ref_reseed_ids(seed)
    rng = random.Random(seed)
    mock._counter = itertools.count()
    h = RefHarness()
    h.state.set_scheduler_config(SchedulerConfiguration(
        scheduler_algorithm=alg,
        preemption_config=PreemptionConfig(system_scheduler_enabled=False)))
    for i in range(30):
        node = mock.node()
        node.id = f"sys-node-{i:04d}"
        node.node_resources.cpu.cpu_shares = rng.choice([600, 2000, 4000])
        node.node_resources.memory.memory_mb = rng.choice([512, 4096, 8192])
        node.compute_class()
        h.state.upsert_node(node)
        for _ in range(rng.randint(0, 2)):
            other = mock.job()
            other.task_groups[0].tasks[0].resources.cpu = 400
            other.task_groups[0].tasks[0].resources.memory_mb = 400
            a = mock.alloc_for(other, node)
            a.client_status = ALLOC_CLIENT_RUNNING
            h.state.upsert_allocs([a])
    job = mock.system_job()
    job.id = "sys-parity"
    if sysbatch:
        job.type = "sysbatch"
    tg = job.task_groups[0]
    tg.tasks[0].resources.cpu = 500
    tg.tasks[0].resources.memory_mb = 512
    if ports:
        tg.networks = [NetworkResource(
            dynamic_ports=[Port(label="http")],
            reserved_ports=[Port(label="adm", value=9800)])]
    h.state.upsert_job(job)
    ev = Evaluation(id=f"sys-parity-eval-{seed:08d}",
                    namespace=job.namespace, job_id=job.id,
                    priority=job.priority, type=job.type,
                    triggered_by="job-register", status="pending")
    return h.state, ev


SYSTEM_CASES = [(0, False), (1, False), (2, False), (77, True)]


@pytest.mark.parametrize("alg", ["binpack", "tpu-binpack", "tpu-spread"])
@pytest.mark.parametrize("seed,ports", SYSTEM_CASES)
def test_system_world_equals_reference(seed, ports, alg):
    store, ev = system_world(seed, ports, alg)
    rh, ph, r, p = run_both(store, ev, "system")
    assert r is None and p is None and placed_nodes(ph)
    assert_same_runs(rh, ph)
    # the device fit leaves out exactly the nodes the host stack does
    hstore, hev = system_world(seed, ports, "binpack")
    host, _, _, _ = run_both(hstore, hev, "system")
    assert placed_nodes(host) == placed_nodes(ph)
    assert len(placed_nodes(ph)) == len(set(placed_nodes(ph)))


@pytest.mark.parametrize("alg", ["binpack", "tpu-binpack"])
@pytest.mark.parametrize("seed", [3, 78])
def test_sysbatch_world_equals_reference(seed, alg):
    store, ev = system_world(seed, seed == 78, alg, sysbatch=True)
    rh, ph, r, p = run_both(store, ev, "sysbatch")
    assert r is None and p is None and placed_nodes(ph)
    assert_same_runs(rh, ph)


# --------------------------------------------------------------------------
# preemption (tests/test_preemption.py) and the tiers of
# tests/test_parity_scale.py

def preempt_world(case, alg):
    ref_reseed_ids(len(case))
    mock._counter = itertools.count()
    h = RefHarness()
    h.state.set_scheduler_config(SchedulerConfiguration(
        scheduler_algorithm=alg,
        preemption_config=PreemptionConfig(
            system_scheduler_enabled=True, batch_scheduler_enabled=True,
            service_scheduler_enabled=True)))
    node = mock.node()
    node.id = "preempt-node-0"
    h.state.upsert_node(node)
    cpu, mem = 2000, 512
    if case == "lower_priority":
        _fill_node(h, node, 1800, 2, 20)
    elif case == "within_delta":
        _fill_node(h, node, 1800, 2, 65)
    elif case == "minimal_set":
        _fill_node(h, node, 2000, 1, 20)
        _fill_node(h, node, 900, 2, 30)
        mem = 256
    job = mock.job(priority=70)
    job.id = f"preempt-{case}"
    job.task_groups[0].count = 1
    job.task_groups[0].tasks[0].resources.cpu = cpu
    job.task_groups[0].tasks[0].resources.memory_mb = mem
    h.state.upsert_job(job)
    ev = mock.evaluation(job_id=job.id, type=job.type, priority=job.priority)
    ev.id = f"preempt-eval-{case}"
    return h.state, ev


@pytest.mark.parametrize("route", ["host", "barrier", "solo", "lpq"])
@pytest.mark.parametrize("case", ["lower_priority", "within_delta",
                                  "minimal_set"])
def test_preemption_world_equals_reference(case, route):
    alg = {"host": "binpack", "lpq": "tpu-lpq"}.get(route, "tpu-binpack")
    store, ev = preempt_world(case, alg)
    rh, ph, r, p = run_both(store, ev, "tpu-lpq" if route == "lpq"
                            else "service", Route(route))
    assert r is None and p is None
    assert_same_runs(rh, ph)
    pre = [a for plan in ph.plans for v in plan.node_preemptions.values()
           for a in v]
    if case == "within_delta":
        assert not placements(ph) and not pre
    else:
        assert len(placements(ph)) == 1 and pre


def tier_world(tier, n_nodes, count, seed, alg):
    ref_reseed_ids(seed)
    rng = random.Random(seed)
    mock._counter = itertools.count()
    h = RefHarness()
    cfg = SchedulerConfiguration(scheduler_algorithm=alg)
    if tier == 5:
        cfg.preemption_config = PreemptionConfig(
            service_scheduler_enabled=True, batch_scheduler_enabled=True)
    h.state.set_scheduler_config(cfg)
    nodes = benchkit.make_fleet(rng, h, n_nodes, gpus=(tier == 5))
    if tier == 5:
        benchkit.seed_utilization(rng, h, nodes, 0.95,
                                  priorities=(10, 20, 30, 40))
    elif tier in (3, 4):
        benchkit.seed_utilization(rng, h, nodes, 0.25)
    job = benchkit.tier_job(tier, rng, count)
    job.id = f"tier{tier}-job-{seed}"
    if tier == 5:
        job.priority = 70
        job.task_groups[0].tasks[0].resources.cpu = 1000
        job.task_groups[0].tasks[0].resources.devices = [
            DeviceRequest(name="nvidia/gpu", count=1)]
    h.state.upsert_job(job)
    ev = mock.evaluation(job_id=job.id, type=job.type, priority=job.priority)
    ev.id = f"tier{tier}-eval-{seed:08d}"
    kind = job.type if job.type in ("service", "batch") else "service"
    return h.state, ev, kind


TIER_CASES = [(1, 5, 3, 0), (2, 40, 30, 1), (3, 40, 30, 100),
              (4, 40, 30, 201), (5, 24, 12, 42)]


@pytest.mark.parametrize("alg", ["binpack", "tpu-binpack", "tpu-spread"])
@pytest.mark.parametrize("tier,n_nodes,count,seed", TIER_CASES)
def test_tier_world_equals_reference(tier, n_nodes, count, seed, alg):
    store, ev, kind = tier_world(tier, n_nodes, count, seed, alg)
    route = Route("barrier") if alg.startswith("tpu") else HOST
    rh, ph, r, p = run_both(store, ev, kind, route)
    assert r is None and p is None and placements(ph)
    assert_same_runs(rh, ph)
