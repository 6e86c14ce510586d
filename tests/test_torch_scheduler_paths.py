"""The reconciler paths of tests/test_scheduler.py, the breaker, a sticky
disk's host fallback and the journal, through the port's Harness against
the JAX package's, on the CPU.

Each scenario builds its world with the reference (its mock, store and
host scheduler for the set-up steps), carries the store to the port
before the step under test, and runs that step through both packages'
Harness with the id streams seeded alike and the clock pinned; the
plans, eval updates, created evals and stores must be equal (scores:
assert_allclose rtol 1e-12; everything else exact), under the host stack
(binpack) and the device path (tpu-binpack through a CPU SolveBarrier
hook).
"""
import numpy as np
import pytest
import torch

from nomad_tpu import mock
from nomad_tpu.scheduler import Harness as RefHarness
from nomad_tpu.server.telemetry import metrics as ref_metrics
from nomad_tpu.faultinject import faults as ref_faults
from nomad_tpu.solver import batch as ref_batch
from nomad_tpu.solver import guard as ref_guard
from nomad_tpu.structs import (
    Constraint, SchedulerConfiguration, ALLOC_CLIENT_COMPLETE,
    ALLOC_CLIENT_FAILED, ALLOC_CLIENT_RUNNING, EVAL_STATUS_BLOCKED,
    EVAL_STATUS_COMPLETE, NODE_STATUS_DOWN, TRIGGER_NODE_UPDATE)
from nomad_tpu.structs.job import reseed_ids as ref_reseed_ids

from nomad_tpu_torch import structs as pst
from nomad_tpu_torch.carry import store_from_reference, struct_from_reference
from nomad_tpu_torch.faultinject import faults
from nomad_tpu_torch.scheduler.context import EvalContext
from nomad_tpu_torch.scheduler.harness import Harness
from nomad_tpu_torch.solver import batch, guard, lpq
from nomad_tpu_torch.solver.service import TpuPlacementService
from nomad_tpu_torch.tensor import pack as port_pack

from test_torch_scheduler import (  # noqa: F401 -- fresh_state is autouse
    HOST, NOW, Route, assert_same_runs, fresh_state, placed_nodes,
    placements, run_both)

torch.set_num_threads(1)

ALGS = ["binpack", "tpu-binpack"]


def _route(alg):
    return Route("barrier") if alg.startswith("tpu") else HOST


def _harness(alg, seed=7):
    ref_reseed_ids(seed)
    h = RefHarness()
    h.state.set_scheduler_config(
        SchedulerConfiguration(scheduler_algorithm=alg))
    return h


def make_eval(job, **kw):
    e = mock.evaluation(job_id=job.id, namespace=job.namespace,
                        type=job.type, priority=job.priority)
    for k, v in kw.items():
        setattr(e, k, v)
    return e


def _compare(h, ev, alg, kind="service", **kw):
    rh, ph, r, p = run_both(h.state, ev, kind, _route(alg), **kw)
    assert (r is None) == (p is None)
    if r is not None:
        assert str(r) == str(p)
    assert_same_runs(rh, ph)
    return rh, ph


def _place_first(h, job, kind="service"):
    """The set-up step: the job placed by the reference."""
    h.state.upsert_job(job)
    assert RefHarness(h.state).process(kind, make_eval(job)) is None


@pytest.mark.parametrize("alg", ALGS)
def test_register_places_all(alg):
    h = _harness(alg)
    for _ in range(10):
        h.state.upsert_node(mock.node())
    job = mock.job()
    h.state.upsert_job(job)
    ev = make_eval(job)
    h.state.upsert_evals([ev])
    rh, ph = _compare(h, ev, alg)
    assert len(placements(ph)) == 10
    assert ph.evals[-1].status == EVAL_STATUS_COMPLETE
    stored = ph.state.allocs_by_job(job.namespace, job.id)
    assert sorted(a.index() for a in stored) == list(range(10))


@pytest.mark.parametrize("alg", ALGS)
def test_consolidation_across_jobs_in_the_port_store(alg):
    """Three jobs in turn; the port's store carries its own commits from
    one step to the next, and each step equals the reference's."""
    h = _harness(alg)
    for _ in range(2):
        h.state.upsert_node(mock.node())
    pstore = store_from_reference(h.state.snapshot())
    used = set()
    for k in range(3):
        job = mock.job()
        job.task_groups[0].count = 1
        h.state.upsert_job(job)
        pstore.upsert_job(struct_from_reference(job))
        rh, ph, r, p = run_both(h.state, make_eval(job), "service",
                                _route(alg), seed=100 + k,
                                port_store=pstore)
        assert r is None and p is None
        assert_same_runs(rh, ph)
        used |= set(placements(ph).values())
    assert len(used) == 1


@pytest.mark.parametrize("alg", ALGS)
def test_insufficient_capacity_creates_blocked_eval(alg):
    h = _harness(alg)
    n = mock.node()
    n.node_resources.cpu.cpu_shares = 1000
    h.state.upsert_node(n)
    job = mock.job()
    job.task_groups[0].count = 4
    h.state.upsert_job(job)
    rh, ph = _compare(h, make_eval(job), alg)
    assert len(placements(ph)) == 2
    assert len(ph.create_evals) == 1
    assert ph.create_evals[0].status == EVAL_STATUS_BLOCKED
    assert ph.evals[-1].blocked_eval == ph.create_evals[0].id
    assert ph.evals[-1].failed_tg_allocs["web"].coalesced_failures == 1
    assert ph.state.eval_by_id(ph.create_evals[0].id) is not None


@pytest.mark.parametrize("alg", ALGS)
def test_job_constraint_filters_nodes(alg):
    h = _harness(alg)
    good, bad = mock.node(), mock.node()
    bad.attributes["kernel.name"] = "windows"
    bad.compute_class()
    h.state.upsert_node(good)
    h.state.upsert_node(bad)
    job = mock.job()
    job.constraints = [Constraint(l_target="${attr.kernel.name}",
                                  r_target="linux", operand="=")]
    job.task_groups[0].count = 2
    h.state.upsert_job(job)
    rh, ph = _compare(h, make_eval(job), alg)
    assert set(placements(ph).values()) == {good.id}


def _updated_job(job, **tg_kw):
    job2 = mock.job(id=job.id)
    job2.task_groups[0].count = 2
    for k, v in tg_kw.items():
        setattr(job2.task_groups[0], k, v)
    return job2


@pytest.mark.parametrize("alg", ALGS)
def test_destructive_update_rolls_one_at_a_time(alg):
    h = _harness(alg)
    h.state.upsert_node(mock.node())
    job = mock.job()
    job.task_groups[0].count = 2
    _place_first(h, job)
    job2 = _updated_job(job)
    job2.task_groups[0].tasks[0].config = {"run_for": "60s"}
    h.state.upsert_job(job2)
    rh, ph = _compare(h, make_eval(job2), alg)
    plan = ph.plans[0]
    assert sum(len(v) for v in plan.node_update.values()) == 1
    assert len(placements(ph)) == 1


@pytest.mark.parametrize("alg", ALGS)
def test_destructive_update_all_at_once(alg):
    h = _harness(alg)
    h.state.upsert_node(mock.node())
    job = mock.job()
    job.task_groups[0].count = 2
    job.task_groups[0].update = None
    _place_first(h, job)
    job2 = _updated_job(job, update=None)
    job2.task_groups[0].tasks[0].config = {"run_for": "60s"}
    h.state.upsert_job(job2)
    rh, ph = _compare(h, make_eval(job2), alg)
    plan = ph.plans[0]
    assert sum(len(v) for v in plan.node_update.values()) == 2
    assert len(placements(ph)) == 2


@pytest.mark.parametrize("alg", ALGS)
def test_in_place_update(alg):
    h = _harness(alg)
    h.state.upsert_node(mock.node())
    job = mock.job()
    job.task_groups[0].count = 2
    _place_first(h, job)
    job2 = _updated_job(job)
    job2.meta = {"foo": "bar"}
    h.state.upsert_job(job2)
    rh, ph = _compare(h, make_eval(job2), alg)
    plan = ph.plans[0]
    assert not plan.node_update
    assert sum(len(v) for v in plan.node_allocation.values()) == 2


@pytest.mark.parametrize("alg", ALGS)
def test_count_decrease_stops_highest_indexes(alg):
    h = _harness(alg)
    h.state.upsert_node(mock.node())
    job = mock.job()
    job.task_groups[0].count = 5
    _place_first(h, job)
    job2 = mock.job(id=job.id)
    job2.task_groups[0].count = 2
    h.state.upsert_job(job2)
    for a in h.state.allocs_by_job(job.namespace, job.id):
        a.job_version = job2.version
        a.job = job2
    rh, ph = _compare(h, make_eval(job2), alg)
    stopped = [a for v in ph.plans[0].node_update.values() for a in v]
    assert sorted(a.index() for a in stopped) == [2, 3, 4]


@pytest.mark.parametrize("alg", ALGS)
def test_deregister_stops_everything(alg):
    h = _harness(alg)
    h.state.upsert_node(mock.node())
    job = mock.job()
    job.task_groups[0].count = 4
    _place_first(h, job)
    stopped = mock.job(id=job.id)
    stopped.stop = True
    stopped.task_groups[0].count = 4
    h.state.upsert_job(stopped)
    rh, ph = _compare(h, make_eval(stopped, triggered_by="job-deregister"),
                      alg)
    plan = ph.plans[0]
    assert sum(len(v) for v in plan.node_update.values()) == 4
    assert not plan.node_allocation


@pytest.mark.parametrize("alg", ALGS)
def test_node_down_reschedules_lost_allocs(alg):
    h = _harness(alg)
    for _ in range(3):
        h.state.upsert_node(mock.node())
    job = mock.job()
    job.task_groups[0].count = 3
    _place_first(h, job)
    for a in h.state.allocs_by_job(job.namespace, job.id):
        a.client_status = ALLOC_CLIENT_RUNNING
    down = sorted({a.node_id for a in
                   h.state.allocs_by_job(job.namespace, job.id)})[0]
    h.state.update_node_status(down, NODE_STATUS_DOWN)
    rh, ph = _compare(h, make_eval(job, triggered_by=TRIGGER_NODE_UPDATE,
                                   node_id=down), alg)
    lost = [a for v in ph.plans[0].node_update.values() for a in v]
    assert lost and all(a.client_status == "lost" for a in lost)
    assert len(placements(ph)) == len(lost)
    assert down not in placements(ph).values()


@pytest.mark.parametrize("alg", ALGS)
def test_failed_alloc_rescheduled_with_a_penalty(alg):
    """On the device path the replacement is a penalty lane (row 2)."""
    h = _harness(alg)
    for _ in range(3):
        h.state.upsert_node(mock.node())
    job = mock.job()
    job.task_groups[0].count = 1
    _place_first(h, job)
    (alloc,) = h.state.allocs_by_job(job.namespace, job.id)
    alloc.client_status = ALLOC_CLIENT_FAILED
    alloc.client_terminal_time = NOW - 60
    rh, ph = _compare(h, make_eval(job, triggered_by="alloc-failure"), alg)
    (placed,) = [a for plan in ph.plans
                 for v in plan.node_allocation.values() for a in v]
    assert placed.previous_allocation == alloc.id
    assert [(e.prev_alloc_id, e.prev_node_id, e.reschedule_time)
            for e in placed.reschedule_tracker.events] == \
        [(alloc.id, alloc.node_id, NOW)]
    assert placed.node_id != alloc.node_id


@pytest.mark.parametrize("alg", ALGS)
def test_completed_batch_allocs_are_not_replaced(alg):
    h = _harness(alg)
    h.state.upsert_node(mock.node())
    job = mock.batch_job(count=3)
    _place_first(h, job, kind="batch")
    for a in h.state.allocs_by_job(job.namespace, job.id):
        a.client_status = ALLOC_CLIENT_COMPLETE
    rh, ph = _compare(h, make_eval(job), alg, kind="batch")
    assert not placements(ph)


@pytest.mark.parametrize("alg", ALGS)
def test_system_job_on_every_node(alg):
    h = _harness(alg)
    nodes = [mock.node() for _ in range(4)]
    for n in nodes:
        h.state.upsert_node(n)
    job = mock.system_job()
    h.state.upsert_job(job)
    rh, ph = _compare(h, make_eval(job), alg, kind="system")
    assert placed_nodes(ph) == sorted(n.id for n in nodes)


@pytest.mark.parametrize("alg", ALGS)
def test_system_job_only_on_feasible_nodes(alg):
    h = _harness(alg)
    good, bad = mock.node(), mock.node()
    bad.attributes.pop("driver.mock")
    bad.compute_class()
    h.state.upsert_node(good)
    h.state.upsert_node(bad)
    job = mock.system_job()
    h.state.upsert_job(job)
    rh, ph = _compare(h, make_eval(job), alg, kind="system")
    assert placed_nodes(ph) == [good.id]


@pytest.mark.parametrize("alg", ALGS)
def test_plan_rejection_retries_then_fails(alg):
    h = _harness(alg)
    h.state.upsert_node(mock.node())
    job = mock.job()
    h.state.upsert_job(job)

    def reject(hh):
        hh.reject_plan = True
    rh, ph = _compare(h, make_eval(job), alg, configure=reject)
    assert ph.reject_tracker == rh.reject_tracker == 5
    assert ph.evals[-1].status == "failed"


@pytest.mark.parametrize("alg", ["spread", "tpu-spread"])
def test_spread_algorithm_distributes(alg):
    h = _harness(alg)
    for _ in range(4):
        h.state.upsert_node(mock.node())
    job = mock.job()
    job.task_groups[0].count = 4
    h.state.upsert_job(job)
    rh, ph = _compare(h, make_eval(job), alg)
    assert len(set(placements(ph).values())) > 1


@pytest.mark.parametrize("alg", ALGS)
def test_deployment_created_and_committed(alg):
    h = _harness(alg)
    h.state.upsert_node(mock.node())
    job = mock.job()
    job.task_groups[0].count = 2
    h.state.upsert_job(job)
    rh, ph = _compare(h, make_eval(job), alg)
    d = ph.state.latest_deployment_by_job(job.namespace, job.id)
    assert d is not None and d.job_version == job.version
    assert "web" in d.task_groups
    assert {a.deployment_id for plan in ph.plans
            for v in plan.node_allocation.values() for a in v} == {d.id}


# --------------------------------------------------------------------------
# host fallbacks: a sticky disk, and an open breaker

def _sticky_world():
    h = _harness("tpu-binpack")
    for _ in range(4):
        h.state.upsert_node(mock.node())
    job = mock.job()
    job.task_groups[0].count = 3
    job.task_groups[0].ephemeral_disk.sticky = True
    _place_first(h, job)
    allocs = h.state.allocs_by_job(job.namespace, job.id)
    failed = allocs[1]
    failed.client_status = ALLOC_CLIENT_FAILED
    failed.client_terminal_time = NOW - 60
    return h, job, failed


def _ref_host_places():
    """The reference's count of host-stack places under a tpu-*
    algorithm (its telemetry counter)."""
    return ref_metrics.snapshot()["counters"].get(
        "nomad.scheduler.placements_host_fallback", 0)


def test_sticky_disk_reschedule_falls_back_to_the_host_stack():
    """A rescheduled place of a sticky task group goes to the host stack
    (upstream generic_sched.go: a sticky disk with a previous alloc),
    back onto its node; the guard counts it as one host-stack place,
    as the reference's placements_host_fallback counter does, and no
    host-fallback eval (no dispatch was refused or failed)."""
    h, job, failed = _sticky_world()
    before = guard.state()["host_fallback_dispatches"]
    places_before = guard.state()["placements_host_fallback"]
    ref_places = _ref_host_places()
    ref_before = ref_guard.state()["host_fallback_dispatches"]
    route = Route("barrier")
    rh, ph, r, p = run_both(h.state, make_eval(
        job, triggered_by="alloc-failure"), "service", route)
    assert r is None and p is None
    assert_same_runs(rh, ph)
    assert route.port_solves == 0
    (placed,) = [a for plan in ph.plans
                 for v in plan.node_allocation.values() for a in v]
    assert placed.node_id == failed.node_id
    assert placed.previous_allocation == failed.id
    assert guard.state()["placements_host_fallback"] - places_before \
        == _ref_host_places() - ref_places == 1
    assert guard.state()["host_fallback_dispatches"] - before \
        == ref_guard.state()["host_fallback_dispatches"] - ref_before == 0


def _breaker_world(kind):
    h = _harness("tpu-binpack")
    for _ in range(5):
        h.state.upsert_node(mock.node())
    job = mock.system_job() if kind == "system" else mock.job()
    h.state.upsert_job(job)
    return h, job


@pytest.mark.parametrize("kind", ["service", "system"])
def test_open_breaker_places_through_the_host_stack(kind):
    """With both guards' breakers open, a tpu-binpack eval places through
    the host stack in both packages, and the port's guard counts the
    fallback, as the reference's does; with them closed the same world
    takes the device path to the same placements. An open breaker
    turns the tpu-* algorithm off for the eval, so its host-stack
    places are not counted as placements_host_fallback, in either
    package."""
    h, job = _breaker_world(kind)
    guard._BREAKER["state"] = guard.BREAKER_OPEN
    ref_guard._BREAKER["state"] = ref_guard.BREAKER_OPEN
    ref_before = ref_guard.state()["host_fallback_dispatches"]
    before = guard.state()["host_fallback_dispatches"]
    places_before = guard.state()["placements_host_fallback"]
    ref_places = _ref_host_places()
    route = Route("barrier")
    rh, ph, r, p = run_both(h.state, make_eval(job), kind, route)
    assert r is None and p is None and placed_nodes(ph)
    assert_same_runs(rh, ph)
    assert route.port_solves == 0
    ref_n = ref_guard.state()["host_fallback_dispatches"] - ref_before
    assert guard.state()["host_fallback_dispatches"] - before == ref_n >= 1
    assert guard.state()["placements_host_fallback"] == places_before
    assert _ref_host_places() == ref_places

    guard._BREAKER["state"] = guard.BREAKER_CLOSED
    ref_guard._BREAKER["state"] = ref_guard.BREAKER_CLOSED
    h, job = _breaker_world(kind)
    before = guard.state()["host_fallback_dispatches"]
    route = Route("barrier")
    rh2, ph2, _, _ = run_both(h.state, make_eval(job), kind, route)
    assert_same_runs(rh2, ph2)
    assert route.port_solves == (1 if kind == "service" else 0)
    assert guard.state()["host_fallback_dispatches"] == before
    assert placed_nodes(ph2) == placed_nodes(ph)


def test_system_host_stack_places_under_a_tpu_algorithm_are_counted():
    """A system job the device path does not model (distinct_property)
    places through the host stack under tpu-binpack: each place counts
    as a host-stack place, no eval counts as a host fallback, and the
    plans equal the reference's."""
    h, job = _breaker_world("system")
    job.constraints.append(Constraint(l_target="${node.unique.id}",
                                      operand="distinct_property"))
    h.state.upsert_job(job)
    before = guard.state()
    rh, ph, r, p = run_both(h.state, make_eval(job), "system",
                            Route("barrier"))
    assert r is None and p is None and placed_nodes(ph)
    assert_same_runs(rh, ph)
    after = guard.state()
    assert (after["placements_host_fallback"]
            - before["placements_host_fallback"]) == len(placed_nodes(ph))
    assert after["host_fallback_dispatches"] == \
        before["host_fallback_dispatches"]


# --------------------------------------------------------------------------
# a failed dispatch: the host stack on the CPU, the caller's error on a card

def test_failed_dispatch_on_the_cpu_goes_to_the_host_stack(monkeypatch):
    """With the solver.dispatch fault armed in both packages, the
    barrier's generation fails; on CPU cells the hook counts one host
    fallback and the host stack places the task group, in both packages,
    to the same plans and the same counts."""
    h, job = _breaker_world("service")
    ref_before = ref_guard.state()["host_fallback_dispatches"]
    ref_places = _ref_host_places()
    before = guard.state()
    # the reference's pipelined generation stages its arena buffers
    # (fuse_lanes on the intake thread); its dispatch fails before
    # solve_groups, whose finally would release them
    staged = []
    real_fuse = ref_batch.fuse_lanes

    def recording(*a, **kw):
        groups = real_fuse(*a, **kw)
        staged.extend(groups)
        return groups

    monkeypatch.setattr(ref_batch, "fuse_lanes", recording)
    faults.arm("solver.dispatch", "error")
    ref_faults.arm("solver.dispatch", "error")
    try:
        route = Route("barrier")
        rh, ph, r, p = run_both(h.state, make_eval(job), "service", route)
    finally:
        faults.disarm_all()
        ref_faults.disarm_all()
        # drain the failed generation: release the arena entries it left
        # acquired, so the next test on this worker reads the reference
        # arena's in_use as the port's (ROADMAP Queue 3, *reference*)
        for g in staged:
            if g.entry is not None:
                ref_batch._ARENA.release(g.entry)
                g.entry = None
    assert r is None and p is None and placed_nodes(ph)
    assert_same_runs(rh, ph)
    assert route.port_solves == 1
    after = guard.state()
    assert (after["host_fallback_dispatches"]
            - before["host_fallback_dispatches"]) == \
        ref_guard.state()["host_fallback_dispatches"] - ref_before == 1
    assert (after["placements_host_fallback"]
            - before["placements_host_fallback"]) == \
        _ref_host_places() - ref_places == len(placed_nodes(ph))


class _CardBarrier:
    """A barrier whose cell is a card and whose generation failed (a
    kernel's exception, as run_dispatch reports it)."""
    cells = (torch.device("cuda"),)

    def solve(self, lane):
        raise guard.DispatchFailed("error", "kernel failed")


@pytest.fixture
def on_card(monkeypatch):
    """A ``cuda`` device resolves and its init passes, on a machine that
    has no card: what follows is the dispatch's own outcome (the fault
    point fires before any launch, and the stub barrier launches
    nothing)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(guard, "backend_available", lambda *a, **k: True)


def _card_eval(kind):
    h, job = _breaker_world(kind)
    return (store_from_reference(h.state.snapshot()),
            struct_from_reference(make_eval(job)))


@pytest.mark.parametrize("route", ["barrier", "lpq", "solo", "system"])
def test_failed_dispatch_on_a_card_fails_the_eval(on_card, route):
    """On a card a failed dispatch raises DispatchFailed out of
    Harness.process, through the SolveBarrier hook, the LpqBarrier hook,
    the solo dispatch and the system fit alike: the host stack places
    nothing, no plan commits, no eval update is written, and no host
    fallback is counted."""
    kind = "system" if route == "system" else "service"
    store, ev = _card_eval(kind)
    kw = {"device": "cuda"}
    if route == "barrier":
        kw["solve_hook"] = batch.make_solve_hook(_CardBarrier())
    elif route == "lpq":
        kw["solve_hook"] = lpq.make_lpq_hook(_CardBarrier())
    else:
        faults.arm("solver.dispatch", "error")
    ph = Harness(store)
    before = guard.state()
    try:
        with pytest.raises(guard.DispatchFailed) as ei:
            ph.process(kind, ev, **kw)
    finally:
        faults.disarm_all()
    assert ei.value.kind == "error"
    assert not ph.plans and not ph.evals and not store.allocs()
    after = guard.state()
    for k in ("host_fallback_dispatches", "placements_host_fallback"):
        assert after[k] == before[k], k


@pytest.mark.parametrize("kind", ["service", "system"])
def test_open_breaker_on_a_card_refuses_the_eval(on_card, kind):
    """On a card an open breaker does not send the eval to the host
    stack: _tpu_algorithm (GenericScheduler) and the system scheduler's
    check raise DispatchFailed("refused") out of Harness.process, with
    nothing placed and no fallback counted."""
    store, ev = _card_eval(kind)
    guard._BREAKER["state"] = guard.BREAKER_OPEN
    ph = Harness(store)
    before = guard.state()
    with pytest.raises(guard.DispatchFailed) as ei:
        ph.process(kind, ev, device="cuda")
    assert ei.value.kind == "refused"
    assert not ph.plans and not ph.evals and not store.allocs()
    after = guard.state()
    for k in ("host_fallback_dispatches", "placements_host_fallback"):
        assert after[k] == before[k], k


# --------------------------------------------------------------------------
# the journal

def test_usage_base_catches_up_through_the_plan_commit_journal():
    """A committed plan journals its pairs: the next eval's usage base
    catches up through them (a delta hit, no refold) to a fresh fold of
    the new snapshot, and to the reference store's usage."""
    h = _harness("tpu-binpack")
    nodes = [mock.node() for _ in range(8)]
    for n in nodes:
        h.state.upsert_node(n)
    jobs = [mock.job() for _ in range(3)]
    for j in jobs:
        j.task_groups[0].count = 5
        h.state.upsert_job(j)
    pstore = store_from_reference(h.state.snapshot())

    def usage_now(job):
        snap = pstore.snapshot()
        pjob = snap.job_by_id(job.namespace, job.id)
        ctx = EvalContext(snap, pst.Plan(eval_id="journal-eval-0001",
                                         job=pjob))
        svc = TpuPlacementService(ctx, pjob, False, False, device="cpu")
        ready = snap.ready_nodes_in_pool("default")
        matrix = port_pack.pack_nodes_cached(
            ready, snap.node_table_index, snap.nodes_pack_key(ready))
        return (svc._pack_usage_incremental(matrix, ready,
                                            pjob.task_groups[0]),
                matrix, ready, snap)

    usage_now(jobs[0])
    for k, j in enumerate(jobs):
        rh, ph, r, p = run_both(h.state, make_eval(j), "service",
                                Route("barrier"), seed=300 + k,
                                port_store=pstore)
        assert r is None and p is None
        assert_same_runs(rh, ph)
        u, matrix, ready, snap = usage_now(jobs[0])
        fresh = port_pack.fold_usage_base(
            matrix, ready, lambda nid: [
                a for a in snap.allocs_by_node(nid)
                if not a.client_terminal_status()])
        for f in ("used_cpu", "used_mem", "used_disk"):
            assert np.array_equal(getattr(u, f), fresh[f]), f
        ref_snap = h.state.snapshot()
        want = [sum(a.allocated_resources.comparable().cpu_shares
                    for a in ref_snap.allocs_by_node(n.id)
                    if not a.client_terminal_status()) for n in ready]
        assert u.used_cpu[:len(ready)].tolist() == want
    st = port_pack.pack_cache_stats()
    assert st["usage_base_misses"] == 1
    assert st["usage_base_delta_hits"] == 3


@pytest.mark.parametrize("alg", ALGS)
def test_missing_placement_never_takes_a_lost_allocs_name(alg):
    """A job one alloc short (web[2] gone) whose web[1] is lost on a down
    node: the lost alloc's replacement keeps web[1] and the missing
    placement takes web[2] (upstream: the name index covers lost and
    rescheduled allocs). The reference's index reads the live allocs
    only and names both web[1] (ROADMAP Queue 3); every other decision
    of the eval equals the reference's."""
    h = _harness(alg)
    nodes = [mock.node() for _ in range(3)]
    for n in nodes:
        h.state.upsert_node(n)
    job = mock.job()
    job.task_groups[0].count = 3
    h.state.upsert_job(job)
    allocs = []
    for i in range(2):
        a = mock.alloc_for(job, nodes[i], index=i)
        a.client_status = "running"
        allocs.append(a)
    h.state.upsert_allocs(allocs)
    h.state.update_node_status(nodes[1].id, "down", 0.0)
    ev = make_eval(job, triggered_by="node-update", node_id=nodes[1].id)
    h.state.upsert_evals([ev])
    rh, ph, r, p = run_both(h.state, ev, "service", _route(alg))
    assert r is None and p is None
    want = [a.name for plan in rh.plans
            for al in plan.node_allocation.values() for a in al]
    got = [a.name for plan in ph.plans
           for al in plan.node_allocation.values() for a in al]
    assert sorted(got) == [f"{job.id}.web[1]", f"{job.id}.web[2]"]
    assert sorted(want) == [f"{job.id}.web[1]", f"{job.id}.web[1]"]
    stops = [(a.id, a.client_status) for plan in ph.plans
             for al in plan.node_update.values() for a in al]
    assert stops == [(a.id, a.client_status) for plan in rh.plans
                     for al in plan.node_update.values() for a in al]
    assert stops == [(allocs[1].id, "lost")]
