"""GenericScheduler: service and batch evaluation processing (port of
nomad_tpu/scheduler/generic.py; upstream: scheduler/generic_sched.go
Process :149, process :248, computeJobAllocs :364, computePlacements
:511, and scheduler.go's Scheduler / State / Planner interfaces).

With a tpu-* algorithm in the scheduler configuration, each task group's
placements are packed, solved on the device (``solve_hook``, the
SolveBarrier or LpqBarrier hook, or the service's solo dispatch) and
materialized; what the device path does not model falls back to the
host iterator stack one placement at a time. The device is ``device``
(default ``cuda``): asking for the card without one raises, and nothing
carries on on the CPU unless the caller names it. On a card, a dispatch
that fails or is refused (init down, breaker open) raises DispatchFailed
out of ``process``: the eval is not placed by the host stack.
"""
from __future__ import annotations

import time as _time
from typing import Dict, List, Optional, Set

from ..device import DeviceLike, resolve_device
from ..server.telemetry import metrics as _tm
from ..server.tracing import tracer
from ..solver.guard import (
    dispatch_allowed, host_fallback_allowed, note_host_fallback,
    note_host_placements, refuse_dispatch)
from ..structs import (
    AllocatedResources, AllocatedSharedResources, AllocDeploymentStatus,
    Allocation, Evaluation, Job, Plan, PlanResult, RescheduleEvent,
    RescheduleTracker, generate_uuid,
    ALLOC_DESIRED_RUN, EVAL_STATUS_BLOCKED, EVAL_STATUS_COMPLETE,
    EVAL_STATUS_FAILED, JOB_TYPE_BATCH, JOB_TYPE_SERVICE,
    SCHED_ALG_TPU_SPREAD, TRIGGER_ALLOC_STOP, TRIGGER_DEPLOYMENT_WATCHER,
    TRIGGER_FAILED_FOLLOW_UP, TRIGGER_JOB_DEREGISTER, TRIGGER_JOB_REGISTER,
    TRIGGER_MAX_DISCONNECT_TIMEOUT, TRIGGER_NODE_DRAIN, TRIGGER_NODE_UPDATE,
    TRIGGER_PERIODIC_JOB, TRIGGER_QUEUED_ALLOCS, TRIGGER_RECONNECT,
    TRIGGER_RETRY_FAILED_ALLOC, TRIGGER_ROLLING_UPDATE, TRIGGER_SCALING,
)
from .context import EvalContext
from .rank import net_priority, preemption_score
from .reconcile import AllocPlaceResult, AllocReconciler
from .stack import GenericStack, SelectOptions
from .util import progress_made, tainted_nodes

MAX_SERVICE_SCHEDULE_ATTEMPTS = 5
MAX_BATCH_SCHEDULE_ATTEMPTS = 2

_OK_TRIGGERS = frozenset((
    TRIGGER_JOB_REGISTER, TRIGGER_JOB_DEREGISTER, TRIGGER_NODE_DRAIN,
    TRIGGER_NODE_UPDATE, TRIGGER_ALLOC_STOP, TRIGGER_ROLLING_UPDATE,
    TRIGGER_QUEUED_ALLOCS, TRIGGER_DEPLOYMENT_WATCHER,
    TRIGGER_RETRY_FAILED_ALLOC, TRIGGER_FAILED_FOLLOW_UP,
    TRIGGER_MAX_DISCONNECT_TIMEOUT, TRIGGER_RECONNECT,
    TRIGGER_PERIODIC_JOB, TRIGGER_SCALING,
))


class SetStatusError(Exception):
    """A terminal scheduling failure that still sets the eval's status
    (upstream: generic_sched.go SetStatusError)."""

    def __init__(self, msg: str, status: str = EVAL_STATUS_FAILED):
        super().__init__(msg)
        self.eval_status = status


def _reschedule_tracker(prev: Allocation) -> RescheduleTracker:
    """The previous alloc's reschedule events plus this reschedule."""
    tracker = RescheduleTracker()
    if prev.reschedule_tracker is not None:
        tracker.events = list(prev.reschedule_tracker.events)
    tracker.events.append(RescheduleEvent(
        reschedule_time=_time.time(), prev_alloc_id=prev.id,
        prev_node_id=prev.node_id))
    return tracker


class GenericScheduler:
    """(upstream: generic_sched.go:101 GenericScheduler). ``solve_hook``
    (service, tg, places, nodes, penalties) -> placements | None solves
    a task group at a barrier (batch.make_solve_hook,
    lpq.make_lpq_hook); None solves it in its own dispatch. ``device``
    is where the placement service dispatches (default ``cuda``)."""

    def __init__(self, state, planner, batch: bool = False, logger=None,
                 solve_hook=None, device: DeviceLike = None):
        self.state = state
        self.planner = planner
        self.batch = batch
        self.logger = logger
        self.solve_hook = solve_hook
        self.device = device

        self.eval: Optional[Evaluation] = None
        self.job: Optional[Job] = None
        self.plan: Optional[Plan] = None
        self.plan_result: Optional[PlanResult] = None
        self.ctx: Optional[EvalContext] = None
        self.stack: Optional[GenericStack] = None
        self.deployment = None

        self.base_nodes: List = []
        self.blocked: Optional[Evaluation] = None
        self.failed_tg_allocs: Dict[str, object] = {}
        self.queued_allocs: Dict[str, int] = {}
        self.followup_evals: Dict[str, List[Evaluation]] = {}

    # ------------------------------------------------------------------
    def process(self, evaluation: Evaluation):
        """Entry point (upstream: generic_sched.go:149 Process)."""
        self.eval = evaluation
        if evaluation.triggered_by not in _OK_TRIGGERS:
            desc = (f"scheduler cannot handle "
                    f"'{evaluation.triggered_by}' evaluation")
            self.planner.update_eval(self._eval_with_status(
                EVAL_STATUS_FAILED, desc))
            return None

        limit = (MAX_BATCH_SCHEDULE_ATTEMPTS if self.batch
                 else MAX_SERVICE_SCHEDULE_ATTEMPTS)
        attempts = 0
        err: Optional[Exception] = None
        while attempts < limit:
            try:
                done = self._process_once()
            except SetStatusError as e:
                self.planner.update_eval(self._eval_with_status(
                    e.eval_status, str(e)))
                return e
            if done:
                err = None
                break
            if progress_made(self.plan_result):
                attempts = 0
            else:
                attempts += 1
            if attempts >= limit:
                err = SetStatusError(f"maximum attempts reached ({limit})")
        if err is not None:
            self.planner.update_eval(self._eval_with_status(
                EVAL_STATUS_FAILED, str(err)))
            return err

        self.planner.update_eval(self._eval_with_status(
            EVAL_STATUS_COMPLETE, ""))
        return None

    def _eval_with_status(self, status: str, desc: str) -> Evaluation:
        ev = self.eval.copy()
        ev.status = status
        ev.status_description = desc
        if self.blocked is not None:
            ev.blocked_eval = self.blocked.id
        ev.failed_tg_allocs = dict(self.failed_tg_allocs)
        ev.queued_allocations = dict(self.queued_allocs)
        return ev

    # ------------------------------------------------------------------
    def _process_once(self) -> bool:
        """(upstream: generic_sched.go:248 process) True when the plan
        fully committed or was a no-op."""
        self.blocked = None
        self.failed_tg_allocs = {}

        self.job = self.state.job_by_id(self.eval.namespace,
                                        self.eval.job_id)
        self.plan = Plan(
            eval_id=self.eval.id,
            priority=self.eval.priority,
            job=self.job,
            all_at_once=self.job.all_at_once if self.job else False,
        )
        self.ctx = EvalContext(self.state, self.plan, self.logger)
        self.stack = GenericStack(self.batch, self.ctx)
        if self.job is not None and not self.job.stopped():
            self.stack.set_scheduler_configuration(
                self.state.scheduler_config())
            self.stack.set_job(self.job)
            # the ready nodes of the job's pool and datacenters, memoized
            # on the snapshot: the evals of a barrier generation share
            # one list (and its pack key); read-only
            nodes = self.state.ready_nodes_in_pool_dcs(
                self.job.node_pool, frozenset(self.job.datacenters))
            self.base_nodes = nodes       # before the shuffle: the solver's
            self.stack.set_nodes(nodes)
            self.ctx.metrics.nodes_in_pool = len(nodes)

        if not self._compute_job_allocs():
            return False
        return self._finish_plan()

    def _compute_job_allocs(self) -> bool:
        """(upstream: generic_sched.go:364 computeJobAllocs)"""
        ns, job_id = self.eval.namespace, self.eval.job_id
        allocs = self.state.allocs_by_job(ns, job_id)
        reconciler = AllocReconciler(
            batch=self.batch,
            job_id=job_id,
            job=self.job if (self.job and not self.job.stopped()) else None,
            deployment=self.state.latest_deployment_by_job(ns, job_id),
            existing_allocs=allocs,
            tainted_nodes=tainted_nodes(self.state, allocs),
            eval_id=self.eval.id,
            eval_priority=self.eval.priority,
        )
        results = reconciler.compute()
        self.followup_evals = results.desired_followup_evals
        # the deployment placements attach to: the active one, or the
        # one the reconciler created
        self.deployment = reconciler.deployment

        if results.deployment is not None:
            self.plan.deployment = results.deployment
        self.plan.deployment_updates = list(results.deployment_updates)

        for stop in results.stop:
            self.plan.append_stopped_alloc(
                stop.alloc, stop.status_description, stop.client_status,
                stop.followup_eval_id)
        # disconnect / reconnect updates and in-place updates ride the
        # plan as allocs
        for alloc in results.disconnect_updates.values():
            self.plan.append_alloc(alloc)
        for alloc in results.reconnect_updates.values():
            self.plan.append_alloc(alloc)
        for alloc in results.inplace_update:
            self.plan.append_alloc(alloc)

        # follow-up evals exist before failed allocs name them
        for evals in self.followup_evals.values():
            for ev in evals:
                self.planner.create_eval(ev)

        self.queued_allocs = {
            tg: du.place + du.destructive_update
            for tg, du in results.desired_tg_updates.items()}

        # a destructive update stops the old alloc and places anew
        destructive_places: List[AllocPlaceResult] = []
        for d in results.destructive_update:
            self.plan.append_stopped_alloc(
                d.stop_alloc, d.stop_status_description)
            destructive_places.append(AllocPlaceResult(
                name=d.place_name, task_group=d.place_task_group,
                previous_alloc=d.stop_alloc))

        if self.job is None or self.job.stopped():
            return True
        return self._compute_placements(results.place + destructive_places)

    def _compute_placements(self, places: List[AllocPlaceResult]) -> bool:
        """(upstream: generic_sched.go:511 computePlacements) With a
        tpu-* algorithm, each task group's places are solved on the
        device; what the device path does not model is placed by the
        host stack."""
        tpu_alg = self._tpu_algorithm()
        if tpu_alg:
            places = self._compute_placements_tpu(places)
        if places:
            with tracer.span("sched.feasibility_rank",
                             places=len(places), tpu_carveout=tpu_alg):
                self._place_host(places, self._deployment_id(), tpu_alg)
        if self.failed_tg_allocs and not self.batch:
            self._queue_blocked_eval()
        return True

    def _place_host(self, places: List[AllocPlaceResult],
                    deployment_id: str, tpu_alg: bool) -> None:
        """The host stack, one place at a time. Under a tpu-* algorithm
        the places it makes are counted by the guard as host-stack
        places (note_host_placements); each place is also counted in the
        metrics registry, as ``nomad.scheduler.placements_host_fallback``
        under a tpu-* algorithm and ``placements_host`` otherwise."""
        made = 0
        for place in places:
            tg = place.task_group
            penalty: Set[str] = set()
            preferred = []
            prev = place.previous_alloc
            if prev is not None:
                if place.reschedule:
                    penalty.add(prev.node_id)
                if tg.ephemeral_disk.sticky and not place.previous_lost:
                    node = self.state.node_by_id(prev.node_id)
                    # back to a node still taking work (upstream:
                    # generic_sched.go:889 preferredNode.Ready())
                    if node is not None and node.ready():
                        preferred = [node]

            option = self.stack.select(tg, SelectOptions(
                penalty_node_ids=penalty,
                preferred_nodes=preferred,
                alloc_name=place.name,
                preempt=self._preemption_enabled()))
            if option is None:
                self._note_failed(tg.name, self.ctx.metrics.copy())
                continue
            made += 1
            _tm.incr("nomad.scheduler.placements_host_fallback" if tpu_alg
                     else "nomad.scheduler.placements_host")

            resources = AllocatedResources(
                tasks=dict(option.task_resources),
                shared=option.alloc_resources
                if option.alloc_resources is not None
                else AllocatedSharedResources(
                    disk_mb=tg.ephemeral_disk.size_mb))
            self._append_alloc(place, option.node, resources,
                               self.ctx.metrics.copy(), deployment_id,
                               option.preempted_allocs)
        if tpu_alg and made:
            note_host_placements(made)

    def _note_failed(self, tg_name: str, metrics) -> None:
        """Record a failed placement: the first one's metrics, then a
        coalesced count."""
        if tg_name in self.failed_tg_allocs:
            self.failed_tg_allocs[tg_name].coalesced_failures += 1
        else:
            self.failed_tg_allocs[tg_name] = metrics

    def _append_alloc(self, place, node, resources, metrics,
                      deployment_id: str, preempted) -> None:
        """The allocation of one placement, its reschedule tracker and
        canary flag, and its preemptions, into the plan."""
        tg = place.task_group
        alloc = Allocation(
            id=generate_uuid(),
            namespace=self.job.namespace,
            eval_id=self.eval.id,
            name=place.name,
            job_id=self.job.id,
            job=self.job,
            job_version=self.job.version,
            task_group=tg.name,
            node_id=node.id,
            node_name=node.name,
            deployment_id=deployment_id,
            allocated_resources=resources,
            desired_status=ALLOC_DESIRED_RUN,
            client_status="pending",
            metrics=metrics,
        )
        if place.canary:
            alloc.deployment_status = AllocDeploymentStatus(canary=True)
        prev = place.previous_alloc
        if prev is not None:
            alloc.previous_allocation = prev.id
            if place.reschedule:
                alloc.reschedule_tracker = _reschedule_tracker(prev)
        for p in preempted or ():
            self.plan.append_preempted_alloc(p, alloc.id)
        self.plan.append_alloc(alloc)

    def _deployment_id(self) -> str:
        """Placements attach to the active deployment of the job's
        current version (upstream: generic_sched.go computePlacements
        deploymentID)."""
        d = self.deployment if self.deployment is not None \
            else self.plan.deployment
        if (d is not None and d.active() and self.job is not None
                and d.job_version == self.job.version):
            return d.id
        return ""

    def _tpu_algorithm(self) -> bool:
        """Does the configuration pick a tpu-* algorithm and may this eval
        dispatch? Resolving the device raises without a card. An init
        probe that is down or an open breaker sends the eval to the host
        stack on the CPU, counted as a host fallback; on a card it
        raises DispatchFailed("refused"), as a failed dispatch does."""
        cfg = self.state.scheduler_config()
        if cfg is None or not cfg.uses_tpu():
            return False
        device = resolve_device(self.device)
        if not dispatch_allowed(device):
            if not host_fallback_allowed(device):
                refuse_dispatch(device)
            note_host_fallback()
            return False
        return True

    def _compute_placements_tpu(self, places: List[AllocPlaceResult]
                                ) -> List[AllocPlaceResult]:
        """Solve each task group's places on the device; returns the
        places the device path does not take (a sticky disk with a
        previous alloc, or what tg_solver_eligible refuses), which the
        host stack then places."""
        from ..solver.service import TpuPlacementService, tg_solver_eligible

        cfg = self.state.scheduler_config()
        groups: Dict[str, List[AllocPlaceResult]] = {}
        for place in places:
            groups.setdefault(place.task_group.name, []).append(place)

        deployment_id = self._deployment_id()
        preempt = self._preemption_enabled()
        fallback: List[AllocPlaceResult] = []
        service = TpuPlacementService(
            self.ctx, self.job, self.batch,
            cfg.scheduler_algorithm == SCHED_ALG_TPU_SPREAD,
            preempt=preempt, device=self.device)
        # the solver derives the stack's shuffle from the eval id, so it
        # takes the nodes before the shuffle
        base_nodes = self.base_nodes or \
            self.state.ready_nodes_in_pool(self.job.node_pool)

        for tg_places in groups.values():
            tg = tg_places[0].task_group
            sticky = tg.ephemeral_disk.sticky and any(
                p.previous_alloc is not None for p in tg_places)
            if sticky or not tg_solver_eligible(tg, self.job,
                                                preempt=preempt):
                fallback.extend(tg_places)
                continue
            penalties = [
                {p.previous_alloc.node_id} if (p.reschedule and
                                               p.previous_alloc) else set()
                for p in tg_places]
            with tracer.span("solver.solve_tg", tg=tg.name,
                             places=len(tg_places),
                             batched=self.solve_hook is not None) as sp_:
                if self.solve_hook is not None:
                    solved = self.solve_hook(service, tg, tg_places,
                                             base_nodes, penalties)
                else:
                    solved = service.solve(tg, tg_places, base_nodes,
                                           penalties)
                sp_.tag(host_fallback=solved is None)
            if solved is None:
                fallback.extend(tg_places)
                continue
            n_solved = 0
            for sp in solved:
                if sp.node is None:
                    if (self.eval.annotate_plan and sp.failure is not None
                            and tg.name not in self.failed_tg_allocs):
                        # a plan's answer says why; a registration's
                        # eval keeps the reference's bare metric
                        m = sp.explain(self.ctx.metrics)
                    else:
                        m = self.ctx.metrics.copy()
                        m.nodes_evaluated = sp.n_yielded
                    self._note_failed(tg.name, m)
                    continue
                self._append_solved_alloc(sp, deployment_id)
                n_solved += 1
            if n_solved:
                # one bump per task group, not per placement
                _tm.incr("nomad.scheduler.placements_tpu", n_solved)
        return fallback

    def _append_solved_alloc(self, sp, deployment_id: str) -> None:
        """One solved placement as an allocation. Its metrics are the
        eval's base metric copied for the alloc, with the placement's
        n_yielded and scores."""
        place = sp.place
        resources = sp.resources_prebuilt
        if resources is None:
            resources = AllocatedResources(
                tasks=sp.task_resources,
                shared=sp.alloc_resources
                if sp.alloc_resources is not None
                else AllocatedSharedResources(
                    disk_mb=place.task_group.ephemeral_disk.size_mb))
        metrics = self.ctx.metrics.copy_for_alloc()
        metrics.nodes_evaluated = sp.n_yielded
        metrics.score_node(sp.node.id, "normalized-score", sp.score)
        if sp.preempted_allocs:
            # the component the host records (rank.py
            # PreemptionScoringIterator)
            metrics.score_node(
                sp.node.id, "preemption",
                preemption_score(net_priority(sp.preempted_allocs)))
        self._append_alloc(place, sp.node, resources, metrics,
                           deployment_id, sp.preempted_allocs)

    def _preemption_enabled(self) -> bool:
        cfg = self.state.scheduler_config()
        if cfg is None:
            return False
        sched_type = JOB_TYPE_BATCH if self.batch else JOB_TYPE_SERVICE
        return cfg.preemption_config.is_enabled(sched_type)

    def _queue_blocked_eval(self) -> None:
        """A blocked eval for what could not be placed (upstream:
        generic_sched.go:300)."""
        if self.blocked is not None:
            return
        elig = self.ctx.eligibility()
        blocked = Evaluation(
            id=generate_uuid(),
            namespace=self.eval.namespace,
            priority=self.eval.priority,
            type=self.eval.type,
            triggered_by=TRIGGER_QUEUED_ALLOCS,
            job_id=self.eval.job_id,
            status=EVAL_STATUS_BLOCKED,
            previous_eval=self.eval.id,
            class_eligibility=elig.class_eligibility(),
            escaped_computed_class=elig.has_escaped(),
        )
        self.blocked = blocked
        self.planner.create_eval(blocked)

    def _finish_plan(self) -> bool:
        if self.plan.is_no_op():
            self.plan_result = None
            return True
        result, new_state = self.planner.submit_plan(self.plan)
        self.plan_result = result
        if result is None:
            return False
        # queued allocations less what committed (upstream:
        # generic_sched.go:339 adjustQueuedAllocations)
        for allocs in result.node_allocation.values():
            for alloc in allocs:
                if alloc.task_group in self.queued_allocs:
                    self.queued_allocs[alloc.task_group] -= 1
        full, _expected, _actual = result.full_commit(self.plan)
        if not full:
            if new_state is not None:
                self.state = new_state
            return False
        return True
