"""SystemScheduler: one instance of each task group on every feasible node
(port of nomad_tpu/scheduler/system.py; upstream:
scheduler/scheduler_system.go :31 SystemScheduler, :78 Process, and
system_util.go diffSystemAllocs). With a tpu-* algorithm a task group's
nodes are fit and scored in one system-fit dispatch
(TpuPlacementService.solve_system) on ``device`` (default ``cuda``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..device import DeviceLike, resolve_device
from ..server.telemetry import metrics as _tm
from ..structs import (
    AllocatedResources, AllocatedSharedResources, Allocation, Evaluation,
    Node, Plan, generate_uuid,
    ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_LOST, ALLOC_DESIRED_RUN,
    CONSTRAINT_DISTINCT_PROPERTY, EVAL_STATUS_COMPLETE, EVAL_STATUS_FAILED,
    JOB_TYPE_SYSBATCH, JOB_TYPE_SYSTEM, NODE_STATUS_DOWN,
    SCHED_ALG_TPU_SPREAD,
)
from ..solver.guard import (
    dispatch_allowed, host_fallback_allowed, note_host_fallback,
    note_host_placements, refuse_dispatch)
from .context import EvalContext
from .generic import SetStatusError
from .reconcile import tasks_updated
from .stack import SelectOptions, SystemStack
from .util import progress_made, tainted_nodes

MAX_SYSTEM_SCHEDULE_ATTEMPTS = 5
MAX_SYSBATCH_SCHEDULE_ATTEMPTS = 2


class SystemScheduler:
    """(upstream: scheduler_system.go:31). ``device`` is where the
    placement service dispatches (default ``cuda``)."""

    def __init__(self, state, planner, sysbatch: bool = False, logger=None,
                 device: DeviceLike = None):
        self.state = state
        self.device = device
        self.planner = planner
        self.sysbatch = sysbatch
        self.logger = logger
        self.eval: Optional[Evaluation] = None
        self.job = None
        self.plan: Optional[Plan] = None
        self.plan_result = None
        self.ctx: Optional[EvalContext] = None
        self.stack: Optional[SystemStack] = None
        self.failed_tg_allocs: Dict[str, object] = {}
        self.queued_allocs: Dict[str, int] = {}

    def process(self, evaluation: Evaluation):
        self.eval = evaluation
        limit = (MAX_SYSBATCH_SCHEDULE_ATTEMPTS if self.sysbatch
                 else MAX_SYSTEM_SCHEDULE_ATTEMPTS)
        attempts = 0
        while attempts < limit:
            try:
                done = self._process_once()
            except SetStatusError as e:
                self.planner.update_eval(self._eval_with_status(
                    e.eval_status, str(e)))
                return e
            if done:
                self.planner.update_eval(self._eval_with_status(
                    EVAL_STATUS_COMPLETE, ""))
                return None
            if progress_made(self.plan_result):
                attempts = 0
            else:
                attempts += 1
        err = SetStatusError(f"maximum attempts reached ({limit})")
        self.planner.update_eval(self._eval_with_status(
            EVAL_STATUS_FAILED, str(err)))
        return err

    def _eval_with_status(self, status: str, desc: str) -> Evaluation:
        ev = self.eval.copy()
        ev.status = status
        ev.status_description = desc
        ev.failed_tg_allocs = dict(self.failed_tg_allocs)
        ev.queued_allocations = dict(self.queued_allocs)
        return ev

    def _process_once(self) -> bool:
        self.failed_tg_allocs = {}
        ns, job_id = self.eval.namespace, self.eval.job_id
        self.job = self.state.job_by_id(ns, job_id)

        self.plan = Plan(eval_id=self.eval.id, priority=self.eval.priority,
                         job=self.job)
        self.ctx = EvalContext(self.state, self.plan, self.logger)
        self.stack = SystemStack(self.ctx, self.sysbatch)

        nodes: List[Node] = []
        if self.job is not None and not self.job.stopped():
            self.stack.set_scheduler_configuration(
                self.state.scheduler_config())
            self.stack.set_job(self.job)
            nodes = self.state.ready_nodes_in_pool(self.job.node_pool)
            dcs = set(self.job.datacenters)
            if "*" not in dcs:
                nodes = [n for n in nodes if n.datacenter in dcs]

        existing = self.state.allocs_by_job(ns, job_id)
        tainted = tainted_nodes(self.state, existing)

        self._compute_diff(nodes, existing, tainted)

        if self.plan.is_no_op():
            self.plan_result = None
            return True
        result, new_state = self.planner.submit_plan(self.plan)
        self.plan_result = result
        if result is None:
            return False
        full, _, _ = result.full_commit(self.plan)
        if not full:
            if new_state is not None:
                self.state = new_state
            return False
        return True

    def _compute_diff(self, nodes: List[Node], existing: List[Allocation],
                      tainted: Dict[str, Optional[Node]]) -> None:
        """diffSystemAllocs: per node and task group, place, ignore,
        update or stop (upstream: system_util.go)."""
        job_stopped = self.job is None or self.job.stopped()
        by_node_tg: Dict[tuple, Allocation] = {}
        for a in existing:
            if a.server_terminal_status():
                continue
            if self.sysbatch and a.client_status == ALLOC_CLIENT_COMPLETE:
                continue
            by_node_tg[(a.node_id, a.task_group)] = a

        # Stops: job stopped, node down/deregistered, or drain with a
        # migrate transition. Merely not-ready/ineligible nodes keep their
        # system allocs (upstream: system_util.go:200-202 goto IGNORE).
        for (node_id, tg_name), alloc in list(by_node_tg.items()):
            node = tainted.get(node_id)
            stop_desc = None
            client_status = ""
            if job_stopped:
                stop_desc = "alloc not needed as job is stopped"
            elif node_id in tainted:
                if node is None or node.status == NODE_STATUS_DOWN:
                    stop_desc = "alloc lost since its node is down"
                    client_status = ALLOC_CLIENT_LOST
                elif node.drain and alloc.desired_transition.should_migrate():
                    stop_desc = "alloc is being migrated"
            if stop_desc is not None:
                self.plan.append_stopped_alloc(alloc, stop_desc, client_status)
                del by_node_tg[(node_id, tg_name)]

        if job_stopped:
            return

        for tg in self.job.task_groups:
            placed = 0
            # Pass 1: updates and destructive stops, collecting the nodes
            # that need a fresh placement. Stops land in the plan BEFORE
            # the dense solve packs usage, so the freed capacity is seen
            # (coupling is within-node only; the host's interleaved order
            # is equivalent because placements go to distinct nodes).
            to_place: List[Node] = []
            for node in nodes:
                current = by_node_tg.get((node.id, tg.name))
                if current is not None:
                    if current.job_version == self.job.version:
                        continue  # ignore: up to date
                    if current.job is not None and tasks_updated(
                            current.job, self.job, tg.name):
                        # destructive update
                        self.plan.append_stopped_alloc(
                            current, "alloc not needed due to job update")
                    else:
                        updated = current.copy_skip_job()
                        updated.job = self.job
                        updated.job_version = self.job.version
                        self.plan.append_alloc(updated)
                        continue
                to_place.append(node)

            # Pass 2: one device fit and score over every node (the
            # system form has no sequential dependence), with the host
            # stack per node where the task group is not eligible.
            dense, tpu_alg = self._dense_system(tg, to_place)
            preempt = self._preemption_enabled()
            host_places = 0
            for i, node in enumerate(to_place):
                alloc_metrics = None
                option = None
                if dense is not None:
                    sp = dense[i]
                    if sp.node is not None and sp.task_resources is not None:
                        option = sp
                        # dense selects never touch ctx.metrics: record
                        # the same evaluation trail the host path leaves
                        # (1 candidate node, normalized score)
                        self.ctx.reset()
                        alloc_metrics = self.ctx.metrics.copy()
                        alloc_metrics.nodes_evaluated = 1
                        alloc_metrics.score_node(
                            sp.node.id, "normalized-score", sp.score)
                    elif preempt:
                        # full node + preemption enabled: the eviction
                        # search is host-only -- retry just this node
                        # through the stack with evict on (upstream:
                        # system jobs preempt by default,
                        # PreemptionConfig.SystemSchedulerEnabled)
                        self.stack.set_nodes([node])
                        option = self.stack.select(tg, SelectOptions(
                            alloc_name=f"{self.job.id}.{tg.name}[0]",
                            preempt=True))
                        host_places += option is not None
                else:
                    self.stack.set_nodes([node])
                    option = self.stack.select(tg, SelectOptions(
                        alloc_name=f"{self.job.id}.{tg.name}[0]",
                        preempt=preempt))
                    host_places += option is not None
                if option is None:
                    if tg.name in self.failed_tg_allocs:
                        self.failed_tg_allocs[tg.name].coalesced_failures += 1
                    else:
                        if dense is not None and not preempt:
                            # no host select ran: synthesize the trail
                            self.ctx.reset()
                            m = self.ctx.metrics.copy()
                            m.nodes_evaluated = 1
                            m.exhausted_node(node.id, node.computed_class,
                                             "resources exhausted")
                            self.failed_tg_allocs[tg.name] = m
                        else:
                            self.failed_tg_allocs[tg.name] = \
                                self.ctx.metrics.copy()
                    continue
                resources = AllocatedResources(
                    tasks=dict(option.task_resources),
                    shared=option.alloc_resources
                    if option.alloc_resources is not None
                    else AllocatedSharedResources(
                        disk_mb=tg.ephemeral_disk.size_mb))
                alloc = Allocation(
                    id=generate_uuid(),
                    namespace=self.job.namespace,
                    eval_id=self.eval.id,
                    name=f"{self.job.id}.{tg.name}[0]",
                    job_id=self.job.id,
                    job=self.job,
                    job_version=self.job.version,
                    task_group=tg.name,
                    node_id=option.node.id,
                    node_name=option.node.name,
                    allocated_resources=resources,
                    desired_status=ALLOC_DESIRED_RUN,
                    client_status="pending",
                    metrics=(alloc_metrics if alloc_metrics is not None
                             else self.ctx.metrics.copy()),
                )
                if option.preempted_allocs:
                    for p in option.preempted_allocs:
                        self.plan.append_preempted_alloc(p, alloc.id)
                self.plan.append_alloc(alloc)
                placed += 1
            if tpu_alg and host_places:
                note_host_placements(host_places)
            self.queued_allocs[tg.name] = 0

    def _preemption_enabled(self) -> bool:
        """(upstream: PreemptionConfig; system on by default, sysbatch
        off by default)"""
        cfg = self.state.scheduler_config()
        if cfg is None:
            return False
        return cfg.preemption_config.is_enabled(
            JOB_TYPE_SYSBATCH if self.sysbatch else JOB_TYPE_SYSTEM)

    def _dense_system(self, tg, to_place: List[Node]):
        """(TpuPlacements aligned with ``to_place``, or None for the host
        stack; whether a tpu-* algorithm is on for the task group).
        Left to the host: distinct_property (its counts couple nodes
        through the plan) and device asks. Resolving the device raises
        without a card. An init probe that is down or an open breaker
        sends the task group to the host stack on the CPU, counted as a
        host fallback; on a card it raises DispatchFailed("refused")."""
        if not to_place:
            return None, False
        cfg = self.state.scheduler_config()
        if cfg is None or not cfg.uses_tpu():
            return None, False
        device = resolve_device(self.device)
        if not dispatch_allowed(device):
            if not host_fallback_allowed(device):
                refuse_dispatch(device)
            note_host_fallback()
            return None, False
        from ..solver.service import TpuPlacementService, tg_solver_eligible
        if (not tg_solver_eligible(tg, self.job)
                or any(t.resources.devices for t in tg.tasks)
                or any(c.operand == CONSTRAINT_DISTINCT_PROPERTY
                       for c in list(self.job.constraints)
                       + list(tg.constraints))):
            return None, True
        service = TpuPlacementService(
            self.ctx, self.job, batch_mode=self.sysbatch,
            spread_alg=cfg.scheduler_algorithm == SCHED_ALG_TPU_SPREAD,
            device=self.device)
        solved = service.solve_system(tg, to_place)
        if solved is not None:
            n = sum(1 for sp in solved if sp.node is not None)
            if n:
                _tm.incr("nomad.scheduler.placements_tpu", n)
        return solved, True
