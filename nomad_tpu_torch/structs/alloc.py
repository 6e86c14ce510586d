"""Allocation / Evaluation / Plan / Deployment model (port of
nomad_tpu/structs/alloc.py; upstream: nomad/structs/structs.go
Allocation, AllocMetric, Evaluation, Plan, Deployment,
DesiredTransition).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

from .job import Job
from .resources import AllocatedResources

# Allocation desired statuses (reference: structs.go AllocDesiredStatus*)
ALLOC_DESIRED_RUN = "run"
ALLOC_DESIRED_STOP = "stop"
ALLOC_DESIRED_EVICT = "evict"

# Allocation client statuses (reference: structs.go AllocClientStatus*)
ALLOC_CLIENT_PENDING = "pending"
ALLOC_CLIENT_RUNNING = "running"
ALLOC_CLIENT_COMPLETE = "complete"
ALLOC_CLIENT_FAILED = "failed"
ALLOC_CLIENT_LOST = "lost"
ALLOC_CLIENT_UNKNOWN = "unknown"

# Eval statuses (reference: structs.go EvalStatus*)
EVAL_STATUS_BLOCKED = "blocked"
EVAL_STATUS_PENDING = "pending"
EVAL_STATUS_COMPLETE = "complete"
EVAL_STATUS_FAILED = "failed"
EVAL_STATUS_CANCELLED = "canceled"

# Eval trigger reasons (reference: structs.go EvalTriggerBy*)
TRIGGER_JOB_REGISTER = "job-register"
TRIGGER_JOB_DEREGISTER = "job-deregister"
TRIGGER_PERIODIC_JOB = "periodic-job"
TRIGGER_NODE_DRAIN = "node-drain"
TRIGGER_NODE_UPDATE = "node-update"
TRIGGER_ALLOC_STOP = "alloc-stop"
TRIGGER_SCHEDULED = "scheduled"
TRIGGER_ROLLING_UPDATE = "rolling-update"
TRIGGER_DEPLOYMENT_WATCHER = "deployment-watcher"
TRIGGER_FAILED_FOLLOW_UP = "failed-follow-up"
TRIGGER_MAX_DISCONNECT_TIMEOUT = "max-disconnect-timeout"
TRIGGER_RECONNECT = "reconnect"
TRIGGER_RETRY_FAILED_ALLOC = "alloc-failure"
TRIGGER_QUEUED_ALLOCS = "queued-allocs"
TRIGGER_PREEMPTION = "preemption"
TRIGGER_SCALING = "job-scaling"

CORE_JOB_EVAL_GC = "eval-gc"
CORE_JOB_NODE_GC = "node-gc"
CORE_JOB_JOB_GC = "job-gc"
CORE_JOB_DEPLOYMENT_GC = "deployment-gc"

# Deployment statuses (reference: structs.go DeploymentStatus*)
DEPLOYMENT_STATUS_RUNNING = "running"
DEPLOYMENT_STATUS_PAUSED = "paused"
DEPLOYMENT_STATUS_FAILED = "failed"
DEPLOYMENT_STATUS_SUCCESSFUL = "successful"
DEPLOYMENT_STATUS_CANCELLED = "cancelled"


@dataclass
class RescheduleEvent:
    reschedule_time: float = 0.0
    prev_alloc_id: str = ""
    prev_node_id: str = ""
    delay_s: float = 0.0


@dataclass
class RescheduleTracker:
    events: List[RescheduleEvent] = field(default_factory=list)


# The alloc fields a plan stop/preemption entry carries (Plan._plan_stub).
PLAN_STOP_STUB_FIELDS = ("id", "namespace", "job_id", "task_group",
                         "node_id", "desired_status",
                         "desired_description", "client_status",
                         "followup_eval_id", "preempted_by_allocation")


@dataclass
class DesiredTransition:
    """Server-requested transition flags (reference: structs.DesiredTransition)."""

    migrate: Optional[bool] = None
    reschedule: Optional[bool] = None
    force_reschedule: Optional[bool] = None
    no_shutdown_delay: Optional[bool] = None

    def should_migrate(self) -> bool:
        return bool(self.migrate)

    def should_force_reschedule(self) -> bool:
        return bool(self.force_reschedule)


@dataclass
class AllocMetric:
    """Per-placement explainability record (reference: structs.AllocMetric).

    """

    nodes_evaluated: int = 0
    nodes_filtered: int = 0
    nodes_in_pool: int = 0
    nodes_available: Dict[str, int] = field(default_factory=dict)  # dc -> count
    class_filtered: Dict[str, int] = field(default_factory=dict)
    constraint_filtered: Dict[str, int] = field(default_factory=dict)
    nodes_exhausted: int = 0
    class_exhausted: Dict[str, int] = field(default_factory=dict)
    dimension_exhausted: Dict[str, int] = field(default_factory=dict)
    quota_exhausted: List[str] = field(default_factory=list)
    scores: Dict[str, float] = field(default_factory=dict)  # "node.scorer" -> score
    score_meta: List[dict] = field(default_factory=list)    # ranked top-K nodes
    allocation_time_ns: int = 0
    coalesced_failures: int = 0

    def exhausted_node(self, node_id: str, node_class: str, dimension: str) -> None:
        self.nodes_exhausted += 1
        if node_class:
            self.class_exhausted[node_class] = self.class_exhausted.get(node_class, 0) + 1
        if dimension:
            self.dimension_exhausted[dimension] = self.dimension_exhausted.get(dimension, 0) + 1

    def filter_node(self, node_class: str, constraint: str) -> None:
        self.nodes_filtered += 1
        if node_class:
            self.class_filtered[node_class] = self.class_filtered.get(node_class, 0) + 1
        if constraint:
            self.constraint_filtered[constraint] = self.constraint_filtered.get(constraint, 0) + 1

    def score_node(self, node_id: str, name: str, score: float) -> None:
        self.scores[f"{node_id}.{name}"] = score

    def copy(self) -> "AllocMetric":
        """A copy of every container (each field is a scalar, a flat
        dict, or a list of flat dicts)."""
        return AllocMetric(
            nodes_evaluated=self.nodes_evaluated,
            nodes_filtered=self.nodes_filtered,
            nodes_in_pool=self.nodes_in_pool,
            nodes_available=dict(self.nodes_available),
            class_filtered=dict(self.class_filtered),
            constraint_filtered=dict(self.constraint_filtered),
            nodes_exhausted=self.nodes_exhausted,
            class_exhausted=dict(self.class_exhausted),
            dimension_exhausted=dict(self.dimension_exhausted),
            quota_exhausted=list(self.quota_exhausted),
            scores=dict(self.scores),
            score_meta=[dict(m) for m in self.score_meta],
            allocation_time_ns=self.allocation_time_ns,
            coalesced_failures=self.coalesced_failures)

    def copy_for_alloc(self) -> "AllocMetric":
        """The copy a placed alloc carries: the aggregate containers are
        shared with the eval's base metric (nothing mutates a placed
        alloc's metrics after scheduling), only ``scores`` is fresh."""
        return AllocMetric(
            nodes_evaluated=self.nodes_evaluated,
            nodes_filtered=self.nodes_filtered,
            nodes_in_pool=self.nodes_in_pool,
            nodes_available=self.nodes_available,
            class_filtered=self.class_filtered,
            constraint_filtered=self.constraint_filtered,
            nodes_exhausted=self.nodes_exhausted,
            class_exhausted=self.class_exhausted,
            dimension_exhausted=self.dimension_exhausted,
            quota_exhausted=self.quota_exhausted,
            scores=dict(self.scores),
            score_meta=self.score_meta,
            allocation_time_ns=self.allocation_time_ns,
            coalesced_failures=self.coalesced_failures)


@dataclass
class NetworkStatus:
    interface_name: str = ""
    address: str = ""
    dns: Optional[dict] = None


@dataclass
class Allocation:
    """A placement of one task group instance on one node
    (reference: structs.Allocation)."""

    id: str = ""
    namespace: str = "default"
    eval_id: str = ""
    name: str = ""            # "<job>.<group>[<index>]"
    node_id: str = ""
    node_name: str = ""
    job_id: str = ""
    job: Optional[Job] = None
    task_group: str = ""
    allocated_resources: AllocatedResources = field(default_factory=AllocatedResources)
    metrics: AllocMetric = field(default_factory=AllocMetric)
    desired_status: str = ALLOC_DESIRED_RUN
    desired_description: str = ""
    desired_transition: DesiredTransition = field(default_factory=DesiredTransition)
    client_status: str = ALLOC_CLIENT_PENDING
    client_description: str = ""
    task_states: Dict[str, dict] = field(default_factory=dict)
    deployment_id: str = ""
    deployment_status: Optional["AllocDeploymentStatus"] = None
    reschedule_tracker: Optional[RescheduleTracker] = None
    network_status: Optional[NetworkStatus] = None
    followup_eval_id: str = ""
    previous_allocation: str = ""
    next_allocation: str = ""
    preempted_by_allocation: str = ""
    preempted_allocations: List[str] = field(default_factory=list)
    job_version: int = 0
    client_terminal_time: float = 0.0
    alloc_states: List[dict] = field(default_factory=list)
    signed_identities: Dict[str, str] = field(default_factory=dict)
    create_index: int = 0
    modify_index: int = 0
    alloc_modify_index: int = 0
    create_time: int = 0
    modify_time: int = 0

    # -- status predicates (reference: structs.go Allocation.TerminalStatus etc.)
    def server_terminal_status(self) -> bool:
        return self.desired_status in (ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT)

    def client_terminal_status(self) -> bool:
        return self.client_status in (
            ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED, ALLOC_CLIENT_LOST)

    def terminal_status(self) -> bool:
        return self.server_terminal_status() or self.client_terminal_status()

    def index(self) -> int:
        """The [N] suffix of the alloc name, or -1 if unparseable
        (reference: Allocation.Index never throws)."""
        l = self.name.rfind("[")
        r = self.name.rfind("]")
        if l == -1 or r == -1 or r <= l + 1:
            return -1
        digits = self.name[l + 1:r]
        return int(digits) if digits.isdigit() else -1

    def ran_successfully(self) -> bool:
        return self.client_status == ALLOC_CLIENT_COMPLETE

    def migrate_disk(self) -> bool:
        if self.job is None:
            return False
        tg = self.job.lookup_task_group(self.task_group)
        return tg is not None and tg.ephemeral_disk.migrate

    def copy(self) -> "Allocation":
        import copy as _copy
        return _copy.deepcopy(self)

    def copy_skip_job(self) -> "Allocation":
        """A deep copy sharing the job."""
        job = self.job
        self.job = None
        try:
            c = self.copy()
        finally:
            self.job = job
        c.job = job
        return c


@dataclass
class AllocDeploymentStatus:
    healthy: Optional[bool] = None
    timestamp: float = 0.0
    canary: bool = False
    modify_index: int = 0

    def is_healthy(self) -> bool:
        return bool(self.healthy)

    def is_unhealthy(self) -> bool:
        return self.healthy is not None and not self.healthy


@dataclass
class DeploymentState:
    """Per-task-group deployment progress (reference: structs.DeploymentState)."""

    auto_revert: bool = False
    auto_promote: bool = False
    promoted: bool = False
    placed_canaries: List[str] = field(default_factory=list)
    desired_canaries: int = 0
    desired_total: int = 0
    placed_allocs: int = 0
    healthy_allocs: int = 0
    unhealthy_allocs: int = 0
    progress_deadline_s: float = 600.0
    require_progress_by: float = 0.0


@dataclass
class Deployment:
    """One rollout of one job version (reference: structs.Deployment)."""

    id: str = ""
    namespace: str = "default"
    job_id: str = ""
    job_version: int = 0
    job_modify_index: int = 0
    job_spec_modify_index: int = 0
    job_create_index: int = 0
    is_multiregion: bool = False
    task_groups: Dict[str, DeploymentState] = field(default_factory=dict)
    status: str = DEPLOYMENT_STATUS_RUNNING
    status_description: str = ""
    eval_priority: int = 50
    create_index: int = 0
    modify_index: int = 0
    create_time: int = 0
    modify_time: int = 0

    def active(self) -> bool:
        return self.status in (DEPLOYMENT_STATUS_RUNNING, DEPLOYMENT_STATUS_PAUSED)

    def requires_promotion(self) -> bool:
        for st in self.task_groups.values():
            if st.desired_canaries > 0 and not st.promoted:
                return True
        return False

    def has_auto_promote(self) -> bool:
        if not self.task_groups:
            return False
        return all(st.auto_promote for st in self.task_groups.values()
                   if st.desired_canaries > 0) and self.requires_promotion()


@dataclass
class DeploymentStatusUpdate:
    deployment_id: str = ""
    status: str = ""
    status_description: str = ""


@dataclass
class Evaluation:
    """The unit of scheduler work (reference: structs.Evaluation)."""

    id: str = ""
    namespace: str = "default"
    priority: int = 50
    type: str = "service"
    triggered_by: str = TRIGGER_JOB_REGISTER
    job_id: str = ""
    job_modify_index: int = 0
    node_id: str = ""
    node_modify_index: int = 0
    deployment_id: str = ""
    status: str = EVAL_STATUS_PENDING
    status_description: str = ""
    wait_until: float = 0.0
    next_eval: str = ""
    previous_eval: str = ""
    blocked_eval: str = ""
    related_evals: List[str] = field(default_factory=list)
    failed_tg_allocs: Dict[str, AllocMetric] = field(default_factory=dict)
    class_eligibility: Dict[str, bool] = field(default_factory=dict)
    quota_limit_reached: str = ""
    escaped_computed_class: bool = False
    annotate_plan: bool = False
    queued_allocations: Dict[str, int] = field(default_factory=dict)
    leader_ack: str = ""
    snapshot_index: int = 0
    create_index: int = 0
    modify_index: int = 0
    create_time: int = 0
    modify_time: int = 0

    def terminal_status(self) -> bool:
        return self.status in (EVAL_STATUS_COMPLETE, EVAL_STATUS_FAILED,
                               EVAL_STATUS_CANCELLED)

    def should_enqueue(self) -> bool:
        return self.status == EVAL_STATUS_PENDING

    def should_block(self) -> bool:
        return self.status == EVAL_STATUS_BLOCKED

    def copy(self) -> "Evaluation":
        import copy as _copy
        return _copy.deepcopy(self)


@dataclass
class Plan:
    """A scheduler's proposed state mutation (reference: structs.Plan)."""

    eval_id: str = ""
    eval_token: str = ""
    priority: int = 50
    job: Optional[Job] = None
    all_at_once: bool = False
    node_update: Dict[str, List[Allocation]] = field(default_factory=dict)
    node_allocation: Dict[str, List[Allocation]] = field(default_factory=dict)
    node_preemptions: Dict[str, List[Allocation]] = field(default_factory=dict)
    deployment: Optional[Deployment] = None
    deployment_updates: List[DeploymentStatusUpdate] = field(default_factory=list)
    annotations: Optional[dict] = None
    snapshot_index: int = 0

    @staticmethod
    def _plan_stub(alloc: Allocation) -> Allocation:
        """Narrow copy for plan stop/preemption entries: the stub fields,
        read by id-keyed set membership in ProposedAllocs and by the
        plan applier."""
        stub = Allocation(
            eval_id=alloc.eval_id, name=alloc.name,
            job_version=alloc.job_version,
            desired_transition=replace(alloc.desired_transition))
        for f in PLAN_STOP_STUB_FIELDS:
            setattr(stub, f, getattr(alloc, f))
        return stub

    def append_stopped_alloc(self, alloc: Allocation, desc: str,
                             client_status: str = "",
                             followup_eval_id: str = "") -> None:
        """Mark an existing alloc stopped (reference: Plan.AppendStoppedAlloc)."""
        new = self._plan_stub(alloc)
        new.desired_status = ALLOC_DESIRED_STOP
        new.desired_description = desc
        if client_status:
            new.client_status = client_status
        if followup_eval_id:
            new.followup_eval_id = followup_eval_id
        self.node_update.setdefault(alloc.node_id, []).append(new)

    def append_alloc(self, alloc: Allocation) -> None:
        self.node_allocation.setdefault(alloc.node_id, []).append(alloc)

    def append_preempted_alloc(self, alloc: Allocation, preempting_id: str) -> None:
        new = self._plan_stub(alloc)
        new.desired_status = ALLOC_DESIRED_EVICT
        new.preempted_by_allocation = preempting_id
        new.desired_description = (
            f"Preempted by alloc ID {preempting_id}")
        self.node_preemptions.setdefault(alloc.node_id, []).append(new)

    def is_no_op(self) -> bool:
        return (not self.node_update and not self.node_allocation
                and not self.deployment and not self.deployment_updates)


@dataclass
class PlanResult:
    """What the plan applier committed (reference: structs.PlanResult)."""

    node_update: Dict[str, List[Allocation]] = field(default_factory=dict)
    node_allocation: Dict[str, List[Allocation]] = field(default_factory=dict)
    node_preemptions: Dict[str, List[Allocation]] = field(default_factory=dict)
    deployment: Optional[Deployment] = None
    deployment_updates: List[DeploymentStatusUpdate] = field(default_factory=list)
    refresh_index: int = 0
    alloc_index: int = 0
    rejected_nodes: List[str] = field(default_factory=list)

    def full_commit(self, plan: Plan):
        """(fully committed?, expected, actual) placements
        (reference: PlanResult.FullCommit)."""
        expected = sum(len(v) for v in plan.node_allocation.values())
        actual = sum(len(v) for v in self.node_allocation.values())
        return expected == actual, expected, actual

    def is_no_op(self) -> bool:
        return (not self.node_update and not self.node_allocation
                and not self.deployment_updates and self.deployment is None)
