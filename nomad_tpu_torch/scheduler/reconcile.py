"""Allocation reconciler: the diff of desired and actual state (port of
nomad_tpu/scheduler/reconcile.py; upstream: scheduler/reconcile.go
NewAllocReconciler :201, Compute :239, computeGroup :434,
computePlacements :798, computeStop :1029, and reconcile_util.go's
allocSet filters and allocNameIndex). Canaries, rolling updates,
reschedules and the disconnect and reconnect paths follow the same
structure; a disconnected alloc is marked unknown until
max_client_disconnect (upstream: reconcile.go:1157, :1301).
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..structs import (
    Allocation, Deployment, DeploymentState, DeploymentStatusUpdate,
    Evaluation, Job, Node, TaskGroup, generate_uuid,
    ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED, ALLOC_CLIENT_LOST,
    ALLOC_CLIENT_PENDING, ALLOC_CLIENT_RUNNING, ALLOC_CLIENT_UNKNOWN,
    DEPLOYMENT_STATUS_CANCELLED, DEPLOYMENT_STATUS_RUNNING,
    DEPLOYMENT_STATUS_SUCCESSFUL, EVAL_STATUS_PENDING, JOB_TYPE_SERVICE,
    NODE_STATUS_DISCONNECTED, NODE_STATUS_DOWN,
    TRIGGER_FAILED_FOLLOW_UP, TRIGGER_MAX_DISCONNECT_TIMEOUT,
)

# Descriptions used on stopped allocs (upstream: reconcile.go consts)
ALLOC_NOT_NEEDED = "alloc not needed due to job update"
ALLOC_RESCHEDULED = "alloc was rescheduled because it failed"
ALLOC_LOST = "alloc is lost since its node is down"
ALLOC_UNKNOWN = "alloc is unknown since its node is disconnected"
ALLOC_MIGRATING = "alloc is being migrated"


@dataclass
class AllocPlaceResult:
    """One placement ask (upstream: reconcile.go allocPlaceResult)."""

    name: str = ""
    canary: bool = False
    task_group: Optional[TaskGroup] = None
    previous_alloc: Optional[Allocation] = None
    reschedule: bool = False
    previous_lost: bool = False
    downgrade_non_canary: bool = False
    min_job_version: int = 0


@dataclass
class AllocStopResult:
    alloc: Allocation = None
    client_status: str = ""
    status_description: str = ""
    followup_eval_id: str = ""


@dataclass
class AllocDestructiveResult:
    place_name: str = ""
    place_task_group: Optional[TaskGroup] = None
    stop_alloc: Allocation = None
    stop_status_description: str = ""


@dataclass
class DesiredUpdates:
    """Per-TG summary for eval annotations (upstream: structs.DesiredUpdates)."""

    ignore: int = 0
    place: int = 0
    migrate: int = 0
    stop: int = 0
    in_place_update: int = 0
    destructive_update: int = 0
    canary: int = 0
    preemptions: int = 0
    reschedule_now: int = 0
    reschedule_later: int = 0
    disconnect_updates: int = 0
    reconnect_updates: int = 0


@dataclass
class ReconcileResults:
    """(upstream: reconcile.go reconcileResults)"""

    place: List[AllocPlaceResult] = field(default_factory=list)
    destructive_update: List[AllocDestructiveResult] = field(default_factory=list)
    inplace_update: List[Allocation] = field(default_factory=list)
    stop: List[AllocStopResult] = field(default_factory=list)
    disconnect_updates: Dict[str, Allocation] = field(default_factory=dict)
    reconnect_updates: Dict[str, Allocation] = field(default_factory=dict)
    desired_tg_updates: Dict[str, DesiredUpdates] = field(default_factory=dict)
    desired_followup_evals: Dict[str, List[Evaluation]] = field(default_factory=dict)
    deployment: Optional[Deployment] = None
    deployment_updates: List[DeploymentStatusUpdate] = field(default_factory=list)


def tasks_updated(job_a: Job, job_b: Job, tg_name: str) -> bool:
    """Would moving from job_a to job_b require a destructive update?
    (upstream: util.go:217 tasksUpdated)"""
    a = job_a.lookup_task_group(tg_name)
    b = job_b.lookup_task_group(tg_name)
    if a is None or b is None:
        return True
    if len(a.tasks) != len(b.tasks):
        return True
    if (a.ephemeral_disk.size_mb != b.ephemeral_disk.size_mb
            or a.ephemeral_disk.sticky != b.ephemeral_disk.sticky
            or a.ephemeral_disk.migrate != b.ephemeral_disk.migrate):
        return True
    if _networks_updated(a.networks, b.networks):
        return True
    if {k: (v.source, v.read_only, v.type) for k, v in a.volumes.items()} != \
       {k: (v.source, v.read_only, v.type) for k, v in b.volumes.items()}:
        return True
    for ta in a.tasks:
        tb = b.lookup_task(ta.name)
        if tb is None:
            return True
        if (ta.driver != tb.driver or ta.user != tb.user
                or ta.config != tb.config or ta.env != tb.env
                or ta.artifacts != tb.artifacts
                or ta.templates != tb.templates
                or ta.vault != tb.vault or ta.meta != tb.meta
                or ta.kind != tb.kind or ta.leader != tb.leader):
            return True
        ra, rb = ta.resources, tb.resources
        if (ra.cpu != rb.cpu or ra.memory_mb != rb.memory_mb
                or ra.memory_max_mb != rb.memory_max_mb
                or ra.cores != rb.cores
                or _networks_updated(ra.networks, rb.networks)
                or [(d.name, d.count) for d in ra.devices]
                != [(d.name, d.count) for d in rb.devices]):
            return True
    return False


def _networks_updated(na, nb) -> bool:
    if len(na) != len(nb):
        return True
    for x, y in zip(na, nb):
        if x.mode != y.mode:
            return True
        if ([(p.label, p.value, p.to, p.host_network) for p in x.reserved_ports]
                != [(p.label, p.value, p.to, p.host_network) for p in y.reserved_ports]):
            return True
        if ([(p.label, p.to, p.host_network) for p in x.dynamic_ports]
                != [(p.label, p.to, p.host_network) for p in y.dynamic_ports]):
            return True
    return False


class AllocNameIndex:
    """Tracks which alloc name indexes [0, count) are in use so replacements
    reuse names (upstream: reconcile_util.go allocNameIndex)."""

    def __init__(self, job_id: str, tg_name: str, count: int,
                 in_use: List[Allocation]):
        self.job_id = job_id
        self.tg_name = tg_name
        self.count = count
        self.b: Set[int] = set()
        self.duplicates: List[int] = []
        seen: Set[int] = set()
        for a in in_use:
            idx = a.index()
            if idx < 0:
                continue
            if idx in seen:
                self.duplicates.append(idx)
            seen.add(idx)
            self.b.add(idx)

    def has(self, idx: int) -> bool:
        return idx in self.b

    def unset_highest(self, n: int) -> Set[int]:
        """Return the n highest indexes in use (candidates for stopping)."""
        out = set(sorted(self.b, reverse=True)[:n])
        return out

    def next_n(self, n: int) -> List[str]:
        """The next n unused names (upstream: allocNameIndex.Next)."""
        out = []
        idx = 0
        picked = 0
        while picked < n:
            if idx not in self.b:
                out.append(f"{self.job_id}.{self.tg_name}[{idx}]")
                self.b.add(idx)
                picked += 1
            idx += 1
        return out


def _filter_by_terminal(allocs: List[Allocation]) -> List[Allocation]:
    return [a for a in allocs if not a.server_terminal_status()]


def reschedule_eligible(policy, alloc: Allocation, now: float,
                        is_batch: bool) -> Tuple[bool, float]:
    """Can this failed alloc be rescheduled, and if so when?
    Returns (eligible, wait_until_unix; 0 for now)
    (upstream: structs.go Allocation.NextRescheduleTime +
    reconcile_util.go updateByReschedulable)."""
    if policy is None:
        return False, 0.0
    if alloc.desired_transition.should_force_reschedule():
        return True, 0.0
    attempts = 0
    last_reschedule = 0.0
    if alloc.reschedule_tracker is not None:
        events = alloc.reschedule_tracker.events
        if policy.unlimited:
            attempts = len(events)
        else:
            window_start = now - policy.interval_s
            attempts = sum(1 for e in events
                           if e.reschedule_time >= window_start)
        if events:
            last_reschedule = events[-1].reschedule_time
    if not policy.unlimited and attempts >= policy.attempts:
        return False, 0.0
    delay = _reschedule_delay(policy, attempts)
    # the delay runs from the failure time (now when it is unknown)
    wait_until = (alloc.client_terminal_time or now) + delay
    if wait_until <= now:
        return True, 0.0
    return True, wait_until


def _reschedule_delay(policy, attempts: int) -> float:
    base = policy.delay_s
    if attempts == 0:
        return base
    if policy.delay_function == "constant":
        return base
    if policy.delay_function == "exponential":
        d = base * (2 ** attempts)
    elif policy.delay_function == "fibonacci":
        a, b = base, base
        for _ in range(attempts):
            a, b = b, a + b
        d = a
    else:
        d = base
    return min(d, policy.max_delay_s or d)


class AllocReconciler:
    """(upstream: reconcile.go:201)"""

    def __init__(self, batch: bool, job_id: str, job: Optional[Job],
                 deployment: Optional[Deployment],
                 existing_allocs: List[Allocation],
                 tainted_nodes: Dict[str, Optional[Node]],
                 eval_id: str, eval_priority: int,
                 supports_disconnected_clients: bool = True,
                 now: Optional[float] = None):
        self.batch = batch
        self.job_id = job_id
        self.job = job
        self.deployment = deployment
        self.existing = existing_allocs
        self.tainted = tainted_nodes
        self.eval_id = eval_id
        self.eval_priority = eval_priority
        self.supports_disconnected = supports_disconnected_clients
        self.now = now if now is not None else _time.time()
        self.job_stopped = job is None or job.stopped()
        self.deployment_paused = False
        self.deployment_failed = False
        if deployment is not None:
            self.deployment_paused = deployment.status == "paused"
            self.deployment_failed = deployment.status == "failed"
        self.result = ReconcileResults()

    # ------------------------------------------------------------------
    def compute(self) -> ReconcileResults:
        """(upstream: reconcile.go:239 Compute)"""
        by_tg: Dict[str, List[Allocation]] = {}
        for a in self.existing:
            by_tg.setdefault(a.task_group, []).append(a)

        if self.job_stopped:
            self._handle_stop_all()
            return self.result

        # cancel deployments for older job versions
        self._cancel_unneeded_deployments()

        deployment_complete = True
        for tg in self.job.task_groups:
            allocs = by_tg.pop(tg.name, [])
            complete = self._compute_group(tg, allocs)
            deployment_complete = deployment_complete and complete

        # allocs for TGs that no longer exist -> stop
        for tg_name, allocs in by_tg.items():
            du = self.result.desired_tg_updates.setdefault(
                tg_name, DesiredUpdates())
            for a in _filter_by_terminal(allocs):
                self.result.stop.append(AllocStopResult(
                    alloc=a, status_description=ALLOC_NOT_NEEDED))
                du.stop += 1

        self._finalize_deployment(deployment_complete)
        return self.result

    # ------------------------------------------------------------------
    def _handle_stop_all(self) -> None:
        for a in _filter_by_terminal(self.existing):
            du = self.result.desired_tg_updates.setdefault(
                a.task_group, DesiredUpdates())
            if a.client_terminal_status():
                continue
            self.result.stop.append(AllocStopResult(
                alloc=a, status_description="alloc not needed as job is stopped"))
            du.stop += 1
        if self.deployment is not None and self.deployment.active():
            self.result.deployment_updates.append(DeploymentStatusUpdate(
                deployment_id=self.deployment.id,
                status=DEPLOYMENT_STATUS_CANCELLED,
                status_description="Cancelled because job is stopped"))

    def _cancel_unneeded_deployments(self) -> None:
        d = self.deployment
        if d is None:
            return
        if d.job_version < self.job.version and d.active():
            self.result.deployment_updates.append(DeploymentStatusUpdate(
                deployment_id=d.id,
                status=DEPLOYMENT_STATUS_CANCELLED,
                status_description="Cancelled due to newer version of job"))
            self.deployment = None
        elif not d.active():
            self.deployment = None

    # ------------------------------------------------------------------
    def _compute_group(self, tg: TaskGroup, all_allocs: List[Allocation]) -> bool:
        du = self.result.desired_tg_updates.setdefault(tg.name, DesiredUpdates())
        allocs = _filter_by_terminal(all_allocs)

        # Partition by node state (upstream: reconcile_util.go filterByTainted)
        untainted: List[Allocation] = []
        migrate: List[Allocation] = []
        lost: List[Allocation] = []
        disconnecting: List[Allocation] = []
        reconnecting: List[Allocation] = []
        for a in allocs:
            node = self.tainted.get(a.node_id)
            if a.node_id in self.tainted:
                if node is None or node.status == NODE_STATUS_DOWN:
                    # Down or deregistered: running allocs are lost (the
                    # disconnect grace path requires NODE_STATUS_DISCONNECTED,
                    # handled in the next branch).
                    if a.client_status in (ALLOC_CLIENT_RUNNING,
                                           ALLOC_CLIENT_PENDING):
                        lost.append(a)
                    else:
                        untainted.append(a)
                elif node is not None and node.status == NODE_STATUS_DISCONNECTED:
                    if a.client_status in (ALLOC_CLIENT_RUNNING,
                                           ALLOC_CLIENT_PENDING):
                        if (tg.max_client_disconnect_s is not None
                                and self.supports_disconnected):
                            disconnecting.append(a)
                        else:
                            lost.append(a)
                    else:
                        untainted.append(a)
                elif node is not None and node.drain:
                    if a.client_status == ALLOC_CLIENT_UNKNOWN:
                        untainted.append(a)
                    elif a.desired_transition.should_migrate():
                        migrate.append(a)
                    else:
                        untainted.append(a)
                else:
                    untainted.append(a)
            else:
                if (a.client_status == ALLOC_CLIENT_UNKNOWN
                        and a.node_id not in self.tainted):
                    # node is back -> reconnect path
                    reconnecting.append(a)
                elif a.desired_transition.should_migrate():
                    # operator-requested move on a HEALTHY node
                    # (upstream: alloc stop -> DesiredTransition.Migrate;
                    # filterByTainted migrates these regardless of taint)
                    migrate.append(a)
                else:
                    untainted.append(a)

        # Failed allocs eligible for reschedule (upstream:
        # reconcile_util.go filterByRescheduleable)
        reschedule_now: List[Allocation] = []
        reschedule_later: List[Tuple[Allocation, float]] = []
        still_untainted: List[Allocation] = []
        batch_complete: List[Allocation] = []
        for a in untainted:
            if self.batch:
                failed = a.client_status == ALLOC_CLIENT_FAILED
                succeeded = a.client_status == ALLOC_CLIENT_COMPLETE
                if succeeded:
                    # Completed batch allocs keep their name slot; they are
                    # never replaced (upstream: reconcile_util.go
                    # filterByRescheduleable batch handling).
                    du.ignore += 1
                    batch_complete.append(a)
                    continue
                if not failed:
                    still_untainted.append(a)
                    continue
            else:
                if a.client_status != ALLOC_CLIENT_FAILED:
                    still_untainted.append(a)
                    continue
            policy = tg.reschedule_policy
            ok, wait_until = reschedule_eligible(policy, a, self.now, self.batch)
            if ok and wait_until == 0.0:
                reschedule_now.append(a)
            elif ok:
                reschedule_later.append((a, wait_until))
                still_untainted.append(a)
            else:
                # Failed and not rescheduleable: the alloc keeps its name
                # slot so NO replacement is placed (upstream:
                # reconcile_util.go:429-431 keeps it in untainted).
                du.ignore += 1
                still_untainted.append(a)
        untainted = still_untainted

        # Disconnecting allocs -> mark unknown + followup eval at deadline
        if disconnecting:
            timeout_evals = self._create_timeout_evals(tg, disconnecting)
            for a, ev in timeout_evals:
                updated = a.copy_skip_job()
                updated.client_status = ALLOC_CLIENT_UNKNOWN
                updated.client_description = ALLOC_UNKNOWN
                updated.followup_eval_id = ev.id
                self.result.disconnect_updates[updated.id] = updated
                du.disconnect_updates += 1
            untainted.extend(disconnecting)

        # Reconnecting allocs -> pick up again, stop duplicates
        if reconnecting:
            for a in reconnecting:
                updated = a.copy_skip_job()
                updated.client_status = ALLOC_CLIENT_RUNNING
                self.result.reconnect_updates[updated.id] = updated
                du.reconnect_updates += 1
            untainted.extend(reconnecting)

        # Canary separation (upstream: reconcile.go cancelUnneededCanaries
        # runs BEFORE the shrink): while the deployment is unpromoted,
        # canary allocs live OUTSIDE the count -- they must not trigger
        # the excess-shrink of old-version allocs, and the canary gate
        # below owns their placement/replacement entirely.
        update = tg.update or (self.job.update if self.job else None)
        canaries_desired = (update.canary
                            if update is not None and not update.is_empty()
                            else 0)
        dep_state = (self.deployment.task_groups.get(tg.name)
                     if self.deployment is not None else None)
        promoted = bool(dep_state.promoted) if dep_state is not None \
            else False
        canary_live: List[Allocation] = []
        canary_lost: List[Allocation] = []
        if canaries_desired and not promoted and self.deployment is not None:
            def is_canary(a):
                return (a.deployment_status is not None
                        and a.deployment_status.canary
                        and a.deployment_id == self.deployment.id
                        and a.job_version == self.job.version)

            keep = []
            for a in untainted:
                (canary_live if is_canary(a) else keep).append(a)
            untainted = keep
            keep = []
            for a in migrate:
                # a migrating canary is replaced via the gate, not the
                # generic migrate path (which would drop the flag)
                (canary_lost if is_canary(a) else keep).append(a)
            migrate = keep
            keep = []
            for a in lost:
                (canary_lost if is_canary(a) else keep).append(a)
            lost = keep

        # Determine stops for count shrink; name index over live allocs
        # (+ completed batch allocs, whose names stay reserved)
        live = untainted + migrate
        name_index = AllocNameIndex(self.job_id, tg.name, tg.count,
                                    live + batch_complete)

        n_live = len(untainted) + len(migrate)
        if n_live > tg.count:
            excess = n_live - tg.count
            # OLD-version allocs shrink first: after a canary promotion
            # the surviving canaries ARE the new version and the excess
            # is exactly the old allocs they replace -- index-order alone
            # could stop a canary instead (duplicate canary indexes)
            old_first = sorted(
                (a for a in untainted
                 if a.job_version != self.job.version),
                key=lambda a: -a.index())[:excess]
            stop_ids = {a.id for a in old_first}
            new_untainted = []
            for a in untainted:
                if a.id in stop_ids:
                    self.result.stop.append(AllocStopResult(
                        alloc=a, status_description=ALLOC_NOT_NEEDED))
                    du.stop += 1
                    name_index.b.discard(a.index())
                else:
                    new_untainted.append(a)
            untainted = new_untainted
            excess -= len(stop_ids)
            if excess > 0:
                remove_idx = name_index.unset_highest(excess)
                removed = 0
                new_untainted = []
                for a in untainted:
                    if removed < excess and a.index() in remove_idx:
                        self.result.stop.append(AllocStopResult(
                            alloc=a, status_description=ALLOC_NOT_NEEDED))
                        du.stop += 1
                        name_index.b.discard(a.index())
                        removed += 1
                    else:
                        new_untainted.append(a)
                untainted = new_untainted

        # In-place vs destructive updates for allocs on old job versions
        inplace: List[Allocation] = []
        destructive: List[Allocation] = []
        ignore: List[Allocation] = []
        for a in untainted:
            if a.job_version == self.job.version:
                ignore.append(a)
                continue
            if a.job is not None and tasks_updated(a.job, self.job, tg.name):
                destructive.append(a)
            else:
                inplace.append(a)
        du.ignore += len(ignore)
        du.in_place_update += len(inplace)
        for a in inplace:
            updated = a.copy_skip_job()
            updated.job = self.job
            updated.job_version = self.job.version
            self.result.inplace_update.append(updated)

        # Canary gate (upstream: reconcile.go computeCanaries): with
        # update.canary > 0 and an unpromoted deployment, destructive
        # updates are BLOCKED; up to `canary` new-version allocs place
        # ALONGSIDE the old ones. Lost/migrating canaries stop and are
        # re-placed HERE (fresh canary indexes, upstream
        # NextCanaries) so replacements keep the canary marking. After
        # promotion the surviving canaries count toward the new version,
        # so an equal number of old allocs stop outright and the rest
        # roll through the max_parallel gate.
        # update-needed count BEFORE any gating: completion must reflect
        # outstanding work, not what this round deferred
        destructive_total = len(destructive)
        # the gate applies even before the deployment object exists (the
        # FIRST eval of a canary update creates it via du.canary)
        if canaries_desired and not promoted and \
                (destructive or canary_live or canary_lost):
            for a in canary_lost:
                du.stop += 1
                self.result.stop.append(AllocStopResult(
                    alloc=a, client_status=ALLOC_CLIENT_LOST,
                    status_description=ALLOC_LOST))
            canary_missing = canaries_desired - len(canary_live)
            used_idx = {a.index() for a in canary_live}
            next_idx = 0
            for _ in range(max(0, canary_missing)):
                while next_idx in used_idx:
                    next_idx += 1
                used_idx.add(next_idx)
                du.canary += 1
                self.result.place.append(AllocPlaceResult(
                    name=f"{self.job_id}.{tg.name}[{next_idx}]",
                    task_group=tg, canary=True))
            du.ignore += len(destructive) + len(canary_live)
            destructive = []
        # post-promotion no special stop pass is needed: promoted
        # canaries rejoin `untainted` as current-version allocs and the
        # old-first count shrink above retires the old allocs they
        # replaced; the remaining old allocs roll via max_parallel

        # Rolling-update gate: with an update strategy, at most max_parallel
        # destructive updates per round; in-flight (placed-but-unhealthy)
        # deployment allocs consume slots (upstream: reconcile.go
        # computeUpdates + getDeploymentLimit).
        if destructive and update is not None and not update.is_empty():
            in_flight = 0
            if self.deployment is not None:
                st = self.deployment.task_groups.get(tg.name)
                if st is not None:
                    in_flight = max(0, st.placed_allocs - st.healthy_allocs
                                    - st.unhealthy_allocs)
            limit = max(0, update.max_parallel - in_flight)
            deferred = destructive[limit:]
            destructive = destructive[:limit]
            du.ignore += len(deferred)
        for a in destructive:
            du.destructive_update += 1
            self.result.destructive_update.append(AllocDestructiveResult(
                place_name=a.name, place_task_group=tg, stop_alloc=a,
                stop_status_description=ALLOC_NOT_NEEDED))

        # Migrating allocs: stop + replace elsewhere
        for a in migrate:
            du.migrate += 1
            self.result.stop.append(AllocStopResult(
                alloc=a, status_description=ALLOC_MIGRATING,
                client_status=ALLOC_CLIENT_COMPLETE
                if self.batch else ""))
            name_index.b.discard(a.index())
            self.result.place.append(AllocPlaceResult(
                name=a.name, task_group=tg, previous_alloc=a,
                reschedule=False))
            name_index.b.add(a.index())

        # Lost allocs: stop (client lost) + replace
        for a in lost:
            du.stop += 1
            self.result.stop.append(AllocStopResult(
                alloc=a, client_status=ALLOC_CLIENT_LOST,
                status_description=ALLOC_LOST))
            if not tg.prevent_reschedule_on_lost:
                self.result.place.append(AllocPlaceResult(
                    name=a.name, task_group=tg, previous_alloc=a,
                    reschedule=False, previous_lost=True))
                du.place += 1

        # Reschedule-now placements (replacement keeps the name)
        for a in reschedule_now:
            du.reschedule_now += 1
            self.result.stop.append(AllocStopResult(
                alloc=a, status_description=ALLOC_RESCHEDULED))
            self.result.place.append(AllocPlaceResult(
                name=a.name, task_group=tg, previous_alloc=a,
                reschedule=True))

        # Reschedule-later -> followup evals with wait_until
        if reschedule_later:
            evals = self._create_followup_evals(tg, reschedule_later)
            self.result.desired_followup_evals.setdefault(
                tg.name, []).extend(evals)
            du.reschedule_later += len(reschedule_later)

        # New placements to reach desired count
        existing_n = (len(untainted) + len(migrate) + len(batch_complete)
                      + len([a for a in lost
                             if not tg.prevent_reschedule_on_lost])
                      + len(reschedule_now))
        missing = max(0, tg.count - existing_n)
        if missing > 0:
            # the names the lost and rescheduled allocs' replacements
            # keep are taken (upstream: reconcile.go builds the name
            # index over untainted, migrate, rescheduleNow and lost);
            # the reference's index over the live allocs alone hands
            # such a name to a missing placement too (ROADMAP Queue 3)
            for a in lost + reschedule_now:
                if a in lost and tg.prevent_reschedule_on_lost:
                    continue
                name_index.b.add(a.index())
            for name in name_index.next_n(missing):
                self.result.place.append(AllocPlaceResult(
                    name=name, task_group=tg))
                du.place += 1

        # Deployment bookkeeping (service jobs with update strategy)
        complete = destructive_total == 0 and not migrate and missing == 0
        self._update_deployment_for_group(tg, du, complete)
        return complete

    # ------------------------------------------------------------------
    def _create_followup_evals(self, tg: TaskGroup,
                               later: List[Tuple[Allocation, float]]
                               ) -> List[Evaluation]:
        """Batch failed allocs by wait time into delayed evals
        (upstream: reconcile.go createRescheduleLaterEvals)."""
        evals = []
        by_time: Dict[float, List[Allocation]] = {}
        for a, t in later:
            by_time.setdefault(t, []).append(a)
        for t, allocs in sorted(by_time.items()):
            ev = Evaluation(
                id=generate_uuid(),
                namespace=self.job.namespace,
                priority=self.eval_priority,
                type=self.job.type,
                triggered_by=TRIGGER_FAILED_FOLLOW_UP,
                job_id=self.job.id,
                status=EVAL_STATUS_PENDING,
                wait_until=t,
            )
            evals.append(ev)
            for a in allocs:
                updated = a.copy_skip_job()
                updated.followup_eval_id = ev.id
                self.result.disconnect_updates.setdefault(
                    "_followup_" + updated.id, updated)
        return evals

    def _create_timeout_evals(self, tg: TaskGroup,
                              disconnecting: List[Allocation]):
        out = []
        deadline = self.now + (tg.max_client_disconnect_s or 0.0)
        ev = Evaluation(
            id=generate_uuid(),
            namespace=self.job.namespace,
            priority=self.eval_priority,
            type=self.job.type,
            triggered_by=TRIGGER_MAX_DISCONNECT_TIMEOUT,
            job_id=self.job.id,
            status=EVAL_STATUS_PENDING,
            wait_until=deadline,
        )
        self.result.desired_followup_evals.setdefault(tg.name, []).append(ev)
        for a in disconnecting:
            out.append((a, ev))
        return out

    # ------------------------------------------------------------------
    def _update_deployment_for_group(self, tg: TaskGroup, du: DesiredUpdates,
                                     complete: bool) -> None:
        if self.batch or self.job.type != JOB_TYPE_SERVICE:
            return
        update = tg.update or self.job.update
        if update is None or update.is_empty():
            return
        if self.deployment_failed or self.deployment_paused:
            return
        # Create a deployment when the job version has no active deployment
        # and there is work to do (upstream: reconcile.go createDeployment)
        work = (du.place or du.destructive_update or du.canary)
        if self.deployment is None and work:
            self.deployment = Deployment(
                id=generate_uuid(),
                namespace=self.job.namespace,
                job_id=self.job.id,
                job_version=self.job.version,
                job_create_index=self.job.create_index,
                job_modify_index=self.job.job_modify_index,
                status=DEPLOYMENT_STATUS_RUNNING,
                status_description="Deployment is running",
                eval_priority=self.eval_priority,
            )
            self.result.deployment = self.deployment
        if self.deployment is not None and \
                self.deployment.job_version == self.job.version:
            st = self.deployment.task_groups.get(tg.name)
            if st is None:
                st = DeploymentState(
                    auto_revert=update.auto_revert,
                    auto_promote=update.auto_promote,
                    progress_deadline_s=update.progress_deadline_s,
                    desired_total=tg.count,
                    desired_canaries=update.canary,
                )
                self.deployment.task_groups[tg.name] = st

    def _finalize_deployment(self, deployment_complete: bool) -> None:
        d = self.deployment
        if d is None:
            return
        if deployment_complete and d.status == DEPLOYMENT_STATUS_RUNNING:
            healthy = all(
                st.healthy_allocs >= st.desired_total
                for st in d.task_groups.values()) if d.task_groups else False
            if healthy and not d.requires_promotion():
                self.result.deployment_updates.append(DeploymentStatusUpdate(
                    deployment_id=d.id,
                    status=DEPLOYMENT_STATUS_SUCCESSFUL,
                    status_description="Deployment completed successfully"))
