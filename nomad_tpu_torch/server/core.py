"""The server's main path (port of the main path of
nomad_tpu/server/core.py Server; upstream: nomad/server.go NewServer
:326, leader.go establishLeadership :357, node_endpoint.go Register :99
and UpdateStatus :541, job_endpoint.go Register :96): it wires the store,
the eval broker and blocked evals, the plan applier and the scheduler
workers into one control plane. Single-server topology: this process is
always the leader, and the store's write API is the raft boundary.

A job registered here becomes committed placements:
``register_job`` -> EvalBroker -> BatchWorker -> GenericScheduler ->
SolveBarrier -> the device kernels -> materialize -> Planner (verify,
group commit) -> StateStore.

``device`` is where every scheduler's placement service and every
barrier dispatches: ``cuda`` unless the caller names another, resolved
at ``start``, which raises without a card. The heartbeat deadlines, the
flap tracker, the worker supervisor, GC, periodic dispatch, the
deployment watcher, the drainer, ACLs, the keyring, federation and the
event stream are not part of this module.
"""
from __future__ import annotations

import copy
import gc
import logging
import os
import threading
import time
from typing import List, Optional

from ..device import DeviceLike, resolve_device
from ..state.store import StateStore
from ..structs import (
    Evaluation, Job, Node, NodePool, Plan, PlanResult, generate_uuid,
    ALLOC_CLIENT_FAILED, EVAL_STATUS_BLOCKED, EVAL_STATUS_COMPLETE, EVAL_STATUS_PENDING,
    JOB_STATUS_DEAD, JOB_STATUS_RUNNING, JOB_TYPE_SYSTEM,
    NODE_STATUS_DISCONNECTED, NODE_STATUS_DOWN, NODE_STATUS_READY,
    TRIGGER_JOB_DEREGISTER, TRIGGER_JOB_REGISTER, TRIGGER_NODE_UPDATE,
)
from .admission import AdmissionPipeline
from .broker import BlockedEvals, EvalBroker
from .plan_apply import Planner
from .quality import observatory
from .worker import BatchWorker, Worker

_log = logging.getLogger(__name__)

# how long shutdown waits for each thread it stops
_JOIN_S = 10.0


class Server:
    """(reference core.py:344; upstream: nomad/server.go:105 Server)"""

    def __init__(self, num_workers: Optional[int] = None, state=None,
                 eval_batching: bool = True,
                 batch_width: Optional[int] = None,
                 device: DeviceLike = None):
        self.state = state if state is not None else StateStore()
        self.device = device
        self.broker = EvalBroker()
        self.blocked_evals = BlockedEvals(self.broker)
        self.planner = Planner(self.state)
        # group commit: one blocked-evals sweep per committed plan GROUP
        # (on_plan_result skips its per-plan sweep for those results)
        self.planner.on_batch_commit = self._on_plan_batch_commit
        self.num_workers = num_workers or max(2, (os.cpu_count() or 4))
        # eval coalescing: batch workers running up to batch_width eval
        # threads a batch replace the plain worker pool
        self.eval_batching = eval_batching
        self.batch_width = batch_width or self.num_workers
        self.workers: List[threading.Thread] = []
        self._leader_active = threading.Event()
        self._leader_lock = threading.Lock()

    # ------------------------------------------------------------------
    def start(self) -> None:
        """Boot as the leader (reference :406). Resolves ``device``
        first: with no card this raises, and nothing starts."""
        self.device = resolve_device(self.device)
        # the store pins millions of long-lived objects; the default
        # gen-2 cadence walks that heap every ~7K allocations of
        # scheduler churn, pausing plan verify and commit. 100x fewer
        # full collections, the same gen-0 and gen-1 behavior.
        _, g1, _ = gc.get_threshold()
        gc.set_threshold(700, g1, 1000)
        # the quality observatory binds the store's write hook and the
        # tracer's span sink; a no-op under NOMAD_TPU_TORCH_QUALITY=0
        observatory.attach(self.state)
        self.establish_leadership()

    def establish_leadership(self) -> None:
        """(reference :455; upstream: leader.go:357) Enable the broker
        and blocked evals, restore evals from the store, start the
        workers: two BatchWorkers (one while the LP tier is active: the
        queue coalesces into the widest joint solve), or plain Workers
        without batching."""
        from ..solver.lpq import lpq_active

        with self._leader_lock:
            if self._leader_active.is_set():
                return
            paused = bool(getattr(self.state.scheduler_config(),
                                  "pause_eval_broker", False))
            self.broker.set_enabled(not paused)
            self.blocked_evals.set_enabled(True)
            self._restore_evals()
            if self.eval_batching:
                n = 1 if lpq_active(self.state) else 2
                self.workers = [BatchWorker(self, i, width=self.batch_width)
                                for i in range(n)]
            else:
                self.workers = [Worker(self, i)
                                for i in range(self.num_workers)]
            for w in self.workers:
                w.start()
            self._leader_active.set()

    def revoke_leadership(self) -> None:
        """(reference :513; upstream: leader.go revokeLeadership) Stop the
        workers and wait for them (in-flight evals are nacked back by
        their workers), then disable the broker and blocked evals."""
        with self._leader_lock:
            if not self._leader_active.is_set():
                return
            self._leader_active.clear()
            self._stop_workers()
            self.broker.set_enabled(False)
            self.blocked_evals.set_enabled(False)

    def _stop_workers(self) -> None:
        workers, self.workers = self.workers, []
        for w in workers:
            w.stop()
        deadline = time.monotonic() + _JOIN_S
        for w in workers:
            w.join(max(0.0, deadline - time.monotonic()))
        alive = [w.name for w in workers if w.is_alive()]
        if alive:
            _log.error("workers still running after %.0f s: %s", _JOIN_S,
                       alive)

    def _restore_evals(self, reblock: bool = True) -> None:
        """(reference :532; upstream: leader.go:403 restoreEvals)
        Re-populate the broker and blocked evals from the store. With
        ``reblock`` False a blocked eval is enqueued instead (it blocks
        again if capacity still lacks): a broker resumed after a pause
        may have dropped capacity events meanwhile."""
        for ev in self.state.evals():
            if ev.status == EVAL_STATUS_BLOCKED:
                if reblock:
                    self.blocked_evals.block(ev)
                else:
                    self.broker.enqueue(ev)
            elif ev.should_enqueue():
                self.broker.enqueue(ev)

    def is_leader(self) -> bool:
        return self._leader_active.is_set()

    def shutdown(self) -> None:
        """(reference :579) Stop the workers, the broker's watcher and
        the applier's threads, each waited for within a deadline."""
        observatory.detach(self.state)
        with self._leader_lock:
            self._leader_active.clear()
            self._stop_workers()
        self.broker.set_enabled(False)
        self.broker.shutdown()
        self.planner.shutdown()

    def apply_scheduler_config(self, cfg) -> None:
        """(reference :605) Store and enact a scheduler configuration:
        ``pause_eval_broker`` stops dequeues on the live broker, and a
        resumed broker is re-seeded from the store, its blocked evals
        enqueued."""
        self.state.set_scheduler_config(cfg)
        with self._leader_lock:
            if not self._leader_active.is_set():
                return
            was = self.broker.enabled
            self.broker.set_enabled(not cfg.pause_eval_broker)
            if not was and not cfg.pause_eval_broker:
                self._restore_evals(reblock=False)

    # ------------------------------------------------------------------
    # jobs (upstream: nomad/job_endpoint.go)
    def register_job(self, job: Job) -> Optional[Evaluation]:
        """(reference :761; upstream: job_endpoint.go:96 Register)
        Validate and admit the job (its hooks may add tasks), store it,
        and enqueue its eval; periodic and parameterized jobs get none."""
        self._validate_job(job)
        job, _warnings = AdmissionPipeline(self).apply(job)
        self.state.upsert_job(job)
        if job.is_periodic() or job.is_parameterized():
            return None
        ev = Evaluation(
            id=generate_uuid(), namespace=job.namespace,
            priority=job.priority, type=job.type,
            triggered_by=TRIGGER_JOB_REGISTER, job_id=job.id,
            status=EVAL_STATUS_PENDING)
        self.state.upsert_evals([ev])
        self.broker.enqueue(ev)
        return ev

    def _validate_job(self, job: Job) -> None:
        """(reference :787) Reject malformed user input before anything
        reaches the store."""
        ns = self.state.namespace_by_name(job.namespace)
        if ns is None:
            raise ValueError(f"namespace {job.namespace!r} does not exist")
        # node-pool admission (upstream: job_endpoint_hook_node_pool.go):
        # the pool must exist and the namespace must allow it; an empty
        # pool falls back to the namespace default
        npc = ns.node_pool_configuration
        if (not job.node_pool or job.node_pool == "default") and npc.default:
            job.node_pool = npc.default
        if job.node_pool == "all":
            raise ValueError('jobs may not target the built-in "all" pool')
        if self.state.node_pool_by_name(job.node_pool) is None:
            raise ValueError(f"node pool {job.node_pool!r} does not exist")
        if not npc.allows(job.node_pool):
            raise ValueError(
                f"namespace {job.namespace!r} does not allow node pool "
                f"{job.node_pool!r}")
        for tg in job.task_groups:
            if len(tg.networks) > 1:
                raise ValueError(
                    f"group {tg.name}: only one network block is allowed")
            for task in tg.tasks:
                if task.resources is not None and task.resources.networks:
                    raise ValueError(
                        f"task {task.name}: task-level network blocks are "
                        "not supported; use the group network block")
            sc = tg.scaling
            if sc is None:
                continue
            if not isinstance(sc, dict):
                raise ValueError(
                    f"group {tg.name}: scaling must be a block/object")
            try:
                lo = int(sc.get("min", 0) or 0)
                hi = int(sc.get("max", tg.count))
            except (TypeError, ValueError):
                raise ValueError(
                    f"group {tg.name}: scaling min/max must be integers")
            if lo < 0 or hi < lo:
                raise ValueError(
                    f"group {tg.name}: scaling bounds invalid "
                    f"(min={lo}, max={hi})")

    def deregister_job(self, namespace: str, job_id: str
                       ) -> Optional[Evaluation]:
        """(reference :840; upstream: job_endpoint.go Deregister) Store
        the job stopped and enqueue the eval that stops its allocs."""
        job = self.state.job_by_id(namespace, job_id)
        if job is None:
            return None
        stopped = copy.copy(job)
        stopped.stop = True
        self.state.upsert_job(stopped)
        ev = Evaluation(
            id=generate_uuid(), namespace=namespace, priority=job.priority,
            type=job.type, triggered_by=TRIGGER_JOB_DEREGISTER,
            job_id=job_id, status=EVAL_STATUS_PENDING)
        self.state.upsert_evals([ev])
        self.broker.enqueue(ev)
        return ev

    # ------------------------------------------------------------------
    # nodes (upstream: nomad/node_endpoint.go)
    def register_node(self, node: Node) -> None:
        """(reference :1097; upstream: node_endpoint.go:99 Register) An
        unknown pool is created; new capacity unblocks the evals blocked
        on the node's class."""
        if node.node_pool and \
                self.state.node_pool_by_name(node.node_pool) is None:
            self.state.upsert_node_pool(NodePool(
                name=node.node_pool,
                description="created by node registration"))
        node.status = NODE_STATUS_READY
        self.state.upsert_node(node)
        self.blocked_evals.unblock(node.computed_class)

    def update_node_status(self, node_id: str, status: str) -> None:
        """(reference :1130; upstream: node_endpoint.go:541 UpdateStatus)
        A node that turns ready unblocks its class's evals; a node that
        turns ready, down or disconnected gets evals for its jobs."""
        node = self.state.node_by_id(node_id)
        if node is None:
            return
        old = node.status
        self.state.update_node_status(node_id, status, time.time())
        if status == NODE_STATUS_READY:
            if old != NODE_STATUS_READY:
                self.blocked_evals.unblock(node.computed_class)
                self._create_node_evals(node_id)
        elif status in (NODE_STATUS_DOWN, NODE_STATUS_DISCONNECTED):
            self._create_node_evals(node_id)

    def _create_node_evals(self, node_id: str) -> None:
        """(reference :1190; upstream: node_endpoint.go createNodeEvals)
        An eval for every job with live allocs on the node, and one for
        every system job, enqueued through storm admission."""
        jobs = {}
        for a in self.state.allocs_by_node(node_id):
            if not a.terminal_status():
                jobs[(a.namespace, a.job_id)] = a.job
        evals = []
        for ns, job_id in jobs:
            stored = self.state.job_by_id(ns, job_id)
            if stored is None:
                continue
            evals.append(Evaluation(
                id=generate_uuid(), namespace=ns,
                priority=stored.priority, type=stored.type,
                triggered_by=TRIGGER_NODE_UPDATE, job_id=job_id,
                node_id=node_id, status=EVAL_STATUS_PENDING))
        for job in self.state.jobs():
            if job.type in (JOB_TYPE_SYSTEM, "sysbatch") and not job.stop:
                evals.append(Evaluation(
                    id=generate_uuid(), namespace=job.namespace,
                    priority=job.priority, type=job.type,
                    triggered_by=TRIGGER_NODE_UPDATE, job_id=job.id,
                    node_id=node_id, status=EVAL_STATUS_PENDING))
        if evals:
            self.state.upsert_evals(evals)
            self.broker.enqueue_storm(evals)

    def update_allocs_from_client(self, allocs) -> None:
        """(reference :1309; upstream: node_endpoint.go:1322 UpdateAlloc)
        A client's alloc status updates: the store takes them (capacity a
        stopped alloc held frees only here, when its client says it is
        terminal), the jobs' statuses are refreshed, and a failed alloc
        of a live job enqueues one ``alloc-failure`` eval for its job,
        whose reschedule places with the node penalty. The port's store
        keeps no service catalog, so there is none to clear."""
        self.state.update_allocs_from_client(allocs)
        for key in {(a.namespace, a.job_id) for a in allocs}:
            self._refresh_job_status(*key)
        evals = []
        seen = set()
        for a in allocs:
            if a.client_status != ALLOC_CLIENT_FAILED:
                continue
            stored = self.state.alloc_by_id(a.id)
            if stored is None or (stored.namespace, stored.job_id) in seen:
                continue
            job = self.state.job_by_id(stored.namespace, stored.job_id)
            if job is None or job.stop:
                continue
            seen.add((stored.namespace, stored.job_id))
            evals.append(Evaluation(
                id=generate_uuid(), namespace=stored.namespace,
                priority=job.priority, type=job.type,
                triggered_by="alloc-failure", job_id=job.id,
                status=EVAL_STATUS_PENDING))
        if evals:
            self.state.upsert_evals(evals)
            self.broker.enqueue_all(evals)

    # ------------------------------------------------------------------
    # worker callbacks (reference :1344-1406)
    def _freed_classes_unblock(self, results) -> None:
        """One blocked-evals sweep for the classes of every node that the
        results' stops and preemptions freed."""
        freed = set()
        for result in results:
            for node_id in (list(result.node_update)
                            + list(result.node_preemptions)):
                node = self.state.node_by_id(node_id)
                if node is not None:
                    freed.add(node.computed_class)
        for cls in freed:
            self.blocked_evals.unblock(cls)

    def _on_plan_batch_commit(self, results: List[PlanResult]) -> None:
        """ONE sweep for a whole committed plan group (called on the
        applier's commit thread)."""
        self._freed_classes_unblock(results)

    def on_plan_result(self, plan: Plan, result: PlanResult) -> None:
        # a group-committed result was swept with its group
        if not result.batch_unblocked:
            self._freed_classes_unblock([result])

    def on_eval_update(self, ev: Evaluation) -> None:
        if ev.status == EVAL_STATUS_COMPLETE:
            self._refresh_job_status(ev.namespace, ev.job_id)

    def _refresh_job_status(self, namespace: str, job_id: str) -> None:
        """(upstream: fsm setJobStatus) running while an alloc is live;
        dead once every alloc is terminal and the job is stopped or no
        eval is in flight."""
        job = self.state.job_by_id(namespace, job_id)
        if job is None:
            return
        allocs = self.state.allocs_by_job(namespace, job_id)
        status = job.status
        if any(not a.terminal_status() for a in allocs):
            status = JOB_STATUS_RUNNING
        elif allocs:
            pending = any(not e.terminal_status() for e in
                          self.state.evals_by_job(namespace, job_id))
            if job.stop or not pending:
                status = JOB_STATUS_DEAD
        if status != job.status:
            self.state.update_job_status(namespace, job_id, status)
