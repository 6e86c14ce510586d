"""The server (port of nomad_tpu/server/core.py Server; upstream:
nomad/server.go NewServer :326, leader.go establishLeadership :357,
heartbeat.go, core_sched.go, periodic.go, deploymentwatcher/, drainer/,
node_endpoint.go Register :99 and UpdateStatus :541, job_endpoint.go
Register :96): it wires the store, the eval broker and blocked evals, the
plan applier and the scheduler workers into one control plane, and runs
the leader's duties that keep the fleet alive and the state bounded.
Single-server topology: this process is always the leader, and the
store's write API is the raft boundary.

A job registered here becomes committed placements:
``register_job`` -> EvalBroker -> BatchWorker -> GenericScheduler ->
SolveBarrier -> the device kernels -> materialize -> Planner (verify,
group commit) -> StateStore.

The leader's duties, each a background loop started by ``start`` and
joined by ``shutdown`` (``_supervised``: a loop that raises is logged,
counted in ``nomad.server.watcher_error`` and restarted):

  heartbeat      node TTLs: a node whose client stops checking in goes
                 down (disconnected while an alloc has disconnect
                 grace), and its allocs are rescheduled through the
                 node-down fan-out; NodeFlapTracker holds a node that
                 flaps down for an escalating quarantine
  core-gc        terminal evals, allocs and dead jobs past an age, the
                 oldest terminal allocs past a watermark, and the alloc
                 table's compaction once freed rows dominate
  periodic       ``@every <N>s`` periodic jobs launch children
  deploy-watch   deployments advance, fail (auto-reverting), complete
                 (marking the version stable) and auto-promote
  drainer        draining nodes migrate their allocs, at most
                 migrate.max_parallel of a task group at a time, all at
                 once past the deadline

WorkerSupervisor restarts scheduler workers that die or stop making
progress. The event stream (``publish_event``, ``subscribe_events``)
carries what the leader and the endpoints did.

``device`` is where every scheduler's placement service and every
barrier dispatches: ``cuda`` unless the caller names another, resolved
at ``start``, which raises without a card.

The job operations (upstream: job_endpoint.go Plan, Dispatch, Scale,
ScaleStatus): ``plan_job`` runs the whole scheduler, on the server's
device, over a copy of the state (state/restore.py dump_state into a
fresh store, restore_state) and reports what ``register_job`` would
place and stop, committing nothing to the live store; ``dispatch_job``
registers a parameterized job's child; ``scale_job`` registers a new
count within the group's scaling bounds and records a scaling event.
``snapshot_save`` / ``snapshot_restore`` are the operator's archives
(server/snapshot.py): a restore revokes leadership, replaces every
table, and establishes leadership again, so the restored pending evals
are enqueued as one burst.

The cluster tables: namespaces and node pools (their writes and deletes,
with the reference's refusals), the native service catalog (written by
the clients as workloads start; a node going down and allocs turning
terminal remove their registrations), search over the store
(server/search.py), and ACLs: ``acl_enabled`` turns enforcement on,
``bootstrap_acl`` mints the first management token, and
``resolve_token`` turns a request's secret into a compiled ACL
(acl/Resolver). The volume watcher and CSI, the keyring, variables,
workload identities and federation are not part of this module.

Knobs (read when a Server is built):
  NOMAD_TPU_TORCH_FLAP=0                 immediate down->ready transitions
  NOMAD_TPU_TORCH_FLAP_THRESHOLD         flaps in the window before a
                                         quarantine (3)
  NOMAD_TPU_TORCH_FLAP_WINDOW            the scoring window, s (300)
  NOMAD_TPU_TORCH_FLAP_BASE_S            the first quarantine, s (5)
  NOMAD_TPU_TORCH_FLAP_MAX_S             the quarantine cap, s (300)
  NOMAD_TPU_TORCH_WORKER_SUPERVISE=0     no supervisor
  NOMAD_TPU_TORCH_WORKER_STALL_S         wedge threshold, s (30)
  NOMAD_TPU_TORCH_WORKER_CHECK_S         health-check cadence, s (0.5)
  NOMAD_TPU_TORCH_WORKER_RESTART_BASE_S  first restart backoff, s (0.25)
  NOMAD_TPU_TORCH_WORKER_RESTART_MAX_S   restart backoff cap, s (15)
  NOMAD_TPU_TORCH_GC_ALLOC_WATERMARK     terminal allocs kept before GC
                                         deletes the oldest (1,000,000;
                                         0 keeps them all)
"""
from __future__ import annotations

import copy
import gc
import logging
import os
import queue
import threading
import time
from typing import Dict, List, Optional

from ..acl import ANONYMOUS_ACL, MANAGEMENT_ACL, Resolver
from ..device import DeviceLike, resolve_device
from ..faultinject import faults
from ..state.store import StateStore
from ..structs import (
    ACL_TOKEN_TYPE_MANAGEMENT, ACLToken,
    Allocation, Deployment, DesiredTransition, Evaluation, Job, Node,
    NodePool, Plan, PlanResult, ScalingEvent, generate_uuid,
    ALLOC_CLIENT_FAILED, ALLOC_CLIENT_RUNNING, DEPLOYMENT_STATUS_FAILED,
    DEPLOYMENT_STATUS_PAUSED,
    DEPLOYMENT_STATUS_RUNNING, DEPLOYMENT_STATUS_SUCCESSFUL,
    EVAL_STATUS_BLOCKED, EVAL_STATUS_COMPLETE, EVAL_STATUS_PENDING,
    JOB_STATUS_DEAD, JOB_STATUS_RUNNING, JOB_TYPE_SYSTEM,
    NODE_STATUS_DISCONNECTED, NODE_STATUS_DOWN, NODE_STATUS_READY,
    TRIGGER_DEPLOYMENT_WATCHER, TRIGGER_JOB_DEREGISTER, TRIGGER_JOB_REGISTER,
    TRIGGER_NODE_UPDATE,
)
from .admission import AdmissionPipeline
from .broker import BlockedEvals, EvalBroker
from .plan_apply import BadNodeTracker, Planner
from .quality import observatory
from .telemetry import metrics
from .worker import BatchWorker, Worker

_log = logging.getLogger(__name__)

DEFAULT_HEARTBEAT_TTL = 10.0
GC_EVAL_THRESHOLD = 3600.0
GC_INTERVAL = 60.0
# terminal allocs kept before the watermark pass deletes the oldest
GC_ALLOC_WATERMARK = 1_000_000

# how long shutdown waits for each thread it stops
_JOIN_S = 10.0


def _env_float(name: str, default: str) -> float:
    return float(os.environ.get(name, default))


class NodeFlapTracker(BadNodeTracker):
    """Flap damping (reference core.py:44): the heartbeat path records a
    hit on every transition to down (BadNodeTracker's windowed score);
    once a node's score reaches the threshold its next recovery is held
    for a quarantine of ``min(base * 2 ** (score - threshold), max)``
    seconds, so one sick node cannot storm the broker with node-down
    fan-outs and node-up sweeps. Knobs: NOMAD_TPU_TORCH_FLAP* (module
    docstring)."""

    def __init__(self):
        self.enabled = os.environ.get("NOMAD_TPU_TORCH_FLAP", "1") != "0"
        self.flap_threshold = int(
            os.environ.get("NOMAD_TPU_TORCH_FLAP_THRESHOLD", "3"))
        window = _env_float("NOMAD_TPU_TORCH_FLAP_WINDOW", "300")
        self.base_s = _env_float("NOMAD_TPU_TORCH_FLAP_BASE_S", "5")
        self.max_s = _env_float("NOMAD_TPU_TORCH_FLAP_MAX_S", "300")
        super().__init__(threshold=self.flap_threshold, window=window)
        self._quarantine: Dict[str, float] = {}

    def record_down(self, node_id: str) -> int:
        """A node went down: record the flap and, at or past the
        threshold, arm or extend its quarantine. Returns the score."""
        if not self.enabled:
            return 0
        self.add(node_id)
        score = self.score(node_id)
        if score >= self.flap_threshold:
            hold = min(self.base_s * (2 ** (score - self.flap_threshold)),
                       self.max_s)
            self._quarantine[node_id] = time.time() + hold
            metrics.incr("nomad.heartbeat.flap_quarantined")
        return score

    def quarantine_remaining(self, node_id: str) -> float:
        """Seconds of quarantine left (0: free to turn ready); an expired
        entry is dropped on read."""
        if not self.enabled:
            return 0.0
        until = self._quarantine.get(node_id)
        if until is None:
            return 0.0
        rem = until - time.time()
        if rem <= 0:
            with self._lock:
                self._quarantine.pop(node_id, None)
            return 0.0
        return rem

    def release(self, node_id: str) -> None:
        """Lift the quarantine (a re-registration, a deregistration)."""
        with self._lock:
            self._quarantine.pop(node_id, None)

    def state(self) -> dict:
        """The knobs, the scores in the window and the quarantines left."""
        now = time.time()
        with self._lock:
            cutoff = now - self.window
            scores = {nid: sum(1 for t in hits if t >= cutoff)
                      for nid, hits in self._hits.items()}
            quarantined = {nid: round(until - now, 3)
                           for nid, until in self._quarantine.items()
                           if until > now}
        return {"enabled": self.enabled, "threshold": self.flap_threshold,
                "window_s": self.window, "base_s": self.base_s,
                "max_s": self.max_s,
                "scores": {nid: s for nid, s in scores.items() if s > 0},
                "quarantined": quarantined}


class WorkerSupervisor:
    """The scheduler workers' health (reference core.py:130). Each worker
    touches ``last_progress`` every loop turn; the supervisor detects a
    DEAD worker (its thread ended: a worker.crash fault, an escaped
    BaseException) and a WEDGED one (no progress for longer than
    ``stall_s``), and respawns the slot after an escalating backoff,
    ``min(base * 2 ** (n - 1), max)`` over the slot's consecutive
    restarts (reset once a replacement outlives the stall window). A dead
    worker's leased evals come back through the broker's nack timeout,
    and a wedged one that wakes is fenced at plan submission: the
    supervisor restores capacity only. Knobs:
    NOMAD_TPU_TORCH_WORKER_* (module docstring)."""

    def __init__(self, server):
        self.server = server
        self.enabled = os.environ.get(
            "NOMAD_TPU_TORCH_WORKER_SUPERVISE", "1") != "0"
        self.stall_s = _env_float("NOMAD_TPU_TORCH_WORKER_STALL_S", "30")
        self.check_s = _env_float("NOMAD_TPU_TORCH_WORKER_CHECK_S", "0.5")
        self.base_s = _env_float("NOMAD_TPU_TORCH_WORKER_RESTART_BASE_S",
                                 "0.25")
        self.max_s = _env_float("NOMAD_TPU_TORCH_WORKER_RESTART_MAX_S",
                                "15")
        self._factory = None        # slot index -> a fresh unstarted worker
        self._stop_ev = threading.Event()
        self._gen = 0               # bumped by begin: older watchers exit
        self._thread: Optional[threading.Thread] = None
        self._pending: Dict[int, float] = {}     # slot -> respawn time
        self._consecutive: Dict[int, int] = {}
        self._spawned_at: Dict[int, float] = {}
        self.restarts_total = 0
        self.deaths_detected = 0
        self.wedges_detected = 0

    def begin(self, factory) -> None:
        """Supervise ``server.workers`` (called under the leader lock
        right after the pool starts; ``factory`` builds a slot's
        replacement of the pool's kind)."""
        if not self.enabled:
            return
        self._factory = factory
        now = time.monotonic()
        self._pending.clear()
        self._consecutive.clear()
        self._spawned_at = {i: now for i in range(len(self.server.workers))}
        self._stop_ev.clear()
        # a fresh watcher per leadership term: an older one sees the
        # generation move and exits (joining it here could deadlock: it
        # may wait on the leader lock)
        self._gen += 1
        self._thread = threading.Thread(
            target=self._run, args=(self._gen,), daemon=True,
            name=f"worker-supervisor-{self._gen}")
        self._thread.start()

    def stop(self) -> None:
        self._stop_ev.set()

    def join(self, timeout: float) -> None:
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout)

    def _run(self, gen: int) -> None:
        while not self._stop_ev.wait(self.check_s):
            if gen != self._gen:
                return
            try:
                self._check_once()
            except Exception:  # noqa: BLE001 -- the watcher must survive
                _log.exception("worker supervisor check failed")

    def _check_once(self) -> None:
        with self.server._leader_lock:
            if (not self.server._leader_active.is_set()
                    or self._stop_ev.is_set()):
                return
            now = time.monotonic()
            for i, w in enumerate(self.server.workers):
                if i in self._pending:
                    if now >= self._pending[i]:
                        self._respawn_locked(i)
                    continue
                if not w.is_alive():
                    self.deaths_detected += 1
                    metrics.incr("nomad.worker.supervisor_death")
                    _log.error("worker %s died; restarting slot %d",
                               w.name, i)
                    self._schedule_restart_locked(i, now)
                    continue
                age = now - getattr(w, "last_progress", now)
                if self.stall_s > 0 and age > self.stall_s:
                    self.wedges_detected += 1
                    metrics.incr("nomad.worker.supervisor_wedge")
                    _log.error("worker %s wedged (%.1f s without progress);"
                               " abandoning it, restarting slot %d",
                               w.name, age, i)
                    # the hung thread may never end: stopped, it is left
                    # as an abandoned daemon
                    w.stop()
                    self._schedule_restart_locked(i, now)
                    continue
                if (self._consecutive.get(i)
                        and now - self._spawned_at.get(i, now)
                        > max(self.stall_s, 2 * self.base_s)):
                    self._consecutive.pop(i, None)

    def _schedule_restart_locked(self, slot: int, now: float) -> None:
        n = self._consecutive.get(slot, 0) + 1
        self._consecutive[slot] = n
        self._pending[slot] = now + min(self.base_s * (2 ** (n - 1)),
                                        self.max_s)

    def _respawn_locked(self, slot: int) -> None:
        self._pending.pop(slot, None)
        w = self._factory(slot)
        w.start()
        self.server.workers[slot] = w
        self._spawned_at[slot] = time.monotonic()
        self.restarts_total += 1
        metrics.incr("nomad.worker.supervisor_restart")
        _log.warning("worker slot %d restarted as %s (consecutive restart"
                     " %d)", slot, w.name, self._consecutive.get(slot, 0))

    def state(self) -> dict:
        now = time.monotonic()
        workers = list(self.server.workers)
        return {
            "enabled": self.enabled, "stall_s": self.stall_s,
            "restart_base_s": self.base_s, "restart_max_s": self.max_s,
            "restarts_total": self.restarts_total,
            "deaths_detected": self.deaths_detected,
            "wedges_detected": self.wedges_detected,
            "pending_restarts": len(self._pending),
            "workers": [
                {"name": w.name, "alive": w.is_alive(),
                 "evals_processed": w.evals_processed,
                 "progress_age_s": round(
                     now - getattr(w, "last_progress", now), 3)}
                for w in workers]}


class EventSubscription:
    """One consumer's filtered event queue (reference core.py:304;
    upstream: nomad/stream/event_broker.go Subscription): ``topics`` maps
    a topic (or ``*``) to the keys wanted (or ``*``); a full queue drops
    its oldest event."""

    MAX_PENDING = 1024

    def __init__(self, topics: Optional[Dict[str, List[str]]] = None):
        self.topics = topics or {"*": ["*"]}
        self._q: "queue.Queue" = queue.Queue(maxsize=self.MAX_PENDING)
        self.closed = False

    def matches(self, event: dict) -> bool:
        for topic, keys in self.topics.items():
            if topic not in ("*", event["topic"]):
                continue
            if not keys or "*" in keys or event.get("key") in keys:
                return True
        return False

    def offer(self, event: dict) -> None:
        if self.closed or not self.matches(event):
            return
        try:
            self._q.put_nowait(event)
        except queue.Full:
            try:
                self._q.get_nowait()
                self._q.put_nowait(event)
            except (queue.Empty, queue.Full):
                pass

    def next(self, timeout: float = 1.0) -> Optional[dict]:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None


def _failed_metrics(evals) -> Dict[str, dict]:
    """Each failed task group's metrics over ``evals`` (the last eval
    naming a group wins), as a plan answer reports them."""
    failed = {}
    for pe in evals:
        for tg_name, metric in (pe.failed_tg_allocs or {}).items():
            failed[tg_name] = {
                "nodes_evaluated": metric.nodes_evaluated,
                "nodes_filtered": metric.nodes_filtered,
                "constraint_filtered": dict(metric.constraint_filtered),
                "dimension_exhausted": dict(metric.dimension_exhausted),
            }
    return failed


class Server:
    """(reference core.py:344; upstream: nomad/server.go:105 Server)"""

    def __init__(self, num_workers: Optional[int] = None, state=None,
                 eval_batching: bool = True,
                 batch_width: Optional[int] = None,
                 device: DeviceLike = None,
                 heartbeat_ttl: float = DEFAULT_HEARTBEAT_TTL,
                 acl_enabled: bool = False):
        self.state = state if state is not None else StateStore()
        self.device = device
        # ACL enforcement (reference :349-365): off, every request
        # resolves to the management ACL
        self.acl_enabled = acl_enabled
        self.acl_resolver = Resolver(self.state)
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
        self.supervisor = WorkerSupervisor(self)
        self.heartbeat_ttl = heartbeat_ttl
        self._heartbeat_deadlines: Dict[str, float] = {}
        self._hb_lock = threading.Lock()
        self.flaps = NodeFlapTracker()
        # drain pacing rounds (an endpoint call and the drainer loop)
        # read, count and mark: serialized, or two could overshoot
        # migrate.max_parallel
        self._drain_lock = threading.Lock()
        self._shutdown = threading.Event()
        self._threads: List[threading.Thread] = []
        self._events: List[dict] = []
        self._events_lock = threading.Lock()
        self._event_subs: List[EventSubscription] = []
        self._periodic_last: Dict[tuple, float] = {}
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
        self._start_background()
        self.establish_leadership()

    def _start_background(self) -> None:
        """(reference :427) The leader's loops, each supervised; the
        reference's volume watcher is not ported."""
        for fn, name in ((self._run_heartbeat_watcher, "heartbeat"),
                         (self._run_gc, "core-gc"),
                         (self._run_periodic, "periodic"),
                         (self._run_deployment_watcher, "deploy-watch"),
                         (self._run_drainer, "drainer")):
            t = threading.Thread(target=self._supervised, args=(fn, name),
                                 daemon=True, name=name)
            t.start()
            self._threads.append(t)

    def _supervised(self, fn, name: str) -> None:
        """(reference :441) Run a loop; one that raises is logged,
        counted and restarted after half a second, until shutdown."""
        while not self._shutdown.is_set():
            try:
                fn()
                return          # a clean exit: shutdown
            except Exception:  # noqa: BLE001 -- the loop must survive
                metrics.incr("nomad.server.watcher_error")
                _log.exception("%s watcher failed; restarting", name)
                self._shutdown.wait(0.5)

    def establish_leadership(self) -> None:
        """(reference :455; upstream: leader.go:357) Enable the broker
        and blocked evals, restore evals from the store, give every node
        a full TTL, restore the periodic launch times, start the workers
        -- two BatchWorkers (one while the LP tier is active: the queue
        coalesces into the widest joint solve), or plain Workers without
        batching -- and their supervisor."""
        from ..solver.lpq import lpq_active

        with self._leader_lock:
            if self._leader_active.is_set():
                return
            paused = bool(getattr(self.state.scheduler_config(),
                                  "pause_eval_broker", False))
            self.broker.set_enabled(not paused)
            self.blocked_evals.set_enabled(True)
            self._restore_evals()
            self._initialize_heartbeat_timers()
            self._restore_periodic_launch_times()
            if self.eval_batching:
                n = 1 if lpq_active(self.state) else 2
                self.workers = [BatchWorker(self, i, width=self.batch_width)
                                for i in range(n)]
                spawn = self._spawn_batch_worker
            else:
                self.workers = [Worker(self, i)
                                for i in range(self.num_workers)]
                spawn = self._spawn_worker
            for w in self.workers:
                w.start()
            self._leader_active.set()
            self.supervisor.begin(spawn)

    def _spawn_batch_worker(self, i: int) -> BatchWorker:
        return BatchWorker(self, i, width=self.batch_width)

    def _spawn_worker(self, i: int) -> Worker:
        return Worker(self, i)

    def revoke_leadership(self) -> None:
        """(reference :513; upstream: leader.go revokeLeadership) Stop the
        supervisor and the workers and wait for them (in-flight evals
        are nacked back by their workers), disable the broker and
        blocked evals, and drop the heartbeat deadlines and periodic
        launch times."""
        with self._leader_lock:
            if not self._leader_active.is_set():
                return
            self._leader_active.clear()
            self.supervisor.stop()
            self._stop_workers()
            self.broker.set_enabled(False)
            self.blocked_evals.set_enabled(False)
            with self._hb_lock:
                self._heartbeat_deadlines.clear()
            self._periodic_last.clear()

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
        ready = []
        for ev in self.state.evals():
            if ev.status == EVAL_STATUS_BLOCKED:
                if reblock:
                    self.blocked_evals.block(ev)
                else:
                    ready.append(ev)
            elif ev.should_enqueue():
                ready.append(ev)
        # one call: a batch worker takes the restored burst whole, as it
        # takes any burst enqueued at once (the reference enqueues one
        # eval at a time, so a worker may split it)
        self.broker.enqueue_all(ready)

    def _initialize_heartbeat_timers(self) -> None:
        """(reference :545; upstream: heartbeat.go:59) A new leader owns
        node liveness: every node that is not down gets a full TTL."""
        now = time.time()
        with self._hb_lock:
            for node in self.state.nodes():
                if node.status not in (NODE_STATUS_DOWN,
                                       NODE_STATUS_DISCONNECTED):
                    self._heartbeat_deadlines[node.id] = \
                        now + self.heartbeat_ttl

    def _restore_periodic_launch_times(self) -> None:
        """(reference :557) The last launch of each periodic job, read
        from the children in the store, so a new leader does not launch
        again mid-interval."""
        for job in self.state.jobs():
            if not job.parent_id or "/periodic-" not in job.id:
                continue
            try:
                launched = float(job.id.rsplit("/periodic-", 1)[1])
            except ValueError:
                continue
            if self.state.job_by_id(job.namespace, job.parent_id) is None:
                continue
            key = (job.namespace, job.parent_id)
            self._periodic_last[key] = max(
                self._periodic_last.get(key, 0.0), launched)

    def is_leader(self) -> bool:
        return self._leader_active.is_set()

    def shutdown(self) -> None:
        """(reference :579) Stop the leader's loops, the supervisor, the
        workers, the broker's watcher and the applier's threads, each
        waited for within a deadline."""
        self._shutdown.set()
        self.supervisor.stop()
        observatory.detach(self.state)
        with self._leader_lock:
            self._leader_active.clear()
            self._stop_workers()
        self.broker.set_enabled(False)
        self.broker.shutdown()
        self.planner.shutdown()
        deadline = time.monotonic() + _JOIN_S
        self.supervisor.join(max(0.0, deadline - time.monotonic()))
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
        alive = [t.name for t in self._threads if t.is_alive()]
        if alive:
            _log.error("leader loops still running after %.0f s: %s",
                       _JOIN_S, alive)

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
    # ACLs (upstream: nomad/acl_endpoint.go, nomad/auth/auth.go)
    def bootstrap_acl(self) -> Optional[ACLToken]:
        """(reference :594; upstream: acl_endpoint.go Bootstrap) The
        one-time management token; None once bootstrapped."""
        token = ACLToken.new(name="Bootstrap Token",
                             type=ACL_TOKEN_TYPE_MANAGEMENT)
        token.global_token = True
        if not self.state.bootstrap_acl_token(token):
            return None
        return token

    def resolve_token(self, secret_id: Optional[str]):
        """(reference :626) -> (ACL, token). ACLs off: the management ACL
        for every request; on: no secret, or one that names no live
        token, is the deny-all anonymous ACL. A secret shaped as a JWT
        resolves through the token table as any other: the workload
        identity branch (reference :640-643) comes with the keyring."""
        if not self.acl_enabled:
            return MANAGEMENT_ACL, None
        if not secret_id:
            return ANONYMOUS_ACL, None
        compiled, token = self.acl_resolver.resolve_secret(secret_id)
        if compiled is None:
            return ANONYMOUS_ACL, None
        return compiled, token

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
        self.publish_event("JobRegistered", {"job_id": job.id})
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

    def deregister_job(self, namespace: str, job_id: str,
                       purge: bool = False) -> Optional[Evaluation]:
        """(reference :840; upstream: job_endpoint.go Deregister) Store
        the job stopped (``purge``: then delete it and its versions) and
        enqueue the eval that stops its allocs."""
        job = self.state.job_by_id(namespace, job_id)
        if job is None:
            return None
        stopped = copy.copy(job)
        stopped.stop = True
        self.state.upsert_job(stopped)
        if purge:
            self.state.delete_job(namespace, job_id)
        ev = Evaluation(
            id=generate_uuid(), namespace=namespace, priority=job.priority,
            type=job.type, triggered_by=TRIGGER_JOB_DEREGISTER,
            job_id=job_id, status=EVAL_STATUS_PENDING)
        self.state.upsert_evals([ev])
        self.broker.enqueue(ev)
        self.publish_event("JobDeregistered", {"job_id": job_id})
        return ev

    # job versions (upstream: job_endpoint.go GetJobVersions, Revert,
    # Stable)
    def job_versions(self, namespace: str, job_id: str) -> List[Job]:
        """(reference :937) Every stored version, newest first."""
        return self.state.job_versions_by_id(namespace, job_id)

    def revert_job(self, namespace: str, job_id: str, version: int,
                   enforce_prior_version: Optional[int] = None):
        """(reference :940) Register a prior version's spec as a NEW
        version, not yet stable (a revert moves forward; history stays)."""
        current = self.state.job_by_id(namespace, job_id)
        if current is None:
            raise ValueError(f"job {job_id} not found")
        if enforce_prior_version is not None and \
                current.version != enforce_prior_version:
            raise ValueError(
                f"current version {current.version} != enforced "
                f"{enforce_prior_version}")
        if version == current.version:
            raise ValueError("cannot revert to the current version")
        prior = self.state.job_version(namespace, job_id, version)
        if prior is None:
            raise ValueError(f"version {version} not found")
        revert = copy.deepcopy(prior)
        revert.stop = False
        revert.stable = False
        return self.register_job(revert)

    def set_job_stability(self, namespace: str, job_id: str,
                          version: int, stable: bool) -> None:
        """(reference :966)"""
        if self.state.job_version(namespace, job_id, version) is None:
            raise ValueError(f"job {job_id} version {version} not found")
        self.state.update_job_stability(namespace, job_id, version, stable)

    def plan_job(self, job: Job) -> dict:
        """(reference :862; upstream: job_endpoint.go Plan) A dry run:
        the job, admitted as ``register_job`` admits it, is stored with
        an annotate_plan eval in a fresh store holding a copy of the
        state, and the scheduler runs there through a Harness on the
        server's device. Returns the placements and stops the plans
        would commit, per task group (place, stop, migrate,
        preemptions), the groups that would fail with their metrics,
        the stored job's job_modify_index and the diff type. The live
        store is only read.

        The reference admits the plan with ``_validate_job`` alone, so
        for a Connect job it plans without the injected sidecar task and
        port that its registration adds. Here the admission hooks run
        too, on a copy of the job: the plan predicts ``job run``.

        A group the device path fails carries no explanation in the
        reference's answer (no node evaluated, no dimension exhausted).
        Here the plan's eval has the scheduler count it from the solved
        lane's own tables (solver/service.py failure_metric): the nodes
        evaluated and filtered, the constraints, and the dimension each
        node ran out of, as the host stack counts them.

        Times go to ``nomad.job.plan.dump`` / ``.restore`` /
        ``.schedule`` (ms) and the allocs copied to the gauge
        ``nomad.job.plan.allocs_copied``."""
        from ..scheduler.harness import Harness
        from ..state.restore import dump_state, restore_state

        self._validate_job(job)
        job, _warnings = AdmissionPipeline(self).apply(copy.deepcopy(job))
        t0 = time.perf_counter()
        blob = dump_state(self.state)
        t1 = time.perf_counter()
        temp = StateStore()
        restore_state(temp, blob)
        t2 = time.perf_counter()
        h = Harness(temp)
        temp.upsert_job(job)
        ev = Evaluation(
            id=generate_uuid(), namespace=job.namespace,
            priority=job.priority, type=job.type,
            triggered_by=TRIGGER_JOB_REGISTER, job_id=job.id,
            status=EVAL_STATUS_PENDING, annotate_plan=True)
        temp.upsert_evals([ev])
        sched_type = (job.type if job.type in
                      ("service", "batch", "system", "sysbatch")
                      else "service")
        h.process(sched_type, ev, device=self.device)
        t3 = time.perf_counter()
        metrics.sample_ms("nomad.job.plan.dump", (t1 - t0) * 1e3)
        metrics.sample_ms("nomad.job.plan.restore", (t2 - t1) * 1e3)
        metrics.sample_ms("nomad.job.plan.schedule", (t3 - t2) * 1e3)
        metrics.sample("nomad.job.plan.allocs_copied", len(blob["allocs"]))
        placed = stopped = 0
        tg_updates: Dict[str, Dict[str, int]] = {}

        def bump(tg_name: str, key: str) -> None:
            tg_updates.setdefault(tg_name, {
                "place": 0, "stop": 0, "migrate": 0,
                "preemptions": 0})[key] += 1

        for plan in h.plans:
            for allocs in plan.node_allocation.values():
                placed += len(allocs)
                for alloc in allocs:
                    bump(alloc.task_group, "place")
            for allocs in plan.node_update.values():
                stopped += len(allocs)
                for alloc in allocs:
                    bump(alloc.task_group,
                         "migrate" if (alloc.desired_transition and
                                       alloc.desired_transition.migrate)
                         else "stop")
            for allocs in plan.node_preemptions.values():
                for alloc in allocs:
                    bump(alloc.task_group, "preemptions")
        failed = _failed_metrics(h.evals)
        existing = self.state.job_by_id(job.namespace, job.id)
        return {
            "placed": placed, "stopped": stopped,
            "annotations": ({"desired_tg_updates": tg_updates}
                            if tg_updates else None),
            "failed_tg_allocs": failed,
            "job_modify_index":
                existing.job_modify_index if existing else 0,
            "diff_type": "Edited" if existing is not None else "Added",
        }

    def dispatch_job(self, namespace: str, job_id: str,
                     payload: bytes = b"",
                     meta: Optional[Dict[str, str]] = None,
                     idempotency_token: str = ""):
        """(reference :974; upstream: job_endpoint.go Dispatch and
        validateDispatchRequest) Register a parameterized job's child,
        ``<parent>/dispatch-<unix time>-<8 hex>``, with the payload (16
        KiB at most, as the parent's payload rule allows) and the
        parent's meta overlaid with ``meta`` (every required key, no key
        the parent does not name). A token already used by a child of
        the parent in its namespace returns that child and no eval.
        Returns (child, eval or None); raises ValueError on a refusal."""
        meta = dict(meta or {})
        parent = self.state.job_by_id(namespace, job_id)
        if parent is None:
            raise ValueError(f"job {job_id} not found")
        cfg = parent.parameterized
        if cfg is None or parent.dispatched:
            raise ValueError(f"job {job_id} is not parameterized")
        if parent.stop:
            raise ValueError(f"job {job_id} is stopped")
        if cfg.payload == "required" and not payload:
            raise ValueError("payload is required")
        if cfg.payload == "forbidden" and payload:
            raise ValueError("payload is forbidden")
        if len(payload) > 16 * 1024:
            raise ValueError("payload exceeds 16KiB limit")
        required = set(cfg.meta_required or [])
        allowed = required | set(cfg.meta_optional or [])
        missing = required - set(meta)
        if missing:
            raise ValueError(f"missing required meta: {sorted(missing)}")
        extra = set(meta) - allowed
        if extra:
            raise ValueError(f"unpermitted meta keys: {sorted(extra)}")
        if idempotency_token:
            for j in self.state.jobs():
                if j.namespace == parent.namespace and \
                        j.parent_id == parent.id and \
                        j.dispatch_idempotency_token == idempotency_token:
                    return j, None
        child = copy.deepcopy(parent)
        child.id = (f"{parent.id}/dispatch-{int(time.time())}-"
                    f"{generate_uuid()[:8]}")
        child.name = child.id
        child.parent_id = parent.id
        child.dispatched = True
        child.payload = payload
        child.dispatch_idempotency_token = idempotency_token
        child.meta = {**(parent.meta or {}), **meta}
        ev = self.register_job(child)
        self.publish_event("JobDispatched",
                           {"job_id": parent.id, "dispatched_id": child.id})
        return child, ev

    def scale_job(self, namespace: str, job_id: str, group: str,
                  count: Optional[int] = None, message: str = "",
                  error: bool = False, meta: Optional[dict] = None):
        """(reference :1024; upstream: job_endpoint.go Scale) Register the
        job with ``group`` at ``count``, which must lie within the
        group's scaling bounds (min, max: the block's, max defaulting to
        the count asked), and record one ScalingEvent with the eval's id.
        With ``error`` or no ``count`` only the event is recorded.
        Returns the eval or None; raises ValueError on a refusal (and
        records nothing)."""
        job = self.state.job_by_id(namespace, job_id)
        if job is None:
            raise ValueError(f"job {job_id} not found")
        tg = job.lookup_task_group(group)
        if tg is None:
            raise ValueError(f"group {group} not found in job {job_id}")
        prev_count = tg.count
        ev = None
        if count is not None and not error:
            if count < 0:
                raise ValueError("count must be >= 0")
            if tg.scaling:
                lo = int(tg.scaling.get("min", 0) or 0)
                hi = int(tg.scaling.get("max", count))
                if count < lo or count > hi:
                    raise ValueError(
                        f"count {count} outside scaling bounds "
                        f"[{lo}, {hi}]")
            if job.stop:
                raise ValueError(f"job {job_id} is stopped")
            updated = copy.deepcopy(job)
            updated.lookup_task_group(group).count = count
            ev = self.register_job(updated)
        self.state.upsert_scaling_event(
            namespace, job_id,
            ScalingEvent(
                time=time.time(), task_group=group, count=count,
                previous_count=prev_count, message=message, error=error,
                meta=dict(meta or {}), eval_id=ev.id if ev else ""))
        return ev

    def job_scale_status(self, namespace: str, job_id: str
                         ) -> Optional[dict]:
        """(reference :1063; upstream: job_endpoint.go ScaleStatus) Per
        task group: the desired count, the allocs placed (not terminal),
        running, healthy and unhealthy, and the group's scaling events.
        None for an unknown job."""
        job = self.state.job_by_id(namespace, job_id)
        if job is None:
            return None
        allocs = self.state.allocs_by_job(namespace, job_id)
        all_events = self.state.scaling_events_by_job(namespace, job_id)
        groups = {}
        for tg in job.task_groups:
            tg_allocs = [a for a in allocs if a.task_group == tg.name]
            groups[tg.name] = {
                "desired": tg.count,
                "placed": len([a for a in tg_allocs
                               if not a.terminal_status()]),
                "running": len([a for a in tg_allocs
                                if a.client_status == ALLOC_CLIENT_RUNNING]),
                "healthy": len([a for a in tg_allocs
                                if a.deployment_status is not None
                                and a.deployment_status.is_healthy()]),
                "unhealthy": len([a for a in tg_allocs
                                  if a.deployment_status is not None
                                  and a.deployment_status.is_unhealthy()]),
                "events": [
                    {"time": e.time, "count": e.count,
                     "previous_count": e.previous_count,
                     "message": e.message, "error": e.error,
                     "eval_id": e.eval_id}
                    for e in all_events if e.task_group == tg.name],
            }
        return {"job_id": job_id, "namespace": namespace,
                "job_stopped": job.stop, "task_groups": groups}

    # ------------------------------------------------------------------
    # operator snapshots (upstream: operator_endpoint.go SnapshotSave,
    # SnapshotRestore; helper/snapshot/)
    def snapshot_save(self) -> bytes:
        """(reference :1646) The whole state as a checksummed archive."""
        from ..state.restore import dump_state
        from .snapshot import save_archive
        blob = dump_state(self.state)
        return save_archive(blob, blob.get("index", 0))

    def snapshot_restore(self, data: bytes) -> dict:
        """(reference :1653) Verify an archive, then, as the leader
        restoring a raft snapshot: revoke leadership, replace every
        table (StateStore.restore_from_snapshot), and establish
        leadership again (the restored evals go to the broker in one
        burst, every node gets a full TTL). Returns the archive's meta;
        raises ValueError, with nothing changed, for an archive that
        does not verify or decode."""
        from .snapshot import load_archive
        meta, blob = load_archive(data)
        was_leader = self.is_leader()
        if was_leader:
            self.revoke_leadership()
        try:
            self.state.restore_from_snapshot(blob)
        finally:
            if was_leader:
                self.establish_leadership()
        self.publish_event("SnapshotRestored", {"index": meta["index"]})
        return meta

    # ------------------------------------------------------------------
    # nodes (upstream: nomad/node_endpoint.go)
    def register_node(self, node: Node) -> None:
        """(reference :1097; upstream: node_endpoint.go:99 Register) An
        unknown pool is created; a registration lifts the node's flap
        quarantine (the operator's override) and starts its TTL; new
        capacity unblocks the evals blocked on the node's class."""
        if node.node_pool and \
                self.state.node_pool_by_name(node.node_pool) is None:
            self.state.upsert_node_pool(NodePool(
                name=node.node_pool,
                description="created by node registration"))
        node.status = NODE_STATUS_READY
        self.state.upsert_node(node)
        self.flaps.release(node.id)
        self._reset_heartbeat(node.id)
        self.blocked_evals.unblock(node.computed_class)
        self.publish_event("NodeRegistered", {"node_id": node.id})

    def deregister_node(self, node_id: str) -> None:
        """(reference :1118; upstream: node_endpoint.go Deregister) The
        node goes down first, so its allocs reschedule; then its record
        is removed."""
        if self.state.node_by_id(node_id) is None:
            raise ValueError(f"unknown node {node_id!r}")
        self.update_node_status(node_id, NODE_STATUS_DOWN)
        self.state.delete_node(node_id)
        self.flaps.release(node_id)
        self.publish_event("NodeDeregistered", {"node_id": node_id})

    def update_node_status(self, node_id: str, status: str) -> None:
        """(reference :1130; upstream: node_endpoint.go:541 UpdateStatus)
        A node that turns ready gets a fresh TTL, unblocks its class and
        gets evals for its jobs; one that goes down or disconnected
        records a flap, loses its deadline and gets evals for its jobs
        (the node-down fan-out)."""
        node = self.state.node_by_id(node_id)
        if node is None:
            return
        old = node.status
        self.state.update_node_status(node_id, status, time.time())
        if status == NODE_STATUS_READY:
            self._reset_heartbeat(node_id)
            if old != NODE_STATUS_READY:
                self.blocked_evals.unblock(node.computed_class)
                self._create_node_evals(node_id)
        elif status in (NODE_STATUS_DOWN, NODE_STATUS_DISCONNECTED):
            if old not in (NODE_STATUS_DOWN, NODE_STATUS_DISCONNECTED):
                _log.warning("node %s marked %s", node_id[:8], status)
                if self.flaps.record_down(node_id):
                    metrics.incr("nomad.heartbeat.flap_recorded")
            with self._hb_lock:
                self._heartbeat_deadlines.pop(node_id, None)
            self._create_node_evals(node_id)
            # a dead node's services leave the catalog in one write
            # (reference :1159)
            if status == NODE_STATUS_DOWN:
                self.state.delete_services_by_node(node_id)
        self.publish_event("NodeStatusUpdate",
                           {"node_id": node_id, "status": status})

    def heartbeat(self, node_id: str) -> float:
        """(reference :1163; upstream: heartbeat.go:93) A client's TTL
        refresh; returns the TTL. A down node's heartbeat turns it ready
        again, unless it serves a flap quarantine: then the recovery is
        deferred (its work was already replaced by the node-down
        fan-out, so deferral costs capacity, not work)."""
        faults.fire("heartbeat")
        node = self.state.node_by_id(node_id)
        if node is None:
            return 0.0
        if node.status in (NODE_STATUS_DOWN, NODE_STATUS_DISCONNECTED):
            if self.flaps.quarantine_remaining(node_id) > 0:
                metrics.incr("nomad.heartbeat.quarantine_deferred")
                return self.heartbeat_ttl
            self.update_node_status(node_id, NODE_STATUS_READY)
        self._reset_heartbeat(node_id)
        return self.heartbeat_ttl

    def _reset_heartbeat(self, node_id: str) -> None:
        with self._hb_lock:
            self._heartbeat_deadlines[node_id] = \
                time.time() + self.heartbeat_ttl

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

    # the drainer (upstream: nomad/drainer/)
    def drain_node(self, node_id: str, strategy) -> None:
        """(reference :1223) Start (or, with None, stop) a drain: the node
        turns ineligible and the drainer migrates its allocs, paced by
        each task group's migrate.max_parallel until the deadline, after
        which the rest go at once."""
        if strategy is not None:
            strategy.started_at = strategy.started_at or time.time()
            if strategy.deadline_s > 0 and not strategy.force_deadline:
                strategy.force_deadline = (strategy.started_at
                                           + strategy.deadline_s)
        self.state.update_node_drain(node_id, strategy,
                                     mark_eligible=strategy is None)
        if strategy is None:
            return
        self._drain_tick(node_id, strategy)
        self.publish_event("NodeDrain", {"node_id": node_id})

    def _run_drainer(self) -> None:
        """(reference :1243; upstream: drainer/drainer.go run loop)"""
        while not self._shutdown.wait(0.3):
            if not self._leader_active.is_set():
                continue
            for node in self.state.nodes():
                if node.drain and node.drain_strategy is not None:
                    self._drain_tick(node.id, node.drain_strategy)

    def _drain_tick(self, node_id: str, strategy) -> None:
        """One pacing round for a draining node."""
        with self._drain_lock:
            self._drain_tick_locked(node_id, strategy)

    def _drain_tick_locked(self, node_id: str, strategy) -> None:
        """(reference :1259) Per (job, task group) on the node, mark at
        most migrate.max_parallel allocs for migration, less those of
        the group still migrating anywhere; past the force deadline mark
        every one. A node with nothing left finishes its drain (it stays
        ineligible)."""
        remaining = [a for a in self.state.allocs_by_node(node_id)
                     if not a.terminal_status()
                     and (a.job is None or not strategy.ignore_system_jobs
                          or a.job.type not in (JOB_TYPE_SYSTEM,
                                                "sysbatch"))]
        if not remaining:
            node = self.state.node_by_id(node_id)
            if node is not None and node.drain:
                self.state.update_node_drain(node_id, None,
                                             mark_eligible=False)
                self.publish_event("NodeDrainComplete",
                                   {"node_id": node_id})
            return
        forced = (strategy.force_deadline
                  and time.time() >= strategy.force_deadline)
        to_mark: List[str] = []
        by_group: Dict[tuple, List[Allocation]] = {}
        for a in remaining:
            by_group.setdefault((a.namespace, a.job_id, a.task_group),
                                []).append(a)
        for (ns, job_id, tg_name), allocs in by_group.items():
            if forced:
                to_mark.extend(a.id for a in allocs
                               if not a.desired_transition.migrate)
                continue
            job = self.state.job_by_id(ns, job_id)
            tg = job.lookup_task_group(tg_name) if job is not None else None
            limit = (tg.migrate.max_parallel
                     if tg is not None and tg.migrate is not None else 1)
            # busy slots: the group's allocs anywhere still migrating
            # (marked, not yet terminal)
            in_flight = sum(
                1 for a in self.state.allocs_by_job(ns, job_id)
                if a.task_group == tg_name
                and a.desired_transition.migrate
                and not a.terminal_status())
            room = max(0, limit - in_flight)
            for a in allocs:
                if room <= 0:
                    break
                if not a.desired_transition.migrate:
                    to_mark.append(a.id)
                    room -= 1
        if to_mark:
            self.state.update_alloc_desired_transition(to_mark,
                                                       migrate=True)
            self._create_node_evals(node_id)

    def update_allocs_from_client(self, allocs) -> None:
        """(reference :1309; upstream: node_endpoint.go:1322 UpdateAlloc)
        A client's alloc status updates: the store takes them (capacity a
        stopped alloc held frees only here, when its client says it is
        terminal), the jobs' statuses are refreshed, and a failed alloc
        of a live job enqueues one ``alloc-failure`` eval for its job,
        whose reschedule places with the node penalty. Terminal allocs'
        services leave the catalog in one write (reference :1317)."""
        self.state.update_allocs_from_client(allocs)
        terminal = [a.id for a in allocs if a.client_terminal_status()]
        if terminal:
            self.state.delete_services_by_allocs(terminal)
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

    def stop_alloc(self, alloc_id: str) -> Optional[str]:
        """(reference :1877; upstream: alloc_endpoint.go Stop) Ask for
        one alloc's migration and enqueue the eval that replaces it.
        Returns the eval's id, or None for an unknown alloc."""
        alloc = self.state.alloc_by_id(alloc_id)
        if alloc is None:
            return None
        updated = alloc.copy_skip_job()
        updated.job = alloc.job
        updated.desired_transition = DesiredTransition(migrate=True)
        self.state.upsert_allocs([updated])
        ev = Evaluation(
            id=generate_uuid(), namespace=alloc.namespace,
            job_id=alloc.job_id,
            priority=alloc.job.priority if alloc.job else 50,
            type=alloc.job.type if alloc.job else "service",
            triggered_by="alloc-stop", status=EVAL_STATUS_PENDING)
        self.state.upsert_evals([ev])
        self.broker.enqueue(ev)
        self.publish_event("AllocStopRequested", {"alloc_id": alloc_id})
        return ev.id

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
        if not result.is_no_op():
            self.publish_event("PlanApplied", {
                "eval_id": plan.eval_id,
                "placed": sum(len(v) for v in result.node_allocation.values()),
                "stopped": sum(len(v) for v in result.node_update.values()),
            })

    def on_eval_update(self, ev: Evaluation) -> None:
        if ev.status == EVAL_STATUS_COMPLETE:
            self._refresh_job_status(ev.namespace, ev.job_id)
        self.publish_event("EvalUpdated",
                           {"eval_id": ev.id, "status": ev.status})

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

    # ------------------------------------------------------------------
    # namespaces and node pools (reference :1408-1446; upstream:
    # nomad/namespace_endpoint.go, nomad/node_pool_endpoint.go)
    def upsert_namespace(self, namespace) -> None:
        if not namespace.name or "/" in namespace.name:
            raise ValueError(f"invalid namespace name {namespace.name!r}")
        self.state.upsert_namespace(namespace)
        self.publish_event("NamespaceUpserted", {"name": namespace.name})

    def delete_namespace(self, name: str) -> None:
        if name == "default":
            raise ValueError("default namespace cannot be deleted")
        if self.state.namespace_by_name(name) is None:
            raise ValueError(f"namespace {name!r} not found")
        in_use = [j.id for j in self.state.jobs() if j.namespace == name]
        if in_use:
            raise ValueError(
                f"namespace {name!r} has {len(in_use)} non-purged jobs")
        if self.state.variables(name):
            raise ValueError(f"namespace {name!r} has variables")
        self.state.delete_namespace(name)
        self.publish_event("NamespaceDeleted", {"name": name})

    def upsert_node_pool(self, pool) -> None:
        if not pool.name or pool.name == "all":
            raise ValueError(f"invalid node pool name {pool.name!r}")
        self.state.upsert_node_pool(pool)
        self.publish_event("NodePoolUpserted", {"name": pool.name})

    def delete_node_pool(self, name: str) -> None:
        if name in ("default", "all"):
            raise ValueError(f"built-in node pool {name!r} is undeletable")
        if self.state.node_pool_by_name(name) is None:
            raise ValueError(f"node pool {name!r} not found")
        nodes = [n.id for n in self.state.nodes() if n.node_pool == name]
        if nodes:
            raise ValueError(f"node pool {name!r} has {len(nodes)} nodes")
        jobs = [j.id for j in self.state.jobs() if j.node_pool == name]
        if jobs:
            raise ValueError(f"node pool {name!r} used by {len(jobs)} jobs")
        self.state.delete_node_pool(name)
        self.publish_event("NodePoolDeleted", {"name": name})

    # ------------------------------------------------------------------
    # the native service catalog (reference :1451-1469; upstream:
    # nomad/service_registration_endpoint.go)
    def upsert_services(self, regs) -> None:
        """Store the registrations of provider "nomad" that name a
        service; the others are not the catalog's."""
        regs = [r for r in regs if r.provider == "nomad" and r.service_name]
        if regs:
            self.state.upsert_service_registrations(regs)

    def service_names(self, namespace: Optional[str] = None) -> List[dict]:
        """One row a (namespace, service name): the union of its
        registrations' tags (upstream: ServiceRegistration.List)."""
        byname: Dict[tuple, dict] = {}
        for reg in self.state.service_registrations(namespace):
            entry = byname.setdefault(
                (reg.namespace, reg.service_name),
                {"namespace": reg.namespace,
                 "service_name": reg.service_name, "tags": []})
            for t in reg.tags:
                if t not in entry["tags"]:
                    entry["tags"].append(t)
        return list(byname.values())

    # ------------------------------------------------------------------
    # search (reference :1509; upstream: nomad/search_endpoint.go)
    def search(self, prefix: str, context: str = "all",
               namespace: Optional[str] = None,
               allowed_contexts: Optional[List[str]] = None,
               ns_allowed=None) -> dict:
        from .search import Searcher
        return Searcher(self.state, ns_allowed).prefix_search(
            prefix, context, namespace, allowed_contexts)

    def fuzzy_search(self, text: str, context: str = "all",
                     namespace: Optional[str] = None,
                     allowed_contexts: Optional[List[str]] = None,
                     ns_allowed=None) -> dict:
        from .search import Searcher
        return Searcher(self.state, ns_allowed).fuzzy_search(
            text, context, namespace, allowed_contexts)

    # ------------------------------------------------------------------
    # the event stream (upstream: nomad/stream/event_broker.go)
    @staticmethod
    def _event_key(payload: dict) -> str:
        for k in ("job_id", "node_id", "eval_id", "volume_id",
                  "dispatched_id", "name"):
            if payload.get(k):
                return str(payload[k])
        return ""

    def publish_event(self, topic: str, payload: dict) -> None:
        """(reference :1680) Append to the ring (4,096 events, cut to the
        newest 2,048 when full) and offer to every subscription."""
        event = {"topic": topic, "key": self._event_key(payload),
                 "index": self.state.latest_index(), "time": time.time(),
                 "payload": payload}
        with self._events_lock:
            self._events.append(event)
            if len(self._events) > 4096:
                self._events = self._events[-2048:]
            subs = list(self._event_subs)
        for sub in subs:
            sub.offer(event)

    def events_since(self, index: int) -> List[dict]:
        with self._events_lock:
            return [e for e in self._events if e["index"] > index]

    def subscribe_events(self, topics: Optional[Dict[str, List[str]]] = None,
                         since_index: int = 0) -> EventSubscription:
        """(reference :1697) ``topics``: {topic or *: [keys or *]}. The
        ring is replayed from ``since_index``, then the live events
        follow; replay and registration happen under one lock, so no
        event is lost or delivered out of order."""
        sub = EventSubscription(topics)
        with self._events_lock:
            if since_index:
                for e in self._events:
                    if e["index"] > since_index:
                        sub.offer(e)
            self._event_subs.append(sub)
        return sub

    def unsubscribe_events(self, sub: EventSubscription) -> None:
        with self._events_lock:
            if sub in self._event_subs:
                self._event_subs.remove(sub)

    # ------------------------------------------------------------------
    # the leader's loops
    def _run_heartbeat_watcher(self) -> None:
        """(reference :1720; upstream: heartbeat.go invalidateHeartbeat
        :138) A missed TTL marks the node down -- disconnected while one
        of its live allocs' task groups has disconnect grace -- and the
        node-down fan-out reschedules its allocs."""
        while not self._shutdown.wait(0.2):
            if not self._leader_active.is_set():
                continue
            now = time.time()
            expired = []
            with self._hb_lock:
                for node_id, dl in list(self._heartbeat_deadlines.items()):
                    if dl <= now:
                        expired.append(node_id)
                        del self._heartbeat_deadlines[node_id]
            for node_id in expired:
                if self.state.node_by_id(node_id) is None:
                    continue
                grace = False
                for a in self.state.allocs_by_node(node_id):
                    if a.terminal_status() or a.job is None:
                        continue
                    tg = a.job.lookup_task_group(a.task_group)
                    if tg is not None and tg.max_client_disconnect_s:
                        grace = True
                        break
                self.update_node_status(
                    node_id, NODE_STATUS_DISCONNECTED if grace
                    else NODE_STATUS_DOWN)

    def _run_gc(self) -> None:
        """(reference :1752; upstream: core_sched.go evalGC :236)"""
        while not self._shutdown.wait(GC_INTERVAL):
            if self._leader_active.is_set():
                self.run_gc_once()

    def run_gc_once(self, threshold: float = GC_EVAL_THRESHOLD,
                    terminal_watermark: Optional[int] = None) -> dict:
        """(reference :1758) One GC pass: terminal evals older than
        ``threshold`` whose allocs are all terminal, then the terminal
        allocs older than it whose eval is gone, then dead non-periodic
        jobs with no allocs or evals left, then the watermark pass
        (_gc_watermark), then the alloc table's compaction where freed
        rows dominate. Returns the counts and the compaction's stats."""
        cutoff = time.time() - threshold
        # the allocs of each eval, grouped in one pass (the reference
        # scans every alloc once an eval)
        by_eval: Dict[str, List[Allocation]] = {}
        for a in self.state.allocs():
            by_eval.setdefault(a.eval_id, []).append(a)
        gone_evals = []
        for ev in self.state.evals():
            if not ev.terminal_status():
                continue
            if all(a.terminal_status() for a in by_eval.get(ev.id, ())) \
                    and ev.modify_time < cutoff:
                gone_evals.append(ev.id)
        if gone_evals:
            self.state.delete_evals(gone_evals)
        gone_set = set(gone_evals)
        gone_allocs = [
            a.id for a in self.state.allocs()
            if a.terminal_status() and a.modify_time < cutoff
            and (a.eval_id in gone_set or not a.eval_id
                 or self.state.eval_by_id(a.eval_id) is None)]
        if gone_allocs:
            self.state.delete_allocs(gone_allocs)
        gone_jobs = 0
        for job in self.state.jobs():
            if job.status == JOB_STATUS_DEAD and not job.is_periodic():
                if not self.state.allocs_by_job(job.namespace, job.id) and \
                        not self.state.evals_by_job(job.namespace, job.id):
                    self.state.delete_job(job.namespace, job.id)
                    gone_jobs += 1
        wm = self._gc_watermark(terminal_watermark)
        compacted = self.state.compact_alloc_table()
        if compacted is not None:
            metrics.incr("nomad.gc.table_compactions")
        return {"evals": len(gone_evals), "allocs": len(gone_allocs),
                "jobs": gone_jobs, "watermark_allocs": wm,
                "compacted": compacted}

    def _gc_watermark(self, terminal_watermark: Optional[int]) -> int:
        """(reference :1805) Delete the oldest terminal allocs past the
        retention bound (NOMAD_TPU_TORCH_GC_ALLOC_WATERMARK; 0 keeps
        all), whatever their age. Returns how many went."""
        wm = terminal_watermark
        if wm is None:
            wm = int(os.environ.get("NOMAD_TPU_TORCH_GC_ALLOC_WATERMARK",
                                    str(GC_ALLOC_WATERMARK)) or 0)
        if wm <= 0:
            return 0
        terminal = [a for a in self.state.allocs() if a.terminal_status()]
        excess = len(terminal) - wm
        if excess <= 0:
            return 0
        terminal.sort(key=lambda a: a.modify_time)
        gone = [a.id for a in terminal[:excess]]
        self.state.delete_allocs(gone)
        metrics.incr("nomad.gc.watermark_allocs_deleted", len(gone))
        return len(gone)

    def _run_periodic(self) -> None:
        """(reference :1825; upstream: periodic.go:25) Launch each
        enabled ``@every <N>s`` periodic job once its interval has
        passed (not while a child lives, with prohibit_overlap)."""
        while not self._shutdown.wait(0.5):
            if not self._leader_active.is_set():
                continue
            now = time.time()
            for job in self.state.jobs():
                if not job.is_periodic() or job.stop:
                    continue
                p = job.periodic
                if not p.enabled or not p.spec.startswith("@every "):
                    continue
                try:
                    interval = float(p.spec[len("@every "):].rstrip("s"))
                except ValueError:
                    continue
                key = (job.namespace, job.id)
                if now - self._periodic_last.get(key, 0.0) < interval:
                    continue
                if p.prohibit_overlap and any(
                        j.parent_id == job.id and j.status != JOB_STATUS_DEAD
                        for j in self.state.jobs()):
                    continue
                self._periodic_last[key] = now
                self._dispatch_periodic(job, now)

    def _dispatch_periodic(self, job: Job, now: float) -> None:
        """(reference :1857; upstream: periodic.go:51 DispatchJob) The
        child job ``<id>/periodic-<unix seconds>``."""
        child = copy.deepcopy(job)
        child.id = f"{job.id}/periodic-{int(now)}"
        child.parent_id = job.id
        child.periodic = None
        self.register_job(child)

    def periodic_force(self, namespace: str, job_id: str) -> str:
        """(reference :1865; upstream: periodic_endpoint.go Force) Launch
        a periodic job's child now; returns the child's id."""
        job = self.state.job_by_id(namespace, job_id)
        if job is None:
            raise ValueError(f"unknown job {job_id!r}")
        if not job.is_periodic():
            raise ValueError(f"job {job_id!r} is not periodic")
        now = time.time()
        self._dispatch_periodic(job, now)
        return f"{job.id}/periodic-{int(now)}"

    # the deployment watcher (upstream: nomad/deploymentwatcher/)
    def _run_deployment_watcher(self) -> None:
        """(reference :1900) Watch every running deployment."""
        while not self._shutdown.wait(0.3):
            if not self._leader_active.is_set():
                continue
            for d in self.state.deployments():
                if not d.active() or d.status != DEPLOYMENT_STATUS_RUNNING:
                    continue
                self._watch_deployment(d)

    def _deployment_eval(self, d: Deployment, job: Job) -> None:
        ev = Evaluation(
            id=generate_uuid(), namespace=d.namespace,
            priority=d.eval_priority, type=job.type,
            triggered_by=TRIGGER_DEPLOYMENT_WATCHER, job_id=d.job_id,
            deployment_id=d.id, status=EVAL_STATUS_PENDING)
        self.state.upsert_evals([ev])
        self.broker.enqueue(ev)

    def pause_deployment(self, deployment_id: str, pause: bool) -> None:
        """(reference :1914; upstream: deployment_endpoint.go Pause) The
        watcher advances running deployments only."""
        d = self.state.deployment_by_id(deployment_id)
        if d is None:
            raise ValueError(f"unknown deployment {deployment_id!r}")
        if pause and d.status != DEPLOYMENT_STATUS_RUNNING:
            raise ValueError(f"deployment is {d.status}, not running")
        if not pause and d.status != DEPLOYMENT_STATUS_PAUSED:
            raise ValueError(f"deployment is {d.status}, not paused")
        nd = copy.deepcopy(d)
        nd.status = (DEPLOYMENT_STATUS_PAUSED if pause
                     else DEPLOYMENT_STATUS_RUNNING)
        nd.status_description = ("Deployment is paused" if pause
                                 else "Deployment is running")
        self.state.upsert_deployment_cas(nd, d.modify_index)
        self.publish_event("DeploymentPaused" if pause
                           else "DeploymentResumed",
                           {"deployment_id": deployment_id})

    def fail_deployment(self, deployment_id: str) -> None:
        """(reference :1936; upstream: deployment_endpoint.go Fail) Fail
        it and auto-revert the groups that ask for it, as the watcher's
        unhealthy path does."""
        d = self.state.deployment_by_id(deployment_id)
        if d is None:
            raise ValueError(f"unknown deployment {deployment_id!r}")
        if not d.active():
            raise ValueError(f"deployment is already {d.status}")
        nd = copy.deepcopy(d)
        nd.status = DEPLOYMENT_STATUS_FAILED
        nd.status_description = "Deployment marked as failed by operator"
        if self.state.upsert_deployment_cas(nd, d.modify_index):
            if any(st.auto_revert for st in nd.task_groups.values()):
                self._revert_job(nd)
        self.publish_event("DeploymentFailed",
                           {"deployment_id": deployment_id})

    def promote_deployment(self, deployment_id: str,
                           groups: Optional[List[str]] = None) -> None:
        """(reference :1956; upstream: deployment_endpoint.go Promote)
        Every targeted group must have its desired canaries healthy;
        promotion lets the reconciler's canary gate release the rest."""
        d = self.state.deployment_by_id(deployment_id)
        if d is None:
            raise ValueError(f"unknown deployment {deployment_id!r}")
        if d.status != DEPLOYMENT_STATUS_RUNNING:
            raise ValueError("deployment is not running")
        allocs = [a for a in self.state.allocs_by_job(d.namespace, d.job_id)
                  if a.deployment_id == d.id]
        nd = copy.deepcopy(d)
        targets = groups or list(nd.task_groups)
        for tg_name in targets:
            st = nd.task_groups.get(tg_name)
            if st is None:
                raise ValueError(f"unknown task group {tg_name!r}")
            if st.desired_canaries <= 0 or st.promoted:
                continue
            healthy_canaries = sum(
                1 for a in allocs
                if a.task_group == tg_name
                and a.deployment_status is not None
                and a.deployment_status.canary
                and a.deployment_status.is_healthy())
            if healthy_canaries < st.desired_canaries:
                raise ValueError(
                    f"group {tg_name!r}: {healthy_canaries}/"
                    f"{st.desired_canaries} canaries healthy")
            st.promoted = True
        if not self.state.upsert_deployment_cas(nd, d.modify_index):
            raise ValueError("deployment changed concurrently; retry")
        job = self.state.job_by_id(nd.namespace, nd.job_id)
        if job is not None and not job.stop:
            self._deployment_eval(nd, job)
        self.publish_event("DeploymentPromoted",
                           {"deployment_id": nd.id, "groups": targets})

    def _watch_deployment(self, d: Deployment) -> None:
        """(reference :2002) Recount each group's placed, healthy and
        unhealthy allocs: an unhealthy one fails the deployment (and
        auto-reverts where asked); every group healthy in full completes
        it and marks the job version stable; progress enqueues an eval
        so the reconciler releases the next batch; healthy canaries of
        an auto-promote deployment promote it. Every write is a CAS on
        the modify index the counts were read at: a conflict retries on
        the next tick."""
        allocs = [a for a in self.state.allocs_by_job(d.namespace, d.job_id)
                  if a.deployment_id == d.id]
        changed = False
        nd = copy.deepcopy(d)
        failed_tg = None
        for tg_name, st in nd.task_groups.items():
            tg_allocs = [a for a in allocs if a.task_group == tg_name]
            placed = len(tg_allocs)
            healthy = sum(1 for a in tg_allocs
                          if a.deployment_status is not None
                          and a.deployment_status.is_healthy())
            unhealthy = sum(1 for a in tg_allocs
                            if a.deployment_status is not None
                            and a.deployment_status.is_unhealthy())
            if (placed, healthy, unhealthy) != (
                    st.placed_allocs, st.healthy_allocs, st.unhealthy_allocs):
                st.placed_allocs = placed
                st.healthy_allocs = healthy
                st.unhealthy_allocs = unhealthy
                changed = True
            if unhealthy > 0:
                failed_tg = tg_name
        if failed_tg is not None:
            nd.status = DEPLOYMENT_STATUS_FAILED
            nd.status_description = (
                f"Failed due to unhealthy allocations in {failed_tg}")
            if self.state.upsert_deployment_cas(nd, d.modify_index):
                if nd.task_groups[failed_tg].auto_revert:
                    self._revert_job(nd)
            return
        job = self.state.job_by_id(nd.namespace, nd.job_id)
        complete = bool(nd.task_groups) and all(
            st.healthy_allocs >= st.desired_total
            for st in nd.task_groups.values())
        if complete and not nd.requires_promotion():
            nd.status = DEPLOYMENT_STATUS_SUCCESSFUL
            nd.status_description = "Deployment completed successfully"
            changed = True
            if job is not None and job.version == nd.job_version:
                self.state.update_job_stability(
                    nd.namespace, nd.job_id, nd.job_version, True)
        if changed:
            if not self.state.upsert_deployment_cas(nd, d.modify_index):
                return
            if job is not None and not job.stop and \
                    nd.status == DEPLOYMENT_STATUS_RUNNING:
                self._deployment_eval(nd, job)
        cur = self.state.deployment_by_id(d.id)
        if cur is not None and cur.status == DEPLOYMENT_STATUS_RUNNING \
                and cur.requires_promotion() and cur.has_auto_promote():
            try:
                self.promote_deployment(cur.id)
            except ValueError:
                pass            # canaries not healthy yet: the next tick

    def _revert_job(self, d: Deployment) -> None:
        """(reference :2080) Register the newest stable version before
        the deployment's job version again."""
        job = self.state.job_by_id(d.namespace, d.job_id)
        if job is None:
            return
        for v in range(job.version - 1, -1, -1):
            prev = self.state.job_version(d.namespace, d.job_id, v)
            if prev is not None and prev.stable:
                self.register_job(copy.deepcopy(prev))
                return
