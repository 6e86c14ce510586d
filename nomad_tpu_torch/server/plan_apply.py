"""Plan queue and applier: the serialization point of optimistic
concurrency (port of nomad_tpu/server/plan_apply.py; upstream:
nomad/plan_apply.go planApply :96, evaluatePlan :468,
evaluatePlanPlacements :507, evaluateNodePlan :717 -- the authoritative
AllocsFit re-check -- plan_queue.go and plan_apply_node_tracker.go).
Scheduler workers race against snapshots; every plan is verified here
against the LATEST state before it commits, and a partial commit hands
back a refresh index so the scheduler retries against fresher state.

The verify pre-pass is the reference's Python pre-pass (``_fast_check``):
the alloc table's per-node fold, the plan's deltas subtracted at most
once per alloc, the in-flight overlay, then ``verify_fit``. The
reference's default native pre-pass is decision-identical to it.

Knobs (read at each use):
  NOMAD_TPU_TORCH_PLAN_BATCH               0 turns group commit off: one
                                           plan a cycle, the serial commit
  NOMAD_TPU_TORCH_PLAN_BATCH_WINDOW_MS     how long an expected group is
                                           waited for, per arrival (100)
"""
from __future__ import annotations

import heapq
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import schedcheck, statecheck
from ..faultinject import faults
from .quality import observatory
from .telemetry import metrics
from .tracing import tracer
from ..structs import (
    Allocation, Evaluation, Plan, PlanResult, allocs_fit,
    NODE_STATUS_DISCONNECTED, NODE_STATUS_DOWN, NODE_STATUS_READY,
)


def verify_fit(cpu_cap, mem_cap, disk_cap, used_cpu, used_mem, used_disk,
               ask_cpu, ask_mem, ask_disk) -> np.ndarray:
    """Node-axis fit check: the failing dimension per node (0 fits, 1
    cpu, 2 memory, 3 disk; reference native.py:301, its numpy form)."""
    out = np.where(used_cpu + ask_cpu > cpu_cap, 1,
                   np.where(used_mem + ask_mem > mem_cap, 2,
                            np.where(used_disk + ask_disk > disk_cap, 3, 0)))
    return out.astype(np.int32)


def _batch_enabled() -> bool:
    """NOMAD_TPU_TORCH_PLAN_BATCH=0 is the kill switch: the dispatcher
    drains one plan at a time and commits each through the single-plan
    path."""
    return os.environ.get("NOMAD_TPU_TORCH_PLAN_BATCH", "1") != "0"


def _batch_window_s() -> float:
    try:
        return max(0.0, float(os.environ.get(
            "NOMAD_TPU_TORCH_PLAN_BATCH_WINDOW_MS", "100"))) / 1e3
    except ValueError:
        return 0.1


# plans drained a cycle
BATCH_MAX = 64
# first cross-worker conflict backoff: when two WORKERS' plans contend
# for the same nodes, the dispatcher holds its next drain briefly so the
# in-flight commit lands and the serialized plan re-verifies against
# fresh state; it doubles per consecutive conflicted cycle up to the cap
XWORKER_BACKOFF_S = 0.002
XWORKER_BACKOFF_MAX_S = 0.020


class _BatchPartial(Exception):
    """A group commit landed for SOME of its plans only (per-plan staging
    failure or a transaction split). Raised out of the committer future
    so the dispatcher's next cycle re-verifies against clean state
    instead of the now-wrong overlay; every waiter was already resolved
    individually before this is raised."""


class BadNodeTracker:
    """Tracks nodes that repeatedly reject plans (reference
    plan_apply.py:82; upstream: plan_apply_node_tracker.go). ``add``
    says whether a node crossed the threshold; ``score`` exposes its
    count."""

    def __init__(self, threshold: int = 100, window: float = 300.0):
        self.threshold = threshold
        self.window = window
        self._hits: Dict[str, List[float]] = {}
        self._lock = threading.Lock()
        self._last_sweep = time.time()

    def _sweep_locked(self, now: float) -> None:
        # bound the per-node dict: a node id whose whole window expired
        # is dropped entirely. Without this the dict only ever grows --
        # a 2M-alloc run that brushes every node id would hold every
        # one of them for the process lifetime.
        if now - self._last_sweep < self.window:
            return
        self._last_sweep = now
        cutoff = now - self.window
        for nid in list(self._hits):
            hits = self._hits[nid]
            while hits and hits[0] < cutoff:
                hits.pop(0)
            if not hits:
                del self._hits[nid]

    def add(self, node_id: str) -> bool:
        """Record a rejection; True if the node is now 'bad'."""
        now = time.time()
        with self._lock:
            hits = self._hits.setdefault(node_id, [])
            hits.append(now)
            cutoff = now - self.window
            while hits and hits[0] < cutoff:
                hits.pop(0)
            self._sweep_locked(now)
            return len(hits) >= self.threshold

    def score(self, node_id: str) -> int:
        now = time.time()
        with self._lock:
            hits = self._hits.get(node_id)
            if hits is None:
                return 0
            cutoff = now - self.window
            while hits and hits[0] < cutoff:
                hits.pop(0)
            if not hits:
                del self._hits[node_id]
                return 0
            self._sweep_locked(now)
            return len(hits)


class _OverlaySnapshot:
    """A state snapshot with an in-flight (submitted, not yet committed)
    plan result overlaid -- what upstream's optimistic snapshot gives
    verify(N+1) while apply(N) replicates (plan_apply.go:96-118
    pipeline). Only the two reads plan verification performs are
    overlaid."""

    def __init__(self, snapshot, inflight: PlanResult):
        self._snap = snapshot
        self._inflight = inflight
        self._removed = set()
        for allocs in inflight.node_update.values():
            self._removed.update(a.id for a in allocs)
        for allocs in inflight.node_preemptions.values():
            self._removed.update(a.id for a in allocs)

    def node_by_id(self, node_id: str):
        return self._snap.node_by_id(node_id)

    def allocs_by_node(self, node_id: str) -> List[Allocation]:
        out = [a for a in self._snap.allocs_by_node(node_id)
               if a.id not in self._removed]
        have = {a.id for a in out}
        for a in self._inflight.node_allocation.get(node_id, ()):
            if a.id not in have:
                out.append(a)
        return out


def _merge_results(results: List[PlanResult]) -> PlanResult:
    """One PlanResult overlaying a whole in-flight batch. The group's
    node sets are pairwise disjoint by construction, so the per-node
    dict merges can never collide."""
    merged = PlanResult(node_update={}, node_allocation={},
                        node_preemptions={})
    for r in results:
        merged.node_update.update(r.node_update)
        merged.node_allocation.update(r.node_allocation)
        merged.node_preemptions.update(r.node_preemptions)
    return merged


class _Pending:
    """One queued plan submission moving through the pipeline."""

    __slots__ = ("plan", "eval_updates", "event", "result", "error",
                 "seq", "trace_ctx", "worker", "conflict_retries",
                 "external")

    def __init__(self, plan, eval_updates, seq, trace_ctx=None,
                 worker=None):
        self.plan = plan
        self.eval_updates = eval_updates
        self.event = threading.Event()
        self.result: Optional[PlanResult] = None
        self.error: Optional[BaseException] = None
        self.seq = seq
        # the submitting eval thread's trace ctx, carried so the
        # dispatcher's and committer's spans land in its trace
        self.trace_ctx = trace_ctx
        # submitting worker identity (thread name): distinguishes
        # same-worker batch conflicts from CROSS-worker contention in
        # _select_group's serialization accounting
        self.worker = worker
        self.conflict_retries = 0
        self.external = False

    def resolve(self, result=None, error=None) -> None:
        self.result = result
        self.error = error
        if self.external:
            # the submitter's wait on the applier ends here (schedcheck)
            self.external = False
            schedcheck.external_end()
        self.event.set()


class Planner:
    """The leader's plan applier (reference plan_apply.py:208; upstream:
    plan_apply.go:24 planner).

    Pipelined (plan_apply.go:96-118): a priority queue feeds a dispatcher
    that verifies plan N+1 against an optimistic overlay snapshot WHILE
    plan N's commit (raft propose on clustered servers) is still in
    flight -- one outstanding commit, exactly upstream's window. A
    failed commit invalidates the overlay, so the already-verified
    successor is re-verified against clean state before committing
    (conservative: overlays can only over-count usage... except freed
    capacity from stops, which the re-verify covers). Verification fans
    out per node across a pool sized NumCPU/2 like upstream's
    EvaluatePool (plan_apply.go:113-118).

    GROUP COMMIT (the WAL / raft batched-apply move): instead of one
    plan per cycle, the dispatcher drains every queued plan whose node
    set is pairwise disjoint from the plans ahead of it (a cheap bitset
    test over AllocTable node slots -- disjoint plans cannot observe
    each other, so verifying them against one shared snapshot equals
    serial verification) and commits the group as ONE store transaction:
    one lock acquisition, one raft index bump, one snapshot
    invalidation, one blocked-evals unblock sweep. The first plan whose
    node set overlaps the group ends it -- it and everything behind it
    fall back to today's serial order (requeued ahead of the next
    cycle), so an overlapping plan never commits out of queue order.
    The solve barrier hints an incoming fused generation
    (``expect_plans``) so all of its plans land in one group instead of
    trickling into several. ``NOMAD_TPU_TORCH_PLAN_BATCH=0`` turns all
    of it off.

    Counters (the reference's ``nomad.plan.*`` metrics): plans_applied,
    plans_rejected, batches_committed, cross_worker_serialized and
    batch_conflict_serialized.
    """

    def __init__(self, state, pool_size: Optional[int] = None):
        self.state = state
        self.bad_nodes = BadNodeTracker()
        self._pool_size = pool_size or max(1, (os.cpu_count() or 2) // 2)
        self._pool = ThreadPoolExecutor(max_workers=self._pool_size,
                                        thread_name_prefix="plan-verify")
        self._committer = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="plan-commit")
        self.plans_applied = 0
        self.plans_rejected = 0
        self.batches_committed = 0
        self.cross_worker_serialized = 0
        self.batch_conflict_serialized = 0
        # one unblock sweep per committed batch (server wires this to
        # BlockedEvals; None = every plan unblocks individually via
        # server.on_plan_result, the legacy path)
        self.on_batch_commit = None
        # group-submission hint state (expect_plans)
        self._expect_n = 0
        self._expect_rolling = 0.0
        self._expect_hard = 0.0
        # cross-worker serialization backoff: consecutive
        # conflicted drain cycles escalate a bounded hold before the
        # next drain (min(base * 2**(n-1), max)); any clean cycle
        # resets.  Serialization itself is deterministic queue order
        # (-priority, seq): the conflicted plan retains its seq, so it
        # drains FIRST next cycle -- retry is bounded by construction.
        self._conflict_streak = 0
        self._backoff_until = 0.0
        # priority plan queue (upstream: plan_queue.go:99)
        self._cv = threading.Condition()
        self._heap: List[tuple] = []
        self._seq = 0
        self._shutdown = False
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="plan-dispatch")
        self._dispatcher.start()

    def shutdown(self, timeout: float = 10.0) -> None:
        """Drain the queue, then stop the dispatcher (waited for at most
        ``timeout`` seconds) and the verify and commit threads."""
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        # let the dispatcher drain queued plans BEFORE killing the pools
        # it verifies/commits on, or every drained waiter errors out
        self._dispatcher.join(timeout=timeout)
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._committer.shutdown(wait=True, cancel_futures=True)

    # ------------------------------------------------------------------
    def apply(self, plan: Plan,
              eval_updates: Optional[List[Evaluation]] = None,
              worker: Optional[str] = None) -> PlanResult:
        """Enqueue and wait (a blocking submit, upstream worker.go:650
        SubmitPlan). ``worker`` names the submitting pool worker for
        cross-worker conflict accounting."""
        faults.fire("plan.apply")   # chaos: raise -> eval nack/requeue
        if schedcheck._ACTIVE:
            # plan submission is the worker -> applier rendezvous: a
            # schedule decision point
            schedcheck.yield_point("plan.submit")
        with self._cv:
            if self._shutdown:
                raise RuntimeError("planner is shut down")
            self._seq += 1
            # worker stays None for direct (non-pool) submitters: the
            # cross-worker counter must only tally POOL contention, not
            # ad-hoc applier callers
            pending = _Pending(plan, eval_updates, self._seq,
                               trace_ctx=tracer.current(), worker=worker)
            if schedcheck._ACTIVE:
                # the applier's work on it is outside a controlled
                # schedule until resolve
                pending.external = True
                schedcheck.external_begin()
            heapq.heappush(self._heap,
                           (-plan.priority, pending.seq, pending))
            if self._expect_n > 0:
                # one expected group member arrived: roll the window so
                # the drain keeps holding while the generation streams in
                self._expect_n -= 1
                self._expect_rolling = time.monotonic() + _batch_window_s()
            metrics.sample("nomad.plan.queue_depth", float(len(self._heap)))
            self._cv.notify()
        # bounded re-check: the dispatcher resolves every pending entry,
        # success or failure, but a wedged commit should park us
        # re-checkably, not forever
        while not pending.event.wait(5.0):
            pass
        if pending.error is not None:
            raise pending.error
        return pending.result

    def expect_plans(self, n: int) -> None:
        """Group-submission hint from the solve barrier: ~n plans from
        one fused generation are about to be submitted, so the
        dispatcher holds its drain briefly and commits them as one
        group. Purely advisory -- a rolling per-arrival window plus a
        hard deadline bound the wait, so over-counted hints (multi-TG
        evals rendezvous once per TG; failed evals submit nothing) cost
        at most the window."""
        if n <= 0 or not _batch_enabled():
            return
        w = _batch_window_s()
        now = time.monotonic()
        with self._cv:
            self._expect_n += n
            self._expect_rolling = now + w
            self._expect_hard = max(self._expect_hard, now + 10 * w)
            self._cv.notify_all()

    # ------------------------------------------------------------------
    def _dispatch_loop(self) -> None:
        # inflight = (future, merged PlanResult overlay, commit items);
        # commits resolve their own waiters (success AND failure), so
        # the dispatcher never has to drain eagerly -- it keeps
        # verifying new arrivals while the commit replicates, which is
        # the pipeline
        inflight: Optional[tuple] = None
        while True:
            with self._cv:
                while not self._heap and not self._shutdown:
                    self._cv.wait(0.5)
                if self._shutdown and not self._heap:
                    break
                items = self._drain_locked()
            group = items
            if len(items) > 1:
                group, rest = self._select_group(items)
                if rest:
                    # conflicting plans (and everything behind them) go
                    # back to the queue BEFORE any processing, so a
                    # failure below can never error-resolve a plan that
                    # is still queued for a later commit
                    with self._cv:
                        for it in rest:
                            heapq.heappush(
                                self._heap,
                                (-it.plan.priority, it.seq, it))
                        self._cv.notify()
            try:
                inflight = self._process_batch(group, inflight)
            except BaseException as e:  # noqa: BLE001 -- waiters must wake
                for it in group:
                    if not it.event.is_set():
                        it.resolve(error=e)
        if inflight is not None:
            try:
                inflight[0].result()
            except BaseException:  # noqa: BLE001 -- shutdown drain
                pass

    def _drain_locked(self) -> List[_Pending]:
        """Pop the next commit candidates (cv held, heap non-empty).
        Serial mode pops exactly one; batch mode drains everything
        queued, first holding for the barrier's expected group within
        the rolling window."""
        if not _batch_enabled():
            return [heapq.heappop(self._heap)[2]]
        # cross-worker conflict backoff (bounded by the _MAX knob):
        # holding the drain lets the in-flight commit land so the
        # serialized plan re-verifies against fresh state
        while not self._shutdown:
            rem = self._backoff_until - time.monotonic()
            if rem <= 0:
                break
            self._cv.wait(min(rem, XWORKER_BACKOFF_MAX_S))
        while self._expect_n > 0 and not self._shutdown:
            now = time.monotonic()
            deadline = min(self._expect_rolling, self._expect_hard)
            if now >= deadline:
                self._expect_n = 0      # hint over-counted: stop waiting
                break
            self._cv.wait(deadline - now)
        items = []
        while self._heap and len(items) < BATCH_MAX:
            items.append(heapq.heappop(self._heap)[2])
        return items

    # ------------------------------------------------------------------
    def _plan_node_keys(self, plan: Plan) -> Tuple[List[int], set]:
        """The plan's touched nodes as AllocTable slots (the bitset
        domain) plus any ids the table has never seen."""
        table = self.state.alloc_table
        slots: List[int] = []
        unknown: set = set()
        for src in (plan.node_allocation, plan.node_update,
                    plan.node_preemptions):
            for nid in src:
                s = table.node_slot_of(nid)
                if s >= 0:
                    slots.append(s)
                else:
                    unknown.add(nid)
        return slots, unknown

    def _select_group(self, items: List[_Pending]
                      ) -> Tuple[List[_Pending], List[_Pending]]:
        """Maximal pairwise-DISJOINT prefix in queue order. Disjoint
        node sets cannot observe each other, so the group verifies
        against one shared snapshot and commits as one transaction with
        results identical to serial order. The first overlapping plan
        ends the group -- it and everything behind it keep today's
        serial order (a later plan must never commit ahead of an
        earlier one whose verification could see it)."""
        table = self.state.alloc_table
        claimed = np.zeros(max(table.n_nodes, 1), dtype=bool)
        claimed_unknown: set = set()
        group: List[_Pending] = []
        group_workers: set = set()
        for k, it in enumerate(items):
            slots, unknown = self._plan_node_keys(it.plan)
            arr = np.asarray(slots, dtype=np.int64) if slots else None
            if ((arr is not None and bool(claimed[arr].any()))
                    or (unknown
                        and not claimed_unknown.isdisjoint(unknown))):
                it.conflict_retries += 1
                if (it.worker is not None and group_workers
                        and it.worker not in group_workers):
                    # node-overlapping plans from DIFFERENT pool
                    # workers: the N-worker contention case.
                    # Serialized deterministically in queue order (never
                    # rejected) -- the conflicted plan keeps its seq, so
                    # it drains first next cycle and commits against the
                    # state this group just wrote.  The first retry
                    # re-drains IMMEDIATELY: the group commit it
                    # conflicted with is already in flight and verify
                    # overlays it, so a hold would only tax the applier
                    # loop (a flat per-conflict hold measured as a ~27%
                    # batched-pipeline throughput drop).  Only a plan
                    # that RE-conflicts arms the escalating bounded
                    # backoff, giving the in-flight commit time to land.
                    self.cross_worker_serialized += 1
                    metrics.incr("nomad.plan.cross_worker_serialized")
                    if it.conflict_retries >= 2:
                        self._conflict_streak += 1
                        hold = min(XWORKER_BACKOFF_S
                                   * (2 ** (self._conflict_streak - 1)),
                                   XWORKER_BACKOFF_MAX_S)
                        self._backoff_until = time.monotonic() + hold
                else:
                    self.batch_conflict_serialized += 1
                    metrics.incr("nomad.plan.batch_conflict_serialized")
                return group, items[k:]
            if arr is not None:
                claimed[arr] = True
            claimed_unknown |= unknown
            group.append(it)
            if it.worker is not None:
                group_workers.add(it.worker)
        self._conflict_streak = 0
        return group, []

    def _process_batch(self, items: List[_Pending], inflight):
        """Verify a group of plans (overlaying the in-flight commit),
        then submit ONE grouped commit asynchronously. Returns the new
        in-flight tuple. The caller already reduced ``items`` to a
        pairwise-disjoint group."""
        metrics.sample("nomad.plan.batch_size", float(len(items)))
        snapshot = self.state.snapshot()
        overlaid = (_OverlaySnapshot(snapshot, inflight[1])
                    if inflight is not None else snapshot)
        results = []
        for it in items:
            with metrics.measure("nomad.plan.evaluate"), \
                    tracer.span("plan.evaluate", ctx=it.trace_ctx,
                                overlay=inflight is not None,
                                nodes=len(it.plan.node_allocation)):
                results.append(self._evaluate_plan(overlaid, it.plan))

        # serialize commits: wait for the previous one (its replication
        # overlapped this verification, which is the whole point)
        if inflight is not None:
            try:
                inflight[0].result()   # waiters resolved inside commit
                prev_ok = True
            except BaseException:  # noqa: BLE001
                prev_ok = False
            if not prev_ok:
                # the overlay assumed a commit that never (fully)
                # landed -- freed-capacity assumptions may be wrong:
                # re-verify the whole group clean
                fresh = self.state.snapshot()
                results = []
                for it in items:
                    with metrics.measure("nomad.plan.evaluate"), \
                            tracer.span("plan.evaluate",
                                        ctx=it.trace_ctx,
                                        overlay=False, reverify=True):
                        results.append(self._evaluate_plan(fresh, it.plan))

        # bad-node hits are recorded ONCE, for the result that actually
        # decides the plan (a discarded overlay pass must not count)
        commit_items: List[Tuple[_Pending, PlanResult]] = []
        for it, result in zip(items, results):
            for node_id in result.rejected_nodes:
                self.bad_nodes.add(node_id)
            # rejected placements never reach the alloc-delta journal:
            # the quality observatory's churn learns of them here
            observatory.note_rejected(len(result.rejected_nodes))
            if result.is_no_op() and not it.plan.is_no_op():
                result.refresh_index = self.state.latest_index()
                self.plans_rejected += 1
                tracer.event("plan.rejected", ctx=it.trace_ctx,
                             rejected=len(result.rejected_nodes))
                it.resolve(result=result)
            else:
                commit_items.append((it, result))
        if not commit_items:
            return None

        if len(commit_items) == 1:
            it, result = commit_items[0]
            future = self._committer.submit(self._commit_one, it, result)
            return (future, result, commit_items)
        future = self._committer.submit(self._commit_group, commit_items)
        overlay = _merge_results([r for _, r in commit_items])
        return (future, overlay, commit_items)

    def _commit_one(self, item: _Pending, result: PlanResult) -> int:
        """The single-plan commit (also the batch-of-one path and every
        commit under NOMAD_TPU_TORCH_PLAN_BATCH=0)."""
        try:
            with metrics.measure("nomad.plan.commit"), \
                    tracer.span("plan.commit", ctx=item.trace_ctx,
                                batch=1,
                                rejected=len(result.rejected_nodes)):
                index = self.state.upsert_plan_results(result,
                                                       item.eval_updates)
        except BaseException as e:  # noqa: BLE001 -- waiter must wake
            item.resolve(error=e)
            raise
        result.alloc_index = index
        if result.rejected_nodes:
            result.refresh_index = index
        self.plans_applied += 1
        item.resolve(result=result)
        return index

    def _commit_group(self, commit_items) -> int:
        """One grouped store transaction for N disjoint verified plans.
        A whole-transaction failure splits the batch: each plan retries
        serially so survivors still commit exactly once; per-plan
        staging failures (the plan.commit chaos point) resolve only
        their own waiter. Either failure mode poisons the overlay (the
        raised exception) so the next cycle re-verifies clean."""
        gctx = tracer.group([it.trace_ctx for it, _ in commit_items])
        entries = [(r, it.eval_updates) for it, r in commit_items]
        try:
            with metrics.measure("nomad.plan.commit"), \
                    tracer.activate(gctx), \
                    tracer.span("plan.commit", ctx=gctx,
                                batch=len(commit_items),
                                rejected=sum(len(r.rejected_nodes)
                                             for _, r in commit_items)):
                index, outcomes = self.state.apply_plan_results_batch(
                    entries)
        except BaseException:  # noqa: BLE001 -- split the batch
            for it, r in commit_items:
                if it.event.is_set():
                    continue
                try:
                    self._commit_one(it, r)
                except BaseException:  # noqa: BLE001 -- keep splitting
                    pass               # (waiter already resolved inside)
            raise _BatchPartial("group commit split to serial")

        committed: List[PlanResult] = []
        failed = False
        for (it, r), out in zip(commit_items, outcomes):
            if out is not None:
                failed = True
                it.resolve(error=out)
                continue
            r.alloc_index = index
            if r.rejected_nodes:
                r.refresh_index = index
            r.batch_unblocked = True    # server skips per-plan unblock
            self.plans_applied += 1
            committed.append(r)
            it.resolve(result=r)
        self.batches_committed += 1
        hook = self.on_batch_commit
        if hook is not None and committed:
            try:
                hook(committed)         # ONE unblock sweep per batch
            except Exception:  # noqa: BLE001 -- sweep must not kill
                pass                    # the committer
        if failed:
            raise _BatchPartial("plan staging failed mid-batch")
        return index

    # ------------------------------------------------------------------
    def _evaluate_plan(self, snapshot, plan: Plan) -> PlanResult:
        """Per-node re-verification (reference :633; upstream:
        evaluatePlanPlacements :507). Nodes whose placements no longer
        fit are trimmed from the result (partial commit) unless
        plan.all_at_once. Its table reads must all see one version:
        statecheck's strict scope (an inert context when off)."""
        with statecheck.strict_scope("plan.verify"):
            return self._evaluate_plan_scoped(snapshot, plan)

    def _evaluate_plan_scoped(self, snapshot, plan: Plan) -> PlanResult:
        result = PlanResult(
            node_update={k: list(v) for k, v in plan.node_update.items()},
            node_allocation={},
            node_preemptions={k: list(v)
                              for k, v in plan.node_preemptions.items()},
            deployment=plan.deployment,
            deployment_updates=list(plan.deployment_updates),
        )

        node_ids = list(plan.node_allocation.keys())

        # The pre-pass: a cpu/mem/disk check across all touched nodes. A
        # reject is authoritative -- ports/cores/devices can only add MORE
        # rejections, never rescue a resource overflow. A PASS is also
        # authoritative when nothing on the node involves ports, cores or
        # devices (the dimensions the pre-pass does not model): the full
        # allocs_fit walk is skipped for those, leaving the node-status
        # checks.
        fast_reject, fast_fit = self._fast_check(snapshot, plan, node_ids)

        def check(node_id: str) -> Tuple[str, bool, str]:
            dim = fast_reject.get(node_id)
            if dim:
                return node_id, False, dim
            ok, reason = self._evaluate_node_plan(
                snapshot, plan, node_id, skip_fit=node_id in fast_fit)
            return node_id, ok, reason

        # chunk the fan-out by hand: one future per node would cost more
        # in executor machinery than the check itself, and
        # ThreadPoolExecutor.map ignores its chunksize argument
        checks: List[Tuple[str, bool, str]] = []
        if node_ids:
            size = max(8, len(node_ids) // (self._pool_size * 4))
            chunks = [node_ids[i:i + size]
                      for i in range(0, len(node_ids), size)]
            for part in self._pool.map(
                    lambda ids: [check(nid) for nid in ids], chunks):
                checks.extend(part)

        rejected: List[str] = []
        for node_id, ok, reason in checks:
            if ok:
                result.node_allocation[node_id] = list(
                    plan.node_allocation[node_id])
            else:
                rejected.append(node_id)

        if rejected and plan.all_at_once:
            # all-or-nothing (upstream: evaluatePlan AllAtOnce handling)
            result.node_allocation = {}
            result.deployment = None
            result.deployment_updates = []
        result.rejected_nodes = rejected
        return result

    @staticmethod
    def _alloc_special(a) -> bool:
        return a.allocated_resources.has_special_dimensions()

    def _fast_check(self, snapshot, plan: Plan, node_ids
                    ) -> Tuple[Dict[str, str], set]:
        """The pre-pass (reference :709): a batch cpu/mem/disk check.
        Returns (node_id -> failing dimension for definite rejects, set
        of node_ids whose fit is fully proven). Nodes in neither get the
        full authoritative check.

        The committed-state usage comes from AllocTable.fold_verify
        (read under the store lock, so a half-applied commit cannot tear
        it) instead of a per-node walk. Plan deltas (stops, preemptions,
        in-place replacements) and the pipeline overlay's in-flight plan
        are then adjusted on top -- each touches only the plan-sized
        sets, not the fleet."""
        n = len(node_ids)
        if n < 8:       # not worth the batch setup
            return {}, set()
        base_snap = getattr(snapshot, "_snap", snapshot)
        inflight = getattr(snapshot, "_inflight", None)
        overlay_removed = getattr(snapshot, "_removed", frozenset())
        table = getattr(base_snap, "alloc_table", None)
        store = getattr(base_snap, "_store", None)
        if table is None or store is None:
            return {}, set()    # exotic snapshot: python path checks all

        caps = [np.zeros(n) for _ in range(3)]
        asks = [np.zeros(n) for _ in range(3)]
        valid = np.zeros(n, dtype=bool)
        plain_nodes = np.ones(n, dtype=bool)
        pos_of: Dict[str, int] = {}
        for k, node_id in enumerate(node_ids):
            node = base_snap.node_by_id(node_id)
            if node is None:
                continue
            valid[k] = True
            pos_of[node_id] = k
            # static per-node facts, cached on the (replace-on-write)
            # node object: caps minus reserved, and whether the NODE
            # itself carries reserved ports (allocs_fit validates them
            # via NetworkIndex.set_node independent of any alloc)
            fc = node.__dict__.get("_fc_caps")
            if fc is None:
                fc = (node.node_resources.cpu.cpu_shares
                      - node.reserved_resources.cpu_shares,
                      node.node_resources.memory.memory_mb
                      - node.reserved_resources.memory_mb,
                      node.node_resources.disk.disk_mb
                      - node.reserved_resources.disk_mb,
                      bool(node.reserved_resources.reserved_ports))
                node.__dict__["_fc_caps"] = fc
            caps[0][k], caps[1][k], caps[2][k] = fc[0], fc[1], fc[2]
            if fc[3]:
                plain_nodes[k] = False

        with store._lock:
            used_c, used_m, used_d, spec_any, _found = \
                table.fold_verify(node_ids)

            subtracted: set = set()

            def subtract_row(alloc_id: str, k: int) -> None:
                # at most once per alloc: the same id can appear in this
                # plan's stops AND the in-flight plan's removed set (the
                # old python path's set-union semantics); a double
                # subtraction would undercount usage and let an
                # overcommitted placement skip the authoritative check
                if alloc_id in subtracted:
                    return
                row = table._row_of.get(alloc_id)
                if row is None or not table.live_strict[row]:
                    return
                subtracted.add(alloc_id)
                used_c[k] -= table.cpu[row]
                used_m[k] -= table.mem[row]
                used_d[k] -= table.disk[row]

            for nid, allocs in plan.node_update.items():
                k = pos_of.get(nid)
                if k is not None:
                    for a in allocs:
                        subtract_row(a.id, k)
            for nid, allocs in plan.node_preemptions.items():
                k = pos_of.get(nid)
                if k is not None:
                    for a in allocs:
                        subtract_row(a.id, k)
            for nid, allocs in plan.node_allocation.items():
                k = pos_of.get(nid)
                if k is None:
                    continue
                for a in allocs:
                    # in-place update: the existing row is REPLACED
                    subtract_row(a.id, k)
                    cr = a.allocated_resources.comparable()
                    asks[0][k] += cr.cpu_shares
                    asks[1][k] += cr.memory_mb
                    asks[2][k] += cr.disk_mb
                    if plain_nodes[k] and self._alloc_special(a):
                        plain_nodes[k] = False
            if overlay_removed:
                slot_to_k = {table.node_slot_of(nid): k
                             for nid, k in pos_of.items()}
                for aid in overlay_removed:
                    row = table._row_of.get(aid)
                    if row is not None and table.live_strict[row]:
                        k = slot_to_k.get(int(table.node_slot[row]))
                        if k is not None:
                            subtract_row(aid, k)

            if inflight is not None:
                # the pipelined previous plan consumes capacity the
                # fold may not see yet -- but its commit RACES this
                # verify, so each alloc counts only if its row hasn't
                # landed in the table (else it would count twice and
                # spuriously reject)
                for nid, allocs in inflight.node_allocation.items():
                    k = pos_of.get(nid)
                    if k is None:
                        continue
                    for a in allocs:
                        if a.id in table._row_of:
                            continue
                        cr = a.allocated_resources.comparable()
                        used_c[k] += cr.cpu_shares
                        used_m[k] += cr.memory_mb
                        used_d[k] += cr.disk_mb
                        if plain_nodes[k] and self._alloc_special(a):
                            plain_nodes[k] = False

        plain = plain_nodes & ~spec_any
        dims = verify_fit(*caps, used_c, used_m, used_d, *asks)
        names = {1: "cpu", 2: "memory", 3: "disk"}
        rejects = {node_ids[k]: names[int(dims[k])]
                   for k in range(n) if valid[k] and dims[k] != 0}
        fit = {node_ids[k] for k in range(n)
               if valid[k] and dims[k] == 0 and plain[k]}
        return rejects, fit

    def _evaluate_node_plan(self, snapshot, plan: Plan, node_id: str,
                            skip_fit: bool = False) -> Tuple[bool, str]:
        """(reference :973; upstream: evaluateNodePlan plan_apply.go:717).
        ``skip_fit``
        elides the allocs_fit walk when _fast_check already proved it;
        the node-status gates always run."""
        new_allocs = plan.node_allocation.get(node_id, [])
        node = snapshot.node_by_id(node_id)
        if node is None:
            return not new_allocs, "node does not exist"
        if new_allocs:
            if node.status == NODE_STATUS_DOWN:
                return False, "node is down"
            if node.status == NODE_STATUS_DISCONNECTED:
                # only reconnect updates allowed (upstream: :745)
                for a in new_allocs:
                    if a.client_status not in ("unknown", "running"):
                        return False, "node is disconnected"
            elif node.status != NODE_STATUS_READY:
                return False, f"node is {node.status}"

        if skip_fit:
            return True, ""

        existing = snapshot.allocs_by_node(node_id)
        removed = set()
        for a in plan.node_update.get(node_id, ()):
            removed.add(a.id)
        for a in plan.node_preemptions.get(node_id, ()):
            removed.add(a.id)
        proposed: Dict[str, Allocation] = {}
        for a in existing:
            if a.id in removed or a.terminal_status():
                continue
            proposed[a.id] = a
        for a in new_allocs:
            proposed[a.id] = a

        fit, dim, _ = allocs_fit(node, list(proposed.values()),
                                 check_devices=True)
        if not fit:
            return False, dim
        return True, ""
