"""Evaluation broker: the priority work queue feeding scheduler workers
(port of nomad_tpu/server/broker.py; upstream: nomad/eval_broker.go
EvalBroker :52, Enqueue :201, Dequeue :354, Ack :555, Nack :632, the
delayed-eval heap :791, and blocked_evals.go BlockedEvals :35,
class-keyed unblocking). Leader-only upstream; here enabled and disabled
the same way.

Knobs (read when a broker is built):
  NOMAD_TPU_TORCH_STORM_ADMISSION  0 turns storm admission and ready-depth
                                   shedding off (1)
  NOMAD_TPU_TORCH_STORM_WAVE       evals a storm admits at once (256)
  NOMAD_TPU_TORCH_STORM_RATE       deferred-release rate, evals/s (1000)
  NOMAD_TPU_TORCH_BROKER_MAX_READY ready depth past which an enqueue is
                                   deferred (8192; 0 = no bound)
  NOMAD_TPU_TORCH_BROKER_SHED_DELAY  the deferral of a shed eval, s (0.5)
  NOMAD_TPU_TORCH_POISON_AFTER     exhausted delivery cycles that
                                   quarantine an eval (3; 0 = never)
"""
from __future__ import annotations

import heapq
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from .. import schedcheck
from ..faultinject import faults
from .telemetry import metrics
from .tracing import tracer
from ..structs import (
    Evaluation, EVAL_STATUS_PENDING, TRIGGER_QUEUED_ALLOCS,
)

_log = logging.getLogger(__name__)

DEFAULT_NACK_TIMEOUT = 60.0
DEFAULT_DELIVERY_LIMIT = 3
FAILED_QUEUE = "_failed"


class EvalBroker:
    """(reference broker.py:26; upstream: eval_broker.go:52)

    Storm admission: a mass-rescheduling fan-out (a node-down eval storm)
    enters through ``enqueue_storm``, which admits one bounded wave at
    once and defers the rest onto the delayed heap at a paced release
    rate; every path into the ready queues sheds to the delayed heap
    once the ready depth reaches ``max_ready``. Nothing is dropped: an
    overload becomes deferred evals.

    Poison quarantine: an eval that exhausts its ``delivery_limit``
    ``poison_after`` times moves to a dead-letter dict instead of the
    failed-queue retry loop; the job's waiting evals promote past it,
    and ``release_quarantined`` re-admits it.
    """

    def __init__(self, nack_timeout: float = DEFAULT_NACK_TIMEOUT,
                 delivery_limit: int = DEFAULT_DELIVERY_LIMIT):
        self.nack_timeout = nack_timeout
        self.delivery_limit = delivery_limit
        self.admission_enabled = \
            os.environ.get("NOMAD_TPU_TORCH_STORM_ADMISSION", "1") != "0"
        self.storm_wave = int(os.environ.get("NOMAD_TPU_TORCH_STORM_WAVE",
                                             "256"))
        self.storm_rate = float(os.environ.get("NOMAD_TPU_TORCH_STORM_RATE",
                                               "1000"))
        self.max_ready = int(os.environ.get("NOMAD_TPU_TORCH_BROKER_MAX_READY",
                                            "8192"))
        self.shed_delay_s = float(os.environ.get(
            "NOMAD_TPU_TORCH_BROKER_SHED_DELAY", "0.5"))
        self.poison_after = int(os.environ.get(
            "NOMAD_TPU_TORCH_POISON_AFTER", "3"))
        self._lock = threading.Condition()
        self.enabled = False
        # sched type -> heap of (-priority, seq, eval)
        self._ready: Dict[str, list] = {}
        self._unack: Dict[str, Tuple[Evaluation, str, float]] = {}  # id -> (eval, token, deadline)
        self._waiting: Dict[str, Evaluation] = {}   # dedup: pending per job
        self._evals: Dict[str, int] = {}            # eval id -> dequeue count
        self._delayed: list = []                    # (wait_until, seq, eval)
        # poison-eval dead letters: id -> {"eval", "strikes", "at"};
        # strikes count delivery-limit exhaustions per eval id
        self._quarantine: Dict[str, dict] = {}
        self._poison_strikes: Dict[str, int] = {}
        self._enqueued_at: Dict[str, float] = {}    # eval id -> ready time
        self._seq = 0
        self._timer_thread: Optional[threading.Thread] = None
        self._shutdown = False

    # ------------------------------------------------------------------
    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            was = self.enabled
            self.enabled = enabled
            if not enabled:
                # flush everything (upstream: broker.flush on disable)
                self._ready.clear()
                self._unack.clear()
                self._waiting.clear()
                self._evals.clear()
                self._delayed = []
                self._quarantine.clear()
                self._poison_strikes.clear()
                self._enqueued_at.clear()
            self._lock.notify_all()
        if enabled and not was:
            self._start_delayed_watcher()

    def _start_delayed_watcher(self) -> None:
        if self._timer_thread is not None and self._timer_thread.is_alive():
            return
        self._timer_thread = threading.Thread(
            target=self._run_delayed_watcher, daemon=True,
            name="eval-broker-delayed")
        self._timer_thread.start()

    def _run_delayed_watcher(self) -> None:
        """Move delayed evals into the ready queues when their wait_until
        passes (upstream: eval_broker.go:791 runDelayedEvalsWatcher), and
        periodically retry failed evals (upstream: the leader's
        failed-eval follow-up, leader.go reapFailedEvaluations)."""
        last_failed_retry = time.time()
        while True:
            with self._lock:
                if self._shutdown or not self.enabled:
                    return
                now = time.time()
                while self._delayed and self._delayed[0][0] <= now:
                    if schedcheck._ACTIVE:
                        # each delayed release is a decision point
                        schedcheck.yield_point("broker.delayed_pop")
                    _, _, ev = heapq.heappop(self._delayed)
                    self._enqueue_locked(ev)
                if now - last_failed_retry >= self.nack_timeout / 2:
                    last_failed_retry = now
                    failed = self._ready.pop(FAILED_QUEUE, None)
                    if failed:
                        for _, _, ev in failed:
                            self._evals.pop(ev.id, None)  # reset deliveries
                            self._enqueue_locked(ev)
                        self._lock.notify_all()
                timeout = (self._delayed[0][0] - now) if self._delayed else 1.0
                self._lock.wait(min(max(timeout, 0.01), 1.0))

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop the delayed watcher and wait for it, at most ``timeout``
        seconds."""
        with self._lock:
            self._shutdown = True
            self._lock.notify_all()
        t = self._timer_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout)

    # ------------------------------------------------------------------
    def enqueue(self, ev: Evaluation) -> None:
        with self._lock:
            self._process_enqueue(ev)
            self._lock.notify_all()

    def enqueue_all(self, evals: List[Evaluation]) -> None:
        with self._lock:
            for ev in evals:
                self._process_enqueue(ev)
            self._lock.notify_all()

    def _ready_depth_locked(self) -> int:
        return sum(len(h) for s, h in self._ready.items()
                   if s != FAILED_QUEUE)

    def enqueue_storm(self, evals: List[Evaluation]) -> None:
        """Admission-controlled mass enqueue for node-down fan-outs: the
        first ``storm_wave`` evals (while ready depth allows) admit
        immediately; the remainder are deferred onto the delayed heap in
        wave-sized groups released at ``storm_rate`` evals/s. Nothing is
        dropped -- a deferred eval is a followup eval with a later
        release time."""
        with self._lock:
            if not self.enabled:
                return
            if not self.admission_enabled:
                for ev in evals:
                    self._process_enqueue(ev)
                self._lock.notify_all()
                return
            now = time.time()
            depth = self._ready_depth_locked()
            wave = max(1, self.storm_wave)
            admitted = deferred = 0
            for ev in evals:
                room = (admitted < wave
                        and (not self.max_ready
                             or depth + admitted < self.max_ready))
                if room and not (ev.wait_until
                                 and ev.wait_until > now):
                    self._process_enqueue(ev)
                    admitted += 1
                    continue
                wave_idx = deferred // wave + 1
                release = now + wave_idx * (wave / max(1.0,
                                                       self.storm_rate))
                if ev.wait_until and ev.wait_until > release:
                    release = ev.wait_until
                self._seq += 1
                heapq.heappush(self._delayed, (release, self._seq, ev))
                deferred += 1
            self._lock.notify_all()
        if deferred:
            metrics.incr("nomad.broker.storm_deferred", deferred)

    def _process_enqueue(self, ev: Evaluation) -> None:
        if not self.enabled:
            return
        if ev.id in self._quarantine:
            return  # dead-lettered: only an operator release re-admits
        if ev.id in self._evals and ev.id not in self._unack:
            return  # already tracked and ready
        if ev.wait_until and ev.wait_until > time.time():
            self._seq += 1
            heapq.heappush(self._delayed, (ev.wait_until, self._seq, ev))
            return
        self._enqueue_locked(ev)

    def _enqueue_locked(self, ev: Evaluation) -> None:
        # Dedup: one eval per job in-flight; extras wait
        # (upstream: eval_broker.go blocked/waiting tracking by job)
        namespaced_job = (ev.namespace, ev.job_id)
        for other in list(self._unack.values()):
            if (other[0].namespace, other[0].job_id) == namespaced_job:
                self._waiting[ev.id] = ev
                return
        # queue-depth shedding: past max_ready the eval degrades to a
        # DEFERRED eval (delayed heap, re-admitted once depth recedes)
        # instead of growing the ready queue without bound; also catches
        # the delayed watcher's releases under sustained overload
        if self.admission_enabled and self.max_ready and \
                self._ready_depth_locked() >= self.max_ready:
            self._seq += 1
            heapq.heappush(self._delayed,
                           (time.time() + self.shed_delay_s,
                            self._seq, ev))
            metrics.incr("nomad.broker.shed_deferred")
            return
        self._seq += 1
        sched = ev.type
        self._ready.setdefault(sched, [])
        heapq.heappush(self._ready[sched], (-ev.priority, self._seq, ev))
        self._evals.setdefault(ev.id, 0)
        self._enqueued_at.setdefault(ev.id, time.time())

    # ------------------------------------------------------------------
    def dequeue(self, schedulers: List[str], timeout: Optional[float] = None
                ) -> Tuple[Optional[Evaluation], str]:
        """Blocking dequeue; returns (eval, ack-token)
        (upstream: eval_broker.go:354)."""
        faults.fire("broker.dequeue")   # chaos: stall/error the feed
        deadline = time.time() + timeout if timeout is not None else None
        with self._lock:
            while True:
                if not self.enabled:
                    return None, ""
                self._check_nack_timeouts_locked()
                popped = self._pop_ready_locked(schedulers)
                if popped is not None:
                    return popped
                if deadline is not None:
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        return None, ""
                    self._lock.wait(min(remaining, 0.5))
                else:
                    self._lock.wait(0.5)

    def _pop_ready_locked(self, schedulers: List[str],
                          exclude_jobs: Optional[Set[Tuple[str, str]]] = None
                          ) -> Optional[Tuple[Evaluation, str]]:
        """Pop the highest-priority ready eval across the given scheduler
        queues, mint its ack token, and move it to unacked. Shared by
        dequeue() and dequeue_batch(); `exclude_jobs` implements the
        batched path's distinct-jobs rule. A ready eval whose job has an
        eval outstanding moves to the job's waiting evals (promoted by
        that eval's ack): two evals of one job never run at once, also
        when both were ready before either was leased (upstream:
        eval_broker.go's per-job pending set covers ready evals too)."""
        busy = {(e.namespace, e.job_id) for e, _, _ in self._unack.values()}
        best, best_key = None, None
        for sched in schedulers:
            heap = self._ready.get(sched)
            while heap and (heap[0][2].id in self._unack or (
                    heap[0][2].namespace, heap[0][2].job_id) in busy):
                _, _, held = heapq.heappop(heap)
                if held.id not in self._unack:
                    self._waiting[held.id] = held
            if not heap:
                continue
            if exclude_jobs is not None and (
                    heap[0][2].namespace, heap[0][2].job_id) in exclude_jobs:
                continue
            key = heap[0][:2]
            if best is None or key < best_key:
                best, best_key = sched, key
        if best is None:
            return None
        _, _, ev = heapq.heappop(self._ready[best])
        token = f"token-{ev.id}-{self._evals.get(ev.id, 0)}"
        self._evals[ev.id] = self._evals.get(ev.id, 0) + 1
        self._unack[ev.id] = (ev, token, time.time() + self.nack_timeout)
        t_ready = self._enqueued_at.pop(ev.id, None)
        if t_ready is not None:
            wait_s = time.time() - t_ready
            metrics.sample_ms("nomad.broker.eval_wait", wait_s * 1e3)
            # the eval's trace starts here: the wait span is recorded
            # after the fact from the enqueue time
            ctx = tracer.begin(ev.id, job=ev.job_id, lane=ev.type,
                               trigger=ev.triggered_by,
                               priority=ev.priority)
            tracer.record("broker.wait", t_ready, wait_s * 1e3, ctx=ctx,
                          deliveries=self._evals.get(ev.id, 0))
        return ev, token

    def dequeue_batch(self, schedulers: List[str], max_k: int,
                      timeout: Optional[float] = None
                      ) -> List[Tuple[Evaluation, str]]:
        """Dequeue up to max_k ready evals in one call: block for the
        first, then greedily drain whatever else is immediately ready.
        Distinct jobs only -- two evals of one job must not run
        concurrently (the broker's pending-per-job invariant). This is
        the coalescing entry point the batched solver needs; upstream's
        contract is one eval a dequeue (eval_broker.go:354).

        The blocking first pop and the greedy drain happen under ONE
        lock acquisition: with two steps, the other batch worker's
        blocking dequeue could pop the second eval of an atomically
        enqueued burst between them, splitting it into two one-lane
        batches (the cross-lane fixpoint only sees conflicts inside one
        fused generation)."""
        faults.fire("broker.dequeue")   # chaos: stall/error the feed
        out: List[Tuple[Evaluation, str]] = []
        deadline = time.time() + timeout if timeout is not None else None
        with self._lock:
            while True:
                if not self.enabled:
                    return out
                self._check_nack_timeouts_locked()
                popped = self._pop_ready_locked(schedulers)
                if popped is not None:
                    break
                if deadline is not None:
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        return out
                    self._lock.wait(min(remaining, 0.5))
                else:
                    self._lock.wait(0.5)
            ev, token = popped
            out.append((ev, token))
            jobs = {(ev.namespace, ev.job_id)}
            while len(out) < max_k:
                popped = self._pop_ready_locked(schedulers,
                                                exclude_jobs=jobs)
                if popped is None:
                    break
                nxt, tok = popped
                jobs.add((nxt.namespace, nxt.job_id))
                out.append((nxt, tok))
        return out

    def dequeue_lpq(self, schedulers: List[str], max_k: int,
                    timeout: Optional[float] = None,
                    gather_s: float = 0.0
                    ) -> List[Tuple[Evaluation, str]]:
        """Whole-queue coalescer for the LP tier: like
        dequeue_batch, but after draining what's immediately ready it
        keeps GATHERING for up to ``gather_s`` -- an in-flight
        registration burst lands in one joint solve instead of
        fragmenting into per-arrival micro-batches.  Same distinct-jobs
        invariant; still bounded by ``max_k``."""
        out = self.dequeue_batch(schedulers, max_k, timeout=timeout)
        if not out or len(out) >= max_k or gather_s <= 0:
            return out
        deadline = time.time() + gather_s
        jobs = {(ev.namespace, ev.job_id) for ev, _ in out}
        gathered = 0
        with self._lock:
            while len(out) < max_k:
                self._check_nack_timeouts_locked()
                popped = self._pop_ready_locked(schedulers,
                                                exclude_jobs=jobs)
                if popped is not None:
                    ev, tok = popped
                    jobs.add((ev.namespace, ev.job_id))
                    out.append((ev, tok))
                    gathered += 1
                    continue
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                self._lock.wait(min(remaining, 0.05))
        if gathered:
            metrics.incr("nomad.broker.lpq_gathered", gathered)
        return out

    def _check_nack_timeouts_locked(self) -> None:
        now = time.time()
        for eid, (ev, token, dl) in list(self._unack.items()):
            if dl <= now:
                del self._unack[eid]
                self._requeue_or_fail_locked(ev)

    def _requeue_or_fail_locked(self, ev: Evaluation) -> None:
        if self._evals.get(ev.id, 0) >= self.delivery_limit:
            # one poison strike per exhausted delivery cycle: the eval
            # burned delivery_limit leases (worker crashes, wedges past
            # the nack timeout, or scheduler errors) without one ack
            strikes = self._poison_strikes.get(ev.id, 0) + 1
            self._poison_strikes[ev.id] = strikes
            if self.poison_after and strikes >= self.poison_after:
                self._quarantine_locked(ev, strikes)
                return
            self._seq += 1
            self._ready.setdefault(FAILED_QUEUE, [])
            heapq.heappush(self._ready[FAILED_QUEUE],
                           (-ev.priority, self._seq, ev))
            # the job's pipeline must not wedge behind the failed eval
            self._promote_waiting_locked(ev)
        else:
            self._seq += 1
            self._ready.setdefault(ev.type, [])
            heapq.heappush(self._ready[ev.type], (-ev.priority, self._seq, ev))
        self._lock.notify_all()

    def _quarantine_locked(self, ev: Evaluation, strikes: int) -> None:
        """Dead-letter a poison eval: it has exhausted its delivery
        limit ``strikes`` times.  Never retried automatically -- the
        operator releases it (release_quarantined) once the cause is
        fixed; meanwhile the job's waiting evals promote past it so the
        queue never wedges behind the poison."""
        self._quarantine[ev.id] = {"eval": ev, "strikes": strikes,
                                   "at": time.time()}
        self._evals.pop(ev.id, None)
        self._enqueued_at.pop(ev.id, None)
        metrics.incr("nomad.broker.eval_quarantined")
        _log.error("eval=%s job=%s quarantined after %d exhausted "
                   "delivery cycles (%d leases each); release it with "
                   "release_quarantined", ev.id, ev.job_id, strikes,
                   self.delivery_limit)
        self._promote_waiting_locked(ev)
        self._lock.notify_all()

    def quarantine_state(self) -> dict:
        """The dead-letter set, for operators and tests."""
        now = time.time()
        with self._lock:
            evals = [{"id": rec["eval"].id,
                      "job_id": rec["eval"].job_id,
                      "namespace": rec["eval"].namespace,
                      "type": rec["eval"].type,
                      "triggered_by": rec["eval"].triggered_by,
                      "strikes": rec["strikes"],
                      "age_s": round(now - rec["at"], 3)}
                     for _, rec in sorted(self._quarantine.items())]
        return {"poison_after": self.poison_after,
                "delivery_limit": self.delivery_limit,
                "total": len(evals), "evals": evals}

    def release_quarantined(self,
                            eval_id: Optional[str] = None) -> List[str]:
        """Re-admit dead-lettered eval(s) with a clean delivery and strike
        slate (eval_id None releases all). Returns the released ids."""
        released: List[str] = []
        with self._lock:
            ids = [eval_id] if eval_id is not None \
                else sorted(self._quarantine)
            for eid in ids:
                rec = self._quarantine.pop(eid, None)
                if rec is None:
                    continue
                self._poison_strikes.pop(eid, None)
                self._evals.pop(eid, None)
                self._process_enqueue(rec["eval"])
                released.append(eid)
            if released:
                self._lock.notify_all()
        if released:
            metrics.incr("nomad.broker.quarantine_released", len(released))
        return released

    # ------------------------------------------------------------------
    def token_outstanding(self, eval_id: str, token: str) -> bool:
        """True iff (eval_id, token) is still THE outstanding lease.
        The plan applier's stale-worker fence (upstream: the plan
        endpoint's EvalToken validation): a worker whose lease expired
        into a nack-timeout redelivery -- it wedged, or its supervisor
        gave it up for dead -- must not commit plans; the replacement
        delivery owns the eval."""
        with self._lock:
            entry = self._unack.get(eval_id)
            return entry is not None and entry[1] == token

    # ------------------------------------------------------------------
    def ack(self, eval_id: str, token: str) -> Optional[str]:
        """(upstream: eval_broker.go:555). Releases the job's waiting eval."""
        with self._lock:
            entry = self._unack.get(eval_id)
            if entry is None or entry[1] != token:
                return "token mismatch or eval not outstanding"
            ev = entry[0]
            del self._unack[eval_id]
            self._evals.pop(eval_id, None)
            # a successful delivery clears the eval's poison record
            self._poison_strikes.pop(eval_id, None)
            self._promote_waiting_locked(ev)
            self._lock.notify_all()
            return None

    def _promote_waiting_locked(self, ev: Evaluation) -> None:
        """Promote one waiting eval for the same job."""
        for wid, wev in list(self._waiting.items()):
            if (wev.namespace, wev.job_id) == (ev.namespace, ev.job_id):
                del self._waiting[wid]
                self._enqueue_locked(wev)
                break

    def nack(self, eval_id: str, token: str) -> Optional[str]:
        """(upstream: eval_broker.go:632)"""
        with self._lock:
            entry = self._unack.get(eval_id)
            if entry is None or entry[1] != token:
                return "token mismatch or eval not outstanding"
            ev = entry[0]
            del self._unack[eval_id]
            self._requeue_or_fail_locked(ev)
            return None

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "total_ready": self._ready_depth_locked(),
                "total_unacked": len(self._unack),
                "total_waiting": len(self._waiting),
                "total_delayed": len(self._delayed),
                "total_failed": len(self._ready.get(FAILED_QUEUE, [])),
                "total_quarantined": len(self._quarantine),
                "by_scheduler": {s: len(h) for s, h in self._ready.items()},
            }


class BlockedEvals:
    """Holds evals that failed placement until capacity frees (reference
    broker.py:558; upstream: nomad/blocked_evals.go:35). Unblocking is
    keyed by computed node class: an eval ineligible for every class a
    new node belongs to stays blocked."""

    def __init__(self, broker: EvalBroker):
        self.broker = broker
        self._lock = threading.Lock()
        self.enabled = False
        # (namespace, job_id) -> Evaluation  (one blocked eval per job)
        self._captured: Dict[Tuple[str, str], Evaluation] = {}
        self._escaped: Set[str] = set()
        self._stats_blocked = 0

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self.enabled = enabled
            if not enabled:
                self._captured.clear()
                self._escaped.clear()

    def block(self, ev: Evaluation) -> None:
        with self._lock:
            if not self.enabled:
                return
            key = (ev.namespace, ev.job_id)
            # keep only the newest blocked eval per job
            # (upstream: blocked_evals.go duplicate tracking)
            self._captured[key] = ev
            if ev.escaped_computed_class:
                self._escaped.add(ev.id)

    def unblock(self, computed_class: str, index: int = 0) -> List[Evaluation]:
        """Capacity freed on a node of the given class -> requeue matching
        evals (upstream: blocked_evals.go Unblock)."""
        with self._lock:
            if not self.enabled:
                return []
            unblock: List[Evaluation] = []
            for key, ev in list(self._captured.items()):
                elig = ev.class_eligibility or {}
                if (ev.id in self._escaped
                        or not computed_class
                        or computed_class not in elig
                        or elig.get(computed_class, True)):
                    unblock.append(ev)
                    del self._captured[key]
                    self._escaped.discard(ev.id)
            for ev in unblock:
                requeued = ev.copy()
                requeued.status = EVAL_STATUS_PENDING
                requeued.triggered_by = TRIGGER_QUEUED_ALLOCS
                self.broker.enqueue(requeued)
            return unblock

    def unblock_all(self) -> List[Evaluation]:
        return self.unblock("")

    def stats(self) -> dict:
        with self._lock:
            return {"total_blocked": len(self._captured),
                    "total_escaped": len(self._escaped)}
