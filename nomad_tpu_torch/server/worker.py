"""Scheduler workers: dequeue evals, invoke the scheduler, submit plans
(port of nomad_tpu/server/worker.py; upstream: nomad/worker.go
Worker.run :397, dequeueEvaluation :476, invokeScheduler :610, and the
Planner half: SubmitPlan :650, UpdateEval :721, CreateEval :760,
ReblockEval :802).

``BatchWorker`` coalesces up to ``width`` evals and runs their
schedulers on one thread each, meeting at one ``SolveBarrier`` (or, under
``tpu-lpq``, one ``LpqBarrier``) so their solves fuse into one dispatch on
the server's device. A failed dispatch raises out of the eval, which is
nacked for redelivery: it never becomes a host placement on the card.
Errors are logged through ``logging``.
"""
from __future__ import annotations

import logging
import threading
from typing import List, Optional, Tuple

from ..faultinject import InjectedFault, faults
from ..scheduler.factory import new_scheduler
from ..structs import Evaluation, Plan, PlanResult, EVAL_STATUS_BLOCKED

_log = logging.getLogger(__name__)

SCHEDULERS = ["service", "batch", "system", "sysbatch"]


class WorkerCrash(BaseException):
    """Injected worker death (the ``worker.crash`` fault point).
    BaseException on purpose: it must escape the per-iteration
    ``except Exception`` guards of the worker loops and kill the thread
    as a real crash would -- no nack, no cleanup, the leased evals left
    to the broker's nack-timeout redelivery."""


class StaleEvalToken(Exception):
    """A worker submitted a plan on an expired or superseded broker
    lease: its eval was redelivered after a nack timeout. The plan must
    not commit -- the outstanding delivery owns the eval now (upstream:
    plan_apply.go's EvalToken check)."""


def _fire_crash_point() -> None:
    """``worker.crash``: an armed error kills the worker thread mid-eval
    (``worker.invoke``'s error takes the orderly nack path instead); an
    armed hang or delay wedges the loop."""
    try:
        faults.fire("worker.crash")
    except InjectedFault as e:
        raise WorkerCrash(str(e)) from e


class WorkerPlanner:
    """The planner a scheduler is handed (reference worker.py:55): plans
    go through the server's plan applier, eval writes to its store."""

    def __init__(self, server, eval_token: str, eval_id: str = "",
                 worker_name: Optional[str] = None):
        self.server = server
        self.eval_token = eval_token
        self.eval_id = eval_id
        self.worker_name = worker_name

    def submit_plan(self, plan: Plan) -> Tuple[Optional[PlanResult], object]:
        # stale-lease fence: a worker whose lease lapsed (nack-timeout
        # redelivery after a wedge or crash) must not commit --
        # exactly-once placement belongs to the outstanding delivery
        if self.eval_id and not self.server.broker.token_outstanding(
                self.eval_id, self.eval_token):
            raise StaleEvalToken(
                f"eval {self.eval_id} lease {self.eval_token} is no "
                f"longer outstanding; plan rejected")
        result = self.server.planner.apply(plan, worker=self.worker_name)
        new_state = None
        if result.rejected_nodes or (result.is_no_op()
                                     and not plan.is_no_op()):
            # a partial or failed commit: the scheduler refreshes its
            # snapshot
            new_state = self.server.state.snapshot()
        self.server.on_plan_result(plan, result)
        return result, new_state

    def update_eval(self, ev: Evaluation) -> None:
        self.server.state.upsert_evals([ev])
        self.server.on_eval_update(ev)

    def create_eval(self, ev: Evaluation) -> None:
        self.server.state.upsert_evals([ev])
        if ev.status == EVAL_STATUS_BLOCKED:
            self.server.blocked_evals.block(ev)
        elif ev.should_enqueue():
            self.server.broker.enqueue(ev)

    def reblock_eval(self, ev: Evaluation) -> None:
        self.server.blocked_evals.block(ev)


def invoke_scheduler(server, ev: Evaluation, token: str, solve_hook=None,
                     sched_factory=None, worker_name=None) -> None:
    """(reference worker.py:174; upstream: worker.go:610 invokeScheduler)
    Wait until the store has caught up with the eval's creation, then run
    the scheduler over a snapshot on the server's device.
    ``sched_factory`` overrides the factory entry of service and batch
    evals (the LP tier passes "tpu-lpq"); ``worker_name`` names the
    owning pool worker for the applier's cross-worker accounting."""
    faults.fire("worker.invoke")    # chaos: raise -> nack -> requeue
    server.state.block_until(ev.modify_index - 1, timeout=2.0)
    snapshot = server.state.snapshot()
    planner = WorkerPlanner(server, token, eval_id=ev.id,
                            worker_name=worker_name)
    sched_type = ev.type if ev.type in SCHEDULERS else "service"
    kwargs = {"device": server.device}
    name = sched_type
    if sched_type in ("service", "batch"):
        if solve_hook is not None:
            kwargs["solve_hook"] = solve_hook
        if sched_factory is not None:
            name = sched_factory
            kwargs["batch"] = sched_type == "batch"
    new_scheduler(name, snapshot, planner, **kwargs).process(ev)


class Worker(threading.Thread):
    """One eval at a time (reference worker.py:108; upstream:
    worker.go:397 Worker.run)."""

    def __init__(self, server, worker_id: int,
                 schedulers: Optional[List[str]] = None):
        super().__init__(daemon=True, name=f"scheduler-worker-{worker_id}")
        self.server = server
        self.worker_id = worker_id
        self.schedulers = schedulers or list(SCHEDULERS)
        self._stop_ev = threading.Event()
        self.evals_processed = 0

    def stop(self) -> None:
        self._stop_ev.set()

    def run(self) -> None:
        # one bad iteration (a dequeue that raises: the broker.dequeue
        # fault point) must not silently kill the worker thread
        while not self._stop_ev.is_set():
            try:
                ev, token = self.server.broker.dequeue(
                    self.schedulers, timeout=0.5)
            except Exception:  # noqa: BLE001 -- the loop must survive
                _log.exception("eval dequeue failed")
                self._stop_ev.wait(0.5)
                continue
            if ev is None:
                continue
            # an armed worker.crash kills this thread HERE -- after the
            # lease was minted, before any ack or nack
            _fire_crash_point()
            try:
                invoke_scheduler(self.server, ev, token,
                                 worker_name=self.name)
                self.server.broker.ack(ev.id, token)
            except Exception:  # noqa: BLE001 -- nacked for redelivery
                self.server.broker.nack(ev.id, token)
                _log.exception("eval=%s job=%s scheduler invoke failed; "
                               "nacked for redelivery", ev.id, ev.job_id)
            self.evals_processed += 1


class BatchWorker(threading.Thread):
    """Eval-coalescing worker (reference worker.py:218): dequeues up to
    ``width`` evals of distinct jobs and runs their schedulers at once,
    meeting at one barrier so their solves fuse into one device
    dispatch. Each eval keeps its own scheduler and snapshot; the plan
    applier settles what the barrier's cross-lane fixpoint did not."""

    def __init__(self, server, worker_id: int, width: int = 8,
                 schedulers: Optional[List[str]] = None):
        super().__init__(daemon=True, name=f"batch-worker-{worker_id}")
        self.server = server
        self.worker_id = worker_id
        self.width = max(1, width)
        self.schedulers = schedulers or list(SCHEDULERS)
        self._stop_ev = threading.Event()
        self.evals_processed = 0
        self.batches_processed = 0

    def stop(self) -> None:
        self._stop_ev.set()

    def run(self) -> None:
        # this thread may be the server's only scheduling path: one bad
        # iteration must not halt all scheduling
        while not self._stop_ev.is_set():
            try:
                self._run_batch()
            except Exception:  # noqa: BLE001 -- the loop must survive
                _log.exception("batch worker iteration failed")
                self._stop_ev.wait(0.5)

    def _run_batch(self) -> None:
        """(reference :265) One generation: up to ``width`` evals at one
        SolveBarrier, or, while the LP tier is active (checked per batch,
        so an algorithm change takes effect at once), _run_lpq_batch."""
        from ..solver.batch import SolveBarrier, make_solve_hook
        from ..solver.lpq import lpq_active

        if lpq_active(self.server.state):
            self._run_lpq_batch()
            return
        batch = self.server.broker.dequeue_batch(
            self.schedulers, self.width, timeout=0.5)
        if not batch:
            return
        # an armed worker.crash kills the whole worker here: every eval
        # of the leased batch is orphaned at once (no eval thread was
        # started, so no barrier waits on a dead participant)
        _fire_crash_point()
        barrier = SolveBarrier(len(batch), e_pad_hint=self.width,
                               plan_group_hint=self.server.planner
                               .expect_plans,
                               device=self.server.device)
        self._run_threads(batch, barrier, make_solve_hook(barrier), None,
                          "batch-eval")

    def _run_lpq_batch(self) -> None:
        """(reference :309) One LP generation: drain up to
        NOMAD_TPU_TORCH_LPQ_BATCH evals (gathering arrivals briefly), run
        each through the tpu-lpq factory entry, and meet at one
        LpqBarrier: one whole-queue LP relaxation."""
        from ..solver.lpq import (
            LpqBarrier, lpq_batch_width, lpq_gather_s, make_lpq_hook,
        )

        batch = self.server.broker.dequeue_lpq(
            self.schedulers, lpq_batch_width(), timeout=0.5,
            gather_s=lpq_gather_s())
        if not batch:
            return
        _fire_crash_point()
        barrier = LpqBarrier(len(batch),
                             plan_group_hint=self.server.planner.expect_plans,
                             device=self.server.device)
        self._run_threads(batch, barrier, make_lpq_hook(barrier), "tpu-lpq",
                          "lpq-eval")

    def _run_threads(self, batch, barrier, hook, sched_factory,
                     prefix: str) -> None:
        threads = [
            threading.Thread(
                target=self._run_one,
                args=(ev, token, barrier, hook, sched_factory),
                daemon=True, name=f"{prefix}-{ev.id[:8]}")
            for ev, token in batch]
        for t in threads:
            t.start()
        for t in threads:
            # bounded joins: an eval thread wedged past the dispatch
            # watchdog stays a live, visible thread
            while t.is_alive():
                t.join(timeout=5.0)
        self.evals_processed += len(batch)
        self.batches_processed += 1

    def _run_one(self, ev: Evaluation, token: str, barrier, hook,
                 sched_factory=None) -> None:
        """(reference :348) Run one eval of the batch, ack or nack it, and
        always leave the barrier."""
        try:
            invoke_scheduler(self.server, ev, token, solve_hook=hook,
                             sched_factory=sched_factory,
                             worker_name=self.name)
            self.server.broker.ack(ev.id, token)
        except Exception:  # noqa: BLE001 -- nacked for redelivery
            self.server.broker.nack(ev.id, token)
            _log.exception("eval=%s job=%s batch-eval invoke failed; "
                           "nacked for redelivery", ev.id, ev.job_id)
        finally:
            barrier.done()
