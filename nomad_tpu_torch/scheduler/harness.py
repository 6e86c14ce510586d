"""Scheduler harness (port of nomad_tpu/scheduler/harness.py; upstream:
scheduler/testing.go): a state store with a planner that applies each
submitted plan to the store at once (``upsert_plan_results``), as the
plan applier would after verifying it. An Evaluation goes in through
``process`` and a committed plan lands in the store."""
from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from ..server.tracing import tracer
from ..state.store import StateStore
from ..structs import Evaluation, Plan, PlanResult
from .factory import new_scheduler


class Harness:
    """(upstream: testing.go:50 Harness)"""

    def __init__(self, state: Optional[StateStore] = None):
        self.state = state if state is not None else StateStore()
        self.plans: List[Plan] = []
        self.evals: List[Evaluation] = []
        self.create_evals: List[Evaluation] = []
        self.reblock_evals: List[Evaluation] = []
        self.reject_plan = False
        self.reject_tracker = 0
        self._lock = threading.Lock()

    # -- Planner interface ---------------------------------------------------
    def submit_plan(self, plan: Plan) -> Tuple[Optional[PlanResult], object]:
        """Commit the whole plan (or, with ``reject_plan``, nothing and
        a refreshed snapshot)."""
        with self._lock:
            self.plans.append(plan)
            if self.reject_plan:
                self.reject_tracker += 1
                result = PlanResult(refresh_index=self.state.latest_index())
                return result, self.state.snapshot()

            result = PlanResult(
                node_update={k: list(v) for k, v in plan.node_update.items()},
                node_allocation={k: list(v)
                                 for k, v in plan.node_allocation.items()},
                node_preemptions={k: list(v)
                                  for k, v in plan.node_preemptions.items()},
                deployment=plan.deployment,
                deployment_updates=list(plan.deployment_updates),
            )
            self.state.upsert_plan_results(result)
            return result, None

    def update_eval(self, ev: Evaluation) -> None:
        with self._lock:
            self.evals.append(ev)

    def create_eval(self, ev: Evaluation) -> None:
        with self._lock:
            self.create_evals.append(ev)
            self.state.upsert_evals([ev])

    def reblock_eval(self, ev: Evaluation) -> None:
        with self._lock:
            self.reblock_evals.append(ev)

    def scheduler_config(self):
        return self.state.scheduler_config()

    # -- driving -------------------------------------------------------------
    def process(self, factory_name_or_fn, ev: Evaluation, **kwargs):
        """Build the scheduler over a snapshot of the store and run the
        eval (upstream: testing.go Process). ``factory_name_or_fn`` is a
        registered scheduler name (``kwargs``, such as solve_hook and
        device, go to its constructor) or a function (snapshot, planner)
        -> scheduler."""
        snap = self.state.snapshot()
        if callable(factory_name_or_fn):
            sched = factory_name_or_fn(snap, self)
        else:
            sched = new_scheduler(factory_name_or_fn, snap, self, **kwargs)
        # the eval's trace, as the server's workers open one
        ctx = tracer.begin(ev.id, job=ev.job_id, lane=ev.type,
                           trigger=ev.triggered_by, source="harness")
        err = None
        try:
            with tracer.activate(ctx), \
                    tracer.span("harness.process", ctx=ctx):
                return sched.process(ev)
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
            raise
        finally:
            tracer.end(ev.id, status="failed" if err else "complete",
                       error=err)
