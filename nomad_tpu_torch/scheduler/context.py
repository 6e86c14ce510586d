"""Per-evaluation context (port of nomad_tpu/scheduler/context.py;
upstream: scheduler/context.go): the plan under construction, metrics,
the compiled-regex cache and the computed-class eligibility cache. The
placement service reads ``state``, ``plan``, ``proposed_allocs``,
``regex`` and ``metrics``.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional

from ..structs import Allocation, AllocMetric, Job, Plan

# Eligibility states (reference: context.go)
ELIGIBILITY_UNKNOWN = 0
ELIGIBILITY_ELIGIBLE = 1
ELIGIBILITY_INELIGIBLE = 2
ELIGIBILITY_ESCAPED = 3  # constraint references unique attrs; no class caching


class EvalEligibility:
    """Tracks job/taskgroup feasibility per computed node class
    (reference: context.go:261)."""

    def __init__(self) -> None:
        self.job: Dict[str, int] = {}
        self.job_escaped = False
        self.tg: Dict[str, Dict[str, int]] = {}
        self.tg_escaped: Dict[str, bool] = {}
        self.quota_reached = ""

    @staticmethod
    def _escaped(constraints) -> bool:
        for c in constraints:
            for t in (c.l_target, c.r_target):
                if "${node.unique." in t or "${attr.unique." in t or "${meta.unique." in t:
                    return True
            if c.operand in ("distinct_hosts", "distinct_property"):
                return True
        return False

    def set_job(self, job: Job) -> None:
        self.job_escaped = self._escaped(job.constraints)
        for tg in job.task_groups:
            constraints = list(tg.constraints)
            for t in tg.tasks:
                constraints.extend(t.constraints)
            self.tg_escaped[tg.name] = self._escaped(constraints)

    def has_escaped(self) -> bool:
        return self.job_escaped or any(self.tg_escaped.values())

    def job_status(self, node_class: str) -> int:
        if self.job_escaped or not node_class:
            return ELIGIBILITY_ESCAPED
        return self.job.get(node_class, ELIGIBILITY_UNKNOWN)

    def set_job_eligibility(self, eligible: bool, node_class: str) -> None:
        if node_class:
            self.job[node_class] = (
                ELIGIBILITY_ELIGIBLE if eligible else ELIGIBILITY_INELIGIBLE)

    def task_group_status(self, tg_name: str, node_class: str) -> int:
        if self.tg_escaped.get(tg_name, False) or not node_class:
            return ELIGIBILITY_ESCAPED
        return self.tg.get(tg_name, {}).get(node_class, ELIGIBILITY_UNKNOWN)

    def set_task_group_eligibility(self, eligible: bool, tg_name: str,
                                   node_class: str) -> None:
        if node_class:
            self.tg.setdefault(tg_name, {})[node_class] = (
                ELIGIBILITY_ELIGIBLE if eligible else ELIGIBILITY_INELIGIBLE)

    def class_eligibility(self) -> Dict[str, bool]:
        """Export for blocked evals (class-keyed unblocking, reference:
        context.go:325 GetClasses + blocked_evals.go:46-50): a class is
        eligible only if no job- or TG-level check marked it ineligible;
        any ineligible mark wins over eligible marks."""
        out: Dict[str, bool] = {}
        for cls, st in self.job.items():
            if st == ELIGIBILITY_ELIGIBLE:
                out.setdefault(cls, True)
            elif st == ELIGIBILITY_INELIGIBLE:
                out[cls] = False
        for tgmap in self.tg.values():
            for cls, st in tgmap.items():
                if st == ELIGIBILITY_ELIGIBLE:
                    out.setdefault(cls, True)
                elif st == ELIGIBILITY_INELIGIBLE:
                    out[cls] = False
        return out


class EvalContext:
    """State handed through the iterator stack (reference: context.go:130)."""

    def __init__(self, state, plan: Plan, logger=None, events=None):
        self.state = state
        self.plan = plan
        self.logger = logger
        self.metrics = AllocMetric()
        self._eligibility: Optional[EvalEligibility] = None
        self._regex_cache: Dict[str, re.Pattern] = {}
        self._version_cache: Dict[str, object] = {}
        self.events: List[object] = events if events is not None else []

    def reset(self) -> None:
        self.metrics = AllocMetric()

    def eligibility(self) -> EvalEligibility:
        if self._eligibility is None:
            self._eligibility = EvalEligibility()
        return self._eligibility

    def regex(self, pattern: str) -> Optional[re.Pattern]:
        pat = self._regex_cache.get(pattern)
        if pat is None:
            try:
                pat = re.compile(pattern)
            except re.error:
                return None
            self._regex_cache[pattern] = pat
        return pat

    def send_event(self, event) -> None:
        self.events.append(event)

    def proposed_allocs(self, node_id: str) -> List[Allocation]:
        """Existing non-client-terminal allocs on the node, minus plan stops
        and preemptions, plus plan placements (reference: context.go:176
        EvalContext.ProposedAllocs). Preserves insertion order so the scan
        is deterministic (the reference materializes from a map; our
        deterministic order is a superset contract the TPU path shares)."""
        existing = self.state.allocs_by_node(node_id)

        removed = set()
        for a in self.plan.node_update.get(node_id, ()):
            removed.add(a.id)
        for a in self.plan.node_preemptions.get(node_id, ()):
            removed.add(a.id)

        by_id: Dict[str, Allocation] = {}
        for alloc in existing:
            if alloc.id in removed:
                continue
            if alloc.client_terminal_status():
                continue
            by_id[alloc.id] = alloc
        for alloc in self.plan.node_allocation.get(node_id, ()):
            by_id[alloc.id] = alloc
        return list(by_id.values())
