"""Spread scoring (port of nomad_tpu/scheduler/spread.py; upstream:
scheduler/spread.go and propertyset.go): PropertySet, SpreadIterator and
even_spread_score_boost."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..structs import Job, Node, Spread, TaskGroup
from .context import EvalContext
from .rank import RankedNode, RankIterator
from .util import resolve_target

IMPLICIT_TARGET = "*"


class PropertySet:
    """Counts this job's allocs per value of one attribute
    (upstream: scheduler/propertyset.go). Includes plan placements,
    excludes plan stops; client-terminal allocs don't count."""

    def __init__(self, ctx: EvalContext, job: Job, target_attribute: str):
        self.ctx = ctx
        self.job = job
        self.target_attribute = target_attribute
        self.tg_name: Optional[str] = None
        self._existing: Optional[Dict[str, int]] = None

    def set_tg_name(self, name: str) -> None:
        self.tg_name = name
        self._existing = None

    def _node_value(self, node: Node) -> Tuple[str, bool]:
        return resolve_target(self.target_attribute, node)

    def _gather(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        allocs = self.ctx.state.allocs_by_job(self.job.namespace, self.job.id)
        stopped = set()
        for na in self.ctx.plan.node_update.values():
            stopped.update(a.id for a in na)
        for na in self.ctx.plan.node_preemptions.values():
            stopped.update(a.id for a in na)
        live = [a for a in allocs
                if a.id not in stopped and not a.terminal_status()]
        for na in self.ctx.plan.node_allocation.values():
            live.extend(na)
        for alloc in live:
            if self.tg_name is not None and alloc.task_group != self.tg_name:
                continue
            node = self.ctx.state.node_by_id(alloc.node_id)
            if node is None:
                continue
            val, ok = self._node_value(node)
            if not ok:
                continue
            counts[str(val)] = counts.get(str(val), 0) + 1
        return counts

    def used_count(self, node: Node) -> Tuple[str, str, int]:
        """(node's value, errMsg, used count for that value)
        (upstream: propertyset.go UsedCount)."""
        val, ok = self._node_value(node)
        if not ok:
            return "", f"missing property {self.target_attribute}", 0
        counts = self.combined_use_map()
        return str(val), "", counts.get(str(val), 0)

    def combined_use_map(self) -> Dict[str, int]:
        # Recomputed per call because the plan mutates between placements
        # within one eval (reference recomputes from plan similarly).
        return self._gather()


class SpreadIterator(RankIterator):
    """(upstream: spread.go:128 SpreadIterator.Next)"""

    def __init__(self, ctx: EvalContext, source: RankIterator):
        self.ctx = ctx
        self.source = source
        self.job: Optional[Job] = None
        self.tg: Optional[TaskGroup] = None
        self.job_spreads: List[Spread] = []
        self.spreads: List[Spread] = []
        self.property_sets: Dict[str, PropertySet] = {}
        self.sum_spread_weights = 0
        self.lowest_spread_boost = -1.0

    def set_job(self, job: Job) -> None:
        self.job = job
        self.job_spreads = list(job.spreads)

    def set_task_group(self, tg: TaskGroup) -> None:
        self.tg = tg
        self.spreads = list(self.job_spreads) + list(tg.spreads)
        self.sum_spread_weights = sum(s.weight for s in self.spreads)
        self.property_sets = {}
        self.lowest_spread_boost = -1.0
        for s in self.spreads:
            ps = PropertySet(self.ctx, self.job, s.attribute)
            ps.set_tg_name(tg.name)
            self.property_sets[s.attribute] = ps

    def has_spreads(self) -> bool:
        return bool(self.spreads)

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None or not self.has_spreads():
            return option

        total = 0.0
        for spread in self.spreads:
            pset = self.property_sets[spread.attribute]
            nvalue, err, used = pset.used_count(option.node)
            used += 1  # include this placement
            if err:
                total -= 1.0
                continue
            desired = {t.value: t.percent for t in spread.spread_target}
            if not desired:
                total += even_spread_score_boost(pset, option.node)
                continue
            tg_count = self.tg.count or 1
            pct = desired.get(nvalue, desired.get(IMPLICIT_TARGET))
            if pct is None:
                total -= 1.0
                continue
            desired_count = (pct / 100.0) * tg_count
            spread_weight = float(spread.weight) / float(self.sum_spread_weights)
            if desired_count == 0:
                total += self.lowest_spread_boost
                continue
            boost = ((desired_count - float(used)) / desired_count) * spread_weight
            total += boost
            if boost < self.lowest_spread_boost:
                self.lowest_spread_boost = boost

        if total != 0.0:
            option.scores.append(total)
            self.ctx.metrics.score_node(option.node.id, "allocation-spread", total)
        return option

    def reset(self) -> None:
        self.source.reset()


def even_spread_score_boost(pset: PropertySet, node: Node) -> float:
    """Even spreading when no targets given (upstream: spread.go:216)."""
    combined = pset.combined_use_map()
    if not combined:
        return 0.0
    nvalue, ok = resolve_target(pset.target_attribute, node)
    if not ok:
        return -1.0
    current = combined.get(str(nvalue), 0)
    counts = list(combined.values())
    min_count = min(counts)
    max_count = max(counts)
    if current != min_count:
        if min_count == 0:
            return -1.0
        return float(min_count - current) / float(min_count)
    elif min_count == max_count:
        return -1.0
    elif min_count == 0:
        return 1.0
    delta = max_count - min_count
    return float(delta) / float(min_count)
