"""Placement stacks: the chained iterator pipelines (port of
nomad_tpu/scheduler/stack.py; upstream: scheduler/stack.go):
GenericStack (:46, the chain of NewGenericStack :370), SystemStack
(:201), the log2 candidate limit (:82-95) and the 100-node scan for
spread and affinity jobs (:176-185).
"""
from __future__ import annotations

import math
import time
from typing import List, Optional, Set

from ..structs import (
    Job, Node, SchedulerConfiguration, TaskGroup,
)
from .context import EvalContext
from .feasible import (
    ConstraintChecker, DeviceChecker, DistinctHostsIterator,
    DistinctPropertyIterator, DriverChecker, FeasibilityWrapper,
    CSIVolumeChecker, HostVolumeChecker, NetworkChecker, StaticIterator,
)
from .rank import (
    BinPackIterator, FeasibleRankIterator, JobAntiAffinityIterator,
    NodeAffinityIterator, NodeReschedulingPenaltyIterator,
    PreemptionScoringIterator, RankedNode, ScoreNormalizationIterator,
)
from .select import LimitIterator, MaxScoreIterator
from .spread import SpreadIterator
from .util import shuffle_nodes


class SelectOptions:
    """(upstream: stack.go:37)"""

    def __init__(self, penalty_node_ids: Optional[Set[str]] = None,
                 preferred_nodes: Optional[List[Node]] = None,
                 preempt: bool = False, alloc_name: str = ""):
        self.penalty_node_ids = penalty_node_ids or set()
        self.preferred_nodes = preferred_nodes or []
        self.preempt = preempt
        self.alloc_name = alloc_name


def _tg_constraints(tg: TaskGroup):
    """The drivers and the merged constraints of a task group
    (upstream: stack.go taskGroupConstraints)."""
    drivers = set()
    constraints = list(tg.constraints)
    for task in tg.tasks:
        drivers.add(task.driver)
        constraints.extend(task.constraints)
    return drivers, constraints


class GenericStack:
    """Service and batch placement stack (upstream: stack.go:46). The
    constructor builds the whole chain, so every eval builds it even
    when no placement falls back to the host."""

    def __init__(self, batch: bool, ctx: EvalContext):
        self.batch = batch
        self.ctx = ctx
        self.job_version: Optional[int] = None

        self.source = StaticIterator(ctx, [])
        self._pending_shuffle = None
        self.job_constraint = ConstraintChecker(ctx, [])
        self.tg_drivers = DriverChecker(ctx, set())
        self.tg_constraint = ConstraintChecker(ctx, [])
        self.tg_devices = DeviceChecker(ctx)
        self.tg_host_volumes = HostVolumeChecker(ctx)
        self.tg_csi_volumes = CSIVolumeChecker(ctx)
        self.tg_network = NetworkChecker(ctx)
        self.wrapped_checks = FeasibilityWrapper(
            ctx, self.source,
            job_checkers=[self.job_constraint],
            tg_checkers=[self.tg_drivers, self.tg_constraint,
                         self.tg_devices, self.tg_network],
            avail_checkers=[self.tg_host_volumes, self.tg_csi_volumes])
        self.distinct_hosts = DistinctHostsIterator(ctx, self.wrapped_checks)
        self.distinct_property = DistinctPropertyIterator(
            ctx, self.distinct_hosts)
        rank_source = FeasibleRankIterator(ctx, self.distinct_property)
        self.binpack = BinPackIterator(ctx, rank_source, evict=False, priority=0)
        self.job_anti_aff = JobAntiAffinityIterator(ctx, self.binpack, "")
        self.resched_penalty = NodeReschedulingPenaltyIterator(
            ctx, self.job_anti_aff)
        self.node_affinity = NodeAffinityIterator(ctx, self.resched_penalty)
        self.spread = SpreadIterator(ctx, self.node_affinity)
        preemption_scorer = PreemptionScoringIterator(ctx, self.spread)
        self.score_norm = ScoreNormalizationIterator(ctx, preemption_scorer)
        self.limit = LimitIterator(ctx, self.score_norm)
        self.max_score = MaxScoreIterator(ctx, self.limit)

    def set_nodes(self, base_nodes: List[Node]) -> None:
        """Set the candidate nodes and the log2 scan limit (upstream:
        stack.go:75-95 GenericStack.SetNodes). The shuffle waits for the
        first select(): it is a Python pass over the whole fleet, and
        the device path asks the stack only for what falls back to the
        host; its seed (the plan's eval id and the state index taken
        here) makes the delay invisible."""
        self._pending_shuffle = (list(base_nodes),
                                 self.ctx.state.latest_index())

        limit = 2
        n = len(base_nodes)
        if not self.batch and n > 0:
            log_limit = int(math.ceil(math.log2(n))) if n > 1 else 1
            if log_limit > limit:
                limit = log_limit
        self.limit.set_limit(limit)

    def _materialize_nodes(self) -> None:
        pending = self._pending_shuffle
        if pending is None:
            return
        self._pending_shuffle = None
        nodes, idx = pending
        shuffle_nodes(self.ctx.plan, idx, nodes)
        self.source.set_nodes(nodes)

    def set_job(self, job: Job) -> None:
        if self.job_version is not None and self.job_version == job.version:
            return
        self.job_version = job.version
        self.tg_csi_volumes.set_namespace(job.namespace)
        self.job_constraint.set_constraints(job.constraints)
        self.distinct_hosts.set_job(job)
        self.distinct_property.set_job(job)
        self.binpack.set_job(job)
        self.job_anti_aff.set_job(job)
        self.node_affinity.set_job(job)
        self.spread.set_job(job)
        self.ctx.eligibility().set_job(job)

    def set_scheduler_configuration(self, cfg: SchedulerConfiguration) -> None:
        self.binpack.set_scheduler_configuration(cfg)

    def select(self, tg: TaskGroup,
               options: Optional[SelectOptions] = None) -> Optional[RankedNode]:
        """(upstream: stack.go:128 GenericStack.Select)"""
        options = options or SelectOptions()
        self._materialize_nodes()

        if options.preferred_nodes:
            original = self.source.nodes
            self.source.set_nodes(options.preferred_nodes)
            sub = SelectOptions(options.penalty_node_ids, [], options.preempt,
                                options.alloc_name)
            option = self.select(tg, sub)
            self.source.set_nodes(original)
            if option is not None:
                return option
            return self.select(tg, sub)

        self.max_score.reset()
        self.ctx.reset()
        start = time.perf_counter_ns()

        drivers, constraints = _tg_constraints(tg)
        self.tg_drivers.set_drivers(drivers)
        self.tg_constraint.set_constraints(constraints)
        self.tg_devices.set_task_group(tg)
        self.tg_host_volumes.set_volumes(options.alloc_name, tg.volumes)
        self.tg_csi_volumes.set_volumes(options.alloc_name, tg.volumes)
        if tg.networks:
            self.tg_network.set_network(tg.networks[0])
        else:
            self.tg_network.set_network(None)
        self.distinct_hosts.set_task_group(tg)
        self.distinct_property.set_task_group(tg)
        self.wrapped_checks.set_task_group(tg.name)
        self.binpack.set_task_group(tg)
        self.binpack.evict = options.preempt
        self.job_anti_aff.set_task_group(tg)
        self.resched_penalty.set_penalty_nodes(options.penalty_node_ids)
        self.node_affinity.set_task_group(tg)
        self.spread.set_task_group(tg)

        if self.node_affinity.has_affinities() or self.spread.has_spreads():
            # spread and affinity scoring need a wide scan
            # (upstream: stack.go:176-185)
            limit = tg.count
            if tg.count < 100:
                limit = 100
            self.limit.set_limit(limit)

        option = self.max_score.next()
        self.ctx.metrics.allocation_time_ns = time.perf_counter_ns() - start
        return option


class SystemStack:
    """System and sysbatch stack: every feasible node, no limit
    (upstream: stack.go:201 SystemStack)."""

    def __init__(self, ctx: EvalContext, sysbatch: bool = False):
        self.ctx = ctx
        self.sysbatch = sysbatch

        self.source = StaticIterator(ctx, [])
        self.job_constraint = ConstraintChecker(ctx, [])
        self.tg_drivers = DriverChecker(ctx, set())
        self.tg_constraint = ConstraintChecker(ctx, [])
        self.tg_devices = DeviceChecker(ctx)
        self.tg_host_volumes = HostVolumeChecker(ctx)
        self.tg_csi_volumes = CSIVolumeChecker(ctx)
        self.tg_network = NetworkChecker(ctx)
        self.wrapped_checks = FeasibilityWrapper(
            ctx, self.source,
            job_checkers=[self.job_constraint],
            tg_checkers=[self.tg_drivers, self.tg_constraint,
                         self.tg_devices, self.tg_network],
            avail_checkers=[self.tg_host_volumes, self.tg_csi_volumes])
        self.distinct_property = DistinctPropertyIterator(
            ctx, self.wrapped_checks)
        rank_source = FeasibleRankIterator(ctx, self.distinct_property)
        self.binpack = BinPackIterator(ctx, rank_source, evict=False, priority=0)
        self.score_norm = ScoreNormalizationIterator(ctx, self.binpack)

    def set_nodes(self, base_nodes: List[Node]) -> None:
        self.source.set_nodes(list(base_nodes))

    def set_job(self, job: Job) -> None:
        self.tg_csi_volumes.set_namespace(job.namespace)
        self.job_constraint.set_constraints(job.constraints)
        self.distinct_property.set_job(job)
        self.binpack.set_job(job)
        self.ctx.eligibility().set_job(job)

    def set_scheduler_configuration(self, cfg: SchedulerConfiguration) -> None:
        self.binpack.set_scheduler_configuration(cfg)

    def select(self, tg: TaskGroup,
               options: Optional[SelectOptions] = None) -> Optional[RankedNode]:
        self.ctx.reset()
        start = time.perf_counter_ns()
        options = options or SelectOptions()
        drivers, constraints = _tg_constraints(tg)
        self.tg_drivers.set_drivers(drivers)
        self.tg_constraint.set_constraints(constraints)
        self.tg_devices.set_task_group(tg)
        self.tg_host_volumes.set_volumes(options.alloc_name, tg.volumes)
        self.tg_csi_volumes.set_volumes(options.alloc_name, tg.volumes)
        if tg.networks:
            self.tg_network.set_network(tg.networks[0])
        else:
            self.tg_network.set_network(None)
        self.distinct_property.set_task_group(tg)
        self.wrapped_checks.set_task_group(tg.name)
        self.binpack.set_task_group(tg)
        self.binpack.evict = options.preempt
        option = self.score_norm.next()
        self.ctx.metrics.allocation_time_ns = time.perf_counter_ns() - start
        return option
