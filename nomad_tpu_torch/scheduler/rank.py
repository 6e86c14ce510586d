"""Rank iterators: the bin-packing loop and the scoring chain (port of
nomad_tpu/scheduler/rank.py; upstream: scheduler/rank.go, device.go):
RankedNode (:33), FeasibleRankIterator (:96), BinPackIterator (:156:
proposed allocs, network index, ports, devices, reserved cores,
AllocsFit, preemption, score), JobAntiAffinityIterator (:622),
NodeReschedulingPenaltyIterator (:684), NodeAffinityIterator (:756),
ScoreNormalizationIterator (:815), PreemptionScoringIterator (:851),
with the DeviceAllocator and select_reserved_cores that the placement
service also replays at materialize for exact instance and core ids.
This is the host path: the kernels compute the same math over the node
axis, and the host stack places what they do not model.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from ..structs import (
    AllocatedDeviceResource, AllocatedResources, AllocatedSharedResources,
    AllocatedTaskResources, Allocation, Job, NetworkIndex, NetworkResource,
    Node, SchedulerConfiguration, TaskGroup, allocs_fit, score_fit_binpack,
    score_fit_spread, BINPACK_MAX_FIT_SCORE, SCHED_ALG_SPREAD,
    SCHED_ALG_TPU_SPREAD,
)
from .context import EvalContext
from .feasible import DeviceChecker, check_constraint
from .preemption import Preemptor
from .util import resolve_target


class RankedNode:
    """A candidate node moving through the scoring chain
    (upstream: rank.go:33)."""

    __slots__ = ("node", "final_score", "scores", "task_resources",
                 "alloc_resources", "preempted_allocs")

    def __init__(self, node: Node):
        self.node = node
        self.final_score = 0.0
        self.scores: List[float] = []
        self.task_resources: Dict[str, AllocatedTaskResources] = {}
        self.alloc_resources: Optional[AllocatedSharedResources] = None
        self.preempted_allocs: Optional[List[Allocation]] = None


class RankIterator:
    def next(self) -> Optional[RankedNode]:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class FeasibleRankIterator(RankIterator):
    """Turns a feasibility iterator into the head of the ranking chain
    (upstream: rank.go:96)."""

    def __init__(self, ctx: EvalContext, source):
        self.ctx = ctx
        self.source = source

    def next(self) -> Optional[RankedNode]:
        node = self.source.next()
        if node is None:
            return None
        return RankedNode(node)

    def reset(self) -> None:
        self.source.reset()


class DeviceAllocator:
    """Fits device asks against node device groups, tracking instance usage
    (reference: scheduler/device.go)."""

    def __init__(self, ctx: EvalContext, node: Node):
        self.ctx = ctx
        self.node = node
        # id_string -> set of used instance ids
        self.used: Dict[str, set] = {}

    def add_allocs(self, allocs: List[Allocation]) -> None:
        for alloc in allocs:
            if alloc.client_terminal_status():
                continue
            for tr in alloc.allocated_resources.tasks.values():
                for dev in tr.devices:
                    self.used.setdefault(dev.id_string(), set()).update(
                        dev.device_ids)

    def add_reserved(self, offer: AllocatedDeviceResource) -> None:
        self.used.setdefault(offer.id_string(), set()).update(offer.device_ids)

    def assign_device(self, req):
        """Returns (offer, sum_matched_affinity_weights, err). Picks the
        feasible group with the highest affinity score
        (reference: device.go AssignDevice)."""
        best = None
        best_score = 0.0
        for group in self.node.node_resources.devices:
            if not group.matches_request(req.name):
                continue
            free = [i for i in group.instance_ids
                    if i not in self.used.get(group.id_string(), set())]
            if len(free) < req.count:
                continue
            if req.constraints:
                if not DeviceChecker(self.ctx)._check_device_constraints(
                        group, req.constraints):
                    continue
            score = 0.0
            if req.affinities:
                for aff in req.affinities:
                    lval, l_ok = DeviceChecker._resolve_device_target(
                        aff.l_target, group)
                    rval, r_ok = DeviceChecker._resolve_device_target(
                        aff.r_target, group)
                    if check_constraint(self.ctx, aff.operand, lval, rval,
                                        l_ok, r_ok):
                        score += float(aff.weight)
            if best is None or score > best_score:
                best = (group, free)
                best_score = score
        if best is None:
            return None, 0.0, "no devices match request"
        group, free = best
        offer = AllocatedDeviceResource(
            vendor=group.vendor, type=group.type, name=group.name,
            device_ids=free[:req.count])
        return offer, best_score, ""


def select_reserved_cores(node: Node, consumed, count: int):
    """Deterministic lowest-id selection of free reservable cores
    (reference: rank.go:481-524, simplified from NUMA-preferring to
    lowest-id). Excludes agent-reserved cores (the same availability rule
    allocs_fit enforces, structs/funcs.py) and anything in ``consumed``.
    Returns the core ids, or None when fewer than ``count`` are free.
    BOTH the host BinPackIterator and the dense path's materialize replay
    use this helper -- core-id parity depends on there being one copy."""
    usable = (set(node.node_resources.cpu.reservable_cores)
              - set(node.reserved_resources.cores) - set(consumed))
    if len(usable) < count:
        return None
    return sorted(usable)[:count]


class BinPackIterator(RankIterator):
    """The host's inner loop over one candidate node (upstream:
    rank.go:156-598)."""

    def __init__(self, ctx: EvalContext, source: RankIterator,
                 evict: bool = False, priority: int = 0):
        self.ctx = ctx
        self.source = source
        self.evict = evict
        self.priority = priority
        self.job_ns_id = ("", "")
        self.task_group: Optional[TaskGroup] = None
        self.memory_oversubscription = False
        self.score_fit = score_fit_binpack

    def set_job(self, job: Job) -> None:
        self.priority = job.priority
        self.job_ns_id = (job.namespace, job.id)

    def set_task_group(self, tg: TaskGroup) -> None:
        self.task_group = tg

    def set_scheduler_configuration(self, cfg: SchedulerConfiguration) -> None:
        alg = cfg.scheduler_algorithm
        self.score_fit = (score_fit_spread
                          if alg in (SCHED_ALG_SPREAD, SCHED_ALG_TPU_SPREAD)
                          else score_fit_binpack)
        self.memory_oversubscription = cfg.memory_oversubscription_enabled

    def _preemptor(self, node: Node, candidates) -> Preemptor:
        p = Preemptor(self.priority, self.ctx, self.job_ns_id)
        p.set_node(node)
        p.set_preemptions(self._current_preemptions())
        p.set_candidates(candidates)
        return p

    def next(self) -> Optional[RankedNode]:
        while True:
            option = self.source.next()
            if option is None:
                return None
            node = option.node
            proposed = self.ctx.proposed_allocs(node.id)

            # existing network use; a collision here means corrupt
            # state (upstream: rank.go:226 PortCollisionEvent)
            net_idx = NetworkIndex()
            err = net_idx.set_node(node)
            if err:
                self.ctx.send_event({"type": "port_collision", "reason": err,
                                     "node": node.id})
                self.ctx.metrics.exhausted_node(
                    node.id, node.computed_class, "network: invalid node")
                continue
            collide, reason = net_idx.add_allocs(proposed)
            if collide:
                self.ctx.send_event({"type": "port_collision",
                                     "reason": reason, "node": node.id})
                self.ctx.metrics.exhausted_node(
                    node.id, node.computed_class, "network: port collision")
                continue

            dev_allocator = DeviceAllocator(self.ctx, node)
            dev_allocator.add_allocs(proposed)
            total_device_affinity_weight = 0.0
            sum_matching_affinities = 0.0

            total = AllocatedResources(
                tasks={},
                shared=AllocatedSharedResources(
                    disk_mb=self.task_group.ephemeral_disk.size_mb))

            allocs_to_preempt: List[Allocation] = []

            # the task group's network ask (upstream: rank.go:283-365)
            if self.task_group.networks:
                ask = self.task_group.networks[0].copy()
                bad_template = False
                for p in ask.dynamic_ports + ask.reserved_ports:
                    if p.host_network and p.host_network.startswith("${"):
                        val, ok = resolve_target(p.host_network, node)
                        if not ok:
                            bad_template = True
                            break
                        p.host_network = val
                if bad_template:
                    continue
                offer, aerr = net_idx.assign_ports([ask])
                if offer is None:
                    if not self.evict:
                        self.ctx.metrics.exhausted_node(
                            node.id, node.computed_class, f"network: {aerr}")
                        continue
                    net_preempts = self._preemptor(
                        node, proposed).preempt_for_network(ask, net_idx)
                    if not net_preempts:
                        self.ctx.metrics.exhausted_node(
                            node.id, node.computed_class, f"network: {aerr}")
                        continue
                    allocs_to_preempt.extend(net_preempts)
                    removed = {a.id for a in net_preempts}
                    proposed = [a for a in proposed if a.id not in removed]
                    net_idx = NetworkIndex()
                    net_idx.set_node(node)
                    net_idx.add_allocs(proposed)
                    offer, aerr = net_idx.assign_ports([ask])
                    if offer is None:
                        self.ctx.metrics.exhausted_node(
                            node.id, node.computed_class, f"network: {aerr}")
                        continue
                # commit the offer into the index, each port on its host
                # network (upstream: rank.go:352 AddReservedPorts)
                for pm in offer.ports:
                    net_idx.add_reserved_port(
                        pm.value, net_idx._network_for_ip(pm.host_ip))
                nw_res = NetworkResource(
                    mode=ask.mode, device="",
                    reserved_ports=[], dynamic_ports=[])
                total.shared.networks = [nw_res]
                total.shared.ports = offer.ports
                option.alloc_resources = AllocatedSharedResources(
                    networks=[nw_res],
                    disk_mb=self.task_group.ephemeral_disk.size_mb,
                    ports=offer.ports)

            exhausted = False
            for task in self.task_group.tasks:
                task_res = AllocatedTaskResources(
                    cpu_shares=task.resources.cpu,
                    memory_mb=task.resources.memory_mb)
                if self.memory_oversubscription:
                    task_res.memory_max_mb = task.resources.memory_max_mb

                for req in task.resources.devices:
                    offer, sum_aff, derr = dev_allocator.assign_device(req)
                    if offer is None:
                        if not self.evict:
                            self.ctx.metrics.exhausted_node(
                                node.id, node.computed_class,
                                f"devices: {derr}")
                            exhausted = True
                            break
                        dev_preempts = self._preemptor(
                            node, proposed).preempt_for_device(
                                req, dev_allocator)
                        if not dev_preempts:
                            exhausted = True
                            break
                        allocs_to_preempt.extend(dev_preempts)
                        removed = {a.id for a in allocs_to_preempt}
                        proposed = [a for a in proposed if a.id not in removed]
                        dev_allocator = DeviceAllocator(self.ctx, node)
                        dev_allocator.add_allocs(proposed)
                        offer, sum_aff, derr = dev_allocator.assign_device(req)
                        if offer is None:
                            exhausted = True
                            break
                    dev_allocator.add_reserved(offer)
                    task_res.devices.append(offer)
                    if req.affinities:
                        for a in req.affinities:
                            total_device_affinity_weight += abs(float(a.weight))
                        sum_matching_affinities += sum_aff
                if exhausted:
                    break

                # reserved cores (upstream: rank.go:481-524, lowest free
                # ids)
                if task.resources.cores > 0:
                    consumed = set()
                    for alloc in proposed:
                        consumed.update(
                            alloc.allocated_resources.comparable().reserved_cores)
                    for tr in total.tasks.values():
                        consumed.update(tr.reserved_cores)
                    cores = select_reserved_cores(
                        node, consumed, task.resources.cores)
                    if cores is None:
                        self.ctx.metrics.exhausted_node(
                            node.id, node.computed_class, "cores")
                        exhausted = True
                        break
                    task_res.reserved_cores = cores
                    total_cores = node.node_resources.cpu.total_core_count
                    if total_cores:
                        mhz_per_core = (node.node_resources.cpu.cpu_shares
                                        // total_cores)
                        task_res.cpu_shares = mhz_per_core * len(cores)

                option.task_resources[task.name] = task_res
                total.tasks[task.name] = task_res
            if exhausted:
                continue

            current = proposed
            ghost = Allocation(allocated_resources=total)
            proposed = proposed + [ghost]

            fit, dim, util = allocs_fit(node, proposed, net_idx,
                                        check_devices=False)
            if not fit:
                if not self.evict:
                    self.ctx.metrics.exhausted_node(
                        node.id, node.computed_class, dim)
                    continue
                preempted = self._preemptor(
                    node, current).preempt_for_task_group(total)
                allocs_to_preempt.extend(preempted)
                if not preempted:
                    self.ctx.metrics.exhausted_node(
                        node.id, node.computed_class, dim)
                    continue
                # the use after the evictions: what stays, plus the ask
                removed = {a.id for a in allocs_to_preempt}
                remaining = [a for a in current if a.id not in removed] + [ghost]
                fit2, _, util = allocs_fit(node, remaining, None,
                                           check_devices=False)
                if not fit2:
                    self.ctx.metrics.exhausted_node(
                        node.id, node.computed_class, dim)
                    continue
            if allocs_to_preempt:
                option.preempted_allocs = allocs_to_preempt

            fitness = self.score_fit(node, util)
            normalized = fitness / BINPACK_MAX_FIT_SCORE
            option.scores.append(normalized)
            self.ctx.metrics.score_node(node.id, "binpack", normalized)

            if total_device_affinity_weight != 0.0:
                sum_matching_affinities /= total_device_affinity_weight
                option.scores.append(sum_matching_affinities)
                self.ctx.metrics.score_node(
                    node.id, "devices", sum_matching_affinities)
            return option

    def _current_preemptions(self) -> List[Allocation]:
        out: List[Allocation] = []
        for allocs in self.ctx.plan.node_preemptions.values():
            out.extend(allocs)
        return out

    def reset(self) -> None:
        self.source.reset()


class JobAntiAffinityIterator(RankIterator):
    """-(collisions + 1) / desired count for a node already holding this
    job's task group (upstream: rank.go:622)."""

    def __init__(self, ctx: EvalContext, source: RankIterator, job_id: str):
        self.ctx = ctx
        self.source = source
        self.job_id = job_id
        self.task_group = ""
        self.desired_count = 0

    def set_job(self, job: Job) -> None:
        self.job_id = job.id

    def set_task_group(self, tg: TaskGroup) -> None:
        self.task_group = tg.name
        self.desired_count = tg.count

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None:
            return None
        proposed = self.ctx.proposed_allocs(option.node.id)
        collisions = sum(1 for a in proposed
                         if a.job_id == self.job_id
                         and a.task_group == self.task_group)
        if collisions > 0 and self.desired_count > 0:
            penalty = -1.0 * float(collisions + 1) / float(self.desired_count)
            option.scores.append(penalty)
            self.ctx.metrics.score_node(
                option.node.id, "job-anti-affinity", penalty)
        else:
            self.ctx.metrics.score_node(option.node.id, "job-anti-affinity", 0)
        return option

    def reset(self) -> None:
        self.source.reset()


class NodeReschedulingPenaltyIterator(RankIterator):
    """-1 on the nodes where the previous attempt failed
    (upstream: rank.go:684)."""

    def __init__(self, ctx: EvalContext, source: RankIterator):
        self.ctx = ctx
        self.source = source
        self.penalty_nodes: set = set()

    def set_penalty_nodes(self, penalty_nodes) -> None:
        self.penalty_nodes = set(penalty_nodes or ())

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None:
            return None
        if option.node.id in self.penalty_nodes:
            option.scores.append(-1.0)
            self.ctx.metrics.score_node(
                option.node.id, "node-reschedule-penalty", -1)
        else:
            self.ctx.metrics.score_node(
                option.node.id, "node-reschedule-penalty", 0)
        return option

    def reset(self) -> None:
        self.penalty_nodes = set()
        self.source.reset()


class NodeAffinityIterator(RankIterator):
    """The matched affinities' weights over the sum of |weights|
    (upstream: rank.go:756)."""

    def __init__(self, ctx: EvalContext, source: RankIterator):
        self.ctx = ctx
        self.source = source
        self.job_affinities: list = []
        self.affinities: list = []

    def set_job(self, job: Job) -> None:
        self.job_affinities = list(job.affinities)

    def set_task_group(self, tg: TaskGroup) -> None:
        self.affinities = list(self.job_affinities)
        self.affinities.extend(tg.affinities)
        for task in tg.tasks:
            self.affinities.extend(task.affinities)

    def has_affinities(self) -> bool:
        return bool(self.affinities)

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None:
            return None
        if not self.has_affinities():
            self.ctx.metrics.score_node(option.node.id, "node-affinity", 0)
            return option
        sum_weight = sum(abs(float(a.weight)) for a in self.affinities)
        total = 0.0
        for aff in self.affinities:
            lval, l_ok = resolve_target(aff.l_target, option.node)
            rval, r_ok = resolve_target(aff.r_target, option.node)
            if check_constraint(self.ctx, aff.operand, lval, rval, l_ok, r_ok):
                total += float(aff.weight)
        if total != 0.0:
            norm = total / sum_weight
            option.scores.append(norm)
            self.ctx.metrics.score_node(option.node.id, "node-affinity", norm)
        return option

    def reset(self) -> None:
        self.source.reset()
        self.affinities = []


class ScoreNormalizationIterator(RankIterator):
    """The final score: the mean of the node's scores
    (upstream: rank.go:815)."""

    def __init__(self, ctx: EvalContext, source: RankIterator):
        self.ctx = ctx
        self.source = source

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None or not option.scores:
            return option
        option.final_score = sum(option.scores) / len(option.scores)
        self.ctx.metrics.score_node(
            option.node.id, "normalized-score", option.final_score)
        return option

    def reset(self) -> None:
        self.source.reset()


def net_priority(allocs: List[Allocation]) -> float:
    """The highest priority plus the sum over it (upstream: rank.go
    netPriority)."""
    sum_priority = 0
    mx = 0.0
    for alloc in allocs:
        p = alloc.job.priority if alloc.job is not None else 50
        if float(p) > mx:
            mx = float(p)
        sum_priority += p
    if mx == 0.0:
        return 0.0
    return mx + (float(sum_priority) / mx)


def preemption_score(net_prio: float) -> float:
    """Logistic decay with its inflection at 2048 (upstream: rank.go
    preemptionScore)."""
    rate = 0.0048
    origin = 2048.0
    return 1.0 / (1.0 + math.exp(rate * (net_prio - origin)))


class PreemptionScoringIterator(RankIterator):
    """Scores a node by what its placement would evict
    (upstream: rank.go:851)."""

    def __init__(self, ctx: EvalContext, source: RankIterator):
        self.ctx = ctx
        self.source = source

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None or not option.preempted_allocs:
            return option
        score = preemption_score(net_priority(option.preempted_allocs))
        option.scores.append(score)
        self.ctx.metrics.score_node(option.node.id, "preemption", score)
        return option

    def reset(self) -> None:
        self.source.reset()
