"""Preemption search: which lower-priority allocs to evict for a placement
(port of nomad_tpu/scheduler/preemption.py; upstream:
scheduler/preemption.go):
  Preemptor (:201 region), PreemptForTaskGroup (greedy pick by resource
  distance then superset filter), filterAndGroupPreemptibleAllocs (:666,
  only priority <= jobPriority-10 eligible), basicResourceDistance (:611),
  scoreForTaskGroup with maxParallelPenalty=50 (:16), filterSuperset (:705),
  PreemptForNetwork (:273) and PreemptForDevice (:475).

Network preemption is re-designed around ports (the reference scores by
deprecated MBits; our network model is port-bitmap based -- see
structs/network.py), keeping the same candidate filtering and net-priority
minimization contract.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from ..structs import (
    Allocation, ComparableResources, NetworkIndex, Node,
)
from .context import EvalContext

MAX_PARALLEL_PENALTY = 50.0


def basic_resource_distance(ask: ComparableResources,
                            used: ComparableResources) -> float:
    """Euclidean distance in normalized (cpu, mem, disk) space
    (reference: preemption.go:611)."""
    mem_c = cpu_c = disk_c = 0.0
    if ask.memory_mb > 0:
        mem_c = (float(ask.memory_mb) - float(used.memory_mb)) / float(ask.memory_mb)
    if ask.cpu_shares > 0:
        cpu_c = (float(ask.cpu_shares) - float(used.cpu_shares)) / float(ask.cpu_shares)
    if ask.disk_mb > 0:
        disk_c = (float(ask.disk_mb) - float(used.disk_mb)) / float(ask.disk_mb)
    return math.sqrt(mem_c ** 2 + cpu_c ** 2 + disk_c ** 2)


def score_for_task_group(ask: ComparableResources, used: ComparableResources,
                         max_parallel: int, num_preempted: int) -> float:
    """Distance + max_parallel penalty (reference: preemption.go:644)."""
    penalty = 0.0
    if max_parallel > 0 and num_preempted >= max_parallel:
        penalty = float((num_preempted + 1) - max_parallel) * MAX_PARALLEL_PENALTY
    return basic_resource_distance(ask, used) + penalty


def filter_and_group_preemptible(job_priority: int,
                                 current: List[Allocation]
                                 ) -> List[Tuple[int, List[Allocation]]]:
    """Group by priority ascending; only allocs at least 10 priority levels
    below are eligible (reference: preemption.go:666)."""
    by_priority: Dict[int, List[Allocation]] = {}
    for alloc in current:
        if alloc.job is None:
            continue
        if job_priority - alloc.job.priority < 10:
            continue
        by_priority.setdefault(alloc.job.priority, []).append(alloc)
    return sorted(by_priority.items(), key=lambda kv: kv[0])


class Preemptor:
    """(reference: preemption.go Preemptor)"""

    def __init__(self, job_priority: int, ctx: Optional[EvalContext],
                 job_ns_id: Tuple[str, str]):
        self.job_priority = job_priority
        self.ctx = ctx
        self.job_ns_id = job_ns_id
        self.current_allocs: List[Allocation] = []
        self.alloc_details: Dict[str, Tuple[int, ComparableResources]] = {}
        self.current_preemptions: Dict[Tuple[str, str, str], int] = {}
        self.node_remaining: Optional[ComparableResources] = None
        self.node: Optional[Node] = None

    def set_node(self, node: Node) -> None:
        self.node = node
        remaining = node.node_resources.comparable()
        remaining.subtract(node.reserved_resources.comparable())
        self.node_remaining = remaining

    def set_candidates(self, allocs: List[Allocation]) -> None:
        self.current_allocs = []
        self.alloc_details = {}
        for alloc in allocs:
            # Skip this job's own allocs and anything already terminal
            if (alloc.namespace, alloc.job_id) == self.job_ns_id:
                continue
            if alloc.terminal_status():
                continue
            max_parallel = 0
            if alloc.job is not None:
                tg = alloc.job.lookup_task_group(alloc.task_group)
                if tg is not None and tg.migrate is not None:
                    max_parallel = tg.migrate.max_parallel
            self.alloc_details[alloc.id] = (
                max_parallel, alloc.allocated_resources.comparable())
            self.current_allocs.append(alloc)

    def set_preemptions(self, allocs: List[Allocation]) -> None:
        self.current_preemptions = {}
        for alloc in allocs:
            key = (alloc.namespace, alloc.job_id, alloc.task_group)
            self.current_preemptions[key] = self.current_preemptions.get(key, 0) + 1

    def _num_preemptions(self, alloc: Allocation) -> int:
        return self.current_preemptions.get(
            (alloc.namespace, alloc.job_id, alloc.task_group), 0)

    # -- CPU/memory/disk path (reference: PreemptForTaskGroup) --------------
    def preempt_for_task_group(self, resource_ask) -> List[Allocation]:
        # comparable() results are cached on the ask and shared between
        # the three calls in this method; this one is mutated (subtract
        # below), so it must be a private copy
        resources_needed = resource_ask.comparable().copy()
        node_remaining = self.node_remaining.copy()
        for alloc in self.current_allocs:
            node_remaining.subtract(self.alloc_details[alloc.id][1])

        groups = filter_and_group_preemptible(self.job_priority,
                                              self.current_allocs)
        best: List[Allocation] = []
        all_met = False
        available = node_remaining.copy()
        resources_asked = resource_ask.comparable()

        for _prio, group in groups:
            group = list(group)
            while group and not all_met:
                best_dist = math.inf
                best_idx = -1
                for idx, alloc in enumerate(group):
                    max_parallel, used = self.alloc_details[alloc.id]
                    dist = score_for_task_group(
                        resources_needed, used, max_parallel,
                        self._num_preemptions(alloc))
                    if dist < best_dist:
                        best_dist = dist
                        best_idx = idx
                closest = group.pop(best_idx)
                closest_res = self.alloc_details[closest.id][1]
                available.add(closest_res)
                all_met, _ = available.superset(resources_asked)
                best.append(closest)
                resources_needed.subtract(closest_res)
            if all_met:
                break

        if not all_met:
            return []

        return self._filter_superset(best, node_remaining,
                                     resource_ask.comparable())

    def _filter_superset(self, best: List[Allocation],
                         node_remaining: ComparableResources,
                         ask: ComparableResources) -> List[Allocation]:
        """Drop allocs whose resources are already covered by the rest
        (reference: preemption.go:705 filterSuperset)."""
        best = sorted(
            best,
            key=lambda a: basic_resource_distance(
                ask, self.alloc_details[a.id][1]),
            reverse=True)
        available = node_remaining.copy()
        out: List[Allocation] = []
        met = False
        for alloc in best:
            if met:
                break
            available.add(self.alloc_details[alloc.id][1])
            out.append(alloc)
            met, _ = available.superset(ask)
        return out

    # -- network path (port-based re-design of PreemptForNetwork) -----------
    def preempt_for_network(self, ask, net_idx: NetworkIndex
                            ) -> Optional[List[Allocation]]:
        """Free ports by preempting the cheapest (lowest net-priority) set of
        eligible allocs whose released ports make the ask assignable."""
        if not self.current_allocs:
            return None
        wanted_static = {p.value for p in ask.reserved_ports}
        groups = filter_and_group_preemptible(self.job_priority,
                                              self.current_allocs)
        chosen: List[Allocation] = []
        for _prio, group in groups:
            for alloc in group:
                ports = {pm.value for pm in
                         alloc.allocated_resources.shared.ports}
                for net in alloc.allocated_resources.shared.networks:
                    ports.update(p.value for p in net.reserved_ports)
                    ports.update(p.value for p in net.dynamic_ports)
                if wanted_static & ports or (not wanted_static and ports):
                    chosen.append(alloc)
                    # Would the ask fit with these preempted?
                    if self._network_ask_fits_without(chosen, ask):
                        return chosen
        return None

    def _network_ask_fits_without(self, preempted: List[Allocation],
                                  ask) -> bool:
        idx = NetworkIndex()
        if self.node is not None:
            idx.set_node(self.node)
        removed = {a.id for a in preempted}
        idx.add_allocs([a for a in self.current_allocs
                        if a.id not in removed])
        offer, _ = idx.assign_ports([ask])
        return offer is not None

    # -- device path (reference: PreemptForDevice) --------------------------
    def preempt_for_device(self, req, dev_allocator
                           ) -> Optional[List[Allocation]]:
        """Free device instances by preempting holders; chooses the option
        with minimal net priority (reference: preemption.go:475-558)."""
        # Map device group -> allocs holding instances of it
        holders: Dict[str, List[Tuple[Allocation, int]]] = {}
        for alloc in self.current_allocs:
            if alloc.job is None:
                continue
            if self.job_priority - alloc.job.priority < 10:
                continue
            for tr in alloc.allocated_resources.tasks.values():
                for dev in tr.devices:
                    holders.setdefault(dev.id_string(), []).append(
                        (alloc, len(dev.device_ids)))

        best_option: Optional[List[Allocation]] = None
        best_net_priority = math.inf
        for group in self.node.node_resources.devices:
            if not group.matches_request(req.name):
                continue
            entries = holders.get(group.id_string(), [])
            if not entries:
                continue
            free = len(group.instance_ids) - sum(
                n for _, n in entries)
            needed = req.count - max(free, 0)
            if needed <= 0:
                continue
            # Sort holders by instance count descending, take until covered
            entries = sorted(entries, key=lambda e: -e[1])
            covered = 0
            option: List[Allocation] = []
            priorities = set()
            net_prio = 0
            for alloc, n in entries:
                if covered >= needed:
                    break
                covered += n
                option.append(alloc)
                p = alloc.job.priority
                if p not in priorities:
                    priorities.add(p)
                    net_prio += p
            if covered >= needed and net_prio < best_net_priority:
                best_net_priority = net_prio
                best_option = option
        return best_option
