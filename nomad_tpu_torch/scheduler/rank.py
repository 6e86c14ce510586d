"""Device and reserved-core packing (port of nomad_tpu/scheduler/rank.py
DeviceAllocator and select_reserved_cores; upstream: scheduler/device.go,
rank.go:481-524). The placement service sizes its device and core tables
with these and replays them at materialize for exact instance and core
ids. The rank iterators come with the scheduler slice.
"""
from __future__ import annotations

from typing import Dict, List

from ..structs import AllocatedDeviceResource, Allocation, Node
from .context import EvalContext
from .feasible import DeviceChecker, check_constraint


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
