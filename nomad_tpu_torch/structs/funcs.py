"""Fit checks (port of nomad_tpu/structs/funcs.py; upstream:
nomad/structs/funcs.go):
  - allocs_fit          (funcs.go:141 AllocsFit)
  - devices_fit         (devices.go DeviceAccounter)
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from .alloc import Allocation
from .network import NetworkIndex
from .node import Node
from .resources import ComparableResources

def allocs_fit(node: Node, allocs: List[Allocation],
               net_idx: Optional[NetworkIndex] = None,
               check_devices: bool = False,
               ) -> Tuple[bool, str, ComparableResources]:
    """Check whether a set of allocations fits on a node.

    Returns (fits, failing-dimension, used-resources). Mirrors the exact
    check order of the reference (funcs.go:141): core overlap, then resource
    superset, then port collisions, then device oversubscription.
    """
    used = ComparableResources()
    reserved_cores = set()
    core_overlap = False

    for alloc in allocs:
        if alloc.client_terminal_status():
            continue
        cr = alloc.allocated_resources.comparable()
        used.add(cr)
        for core in cr.reserved_cores:
            if core in reserved_cores:
                core_overlap = True
            reserved_cores.add(core)

    if core_overlap:
        return False, "cores", used

    available = node.node_resources.comparable()
    available.subtract(node.reserved_resources.comparable())
    # Expose node's reservable cores for the superset core check
    available.reserved_cores = [
        c for c in node.node_resources.cpu.reservable_cores
        if c not in node.reserved_resources.cores]
    ok, dim = available.superset(used)
    if not ok:
        return False, dim, used

    if net_idx is None:
        net_idx = NetworkIndex()
        err = net_idx.set_node(node)
        if err:
            return False, f"reserved node port collision: {err}", used
        collision, reason = net_idx.add_allocs(allocs)
        if collision:
            return False, f"reserved alloc port collision: {reason}", used

    if net_idx.overcommitted():
        return False, "bandwidth exceeded", used

    if check_devices:
        ok, dim = devices_fit(node, allocs)
        if not ok:
            return False, dim, used

    return True, "", used


def devices_fit(node: Node, allocs: List[Allocation]) -> Tuple[bool, str]:
    """Check device instance oversubscription
    (reference: structs.DeviceAccounter in devices.go)."""
    counts = {}   # (vendor,type,name) -> used count
    caps = {d.id_string(): len(d.instance_ids) for d in node.node_resources.devices}
    instance_used = {}  # id_string -> set(instance ids)
    for alloc in allocs:
        if alloc.client_terminal_status():
            continue
        for tr in alloc.allocated_resources.tasks.values():
            for dev in tr.devices:
                key = dev.id_string()
                seen = instance_used.setdefault(key, set())
                for inst in dev.device_ids:
                    if inst in seen:
                        return False, "device oversubscribed"
                    seen.add(inst)
                counts[key] = counts.get(key, 0) + len(dev.device_ids)
    for key, used_n in counts.items():
        if used_n > caps.get(key, 0):
            return False, "device oversubscribed"
    return True, ""
