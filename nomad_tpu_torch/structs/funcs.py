"""Fit checks (port of nomad_tpu/structs/funcs.py; upstream:
nomad/structs/funcs.go):
  - allocs_fit          (funcs.go:141 AllocsFit)
  - devices_fit         (devices.go DeviceAccounter)
  - score_fit_binpack   (funcs.go:236 ScoreFitBinPack, BestFit v3:
                         score = 20 - (10^freeCpuPct + 10^freeRamPct),
                         clamp [0, 18])
  - score_fit_spread    (funcs.go:263 ScoreFitSpread, worst fit:
                         score = (10^freeCpuPct + 10^freeRamPct) - 2,
                         clamp [0, 18])
The host scorers are float64 math on the host; the kernels compute the
same expressions over the node axis.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

from .alloc import Allocation
from .network import NetworkIndex
from .node import Node
from .resources import ComparableResources

BINPACK_MAX_FIT_SCORE = 18.0

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


def compute_free_percentage(node: Node, util: ComparableResources
                            ) -> Tuple[float, float]:
    """(free cpu share, free memory share) after the node's reserved
    resources (reference: funcs.go computeFreePercentage). A node with
    no capacity gives NaN, which both scorers clamp to 0."""
    node_cpu = float(node.node_resources.cpu.cpu_shares
                     - node.reserved_resources.cpu_shares)
    node_mem = float(node.node_resources.memory.memory_mb
                     - node.reserved_resources.memory_mb)
    if node_cpu <= 0.0 or node_mem <= 0.0:
        return math.nan, math.nan
    free_cpu = 1.0 - (float(util.cpu_shares) / node_cpu)
    free_ram = 1.0 - (float(util.memory_mb) / node_mem)
    return free_cpu, free_ram


def score_fit_binpack(node: Node, util: ComparableResources) -> float:
    """BestFit v3: 18 at full use, 0 when empty."""
    free_cpu, free_ram = compute_free_percentage(node, util)
    if math.isnan(free_cpu):
        return 0.0
    total = math.pow(10.0, free_cpu) + math.pow(10.0, free_ram)
    score = 20.0 - total
    if score > BINPACK_MAX_FIT_SCORE:
        score = BINPACK_MAX_FIT_SCORE
    elif score < 0.0:
        score = 0.0
    return score


def score_fit_spread(node: Node, util: ComparableResources) -> float:
    """Worst fit: the binpack score turned around."""
    free_cpu, free_ram = compute_free_percentage(node, util)
    if math.isnan(free_cpu):
        return 0.0
    total = math.pow(10.0, free_cpu) + math.pow(10.0, free_ram)
    score = total - 2.0
    if score > BINPACK_MAX_FIT_SCORE:
        score = BINPACK_MAX_FIT_SCORE
    elif score < 0.0:
        score = 0.0
    return score
