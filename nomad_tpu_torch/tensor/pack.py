"""Node-axis array tables (port of the array parts of
nomad_tpu/tensor/pack.py, and of the preemption candidate tables of
nomad_tpu/solver/service.py).

Shapes are padded to bucket sizes so one kernel shape serves many fleet
sizes. Building these from Node and Allocation structs (pack_nodes,
pack_usage) waits for the structs slice; callers hand in arrays.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

DEFAULT_NODE_BUCKETS = (64, 256, 1024, 4096, 16384, 65536)


def bucket_size(n: int, buckets=DEFAULT_NODE_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(2 ** np.ceil(np.log2(max(n, 1))))


@dataclass
class NodeMatrix:
    """Static per-eval node-axis tensors (padded to n_pad): capacity minus
    agent-reserved resources, free dynamic ports, and the real-node mask."""

    n_real: int
    n_pad: int
    node_ids: List[str]
    cpu_cap: np.ndarray        # (n_pad,) float64
    mem_cap: np.ndarray
    disk_cap: np.ndarray
    dyn_free: np.ndarray       # (n_pad,) int32 free ports in dynamic range
    valid: np.ndarray          # (n_pad,) bool -- real node vs padding


@dataclass
class UsageState:
    """Dynamic usage on the node axis: what proposed allocs consume."""

    used_cpu: np.ndarray       # (n_pad,) float64
    used_mem: np.ndarray
    used_disk: np.ndarray
    placed_jobtg: np.ndarray   # (n_pad,) int32 allocs of THIS job+tg per node
    placed_job: np.ndarray     # (n_pad,) int32 allocs of THIS job (any tg)
    dyn_used: np.ndarray       # (n_pad,) int32 dynamic-range ports in use


@dataclass
class SpreadInfo:
    """Spread attributes as arrays: per spread, each node's value index into
    a padded value table plus desired counts (reference: spread.go
    computeSpreadInfo + propertyset.go)."""

    n_spreads: int
    value_index: np.ndarray    # (S, n_pad) int32; -1 = attribute missing
    n_values: int              # V (padded distinct values across spreads)
    desired: np.ndarray        # (S, V) float64; -1 = no explicit target
    has_targets: np.ndarray    # (S,) bool
    weights: np.ndarray        # (S,) float64
    sum_weights: float
    initial_counts: np.ndarray  # (S, V) int32 existing allocs per value
    values: List[List[str]] = field(default_factory=list)


@dataclass
class DistinctPropertyInfo:
    """distinct_property constraints as arrays (reference:
    solver/service.py _pack_distinct_property; feasible.go:661,
    propertyset.go): per constraint d, each node's value index (-1 = the
    attribute is missing, so the node is infeasible), the limit of allocs
    per value, and the job's current alloc count per value."""

    value_index: np.ndarray    # (Dp, n_pad) int32
    limit: np.ndarray          # (Dp,) int32
    tg_scope: np.ndarray       # (Dp,) bool: task-group-level constraint
    counts: np.ndarray         # (Dp, Vd) int32


@dataclass
class DeviceInfo:
    """Device requests as arrays (reference: solver/service.py
    _pack_devices; feasible.go:1270, scheduler/device.go): per request r
    and node device group g, the affinity score and the free instance
    count (-1 = the group does not match the request)."""

    affinity: np.ndarray       # (R, Gd, n_pad) float
    count: np.ndarray          # (R,) int32 instances asked
    sum_weight: float          # sum of |affinity weights| over requests
    free: np.ndarray           # (R, Gd, n_pad) int32


@dataclass
class PreemptInfo:
    """A preemption lane's candidates as arrays in original node order
    (reference: solver/service.py _pack_preemption): per node, every
    proposed alloc is one candidate column, in proposed-alloc order; the
    columns of a node past its allocs are padding (valid False, grp -1).
    ``valid`` is False for the placing job's own allocs and terminal ones.
    ``counts`` holds the evictions each (job, task group) already has in
    the eval's plan; ``grp`` indexes it."""

    cpu: np.ndarray            # (n_pad, A) MHz
    mem: np.ndarray            # (n_pad, A) MB
    disk: np.ndarray           # (n_pad, A) MB
    prio: np.ndarray           # (n_pad, A) int32 job priority
    maxp: np.ndarray           # (n_pad, A) int32 migrate.max_parallel
    grp: np.ndarray            # (n_pad, A) int32 group index, -1 none
    valid: np.ndarray          # (n_pad, A) bool eligible candidate
    job_prio: int              # the placing job's priority
    counts: np.ndarray         # (G,) int32


def journal_touched_nodes(pairs) -> set:
    """The node ids an alloc-delta journal span touches (both ends of a
    move: the node an alloc left and the node it landed on). The
    resident chain reports it beside the elements it scatters; the
    scatter's update set itself is the bitwise diff of the tables, since
    under the per-eval shuffle journal rows do not map to fixed table
    rows."""
    touched: set = set()
    for old, new in pairs:
        for a in (old, new):
            nid = getattr(a, "node_id", None)
            if nid:
                touched.add(nid)
    return touched
