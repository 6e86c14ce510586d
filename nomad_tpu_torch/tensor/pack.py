"""Node-axis tables: structs in, arrays out (port of
nomad_tpu/tensor/pack.py, and of the preemption candidate tables of
nomad_tpu/solver/service.py).

Shapes are padded to bucket sizes so one kernel shape serves many fleet
sizes. ``pack_nodes`` / ``pack_usage`` / ``fold_usage_base`` /
``pack_feasibility`` / ``pack_spreads`` / ``pack_affinities`` build the
tables from Node, Job and Allocation structs; callers may also hand in
arrays directly (solver/service.py pack_lane_arrays).

Everything derived only from (node-table version, job or task-group
spec) is memoized on the version-keyed NodeMatrix (pack_nodes_cached):
feasibility masks, spread tables, affinity columns, and the placement
service's usage base. A node-table write drops stale matrices
(note_table_write, called by state/store.py); memoized arrays are frozen
read-only and every consumer copies before it writes. The uncached
functions are the definitions the memo forms call; the kill switch
``NOMAD_TPU_TORCH_PACK_CACHE=0`` (pack_cache_enabled) has the placement
service call them directly.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import jitcheck, statecheck
from ..structs.resources import (
    DEFAULT_MAX_DYNAMIC_PORT, DEFAULT_MIN_DYNAMIC_PORT)

PORT_WORDS = 2048          # 65536 ports / 32 bits
DEFAULT_NODE_BUCKETS = (64, 256, 1024, 4096, 16384, 65536)


def bucket_size(n: int, buckets=DEFAULT_NODE_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(2 ** np.ceil(np.log2(max(n, 1))))


@dataclass
class NodeMatrix:
    """Static per-eval node-axis tensors (padded to n_pad): capacity minus
    agent-reserved resources, free dynamic ports, and the real-node mask.
    The trailing fields are what pack_nodes adds: the agent-reserved port
    bitmap ((n_pad, PORT_WORDS) uint32, None when no node reserves a
    port) and the computed-class coding (codes (n_pad,) int32, -1 for
    padding or no class; class_reps[c] = the node index representing
    code c) that vectorises feasibility."""

    n_real: int
    n_pad: int
    node_ids: List[str]
    cpu_cap: np.ndarray        # (n_pad,) float64
    mem_cap: np.ndarray
    disk_cap: np.ndarray
    dyn_free: np.ndarray       # (n_pad,) int32 free ports in dynamic range
    valid: np.ndarray          # (n_pad,) bool -- real node vs padding
    port_bitmap: Optional[np.ndarray] = None
    class_codes: Optional[np.ndarray] = None
    class_reps: Optional[List[int]] = None


@dataclass
class UsageState:
    """Dynamic usage on the node axis: what proposed allocs consume.
    ``port_bitmap`` ((n_pad, PORT_WORDS) uint32, alloc ports included;
    None when no port state exists) trails the other fields."""

    used_cpu: np.ndarray       # (n_pad,) float64
    used_mem: np.ndarray
    used_disk: np.ndarray
    placed_jobtg: np.ndarray   # (n_pad,) int32 allocs of THIS job+tg per node
    placed_job: np.ndarray     # (n_pad,) int32 allocs of THIS job (any tg)
    dyn_used: np.ndarray       # (n_pad,) int32 dynamic-range ports in use
    port_bitmap: Optional[np.ndarray] = None

    def ensure_bitmap(self, n_pad: int) -> np.ndarray:
        if self.port_bitmap is None:
            self.port_bitmap = np.zeros((n_pad, PORT_WORDS), dtype=np.uint32)
        return self.port_bitmap


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


# ---------------------------------------------------------------------------
# structs -> tables

def pack_nodes(nodes, n_pad: Optional[int] = None) -> NodeMatrix:
    """The node axis of a node list: capacity minus agent-reserved
    resources, free dynamic ports, reserved-port bitmap and class codes."""
    n = len(nodes)
    if n_pad is None:
        n_pad = bucket_size(n)
    cpu = np.zeros(n_pad, dtype=np.float64)
    mem = np.zeros(n_pad, dtype=np.float64)
    disk = np.zeros(n_pad, dtype=np.float64)
    ports: Optional[np.ndarray] = None
    dyn_free = np.zeros(n_pad, dtype=np.int32)
    valid = np.zeros(n_pad, dtype=bool)
    ids = []
    codes = np.full(n_pad, -1, dtype=np.int32)
    code_of: Dict[str, int] = {}
    reps: List[int] = []
    for i, node in enumerate(nodes):
        ids.append(node.id)
        cls = node.computed_class
        if cls:
            code = code_of.get(cls)
            if code is None:
                code = len(reps)
                code_of[cls] = code
                reps.append(i)
            codes[i] = code
        nr, rr = node.node_resources, node.reserved_resources
        cpu[i] = nr.cpu.cpu_shares - rr.cpu_shares
        mem[i] = nr.memory.memory_mb - rr.memory_mb
        disk[i] = nr.disk.disk_mb - rr.disk_mb
        lo, hi = nr.min_dynamic_port, nr.max_dynamic_port
        dyn_free[i] = max(0, hi - lo + 1)
        for p in rr.reserved_ports:
            if 0 <= p < 65536:
                if ports is None:
                    ports = np.zeros((n_pad, PORT_WORDS), dtype=np.uint32)
                ports[i, p >> 5] |= np.uint32(1 << (p & 31))
                if lo <= p <= hi:
                    dyn_free[i] -= 1
        valid[i] = True
    return NodeMatrix(n_real=n, n_pad=n_pad, node_ids=ids, cpu_cap=cpu,
                      mem_cap=mem, disk_cap=disk, dyn_free=dyn_free,
                      valid=valid, port_bitmap=ports, class_codes=codes,
                      class_reps=reps)


# pack_nodes memoized per (node-table version, node-id tuple), a true LRU
# shared by concurrent eval threads
_NODE_MATRIX_CACHE: "OrderedDict[tuple, NodeMatrix]" = OrderedDict()
_NODE_MATRIX_CACHE_MAX = 8
_NODE_MATRIX_LOCK = threading.Lock()
# one build per key: the eval threads of a generation that miss together
# wait for the first one's matrix instead of each building their own
_NODE_MATRIX_BUILDS: Dict[tuple, threading.Lock] = {}
# per-matrix memo bound: a spec churn clears rather than grows unbounded
_MATRIX_MEMO_MAX = 64

_PACK_STATS = {
    "hits": 0,              # feasibility / spread / affinity memo hits
    "misses": 0,
    "matrix_hits": 0,       # node-matrix cache
    "matrix_misses": 0,
    "usage_base_hits": 0,   # the placement service's usage base
    "usage_base_misses": 0,
    # a stale base advanced by the journal's alloc deltas instead of a
    # refold (solver/service.py _catch_up_usage_base)
    "usage_base_delta_hits": 0,
    "invalidations": 0,
}
_PACK_STATS_LOCK = threading.Lock()
def pack_cache_enabled() -> bool:
    """(reference :138) ``NOMAD_TPU_TORCH_PACK_CACHE=0`` bypasses every
    memo of the placement service's pack: it packs the usage, the
    feasibility, the spreads and the affinities uncached, per eval (the
    reference's oracle path)."""
    return os.environ.get("NOMAD_TPU_TORCH_PACK_CACHE", "1") != "0"


# per-thread hit/miss window: one pack call's cache outcomes on its own
# thread, whatever other eval threads do meanwhile
_PACK_TLS = threading.local()


def _stat_incr(name: str, n: int = 1) -> None:
    with _PACK_STATS_LOCK:
        _PACK_STATS[name] += n
    bucket = ("hit" if name.endswith("hits")
              else "miss" if name.endswith("misses") else None)
    if bucket is not None:
        setattr(_PACK_TLS, bucket, getattr(_PACK_TLS, bucket, 0) + n)


def begin_pack_window() -> Tuple[int, int]:
    """Start of one pack call on this thread: the thread-local (hits,
    misses) watermark."""
    return (getattr(_PACK_TLS, "hit", 0), getattr(_PACK_TLS, "miss", 0))


def end_pack_window(mark: Tuple[int, int]) -> Tuple[int, int]:
    """(hits, misses) this thread recorded since ``mark``."""
    return (getattr(_PACK_TLS, "hit", 0) - mark[0],
            getattr(_PACK_TLS, "miss", 0) - mark[1])


def pack_cache_stats() -> dict:
    with _PACK_STATS_LOCK:
        out = dict(_PACK_STATS)
    with _NODE_MATRIX_LOCK:
        out["matrix_entries"] = len(_NODE_MATRIX_CACHE)
    out["enabled"] = pack_cache_enabled()
    return out


def invalidate_pack_caches(reason: str = "") -> None:
    """Drop every cached matrix (their memos die with them)."""
    with _NODE_MATRIX_LOCK:
        had = bool(_NODE_MATRIX_CACHE)
        _NODE_MATRIX_CACHE.clear()
    if had:
        _stat_incr("invalidations")


def usage_lock(matrix) -> threading.Lock:
    """The lock under which one thread at a time folds or catches up the
    usage base memoized on ``matrix`` (solver/service.py)."""
    lock = matrix.__dict__.get("_usage_lock")
    if lock is None:
        with _NODE_MATRIX_LOCK:
            lock = matrix.__dict__.setdefault("_usage_lock",
                                              threading.Lock())
    return lock


def note_table_write(tables, table_index: int, delta=None) -> None:
    """The state store's write hook: a node-table write drops the
    matrices of older fleet versions. Alloc writes need nothing here:
    usage bases catch up through the store's journal."""
    if "nodes" in tables:
        note_node_table_write(table_index)


def note_node_table_write(table_index: int) -> None:
    with _NODE_MATRIX_LOCK:
        stale = [k for k in _NODE_MATRIX_CACHE if k[0] < table_index]
        for k in stale:
            del _NODE_MATRIX_CACHE[k]
    if stale:
        _stat_incr("invalidations")


def reset_pack_caches() -> None:
    """Empty the matrix cache and zero the counters."""
    with _NODE_MATRIX_LOCK:
        _NODE_MATRIX_CACHE.clear()
        _NODE_MATRIX_BUILDS.clear()
    with _PACK_STATS_LOCK:
        for k in _PACK_STATS:
            _PACK_STATS[k] = 0


def pack_nodes_cached(nodes, node_table_index: Optional[int],
                      key_hint=None) -> NodeMatrix:
    """pack_nodes memoized by node-table version; the result is frozen
    (callers never write it). ``key_hint`` is the node-id tuple where the
    caller holds it already (the snapshot's ready-list memo). Threads
    that miss one key together build it once: the others wait for it."""
    if node_table_index is None:
        return pack_nodes(nodes)
    key = (node_table_index,
           key_hint if key_hint is not None
           else tuple(n.id for n in nodes))

    def lookup():
        with _NODE_MATRIX_LOCK:
            hit = _NODE_MATRIX_CACHE.get(key)
            if hit is not None:
                _NODE_MATRIX_CACHE.move_to_end(key)
            return hit

    hit = lookup()
    if hit is None:
        with _NODE_MATRIX_LOCK:
            build = _NODE_MATRIX_BUILDS.setdefault(key, threading.Lock())
        with build:
            hit = lookup()
            if hit is None:
                matrix = pack_nodes(nodes)
                _stat_incr("matrix_misses")
                freeze_matrix(matrix)
                with _NODE_MATRIX_LOCK:
                    while len(_NODE_MATRIX_CACHE) >= _NODE_MATRIX_CACHE_MAX:
                        _NODE_MATRIX_CACHE.popitem(last=False)
                    _NODE_MATRIX_CACHE[key] = matrix
                    _NODE_MATRIX_BUILDS.pop(key, None)
                return matrix
    _stat_incr("matrix_hits")
    if statecheck._ACTIVE:
        # the served entry must be the version the caller's snapshot
        # pins (equal by construction: this guards the keying)
        statecheck.note_memo_served("node_matrix", key[0],
                                    node_table_index)
    return hit


def _matrix_memo(matrix, key, build):
    """``build()`` memoized on the version-keyed NodeMatrix, frozen."""
    if matrix is None:
        return build()
    memo = matrix.__dict__.get("_pack_memo")
    if memo is None:
        memo = matrix.__dict__.setdefault("_pack_memo", {})
    hit = memo.get(key)
    if hit is not None:
        _stat_incr("hits")
        return hit[0]
    out = build()
    _freeze(out)
    _stat_incr("misses")
    if len(memo) >= _MATRIX_MEMO_MAX:
        memo.clear()
    memo[key] = (out,)          # tuple-wrapped: None is a valid result
    return out


def _freeze(obj) -> None:
    """Mark a memo's numpy payloads read-only (shared across evals) and
    register them with the sanitizers while they record."""
    if isinstance(obj, np.ndarray):
        obj.setflags(write=False)
        _note_frozen(obj)
    elif isinstance(obj, SpreadInfo):
        for arr in (obj.value_index, obj.desired, obj.has_targets,
                    obj.weights, obj.initial_counts):
            arr.setflags(write=False)
            _note_frozen(arr)


def _note_frozen(arr) -> None:
    """A frozen memo payload: jitcheck's frozen-memo registry, and the
    published set statecheck re-fingerprints."""
    if jitcheck._ACTIVE:
        jitcheck.note_frozen(arr)
    if statecheck._ACTIVE:
        statecheck.note_published(arr)


def freeze_matrix(matrix: NodeMatrix) -> None:
    """Freeze a NodeMatrix's arrays before it enters the shared cache."""
    for arr in (matrix.cpu_cap, matrix.mem_cap, matrix.disk_cap,
                matrix.dyn_free, matrix.valid, matrix.class_codes,
                matrix.port_bitmap):
        if isinstance(arr, np.ndarray):
            arr.setflags(write=False)
            _note_frozen(arr)


def freeze_usage_base(base: dict) -> None:
    """Freeze a memoized usage base: every eval of a snapshot shares it
    and copies before it overlays its own plan deltas."""
    for k in ("used_cpu", "used_mem", "used_disk", "dyn_used"):
        base[k].setflags(write=False)
        _note_frozen(base[k])
    if base.get("ports") is not None:
        base["ports"].setflags(write=False)
        _note_frozen(base["ports"])


def _constraints_fp(constraints) -> tuple:
    return tuple((c.l_target, c.operand, str(c.r_target))
                 for c in constraints)


def pack_feasibility_cached(ctx, stack_like, tg, nodes, n_pad: int,
                            alloc_name: str = "", matrix=None
                            ) -> np.ndarray:
    """pack_feasibility memoized per (node-table version, fingerprint of
    everything the checkers read: job and merged task-group
    constraints, drivers, device asks, volumes with the alloc name that
    scopes per-alloc claims, and the network ask)."""
    from ..scheduler.stack import _tg_constraints

    job = ctx.plan.job
    drivers, constraints = _tg_constraints(tg)
    key = ("feas",
           _constraints_fp(job.constraints if job else []),
           tuple(sorted(drivers)),
           _constraints_fp(constraints),
           repr([r for t in tg.tasks for r in t.resources.devices]),
           repr(tg.volumes), alloc_name if tg.volumes else "",
           repr(tg.networks[0]) if tg.networks else "")
    return _matrix_memo(matrix, key, lambda: pack_feasibility(
        ctx, stack_like, tg, nodes, n_pad, alloc_name=alloc_name,
        matrix=matrix))


def pack_spreads_cached(spreads, nodes, n_pad: int, tg_count: int,
                        existing_value_counts=None, matrix=None
                        ) -> Optional[SpreadInfo]:
    """pack_spreads memoized per (node-table version, spread spec,
    existing value counts)."""
    if not spreads:
        return None
    key = ("spread", repr(spreads), int(tg_count),
           tuple(tuple(sorted(c.items())) for c in existing_value_counts)
           if existing_value_counts else None)
    return _matrix_memo(matrix, key, lambda: pack_spreads(
        spreads, nodes, n_pad, tg_count, existing_value_counts))


def pack_affinities_cached(affinities, ctx, nodes, n_pad: int,
                           matrix=None) -> Optional[np.ndarray]:
    """pack_affinities memoized per (node-table version, affinity spec)."""
    if not affinities:
        return None
    key = ("aff", repr(affinities))
    return _matrix_memo(matrix, key, lambda: pack_affinities(
        affinities, ctx, nodes, n_pad))


def pack_usage(matrix: NodeMatrix, proposed_by_node: Dict[str, list],
               job_id: str, tg_name: str, namespace: str = "default",
               nodes=None) -> UsageState:
    """Fold proposed allocations into usage tables. ``proposed_by_node``
    maps node id -> what ctx.proposed_allocs returns for it."""
    n_pad = matrix.n_pad
    used_cpu = np.zeros(n_pad, dtype=np.float64)
    used_mem = np.zeros(n_pad, dtype=np.float64)
    used_disk = np.zeros(n_pad, dtype=np.float64)
    placed = np.zeros(n_pad, dtype=np.int32)
    placed_job = np.zeros(n_pad, dtype=np.int32)
    ports = (matrix.port_bitmap.copy()
             if matrix.port_bitmap is not None else None)
    dyn_used = np.zeros(n_pad, dtype=np.int32)
    index = {nid: i for i, nid in enumerate(matrix.node_ids)}
    dyn_ranges = {}
    if nodes is not None:
        for node in nodes:
            dyn_ranges[node.id] = (node.node_resources.min_dynamic_port,
                                   node.node_resources.max_dynamic_port)
    for nid, allocs in proposed_by_node.items():
        i = index.get(nid)
        if i is None:
            continue
        lo, hi = dyn_ranges.get(nid, (DEFAULT_MIN_DYNAMIC_PORT,
                                      DEFAULT_MAX_DYNAMIC_PORT))
        for alloc in allocs:
            cr = alloc.allocated_resources.comparable()
            used_cpu[i] += cr.cpu_shares
            used_mem[i] += cr.memory_mb
            used_disk[i] += cr.disk_mb
            if alloc.job_id == job_id and alloc.namespace == namespace:
                placed_job[i] += 1
                if alloc.task_group == tg_name:
                    placed[i] += 1
            for v in alloc.allocated_resources.all_ports():
                if 0 <= v < 65536:
                    if ports is None:
                        ports = np.zeros((n_pad, PORT_WORDS),
                                         dtype=np.uint32)
                    word, bit = v >> 5, np.uint32(1 << (v & 31))
                    if not ports[i, word] & bit:
                        ports[i, word] |= bit
                        if lo <= v <= hi:
                            dyn_used[i] += 1
    return UsageState(used_cpu=used_cpu, used_mem=used_mem,
                      used_disk=used_disk, placed_jobtg=placed,
                      placed_job=placed_job, dyn_used=dyn_used,
                      port_bitmap=ports)


def fold_usage_base(matrix: NodeMatrix, nodes, allocs_of,
                    with_ports: bool = True) -> dict:
    """The job-independent usage of one node list: what every alloc
    ``allocs_of(node_id)`` returns consumes, added with np.add.at, and
    with ``with_ports`` the port bitmap (the agent-reserved ports and
    every alloc's, deduplicated) and the dynamic ports in use; without,
    ``ports`` is None and ``dyn_used`` zero. The placement service
    memoizes the portless base per snapshot and overlays each eval's own
    plan deltas; job-scoped placed counts are rebuilt per eval."""
    n_pad = matrix.n_pad
    idx: List[int] = []
    cpu: List[float] = []
    mem: List[float] = []
    disk: List[float] = []
    port_pos: List[int] = []
    port_val: List[int] = []
    for i, node in enumerate(nodes):
        for alloc in allocs_of(node.id):
            cr = alloc.allocated_resources.comparable()
            idx.append(i)
            cpu.append(cr.cpu_shares)
            mem.append(cr.memory_mb)
            disk.append(cr.disk_mb)
            if not with_ports:
                continue
            for v in alloc.allocated_resources.all_ports():
                if 0 <= v < 65536:
                    port_pos.append(i)
                    port_val.append(v)
    used_cpu = np.zeros(n_pad, dtype=np.float64)
    used_mem = np.zeros(n_pad, dtype=np.float64)
    used_disk = np.zeros(n_pad, dtype=np.float64)
    if idx:
        ii = np.asarray(idx, dtype=np.int64)
        np.add.at(used_cpu, ii, np.asarray(cpu, dtype=np.float64))
        np.add.at(used_mem, ii, np.asarray(mem, dtype=np.float64))
        np.add.at(used_disk, ii, np.asarray(disk, dtype=np.float64))
    ports = (matrix.port_bitmap.copy()
             if with_ports and matrix.port_bitmap is not None else None)
    dyn_used = np.zeros(n_pad, dtype=np.int32)
    if port_pos:
        if ports is None:
            ports = np.zeros((n_pad, PORT_WORDS), dtype=np.uint32)
        pp = np.asarray(port_pos, dtype=np.int64)
        pv = np.asarray(port_val, dtype=np.int64)
        # a port counts once per node
        keys = np.unique(pp * 65536 + pv)
        pp, pv = keys >> 16, keys & 0xFFFF
        words = pv >> 5
        bits = np.uint32(1) << (pv & 31).astype(np.uint32)
        already = (ports[pp, words] & bits) != 0
        np.bitwise_or.at(ports, (pp, words), bits)
        lo = np.zeros(n_pad, dtype=np.int64)
        hi = np.full(n_pad, -1, dtype=np.int64)
        for i, node in enumerate(nodes):
            lo[i] = node.node_resources.min_dynamic_port
            hi[i] = node.node_resources.max_dynamic_port
        in_dyn = (~already) & (pv >= lo[pp]) & (pv <= hi[pp])
        np.add.at(dyn_used, pp[in_dyn], 1)
    return {"used_cpu": used_cpu, "used_mem": used_mem,
            "used_disk": used_disk, "ports": ports, "dyn_used": dyn_used}


def pack_feasibility(ctx, stack_like, tg, nodes, n_pad: int,
                     alloc_name: str = "", matrix=None) -> np.ndarray:
    """The feasibility mask: the job, driver, task-group, device and
    network checkers once per computed node class (broadcast through
    the matrix's class codes where no constraint reads a unique
    attribute), host volumes per node."""
    from ..scheduler.feasible import (
        ConstraintChecker, DeviceChecker, DriverChecker, HostVolumeChecker,
        NetworkChecker)
    from ..scheduler.stack import _tg_constraints

    job = ctx.plan.job
    drivers, constraints = _tg_constraints(tg)
    job_check = ConstraintChecker(ctx, job.constraints if job else [])
    drv_check = DriverChecker(ctx, drivers)
    tg_check = ConstraintChecker(ctx, constraints)
    dev_check = DeviceChecker(ctx)
    dev_check.set_task_group(tg)
    vol_check = HostVolumeChecker(ctx)
    vol_check.set_volumes(alloc_name, tg.volumes)
    net_check = NetworkChecker(ctx)
    if tg.networks:
        net_check.set_network(tg.networks[0])

    out = np.zeros(n_pad, dtype=bool)
    escaped = any("unique." in (c.l_target + c.r_target)
                  for c in (job.constraints if job else []) + constraints)

    def class_verdict(node):
        return (job_check.feasible(node) and drv_check.feasible(node)
                and tg_check.feasible(node)
                and dev_check.feasible(node)
                and net_check.feasible(node))

    codes = matrix.class_codes if matrix is not None else None
    if (not escaped and codes is not None
            and matrix.n_real == len(nodes)
            and matrix.class_reps is not None
            and (codes[:len(nodes)] >= 0).all()):
        verdicts = np.fromiter(
            (class_verdict(nodes[rep]) for rep in matrix.class_reps),
            dtype=bool, count=len(matrix.class_reps))
        n = len(nodes)
        out[:n] = verdicts[codes[:n]] if len(verdicts) else False
        if vol_check.volumes:
            for i, node in enumerate(nodes):
                if out[i]:
                    out[i] = vol_check.feasible(node)
        return out

    class_cache: Dict[str, bool] = {}
    check_vols = bool(vol_check.volumes)
    for i, node in enumerate(nodes):
        cls = node.computed_class
        if not escaped and cls in class_cache:
            class_ok = class_cache[cls]
        else:
            class_ok = class_verdict(node)
            if not escaped and cls:
                class_cache[cls] = class_ok
        out[i] = class_ok and (not check_vols or vol_check.feasible(node))
    return out


def pack_spreads(spreads, nodes, n_pad: int, tg_count: int,
                 existing_value_counts: Optional[List[Dict[str, int]]] = None
                 ) -> Optional[SpreadInfo]:
    """The spread tables; None when the task group has no spreads."""
    from ..scheduler.util import resolve_target
    if not spreads:
        return None
    S = len(spreads)
    tables: List[List[str]] = []
    per_node_vals: List[List[str]] = []
    for s in spreads:
        vals = []
        node_vals = []
        for node in nodes:
            v, ok = resolve_target(s.attribute, node)
            node_vals.append(str(v) if ok else None)
            if ok and str(v) not in vals:
                vals.append(str(v))
        # values only existing allocs reference still need slots
        if existing_value_counts:
            idx = len(tables)
            if idx < len(existing_value_counts):
                for v in existing_value_counts[idx]:
                    if v not in vals:
                        vals.append(v)
        tables.append(vals)
        per_node_vals.append(node_vals)
    V = max(1, max(len(t) for t in tables))
    value_index = np.full((S, n_pad), -1, dtype=np.int32)
    desired = np.full((S, V), -1.0, dtype=np.float64)
    has_targets = np.zeros(S, dtype=bool)
    weights = np.zeros(S, dtype=np.float64)
    init_counts = np.zeros((S, V), dtype=np.int32)
    for si, s in enumerate(spreads):
        table = {v: j for j, v in enumerate(tables[si])}
        for ni, v in enumerate(per_node_vals[si]):
            if v is not None:
                value_index[si, ni] = table[v]
        weights[si] = float(s.weight)
        if s.spread_target:
            has_targets[si] = True
            implicit = None
            for t in s.spread_target:
                if t.value == "*":
                    implicit = (t.percent / 100.0) * tg_count
                    continue
                if t.value in table:
                    desired[si, table[t.value]] = \
                        (t.percent / 100.0) * tg_count
            if implicit is not None:
                for v, j in table.items():
                    if desired[si, j] < 0:
                        desired[si, j] = implicit
        if existing_value_counts and si < len(existing_value_counts):
            for v, c in existing_value_counts[si].items():
                if v in table:
                    init_counts[si, table[v]] = c
    return SpreadInfo(n_spreads=S, value_index=value_index, n_values=V,
                      desired=desired, has_targets=has_targets,
                      weights=weights, sum_weights=float(weights.sum()),
                      initial_counts=init_counts, values=tables)


def pack_affinities(affinities, ctx, nodes, n_pad: int
                    ) -> Optional[np.ndarray]:
    """Per-node normalized affinity score (static within an eval;
    upstream: rank.go:756 NodeAffinityIterator)."""
    from ..scheduler.feasible import check_constraint
    from ..scheduler.util import resolve_target
    if not affinities:
        return None
    sum_weight = sum(abs(float(a.weight)) for a in affinities)
    out = np.zeros(n_pad, dtype=np.float64)
    for i, node in enumerate(nodes):
        total = 0.0
        for aff in affinities:
            lval, l_ok = resolve_target(aff.l_target, node)
            rval, r_ok = resolve_target(aff.r_target, node)
            if check_constraint(ctx, aff.operand, lval, rval, l_ok, r_ok):
                total += float(aff.weight)
        out[i] = total / sum_weight if sum_weight else 0.0
    return out
