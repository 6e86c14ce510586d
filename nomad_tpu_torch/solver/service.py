"""The placement service: structs in, placements out (port of
nomad_tpu/solver/service.py).

``TpuPlacementService`` takes an eval's job, task group, places, node
list and state snapshot as the port's structs (structs/), packs the lane
exactly as the reference does (``pack``: the eval's node shuffle, the
shuffled NodeConst / NodeState tables with the distinct_property,
device, reserved-core and preemption tables a lane needs, and a uniform
PlacementBatch), has it solved (``solve``: the solo dispatch;
solver/batch.py make_solve_hook: the SolveBarrier) and maps the result
back to ``TpuPlacement``s (``materialize``: node, task resources,
reserved cores, device instance ids, ports, preempted allocs).
``solve_system`` is the system-job entry point.

``pack_lane_arrays`` builds a lane from node-axis arrays instead, as
``_pack_inner`` does once its struct walks are done; ``placements`` and
``evictions`` map solved shuffled positions back to node indexes and a
preemption lane's candidate columns; ``dispatch_lane`` solves one lane
in its own dispatch; ``solve_system_arrays`` is the array form of
solve_system.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import jitcheck, native, statecheck
from ..device import DeviceLike, default_dtype_name, resolve_device
from ..scheduler.util import shuffled_order
from ..structs import (
    AllocMetric, AllocatedResources, AllocatedSharedResources,
    AllocatedTaskResources, NetworkIndex, CONSTRAINT_DISTINCT_HOSTS,
    CONSTRAINT_DISTINCT_PROPERTY)
from ..state.alloc_table import pack_delta_enabled
from ..tensor.pack import (
    DeviceInfo, DistinctPropertyInfo, PreemptInfo, UsageState,
    begin_pack_window, end_pack_window, fold_usage_base,
    freeze_usage_base, pack_affinities, pack_affinities_cached,
    pack_cache_enabled, pack_feasibility, pack_feasibility_cached,
    pack_nodes_cached, pack_spreads, pack_spreads_cached, pack_usage,
    usage_lock, _freeze, _stat_incr)
from .binpack import (
    MAX_SKIP, WAVE_DEVICE_CAP_STEPS, PlacementBatch, PreemptState,
    PreemptTables, make_node_const, make_node_state, wavefront_buffer_size)
from ..server.quality import observatory
from ..server.telemetry import metrics
from ..server.tracing import tracer
from . import xferobs
from .system import packed_views, solve_system_packed


class PackedLane:
    """One (eval, task-group) batch marshalled for the solver: the unit
    fuse_and_solve fuses across evals. Holds the numpy tables (shuffled
    node order), a preemption lane's candidate tables (``ptab``) and
    carried state (``pinit``), and what placements() needs to map
    results back. ``matrix`` is the NodeMatrix the lane was packed from:
    its identity is the node universe the LP tier groups lanes by.
    ``plan_priority`` and ``plan_has_stops`` are the two facts of the
    eval's plan the cross-lane fixpoint reads: its priority, and whether
    it already stops or preempts allocs. ``table_version`` (the packing
    snapshot's node-table index) and ``delta_src`` (the state store
    holding the alloc-delta journal and the snapshot's index) are what
    the resident buffer set reads (solver/resident.py). A lane packed
    from structs (TpuPlacementService.pack) also holds what materialize
    and the LP tier's repair read: its ``service``, task group ``tg``,
    ``places``, ``nodes`` (original order) and, for a preemption lane,
    ``cand_allocs`` (per shuffled position, the candidate Allocations in
    column order); lanes built from arrays leave them None."""

    __slots__ = ("order", "const", "init", "batch", "dtype_name",
                 "spread_alg", "node_ids", "ptab", "pinit", "matrix",
                 "plan_priority", "plan_has_stops", "table_version",
                 "delta_src", "service", "tg", "places", "nodes",
                 "cand_allocs", "_wave")

    def __init__(self, order, const, init, batch, dtype_name: str,
                 spread_alg: bool, node_ids: Optional[Sequence[str]] = None,
                 ptab: Optional[PreemptTables] = None,
                 pinit: Optional[PreemptState] = None, matrix=None,
                 plan_priority: int = 50, plan_has_stops: bool = False,
                 table_version: Optional[int] = None, delta_src=None,
                 service=None, tg=None, places=None, nodes=None,
                 cand_allocs=None):
        if (ptab is None) != (pinit is None):
            raise ValueError("a preemption lane needs both ptab and pinit")
        self.order = order
        self.const = const
        self.init = init
        self.batch = batch
        self.dtype_name = dtype_name
        self.spread_alg = spread_alg
        self.node_ids = node_ids
        self.ptab = ptab
        self.pinit = pinit
        self.matrix = matrix
        self.plan_priority = int(plan_priority)
        self.plan_has_stops = bool(plan_has_stops)
        self.table_version = table_version
        self.delta_src = delta_src
        self.service = service
        self.tg = tg
        self.places = places
        self.nodes = nodes
        self.cand_allocs = cand_allocs
        self._wave = None

    def wavefront_ok(self) -> bool:
        """Can this lane take the wavefront path? Uniform asks over an
        active prefix, a window that fits a slot buffer, no
        distinct_property and no reserved cores; devices only as a pure
        capacity (_wave_devices_ok). Spreads, affinities and reschedule
        penalties are modelled. A preemption lane takes the windowed
        preemption kernel on top of that only with no spreads, no valid
        candidate under a max_parallel limit, and room in the buffer for
        the window beside the deferred zombie."""
        if self._wave is None:
            self._wave = self._wavefront_check()
        return self._wave

    def _wavefront_check(self) -> bool:
        c = self.const
        if self.ptab is not None:
            # the slot kernel carries no spread columns
            if c.spread_vidx.shape[0]:
                return False
            # max_parallel penalties tie the greedy's pick order to the
            # evolving group counts, so a node's option status would not
            # stay static outside the window: such lanes stay dense
            if bool(np.any(np.asarray(self.ptab.maxp)[
                    np.asarray(self.ptab.valid)] > 0)):
                return False
            # the deferred zombie holds one slot for a step: the window
            # must fit beside it
            lim = int(np.asarray(self.batch.limit)[0])
            width = wavefront_buffer_size(lim)
            if width is None or lim + MAX_SKIP + 1 > width:
                return False
        if c.dp_vidx.shape[0] or c.mhz_per_core.shape[0]:
            return False
        if c.dev_aff.shape[0] and not self._wave_devices_ok():
            return False
        b = self.batch
        act = np.asarray(b.active)
        n_act = int(act.sum())
        if n_act == 0 or not act[:n_act].all():     # active must be prefix
            return False
        for arr in (b.ask_cpu, b.ask_mem, b.ask_disk, b.n_dyn_ports,
                    b.has_static, b.limit, b.count):
            v = np.asarray(arr)[:n_act]
            if not (v == v[0]).all():
                return False
        return wavefront_buffer_size(
            int(np.asarray(b.limit)[0])) is not None

    def _wave_devices_ok(self) -> bool:
        """A uniform device ask rides the wavefront as a pure capacity
        dimension (binpack._wave_device_capacity) when the dense device
        score vanishes (zero affinity weight) and the capacity replay is
        bounded. A preemption lane whose evictable candidates hold
        matching devices never gets here (the reference packs none)."""
        c = self.const
        if float(np.asarray(c.dev_sum_weight)) != 0.0:
            return False
        cnt = np.asarray(c.dev_count)
        if cnt.size == 0 or (cnt <= 0).any():
            return False
        free = np.asarray(self.init.dev_free)
        if free.size == 0:
            return False
        per_node = np.clip(free, 0, None).sum(axis=(0, 1))
        return (int(per_node.max(initial=0)) // int(cnt.min())
                < WAVE_DEVICE_CAP_STEPS)

    def wavefront_B(self) -> Optional[int]:
        """Slot-buffer width (lanes of different widths never fuse)."""
        if not self.wavefront_ok():
            return None
        return wavefront_buffer_size(int(np.asarray(self.batch.limit)[0]))

    def fuse_key(self) -> tuple:
        """Lanes with equal keys fuse into one dispatch: every static table
        shape except the placement axis (which pads), plus dtype, scoring
        mode and slot width."""
        return (self.const.cpu_cap.shape[0],          # n_pad
                self.batch.ask_cores.shape[0] > 0,    # core-ask lanes
                self.const.spread_vidx.shape[0],      # S
                self.const.spread_desired.shape[1],   # V
                self.const.dp_vidx.shape[0],          # Dp
                self.init.dp_counts.shape[1] if
                self.const.dp_vidx.shape[0] else 0,   # Vd
                self.const.dev_aff.shape[:2],         # (R, Gd)
                self.ptab.cpu.shape[1] if self.ptab is not None else 0,
                self.pinit.counts.shape[0] if self.pinit is not None
                else 0,                               # A, G
                self.dtype_name, self.spread_alg,
                self.wavefront_B())


def _limit(n: int, count: int, has_affinities: bool, has_spreads: bool,
           batch_mode: bool = False, sticky: Optional[int] = None) -> int:
    """The scan-window limit (upstream: stack.go:82-95 log2 limit,
    :176-185 spread / affinity override). ``sticky`` is an override an
    earlier task group of the eval set (the host LimitIterator never
    restores it); batch mode keeps the fixed limit of 2."""
    if has_affinities or has_spreads:
        return count if count >= 100 else 100
    if sticky is not None:
        return sticky
    limit = 2
    if not batch_mode and n > 1:
        log_limit = int(math.ceil(math.log2(n)))
        if log_limit > limit:
            limit = log_limit
    return limit


def pack_lane_arrays(matrix, usage, feasible: np.ndarray, *,
                     ask: Tuple[float, float, float], count: int,
                     n_places: int, eval_id: str, state_index: int,
                     affinity: Optional[np.ndarray] = None,
                     spread_info=None,
                     penalty_node_ids: Optional[
                         Sequence[Optional[str]]] = None,
                     distinct_hosts: bool = False,
                     distinct_job_level: bool = False,
                     distinct_property=None, devices=None,
                     ask_cores: int = 0,
                     mhz_per_core: Optional[np.ndarray] = None,
                     cores_free: Optional[np.ndarray] = None,
                     static_ports_free: Optional[np.ndarray] = None,
                     n_dyn_ports: int = 0,
                     preemption=None,
                     spread_alg: bool = False,
                     plan_priority: int = 50,
                     plan_has_stops: bool = False,
                     table_version: Optional[int] = None,
                     delta_src=None,
                     limit: Optional[int] = None,
                     order: Optional[List[int]] = None,
                     dtype_name: Optional[str] = None,
                     device: DeviceLike = None) -> PackedLane:
    """Build one service-eval lane from node-axis arrays (original node
    order, padded to matrix.n_pad): the shuffle for (eval_id,
    state_index), the shuffled const/init tables and a uniform batch of
    ``n_places`` placements asking ``ask`` = (cpu MHz, memory MB, disk
    MB). ``penalty_node_ids`` names, per placement, a node to penalize
    (the reschedule penalty) or None. Dense-lane options, each in
    original node order: ``distinct_property`` (DistinctPropertyInfo),
    ``devices`` (DeviceInfo), ``ask_cores`` reserved cores per placement
    with ``mhz_per_core`` and ``cores_free`` per node (``ask[0]`` is then
    the cpu of the tasks that reserve no cores), ``static_ports_free``
    (per node: are the task group's static ports free; None = no static
    ports asked) and ``n_dyn_ports`` dynamic ports asked.
    ``preemption`` (PreemptInfo, candidates in original node order) makes
    a preemption lane: its tables are shuffled with the nodes. Preemption
    lanes ask for no ports and no reserved cores (the reference routes
    those to its host iterator). ``plan_priority`` (the eval's plan
    priority, the job's) and ``plan_has_stops`` (the plan already stops
    or preempts allocs) are what the cross-lane fixpoint reads;
    ``table_version`` and ``delta_src`` (a (store, index) pair) what the
    resident buffer set reads. ``limit`` is the scan-window limit
    (default: _limit's, for the eval's first task group outside batch
    mode); ``order`` the eval's shuffle where the caller has it already.
    ``dtype_name`` defaults by ``device``: float64 on the CPU,
    float32 on the card."""
    dtype_name = default_dtype_name(device, dtype_name)
    dtype = np.dtype(dtype_name).type
    n = matrix.n_real
    n_pad = matrix.n_pad
    if order is None:
        order = shuffled_order(eval_id, state_index, n)
    perm = np.concatenate([np.asarray(order, dtype=np.int64),
                           np.arange(n, n_pad, dtype=np.int64)])
    if limit is None:
        limit = _limit(n, count, affinity is not None,
                       spread_info is not None)
    if ask_cores and (mhz_per_core is None or cores_free is None):
        raise ValueError("a reserved-core ask needs mhz_per_core and "
                         "cores_free")
    cores = bool(ask_cores)
    const = make_node_const(matrix, feasible, affinity, distinct_hosts,
                            spread_info, perm, dtype=dtype,
                            distinct_job_level=distinct_job_level,
                            distinct_property=distinct_property,
                            devices=devices,
                            mhz_per_core=mhz_per_core if cores else None)
    init = make_node_state(
        usage, matrix,
        (np.ones(n_pad, dtype=bool) if static_ports_free is None
         else np.asarray(static_ports_free, dtype=bool)), perm,
        spread_info.n_spreads if spread_info else 0,
        spread_info.n_values if spread_info else 1,
        spread_counts=(spread_info.initial_counts
                       if spread_info else None), dtype=dtype,
        distinct_property=distinct_property, devices=devices,
        cores_free=cores_free if cores else None)

    P = int(n_places)
    penalty = np.full(P, -1, dtype=np.int32)
    if penalty_node_ids:
        inv = np.empty(n_pad, dtype=np.int64)
        inv[perm] = np.arange(n_pad)
        id_to_pos = {nid: int(inv[i])
                     for i, nid in enumerate(matrix.node_ids)}
        for pi, nid in enumerate(penalty_node_ids):
            if nid is not None:
                pos = id_to_pos.get(nid)
                if pos is not None:
                    penalty[pi] = pos
    ask_cpu, ask_mem, ask_disk = ask
    batch = PlacementBatch(
        ask_cpu=np.full(P, float(ask_cpu), dtype=dtype),
        ask_mem=np.full(P, float(ask_mem), dtype=dtype),
        ask_disk=np.full(P, float(ask_disk), dtype=dtype),
        n_dyn_ports=np.full(P, n_dyn_ports, dtype=np.int32),
        has_static=np.full(P, static_ports_free is not None),
        limit=np.full(P, limit, dtype=np.int32),
        count=np.full(P, count, dtype=np.int32),
        penalty_idx=penalty,
        active=np.ones(P, dtype=bool),
        ask_cores=(np.full(P, ask_cores, dtype=np.int32) if cores
                   else np.zeros(0, dtype=np.int32)))
    ptab = pinit = None
    if preemption is not None:
        if n_dyn_ports or static_ports_free is not None or cores:
            raise ValueError("a preemption lane asks for no ports and no "
                             "reserved cores")
        ptab, pinit = _preempt_tables(preemption, perm, dtype)
    return PackedLane(order, const, init, batch, dtype_name, spread_alg,
                      node_ids=matrix.node_ids, ptab=ptab, pinit=pinit,
                      matrix=matrix, plan_priority=plan_priority,
                      plan_has_stops=plan_has_stops,
                      table_version=table_version, delta_src=delta_src)


def _preempt_tables(info, perm, dtype):
    """PreemptTables / PreemptState in shuffled node order from a
    PreemptInfo in original node order (dynamic ports and static-port
    holds stay zero: preemption lanes ask for no ports)."""
    A = np.asarray(info.cpu).shape[1]
    shape = (perm.shape[0], A)

    def rows(a, dt):
        a = np.asarray(a)
        if a.shape != shape:
            raise ValueError(f"preemption table of shape {a.shape}, "
                             f"expected {shape}")
        return a[perm].astype(dt)

    ptab = PreemptTables(
        cpu=rows(info.cpu, dtype), mem=rows(info.mem, dtype),
        disk=rows(info.disk, dtype), prio=rows(info.prio, np.int32),
        maxp=rows(info.maxp, np.int32), grp=rows(info.grp, np.int32),
        dyn_ports=np.zeros(shape, dtype=np.int32),
        static_rel=np.zeros(shape, dtype=bool),
        valid=rows(info.valid, bool),
        job_prio=np.asarray(info.job_prio, dtype=np.int32))
    pinit = PreemptState(evicted=np.zeros(shape, dtype=bool),
                         counts=np.asarray(info.counts, dtype=np.int32))
    return ptab, pinit


def placements(lane: PackedLane, chosen) -> Tuple[np.ndarray,
                                                  List[Optional[str]]]:
    """Map solved shuffled positions to (original node index per
    placement, -1 where nothing was placed; node id or None)."""
    pos = np.asarray(chosen, dtype=np.int64)
    order = np.asarray(lane.order, dtype=np.int64)
    idx = np.full(pos.shape, -1, dtype=np.int64)
    placed = pos >= 0
    idx[placed] = order[pos[placed]]
    ids: List[Optional[str]] = [
        (lane.node_ids[i] if i >= 0 and lane.node_ids is not None else None)
        for i in idx.tolist()]
    return idx, ids


def evictions(lane: PackedLane, chosen, evict_rows
              ) -> List[Tuple[int, np.ndarray]]:
    """Map a preemption lane's results back: per placement, (original
    node index or -1, the candidate columns it evicts there). Columns
    index the chosen node's row of the PreemptInfo tables, which keep
    their column order through the shuffle."""
    idx, _ = placements(lane, chosen)
    rows = np.asarray(evict_rows, dtype=bool)
    return [(int(n), np.nonzero(rows[k])[0] if n >= 0
             else np.zeros(0, dtype=np.int64))
            for k, n in enumerate(idx.tolist())]


def failure_metric(lane: PackedLane, chosen, pi: int, base):
    """Why placement ``pi`` of a solved lane (one packed by
    TpuPlacementService.pack) found no node, counted from the lane's own
    tables as the host stack counts a select that finds none (upstream:
    feasible.go, rank.go BinPackIterator): every node of the lane
    evaluated, each explained once, in the host's order of checks, as
    it stands after the lane's placements before ``pi``:
      * refused by the feasibility mask: filtered. For the group's
        first placement the checkers that built the mask name the
        refusing constraint once per node class (per node where a
        constraint reads a unique attribute), as the host's class cache
        names it once; after it the cache holds each class's verdict,
        and the host names none but a unique attribute's;
      * holding the job (distinct_hosts) or a property value at its
        limit (distinct_property): filtered under that constraint;
      * else exhausted on its first short dimension: the static ports
        (named by the group's first reserved port), the dynamic ports,
        a device request, reserved cores, cpu, memory, disk.
    Returns a copy of ``base`` (the eval's metric) with those counts in
    place of its filter and exhaustion counts."""
    from ..tensor.pack import feasibility_checkers

    const, init, batch = lane.const, lane.init, lane.batch
    nodes, order, tg = lane.nodes, lane.order, lane.tg
    n = len(nodes)
    m = base.copy()
    m.nodes_evaluated = n
    m.nodes_filtered = m.nodes_exhausted = 0
    m.class_filtered, m.constraint_filtered = {}, {}
    m.class_exhausted, m.dimension_exhausted = {}, {}

    taken = np.asarray(chosen[:pi], dtype=np.int64)
    taken = taken[(taken >= 0) & (taken < n)]
    hits = np.bincount(taken, minlength=n)[:n]
    left = np.ones(n, dtype=bool)          # nodes not yet explained

    # the feasibility mask, its reasons from the checkers that built it
    refused = left & ~np.asarray(const.feasible[:n], dtype=bool)
    if refused.any():
        ctx = lane.service.ctx
        verdict, vol_check, escaped = feasibility_checkers(
            ctx, tg, lane.places[pi].name)
        # where the host names no constraint, a class is checked
        # against a metric nobody reads
        first = m if pi == 0 or escaped else AllocMetric()
        saved = ctx.metrics
        try:
            class_ok: Dict[str, bool] = {}
            for pos in np.nonzero(refused)[0]:
                node = nodes[order[pos]]
                key = node.id if escaped else node.computed_class
                before = m.nodes_filtered
                if key not in class_ok:
                    ctx.metrics = first
                    class_ok[key] = verdict(node)
                if class_ok[key] and vol_check is not None:
                    ctx.metrics = m         # checked per node, as the host
                    vol_check.feasible(node)
                if m.nodes_filtered == before:
                    m.filter_node(node.computed_class, "")
        finally:
            ctx.metrics = saved
        left &= ~refused

    def filtered(mask, constraint):
        for pos in np.nonzero(left & mask)[0]:
            m.filter_node(nodes[order[pos]].computed_class, constraint)
        left[mask] = False

    if bool(const.distinct_hosts):
        placed = (init.placed_job if bool(const.distinct_job_level)
                  else init.placed)[:n] + hits
        filtered(placed > 0, CONSTRAINT_DISTINCT_HOSTS)
    if const.dp_vidx.size:
        vidx = np.asarray(const.dp_vidx)[:, :n]
        counts = np.array(init.dp_counts, dtype=np.int64)
        for d in range(vidx.shape[0]):
            v = vidx[d, taken]
            np.add.at(counts[d], v[v >= 0], 1)
        full = np.zeros(n, dtype=bool)
        for d in range(vidx.shape[0]):
            v = vidx[d]
            full |= (v < 0) | (counts[d, np.maximum(v, 0)]
                               >= int(const.dp_limit[d]))
        filtered(full, CONSTRAINT_DISTINCT_PROPERTY)

    def exhausted(mask, dim):
        for pos in np.nonzero(left & mask)[0]:
            node = nodes[order[pos]]
            m.exhausted_node(node.id, node.computed_class, dim)
        left[mask] = False

    if bool(batch.has_static[pi]):
        port = tg.networks[0].reserved_ports[0]
        exhausted(~np.asarray(init.static_free[:n], dtype=bool) | (hits > 0),
                  f"network: reserved port collision "
                  f"{port.label}={port.value}")
    n_dyn = int(batch.n_dyn_ports[pi])
    if n_dyn:
        exhausted(init.dyn_avail[:n] - hits * n_dyn < n_dyn,
                  "network: dynamic port selection failed")
    if init.dev_free.size:
        # the earlier placements' instances, taken as the kernel takes
        # them: per request, the first group of highest affinity with room
        free = np.array(init.dev_free[:, :, :n], dtype=np.int64)
        need = np.asarray(const.dev_count, dtype=np.int64)
        aff = np.asarray(const.dev_aff, dtype=np.float64)[:, :, :n]
        for q in taken:
            for r in range(free.shape[0]):
                room = free[r, :, q] >= need[r]
                if room.any():
                    g = int(np.argmax(np.where(room, aff[r, :, q], -np.inf)))
                    free[r, g, q] -= need[r]
        exhausted(~(free >= need[:, None, None]).any(axis=1).all(axis=0),
                  "devices: no devices match request")
    ask_cpu = np.full(n, float(batch.ask_cpu[pi]))
    if batch.ask_cores.size and int(batch.ask_cores[pi]):
        cores = int(batch.ask_cores[pi])
        exhausted(init.cores_free[:n] - hits * cores < cores, "cores")
        ask_cpu = ask_cpu + np.asarray(const.mhz_per_core[:n]) * cores
    for dim, cap, used, ask in (
            ("cpu", const.cpu_cap, init.used_cpu, ask_cpu),
            ("memory", const.mem_cap, init.used_mem,
             float(batch.ask_mem[pi])),
            ("disk", const.disk_cap, init.used_disk,
             float(batch.ask_disk[pi]))):
        use = np.asarray(used[:n], dtype=np.float64) + (hits + 1) * ask
        exhausted(use > np.asarray(cap[:n], dtype=np.float64), dim)
    return m


def dispatch_lane(lane: PackedLane, device: DeviceLike = None):
    """Solve ONE lane in its own dispatch (reference service.py
    dispatch_lane): through wave.solve_lane_fused on ``device`` (default
    ``cuda``), routed by the lane's own wave gate, its tables through the
    resident buffer set. Returns host numpy (chosen int64, scores,
    n_yielded int64), each (P,), plus evict_rows (P, A) bool for a
    preemption lane. The batched path fuses many lanes through
    solver/batch.py instead."""
    from .wave import solve_lane_fused

    def one(tree):
        return type(tree)(*(np.asarray(a)[None] for a in tree))

    wave = lane.wavefront_ok()
    if lane.ptab is not None:
        metrics.incr("nomad.solver.wavefront_preempt_dispatches" if wave
                     else "nomad.solver.dense_dispatches")
    else:
        metrics.incr("nomad.solver.wavefront_dispatches" if wave
                     else "nomad.solver.dense_dispatches")
    pre = () if lane.ptab is None else (one(lane.ptab), one(lane.pinit))
    out = solve_lane_fused(
        one(lane.const), one(lane.init), one(lane.batch), *pre,
        spread_alg=lane.spread_alg, dtype_name=lane.dtype_name,
        wave=wave, device=device,
        cache_version=lane.table_version, delta_src=lane.delta_src)
    return tuple(np.asarray(o)[0] for o in out)


def solve_system_arrays(matrix, usage, feasible: np.ndarray, *,
                        ask: Tuple[float, float, float], eval_id: str,
                        state_index: int, ask_cores: int = 0,
                        mhz_per_core: Optional[np.ndarray] = None,
                        cores_free: Optional[np.ndarray] = None,
                        static_ports_free: Optional[np.ndarray] = None,
                        n_dyn_ports: int = 0, spread_alg: bool = False,
                        dtype_name: Optional[str] = None,
                        device: DeviceLike = None
                        ) -> Tuple[PackedLane, np.ndarray, np.ndarray]:
    """One system eval over every node (reference:
    TpuPlacementService.solve_system, service.py:375-417): pack one lane
    from node-axis arrays as pack_lane_arrays does, fit and score every
    node through solve_system_packed on ``device`` (default ``cuda``),
    and map the result back to node order. Returns (lane, chosen,
    scores) over the real nodes in original order: chosen[k] is node k's
    shuffled position where it fits, else -1 (``placements(lane,
    chosen)`` maps it back to k and its id), scores[k] its binpack
    score."""
    dev = resolve_device(device)
    lane = pack_lane_arrays(
        matrix, usage, feasible, ask=ask, count=1, n_places=1,
        eval_id=eval_id, state_index=state_index, ask_cores=ask_cores,
        mhz_per_core=mhz_per_core, cores_free=cores_free,
        static_ports_free=static_ports_free, n_dyn_ports=n_dyn_ports,
        spread_alg=spread_alg, dtype_name=dtype_name, device=dev)
    chosen, scores = _system_fit(lane, matrix.n_real, dev)
    return lane, chosen, scores


def _system_fit(lane: PackedLane, n: int, device) -> Tuple[np.ndarray,
                                                           np.ndarray]:
    """Fit and score every node of a system lane through the system fit
    kernel: one upload, one launch, fit and score back in one copy.
    Returns (chosen, scores) over the n real nodes in original order:
    chosen[k] is node k's shuffled position where it fits, else -1."""
    batch1 = type(lane.batch)(*(np.asarray(a)[:1] for a in lane.batch))
    out, N, dt = solve_system_packed(lane.const, lane.init, batch1,
                                     spread_alg=lane.spread_alg,
                                     dtype_name=lane.dtype_name,
                                     device=device)
    # the system dispatch's one read-back (the reference reads its
    # system fit back once too)
    with jitcheck.sanctioned_fetch("system"):
        host = out.cpu()
        fit, score = (t[0].numpy() for t in packed_views(host, 1, N, dt))
    xferobs.note_fetch(xferobs.tree_nbytes(host), "system")
    inv = np.empty(n, dtype=np.int64)
    inv[np.asarray(lane.order, dtype=np.int64)] = np.arange(n)
    chosen = np.where(fit[inv], inv, -1).astype(np.int64)
    return chosen, score[inv].astype(np.float64)


# ---------------------------------------------------------------------------
# the struct half

class TpuPlacement:
    """One solved placement returned to the scheduler."""

    __slots__ = ("place", "node", "task_resources", "alloc_resources",
                 "score", "n_yielded", "preempted_allocs",
                 "resources_prebuilt", "failure")

    def __init__(self, place, node, task_resources, alloc_resources, score,
                 n_yielded, preempted_allocs=None,
                 resources_prebuilt=None):
        self.place = place
        self.node = node
        self.task_resources = task_resources
        self.alloc_resources = alloc_resources
        self.score = score
        self.n_yielded = n_yielded
        self.preempted_allocs = preempted_allocs
        # uniform simple lanes share ONE AllocatedResources across all
        # their placements (committed allocs are replaced, never mutated)
        self.resources_prebuilt = resources_prebuilt
        # a failed placement of a solved service or batch lane: (lane,
        # chosen, its index)
        self.failure = None

    def explain(self, base):
        """A failed placement's metric: ``base`` with the lane's count
        of why no node took it (failure_metric)."""
        lane, chosen, pi = self.failure
        return failure_metric(lane, chosen, pi, base)


def tg_solver_eligible(tg, job=None, preempt: bool = False) -> bool:
    """Does the solver model everything this task group asks for? The
    carve-outs, left to the host iterator: per-task networks and more
    than one group network; preemption together with ports or reserved
    cores; a 0% spread target."""
    has_cores = False
    for task in tg.tasks:
        if task.resources.cores > 0:
            has_cores = True
        if task.resources.networks:
            return False
    if len(tg.networks) > 1:
        return False
    if preempt and (tg.networks or has_cores):
        return False
    spreads = list(tg.spreads) + (list(job.spreads) if job is not None
                                  else [])
    for s in spreads:
        if any(t.percent == 0 for t in s.spread_target):
            return False
    return True


def mesh_status() -> dict:
    """The mesh route at a glance (reference :250), for guard.state():
    the NOMAD_TPU_TORCH_MESH switch, the card count, the (evals, nodes)
    grid ``pick_mesh`` would give a dense 8-lane batch over 256 nodes on
    those cards, and the mesh dispatch counters of the dense and LP
    routes. The count is the guard's probe result: this never starts a
    CUDA init, so before the first dispatch it reads 0 and no grid."""
    from ..parallel.mesh import mesh_enabled, pick_mesh
    from . import guard

    counters = metrics.snapshot().get("counters", {})
    out = {
        "enabled": mesh_enabled(),
        "devices": guard.cards_seen(),
        "grid": None,
        "dispatches": counters.get("nomad.solver.mesh_dispatches", 0),
        "lpq_dispatches": counters.get("nomad.lpq.mesh_dispatches", 0),
    }
    if out["enabled"] and out["devices"] > 1:
        grid = pick_mesh(8, 256, [f"cuda:{i}"
                                  for i in range(out["devices"])])
        if grid is not None:
            out["grid"] = list(grid.shape)
    return out


def _pos_index(matrix) -> Dict[str, int]:
    """node id -> original position, memoized on the matrix."""
    pos_of = matrix.__dict__.get("_pos_index")
    if pos_of is None:
        pos_of = {nid: i for i, nid in enumerate(matrix.node_ids)}
        matrix._pos_index = pos_of
    return pos_of


class TpuPlacementService:
    """Solves all of one task group's placements for one eval in one
    dispatch. ``ctx`` is the eval's EvalContext (its ``state`` a
    StateSnapshot), ``job`` the eval's job; ``batch_mode`` is the
    batch scheduler's fixed scan limit, ``spread_alg`` the spread
    scoring, ``preempt`` packs candidate tables. ``dtype`` defaults by
    ``device`` (float64 on the CPU, float32 on the card, which is the
    default device); ``device`` is where solve and solve_system
    dispatch."""

    def __init__(self, ctx, job, batch_mode: bool, spread_alg: bool,
                 dtype: Optional[str] = None, preempt: bool = False,
                 device: DeviceLike = None):
        self.ctx = ctx
        self.job = job
        self.batch_mode = batch_mode
        self.spread_alg = spread_alg
        self.preempt = preempt
        self.device = device
        self.dtype = default_dtype_name(device, dtype)
        # the host stack's limit persists across the eval's task groups
        # (stack.go: the spread/affinity override is never restored)
        self._current_limit: Optional[int] = None
        # (host ms, cache hits, cache misses) of the last pack call
        self.last_pack: Tuple[float, int, int] = (0.0, 0, 0)

    def solve(self, tg, places, nodes, penalty_nodes_per_place=None
              ) -> Optional[List[TpuPlacement]]:
        """The solo dispatch: one TpuPlacement per place (node None
        where it failed), or None when the task group is not eligible or,
        on the CPU, the dispatch failed under the guard (the caller's
        host path then places it). On a card the DispatchFailed reaches
        the caller."""
        from . import guard

        with tracer.span("solver.pack", tg=tg.name, places=len(places)):
            lane = self.pack(tg, places, nodes, penalty_nodes_per_place)
        if lane is None:
            return None
        try:
            with tracer.span("solver.dispatch_solo", tg=tg.name):
                out = guard.run_dispatch(
                    lambda: dispatch_lane(lane, device=self.device),
                    label="solver.dispatch_solo", device=self.device)
        except guard.DispatchFailed:
            if not guard.host_fallback_allowed(self.device):
                raise
            guard.note_host_fallback()
            return None
        # the shadow audit's sampled capture (server/quality.py)
        observatory.maybe_capture_audit(lane, out[0], out[1])
        with tracer.span("solver.materialize", tg=tg.name):
            return self.materialize(lane, *out)

    def solve_system(self, tg, nodes) -> Optional[List[TpuPlacement]]:
        """A system job: one independent fit and score per node (no
        window, no distinct_hosts, binpack score only). One TpuPlacement
        per node (node None where infeasible), or None when ineligible
        or, on the CPU, the dispatch failed under the guard (on a card
        the DispatchFailed reaches the caller)."""
        from . import guard
        from ..scheduler.reconcile import AllocPlaceResult

        if not nodes:
            return []
        places = [AllocPlaceResult(name=f"{self.job.id}.{tg.name}[0]",
                                   task_group=tg) for _ in nodes]
        lane = self.pack(tg, places, nodes)
        if lane is None:
            return None
        n = len(nodes)
        try:
            chosen, scores = guard.run_dispatch(
                lambda: _system_fit(lane, n, self.device),
                label="solver.dispatch.system", device=self.device)
        except guard.DispatchFailed:
            if not guard.host_fallback_allowed(self.device):
                raise
            guard.note_host_fallback()
            return None
        return self.materialize(lane, chosen, scores,
                                np.ones(n, dtype=np.int64))

    def pack(self, tg, places, nodes, penalty_nodes_per_place=None
             ) -> Optional[PackedLane]:
        """One task group's placements as a PackedLane (host only, no
        dispatch), or None when the task group is not eligible. The host
        time and the pack-cache hits and misses land in ``last_pack``."""
        mark = begin_pack_window()
        t0 = time.perf_counter()
        lane = self._pack_inner(tg, places, nodes, penalty_nodes_per_place)
        dt_ms = (time.perf_counter() - t0) * 1e3
        hits, misses = end_pack_window(mark)
        self.last_pack = (dt_ms, hits, misses)
        metrics.sample_ms("nomad.solver.pack_ms", dt_ms)
        if hits:
            metrics.incr("nomad.solver.pack_cache_hit", hits)
        if misses:
            metrics.incr("nomad.solver.pack_cache_miss", misses)
        tracer.event("solver.pack_cache", tg=tg.name, ms=round(dt_ms, 3),
                     hits=hits, misses=misses, eligible=lane is not None)
        return lane

    def _pack_inner(self, tg, places, nodes, penalty_nodes_per_place=None
                    ) -> Optional[PackedLane]:
        if (not tg_solver_eligible(tg, self.job, preempt=self.preempt)
                or not places):
            return None
        state = self.ctx.state
        n = len(nodes)
        state_index = state.latest_index()
        key_fn = getattr(state, "nodes_pack_key", None)
        matrix = pack_nodes_cached(
            nodes, getattr(state, "node_table_index", None),
            key_hint=key_fn(nodes) if key_fn is not None else None)
        n_pad = matrix.n_pad

        # the permutation the host stack applies in set_nodes
        order = shuffled_order(self.ctx.plan.eval_id, state_index, n)

        # preemption candidate tables, reserved cores and devices need
        # every node's proposed allocs: walk them once
        ask_cores_total = sum(t.resources.cores for t in tg.tasks)
        requests = [r for t in tg.tasks for r in t.resources.devices]
        walk_usage = self.preempt or ask_cores_total > 0
        proposed_by_node = None
        if walk_usage or requests:
            proposed_by_node = {
                node.id: self.ctx.proposed_allocs(node.id) for node in nodes}
        # usage (reference :481-505): the store's alloc table when it can
        # fold every row and no walk is needed anyway; else the memoized
        # incremental base; else (NOMAD_TPU_TORCH_PACK_CACHE=0) the walk
        cached = pack_cache_enabled()
        table = getattr(state, "alloc_table", None)
        if (table is not None and not table.has_port_overflow
                and not walk_usage):
            usage = self._pack_usage_from_table(table, matrix, nodes, tg)
        elif cached:
            usage = self._pack_usage_incremental(matrix, nodes, tg)
        else:
            if proposed_by_node is None:
                proposed_by_node = {
                    node.id: self.ctx.proposed_allocs(node.id)
                    for node in nodes}
            usage = pack_usage(matrix, proposed_by_node, self.job.id,
                               tg.name, self.job.namespace, nodes)
        alloc_name = places[0].name
        feasible = (pack_feasibility_cached if cached else pack_feasibility)(
            self.ctx, None, tg, nodes, n_pad, alloc_name=alloc_name,
            matrix=matrix)

        affinities = (list(self.job.affinities) + list(tg.affinities)
                      + [a for t in tg.tasks for a in t.affinities])
        spreads = list(self.job.spreads) + list(tg.spreads)
        existing_counts = self._existing_spread_counts(spreads, tg)
        if cached:
            affinity = pack_affinities_cached(affinities, self.ctx, nodes,
                                              n_pad, matrix=matrix)
            spread_info = pack_spreads_cached(spreads, nodes, n_pad,
                                              tg.count, existing_counts,
                                              matrix=matrix)
        else:
            affinity = pack_affinities(affinities, self.ctx, nodes, n_pad)
            spread_info = pack_spreads(spreads, nodes, n_pad, tg.count,
                                       existing_counts)

        distinct_job_level = any(
            c.operand == CONSTRAINT_DISTINCT_HOSTS
            and str(c.r_target).lower() != "false"
            for c in self.job.constraints)
        distinct_hosts = distinct_job_level or any(
            c.operand == CONSTRAINT_DISTINCT_HOSTS
            and str(c.r_target).lower() != "false"
            for c in tg.constraints)

        # static port availability per node for this task group's ask
        static_ports = []
        n_dyn = 0
        if tg.networks:
            static_ports = [p.value for p in tg.networks[0].reserved_ports]
            n_dyn = len(tg.networks[0].dynamic_ports)
        static_free = None
        if static_ports:
            static_free = np.ones(n_pad, dtype=bool)
            if usage.port_bitmap is not None:
                # the native control plane's check (reference :547)
                static_free = native.static_ports_free(
                    usage.port_bitmap,
                    np.asarray(static_ports, dtype=np.int32))

        dtype = np.dtype(self.dtype).type
        ask = tg.total_resources()
        mhz = cores_free = None
        if ask_cores_total:
            # a core-asking task's cpu is mhz_per_core * cores on the
            # candidate node (rank.go:340-344): only the other tasks'
            # cpu is a fixed ask
            ask_cpu = float(sum(t.resources.cpu for t in tg.tasks
                                if t.resources.cores == 0))
            mhz, cores_free = self._pack_cores(nodes, n_pad, dtype,
                                               proposed_by_node)
        else:
            ask_cpu = float(ask.cpu)
        devices = (self._pack_devices(requests, nodes, n_pad,
                                      proposed_by_node, dtype)
                   if requests else None)
        preemption = cand_allocs = None
        if self.preempt:
            preemption, cand_allocs = self._pack_preemption(
                nodes, order, n_pad, dtype, proposed_by_node)
        delta_store = getattr(state, "_store", None)    # the journal
        plan = self.ctx.plan
        lane = pack_lane_arrays(
            matrix, usage, feasible,
            ask=(ask_cpu, float(ask.memory_mb), float(ask.disk_mb)),
            count=tg.count, n_places=len(places),
            eval_id=plan.eval_id, state_index=state_index, order=order,
            affinity=affinity, spread_info=spread_info,
            penalty_node_ids=(
                [next(iter(pen)) if pen else None
                 for pen in penalty_nodes_per_place]
                if penalty_nodes_per_place else None),
            distinct_hosts=distinct_hosts,
            distinct_job_level=distinct_job_level,
            distinct_property=self._pack_distinct_property(
                tg, nodes, order, n_pad),
            devices=devices, ask_cores=ask_cores_total,
            mhz_per_core=mhz, cores_free=cores_free,
            static_ports_free=static_free, n_dyn_ports=n_dyn,
            preemption=preemption, spread_alg=self.spread_alg,
            plan_priority=plan.priority,
            plan_has_stops=bool(plan.node_update or plan.node_preemptions),
            table_version=getattr(state, "node_table_index", None),
            delta_src=((delta_store, state_index)
                       if delta_store is not None else None),
            limit=self._limit(n, tg, bool(affinities), bool(spreads)),
            dtype_name=self.dtype)
        if (requests and cand_allocs is not None
                and self._cands_hold_matching_devices(
                    requests, cand_allocs, lane.ptab)):
            # evicting such a candidate frees matching instances: no
            # preemption kernel models device release
            return None
        lane.service = self
        lane.tg = tg
        lane.places = places
        lane.nodes = nodes
        lane.cand_allocs = cand_allocs
        return lane

    @staticmethod
    def _cands_hold_matching_devices(requests, cand_allocs, ptab) -> bool:
        """Does an evictable candidate (a valid row at least 10 priority
        levels below the job) hold a device instance the ask matches?"""
        names = [r.name for r in requests]
        valid = (np.asarray(ptab.valid)
                 & (int(np.asarray(ptab.job_prio))
                    - np.asarray(ptab.prio) >= 10))
        A = valid.shape[1]
        for pos, cands in enumerate(cand_allocs):
            for a_i, a in enumerate(cands[:A]):
                if not valid[pos, a_i]:
                    continue
                for tr in a.allocated_resources.tasks.values():
                    for d in tr.devices:
                        if any(d.matches_request(n) for n in names):
                            return True
        return False

    def _pack_cores(self, nodes, n_pad, dtype, proposed_by_node):
        """Per node (original order): MHz per reservable core and the
        reservable cores its proposed allocs leave free."""
        mhz = np.zeros(n_pad, dtype=dtype)
        cores_free = np.zeros(n_pad, dtype=np.int32)
        for i, node in enumerate(nodes):
            cpu_res = node.node_resources.cpu
            total_cores = cpu_res.total_core_count
            mhz[i] = cpu_res.cpu_shares // total_cores if total_cores else 0
            # as allocs_fit and select_reserved_cores: agent-reserved
            # cores are never free
            reservable = (set(cpu_res.reservable_cores)
                          - set(node.reserved_resources.cores))
            for alloc in proposed_by_node[node.id]:
                for tr in alloc.allocated_resources.tasks.values():
                    reservable.difference_update(tr.reserved_cores)
            cores_free[i] = len(reservable)
        return mhz, cores_free

    def _pack_distinct_property(self, tg, nodes, order, n_pad
                                ) -> Optional[DistinctPropertyInfo]:
        """distinct_property tables in original node order
        (feasible.go:661, propertyset.go): per constraint, each node's
        value index (-1: the attribute is missing, so the node is
        infeasible; values numbered in shuffled first-seen order, as the
        reference numbers them), the limit, its scope, and the job's
        alloc count per value (live allocs, plan placements added, plan
        stops removed)."""
        from ..scheduler.util import resolve_target

        csets = ([(c, False) for c in self.job.constraints
                  if c.operand == CONSTRAINT_DISTINCT_PROPERTY]
                 + [(c, True) for c in tg.constraints
                    if c.operand == CONSTRAINT_DISTINCT_PROPERTY])
        if not csets:
            return None
        Dp = len(csets)
        allocs = [a for a in self.ctx.state.allocs_by_job(
            self.job.namespace, self.job.id) if not a.terminal_status()]
        removed = set()
        for na in self.ctx.plan.node_update.values():
            removed.update(a.id for a in na)
        allocs = [a for a in allocs if a.id not in removed]
        for na in self.ctx.plan.node_allocation.values():
            allocs.extend(na)

        vidx = np.full((Dp, n_pad), -1, dtype=np.int32)
        limits = np.ones(Dp, dtype=np.int32)
        tg_scope = np.zeros(Dp, dtype=bool)
        value_maps = []
        for d, (c, is_tg) in enumerate(csets):
            tg_scope[d] = is_tg
            try:
                limits[d] = max(1, int(c.r_target)) if c.r_target else 1
            except ValueError:
                limits[d] = 1
            vmap: Dict[str, int] = {}
            for i in order:
                val, ok = resolve_target(c.l_target, nodes[i])
                if not ok:
                    continue
                key = str(val)
                if key not in vmap:
                    vmap[key] = len(vmap)
                vidx[d, i] = vmap[key]
            value_maps.append(vmap)

        Vd = max(2, int(2 ** np.ceil(np.log2(max(
            max((len(m) for m in value_maps), default=1), 1)))))
        counts = np.zeros((Dp, Vd), dtype=np.int32)
        node_cache: Dict[str, object] = {}
        for a in allocs:
            node = node_cache.get(a.node_id)
            if node is None:
                node = self.ctx.state.node_by_id(a.node_id)
                node_cache[a.node_id] = node
            if node is None:
                continue
            for d, (c, is_tg) in enumerate(csets):
                if is_tg and a.task_group != tg.name:
                    continue
                val, ok = resolve_target(c.l_target, node)
                if ok:
                    gi = value_maps[d].get(str(val))
                    if gi is not None:
                        counts[d, gi] += 1
        return DistinctPropertyInfo(value_index=vidx, limit=limits,
                                    tg_scope=tg_scope, counts=counts)

    def _pack_devices(self, requests, nodes, n_pad, proposed_by_node,
                      dtype) -> DeviceInfo:
        """Device tables in original node order (feasible.go:1270,
        device.go): per request r and node device group g, the affinity
        score and the free instance count (-1: the group does not
        match)."""
        from ..scheduler.rank import DeviceAllocator

        R = len(requests)
        max_g = max([1] + [len(node.node_resources.devices)
                           for node in nodes])
        Gd = int(2 ** np.ceil(np.log2(max(max_g, 1))))

        aff = np.zeros((R, Gd, n_pad), dtype=dtype)
        free = np.full((R, Gd, n_pad), -1, dtype=np.int32)
        counts = np.asarray([r.count for r in requests], dtype=np.int32)
        sum_w = 0.0
        for r in requests:
            if r.affinities:
                sum_w += sum(abs(float(a.weight)) for a in r.affinities)

        for i, node in enumerate(nodes):
            groups = node.node_resources.devices
            if not groups:
                continue
            allocator = DeviceAllocator(self.ctx, node)
            allocator.add_allocs(proposed_by_node[node.id])
            for g_i, group in enumerate(groups):
                used = allocator.used.get(group.id_string(), set())
                n_free = sum(1 for x in group.instance_ids if x not in used)
                for r_i, req in enumerate(requests):
                    if not group.matches_request(req.name):
                        continue
                    if req.constraints and not self._dev_constraints_ok(
                            group, req.constraints):
                        continue
                    free[r_i, g_i, i] = n_free
                    aff[r_i, g_i, i] = self._dev_affinity_score(group, req)
        return DeviceInfo(affinity=aff, count=counts, sum_weight=sum_w,
                          free=free)

    def _dev_constraints_ok(self, group, constraints) -> bool:
        from ..scheduler.feasible import DeviceChecker
        return DeviceChecker._check_device_constraints(
            DeviceChecker(self.ctx), group, constraints)

    def _dev_affinity_score(self, group, req) -> float:
        from ..scheduler.feasible import DeviceChecker, check_constraint
        score = 0.0
        for a in req.affinities or ():
            lval, l_ok = DeviceChecker._resolve_device_target(
                a.l_target, group)
            rval, r_ok = DeviceChecker._resolve_device_target(
                a.r_target, group)
            if check_constraint(self.ctx, a.operand, lval, rval,
                                l_ok, r_ok):
                score += float(a.weight)
        return score

    def _pack_preemption(self, nodes, order, n_pad, dtype,
                         proposed_by_node):
        """The candidate tables in original node order (PreemptInfo;
        groups numbered in shuffled first-seen order, as the reference
        numbers them) and, per shuffled position, the candidate
        Allocations: every proposed alloc is a candidate column, in
        proposed_allocs order (dense argmin ties break as the host's
        in-order scan does); the placing job's own, terminal and
        job-less allocs are masked invalid (upstream: preemption.go
        setCandidates / filterAndGroup :666)."""
        per_node = []          # shuffled order: the candidate allocs
        max_a = 1
        for pos in range(n_pad):
            allocs = (proposed_by_node[nodes[order[pos]].id]
                      if pos < len(order) else [])
            per_node.append(allocs)
            max_a = max(max_a, len(allocs))
        A = int(2 ** np.ceil(np.log2(max(max_a, 8))))

        cpu = np.zeros((n_pad, A), dtype=dtype)
        mem = np.zeros((n_pad, A), dtype=dtype)
        disk = np.zeros((n_pad, A), dtype=dtype)
        prio = np.zeros((n_pad, A), dtype=np.int32)
        maxp = np.zeros((n_pad, A), dtype=np.int32)
        grp = np.full((n_pad, A), -1, dtype=np.int32)
        valid = np.zeros((n_pad, A), dtype=bool)
        group_idx: Dict[Tuple[str, str, str], int] = {}
        own = (self.job.namespace, self.job.id)
        for i, allocs in zip(order, per_node):
            for a_i, alloc in enumerate(allocs[:A]):
                cr = alloc.allocated_resources.comparable()
                cpu[i, a_i] = cr.cpu_shares
                mem[i, a_i] = cr.memory_mb
                disk[i, a_i] = cr.disk_mb
                prio[i, a_i] = (alloc.job.priority if alloc.job is not None
                                else 50)
                mp = 0
                if alloc.job is not None:
                    atg = alloc.job.lookup_task_group(alloc.task_group)
                    if atg is not None and atg.migrate is not None:
                        mp = atg.migrate.max_parallel
                maxp[i, a_i] = mp
                key = (alloc.namespace, alloc.job_id, alloc.task_group)
                if key not in group_idx:
                    group_idx[key] = len(group_idx)
                grp[i, a_i] = group_idx[key]
                valid[i, a_i] = (alloc.job is not None
                                 and (alloc.namespace, alloc.job_id) != own
                                 and not alloc.terminal_status())

        G = int(2 ** np.ceil(np.log2(max(len(group_idx), 4))))
        counts = np.zeros(G, dtype=np.int32)
        for na in self.ctx.plan.node_preemptions.values():
            for a in na:
                gi = group_idx.get((a.namespace, a.job_id, a.task_group))
                if gi is not None:
                    counts[gi] += 1
        info = PreemptInfo(cpu=cpu, mem=mem, disk=disk, prio=prio,
                           maxp=maxp, grp=grp, valid=valid,
                           job_prio=self.job.priority, counts=counts)
        return info, per_node

    def materialize(self, lane: PackedLane, chosen, scores, n_yielded,
                    evict_rows=None) -> List[TpuPlacement]:
        """Map solved shuffled positions back to nodes: task resources,
        reserved cores and device instances replayed with the host's
        deterministic selectors, ports assigned by replaying the node's
        NetworkIndex, eviction rows mapped back to the Allocations to
        preempt."""
        from ..scheduler.rank import DeviceAllocator, select_reserved_cores

        tg, places, nodes, order = (lane.tg, lane.places, lane.nodes,
                                    lane.order)
        out: List[TpuPlacement] = []
        net_indexes: Dict[str, NetworkIndex] = {}
        dev_allocators: Dict[str, object] = {}
        core_used: Dict[str, set] = {}
        has_devices = any(t.resources.devices for t in tg.tasks)
        # a uniform simple lane (no ports, cores or devices): every
        # placement gets the same resources, built once and shared
        shared_res = None
        if (not tg.networks and not has_devices
                and not any(t.resources.cores > 0 for t in tg.tasks)):
            shared_res = AllocatedResources(
                tasks={t.name: AllocatedTaskResources(
                    cpu_shares=t.resources.cpu,
                    memory_mb=t.resources.memory_mb)
                    for t in tg.tasks},
                shared=AllocatedSharedResources(
                    disk_mb=tg.ephemeral_disk.size_mb))
            shared_res.comparable()
        for pi, place in enumerate(places):
            pos = int(chosen[pi])
            if pos < 0:
                out.append(TpuPlacement(place, None, None, None, 0.0,
                                        int(n_yielded[pi])))
                continue
            node = nodes[order[pos]]
            preempted = None
            if evict_rows is not None and lane.cand_allocs is not None:
                row = np.asarray(evict_rows[pi])
                if row.any():
                    cands = lane.cand_allocs[pos]
                    preempted = [cands[ai] for ai in np.nonzero(row)[0]
                                 if ai < len(cands)]
            if shared_res is not None:
                out.append(TpuPlacement(
                    place, node, shared_res.tasks, shared_res.shared,
                    float(scores[pi]), int(n_yielded[pi]),
                    preempted_allocs=preempted,
                    resources_prebuilt=shared_res))
                continue
            task_resources = {}
            failed = False
            for task in tg.tasks:
                tr = AllocatedTaskResources(
                    cpu_shares=task.resources.cpu,
                    memory_mb=task.resources.memory_mb)
                if task.resources.cores > 0:
                    used = core_used.get(node.id)
                    if used is None:
                        used = set()
                        for al in self.ctx.proposed_allocs(node.id):
                            used.update(al.allocated_resources
                                        .comparable().reserved_cores)
                        core_used[node.id] = used
                    cores = select_reserved_cores(
                        node, used, task.resources.cores)
                    if cores is None:
                        failed = True       # the count-exact fit should
                        break               # prevent this
                    used.update(cores)
                    tr.reserved_cores = cores
                    cpu_res = node.node_resources.cpu
                    if cpu_res.total_core_count:
                        tr.cpu_shares = (
                            cpu_res.cpu_shares
                            // cpu_res.total_core_count) * len(cores)
                if has_devices and task.resources.devices:
                    allocator = dev_allocators.get(node.id)
                    if allocator is None:
                        allocator = DeviceAllocator(self.ctx, node)
                        allocator.add_allocs(
                            self.ctx.proposed_allocs(node.id))
                        dev_allocators[node.id] = allocator
                    for req in task.resources.devices:
                        offer, _sum_aff, _err = allocator.assign_device(req)
                        if offer is None:
                            failed = True
                            break
                        allocator.add_reserved(offer)
                        tr.devices.append(offer)
                    if failed:
                        break
                task_resources[task.name] = tr
            if failed:
                out.append(TpuPlacement(place, None, None, None, 0.0,
                                        int(n_yielded[pi])))
                continue
            alloc_resources = None
            if tg.networks:
                idx = net_indexes.get(node.id)
                if idx is None:
                    idx = NetworkIndex()
                    idx.set_node(node)
                    idx.add_allocs(self.ctx.proposed_allocs(node.id))
                    net_indexes[node.id] = idx
                offer, _err = idx.assign_ports([tg.networks[0]])
                if offer is None:
                    out.append(TpuPlacement(place, None, None, None, 0.0,
                                            int(n_yielded[pi])))
                    continue
                for pm in offer.ports:
                    idx.add_reserved_port(
                        pm.value, idx._network_for_ip(pm.host_ip))
                alloc_resources = AllocatedSharedResources(
                    disk_mb=tg.ephemeral_disk.size_mb, ports=offer.ports)
            out.append(TpuPlacement(place, node, task_resources,
                                    alloc_resources, float(scores[pi]),
                                    int(n_yielded[pi]),
                                    preempted_allocs=preempted))
        for pi, tp in enumerate(out):
            if tp.node is None:
                tp.failure = (lane, chosen, pi)
        return out

    @staticmethod
    def _node_slots(table, matrix, nodes, n_pad):
        """(reference :1034) The table slot of each node of this node
        order, -1 past them, memoized on the (version-keyed) matrix once
        every node has a slot: a node registered with the table later is
        looked up again."""
        cached = matrix.__dict__.get("_table_slots")
        if cached is not None and cached[0] is table:
            return cached[1]
        slots = np.full(n_pad, -1, dtype=np.int32)
        slots[:len(nodes)] = np.fromiter(
            map(table.node_slot_of, (n.id for n in nodes)),
            dtype=np.int32, count=len(nodes))
        if len(nodes) == 0 or slots[:len(nodes)].min() >= 0:
            matrix._table_slots = (table, slots)
        return slots

    def _pack_usage_from_table(self, table, matrix, nodes,
                               tg) -> UsageState:
        """(reference :1052) Usage as the fold of the store's alloc table
        (AllocTable.pack, count_placed) plus this eval's plan deltas: the
        fold of ctx.proposed_allocs per node without walking them. The
        table is the live store's, read under its lock: it may hold
        commits newer than the snapshot, which the plan applier
        verifies against. The lanes of one generation pack from one
        table version against one matrix: a portless fold is kept on the
        matrix by (table, version), its arrays frozen, and each lane
        copies what it overlays; a task group with ports folds its own
        (its port words are refolded rather than kept)."""
        n_pad = matrix.n_pad
        store = getattr(self.ctx.state, "_store", None)
        lock = store._lock if store is not None else usage_lock(matrix)
        with_ports = bool(tg.networks)
        with lock:
            cached = matrix.__dict__.get("_fold_cache")
            packed = None
            if not with_ports and cached is not None \
                    and cached[0] is table and cached[1] == table.version:
                packed = cached[2]
                if statecheck._ACTIVE:
                    # the served fold's version must be the table's
                    statecheck.note_memo_served(
                        "fold_cache", cached[1], table.version)
            if packed is None:
                slots = self._node_slots(table, matrix, nodes, n_pad)
                packed = table.pack(n_pad, slots, with_ports,
                                    port_words_seed=matrix.port_bitmap)
                if not with_ports:
                    for key in ("used_cpu", "used_mem", "used_disk",
                                "dyn_used", "row_slots"):
                        _freeze(packed[key])
                    matrix._fold_cache = (table, table.version, packed)
            placed, placed_job = table.count_placed(
                n_pad, packed["row_slots"], self.job.namespace, self.job.id,
                tg.name)
        if not with_ports:
            packed = dict(packed, **{
                key: packed[key].copy() for key in
                ("used_cpu", "used_mem", "used_disk", "dyn_used")})
        usage = UsageState(
            used_cpu=packed["used_cpu"], used_mem=packed["used_mem"],
            used_disk=packed["used_disk"], placed_jobtg=placed,
            placed_job=placed_job, dyn_used=packed["dyn_used"],
            port_bitmap=packed["port_words"])
        self._overlay_plan_deltas(usage, nodes, tg)
        return usage

    def _pack_usage_incremental(self, matrix, nodes, tg) -> UsageState:
        """(reference :1120) Usage as the fold of ctx.proposed_allocs per
        node, without the per-eval walk over every alloc: the snapshot's
        job-independent base fold, this job's placed counts, and this
        eval's plan deltas on top; the route when the alloc table cannot
        serve. A task group that asks for no ports packs no port state
        (no bitmap, no dynamic ports in use), as the table path packs
        it; its base is memoized on the matrix per (store, index) and
        caught up through the store's journal when the snapshot is
        newer (with NOMAD_TPU_TORCH_PACK_DELTA=0: memoized per snapshot
        and folded in full); the eval threads of a generation wait for
        one fold or catch-up instead of each doing its own. A task group
        with ports folds its base, port bitmap included, per eval."""
        snap = self.ctx.state
        with_ports = bool(tg.networks)

        def live(nid):
            return [a for a in snap.allocs_by_node(nid)
                    if not a.client_terminal_status()]

        if with_ports:
            base = fold_usage_base(matrix, nodes, live, with_ports=True)
            _stat_incr("usage_base_misses")
        elif not pack_delta_enabled():
            # NOMAD_TPU_TORCH_PACK_DELTA=0 (reference :1168-1195): one
            # base a snapshot, memoized on the snapshot, folded in full
            token = snap.latest_index()
            memo = snap.__dict__.setdefault("_usage_base_memo", {})
            with usage_lock(matrix):
                ent = memo.get(id(matrix))
                base = None
                if ent is not None and ent[0] is matrix and ent[1] == token:
                    base = ent[2]
                    _stat_incr("usage_base_hits")
                    if statecheck._ACTIVE:
                        statecheck.note_memo_served(
                            "usage_base", ent[1], token)
                if base is None:
                    base = fold_usage_base(matrix, nodes, live,
                                           with_ports=False)
                    _stat_incr("usage_base_misses")
                    freeze_usage_base(base)
                    memo[id(matrix)] = (matrix, token, base)
        else:
            token = snap.latest_index()
            store = getattr(snap, "_store", snap)
            with usage_lock(matrix):
                base = None
                ent = getattr(matrix, "_usage_base", None)
                if ent is not None and ent[0] is store:
                    if ent[1] == token:
                        base = ent[2]
                        _stat_incr("usage_base_hits")
                        if statecheck._ACTIVE:
                            # a hit must serve exactly the snapshot's
                            # index
                            statecheck.note_memo_served(
                                "usage_base", ent[1], token)
                    elif ent[1] < token:
                        base = self._catch_up_usage_base(matrix, store,
                                                         ent, token)
                if base is None:
                    base = fold_usage_base(matrix, nodes, live,
                                           with_ports=False)
                    _stat_incr("usage_base_misses")
                    freeze_usage_base(base)
                    matrix._usage_base = (store, token, base)

        n_pad = matrix.n_pad
        placed = np.zeros(n_pad, dtype=np.int32)
        placed_job = np.zeros(n_pad, dtype=np.int32)
        pos_of = _pos_index(matrix)
        for a in snap.allocs_by_job(self.job.namespace, self.job.id):
            if a.client_terminal_status():
                continue
            i = pos_of.get(a.node_id)
            if i is None:
                continue
            placed_job[i] += 1
            if a.task_group == tg.name:
                placed[i] += 1
        usage = UsageState(
            used_cpu=base["used_cpu"].copy(),
            used_mem=base["used_mem"].copy(),
            used_disk=base["used_disk"].copy(),
            placed_jobtg=placed, placed_job=placed_job,
            dyn_used=base["dyn_used"].copy(),
            port_bitmap=(base["ports"].copy()
                         if base["ports"] is not None else None))
        self._overlay_plan_deltas(usage, nodes, tg)
        return usage

    def _catch_up_usage_base(self, matrix, store, ent, token):
        """Advance a stale portless usage base to ``token`` by the (old,
        new) alloc pairs the store journaled between the base's index
        and the snapshot's. Returns the caught-up base (memoized on the
        matrix), or None when the journal does not cover the span."""
        deltas_fn = getattr(store, "alloc_deltas_since", None)
        if deltas_fn is None:
            return None
        covered, pairs = deltas_fn(ent[1], upto=token)
        if not covered:
            return None
        pos_of = _pos_index(matrix)
        old_base = ent[2]
        uc = old_base["used_cpu"].copy()
        um = old_base["used_mem"].copy()
        ud = old_base["used_disk"].copy()
        for old, new in pairs:
            for a, sign in ((old, -1), (new, +1)):
                if a is None or a.client_terminal_status():
                    continue
                i = pos_of.get(a.node_id)
                if i is None:
                    continue
                cr = a.allocated_resources.comparable()
                uc[i] += sign * cr.cpu_shares
                um[i] += sign * cr.memory_mb
                ud[i] += sign * cr.disk_mb
        base = {"used_cpu": uc, "used_mem": um, "used_disk": ud,
                "ports": None, "dyn_used": old_base["dyn_used"]}
        freeze_usage_base(base)
        matrix._usage_base = (store, token, base)
        _stat_incr("usage_base_delta_hits")
        if statecheck._ACTIVE:
            # the caught-up base serves the snapshot's index
            statecheck.note_memo_served("usage_base_delta", token,
                                        getattr(self.ctx.state,
                                                "latest_index",
                                                lambda: token)())
        return base

    def _overlay_plan_deltas(self, usage, nodes, tg) -> None:
        """Apply this eval's plan to the packed usage: stops and
        preemptions release what the stored alloc holds, placements
        (in-place updates replace their stored row) consume
        (upstream: context.go:176 ProposedAllocs). A plan entry whose
        alloc is not stored is skipped: it was never folded in."""
        pos_of = {node.id: i for i, node in enumerate(nodes)}
        plan = self.ctx.plan
        ns, jid, tgn = self.job.namespace, self.job.id, tg.name

        def adjust(a, sign: int) -> None:
            pos = pos_of.get(a.node_id)
            if pos is None:
                return
            if sign < 0 and a.client_terminal_status():
                return              # never counted in the base
            cr = a.allocated_resources.comparable()
            usage.used_cpu[pos] += sign * cr.cpu_shares
            usage.used_mem[pos] += sign * cr.memory_mb
            usage.used_disk[pos] += sign * cr.disk_mb
            if a.namespace == ns and a.job_id == jid:
                usage.placed_job[pos] += sign
                if a.task_group == tgn:
                    usage.placed_jobtg[pos] += sign
            ports = a.allocated_resources.all_ports()
            if not ports:
                return
            node = nodes[pos]
            lo = node.node_resources.min_dynamic_port
            hi = node.node_resources.max_dynamic_port
            bitmap = usage.ensure_bitmap(len(usage.used_cpu))
            for p in ports:
                if not 0 <= p < 65536:
                    continue
                word, bit = p >> 5, np.uint32(1 << (p & 31))
                if sign > 0:
                    if not bitmap[pos, word] & bit:
                        bitmap[pos, word] |= bit
                        if lo <= p <= hi:
                            usage.dyn_used[pos] += 1
                elif bitmap[pos, word] & bit:
                    bitmap[pos, word] &= ~bit
                    if lo <= p <= hi:
                        usage.dyn_used[pos] -= 1

        state = self.ctx.state
        seen_ids = set()
        for allocs in plan.node_update.values():
            for a in allocs:
                stored = state.alloc_by_id(a.id)
                if stored is not None:
                    adjust(stored, -1)
                seen_ids.add(a.id)
        for allocs in plan.node_preemptions.values():
            for a in allocs:
                if a.id not in seen_ids:
                    stored = state.alloc_by_id(a.id)
                    if stored is not None:
                        adjust(stored, -1)
                    seen_ids.add(a.id)
        for allocs in plan.node_allocation.values():
            for a in allocs:
                stored = state.alloc_by_id(a.id)
                if stored is not None and a.id not in seen_ids:
                    adjust(stored, -1)
                adjust(a, +1)

    def _limit(self, n: int, tg, has_affinities: bool,
               has_spreads: bool) -> int:
        """The module _limit for this task group; a spread / affinity
        override sticks for the rest of the eval's task groups."""
        limit = _limit(n, tg.count, has_affinities, has_spreads,
                       batch_mode=self.batch_mode,
                       sticky=self._current_limit)
        if has_affinities or has_spreads:
            self._current_limit = limit
        return limit

    def _existing_spread_counts(self, spreads, tg):
        """Per spread: the task group's live allocs per attribute value,
        plan stops removed (upstream: propertyset.go UsedCount)."""
        from ..scheduler.util import resolve_target
        if not spreads:
            return None
        stopped = set()
        for na in self.ctx.plan.node_update.values():
            stopped.update(a.id for a in na)
        allocs = [a for a in self.ctx.state.allocs_by_job(
            self.job.namespace, self.job.id)
            if a.id not in stopped and not a.terminal_status()
            and a.task_group == tg.name]
        out = []
        for s in spreads:
            counts: Dict[str, int] = {}
            for a in allocs:
                node = self.ctx.state.node_by_id(a.node_id)
                if node is None:
                    continue
                v, ok = resolve_target(s.attribute, node)
                if ok:
                    counts[str(v)] = counts.get(str(v), 0) + 1
            out.append(counts)
        return out
