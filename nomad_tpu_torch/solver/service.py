"""Lane packing and result mapping (port of the array half of
nomad_tpu/solver/service.py).

``pack_lane_arrays`` builds one lane exactly as the reference's
TpuPlacementService._pack_inner does once its struct walks are done: the
eval's node shuffle, the shuffled NodeConst / NodeState tables (with the
distinct_property, device, reserved-core and port tables a dense lane
needs, and a preemption lane's candidate tables) and the uniform
PlacementBatch. ``placements`` maps solved shuffled positions back to
node indexes and ids, ``evictions`` a preemption lane's eviction rows
back to each chosen node's candidates. ``dispatch_lane`` solves one
lane in its own dispatch; ``solve_system_arrays`` is the system-job
entry point (TpuPlacementService.solve_system). Port
assignment through NetworkIndex and the TpuPlacement structs come with
the structs slice.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike, default_dtype_name, resolve_device
from ..scheduler.util import shuffled_order
from .binpack import (
    MAX_SKIP, WAVE_DEVICE_CAP_STEPS, PlacementBatch, PreemptState,
    PreemptTables, make_node_const, make_node_state, wavefront_buffer_size)
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
    the resident buffer set reads (solver/resident.py)."""

    __slots__ = ("order", "const", "init", "batch", "dtype_name",
                 "spread_alg", "node_ids", "ptab", "pinit", "matrix",
                 "plan_priority", "plan_has_stops", "table_version",
                 "delta_src", "_wave")

    def __init__(self, order, const, init, batch, dtype_name: str,
                 spread_alg: bool, node_ids: Optional[Sequence[str]] = None,
                 ptab: Optional[PreemptTables] = None,
                 pinit: Optional[PreemptState] = None, matrix=None,
                 plan_priority: int = 50, plan_has_stops: bool = False,
                 table_version: Optional[int] = None, delta_src=None):
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


def _limit(n: int, count: int, has_affinities: bool,
           has_spreads: bool) -> int:
    """Scan-window limit of a service eval (reference: stack.go:82-95 log2
    limit, :176-185 spread/affinity override). Batch mode's fixed limit
    of 2 and the override's stickiness across an eval's task groups come
    with the structs slice, together with the callers that need them."""
    if has_affinities or has_spreads:
        return count if count >= 100 else 100
    limit = 2
    if n > 1:
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
    resident buffer set reads. ``dtype_name`` defaults by ``device``: float64 on the CPU, float32 on
    the card."""
    dtype_name = default_dtype_name(device, dtype_name)
    dtype = np.dtype(dtype_name).type
    n = matrix.n_real
    n_pad = matrix.n_pad
    order = shuffled_order(eval_id, state_index, n)
    perm = np.concatenate([np.asarray(order, dtype=np.int64),
                           np.arange(n, n_pad, dtype=np.int64)])
    limit = _limit(n, count, affinity is not None, spread_info is not None)
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

    pre = () if lane.ptab is None else (one(lane.ptab), one(lane.pinit))
    out = solve_lane_fused(
        one(lane.const), one(lane.init), one(lane.batch), *pre,
        spread_alg=lane.spread_alg, dtype_name=lane.dtype_name,
        wave=lane.wavefront_ok(), device=device,
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
    # one upload, one launch, and fit and score back in one copy
    out, N, dt = solve_system_packed(lane.const, lane.init, lane.batch,
                                     spread_alg=spread_alg,
                                     dtype_name=lane.dtype_name, device=dev)
    fit, score = (t[0].numpy() for t in packed_views(out.cpu(), 1, N, dt))
    n = matrix.n_real
    inv = np.empty(n, dtype=np.int64)
    inv[np.asarray(lane.order, dtype=np.int64)] = np.arange(n)
    chosen = np.where(fit[inv], inv, -1).astype(np.int64)
    return lane, chosen, score[inv].astype(np.float64)
