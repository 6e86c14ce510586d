"""Solver lane tables and the wavefront host precompute (port of the numpy
half of nomad_tpu/solver/binpack.py).

A lane is one (eval, task group) batch of placements. Its node-axis tables
are in SHUFFLED ORDER (scheduler/util.py shuffled_order); callers map
chosen positions back to nodes. The wavefront path turns a uniform-ask
lane into a compact (P+B, 8+S) table on the host; the device kernels in
solver/wave.py scan only that table.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

MAX_SKIP = 3               # select.go maxSkip
SKIP_THRESHOLD = 0.0       # select.go skipScoreThreshold
BINPACK_MAX = 18.0

# slot-buffer widths: log2 windows, and the limit >= 100 spread/affinity
# windows (stack.go:176-185 forces limit = max(count, 100) there)
WAVE_B = 32
WAVE_B_WIDE = 128
# placement-axis padding floor: many lane sizes share one kernel shape
WAVE_P_BUCKETS_MIN = 32
# run-block width: most picks one run decision commits (one warp on the card)
WAVE_K = 32

_EMPTY_I2 = np.zeros((0, 0), dtype=np.int32)
_EMPTY_I1 = np.zeros(0, dtype=np.int32)
_EMPTY_B1 = np.zeros(0, dtype=bool)
_EMPTY_F1 = np.zeros(0, dtype=np.float32)
_EMPTY_F3 = np.zeros((0, 0, 0), dtype=np.float32)
_EMPTY_I3 = np.zeros((0, 0, 0), dtype=np.int32)


class PlacementBatch(NamedTuple):
    """Per-placement inputs, each shaped (P,)."""

    ask_cpu: np.ndarray
    ask_mem: np.ndarray
    ask_disk: np.ndarray
    n_dyn_ports: np.ndarray     # int32 dynamic ports asked
    has_static: np.ndarray      # bool: TG asks static ports
    limit: np.ndarray           # int32 scan-window limit for this placement
    count: np.ndarray           # int32 TG desired count (anti-affinity denom)
    penalty_idx: np.ndarray     # int32 node position to penalize, -1 = none
    active: np.ndarray          # bool: real placement vs padding
    ask_cores: np.ndarray = _EMPTY_I1   # reserved-core ask; 0-size = none


class NodeState(NamedTuple):
    """Mutable usage along the node axis, shaped (N,)."""

    used_cpu: np.ndarray
    used_mem: np.ndarray
    used_disk: np.ndarray
    placed: np.ndarray          # int32: this job+TG alloc count per node
    placed_job: np.ndarray      # int32: this job's alloc count (any TG)
    static_free: np.ndarray     # bool: TG's static ports still free
    dyn_avail: np.ndarray       # int32: free dynamic-range ports
    spread_counts: np.ndarray   # (S, V) int32
    dp_counts: np.ndarray = _EMPTY_I2
    dev_free: np.ndarray = _EMPTY_I3
    cores_free: np.ndarray = _EMPTY_I1


class NodeConst(NamedTuple):
    """Static per-eval node arrays, shaped (N,), plus spread tables. The
    trailing distinct_property / device / core tables are 0-size unless
    the task group asks for them; a lane that carries any of them takes
    the dense path (solver/dense.py)."""

    cpu_cap: np.ndarray
    mem_cap: np.ndarray
    disk_cap: np.ndarray
    feasible: np.ndarray        # bool: constraint/driver feasibility
    affinity: np.ndarray        # float: normalized affinity score per node
    has_affinity: np.ndarray    # bool scalar
    distinct_hosts: np.ndarray  # bool scalar
    distinct_job_level: np.ndarray  # bool scalar: job-level constraint
    spread_vidx: np.ndarray     # (S, N) int32 value index per node, -1 missing
    spread_desired: np.ndarray  # (S, V) float; -1 = no target for value
    spread_has_targets: np.ndarray  # (S,) bool
    spread_weights: np.ndarray      # (S,) float
    spread_sum_weights: np.ndarray  # float scalar
    n_spreads: np.ndarray       # int32 scalar
    dp_vidx: np.ndarray = _EMPTY_I2
    dp_limit: np.ndarray = _EMPTY_I1
    dp_tg_scope: np.ndarray = _EMPTY_B1
    dev_aff: np.ndarray = _EMPTY_F3
    dev_count: np.ndarray = _EMPTY_I1
    dev_sum_weight: np.ndarray = np.float32(0.0)
    mhz_per_core: np.ndarray = _EMPTY_F1


class WaveSpread(NamedTuple):
    """Spread tables the compact wave kernel carries: per-spread value
    counts (the only coupling spreads add between placements) plus the
    static scoring tables."""

    counts: np.ndarray        # (S, V) int32
    desired: np.ndarray       # (S, V)
    has_targets: np.ndarray   # (S,) bool
    weights: np.ndarray       # (S,)
    sum_weights: np.ndarray   # ()


def make_node_const(matrix, feasible: np.ndarray, affinity,
                    distinct_hosts: bool, spread_info, order: np.ndarray,
                    dtype=np.float32,
                    distinct_job_level: bool = False,
                    distinct_property=None, devices=None,
                    mhz_per_core: Optional[np.ndarray] = None) -> NodeConst:
    """Assemble NodeConst in shuffled order (order[i] = original index of
    the node at shuffled position i). ``distinct_property``
    (DistinctPropertyInfo), ``devices`` (DeviceInfo) and ``mhz_per_core``
    ((n_pad,) MHz per reservable core) are node-axis tables in original
    node order; each is left 0-size when None."""
    n_pad = matrix.n_pad
    perm = np.asarray(order, dtype=np.int64)
    cpu = matrix.cpu_cap[perm].astype(dtype)
    mem = matrix.mem_cap[perm].astype(dtype)
    disk = matrix.disk_cap[perm].astype(dtype)
    feas = (feasible & matrix.valid)[perm]
    aff = (affinity[perm].astype(dtype) if affinity is not None
           else np.zeros(n_pad, dtype=dtype))
    if spread_info is not None:
        vidx = spread_info.value_index[:, perm]
        desired = spread_info.desired.astype(dtype)
        has_t = spread_info.has_targets
        weights = spread_info.weights.astype(dtype)
        sum_w = np.asarray(spread_info.sum_weights, dtype=dtype)
        n_s = spread_info.n_spreads
    else:
        vidx = np.zeros((0, n_pad), dtype=np.int32)
        desired = np.zeros((0, 1), dtype=dtype)
        has_t = np.zeros(0, dtype=bool)
        weights = np.zeros(0, dtype=dtype)
        sum_w = np.asarray(0.0, dtype=dtype)
        n_s = 0
    dense = {}
    if distinct_property is not None:
        dense.update(
            dp_vidx=np.asarray(distinct_property.value_index,
                               dtype=np.int32)[:, perm],
            dp_limit=np.asarray(distinct_property.limit, dtype=np.int32),
            dp_tg_scope=np.asarray(distinct_property.tg_scope, dtype=bool))
    if devices is not None:
        dense.update(
            dev_aff=np.asarray(devices.affinity)[:, :, perm].astype(dtype),
            dev_count=np.asarray(devices.count, dtype=np.int32),
            dev_sum_weight=np.asarray(devices.sum_weight, dtype=dtype))
    if mhz_per_core is not None:
        dense["mhz_per_core"] = np.asarray(mhz_per_core)[perm].astype(dtype)
    return NodeConst(
        cpu_cap=cpu, mem_cap=mem,
        disk_cap=disk, feasible=np.asarray(feas),
        affinity=aff,
        has_affinity=np.asarray(affinity is not None),
        distinct_hosts=np.asarray(bool(distinct_hosts)),
        distinct_job_level=np.asarray(bool(distinct_job_level)),
        spread_vidx=np.asarray(vidx), spread_desired=np.asarray(desired),
        spread_has_targets=np.asarray(has_t),
        spread_weights=np.asarray(weights),
        spread_sum_weights=np.asarray(sum_w),
        n_spreads=np.asarray(n_s, dtype=np.int32), **dense)


def make_node_state(usage, matrix, static_ports_free: np.ndarray,
                    order: np.ndarray, n_spreads: int, n_values: int,
                    spread_counts=None, dtype=np.float32,
                    distinct_property=None, devices=None,
                    cores_free: Optional[np.ndarray] = None) -> NodeState:
    """Assemble NodeState in shuffled order; the dense tables as in
    make_node_const (``cores_free``: (n_pad,) free reservable cores)."""
    perm = np.asarray(order, dtype=np.int64)
    counts = (spread_counts if spread_counts is not None
              else np.zeros((n_spreads, max(n_values, 1)), dtype=np.int32))
    dense = {}
    if distinct_property is not None:
        dense["dp_counts"] = np.asarray(distinct_property.counts,
                                        dtype=np.int32)
    if devices is not None:
        dense["dev_free"] = np.asarray(devices.free,
                                       dtype=np.int32)[:, :, perm]
    if cores_free is not None:
        dense["cores_free"] = np.asarray(cores_free, dtype=np.int32)[perm]
    return NodeState(
        used_cpu=usage.used_cpu[perm].astype(dtype),
        used_mem=usage.used_mem[perm].astype(dtype),
        used_disk=usage.used_disk[perm].astype(dtype),
        placed=np.asarray(usage.placed_jobtg[perm], dtype=np.int32),
        placed_job=np.asarray(usage.placed_job[perm], dtype=np.int32),
        static_free=np.asarray(static_ports_free[perm]),
        dyn_avail=(matrix.dyn_free - usage.dyn_used)[perm].astype(np.int32),
        spread_counts=np.asarray(counts), **dense)


def wavefront_buffer_size(limit: int) -> Optional[int]:
    """Slot-buffer width for a lane's scan window: small for log2 windows,
    wide for the limit >= 100 spread/affinity windows; None when the
    window outgrows both (dense-kernel territory)."""
    if limit + MAX_SKIP <= WAVE_B:
        return WAVE_B
    if limit + MAX_SKIP <= WAVE_B_WIDE:
        return WAVE_B_WIDE
    return None


def _wave_p_bucket(p: int) -> int:
    b = WAVE_P_BUCKETS_MIN
    while b < p:
        b *= 2
    return b


def wavefront_compact_host(const, init, batch, dtype_name: str,
                           p_pad: Optional[int] = None, B: int = WAVE_B):
    """Numpy precompute for ONE uniform-ask lane: returns (compact
    (C, 8+S), scal_f (3,), scal_i (2,), pen (P,), WaveSpread). Columns: c
    (closed-form capacity in placements), used_cpu, used_mem, cpu_cap,
    mem_cap, placed, affinity, pos (sentinel -1), then one spread
    value-index column per spread. Rows are the fit nodes in shuffled
    order; rows past the fit list have c = 0 and can never fit. ``p_pad``
    grows the placement axis (C = p_pad + B); padded steps are inert."""
    dt = np.dtype(dtype_name)
    P = int(np.asarray(batch.ask_cpu).shape[0])
    P_out = max(P, p_pad or 0)
    N = int(np.asarray(const.cpu_cap).shape[0])
    ask_cpu = np.asarray(batch.ask_cpu, dtype=dt)[0]
    ask_mem = np.asarray(batch.ask_mem, dtype=dt)[0]
    ask_disk = np.asarray(batch.ask_disk, dtype=dt)[0]
    n_dyn = int(np.asarray(batch.n_dyn_ports)[0])
    has_static = bool(np.asarray(batch.has_static)[0])
    count = np.asarray(batch.count, dtype=dt)[0]
    L = int(np.asarray(batch.limit)[0])
    n_active = int(np.asarray(batch.active).sum())

    BIG = np.int64(2 ** 30)
    cpu_cap = np.asarray(const.cpu_cap, dtype=dt)
    mem_cap = np.asarray(const.mem_cap, dtype=dt)
    disk_cap = np.asarray(const.disk_cap, dtype=dt)
    used_cpu = np.asarray(init.used_cpu, dtype=dt)
    used_mem = np.asarray(init.used_mem, dtype=dt)
    used_disk = np.asarray(init.used_disk, dtype=dt)

    def cap_dim(used0, cap, ask):
        # closed form of "max m with used0 + m*ask <= cap", then nudged by
        # the same float predicate the scan applies, so it is exact
        with np.errstate(divide="ignore", invalid="ignore",
                         over="ignore"):
            q = np.floor((cap - used0) / np.maximum(ask, dt.type(1e-9)))
        q = np.where(np.isfinite(q), q, 0).astype(np.int64)

        def fits(m):
            return used0 + m.astype(dt) * ask <= cap

        q = np.where(fits(q), q, q - 1)
        q = np.where(fits(q), q, q - 1)
        q = np.maximum(q, 0)
        q = np.where(fits(q + 1), q + 1, q)
        q = np.where(fits(q + 1), q + 1, q)
        q = np.where(fits(q), q, 0)
        return np.where(ask > 0, q, BIG)

    c = np.minimum(cap_dim(used_cpu, cpu_cap, ask_cpu),
                   cap_dim(used_mem, mem_cap, ask_mem))
    c = np.minimum(c, cap_dim(used_disk, disk_cap, ask_disk))
    if n_dyn > 0:
        c = np.minimum(c, np.asarray(init.dyn_avail, dtype=np.int64)
                       // n_dyn)
    if has_static:
        c = np.minimum(c, np.where(np.asarray(init.static_free), 1, 0))
    if bool(np.asarray(const.distinct_hosts)):
        distinct0 = (np.asarray(init.placed_job)
                     if bool(np.asarray(const.distinct_job_level))
                     else np.asarray(init.placed))
        c = np.minimum(c, np.where(distinct0 > 0, 0, 1))
    if np.asarray(const.dev_aff).shape[0]:
        # the wave gate (service.PackedLane) refuses device lanes in this
        # port; the device-capacity replay comes with ROADMAP Queue 1 item 5
        raise NotImplementedError(
            "device lanes are not ported to the wavefront path yet "
            "(ROADMAP Queue 1 item 5)")
    c = np.where(np.asarray(const.feasible), c, 0)
    c = np.clip(c, 0, P)

    aff = (np.asarray(const.affinity, dtype=dt)
           if bool(np.asarray(const.has_affinity))
           else np.zeros(N, dtype=dt))

    S = int(np.asarray(const.spread_vidx).shape[0])
    fit_pos = np.nonzero(c > 0)[0][:P_out + B]
    C = P_out + B
    compact = np.zeros((C, 8 + S), dtype=dt)
    compact[:, 7] = -1.0
    if S:
        compact[:, 8:] = -1.0           # missing spread attr sentinel
    k = fit_pos.shape[0]
    compact[:k, 0] = c[fit_pos]
    compact[:k, 1] = used_cpu[fit_pos]
    compact[:k, 2] = used_mem[fit_pos]
    compact[:k, 3] = cpu_cap[fit_pos]
    compact[:k, 4] = mem_cap[fit_pos]
    compact[:k, 5] = np.asarray(init.placed)[fit_pos].astype(dt)
    compact[:k, 6] = aff[fit_pos]
    compact[:k, 7] = fit_pos.astype(dt)
    if S:
        compact[:k, 8:] = np.asarray(
            const.spread_vidx)[:, fit_pos].T.astype(dt)
    scal_f = np.array([ask_cpu, ask_mem, count], dtype=dt)
    scal_i = np.array([L, n_active], dtype=np.int32)
    pen = np.full(P_out, -1, dtype=np.int32)
    pen[:P] = np.asarray(batch.penalty_idx, dtype=np.int32)
    sp = WaveSpread(
        counts=np.asarray(init.spread_counts, dtype=np.int32),
        desired=np.asarray(const.spread_desired, dtype=dt),
        has_targets=np.asarray(const.spread_has_targets, dtype=bool),
        weights=np.asarray(const.spread_weights, dtype=dt),
        sum_weights=np.asarray(const.spread_sum_weights, dtype=dt))
    return compact, scal_f, scal_i, pen, sp
