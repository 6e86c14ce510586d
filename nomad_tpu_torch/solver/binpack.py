"""Solver lane tables and the wavefront host precompute (port of the numpy
half of nomad_tpu/solver/binpack.py).

A lane is one (eval, task group) batch of placements. Its node-axis tables
are in SHUFFLED ORDER (scheduler/util.py shuffled_order); callers map
chosen positions back to nodes. The wavefront path turns a uniform-ask
lane into a compact (P+B, 8+S) table on the host; the device kernels in
solver/wave.py scan only that table. A preemption lane adds (N, A)
candidate-eviction tables (PreemptTables) and its carried state
(PreemptState); its windowed kernel scans a compact table of option
nodes that wavefront_preempt_compact_host builds the same way.
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


# A lane passes the wave gate only if the device capacity replay ends
# within this many steps (service.PackedLane._wave_devices_ok), so
# wavefront_compact_host can insist that the replay succeeded.
WAVE_DEVICE_CAP_STEPS = 1024


def _wave_device_capacity(const, init,
                          cap_steps: int = WAVE_DEVICE_CAP_STEPS
                          ) -> Optional[np.ndarray]:
    """Per-node placement capacity in the device dimension of a uniform
    lane: a numpy replay of the dense scan's per-step commit (a node fits
    while every request has a group with free >= count; the eligible
    group with the first maximal affinity is drained). Returns None when
    the replay cannot bound it (a request with count <= 0 never drains,
    or capacity outlasts ``cap_steps``)."""
    R = int(np.asarray(const.dev_aff).shape[0])
    if R == 0:
        return None
    dev_cnt = np.asarray(const.dev_count, dtype=np.int64)
    if (dev_cnt <= 0).any():
        return None
    free = np.asarray(init.dev_free, dtype=np.int64).copy()  # (R, Gd, N)
    aff = np.asarray(const.dev_aff, dtype=np.float64)
    N = free.shape[2]
    c_dev = np.zeros(N, dtype=np.int64)
    alive = np.ones(N, dtype=bool)
    rr = np.arange(R)
    nn = np.arange(N)
    for _ in range(cap_steps):
        ok_g = free >= dev_cnt[:, None, None]            # (R, Gd, N)
        feas = ok_g.any(axis=1).all(axis=0) & alive      # (N,)
        if not feas.any():
            break
        # first maximal affinity among eligible groups (ties to the
        # lowest group index), as the dense commit picks
        g_star = np.where(ok_g, aff, -np.inf).argmax(axis=1)   # (R, N)
        dec = np.zeros_like(free)
        dec[rr[:, None], g_star, nn[None, :]] = dev_cnt[:, None]
        free -= np.where(feas[None, None, :], dec, 0)
        c_dev += feas
        alive = feas
    else:
        return None
    return c_dev


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
        c_dev = _wave_device_capacity(const, init)
        # the wave gate (service.PackedLane._wave_devices_ok) admits device
        # lanes only when the replay is bounded, so None is a gate bug
        if c_dev is None:
            raise ValueError("unbounded device capacity replay (the lane "
                             "should not have passed the wave gate)")
        # a uniform device ask folds into the closed-form capacity; the
        # score is unchanged (the gate asks for zero device affinity
        # weight, where the dense device score term is 0)
        c = np.minimum(c, c_dev)
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


# --------------------------------------------------------------------------
# Preemption (reference: scheduler/preemption.go PreemptForTaskGroup, and
# rank.go's eviction-enabled BinPackIterator).

class PreemptTables(NamedTuple):
    """Per-lane candidate-eviction tables, (N, A) in shuffled node order:
    every proposed alloc of a node is one candidate column, in
    proposed-alloc order (the greedy's first-min ties break in that
    order). Resources are whole MHz / MB, so every sum over candidates
    is exact in either float dtype."""

    cpu: np.ndarray          # (N, A) comparable usage per candidate
    mem: np.ndarray
    disk: np.ndarray
    prio: np.ndarray         # (N, A) int32 job priority
    maxp: np.ndarray         # (N, A) int32 migrate.max_parallel
    grp: np.ndarray          # (N, A) int32 (job, task group) index, -1 none
    dyn_ports: np.ndarray    # (N, A) int32 dynamic-range ports held
    static_rel: np.ndarray   # (N, A) bool: holds an asked static port
    valid: np.ndarray        # (N, A) bool: eligible candidate
    job_prio: np.ndarray     # () int32 the placing job's priority


class PreemptState(NamedTuple):
    """Carried preemption state: the candidates this eval already evicted
    and per-group eviction counts (the max_parallel penalty's input)."""

    evicted: np.ndarray      # (N, A) bool
    counts: np.ndarray       # (G,) int32


MAX_PARALLEL_PENALTY = 50.0  # preemption.go:16
PREEMPT_SCORE_RATE = 0.0048  # rank.go preemptionScore logistic
PREEMPT_SCORE_ORIGIN = 2048.0

# Columns of the windowed-preemption compact table (C, WPC_NCOLS).
WPC_FEAS = 0
WPC_UC, WPC_UM, WPC_UD = 1, 2, 3
WPC_CC, WPC_CM, WPC_CD = 4, 5, 6
WPC_PLACED, WPC_PLACED_JOB = 7, 8
WPC_AFF, WPC_POS = 9, 10
WPC_CDEV = 11               # device-dimension capacity (2^24 = unbounded,
WPC_NCOLS = 12              # exact in float32)
WPC_DEV_UNBOUNDED = float(2 ** 24)
# the candidate tables of one lane's refill order, (C, A) each, in this
# order (the wave_preempt kernel reads them so)
WPC_CAND = ("cpu", "mem", "disk", "prio", "maxp", "grp", "valid")


def _numpy_preempt_pristine(ccpu, cmem, cdisk, cprio, cmaxp, cgrp, cvalid,
                            counts, cpu_cap, mem_cap, disk_cap, job_prio,
                            ask_cpu, ask_mem, ask_disk):
    """The eviction search (greedy + filterSuperset) at pristine state (no
    prior evictions), vectorized over all N nodes in numpy. Returns (met
    (N,), freed (3, N)). All arithmetic runs in the candidate arrays'
    dtype: a float64 pass in front of a float32 kernel could flip
    near-tie argmins and admit nodes the in-step search cannot yield
    (zombies that starve the window) or drop real options."""
    dt = ccpu.dtype
    ask_cpu = dt.type(ask_cpu)
    ask_mem = dt.type(ask_mem)
    ask_disk = dt.type(ask_disk)
    N, A = ccpu.shape
    elig = cvalid & (job_prio - cprio >= 10)
    avail_c0 = (cpu_cap - np.sum(np.where(cvalid, ccpu, 0.0), axis=1,
                                 dtype=dt)).astype(dt)
    avail_m0 = (mem_cap - np.sum(np.where(cvalid, cmem, 0.0), axis=1,
                                 dtype=dt)).astype(dt)
    avail_d0 = (disk_cap - np.sum(np.where(cvalid, cdisk, 0.0), axis=1,
                                  dtype=dt)).astype(dt)
    n_pre = np.where(cgrp >= 0, counts[np.maximum(cgrp, 0)], 0)
    penalty = np.where((cmaxp > 0) & (n_pre >= cmaxp),
                       (n_pre + 1 - cmaxp) * dt.type(MAX_PARALLEL_PENALTY),
                       dt.type(0.0)).astype(dt)

    def dist(ne_c, ne_m, ne_d):
        eps = dt.type(1e-9)
        zero = dt.type(0.0)
        dc = np.where(ne_c > 0, (ne_c - ccpu) / np.maximum(ne_c, eps), zero)
        dm = np.where(ne_m > 0, (ne_m - cmem) / np.maximum(ne_m, eps), zero)
        dd = np.where(ne_d > 0, (ne_d - cdisk) / np.maximum(ne_d, eps),
                      zero)
        return np.sqrt(dc * dc + dm * dm + dd * dd).astype(dt)

    picked = np.zeros((N, A), dtype=bool)
    av_c, av_m, av_d = avail_c0.copy(), avail_m0.copy(), avail_d0.copy()
    ne_c = np.full(N, ask_cpu, dtype=dt)
    ne_m = np.full(N, ask_mem, dtype=dt)
    ne_d = np.full(N, ask_disk, dtype=dt)
    # the sentinel must fit cprio's dtype (an int64 max cast to int32
    # would wrap to -1 and win every min)
    big_i = np.iinfo(np.int32).max
    for _ in range(A):
        met = ((av_c >= ask_cpu) & (av_m >= ask_mem) & (av_d >= ask_disk)
               & picked.any(axis=1))
        cand = elig & ~picked
        if not np.any(~met & cand.any(axis=1)):
            break
        cur_prio = np.min(np.where(cand, cprio, big_i), axis=1)
        in_group = cand & (cprio == cur_prio[:, None])
        key = np.where(in_group,
                       dist(ne_c[:, None], ne_m[:, None], ne_d[:, None])
                       + penalty, np.inf)
        pick = np.argmin(key, axis=1)
        do = ~met & in_group.any(axis=1)
        onehot = (np.arange(A)[None, :] == pick[:, None]) & do[:, None]
        pc = np.sum(np.where(onehot, ccpu, 0.0), axis=1)
        pm = np.sum(np.where(onehot, cmem, 0.0), axis=1)
        pd = np.sum(np.where(onehot, cdisk, 0.0), axis=1)
        picked |= onehot
        av_c += pc
        av_m += pm
        av_d += pd
        ne_c -= pc
        ne_m -= pm
        ne_d -= pd
    met = ((av_c >= ask_cpu) & (av_m >= ask_mem) & (av_d >= ask_disk)
           & picked.any(axis=1))

    # filterSuperset: re-add the picks in descending distance to the ask
    # and keep the shortest prefix that covers it
    d0 = dist(np.full(N, ask_cpu)[:, None], np.full(N, ask_mem)[:, None],
              np.full(N, ask_disk)[:, None])
    sort_key = np.where(picked, -d0, np.inf)
    order = np.argsort(sort_key, axis=1, kind="stable")
    oc = np.take_along_axis(np.where(picked, ccpu, 0.0), order, axis=1)
    om = np.take_along_axis(np.where(picked, cmem, 0.0), order, axis=1)
    od = np.take_along_axis(np.where(picked, cdisk, 0.0), order, axis=1)
    cum_c = avail_c0[:, None] + np.cumsum(oc, axis=1)
    cum_m = avail_m0[:, None] + np.cumsum(om, axis=1)
    cum_d = avail_d0[:, None] + np.cumsum(od, axis=1)
    met_at = ((cum_c >= ask_cpu) & (cum_m >= ask_mem)
              & (cum_d >= ask_disk))
    first_met = np.argmax(met_at, axis=1)
    keep_sorted = (np.arange(A)[None, :] <= first_met[:, None])
    keep_sorted &= np.take_along_axis(picked, order, axis=1)
    evict = np.zeros_like(picked)
    np.put_along_axis(evict, order, keep_sorted, axis=1)
    freed = np.stack([np.sum(np.where(evict, t, 0.0), axis=1)
                      for t in (ccpu, cmem, cdisk)])
    return met, freed


def wavefront_preempt_compact_host(const, init, batch, ptab, pinit,
                                   dtype_name: str,
                                   p_pad: Optional[int] = None,
                                   B: int = WAVE_B):
    """Host precompute for ONE preemption lane of the windowed kernel: the
    pristine option predicate (plain fit, or fit once the search's
    evictions free enough) and the option nodes in shuffled order as a
    compact table with their candidate tables. Returns (compact (C,
    WPC_NCOLS), cand dict of (C, A) arrays (WPC_CAND), scal_f (4,) =
    ask cpu/mem/disk and count, scal_i (4,) = limit, n_active, job
    priority and the distinct_hosts flag (0 none, 1 task group, 2 job),
    pen (P_out,), counts0 (G,)). Rows past the option list are
    sentinels (pos -1) that never fit."""
    dt = np.dtype(dtype_name)
    P = int(np.asarray(batch.ask_cpu).shape[0])
    P_out = max(P, p_pad or 0)
    N = int(np.asarray(const.cpu_cap).shape[0])
    A = int(np.asarray(ptab.cpu).shape[1])
    ask_cpu = float(np.asarray(batch.ask_cpu, dtype=dt)[0])
    ask_mem = float(np.asarray(batch.ask_mem, dtype=dt)[0])
    ask_disk = float(np.asarray(batch.ask_disk, dtype=dt)[0])
    count = float(np.asarray(batch.count, dtype=dt)[0])
    L = int(np.asarray(batch.limit)[0])
    n_active = int(np.asarray(batch.active).sum())
    job_prio = int(np.asarray(ptab.job_prio))

    cpu_cap = np.asarray(const.cpu_cap, dtype=dt)
    mem_cap = np.asarray(const.mem_cap, dtype=dt)
    disk_cap = np.asarray(const.disk_cap, dtype=dt)
    used_c = np.asarray(init.used_cpu, dtype=dt)
    used_m = np.asarray(init.used_mem, dtype=dt)
    used_d = np.asarray(init.used_disk, dtype=dt)
    feas = np.asarray(const.feasible, dtype=bool)
    placed0 = np.asarray(init.placed)
    placed_job0 = np.asarray(init.placed_job)
    distinct = bool(np.asarray(const.distinct_hosts))
    job_level = bool(np.asarray(const.distinct_job_level))
    distinct_flag = (2 if distinct and job_level
                     else (1 if distinct else 0))

    dcount0 = placed_job0 if job_level else placed0
    feas_nonres0 = feas if not distinct else (feas & (dcount0 == 0))
    # a node with no eligible device group is no option, not even by
    # eviction: the lanes that reach here hold no evictable matching
    # devices, so eviction never frees one
    if np.asarray(const.dev_aff).shape[0]:
        c_dev = _wave_device_capacity(const, init)
        if c_dev is None:
            raise ValueError("unbounded device capacity replay (the lane "
                             "should not have passed the wave gate)")
        dev_ok0 = c_dev >= 1
    else:
        c_dev = None
        dev_ok0 = np.ones(N, dtype=bool)
    fit0 = (feas_nonres0 & dev_ok0
            & (used_c + ask_cpu <= cpu_cap)
            & (used_m + ask_mem <= mem_cap)
            & (used_d + ask_disk <= disk_cap))

    cvalid = np.asarray(ptab.valid, dtype=bool)
    cprio = np.asarray(ptab.prio)
    ccpu = np.asarray(ptab.cpu, dtype=dt)
    cmem = np.asarray(ptab.mem, dtype=dt)
    cdisk = np.asarray(ptab.disk, dtype=dt)
    cmaxp = np.asarray(ptab.maxp)
    cgrp = np.asarray(ptab.grp)
    counts_np = np.asarray(pinit.counts, dtype=np.int64)
    # the exact pristine outcome (a looser coverage bound would admit
    # nodes the in-step search never yields, and B of them starve the
    # window)
    met0, freed0 = _numpy_preempt_pristine(
        ccpu, cmem, cdisk, cprio, cmaxp, cgrp, cvalid, counts_np,
        cpu_cap, mem_cap, disk_cap, job_prio,
        ask_cpu, ask_mem, ask_disk)
    fit2g0 = ((used_c + ask_cpu - freed0[0] <= cpu_cap)
              & (used_m + ask_mem - freed0[1] <= mem_cap)
              & (used_d + ask_disk - freed0[2] <= disk_cap))
    option0 = fit0 | (feas_nonres0 & dev_ok0 & ~fit0 & met0 & fit2g0)

    fit_pos = np.nonzero(option0)[0][:P_out + B]
    C = P_out + B
    compact = np.zeros((C, WPC_NCOLS), dtype=dt)
    compact[:, WPC_POS] = -1.0
    k = fit_pos.shape[0]
    compact[:k, WPC_FEAS] = feas[fit_pos].astype(dt)
    compact[:k, WPC_UC] = used_c[fit_pos]
    compact[:k, WPC_UM] = used_m[fit_pos]
    compact[:k, WPC_UD] = used_d[fit_pos]
    compact[:k, WPC_CC] = cpu_cap[fit_pos]
    compact[:k, WPC_CM] = mem_cap[fit_pos]
    compact[:k, WPC_CD] = disk_cap[fit_pos]
    compact[:k, WPC_PLACED] = placed0[fit_pos].astype(dt)
    compact[:k, WPC_PLACED_JOB] = placed_job0[fit_pos].astype(dt)
    aff = (np.asarray(const.affinity, dtype=dt)
           if bool(np.asarray(const.has_affinity))
           else np.zeros(N, dtype=dt))
    compact[:k, WPC_AFF] = aff[fit_pos]
    compact[:k, WPC_POS] = fit_pos.astype(dt)
    if c_dev is not None:
        compact[:k, WPC_CDEV] = np.minimum(
            c_dev[fit_pos], P_out + 1).astype(dt)
    else:
        compact[:, WPC_CDEV] = dt.type(WPC_DEV_UNBOUNDED)

    def take(arr, fill):
        out = np.full((C, A), fill, dtype=arr.dtype)
        out[:k] = arr[fit_pos]
        return out

    cand = {
        "cpu": take(ccpu, dt.type(0)),
        "mem": take(cmem, dt.type(0)),
        "disk": take(cdisk, dt.type(0)),
        "prio": take(cprio.astype(np.int32), np.int32(0)),
        "maxp": take(np.asarray(ptab.maxp, dtype=np.int32), np.int32(0)),
        "grp": take(np.asarray(ptab.grp, dtype=np.int32), np.int32(-1)),
        "valid": take(cvalid, False),
    }
    scal_f = np.array([ask_cpu, ask_mem, ask_disk, count], dtype=dt)
    scal_i = np.array([L, n_active, job_prio, distinct_flag],
                      dtype=np.int32)
    pen = np.full(P_out, -1, dtype=np.int32)
    pen[:P] = np.asarray(batch.penalty_idx, dtype=np.int32)
    counts0 = np.asarray(pinit.counts, dtype=np.int32)
    return compact, cand, scal_f, scal_i, pen, counts0
