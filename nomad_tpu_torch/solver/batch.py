"""Fuse many evals' lanes into one dispatch (port of the lane-fusion half
of nomad_tpu/solver/batch.py).

Lanes with equal static shapes (PackedLane.fuse_key) stack along a
leading eval axis padded to an E bucket, their placement axes padded to a
common P bucket, and solve in one kernel launch: a wavefront kernel for
lanes that pass the wave gate, the dense scan for the rest; preemption
lanes take the windowed or the dense preemption kernel, by the same
gate. Padding lanes
copy lane 0 with ``active`` all False and place nothing. Dense groups
keep the tight E bucket, as in the reference: a padding lane costs the
dense scan O(N * P). ``_cross_lane_fixpoint`` settles conflicts between
the lanes of one generation against a node-id-keyed capacity ledger (the
LP tier runs it after its greedy dispatch). The solve barrier, the
dispatch pipeline and the stack arena of the reference come with later
slices.

Knob (read at each use):
  NOMAD_TPU_TORCH_BATCH_FIXPOINT   0 turns the cross-lane fixpoint off
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..device import DeviceLike, resolve_device
from .service import PackedLane
from .wave import solve_lane_fused

# pad the fused eval axis to these sizes so one kernel shape serves many
# batch sizes
E_BUCKETS = (1, 2, 4, 8, 16, 32)


def _e_bucket(e: int) -> int:
    for b in E_BUCKETS:
        if e <= b:
            return b
    return int(2 ** np.ceil(np.log2(e)))


def _pad_placement_axis(batch, p_pad: int):
    """Grow a lane's placement axis to p_pad with inert (active=False)
    steps so different-sized evals share one dispatch shape."""
    p = batch.ask_cpu.shape[0]
    if p == p_pad:
        return batch

    def grow(arr, fill=0):
        out = np.full((p_pad,) + arr.shape[1:], fill, dtype=arr.dtype)
        out[:p] = arr
        return out

    return type(batch)(
        ask_cpu=grow(batch.ask_cpu), ask_mem=grow(batch.ask_mem),
        ask_disk=grow(batch.ask_disk),
        n_dyn_ports=grow(batch.n_dyn_ports),
        has_static=grow(batch.has_static, False),
        limit=grow(batch.limit), count=grow(batch.count, 1),
        penalty_idx=grow(batch.penalty_idx, -1),
        active=grow(batch.active, False),
        # 0-size means "no core asks": keep empty
        ask_cores=(batch.ask_cores if batch.ask_cores.shape[0] == 0
                   else grow(batch.ask_cores)))


class _FusedGroup:
    """One shape-compatible lane group, stacked and ready to dispatch."""

    __slots__ = ("idxs", "const", "init", "batch", "ptab", "pinit",
                 "e_real", "e_pad", "p_pad", "wave", "spread_alg",
                 "dtype_name", "cache_version", "delta_src")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


def _fuse_group(lanes: List[PackedLane], idxs: List[int]) -> _FusedGroup:
    """Stack one group's lanes into (E, ...) tables; padding rows copy
    lane 0 and are marked inactive."""
    lane0 = lanes[idxs[0]]
    e_real = len(idxs)
    e_pad = _e_bucket(e_real)
    p_pad = max(32, _e_bucket(max(
        lanes[i].batch.ask_cpu.shape[0] for i in idxs)))
    rows = [lanes[i] for i in idxs] + [lane0] * (e_pad - e_real)
    batches = [_pad_placement_axis(ln.batch, p_pad) for ln in rows]

    def stack(trees):
        return type(trees[0])(*(np.stack([np.asarray(f) for f in fields])
                                for fields in zip(*trees)))

    const = stack([ln.const for ln in rows])
    init = stack([ln.init for ln in rows])
    batch = stack(batches)
    # padding lanes must not place anything
    batch.active[e_real:] = False
    ptab = pinit = None
    if lane0.ptab is not None:
        ptab = stack([ln.ptab for ln in rows])
        pinit = stack([ln.pinit for ln in rows])
    return _FusedGroup(
        idxs=list(idxs), const=const, init=init, batch=batch, ptab=ptab,
        pinit=pinit,
        e_real=e_real, e_pad=e_pad, p_pad=p_pad,
        wave=lane0.wavefront_ok(), spread_alg=lane0.spread_alg,
        dtype_name=lane0.dtype_name, cache_version=lane0.table_version,
        delta_src=lane0.delta_src)


def fuse_lanes(lanes: List[PackedLane]) -> List[_FusedGroup]:
    """Host half of fuse_and_solve: group lanes by static-shape signature
    and stack each group. No device work."""
    groups: Dict[tuple, List[int]] = {}
    for i, lane in enumerate(lanes):
        groups.setdefault(lane.fuse_key(), []).append(i)
    return [_fuse_group(lanes, idxs) for idxs in groups.values()]


def solve_groups(lanes: List[PackedLane], groups: List[_FusedGroup],
                 device: DeviceLike = None) -> List[tuple]:
    """Device half of fuse_and_solve: dispatch each fused group (wave
    kernels, dense scan or a preemption kernel, as the group's gate and
    tables say; its tables through the resident buffer set, with the
    first lane's table_version and delta_src) and map results back to
    input-lane order."""
    dev = resolve_device(device)
    results: List = [None] * len(lanes)
    for g in groups:
        out = solve_lane_fused(
            g.const, g.init, g.batch, g.ptab, g.pinit,
            spread_alg=g.spread_alg, dtype_name=g.dtype_name, wave=g.wave,
            device=dev, cache_version=g.cache_version,
            delta_src=g.delta_src)
        for j, li in enumerate(g.idxs):
            p_real = lanes[li].batch.ask_cpu.shape[0]
            res = (out[0][j][:p_real].astype(np.int64), out[1][j][:p_real],
                   out[2][j][:p_real].astype(np.int64))
            if g.ptab is not None:
                res += (out[3][j][:p_real],)
            results[li] = res
    return results


def fuse_and_solve(lanes: List[PackedLane], device: DeviceLike = None
                   ) -> List[tuple]:
    """Group lanes by static-shape signature, solve each group as ONE
    batched dispatch on ``device`` (default ``cuda``), and return per-lane
    host numpy (chosen int64, scores, n_yielded int64) in input order;
    a preemption lane's tuple adds evict_rows (P, A) bool.
    Pinning the eval axis to a larger bucket (the reference's
    ``e_pad_hint``) comes with the solve barrier that sets it."""
    dev = resolve_device(device)
    return solve_groups(lanes, fuse_lanes(lanes), device=dev)


def _cross_lane_fixpoint(lanes: List[PackedLane], results: List,
                         ledger: Dict[str, list],
                         device: DeviceLike = None) -> None:
    """Resolve conflicts between the lanes of one generation before their
    plans are submitted: walk lanes in plan-priority order (ties in input
    order), charge each placement against the shared per-node ledger
    (node id -> [free cpu, mem, disk, dynamic ports], persisting across a
    batch's generations), and re-solve only the overflowing placements
    of wave lanes against the accumulated usage, on ``device``.

    Lanes the wave kernel cannot re-solve (preemption tables, static
    ports, a plan that already stops or preempts allocs, lanes the wave
    gate refuses) only consume ledger capacity; their conflicts are left
    to the plan applier. ``results`` is edited in place."""
    if os.environ.get("NOMAD_TPU_TORCH_BATCH_FIXPOINT", "1") == "0":
        return
    if len(lanes) < 2 and not ledger:
        return

    order_idx = sorted(range(len(lanes)),
                       key=lambda i: (-lanes[i].plan_priority, i))

    def charge(lane, free, pi):
        """Charge placement pi to the ledger entry ``free`` if it fits."""
        b = lane.batch
        need = (float(b.ask_cpu[pi]), float(b.ask_mem[pi]),
                float(b.ask_disk[pi]), int(b.n_dyn_ports[pi]))
        if (free[0] >= need[0] and free[1] >= need[1]
                and free[2] >= need[2] and free[3] >= need[3]):
            free[0] -= need[0]
            free[1] -= need[1]
            free[2] -= need[2]
            free[3] -= need[3]
            return True
        return False

    def entry(lane, pos, nid):
        f = ledger.get(nid)
        if f is None:
            c, s = lane.const, lane.init
            f = [float(c.cpu_cap[pos]) - float(s.used_cpu[pos]),
                 float(c.mem_cap[pos]) - float(s.used_mem[pos]),
                 float(c.disk_cap[pos]) - float(s.used_disk[pos]),
                 int(s.dyn_avail[pos])]
            ledger[nid] = f
        return f

    for i in order_idx:
        lane, res = lanes[i], results[i]
        if res is None:
            continue
        chosen = res[0]
        active = np.asarray(lane.batch.active)
        # consumer-only lanes are never re-solved: preemption tables and
        # static ports need the applier's exact checks, and a plan that
        # stops or preempts allocs frees capacity only if it commits
        resolvable = (lane.ptab is None and lane.wavefront_ok()
                      and not bool(np.asarray(lane.batch.has_static)[:1]
                                   .any())
                      and not lane.plan_has_stops)
        order = np.asarray(lane.order)
        conflicted: List[int] = []
        accepted_own: List[int] = []
        for pi in range(chosen.shape[0]):
            pos = int(chosen[pi])
            if pos < 0 or pos >= order.shape[0] or not active[pi]:
                continue
            nid = lane.node_ids[order[pos]]
            if charge(lane, entry(lane, pos, nid), pi):
                accepted_own.append(pos)
            elif resolvable:
                conflicted.append(pi)
            # else: left for the applier; its capacity is not charged
        if conflicted:
            results[i] = _resolve_lane_conflicts(
                lane, res, conflicted, accepted_own, ledger, entry, charge,
                device)


def _resolve_lane_conflicts(lane, res, conflicted, accepted_own, ledger,
                            entry, charge, device):
    """Re-solve ``conflicted`` placements of one wave lane against the
    ledger's accumulated usage; returns the merged result tuple."""
    chosen = np.array(res[0], copy=True)
    scores = np.array(res[1], copy=True)
    n_yielded = np.array(res[2], copy=True)
    const, init = lane.const, lane.init
    order = np.asarray(lane.order)
    n = order.shape[0]
    pos_of = {lane.node_ids[order[p]]: p for p in range(n)}

    used_cpu = np.array(init.used_cpu, copy=True)
    used_mem = np.array(init.used_mem, copy=True)
    used_disk = np.array(init.used_disk, copy=True)
    dyn_avail = np.array(init.dyn_avail, copy=True)
    for nid, f in ledger.items():
        p = pos_of.get(nid)
        if p is None:
            continue
        # this lane's view of the node from the joint ledger (caps are
        # the same in every lane, so cap - free is the joint usage)
        used_cpu[p] = float(const.cpu_cap[p]) - f[0]
        used_mem[p] = float(const.mem_cap[p]) - f[1]
        used_disk[p] = float(const.disk_cap[p]) - f[2]
        dyn_avail[p] = f[3]
    placed = np.array(init.placed, copy=True)
    placed_job = np.array(init.placed_job, copy=True)
    spread_counts = np.array(init.spread_counts, copy=True)
    S = spread_counts.shape[0] if spread_counts.ndim else 0
    for pos in accepted_own:
        placed[pos] += 1
        placed_job[pos] += 1
        for s in range(S):
            v = int(const.spread_vidx[s, pos])
            if v >= 0:
                spread_counts[s, v] += 1
    new_init = init._replace(
        used_cpu=used_cpu, used_mem=used_mem, used_disk=used_disk,
        dyn_avail=dyn_avail, placed=placed, placed_job=placed_job,
        spread_counts=spread_counts)

    idx = np.asarray(conflicted, dtype=np.int64)
    sub_batch = type(lane.batch)(*(
        np.asarray(a)[idx] if np.asarray(a).shape[:1] == (chosen.shape[0],)
        else np.asarray(a) for a in lane.batch))

    def one(tree):
        return type(tree)(*(np.asarray(a)[None] for a in tree))

    c2, s2, y2 = solve_lane_fused(
        one(const), one(new_init), one(sub_batch),
        spread_alg=lane.spread_alg, dtype_name=lane.dtype_name, wave=True,
        device=device)
    # merge only successful re-solves: a -1 means the ledger saw no
    # capacity, but the ledger can be pessimistic (a consumer-only lane's
    # charge is never refunded), so keep the original choice and let the
    # applier decide
    for k, pi in enumerate(conflicted):
        pos = int(c2[0, k])
        if pos < 0:
            continue
        chosen[pi] = pos
        scores[pi] = s2[0, k]
        n_yielded[pi] = y2[0, k]
        # charge the fresh choice (solved against the ledger's usage, so
        # it fits; charging records it for later lanes)
        nid = lane.node_ids[order[pos]]
        charge(lane, entry(lane, pos, nid), pi)
    return (chosen, scores, n_yielded)
