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
dense scan O(N * P). The barrier, the dispatch pipeline and the stack
arena of the reference come with later slices.
"""
from __future__ import annotations

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
                 "dtype_name")

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
        dtype_name=lane0.dtype_name)


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
    tables say) and map results back to input-lane order."""
    dev = resolve_device(device)
    results: List = [None] * len(lanes)
    for g in groups:
        out = solve_lane_fused(
            g.const, g.init, g.batch, g.ptab, g.pinit,
            spread_alg=g.spread_alg, dtype_name=g.dtype_name, wave=g.wave,
            device=dev)
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
