"""Fuse many evals' lanes into one dispatch (port of the lane-fusion half
of nomad_tpu/solver/batch.py, with its stack arena and its mesh route).

Lanes with equal static shapes (PackedLane.fuse_key) stack along a
leading eval axis padded to an E bucket, their placement axes padded to a
common P bucket, and solve in one kernel launch: a wavefront kernel for
lanes that pass the wave gate, the dense scan for the rest; preemption
lanes take the windowed or the dense preemption kernel, by the same
gate. Dense groups keep the tight E bucket, as in the reference: a
padding lane costs the dense scan O(N * P); ``e_pad_hint`` pins wave
groups to a wider bucket.

The stacked buffers come from the stack arena: a bounded pool of host
buffers keyed by the group's fuse key and (E, P) shape, filled in place
and returned to the pool after the dispatch. Padding rows hold some
valid lane (inactive, their results discarded): a fresh entry copies
lane 0 into them, and a reused entry leaves an earlier generation's lanes
there (``pad_fills_skipped``), exactly as the reference's arena does, so
the stacked tables and the resident set's counters match the
reference's at every group size. Pooled entries are frozen
(``write=False``) while they sit in the free list.

With several cells (``device`` a list; by default every CUDA card), a
dense group shards over the (evals, nodes) grid ``parallel.mesh.pick_mesh``
chooses, and wave and windowed-preemption groups split their eval axis
over the cells (parallel/mesh.py); dense preemption groups stay on the
first cell. ``_cross_lane_fixpoint`` settles conflicts between the lanes
of one generation against a node-id-keyed capacity ledger (the LP tier
runs it after its greedy dispatch).

``SolveBarrier`` is the rendezvous of one batch of eval threads: each
thread hands in its lane and blocks; when every participant has arrived
or finished, the generation's lanes fuse into one dispatch under the
dispatch guard's watchdog (solver/guard.py), then the fixpoint, and each
thread wakes with its lane's result, or with the DispatchFailed every
participant of a failed generation gets. At depth 1 the last arriver
dispatches; at depth > 1 the generation goes to the process-wide
dispatch pipeline, whose intake thread stacks it into arena buffers
while up to ``depth`` earlier generations are in flight, and results
are delivered in generation order. ``make_solve_hook`` is what a
scheduler calls in place of TpuPlacementService.solve: pack on the eval's
thread, solve at the barrier, materialize on the eval's thread.

Knobs (read at each use):
  NOMAD_TPU_TORCH_BATCH_FIXPOINT     0 turns the cross-lane fixpoint off
  NOMAD_TPU_TORCH_PACK_ARENA         0 stacks into fresh buffers every
                                     generation (kill switch)
  NOMAD_TPU_TORCH_PACK_ARENA_ENTRIES free arena entries kept (8)
  NOMAD_TPU_TORCH_PACK_ARENA_MB      free arena MiB kept (512)
  NOMAD_TPU_TORCH_DISPATCH_DEPTH     fused dispatches in flight across the
                                     process (2; 1 is the kill switch:
                                     the last arriver dispatches)
  NOMAD_TPU_TORCH_DISPATCH_TIMEOUT   the watchdog deadline of each
                                     dispatch, seconds (30; guard.py)
  NOMAD_TPU_TORCH_BREAKER_THRESHOLD  consecutive failed dispatches that
                                     trip the breaker (3; guard.py, with
                                     NOMAD_TPU_TORCH_BREAKER_BACKOFF,
                                     _BACKOFF_MAX, _PROBE_TIMEOUT)
"""
from __future__ import annotations

import functools
import logging
import os
import queue
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import jitcheck, kernels, schedcheck
from ..device import DeviceLike, resolve_device
from ..parallel import mesh
from ..server.quality import observatory
from ..server.telemetry import metrics
from ..server.tracing import tracer
from . import xferobs
from .guard import dispatch_deadline_s, run_dispatch
from .service import PackedLane
from .wave import solve_lane_fused

_log = logging.getLogger(__name__)

# one device, or a list of cells (a device may appear more than once)
CellsLike = Union[DeviceLike, Sequence[DeviceLike]]

# pad the fused eval axis to these sizes so one kernel shape serves many
# batch sizes
E_BUCKETS = (1, 2, 4, 8, 16, 32)


def _e_bucket(e: int) -> int:
    for b in E_BUCKETS:
        if e <= b:
            return b
    return int(2 ** np.ceil(np.log2(e)))


# Safety valve: if a straggler thread neither finishes nor reaches the
# barrier within this window (a bug, not a normal state), dispatch without
# it rather than wedge every blocked eval.
BARRIER_TIMEOUT_S = 10.0


def dispatch_depth() -> int:
    """Fused dispatches in flight across the process
    (NOMAD_TPU_TORCH_DISPATCH_DEPTH, default 2). Depth 1 is the kill
    switch: every barrier dispatches on its last-arriving thread. Depth
    > 1 routes dispatches through the pipeline, so one generation's host
    stacking overlaps another's device work."""
    try:
        d = int(os.environ.get("NOMAD_TPU_TORCH_DISPATCH_DEPTH", "2"))
    except ValueError:
        return 1
    return max(1, min(d, 32))


class _DispatchPipeline:
    """Process-wide dispatch executor: a FIFO intake thread runs each
    job's prepare stage, then starts one in-flight thread per job, never
    more than ``depth`` at once. Jobs of every barrier share the bound."""

    def __init__(self, depth: int):
        self.depth = depth
        self._sem = threading.Semaphore(depth)
        self._q: "queue.Queue" = queue.Queue()
        self._in_flight = 0
        self._staged = 0
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._intake, daemon=True,
            name="solver-dispatch-pipeline")
        self._thread.start()

    def submit(self, job, prepare=None) -> None:
        """``prepare`` (optional) is the job's host staging, the arena
        fill of its generation: the intake thread runs it BEFORE waiting
        for a dispatch slot, so generation g+1's stacking overlaps
        generation g's dispatch instead of holding a slot."""
        self._q.put((job, prepare))

    def stop(self) -> None:
        self._q.put(None)

    def counts(self) -> Tuple[int, int]:
        """(dispatches in flight, prepare stages run)."""
        with self._lock:
            return self._in_flight, self._staged

    def _intake(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            job, prepare = item
            if prepare is not None:
                try:
                    prepare()
                    with self._lock:
                        self._staged += 1
                except Exception:  # noqa: BLE001 -- staging is best
                    # effort: the job re-derives (and fails under its
                    # watchdog)
                    _log.exception("dispatch prepare stage failed")
            # the depth slot is released by the job's thread
            self._sem.acquire()
            with self._lock:
                self._in_flight += 1
            threading.Thread(target=self._run_job, args=(job,),
                             daemon=True,
                             name="solver-dispatch-inflight").start()

    def _run_job(self, job) -> None:
        try:
            job()
        except Exception:  # noqa: BLE001 -- jobs wake their own waiters;
            _log.exception("dispatch job failed")   # this is a backstop
        finally:
            with self._lock:
                self._in_flight -= 1
            self._sem.release()


_PIPELINE: Optional[_DispatchPipeline] = None
_PIPELINE_LOCK = threading.Lock()


def _get_pipeline(depth: int) -> _DispatchPipeline:
    global _PIPELINE
    with _PIPELINE_LOCK:
        if _PIPELINE is None or _PIPELINE.depth != depth:
            if _PIPELINE is not None:
                _PIPELINE.stop()
            _PIPELINE = _DispatchPipeline(depth)
        return _PIPELINE


def pipeline_state() -> dict:
    """The pipeline's depth knob, its dispatches in flight, the prepare
    stages it ran, and whether it exists."""
    with _PIPELINE_LOCK:
        pipe = _PIPELINE
    in_flight, staged = pipe.counts() if pipe is not None else (0, 0)
    return {"depth": dispatch_depth(), "in_flight": in_flight,
            "staged_total": staged, "active": pipe is not None}


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


# --------------------------------------------------------------------------
# The stack arena (reference batch.py _StackArena).

def _arena_enabled() -> bool:
    return os.environ.get("NOMAD_TPU_TORCH_PACK_ARENA", "1") != "0"


def _arena_max_entries() -> int:
    try:
        return max(1, int(os.environ.get(
            "NOMAD_TPU_TORCH_PACK_ARENA_ENTRIES", "8")))
    except ValueError:
        return 8


def _arena_max_bytes() -> int:
    try:
        return max(1, int(float(os.environ.get(
            "NOMAD_TPU_TORCH_PACK_ARENA_MB", "512")) * 1024 * 1024))
    except ValueError:
        return 512 * 1024 * 1024


_ARENA_SITE = "solver/batch.py:_StackArena"


def _arena_note_reuse(ent) -> None:
    """jitcheck: a checkout thaws the entry's stacks on purpose, and a
    served checkout makes the arena steady."""
    for arrs in ent.trees.values():
        for a in arrs:
            jitcheck.note_thawed(a)
    jitcheck.note_served(_ARENA_SITE)


class _ArenaEntry:
    __slots__ = ("key", "trees", "nbytes", "pad_valid", "pooled")

    def __init__(self, key, trees, nbytes: int):
        self.key = key
        self.trees = trees          # tree name -> list of np arrays
        self.nbytes = nbytes
        self.pad_valid = False      # padding rows hold valid lane data
        self.pooled = True


class _StackArena:
    """Bounded pool of reusable stacked host buffers, keyed by fused group
    shape. Thread-safe: concurrent generations check out distinct
    entries; an exhausted pool allocates fresh (never blocks)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._free: "OrderedDict[int, _ArenaEntry]" = OrderedDict()
        self._seq = 0
        self._free_bytes = 0
        self._in_use = 0
        self._stats = {"reuses": 0, "allocs": 0, "evictions": 0,
                       "pad_fills_skipped": 0}

    @staticmethod
    def _set_writeable(ent, flag: bool) -> None:
        """Pooled buffers are frozen while they sit in the free list: a
        generation writing into a buffer it already released raises
        instead of corrupting a lane another checkout reads."""
        for arrs in ent.trees.values():
            for a in arrs:
                a.setflags(write=flag)

    @staticmethod
    def _specs_match(ent, specs) -> bool:
        for name, fields in specs.items():
            arrs = ent.trees.get(name)
            if arrs is None or len(arrs) != len(fields):
                return False
            for a, (shape, dtype) in zip(arrs, fields):
                if a.shape != shape or a.dtype != dtype:
                    return False
        return True

    def acquire(self, key, specs):
        """specs: tree name -> list of (shape, dtype). Returns (entry,
        reused)."""
        if _arena_enabled():
            with self._lock:
                for tok, ent in self._free.items():
                    if ent.key == key and self._specs_match(ent, specs):
                        del self._free[tok]
                        self._free_bytes -= ent.nbytes
                        self._in_use += 1
                        self._stats["reuses"] += 1
                        self._set_writeable(ent, True)
                        if jitcheck._ACTIVE:
                            _arena_note_reuse(ent)
                        return ent, True
        if jitcheck._ACTIVE:
            self._note_build(key, specs)
        trees = {}
        nbytes = 0
        for name, fields in specs.items():
            arrs = []
            for shape, dtype in fields:
                a = np.empty(shape, dtype=dtype)
                nbytes += a.nbytes
                arrs.append(a)
            trees[name] = arrs
        ent = _ArenaEntry(key, trees, nbytes)
        with self._lock:
            self._stats["allocs"] += 1
            if _arena_enabled():
                self._in_use += 1
            else:
                ent.pooled = False
        return ent, False

    def _note_build(self, key, specs) -> None:
        """jitcheck: a fresh stack for (bucket, dtypes) is a rebuild when
        the free list holds one it could have served."""
        with self._lock:
            held = _arena_enabled() and any(
                e.key == key and self._specs_match(e, specs)
                for e in self._free.values())
        sig = (key, tuple((n, tuple((tuple(sh), np.dtype(dt).str)
                                    for sh, dt in f))
                          for n, f in sorted(specs.items())))
        jitcheck.note_build(_ARENA_SITE, sig, held=held)

    def release(self, ent, pool: bool = True) -> None:
        """Check ``ent`` back in; ``pool`` False drops it instead of
        keeping it in the free list (the stacking of a failed dispatch:
        nothing derived before a failure outlives the breaker's clear)."""
        if not ent.pooled:
            return
        with self._lock:
            self._in_use -= 1
            if not (pool and _arena_enabled()):
                return
            self._set_writeable(ent, False)
            if jitcheck._ACTIVE:
                for arrs in ent.trees.values():
                    for a in arrs:
                        jitcheck.note_frozen(a)
            self._seq += 1
            self._free[self._seq] = ent
            self._free_bytes += ent.nbytes
            max_e, max_b = _arena_max_entries(), _arena_max_bytes()
            while self._free and (len(self._free) > max_e
                                  or self._free_bytes > max_b):
                _, old = self._free.popitem(last=False)
                self._free_bytes -= old.nbytes
                self._stats["evictions"] += 1

    def note_pad_skip(self, n: int = 1) -> None:
        with self._lock:
            self._stats["pad_fills_skipped"] += n

    def clear(self, reason: str = "") -> None:
        del reason
        with self._lock:
            self._free.clear()
            self._free_bytes = 0

    def state(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["entries"] = len(self._free)
            out["in_use"] = self._in_use
            out["resident_bytes"] = self._free_bytes
        out["enabled"] = _arena_enabled()
        return out


_ARENA = _StackArena()


def arena_state() -> dict:
    """The arena's counters: reuses, allocs, evictions, pad_fills_skipped,
    free entries, entries in use, free bytes, and whether it is on."""
    return _ARENA.state()


def arena_clear(reason: str = "") -> None:
    """Drop the pooled (free) buffers; entries in use are untouched."""
    _ARENA.clear(reason)


class _FusedGroup:
    """One shape-compatible lane group, stacked into arena buffers and
    ready to dispatch."""

    __slots__ = ("idxs", "const", "init", "batch", "ptab", "pinit",
                 "A", "e_real", "e_pad", "p_pad", "wave", "spread_alg",
                 "dtype_name", "cache_version", "delta_src", "entry",
                 "arena_reused")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


def _fuse_group(lanes: List[PackedLane], idxs: List[int], key: tuple,
                e_pad_hint: int) -> _FusedGroup:
    """Stack one group's lanes into arena-backed (E, ...) buffers, filling
    lanes in place; a reused entry keeps the padding rows an earlier
    generation left (they hold valid lanes, masked inactive)."""
    lane0 = lanes[idxs[0]]
    A = 1 if lane0.ptab is not None else 0
    e_real = len(idxs)
    e_pad = _e_bucket(e_real)
    if e_pad_hint and lane0.wavefront_ok():
        e_pad = max(e_pad, _e_bucket(min(e_pad_hint, E_BUCKETS[-1])))
    p_pad = max(32, _e_bucket(max(
        lanes[i].batch.ask_cpu.shape[0] for i in idxs)))
    # a gauge: this is a lane count, not a time
    metrics.sample("nomad.solver.batch_lanes", float(e_real))
    padded = {i: _pad_placement_axis(lanes[i].batch, p_pad) for i in idxs}
    srcs = {"const": lambda i: lanes[i].const,
            "init": lambda i: lanes[i].init,
            "batch": lambda i: padded[i]}
    if A > 0:
        srcs["ptab"] = lambda i: lanes[i].ptab
        srcs["pinit"] = lambda i: lanes[i].pinit
    specs = {}
    for name, src in srcs.items():
        specs[name] = [((e_pad,) + np.asarray(f).shape, np.asarray(f).dtype)
                       for f in src(idxs[0])]
    entry, reused = _ARENA.acquire((key, e_pad, p_pad), specs)
    metrics.incr("nomad.solver.pack_arena_reuse" if reused
                 else "nomad.solver.pack_arena_alloc")

    skip_pad = entry.pad_valid
    if skip_pad and e_pad > e_real:
        _ARENA.note_pad_skip()
    for name, src in srcs.items():
        dsts = entry.trees[name]
        for f_i, dst in enumerate(dsts):
            for j, li in enumerate(idxs):
                dst[j] = np.asarray(src(li)[f_i])
            if not skip_pad:
                # a fresh buffer's padding rows need some valid lane; once
                # filled they stay valid (earlier generations' rows are
                # real lanes whose results are discarded)
                for j in range(e_real, e_pad):
                    dst[j] = dst[0]
    entry.pad_valid = True

    const = type(lane0.const)(*entry.trees["const"])
    init = type(lane0.init)(*entry.trees["init"])
    batch = type(lane0.batch)(*entry.trees["batch"])
    # padding lanes (and stale rows of a wider earlier generation) must
    # not place anything
    batch.active[e_real:] = False
    ptab = type(lane0.ptab)(*entry.trees["ptab"]) if A > 0 else None
    pinit = type(lane0.pinit)(*entry.trees["pinit"]) if A > 0 else None
    return _FusedGroup(
        idxs=list(idxs), const=const, init=init, batch=batch, ptab=ptab,
        pinit=pinit, A=A, e_real=e_real, e_pad=e_pad, p_pad=p_pad,
        wave=lane0.wavefront_ok(), spread_alg=lane0.spread_alg,
        dtype_name=lane0.dtype_name, cache_version=lane0.table_version,
        delta_src=lane0.delta_src, entry=entry, arena_reused=reused)


def fuse_lanes(lanes: List[PackedLane], e_pad_hint: int = 0
               ) -> List[_FusedGroup]:
    """Host half of fuse_and_solve: group lanes by static-shape signature
    and stack each group into arena buffers. No device work. The caller
    returns each group's entry with ``release_groups`` (solve_groups
    does) once nothing reads its buffers."""
    groups: Dict[tuple, List[int]] = {}
    for i, lane in enumerate(lanes):
        groups.setdefault(lane.fuse_key(), []).append(i)
    out: List[_FusedGroup] = []
    try:
        for key, idxs in groups.items():
            out.append(_fuse_group(lanes, idxs, key, e_pad_hint))
    except BaseException:
        release_groups(out)         # no caller will see these entries
        raise
    return out


def release_groups(groups: List[_FusedGroup], pool: bool = True) -> None:
    """Return the groups' arena entries to the pool (``pool`` False:
    check them in without pooling them)."""
    for g in groups:
        if g.entry is not None:
            _ARENA.release(g.entry, pool=pool)
            g.entry = None


def resolve_cells(device: CellsLike = None) -> List[torch.device]:
    """The cells a dispatch may use: every CUDA card by default (no card
    raises), else the one device or the list of devices given. A device
    may appear several times: each appearance is one cell of a grid."""
    if device is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            resolve_device(None)          # raises: no card
        return [torch.device("cuda", i) for i in range(n)]
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("an empty list of cells")
        return [resolve_device(d) for d in device]
    return [resolve_device(device)]


def dispatch_cell(cells: List[torch.device]) -> torch.device:
    """The device a dispatch's watchdog thread enters: the first cell,
    with the constructing thread's current card for a bare ``cuda`` (a
    new thread starts on card 0)."""
    c = cells[0]
    if c.type == "cuda" and c.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return c


def _dispatch(g: _FusedGroup, cells: List[torch.device], use_mesh: bool):
    """One fused group's solve (reference batch.py _dispatch): a dense
    group over the (evals, nodes) grid pick_mesh chooses for its shapes,
    a wave or windowed-preemption group split on its eval axis over the
    cells (when the cells divide it), a dense preemption group and every
    group without a grid on the first cell."""
    kw = dict(spread_alg=g.spread_alg, dtype_name=g.dtype_name,
              cache_version=g.cache_version, delta_src=g.delta_src)
    multi = use_mesh and len(cells) > 1
    if g.ptab is not None:
        if g.wave:
            metrics.incr("nomad.solver.wavefront_preempt_dispatches")
        return solve_lane_fused(
            g.const, g.init, g.batch, g.ptab, g.pinit, wave=g.wave,
            device=cells if (g.wave and multi) else cells[0], **kw)
    if g.wave:
        metrics.incr("nomad.solver.wavefront_dispatches")
        return solve_lane_fused(g.const, g.init, g.batch, wave=True,
                                device=cells if multi else cells[0], **kw)
    metrics.incr("nomad.solver.dense_dispatches")
    E, N = np.asarray(g.const.cpu_cap).shape
    grid = mesh.pick_mesh(E, N, cells) if multi else None
    if grid is not None:
        metrics.incr("nomad.solver.mesh_dispatches")
        out = mesh.mesh_solve(grid, g.const, g.init, g.batch, **kw)
        xferobs.note_fetch(xferobs.tree_nbytes(out), "mesh")
        return out
    return solve_lane_fused(g.const, g.init, g.batch, device=cells[0], **kw)


def solve_groups(lanes: List[PackedLane], groups: List[_FusedGroup],
                 device: CellsLike = None, use_mesh: bool = True
                 ) -> List[tuple]:
    """Device half of fuse_and_solve: dispatch each fused group (wave
    kernels, dense scan or a preemption kernel, as the group's gate and
    tables say; over a grid of cells where ``_dispatch`` finds one; its
    tables through the resident buffer set, with the first lane's
    table_version and delta_src), map results back to input-lane order,
    and return the groups' arena entries to the pool."""
    results: List = [None] * len(lanes)
    try:
        cells = resolve_cells(device)
        for g in groups:
            t0_wall = time.time()
            t0 = time.perf_counter()
            # the transfer ledger's record of this generation: the
            # transports' payload notes land in it, and its (bytes, ms)
            # pair feeds the transfer fit. Every route returns host
            # numpy, so the timed region ends after the read-back (no
            # extra synchronize). The finally folds the record's notes
            # into the ledger on error paths too.
            if xferobs.enabled():
                xferobs.begin_dispatch(
                    E=g.e_pad, e_real=g.e_real, P=g.p_pad,
                    wave=bool(g.wave), A=g.A,
                    in_flight=pipeline_state()["in_flight"])
            try:
                out = _dispatch(g, cells, use_mesh)
            finally:
                dt_ms = (time.perf_counter() - t0) * 1e3
                xferobs.end_dispatch(dt_ms, t0_wall)
            metrics.sample_ms("nomad.solver.dispatch", dt_ms)
            tracer.record("solver.dispatch", t0_wall, dt_ms,
                          E=g.e_pad, e_real=g.e_real, P=g.p_pad,
                          wave=bool(g.wave), A=g.A,
                          arena_reused=bool(g.arena_reused),
                          slow_compile=dt_ms > 1000.0)
            if dt_ms > 1000.0:
                # over a second (the reference's compile threshold; the
                # port builds its kernels before any barrier, so here it
                # is host work): say which variant
                metrics.incr("nomad.solver.dispatch_slow")
                _log.warning("slow dispatch %.0fms (E=%d P=%d wave=%s "
                             "A=%d)", dt_ms, g.e_pad, g.p_pad, g.wave, g.A)
            for j, li in enumerate(g.idxs):
                p_real = lanes[li].batch.ask_cpu.shape[0]
                res = (np.asarray(out[0][j][:p_real]).astype(np.int64),
                       np.asarray(out[1][j][:p_real]),
                       np.asarray(out[2][j][:p_real]).astype(np.int64))
                if g.ptab is not None:
                    res += (np.asarray(out[3][j][:p_real]),)
                results[li] = res
    finally:
        # results are on the host (or the dispatch failed): nothing reads
        # the host buffers when the next generation refills them
        release_groups(groups)
    return results


def fuse_and_solve(lanes: List[PackedLane], device: CellsLike = None,
                   use_mesh: bool = True, e_pad_hint: int = 0,
                   staged: Optional[dict] = None) -> List[tuple]:
    """Group lanes by static-shape signature, solve each group as ONE
    batched dispatch, and return per-lane host numpy (chosen int64,
    scores, n_yielded int64) in input order; a preemption lane's tuple
    adds evict_rows (P, A) bool. ``device`` is one device or a list of
    cells (default: every CUDA card; with one card there is no grid).
    ``use_mesh`` False keeps every group on the first cell;
    ``e_pad_hint`` pins wave groups' eval axis to at least that bucket.
    ``staged`` may carry ``"groups"``, the lanes already stacked by the
    pipeline's prepare stage: taken out of the dict (so exactly one
    holder returns their arena entries), else the lanes stack here."""
    cells = resolve_cells(device)
    groups = staged.pop("groups", None) if staged else None
    if groups is None:
        groups = fuse_lanes(lanes, e_pad_hint)
    return solve_groups(lanes, groups, device=cells, use_mesh=use_mesh)


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
            metrics.incr("nomad.solver.fixpoint_conflicts", len(conflicted))
            metrics.incr("nomad.solver.fixpoint_dispatches")
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


# --------------------------------------------------------------------------
# The solve barrier (reference batch.py SolveBarrier)

class SolveBarrier:
    """Rendezvous point for one batch of eval threads.

    Threads call solve() (blocking) or done() (on exit). When arrivals +
    finished == participants the batch dispatches:

      - depth 1 (NOMAD_TPU_TORCH_DISPATCH_DEPTH=1, the kill switch): the
        LAST thread to arrive runs the fused dispatch and the fixpoint
        for everyone under one watchdog deadline and wakes them;
      - depth > 1 (default): the generation goes to the process-wide
        dispatch pipeline and the arriving thread joins the waiters. Up
        to ``depth`` fused dispatches run in flight, each under its OWN
        watchdog; completions apply in GENERATION ORDER, so the
        fixpoint's ledger charges generation g before g+1 even when
        g+1's device work ends first.

    ``device`` is the cells of every dispatch, as for fuse_and_solve
    (default: every CUDA card). They are resolved here, so a machine
    with no card raises at construction, never as a DispatchFailed
    under the watchdog; for a CUDA cell the kernel library is built or
    loaded here too, so no build runs under a dispatch deadline."""

    def __init__(self, participants: int, use_mesh: bool = True,
                 e_pad_hint: int = 0, depth: Optional[int] = None,
                 plan_group_hint=None, device: CellsLike = None):
        self._cells = resolve_cells(device)
        self._enter = dispatch_cell(self._cells)
        if any(c.type == "cuda" for c in self._cells):
            kernels.load()
        self._cv = threading.Condition()
        self._participants = participants
        self._finished = 0
        self._waiting: List[Tuple[PackedLane, dict]] = []
        self._use_mesh = use_mesh
        self._generation = 0
        self._depth = dispatch_depth() if depth is None else max(1, depth)
        # called with the lane count each time a generation's results are
        # delivered: each of those evals is about to submit a plan, so
        # the plan applier can commit the generation as one group
        self._plan_group_hint = plan_group_hint
        # generation-ordered completion for the pipelined mode
        self._complete_cv = threading.Condition()
        self._next_complete = 1
        # pin wave groups' eval axis to the configured width, not the
        # momentary batch size
        self._e_pad_hint = e_pad_hint or participants
        # the cross-lane fixpoint's per-node capacity ledger; persists
        # across this batch's generations
        self._ledger: Dict[str, list] = {}

    @property
    def cells(self):
        """The devices every dispatch of this barrier runs on."""
        return self._cells

    def done(self) -> None:
        """The thread finished its eval (no more solves coming)."""
        with self._cv:
            self._finished += 1
            if self._ready_locked():
                self._dispatch_locked()

    def solve(self, lane: PackedLane):
        """Block until the batch dispatches; returns this lane's result
        tuple (as fuse_and_solve's). A failed dispatch raises its
        DispatchFailed in EVERY participating thread."""
        # the eval thread's trace ctx rides the cell, so the dispatch (on
        # a pipeline thread at depth > 1) records into every
        # participating eval's trace
        cell: dict = {"trace_ctx": tracer.current()}
        t_arrive = time.time()
        with self._cv:
            self._waiting.append((lane, cell))
            if self._ready_locked():
                self._dispatch_locked()
            while "result" not in cell and "error" not in cell:
                gen = self._generation
                if not self._cv.wait(timeout=BARRIER_TIMEOUT_S):
                    # straggler safety valve: if OUR lane is still queued
                    # (no dispatch took it), dispatch what we have. Either
                    # way the cell is re-checked under the condition
                    # variable: a generation in flight may still be about
                    # to fill it.
                    if (self._generation == gen
                            and any(c is cell for _, c in self._waiting)):
                        self._dispatch_locked()
            if "error" in cell:
                tracer.record("solver.barrier", t_arrive,
                              (time.time() - t_arrive) * 1e3,
                              outcome="error")
                raise cell["error"]
            tracer.record("solver.barrier", t_arrive,
                          (time.time() - t_arrive) * 1e3, outcome="ok")
            return cell["result"]

    def _ready_locked(self) -> bool:
        return bool(self._waiting
                    and len(self._waiting) + self._finished
                    >= self._participants)

    def _fixpoint_needed(self, lanes) -> bool:
        """The fixpoint's own early-return conditions: a second watchdog
        is paid only when it can work."""
        return (os.environ.get("NOMAD_TPU_TORCH_BATCH_FIXPOINT", "1") != "0"
                and (len(lanes) >= 2 or bool(self._ledger)))

    def _dispatch_locked(self) -> None:
        batch = self._waiting
        self._waiting = []
        self._generation += 1
        gen = self._generation
        lanes = [lane for lane, _ in batch]

        if self._depth > 1:
            # hand the generation to the pipeline; the caller falls back
            # into its wait loop and is woken by the completion. The
            # prepare stage stacks the lanes into arena buffers on the
            # intake thread before a dispatch slot frees up.
            staged: dict = {}
            e_pad_hint = self._e_pad_hint

            def _prepare():
                staged["groups"] = fuse_lanes(lanes, e_pad_hint=e_pad_hint)

            if schedcheck._ACTIVE:
                # the waiters wait on the pipeline: work outside a
                # controlled schedule until _dispatch_job ends
                schedcheck.external_begin()
            try:
                _get_pipeline(self._depth).submit(
                    functools.partial(self._dispatch_job, gen, batch,
                                      lanes, staged),
                    prepare=_prepare)
            except BaseException:
                if schedcheck._ACTIVE:
                    schedcheck.external_end()
                raise
            return

        def solve_batch():
            results = fuse_and_solve(lanes, device=self._cells,
                                     use_mesh=self._use_mesh,
                                     e_pad_hint=self._e_pad_hint)
            _cross_lane_fixpoint(lanes, results, self._ledger,
                                 device=self._cells[0])
            return results

        # group ctx over every waiting eval: the fused dispatch's spans
        # belong to each of them
        gctx = tracer.group([c.get("trace_ctx") for _, c in batch])
        try:
            # the fused dispatch and the fixpoint's re-solves run under
            # the watchdog: a wedged card fails EVERY waiter with
            # DispatchFailed instead of stranding the batch
            xfer_tok = xferobs.mark()
            with tracer.activate(gctx), \
                    tracer.span("solver.fuse_dispatch", ctx=gctx,
                                generation=gen, lanes=len(lanes),
                                depth=1) as sp:
                results = run_dispatch(solve_batch, label="solver.batch",
                                       device=self._enter)
                # shipped / resident bytes and the transfer fit's
                # predicted vs actual ms of this generation
                sp.tag(**xferobs.span_tags(xfer_tok))
            for (_, cell), res in zip(batch, results):
                cell["result"] = res
        except Exception as e:  # noqa: BLE001 -- waiters must not strand
            for _, cell in batch:
                cell["error"] = e
        finally:
            self._hint_plan_group(len(batch))
            with self._complete_cv:
                self._next_complete = gen + 1
            self._cv.notify_all()

    def _dispatch_job(self, gen: int, batch, lanes, staged: dict) -> None:
        """One in-flight generation, on a pipeline thread: the fused
        dispatch under its own watchdog, then the generation-ordered
        fixpoint and wake-up. Every cell gets exactly one result or
        error, whatever raises where. ``staged`` holds the groups the
        intake thread stacked, until fuse_and_solve takes them."""
        results = None
        err: Optional[Exception] = None
        # this runs on a pipeline thread: the group ctx (every eval fused
        # into this generation) rides the batch's cells
        gctx = tracer.group([c.get("trace_ctx") for _, c in batch])
        try:
            xfer_tok = xferobs.mark()
            with tracer.activate(gctx), \
                    tracer.span("solver.fuse_dispatch", ctx=gctx,
                                generation=gen, lanes=len(lanes),
                                depth=self._depth,
                                staged="groups" in staged,
                                in_flight=pipeline_state()["in_flight"]
                                ) as sp:
                results = run_dispatch(
                    lambda: fuse_and_solve(
                        lanes, device=self._cells,
                        use_mesh=self._use_mesh,
                        e_pad_hint=self._e_pad_hint, staged=staged),
                    label="solver.batch", device=self._enter)
                sp.tag(**xferobs.span_tags(xfer_tok))
        except Exception as e:  # noqa: BLE001 -- waiters must not strand
            err = e
        finally:
            # groups nobody took (a failure before fuse_and_solve, or a
            # watchdog that gave up first; an abandoned runner then finds
            # none and stacks its own) are checked in here, once, and
            # not pooled: the dispatch failed
            left = staged.pop("groups", None)
            if left is not None:
                release_groups(left, pool=False)
        # ordered completion: generation g's ledger charges land before
        # g+1's. A started job always finishes (the watchdog bounds it),
        # so the wait ends; the deadline is a last-resort anti-wedge.
        deadline = time.monotonic() + max(
            60.0, 2.0 * _barrier_order_timeout())
        with tracer.span("solver.order_wait", ctx=gctx, generation=gen), \
                self._complete_cv:
            while self._next_complete != gen:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    _log.error("dispatch generation %d gave up waiting for "
                               "generation %d; proceeding out of order",
                               gen, self._next_complete)
                    break
                self._complete_cv.wait(remaining)
        try:
            if err is None and self._fixpoint_needed(lanes):
                try:
                    with tracer.activate(gctx), \
                            tracer.span("solver.fixpoint", ctx=gctx,
                                        generation=gen):
                        run_dispatch(
                            lambda: _cross_lane_fixpoint(
                                lanes, results, self._ledger,
                                device=self._cells[0]),
                            label="solver.batch.fixpoint",
                            device=self._enter)
                except Exception as e:  # noqa: BLE001 -- same contract
                    err = e
        finally:
            self._hint_plan_group(len(batch))
            with self._cv:
                for i, (_, cell) in enumerate(batch):
                    if err is not None:
                        cell["error"] = err
                    else:
                        cell["result"] = results[i]
                self._cv.notify_all()
            with self._complete_cv:
                if self._next_complete == gen:
                    self._next_complete = gen + 1
                self._complete_cv.notify_all()
            if schedcheck._ACTIVE:
                schedcheck.external_end()

    def _hint_plan_group(self, n: int) -> None:
        hint = self._plan_group_hint
        if hint is None or n <= 0:
            return
        try:
            hint(n)
        except Exception:  # noqa: BLE001 -- advisory only
            pass


def _barrier_order_timeout() -> float:
    """How long a pipelined generation waits for its predecessor before
    going on out of order (predecessors are watchdog-bounded, so this
    fires only on a bug)."""
    d = dispatch_deadline_s()
    return d if d > 0 else 30.0


def make_solve_hook(barrier: SolveBarrier):
    """The hook a scheduler calls instead of service.solve(service, tg,
    places, nodes, penalties): pack on the calling thread, solve at the
    barrier, materialize on the calling thread. Returns the
    TpuPlacements, or None when the task group is not eligible or, on
    CPU cells, the generation's dispatch failed (the failure is counted
    as a host fallback, and the caller's host path places the task
    group). On a card the DispatchFailed reaches the caller."""
    from .guard import DispatchFailed, host_fallback_allowed, \
        note_host_fallback

    def hook(service, tg, places, nodes, penalties):
        with tracer.span("solver.pack", tg=tg.name, places=len(places)):
            lane = service.pack(tg, places, nodes, penalties)
        if lane is None:
            return None
        try:
            res = barrier.solve(lane)
        except DispatchFailed:
            if not host_fallback_allowed(barrier.cells):
                raise
            note_host_fallback()
            return None
        # the shadow audit's sampled capture of this lane's result
        # (server/quality.py), replayed on the host in the background
        observatory.maybe_capture_audit(lane, res[0], res[1])
        with tracer.span("solver.materialize", tg=tg.name):
            return service.materialize(lane, *res)
    return hook
