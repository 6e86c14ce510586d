"""Scheduler quality and saturation observatory (port of
nomad_tpu/server/quality.py).

Telemetry says how fast the pipeline is; this module says how well it
places and where the control-plane time goes. Three coupled pieces:

1. **Streaming placement accounting** (``_PlacementAccounting``):
   per-node usage and live-alloc counts kept incrementally off the
   store's alloc-delta journal -- ``StateStore._bump`` hands every
   write's (old_alloc, new_alloc) pairs to ``store._quality_hook`` --
   and churn counters (placements, stops, preemptions, reschedules,
   completions, failures) classified from the same pairs. Derived at
   read time: a fleet fragmentation index, per-node cpu / mem
   utilization histograms, packing efficiency and placement-score
   distributions. ``parity_mismatch`` re-derives the per-node accounting
   from ``store.allocs()`` and counts the nodes that disagree (0 =
   parity; a detected drift heals itself).

2. **Sampled shadow audit** (``_ShadowAuditor``): a sample of committed
   kernel solves, chosen by a hash of the eval id (no RNG state is
   touched), is re-scored and re-solved on the host in a background
   thread: the captured lane tables go through a numpy mirror of the
   dense scan's score / select loop (binpack, job anti-affinity, the
   window select; ``_replay_lane``). It emits
   ``nomad.quality.score_drift`` (gauge) and
   ``nomad.quality.decision_mismatch`` (counter), and latches an alert
   after ``NOMAD_TPU_TORCH_QUALITY_ALERT_AFTER`` violating audits in a
   row. So the card's kernels are held against a host replay in
   production, not only in tests. Only simple lanes (no spreads,
   affinities, ports, devices, cores, preemption or distinct-*) are
   replayed; the others count into ``nomad.quality.audit_skipped``. The
   ``quality.skew`` fault point skews a captured solve's scores as
   numeric drift would, so a drill can show the alert fires.

3. **Pipeline saturation** (``_SaturationTracker``): the span stream
   (every ``tracer.record``, retained or not) folded into per-stage
   busy / wait series -- broker.wait, worker.wait, worker, pack,
   dispatch(.wait), commit(.wait) -- with a Little's-law report
   (arrival rate, mean residence, concurrency L = lambda * W, busy share
   of the window).

Knobs (read at each use):
  NOMAD_TPU_TORCH_QUALITY               0: the Server never attaches the
                                        observatory, the store's hook and
                                        the span sink stay None, the audit
                                        gates return at once (kill switch)
  NOMAD_TPU_TORCH_QUALITY_AUDIT_SAMPLE  share of evals audited (0.05)
  NOMAD_TPU_TORCH_QUALITY_AUDIT_PLACES  placements replayed an eval (256)
  NOMAD_TPU_TORCH_QUALITY_DRIFT_TOL     largest score drift (1e-3)
  NOMAD_TPU_TORCH_QUALITY_ALERT_AFTER   violating audits in a row before
                                        the alert latches (3)

The layer only reads: it never touches RNG or scheduling state.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..solver.binpack import BINPACK_MAX, MAX_SKIP, SKIP_THRESHOLD
from .telemetry import _Series, _strip_ms_keys, metrics

__all__ = ["observatory", "quality_enabled"]

# Allocation.client_terminal_status() as a set test: the delta loop
# below runs once per pair of a 64K-pair group commit under the store
# lock, where a method call per side is measurable.
_CLIENT_TERMINAL = frozenset(("complete", "failed", "lost"))


def quality_enabled() -> bool:
    """NOMAD_TPU_TORCH_QUALITY=0 is the kill switch: nothing attaches, every
    entry point is a no-op and the prior paths run bit-for-bit."""
    return os.environ.get("NOMAD_TPU_TORCH_QUALITY", "1") != "0"


def _audit_sample() -> float:
    try:
        v = float(os.environ.get("NOMAD_TPU_TORCH_QUALITY_AUDIT_SAMPLE", "0.05"))
    except ValueError:
        return 0.05
    return min(max(v, 0.0), 1.0)


def _audit_places_cap() -> int:
    """Replay cost bound: audit at most this many placements of a
    sampled eval (the greedy replay is O(places x nodes) numpy)."""
    try:
        return max(1, int(os.environ.get(
            "NOMAD_TPU_TORCH_QUALITY_AUDIT_PLACES", "256")))
    except ValueError:
        return 256


def _drift_tol() -> float:
    try:
        return float(os.environ.get("NOMAD_TPU_TORCH_QUALITY_DRIFT_TOL", "1e-3"))
    except ValueError:
        return 1e-3


def _alert_after() -> int:
    """Breaker-style threshold: consecutive violating audits before the
    alert latches (mirrors the dispatch breaker's consecutive-failure
    trip)."""
    try:
        return max(1, int(os.environ.get(
            "NOMAD_TPU_TORCH_QUALITY_ALERT_AFTER", "3")))
    except ValueError:
        return 3


def _sample_coord(eval_id: str) -> float:
    """Deterministic per-eval sampling coordinate in [0, 1): a hash,
    never a random draw (same discipline as tracing._keep_fraction --
    the scheduler's seeded shuffles must not observe RNG state)."""
    h = hashlib.blake2b(b"quality:" + eval_id.encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / float(1 << 64)


# ---------------------------------------------------------------------------
# 1. streaming placement-quality accounting
# ---------------------------------------------------------------------------

_UTIL_BUCKETS = 10


class _PlacementAccounting:
    """Per-node usage/count + churn counters, delta-maintained.

    ``note_write`` runs INSIDE the store lock (called from ``_bump``),
    so it must stay O(pairs) cheap and never call back into the store;
    everything derived (fragmentation, histograms, rates) is computed
    at read time in ``report``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            # node_id -> [used_cpu, used_mem, used_disk, live_count]
            self._used: Dict[str, List[float]] = {}
            self._churn: Dict[str, int] = {
                "placements": 0, "stops": 0, "preemptions": 0,
                "reschedules": 0, "completions": 0, "failures": 0,
                "gc_deleted": 0, "rejected_nodes": 0,
            }
            self._scores: Dict[str, _Series] = {}
            self._score_seen = 0
            self._needs_rebuild = False
            self._t0 = time.monotonic()

    # -- hot path (store lock held) ------------------------------------
    def note_write(self, tables, index: int, delta) -> None:
        """Runs inside the store lock from ``_bump``: a 64K-pair group
        commit walks this loop once per pair, so it is inlined and
        local-bound."""
        if "allocs" not in tables:
            return
        terminal = _CLIENT_TERMINAL
        with self._lock:
            used = self._used     # bound under the lock: reset() swaps it
            if delta is None:
                # a structured-delta-free alloc write (snapshot restore):
                # the incremental state is uncoverable -- rebuild lazily
                self._needs_rebuild = True
                return
            churn = self._churn
            for old, new in delta:
                # the scheduler's liveness filter (client-terminal
                # only), the same row filter AllocTable.live /
                # ProposedAllocs use
                if old is not None and \
                        old.client_status not in terminal:
                    ar = old.allocated_resources
                    cr = ar.__dict__.get("_cmp_cache") or ar.comparable()
                    e = used.get(old.node_id)
                    if e is None:
                        e = used[old.node_id] = [0.0, 0.0, 0.0, 0]
                    e[0] -= cr.cpu_shares
                    e[1] -= cr.memory_mb
                    e[2] -= cr.disk_mb
                    e[3] -= 1
                if new is None:
                    churn["gc_deleted"] += 1
                    continue
                if new.client_status not in terminal:
                    ar = new.allocated_resources
                    cr = ar.__dict__.get("_cmp_cache") or ar.comparable()
                    e = used.get(new.node_id)
                    if e is None:
                        e = used[new.node_id] = [0.0, 0.0, 0.0, 0]
                    e[0] += cr.cpu_shares
                    e[1] += cr.memory_mb
                    e[2] += cr.disk_mb
                    e[3] += 1
                if old is None:
                    # the dominant pair shape (a fresh placement):
                    # classified inline, everything else takes the
                    # out-of-line transition path
                    if new.desired_status == "run":
                        churn["placements"] += 1
                        if new.previous_allocation:
                            churn["reschedules"] += 1
                    self._score_seen += 1
                    if (self._score_seen & 15) == 0 and \
                            new.metrics.scores:
                        self._sample_scores(new)
                else:
                    self._classify_transition(old, new)

    def _sample_scores(self, new) -> None:
        """Per-scorer distributions off the alloc's attached scores
        ("node-id.scorer" keys), sampled 1 in 16 by the caller: a
        systematic sample draws the same distribution at a sixteenth
        of the cost."""
        for key, v in new.metrics.scores.items():
            name = key.rsplit(".", 1)[-1]
            s = self._scores.get(name)
            if s is None:
                s = self._scores[name] = _Series()
            s.add(float(v))

    def _classify_transition(self, old, new) -> None:
        c = self._churn
        if old.desired_status == "run" and \
                new.desired_status in ("stop", "evict"):
            c["stops"] += 1
            if new.desired_status == "evict" or \
                    new.preempted_by_allocation:
                c["preemptions"] += 1
        if old.client_status != new.client_status:
            if new.client_status == "complete":
                c["completions"] += 1
            elif new.client_status in ("failed", "lost"):
                c["failures"] += 1

    def note_scores_bulk(self, scores) -> None:
        """Final solved placement scores (kernel path), sampled at the
        audit rate -- one lock for the lane's whole score vector."""
        with self._lock:
            s = self._scores.get("placement")
            if s is None:
                s = self._scores["placement"] = _Series()
            for v in scores:
                s.add(float(v))

    def note_rejected(self, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self._churn["rejected_nodes"] += n

    # -- wholesale recompute + parity gate ------------------------------
    @staticmethod
    def _fold_store(store) -> Dict[str, List[float]]:
        fresh: Dict[str, List[float]] = {}
        for a in store.allocs():
            if a.client_terminal_status():
                continue
            cr = a.allocated_resources.comparable()
            e = fresh.setdefault(a.node_id, [0.0, 0.0, 0.0, 0])
            e[0] += cr.cpu_shares
            e[1] += cr.memory_mb
            e[2] += cr.disk_mb
            e[3] += 1
        return fresh

    def rebuild(self, store) -> None:
        fresh = self._fold_store(store)
        with self._lock:
            self._used = fresh
            self._needs_rebuild = False

    def parity_mismatch(self, store, atol: float = 1e-6) -> int:
        """Compare the delta-maintained per-node accounting against a
        from-scratch fold over the store; returns the number of
        disagreeing nodes (0 = parity).  The fresh fold replaces the
        resident state, so detected drift self-heals."""
        fresh = self._fold_store(store)
        with self._lock:
            bad = 0
            for nid in set(self._used) | set(fresh):
                a = self._used.get(nid, [0.0, 0.0, 0.0, 0])
                b = fresh.get(nid, [0.0, 0.0, 0.0, 0])
                if a[3] != b[3] or any(
                        abs(a[i] - b[i]) > atol for i in range(3)):
                    bad += 1
            self._used = fresh
            self._needs_rebuild = False
            return bad

    # -- read side ------------------------------------------------------
    def report(self, store) -> dict:
        if store is None:
            return {"attached": False}
        with self._lock:
            needs = self._needs_rebuild
        if needs:
            self.rebuild(store)
        nodes = store.nodes()
        with self._lock:
            used = {nid: list(v) for nid, v in self._used.items()}
            churn = dict(self._churn)
            # scores are unitless: strip the _ms suffixes the shared
            # series snapshot carries (same move the gauge surface makes)
            scores = {k: _strip_ms_keys(s.snapshot())
                      for k, s in self._scores.items()}
            elapsed = max(time.monotonic() - self._t0, 1e-9)

        n = len(nodes)
        cap_cpu = np.zeros(n)
        cap_mem = np.zeros(n)
        u_cpu = np.zeros(n)
        u_mem = np.zeros(n)
        counts = np.zeros(n, dtype=np.int64)
        ready = 0
        for k, node in enumerate(nodes):
            nr, rr = node.node_resources, node.reserved_resources
            cap_cpu[k] = max(nr.cpu.cpu_shares - rr.cpu_shares, 0)
            cap_mem[k] = max(nr.memory.memory_mb - rr.memory_mb, 0)
            if node.ready():
                ready += 1
            e = used.get(node.id)
            if e is not None:
                u_cpu[k], u_mem[k], counts[k] = e[0], e[1], e[3]

        with np.errstate(divide="ignore", invalid="ignore"):
            util_cpu = np.clip(
                np.where(cap_cpu > 0, u_cpu / np.maximum(cap_cpu, 1e-9),
                         0.0), 0.0, 1.0)
            util_mem = np.clip(
                np.where(cap_mem > 0, u_mem / np.maximum(cap_mem, 1e-9),
                         0.0), 0.0, 1.0)

        # Fragmentation: free capacity is consumable only at the rate of
        # a node's MOST-constrained dimension; the rest is stranded.
        # 0 = every node's free cpu/mem fractions are balanced,
        # -> 1 = free capacity exists but is unusable for mixed asks
        # (one dimension exhausted while the other idles).
        free_cpu = 1.0 - util_cpu
        free_mem = 1.0 - util_mem
        usable = np.minimum(free_cpu, free_mem)
        free_any = np.maximum(free_cpu, free_mem)
        w = (np.where(cap_cpu.sum() > 0, cap_cpu / max(cap_cpu.sum(), 1e-9),
                      0.0)
             + np.where(cap_mem.sum() > 0,
                        cap_mem / max(cap_mem.sum(), 1e-9), 0.0)) / 2.0
        denom = float((free_any * w).sum())
        frag = 1.0 - float((usable * w).sum()) / denom if denom > 1e-12 \
            else 0.0

        # Packing efficiency: how full the OCCUPIED nodes run (1.0 =
        # perfectly consolidated; low = live allocs smeared thin).
        occ = counts > 0
        pack_cpu = float(u_cpu[occ].sum() / max(cap_cpu[occ].sum(), 1e-9)) \
            if occ.any() else 0.0
        pack_mem = float(u_mem[occ].sum() / max(cap_mem[occ].sum(), 1e-9)) \
            if occ.any() else 0.0

        def hist(u):
            h, _ = np.histogram(u, bins=_UTIL_BUCKETS, range=(0.0, 1.0))
            return [int(x) for x in h]

        def summ(u):
            if not u.size:
                return {"mean": 0.0, "p50": 0.0, "p90": 0.0, "max": 0.0,
                        "hist": [0] * _UTIL_BUCKETS}
            s = np.sort(u)
            return {"mean": round(float(u.mean()), 4),
                    "p50": round(float(s[len(s) // 2]), 4),
                    "p90": round(float(s[min(len(s) - 1,
                                             int(len(s) * 0.9))]), 4),
                    "max": round(float(u.max()), 4),
                    "hist": hist(u)}

        return {
            "attached": True,
            "since_s": round(elapsed, 1),
            "fleet": {"nodes": n, "ready": ready,
                      "occupied": int(occ.sum()),
                      "live_allocs": int(counts.sum())},
            "fragmentation_index": round(frag, 4),
            "packing_efficiency": {"cpu": round(pack_cpu, 4),
                                   "mem": round(pack_mem, 4)},
            "utilization": {"cpu": summ(util_cpu), "mem": summ(util_mem)},
            "churn": dict(churn, per_s={
                k: round(v / elapsed, 3) for k, v in churn.items()}),
            "scores": scores,
        }


# ---------------------------------------------------------------------------
# 2. sampled shadow-oracle audit
# ---------------------------------------------------------------------------

class _AuditItem:
    """One captured kernel solve, self-contained for background replay."""

    __slots__ = ("eval_id", "job_id", "tg_name", "node_ids", "order",
                 "cpu_cap", "mem_cap", "disk_cap", "feasible",
                 "used_cpu", "used_mem", "used_disk", "placed",
                 "ask_cpu", "ask_mem", "ask_disk", "count", "limit",
                 "spread_alg", "chosen", "scores", "skewed", "lpq")


def _lane_simple(lane) -> bool:
    """Only lanes the numpy mirror models exactly are replayable: pure
    cpu/mem/disk binpack + job anti-affinity + window select."""
    c, b = lane.const, lane.batch
    return (lane.ptab is None
            and c.spread_vidx.shape[0] == 0
            and c.dp_vidx.shape[0] == 0
            and c.dev_aff.shape[0] == 0
            and c.mhz_per_core.shape[0] == 0
            and not bool(c.has_affinity)
            and not bool(c.distinct_hosts)
            and b.ask_cores.shape[0] == 0
            and int(np.asarray(b.n_dyn_ports)[0]) == 0
            and not bool(np.asarray(b.has_static)[0])
            and bool((np.asarray(b.penalty_idx) < 0).all()))


def _replay_lane(item: _AuditItem, follow: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy mirror of the dense scan's per-placement score / select
    loop for simple lanes (the port's solver/scoring.py and the window
    select of solver/dense.py):
    fit gate, BestFit-v3 binpack score, job anti-affinity, limit-window
    select with low-score skips, greedy usage carry.  ``follow`` makes
    it a RE-SCORE pass (apply the kernel's choices, return the host's
    score for each); without it, an independent RE-SOLVE."""

    cpu_cap = item.cpu_cap.astype(np.float64)
    mem_cap = item.mem_cap.astype(np.float64)
    disk_cap = item.disk_cap.astype(np.float64)
    feas = item.feasible
    used_cpu = item.used_cpu.astype(np.float64).copy()
    used_mem = item.used_mem.astype(np.float64).copy()
    used_disk = item.used_disk.astype(np.float64).copy()
    placed = item.placed.astype(np.float64).copy()
    count = max(float(item.count), 1.0)
    limit = int(item.limit)
    P = len(item.chosen) if follow is None else len(follow)
    chosen_out = np.full(P, -1, dtype=np.int64)
    scores_out = np.zeros(P, dtype=np.float64)
    big = np.iinfo(np.int64).max

    for p in range(P):
        new_cpu = used_cpu + item.ask_cpu
        new_mem = used_mem + item.ask_mem
        new_disk = used_disk + item.ask_disk
        free_cpu = 1.0 - new_cpu / np.maximum(cpu_cap, 1e-9)
        free_mem = 1.0 - new_mem / np.maximum(mem_cap, 1e-9)
        total = np.power(10.0, free_cpu) + np.power(10.0, free_mem)
        raw = (total - 2.0) if item.spread_alg else (20.0 - total)
        binpack = np.clip(raw, 0.0, BINPACK_MAX) / BINPACK_MAX
        coll = placed > 0
        anti = np.where(coll, -(placed + 1.0) / count, 0.0)
        final = (binpack + anti) / (1.0 + coll.astype(np.float64))

        if follow is not None:
            pos = int(follow[p])
            if pos >= 0:
                chosen_out[p] = pos
                scores_out[p] = final[pos]
                used_cpu[pos] += item.ask_cpu
                used_mem[pos] += item.ask_mem
                used_disk[pos] += item.ask_disk
                placed[pos] += 1
            continue

        fit = (feas & (new_cpu <= cpu_cap) & (new_mem <= mem_cap)
               & (new_disk <= disk_cap))
        low = fit & (final <= SKIP_THRESHOLD)
        skip_rank = np.cumsum(low.astype(np.int64))
        skipped = low & (skip_rank <= MAX_SKIP)
        counted = fit & ~skipped
        cpos = np.cumsum(counted.astype(np.int64))
        total_counted = int(cpos[-1]) if cpos.size else 0
        window = counted & (cpos <= limit)
        deficit = max(0, limit - min(total_counted, limit))
        srank = np.cumsum(skipped.astype(np.int64))
        fallback = skipped & (srank <= deficit)
        yielded = window | fallback
        if not yielded.any():
            continue
        order_key = np.where(window, cpos, limit + srank)
        eff = np.where(yielded, final, -np.inf)
        is_best = yielded & (eff == eff.max())
        pos = int(np.where(is_best, order_key, big).argmin())
        chosen_out[p] = pos
        scores_out[p] = final[pos]
        used_cpu[pos] += item.ask_cpu
        used_mem[pos] += item.ask_mem
        used_disk[pos] += item.ask_disk
        placed[pos] += 1
    return chosen_out, scores_out


class _ShadowAuditor:
    """Bounded capture queue + one daemon replay thread + breaker-style
    alert state."""

    _QUEUE_CAP = 32
    _RESULTS_CAP = 256

    def __init__(self):
        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._thread: Optional[threading.Thread] = None
        self._idle = threading.Event()
        self._idle.set()
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._results: "OrderedDict[str, dict]" = OrderedDict()
            self._audited = 0
            self._skipped = 0
            self._dropped = 0
            self._mismatch_total = 0
            self._drift_max = 0.0
            self._consecutive_bad = 0
            self._alert: Optional[dict] = None
        with self._cv:
            self._queue.clear()

    # -- capture (solve thread) ----------------------------------------
    def wants(self, eval_id: str) -> bool:
        return _sample_coord(eval_id) < _audit_sample()

    def capture(self, lane, chosen, scores, lpq: bool = False) -> bool:
        """Snapshot one solved lane for background audit.  Called on the
        eval thread AFTER the dispatch returned, for already-sampled
        evals (the caller gates on ``wants``); must stay cheap -- array
        copies only, bounded queue, drop (never block) when full."""
        eval_id = lane.service.ctx.plan.eval_id
        if not _lane_simple(lane):
            with self._lock:
                self._skipped += 1
            metrics.incr("nomad.quality.audit_skipped")
            return False
        item = _AuditItem()
        item.eval_id = eval_id
        item.job_id = lane.service.job.id
        item.tg_name = lane.tg.name
        item.node_ids = tuple(n.id for n in lane.nodes)
        item.order = np.asarray(lane.order, dtype=np.int64).copy()
        item.cpu_cap = np.asarray(lane.const.cpu_cap)
        item.mem_cap = np.asarray(lane.const.mem_cap)
        item.disk_cap = np.asarray(lane.const.disk_cap)
        item.feasible = np.asarray(lane.const.feasible)
        item.used_cpu = np.asarray(lane.init.used_cpu).copy()
        item.used_mem = np.asarray(lane.init.used_mem).copy()
        item.used_disk = np.asarray(lane.init.used_disk).copy()
        item.placed = np.asarray(lane.init.placed).copy()
        b = lane.batch
        item.ask_cpu = float(np.asarray(b.ask_cpu)[0])
        item.ask_mem = float(np.asarray(b.ask_mem)[0])
        item.ask_disk = float(np.asarray(b.ask_disk)[0])
        item.count = int(np.asarray(b.count)[0])
        item.limit = int(np.asarray(b.limit)[0])
        item.spread_alg = bool(lane.spread_alg)
        item.lpq = lpq
        cap = _audit_places_cap()
        item.chosen = np.asarray(chosen, dtype=np.int64)[:cap].copy()
        item.scores = np.asarray(scores, dtype=np.float64)[:cap].copy()
        item.skewed = False
        # drill: an armed `quality.skew` fault corrupts the
        # captured solve's scores the way real solver numerics drift
        # would -- the audit below must catch it
        from ..faultinject import InjectedFault, faults
        try:
            faults.fire("quality.skew")
        except InjectedFault:
            item.skewed = True
            item.scores = item.scores + 0.25
        with self._cv:
            if len(self._queue) >= self._QUEUE_CAP:
                with self._lock:
                    self._dropped += 1
                return False
            self._queue.append(item)
            self._idle.clear()
            self._ensure_thread()
            self._cv.notify()
        return True

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="quality-audit")
            self._thread.start()

    # -- replay (background) -------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue:
                    self._idle.set()
                    self._cv.wait(1.0)
                item = self._queue.popleft()
            try:
                self._audit(item)
            except Exception:  # noqa: BLE001 -- audit must never kill
                with self._lock:
                    self._skipped += 1

    def _audit(self, item: _AuditItem) -> None:
        # re-score: follow the kernel's choices, host math
        _, host_scores = _replay_lane(item, follow=item.chosen)
        ok = item.chosen >= 0
        drift = float(np.abs(host_scores[ok] - item.scores[ok]).max()) \
            if ok.any() else 0.0
        # re-solve: independent host greedy, compare decisions
        re_chosen, _ = _replay_lane(item)
        mismatches = int((re_chosen != item.chosen).sum())
        first_bad = int(np.argmax(re_chosen != item.chosen)) \
            if mismatches else -1

        tol = _drift_tol()
        lpq = bool(getattr(item, "lpq", False))
        # LP-queue solves: the joint relaxation is meant to diverge
        # from the greedy per-eval oracle (global vs order-dependent
        # packing) -- divergence is informational, score fidelity still
        # gates (the LP tier reports host-formula scores, so real drift
        # means broken score math, not a different optimum)
        violating = drift > tol or (mismatches > 0 and not lpq)
        metrics.sample("nomad.quality.score_drift", drift)
        metrics.incr("nomad.quality.audit_total")
        if mismatches:
            metrics.incr("nomad.quality.lpq_divergence" if lpq
                         else "nomad.quality.decision_mismatch",
                         mismatches)

        res = {
            "eval_id": item.eval_id, "job_id": item.job_id,
            "tg": item.tg_name, "places": len(item.chosen),
            "score_drift": round(drift, 9),
            "decision_mismatches": 0 if lpq else mismatches,
            "greedy_divergence": mismatches if lpq else 0,
            "lpq": lpq,
            "first_mismatch_place": first_bad,
            "skew_injected": item.skewed,
            "violating": violating,
        }
        if mismatches and first_bad >= 0:
            def nid(pos):
                return (item.node_ids[item.order[pos]]
                        if 0 <= pos < len(item.order) else None)
            res["tpu_node"] = nid(int(item.chosen[first_bad]))
            res["oracle_node"] = nid(int(re_chosen[first_bad]))

        with self._lock:
            self._audited += 1
            if not lpq:
                self._mismatch_total += mismatches
            self._drift_max = max(self._drift_max, drift)
            if violating:
                self._consecutive_bad += 1
                if self._alert is None and \
                        self._consecutive_bad >= _alert_after():
                    self._alert = {
                        "at_audit": self._audited,
                        "reason": ("decision_mismatch" if mismatches
                                   else "score_drift"),
                        "drift": round(drift, 9),
                        "eval_id": item.eval_id,
                    }
                    metrics.incr("nomad.quality.audit_alert")
            else:
                self._consecutive_bad = 0
            self._results[item.eval_id] = res
            while len(self._results) > self._RESULTS_CAP:
                self._results.popitem(last=False)

    # -- read side ------------------------------------------------------
    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Block until the capture queue drained (tests)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cv:
                empty = not self._queue
            if empty and self._idle.wait(0.05):
                return True
        return False

    def report(self) -> dict:
        with self._lock:
            recent = list(self._results.values())[-10:]
            return {
                "sample_rate": _audit_sample(),
                "drift_tol": _drift_tol(),
                "alert_after": _alert_after(),
                "audited": self._audited,
                "skipped_complex": self._skipped,
                "dropped_backlog": self._dropped,
                "score_drift_max": round(self._drift_max, 9),
                "decision_mismatch_total": self._mismatch_total,
                "consecutive_violations": self._consecutive_bad,
                "alert": self._alert,
                "recent": recent,
            }

    def results(self) -> Dict[str, dict]:
        with self._lock:
            return dict(self._results)


# ---------------------------------------------------------------------------
# 3. pipeline saturation attribution
# ---------------------------------------------------------------------------

# span name -> (stage, kind). Spans recorded under a group ctx (one
# fused dispatch serving 32 evals) hit the sink ONCE, so stage busy
# time is wall time spent in the stage, not eval-weighted time.
_STAGE_OF: Dict[str, Tuple[str, str]] = {
    "broker.wait": ("broker.wait", "wait"),
    "worker.wait_for_index": ("worker.wait", "wait"),
    "worker.invoke": ("worker", "busy"),
    "sched.feasibility_rank": ("worker", "busy"),
    "solver.pack": ("pack", "busy"),
    "solver.materialize": ("pack", "busy"),
    "solver.barrier": ("dispatch.wait", "wait"),
    "solver.order_wait": ("dispatch.wait", "wait"),
    "solver.fuse_dispatch": ("dispatch", "busy"),
    "solver.dispatch": ("dispatch", "busy"),
    "solver.dispatch_solo": ("dispatch", "busy"),
    "solver.constcache": ("dispatch", "busy"),
    "solver.fixpoint": ("dispatch", "busy"),
    # transfer-vs-compute split (solver/xferobs.py): the transfer model's
    # predicted copy share of each dispatch vs the remainder -- the
    # dispatch stage decomposed into copy time and kernel time
    "solver.xfer_transfer": ("dispatch.transfer", "busy"),
    "solver.xfer_compute": ("dispatch.compute", "busy"),
    "plan.submit": ("commit.wait", "wait"),
    "plan.evaluate": ("commit", "busy"),
    "plan.commit": ("commit", "busy"),
}


class _SaturationTracker:
    """Streaming per-stage busy/wait histograms off the span stream."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._stages: Dict[str, _Series] = {}
            self._kind: Dict[str, str] = {}
            self._t0 = time.monotonic()

    def note_span(self, name: str, dur_ms: float) -> None:
        ent = _STAGE_OF.get(name)
        if ent is None:
            return
        stage, kind = ent
        with self._lock:
            s = self._stages.get(stage)
            if s is None:
                s = self._stages[stage] = _Series()
                self._kind[stage] = kind
            s.add(dur_ms)

    def report(self) -> dict:
        with self._lock:
            elapsed_s = max(time.monotonic() - self._t0, 1e-9)
            stages = {}
            busy_total_ms = 0.0
            all_total_ms = 0.0
            for stage, s in self._stages.items():
                snap = s.snapshot()
                total_ms = s.total
                all_total_ms += total_ms
                if self._kind[stage] == "busy":
                    busy_total_ms += total_ms
                lam = s.count / elapsed_s            # arrivals/s
                w_ms = snap["mean_ms"]
                stages[stage] = {
                    "kind": self._kind[stage],
                    "count": s.count,
                    "total_ms": round(total_ms, 3),
                    "mean_ms": round(w_ms, 3),
                    "p50_ms": round(snap.get("p50_ms", 0.0), 3),
                    "p99_ms": round(snap.get("p99_ms", 0.0), 3),
                    # Little's law: L = lambda * W -- the stage's mean
                    # concurrency (how many evals live in it at once)
                    "arrival_per_s": round(lam, 2),
                    "littles_l": round(lam * w_ms / 1e3, 3),
                    "busy_pct": round(100.0 * total_ms
                                      / (elapsed_s * 1e3), 2),
                }
        for stage, d in stages.items():
            d["share_of_recorded_pct"] = round(
                100.0 * d["total_ms"] / all_total_ms, 2) \
                if all_total_ms > 0 else 0.0
        bottleneck = None
        if stages:
            busy = {k: v for k, v in stages.items() if v["kind"] == "busy"}
            pool = busy or stages
            bottleneck = max(pool, key=lambda k: pool[k]["littles_l"])
        return {
            "window_s": round(elapsed_s, 1),
            "stages": stages,
            "bottleneck": bottleneck,
            # the control-plane tax decomposition: the share of all
            # recorded pipeline time each stage holds (wait stages
            # included -- queueing IS the tax)
            "busy_total_ms": round(busy_total_ms, 3),
        }


# ---------------------------------------------------------------------------
# the observatory
# ---------------------------------------------------------------------------

class QualityObservatory:
    """Process-global facade wiring the three trackers to a Server's
    store + the tracer's span stream.  ``attach`` binds the most
    recently started Server (like the process-global tracer/metrics);
    ``detach`` on shutdown unbinds only if still attached to that
    store, so overlapping servers in one process can't clear each
    other's live accounting."""

    def __init__(self):
        self.placement = _PlacementAccounting()
        self.audit = _ShadowAuditor()
        self.saturation = _SaturationTracker()
        self._store_ref = None
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return self._store_ref is not None and \
            self._store_ref() is not None

    def _store(self):
        ref = self._store_ref
        return ref() if ref is not None else None

    def attach(self, store) -> None:
        if not quality_enabled():
            return
        from . import tracing
        with self._lock:
            self.placement.reset()
            self.placement.rebuild(store)
            self.saturation.reset()
            self.audit.reset()
            store._quality_hook = self.placement.note_write
            self._store_ref = weakref.ref(store)
            tracing.set_span_sink(self.saturation.note_span)

    def detach(self, store=None) -> None:
        from . import tracing
        with self._lock:
            cur = self._store()
            if store is not None and cur is not None and cur is not store:
                # another server attached after us: only drop our hook
                if getattr(store, "_quality_hook", None) is \
                        self.placement.note_write:
                    store._quality_hook = None
                return
            if cur is not None:
                cur._quality_hook = None
            self._store_ref = None
            tracing.set_span_sink(None)

    # -- capture entry points (hot-path gates first) --------------------
    def maybe_capture_audit(self, lane, chosen, scores,
                            lpq: bool = False) -> None:
        """Offer one solved lane (chosen positions + scores) for the
        shadow audit + score-distribution sampling.  Deterministic
        eval-id-hash sample: identical runs audit identical evals.
        ``lpq`` marks LP-queue-tier solves: score drift still gates,
        but divergence from the greedy re-solve is the tier's PURPOSE
        (global vs order-dependent packing) -- counted separately in
        ``nomad.quality.lpq_divergence``, never into the alert."""
        if not quality_enabled() or not self.active:
            return
        try:
            eval_id = lane.service.ctx.plan.eval_id
            if not self.audit.wants(eval_id):
                return
            ch = np.asarray(chosen, dtype=np.int64)
            sc = np.asarray(scores, dtype=np.float64)
            ok = ch >= 0
            if ok.any():
                self.placement.note_scores_bulk(sc[ok])
            self.audit.capture(lane, ch, sc, lpq=lpq)
        except Exception:  # noqa: BLE001 -- observability only
            pass

    def note_rejected(self, n: int) -> None:
        if not quality_enabled() or not self.active:
            return
        self.placement.note_rejected(n)

    # -- read side ------------------------------------------------------
    def report(self) -> dict:
        if not quality_enabled():
            return {"enabled": False}
        store = self._store()
        out = {
            "enabled": True,
            "attached": store is not None,
            "placement": self.placement.report(store),
            "audit": self.audit.report(),
            "saturation": self.saturation.report(),
        }
        # feed the headline gauges so the metrics registry (and a
        # statsd sink) carry their series without a separate poller
        p = out["placement"]
        if p.get("attached"):
            metrics.sample("nomad.quality.fragmentation",
                           p["fragmentation_index"])
            metrics.sample("nomad.quality.packing_efficiency",
                           p["packing_efficiency"]["cpu"])
        return out

    def parity_mismatch(self) -> int:
        store = self._store()
        if store is None:
            return 0
        return self.placement.parity_mismatch(store)

    def bench_fields(self) -> dict:
        """Flat fields for a benchmark's result line:
        quality_fragmentation, quality_drift, quality_decision_mismatch,
        stage_busy_pct_*."""
        rep = self.report()
        if not rep.get("enabled"):
            return {"quality_enabled": False}
        out = {"quality_enabled": True}
        p = rep["placement"]
        if p.get("attached"):
            out["quality_fragmentation"] = p["fragmentation_index"]
            out["quality_packing_efficiency"] = \
                p["packing_efficiency"]["cpu"]
            out["quality_live_allocs"] = p["fleet"]["live_allocs"]
        a = rep["audit"]
        out["quality_drift"] = a["score_drift_max"]
        out["quality_decision_mismatch"] = a["decision_mismatch_total"]
        out["quality_audited"] = a["audited"]
        sat = rep["saturation"]
        out["stage_bottleneck"] = sat["bottleneck"]
        for stage, d in sat["stages"].items():
            key = "stage_busy_pct_" + stage.replace(".", "_")
            out[key] = d["busy_pct"]
        return out

    def _reset_for_tests(self) -> None:
        self.detach()
        self.placement.reset()
        self.audit.reset()
        self.saturation.reset()


# The process-global observatory, like telemetry.metrics / tracing.tracer.
observatory = QualityObservatory()
