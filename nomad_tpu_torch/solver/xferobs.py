"""Transfer and device-residency ledger (port of
nomad_tpu/solver/xferobs.py): the bytes every dispatch moves.

Four coupled pieces:

1. **Per-dispatch payload ledger** (``_Ledger``): every host->device copy
   the dispatch stack makes is attributed to a tree group -- ``const``
   (fleet tables), ``init`` (usage columns), ``batch`` (per-placement
   asks), ``ptab`` / ``pinit`` (preemption tables), ``compact`` (the
   wave kernels' compact tables), ``mesh`` (the grid route's puts),
   ``delta`` (the version chain's scatter payloads), ``system`` (the
   system fit's one staged upload) and ``lpq`` (the LP relaxation's
   inputs) -- and split into *shipped* (bytes that crossed to the card)
   and *resident* (resident-set hits served from buffers already on the
   card). Bytes read back ride the same records under the fetch site's
   tag. ``note_shipped`` mirrors every ``nomad.solver.dispatch_bytes_total``
   increment, and ``parity()`` (tagged sum minus the mirror) must be 0:
   anything else means a transport shipped bytes the decomposition
   missed.

2. **Device-residency map**: per resident-buffer bytes, version, age and
   hits (solver/resident.py ``residency()``), and a resident-bytes
   high-watermark kept here.

3. **Transfer model** (``_TunnelModel``): a streaming least-squares fit
   of ``wall_ms = rtt + bytes / bandwidth`` over per-dispatch (payload
   bytes, wall ms) pairs, leaving out samples over 1 s. On the card the
   "tunnel" is the host<->device copy path; a dispatch's wall time ends
   after its results were read back, so the fit sees the copies, the
   kernels and the host work of the dispatch, not the enqueue.
   Reported as ``xfer_rtt_ms`` / ``xfer_bw_mbps`` with the sample count,
   the RMS residual and the payload at which transfer time equals the
   round trip.

4. **Transfer/compute split**: once the fit is warm, each dispatch
   records ``solver.xfer_transfer`` / ``solver.xfer_compute`` spans (the
   model's transfer share and the rest) into the eval trace and the
   saturation attribution (server/quality.py).

Knobs (read at each use):
  NOMAD_TPU_TORCH_XFEROBS       0 turns every entry point into a no-op
                                (kill switch; the prior paths bit for bit)
  NOMAD_TPU_TORCH_XFEROBS_RING  per-dispatch records kept (256)
"""
from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = [
    "enabled", "note_payload", "note_shipped", "note_fetch",
    "note_resident_level", "note_shard_bytes", "begin_dispatch",
    "end_dispatch", "mark", "span_tags", "tree_nbytes", "state",
    "parity", "shard_parity", "bench_fields", "counter_events",
    "residency_report",
]

# dispatches slower than this (the threshold solver/batch.py tags as
# slow: first launches, host-heavy generations) are not transfers: they
# would poison the transfer fit with seconds-long outliers
_SLOW_COMPILE_MS = 1000.0

# the tunnel fit is not reported (and the split spans not recorded)
# until it has seen this many clean samples
_FIT_MIN_SAMPLES = 8


def enabled() -> bool:
    """NOMAD_TPU_TORCH_XFEROBS=0 is the kill switch: every entry point is a
    no-op and the prior paths run bit-for-bit."""
    return os.environ.get("NOMAD_TPU_TORCH_XFEROBS", "1") != "0"


def _ring_cap() -> int:
    try:
        return max(8, int(os.environ.get("NOMAD_TPU_TORCH_XFEROBS_RING",
                                         "256")))
    except ValueError:
        return 256


def tree_nbytes(x) -> int:
    """Total nbytes over a (possibly nested) structure of arrays or
    tensors -- the fetch sites hand their read-back results straight
    in."""
    import numpy as np
    if hasattr(x, "nbytes"):
        return int(x.nbytes)
    if hasattr(x, "element_size") and hasattr(x, "numel"):
        return int(x.element_size() * x.numel())
    if isinstance(x, dict):
        return sum(tree_nbytes(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return sum(tree_nbytes(v) for v in x)
    try:
        return int(np.asarray(x).nbytes)
    except Exception:  # noqa: BLE001 -- accounting only, never raise
        return 0


class _TunnelModel:
    """Streaming least-squares fit of wall_ms = rtt_ms + bytes*slope
    (slope = ms per byte, reported as MB/s bandwidth).  Running sums
    only -- O(1) per sample, no sample retention."""

    __slots__ = ("n", "sx", "sy", "sxx", "sxy", "syy", "skipped_slow")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.sx = self.sy = self.sxx = self.sxy = self.syy = 0.0
        self.skipped_slow = 0

    def add(self, nbytes: float, ms: float) -> None:
        if ms > _SLOW_COMPILE_MS:
            self.skipped_slow += 1
            return
        self.n += 1
        self.sx += nbytes
        self.sy += ms
        self.sxx += nbytes * nbytes
        self.sxy += nbytes * ms
        self.syy += ms * ms

    def coeffs(self) -> Optional[tuple]:
        """(rtt_ms, ms_per_byte) without the full report dict -- the
        per-dispatch hot path's shape (fit() is the read side)."""
        if self.n < 2:
            return None
        n = float(self.n)
        var = self.sxx - self.sx * self.sx / n
        cov = self.sxy - self.sx * self.sy / n
        if var <= 1e-9:
            # byte sizes never varied: no slope is identifiable; the
            # mean wall time is the whole model (pure RTT readout)
            slope = 0.0
        else:
            slope = max(cov / var, 0.0)
        rtt = max((self.sy - slope * self.sx) / n, 0.0)
        return rtt, slope

    def fit(self) -> Optional[dict]:
        co = self.coeffs()
        if co is None:
            return None
        rtt, slope = co
        n = float(self.n)
        sse = max(self.syy - rtt * self.sy - slope * self.sxy, 0.0)
        bw_mbps = (1e3 / slope) / 1e6 if slope > 0 else None
        out = {
            "rtt_ms": round(rtt, 3),
            "bw_mbps": round(bw_mbps, 3) if bw_mbps is not None
            else None,
            "ms_per_byte": slope,
            "samples": self.n,
            "skipped_slow": self.skipped_slow,
            "residual_rms_ms": round(math.sqrt(sse / n), 3),
            # payload-vs-RTT crossover: the byte size whose transfer
            # time equals the round trip
            "crossover_bytes": int(rtt / slope) if slope > 0 else None,
        }
        return out

    def predict_ms(self, nbytes: float) -> Optional[float]:
        f = self.fit()
        if f is None or self.n < _FIT_MIN_SAMPLES:
            return None
        return f["rtt_ms"] + f["ms_per_byte"] * nbytes


class _Ledger:
    """Process-global byte accounting. One lock; every hot-path entry
    is a few dict updates per dispatch."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            # group -> [shipped_bytes, resident_bytes,
            #           shipped_arrays, resident_arrays]
            self._groups: Dict[str, List[int]] = {}
            # per-shard rows: group -> cell label -> [declared_bytes,
            # actual_bytes] -- declared from the cut the grid's spec
            # gives a cell, actual from the slice the cell holds;
            # shard_parity() is the zero-tolerance reconciliation
            # between them
            self._shard_rows: Dict[str, Dict[str, List[int]]] = {}
            # fetch tag -> [bytes, fetches]
            self._fetches: Dict[str, List[int]] = {}
            self._shipped_mirror = 0   # note_shipped reconciliation base
            self._dispatches = 0
            self._seq = 0
            self._ring: deque = deque()
            self._resident_level = 0
            self._resident_hwm = 0
            self.tunnel = _TunnelModel()

    # -- hot path -------------------------------------------------------
    def _rec(self) -> Optional[dict]:
        return getattr(self._tls, "rec", None)

    def note_payload(self, group: str, nbytes: int,
                     resident: bool) -> None:
        nbytes = int(nbytes)
        rec = self._rec()
        if rec is not None:
            # record-deferred: folded into the global groups under ONE
            # lock at end_dispatch (which solve_groups guarantees runs,
            # error paths included) instead of a lock per array
            b = rec["bytes"].setdefault(group, [0, 0, 0, 0])
            if resident:
                b[1] += nbytes
                b[3] += 1
            else:
                b[0] += nbytes
                b[2] += 1
            return
        with self._lock:
            self._fold_group_locked(group, nbytes, resident)

    def _fold_group_locked(self, group: str, nbytes: int,
                           resident: bool) -> None:
        g = self._groups.get(group)
        if g is None:
            g = self._groups[group] = [0, 0, 0, 0]
        if resident:
            g[1] += nbytes
            g[3] += 1
        else:
            g[0] += nbytes
            g[2] += 1

    def note_shipped(self, n: int) -> None:
        with self._lock:
            self._shipped_mirror += int(n)

    def note_fetch(self, nbytes: int, group: str) -> None:
        nbytes = int(nbytes)
        rec = self._rec()
        if rec is not None:
            rec["fetched"] += nbytes
            f = rec["fetch_tags"].setdefault(group, [0, 0])
            f[0] += nbytes
            f[1] += 1
            return
        with self._lock:
            f = self._fetches.get(group)
            if f is None:
                f = self._fetches[group] = [0, 0]
            f[0] += nbytes
            f[1] += 1

    def note_resident_level(self, nbytes: int) -> None:
        with self._lock:
            self._resident_level = int(nbytes)
            if nbytes > self._resident_hwm:
                self._resident_hwm = int(nbytes)

    def note_shard_bytes(self, group: str, device: str,
                         declared: int, actual: int) -> None:
        with self._lock:
            rows = self._shard_rows.get(group)
            if rows is None:
                rows = self._shard_rows[group] = {}
            row = rows.get(device)
            if row is None:
                row = rows[device] = [0, 0]
            row[0] += int(declared)
            row[1] += int(actual)

    def shard_parity(self) -> int:
        with self._lock:
            return sum(abs(row[0] - row[1])
                       for rows in self._shard_rows.values()
                       for row in rows.values())

    # -- dispatch records -----------------------------------------------
    def begin_dispatch(self, **meta) -> None:
        self._tls.rec = {"t0": time.time(), "bytes": {}, "fetched": 0,
                         "fetch_tags": {}, "meta": meta}

    def end_dispatch(self, dur_ms: float) -> Optional[dict]:
        rec = self._rec()
        if rec is None:
            return None
        self._tls.rec = None
        shipped = sum(b[0] for b in rec["bytes"].values())
        resident = sum(b[1] for b in rec["bytes"].values())
        payload = shipped + rec["fetched"]
        with self._lock:
            # fold the record's deferred per-group notes into the
            # global ledger (one lock for the whole generation)
            for group, b in rec["bytes"].items():
                g = self._groups.get(group)
                if g is None:
                    g = self._groups[group] = [0, 0, 0, 0]
                for k in range(4):
                    g[k] += b[k]
            for group, fb in rec["fetch_tags"].items():
                f = self._fetches.get(group)
                if f is None:
                    f = self._fetches[group] = [0, 0]
                f[0] += fb[0]
                f[1] += fb[1]
            self._dispatches += 1
            self._seq += 1
            self.tunnel.add(payload, dur_ms)
            coeffs = self.tunnel.coeffs() \
                if self.tunnel.n >= _FIT_MIN_SAMPLES else None
            predicted = (coeffs[0] + coeffs[1] * payload) \
                if coeffs is not None else None
            out = {
                "seq": self._seq,
                "t0": rec["t0"],
                "dur_ms": round(dur_ms, 3),
                "shipped_bytes": shipped,
                "resident_bytes": resident,
                "fetched_bytes": rec["fetched"],
                "bytes": {g: list(b) for g, b in rec["bytes"].items()},
                "resident_level_bytes": self._resident_level,
                "predicted_ms": round(predicted, 3)
                if predicted is not None else None,
                "meta": rec["meta"],
            }
            self._ring.append(out)
            cap = _ring_cap()
            while len(self._ring) > cap:
                self._ring.popleft()
        # the warm fit's coefficients ride the return so end_dispatch()
        # never recomputes them outside the lock
        return dict(out, coeffs=coeffs)

    def mark(self) -> int:
        with self._lock:
            return self._seq

    def since(self, token: int) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._ring if r["seq"] > token]

    # -- read side ------------------------------------------------------
    def parity(self) -> int:
        with self._lock:
            tagged = sum(g[0] for g in self._groups.values())
            return tagged - self._shipped_mirror

    def snapshot(self) -> dict:
        with self._lock:
            groups = {g: {"shipped_bytes": v[0], "resident_bytes": v[1],
                          "shipped_arrays": v[2],
                          "resident_arrays": v[3]}
                      for g, v in sorted(self._groups.items())}
            fetches = {g: {"bytes": v[0], "fetches": v[1]}
                       for g, v in sorted(self._fetches.items())}
            per_shard = {
                g: {d: {"declared_bytes": row[0], "actual_bytes": row[1]}
                    for d, row in sorted(rows.items())}
                for g, rows in sorted(self._shard_rows.items())}
            shard_parity = sum(
                abs(row[0] - row[1])
                for rows in self._shard_rows.values()
                for row in rows.values())
            tagged = sum(v[0] for v in self._groups.values())
            resident = sum(v[1] for v in self._groups.values())
            fetched = sum(v[0] for v in self._fetches.values())
            recent = [dict(r) for r in list(self._ring)[-8:]]
            return {
                "groups": groups,
                "fetches": fetches,
                "per_shard": per_shard,
                "shard_parity_bytes": shard_parity,
                "shipped_bytes_total": tagged,
                "resident_bytes_total": resident,
                "fetched_bytes_total": fetched,
                "counter_mirror_bytes": self._shipped_mirror,
                "parity_bytes": tagged - self._shipped_mirror,
                "dispatches": self._dispatches,
                "resident_level_bytes": self._resident_level,
                "resident_hwm_bytes": self._resident_hwm,
                "tunnel": self.tunnel.fit(),
                "recent": recent,
            }

    def ring_records(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._ring]


_LEDGER = _Ledger()


# ---------------------------------------------------------------------------
# hot-path entry points (every one gated on the kill switch first)


def note_payload(group: str, nbytes: int, resident: bool = False) -> None:
    """One transferred (or cache-resident) array, attributed to its
    tree group.  Called per stacked buffer from the resident set
    (solver/resident.py) and the other transports.  An open
    per-dispatch record short-circuits the env read: the kill switch
    was already consulted when begin_dispatch opened it (an environ
    get costs ~2us -- per array, that would be the very overhead the
    <2% budget forbids)."""
    if _LEDGER._rec() is not None:
        _LEDGER.note_payload(group, nbytes, resident)
        return
    if not enabled():
        return
    _LEDGER.note_payload(group, nbytes, resident)


def note_shipped(n: int) -> None:
    """Mirror of every ``nomad.solver.dispatch_bytes_total`` increment
    (called from resident.note_dispatch_bytes): the reconciliation
    base ``parity()`` compares the tagged decomposition against."""
    if not enabled():
        return
    _LEDGER.note_shipped(n)


def note_fetch(nbytes: int, group: str) -> None:
    """Result bytes pulled back by one sanctioned bulk fetch; ``group``
    is the fetch site's ledger tag."""
    if _LEDGER._rec() is not None:
        _LEDGER.note_fetch(nbytes, group)
        return
    if not enabled():
        return
    _LEDGER.note_fetch(nbytes, group)


def note_resident_level(nbytes: int) -> None:
    """Const-cache resident-bytes level after a put/evict/invalidation;
    maintains the high-watermark gauge."""
    if not enabled():
        return
    _LEDGER.note_resident_level(nbytes)


def note_shard_bytes(group: str, device: str, declared: int,
                     actual: int) -> None:
    """One per-shard ledger row for a mesh tree group: ``declared``
    bytes the grid's cut says this cell should hold vs ``actual`` bytes
    the slice it holds has.  Recorded by the per-shard transfer
    (resident.device_put_sharded_cached)."""
    if not enabled():
        return
    _LEDGER.note_shard_bytes(group, device, declared, actual)


def begin_dispatch(**meta) -> None:
    """Open this thread's per-dispatch record (solver/batch.py
    _solve_groups); subsequent payload/fetch notes on the thread
    accumulate into it until ``end_dispatch``."""
    if not enabled():
        return
    _LEDGER.begin_dispatch(**meta)


def end_dispatch(dur_ms: float, t0_wall: Optional[float] = None) -> None:
    """Close the open record: feed the tunnel fit, emit the
    ``nomad.xfer.*`` gauges, and (when the fit is warm) record the
    transfer-vs-compute split spans into the active trace ctx.  Gated
    on the record itself (begin_dispatch consulted the kill switch;
    no record ever opens while it is off)."""
    rec = _LEDGER.end_dispatch(dur_ms)
    if rec is None:
        return
    from ..server.telemetry import metrics
    metrics.incr("nomad.xfer.dispatches")
    metrics.sample("nomad.xfer.shipped_bytes", float(rec["shipped_bytes"]))
    metrics.sample("nomad.xfer.resident_bytes",
                   float(rec["resident_bytes"]))
    metrics.sample("nomad.xfer.fetched_bytes", float(rec["fetched_bytes"]))
    coeffs = rec["coeffs"]
    if coeffs is None:
        return
    rtt, slope = coeffs
    metrics.sample("nomad.xfer.rtt_ms", round(rtt, 3))
    if slope > 0:
        metrics.sample("nomad.xfer.bw_mbps",
                       round((1e3 / slope) / 1e6, 3))
    # transfer-vs-compute split: the model's predicted wire share of
    # this dispatch vs the remainder, recorded as spans so the
    # saturation attribution grows dispatch.transfer/dispatch.compute
    # stages and the eval waterfall shows the split per generation
    payload = rec["shipped_bytes"] + rec["fetched_bytes"]
    est_transfer = min(max(rtt + slope * payload, 0.0), dur_ms)
    t0 = t0_wall if t0_wall is not None else rec["t0"]
    from ..server.tracing import tracer
    tracer.record("solver.xfer_transfer", t0, est_transfer,
                  payload_bytes=payload)
    tracer.record("solver.xfer_compute", t0 + est_transfer / 1e3,
                  max(dur_ms - est_transfer, 0.0))


def mark() -> int:
    """Ring sequence token; ``span_tags(mark())`` after a dispatch
    aggregates only the generations it produced."""
    if not enabled():
        return 0
    return _LEDGER.mark()


def span_tags(token: int) -> dict:
    """Aggregate xfer_* span tags over the dispatch records completed
    since ``token`` -- the fuse_dispatch waterfall annotation (shipped
    vs resident bytes, tunnel-predicted vs actual wall-ms)."""
    if not enabled():
        return {}
    recs = _LEDGER.since(token)
    if not recs:
        return {}
    out = {
        "xfer_shipped_bytes": sum(r["shipped_bytes"] for r in recs),
        "xfer_resident_bytes": sum(r["resident_bytes"] for r in recs),
        "xfer_fetched_bytes": sum(r["fetched_bytes"] for r in recs),
        "xfer_actual_ms": round(sum(r["dur_ms"] for r in recs), 3),
    }
    preds = [r["predicted_ms"] for r in recs
             if r["predicted_ms"] is not None]
    if preds:
        out["xfer_predicted_ms"] = round(sum(preds), 3)
    return out


# ---------------------------------------------------------------------------
# read side


def parity() -> int:
    """Tagged-decomposition shipped bytes minus the dispatch_bytes
    counter mirror.  0 = every shipped byte is attributed; anything
    else is accounting drift at some transport."""
    if not enabled():
        return 0
    return _LEDGER.parity()


def shard_parity() -> int:
    """Sum over the per-shard rows of |declared - actual| bytes.  0 =
    every mesh shard holds exactly what the spec registry declares;
    anything else is a sharding-layout drift (e.g. a silently
    replicated fleet table burning N x the per-shard budget)."""
    if not enabled():
        return 0
    return _LEDGER.shard_parity()


def residency_report(top: int = 12) -> dict:
    """Device-residency map: per-entry bytes/version/age/hits from the
    resident set plus the watermark this ledger maintains."""
    from . import resident
    entries = resident.residency()
    cc = resident.stats()
    snap_entries = sorted(entries, key=lambda e: -e["bytes"])[:top]
    with _LEDGER._lock:
        hwm = _LEDGER._resident_hwm
    return {
        "entries": len(entries),
        "resident_bytes": cc.get("resident_bytes", 0),
        "resident_hwm_bytes": hwm,
        "evictions": cc.get("evictions", 0),
        "invalidations": cc.get("invalidations", 0),
        # the version chain: device buffers promoted in place by
        # journal deltas (chain rows in ``top`` carry base_version +
        # deltas_applied alongside the content-keyed entries)
        "chain_entries": cc.get("chain_entries", 0),
        "chain_resident_bytes": cc.get("chain_resident_bytes", 0),
        "delta_promotions": cc.get("delta_promotions", 0),
        "delta_reuses": cc.get("delta_reuses", 0),
        "delta_fallbacks": cc.get("delta_fallbacks", 0),
        "delta_bytes_total": cc.get("delta_bytes_total", 0),
        "top": snap_entries,
    }


def state() -> dict:
    """The whole ledger: groups, fetches, per-shard rows, the transfer
    fit, recent dispatch records and the residency report."""
    if not enabled():
        return {"enabled": False}
    out = _LEDGER.snapshot()
    out["enabled"] = True
    try:
        out["residency"] = residency_report()
    except Exception:  # noqa: BLE001 -- status must never fail the agent
        out["residency"] = {}
    return out


def bench_fields() -> dict:
    """Flat xfer_* fields for a benchmark's result line."""
    if not enabled():
        return {"xferobs_enabled": False}
    snap = _LEDGER.snapshot()
    out = {
        "xferobs_enabled": True,
        "xfer_payload_bytes_shipped": snap["shipped_bytes_total"],
        "xfer_payload_bytes_resident": snap["resident_bytes_total"],
        "xfer_payload_bytes_fetched": snap["fetched_bytes_total"],
        "xfer_resident_hwm_bytes": snap["resident_hwm_bytes"],
        "xfer_dispatches": snap["dispatches"],
        # absolute value: drift in EITHER direction (bytes missing from
        # the decomposition, or double-attributed) fails the
        # lower-better zero-tolerance regress row
        "xfer_ledger_parity": abs(snap["parity_bytes"]),
    }
    if snap["dispatches"]:
        out["xfer_shipped_bytes_per_dispatch"] = round(
            snap["shipped_bytes_total"] / snap["dispatches"], 1)
    fit = snap["tunnel"]
    if fit is not None and fit["samples"] >= _FIT_MIN_SAMPLES:
        out["xfer_rtt_ms"] = fit["rtt_ms"]
        # null when no bandwidth term is identifiable (a local backend
        # whose wall time is compute-bound fits slope 0): the field
        # stays present so trend tooling sees "unidentifiable", not
        # "observatory absent"; the regress gate warns on non-numeric
        out["xfer_bw_mbps"] = fit["bw_mbps"]
        if fit["crossover_bytes"] is not None:
            out["xfer_crossover_bytes"] = fit["crossover_bytes"]
        out["xfer_fit_samples"] = fit["samples"]
        out["xfer_fit_residual_ms"] = fit["residual_rms_ms"]
    return out


def counter_events() -> List[dict]:
    """Perfetto counter-track events ('ph': 'C') over the retained
    dispatch records: shipped bytes + resident (device) bytes +
    in-flight depth per generation, to lay beside the eval spans of
    ``tracer.chrome_trace()``."""
    if not enabled():
        return []
    events: List[dict] = []
    for r in _LEDGER.ring_records():
        ts = (r["t0"] + r["dur_ms"] / 1e3) * 1e6
        events.append({"ph": "C", "pid": 1, "name": "xfer shipped bytes",
                       "ts": ts, "args": {"bytes": r["shipped_bytes"]}})
        events.append({"ph": "C", "pid": 1, "name": "xfer resident bytes",
                       "ts": ts,
                       "args": {"bytes": r["resident_level_bytes"]}})
        depth = r["meta"].get("in_flight")
        if depth is not None:
            events.append({"ph": "C", "pid": 1,
                           "name": "xfer in-flight dispatches",
                           "ts": ts, "args": {"depth": depth}})
    return events


def _reset_for_tests() -> None:
    _LEDGER.reset()
    _LEDGER._tls = threading.local()
