"""Eval-scoped span recorder: where did this evaluation's time go?
(port of nomad_tpu/server/tracing.py)

One evaluation's latency is spread over stages on several threads:
the broker's dequeue wait, the snapshot wait, the lane pack, the fused
dispatch on a pipeline thread, the generation-ordered fixpoint, the
serialized plan apply. The ``metrics`` registry (telemetry.py) says the
fleet's ``nomad.plan.evaluate`` p99 rose; it cannot say why one eval was
slow. This module records, per evaluation, a trace (trace id = eval id)
of spans -- name, wall start, duration, thread, tags -- across every
thread the eval touches.

Context. A ``TraceCtx`` is an explicit handle over one or more traces.
Code on the eval's own thread uses the thread's current context (bound
with ``tracer.activate(ctx)``); code that crosses threads carries the
ctx itself: the solve barrier keeps each waiter's ctx in its cell, the
dispatch pipeline binds the group ctx (every lane fused into one
dispatch) on its thread, the plan applier carries the submitter's ctx
on ``_Pending``, and ``guard.run_dispatch`` hands the caller's ctx into
its watchdog's runner thread.

Retention is decided at a trace's end. Traces that degraded (host
fallback, breaker trip, watchdog timeout), failed or were nacked, or
ran at least ``NOMAD_TPU_TORCH_TRACE_SLOW_MS`` are always kept; healthy
ones are kept at ``NOMAD_TPU_TORCH_TRACE_SAMPLE`` by a hash of the eval
id (no RNG state is touched, so scheduling stays bit for bit). Memory is
capped all the same: ``NOMAD_TPU_TORCH_TRACE_CAP`` retained traces,
``NOMAD_TPU_TORCH_TRACE_MB`` estimated MiB and
``NOMAD_TPU_TORCH_TRACE_MAX_SPANS`` spans a trace; the ring evicts
oldest first, and abandoned in-flight traces are bounded the same way.

Knobs (read at each use):
  NOMAD_TPU_TORCH_TRACE            0 makes every entry point a no-op
                                   (kill switch)
  NOMAD_TPU_TORCH_TRACE_SAMPLE     share of healthy traces kept (0.1)
  NOMAD_TPU_TORCH_TRACE_SLOW_MS    traces at least this long are kept
                                   (250)
  NOMAD_TPU_TORCH_TRACE_CAP        retained traces (256)
  NOMAD_TPU_TORCH_TRACE_MB         retained MiB, estimated (8)
  NOMAD_TPU_TORCH_TRACE_MAX_SPANS  spans a trace (512)

``chrome_trace`` exports the retained traces as chrome://tracing /
Perfetto JSON.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple


def trace_enabled() -> bool:
    return os.environ.get("NOMAD_TPU_TORCH_TRACE", "1") != "0"


# Span-stream sink (server/quality.py saturation attribution): every
# recorded span's (name, dur_ms) is offered to the sink whatever the
# trace's retention -- stage histograms must see the full stream, not
# the retained tail. None (the default, and whenever
# NOMAD_TPU_TORCH_QUALITY=0 keeps the observatory detached) is a no-op.
_SPAN_SINK = None


def set_span_sink(sink) -> None:
    global _SPAN_SINK
    _SPAN_SINK = sink


def _slow_ms() -> float:
    try:
        return float(os.environ.get("NOMAD_TPU_TORCH_TRACE_SLOW_MS", "250"))
    except ValueError:
        return 250.0


def _sample_rate() -> float:
    try:
        v = float(os.environ.get("NOMAD_TPU_TORCH_TRACE_SAMPLE", "0.1"))
    except ValueError:
        return 0.1
    return min(max(v, 0.0), 1.0)


def _max_traces() -> int:
    try:
        return max(1, int(os.environ.get("NOMAD_TPU_TORCH_TRACE_CAP", "256")))
    except ValueError:
        return 256


def _max_bytes() -> int:
    try:
        return max(1, int(float(os.environ.get(
            "NOMAD_TPU_TORCH_TRACE_MB", "8")) * 1024 * 1024))
    except ValueError:
        return 8 * 1024 * 1024


def _max_spans() -> int:
    try:
        return max(1, int(os.environ.get(
            "NOMAD_TPU_TORCH_TRACE_MAX_SPANS", "512")))
    except ValueError:
        return 512


def _keep_fraction(trace_id: str) -> float:
    """Deterministic per-eval sampling coordinate in [0, 1): a hash of
    the id, NOT a random draw -- tracing must never touch RNG state the
    scheduler's seeded shuffles could observe."""
    h = hashlib.blake2b(trace_id.encode(), digest_size=8).digest()
    return int.from_bytes(h, "big") / float(1 << 64)


class _Trace:
    __slots__ = ("trace_id", "started_at", "ended_at", "status", "tags",
                 "spans", "degraded_reason", "error", "truncated",
                 "nbytes")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.started_at = time.time()
        self.ended_at: Optional[float] = None
        self.status = "active"
        self.tags: Dict[str, object] = {}
        self.spans: List[dict] = []
        self.degraded_reason: Optional[str] = None
        self.error: Optional[str] = None
        self.truncated = 0
        self.nbytes = 256          # struct + id overhead estimate

    def dur_ms(self) -> float:
        t0 = self.started_at
        if self.spans:
            t0 = min(t0, min(s["t0"] for s in self.spans))
        t1 = self.ended_at if self.ended_at is not None else time.time()
        if self.spans:
            t1 = max(t1, max(s["t0"] + s["dur_ms"] / 1e3
                             for s in self.spans))
        return max(0.0, (t1 - t0) * 1e3)

    def summary(self) -> dict:
        return {
            "eval_id": self.trace_id,
            "started_at": self.started_at,
            "dur_ms": round(self.dur_ms(), 3),
            "status": self.status,
            "degraded": self.degraded_reason is not None,
            "degraded_reason": self.degraded_reason,
            "error": self.error,
            "spans": len(self.spans),
            "tags": dict(self.tags),
        }

    def to_dict(self) -> dict:
        out = self.summary()
        out["ended_at"] = self.ended_at
        out["truncated_spans"] = self.truncated
        out["spans"] = [dict(s) for s in self.spans]
        return out


class TraceCtx:
    """Explicit trace handle: one or more traces (a pipeline generation
    fuses many evals into one dispatch -- spans recorded under the group
    ctx land in EVERY member eval's trace)."""

    __slots__ = ("traces",)

    def __init__(self, traces: Tuple[_Trace, ...]):
        self.traces = traces

    def ids(self) -> List[str]:
        return [t.trace_id for t in self.traces]


class _SpanCM:
    """Context manager recording one span on exit; ``tag()`` adds tags
    mid-flight (e.g. the plan result, known only after the block)."""

    __slots__ = ("_tracer", "_ctx", "_name", "_tags", "_t0")

    def __init__(self, tracer: "Tracer", ctx: Optional[TraceCtx],
                 name: str, tags: dict):
        self._tracer = tracer
        self._ctx = ctx
        self._name = name
        self._tags = tags

    def tag(self, **kv) -> None:
        self._tags.update(kv)

    def __enter__(self) -> "_SpanCM":
        self._t0 = time.time()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._tags.setdefault("error", exc_type.__name__)
        self._tracer.record(
            self._name, self._t0, (time.time() - self._t0) * 1e3,
            ctx=self._ctx, **self._tags)
        return False


class _NullSpan:
    """Shared no-op span: tracing disabled or no active context."""

    __slots__ = ()

    def tag(self, **kv) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Activation:
    __slots__ = ("_tracer", "_ctx", "_prev")

    def __init__(self, tracer: "Tracer", ctx: Optional[TraceCtx]):
        self._tracer = tracer
        self._ctx = ctx

    def __enter__(self):
        tls = self._tracer._tls
        self._prev = getattr(tls, "ctx", None)
        tls.ctx = self._ctx if self._ctx is not None else self._prev
        return self._ctx

    def __exit__(self, *exc):
        self._tracer._tls.ctx = self._prev
        return False


class Tracer:
    def __init__(self):
        self._lock = threading.Lock()
        self._active: "OrderedDict[str, _Trace]" = OrderedDict()
        self._retained: "OrderedDict[str, _Trace]" = OrderedDict()
        self._retained_bytes = 0
        self._tls = threading.local()
        self._dropped = 0          # sampled-out or cap-evicted

    # -- context plumbing ----------------------------------------------
    def begin(self, trace_id: str, **tags) -> Optional[TraceCtx]:
        """Create (or resume -- a nacked eval is redelivered under the
        same id) the active trace for an eval. Returns None when
        tracing is off."""
        if not trace_enabled() or not trace_id:
            return None
        with self._lock:
            tr = self._active.get(trace_id)
            if tr is None:
                tr = _Trace(trace_id)
                self._active[trace_id] = tr
                # in-flight traces are bounded too: an eval whose end()
                # never runs (shutdown mid-flight) must not leak
                while len(self._active) > 4 * _max_traces():
                    _, stale = self._active.popitem(last=False)
                    stale.status = "abandoned"
                    self._finish_locked(stale)
            for k, v in tags.items():
                if k not in tr.tags:
                    tr.tags[k] = v
                    tr.nbytes += len(k) + len(str(v))
        return TraceCtx((tr,))

    def current(self) -> Optional[TraceCtx]:
        if not trace_enabled():
            return None
        return getattr(self._tls, "ctx", None)

    def current_ids(self) -> List[str]:
        ctx = self.current()
        return ctx.ids() if ctx is not None else []

    def activate(self, ctx: Optional[TraceCtx]) -> _Activation:
        """Bind ctx as this thread's current context for the block --
        the explicit handoff for code entering a new thread."""
        return _Activation(self, ctx)

    def group(self, ctxs: Sequence[Optional[TraceCtx]]
              ) -> Optional[TraceCtx]:
        """Fuse many ctxs into one (a barrier generation): spans under
        the group land in every member trace exactly once."""
        seen: "OrderedDict[int, _Trace]" = OrderedDict()
        for c in ctxs:
            if c is None:
                continue
            for t in c.traces:
                seen.setdefault(id(t), t)
        if not seen:
            return None
        return TraceCtx(tuple(seen.values()))

    def _resolve(self, ctx: Optional[TraceCtx]) -> Optional[TraceCtx]:
        if ctx is not None:
            return ctx
        return getattr(self._tls, "ctx", None)

    # -- recording -----------------------------------------------------
    def span(self, name: str, ctx: Optional[TraceCtx] = None, **tags):
        if not trace_enabled():
            return _NULL_SPAN
        ctx = self._resolve(ctx)
        if ctx is None:
            return _NULL_SPAN
        return _SpanCM(self, ctx, name, tags)

    def record(self, name: str, t0: float, dur_ms: float,
               ctx: Optional[TraceCtx] = None, **tags) -> None:
        """Low-level span append (explicit start/duration -- the broker
        records the enqueue->dequeue wait retroactively at pop time)."""
        if not trace_enabled():
            return
        sink = _SPAN_SINK
        if sink is not None:
            try:
                sink(name, dur_ms)
            except Exception:  # noqa: BLE001 -- accounting only
                pass
        ctx = self._resolve(ctx)
        if ctx is None:
            return
        span = {"name": name, "t0": t0, "dur_ms": round(dur_ms, 3),
                "thread": threading.current_thread().name}
        if tags:
            span["tags"] = tags
        cost = 96 + len(name) + sum(
            len(k) + len(str(v)) for k, v in tags.items())
        cap = _max_spans()
        with self._lock:
            for tr in ctx.traces:
                if len(tr.spans) >= cap:
                    tr.truncated += 1
                    continue
                tr.spans.append(span)
                tr.nbytes += cost

    def event(self, name: str, ctx: Optional[TraceCtx] = None,
              **tags) -> None:
        """Zero-duration span (an annotation with a timestamp)."""
        self.record(name, time.time(), 0.0, ctx=ctx, **tags)

    def annotate(self, ctx: Optional[TraceCtx] = None, **tags) -> None:
        """Trace-level tags (lane, generation, plan result...)."""
        if not trace_enabled():
            return
        ctx = self._resolve(ctx)
        if ctx is None:
            return
        with self._lock:
            for tr in ctx.traces:
                for k, v in tags.items():
                    tr.tags[k] = v
                    tr.nbytes += len(k) + len(str(v))

    def mark_degraded(self, reason: str,
                      ctx: Optional[TraceCtx] = None, **tags) -> None:
        """The eval degraded (host fallback / watchdog timeout / breaker
        open): pin the reason (first one wins -- it is the root cause)
        and force tail retention."""
        if not trace_enabled():
            return
        ctx = self._resolve(ctx)
        if ctx is None:
            return
        with self._lock:
            for tr in ctx.traces:
                if tr.degraded_reason is None:
                    tr.degraded_reason = reason
        self.event("degraded", ctx=ctx, reason=reason, **tags)

    def broadcast_event(self, name: str, degraded_reason: str = "",
                        **tags) -> None:
        """Stamp every ACTIVE trace (a breaker trip degrades everything
        in flight, not just the dispatch that tripped it)."""
        if not trace_enabled():
            return
        with self._lock:
            traces = tuple(self._active.values())
        if not traces:
            return
        ctx = TraceCtx(traces)
        if degraded_reason:
            self.mark_degraded(degraded_reason, ctx=ctx, **tags)
        else:
            self.event(name, ctx=ctx, **tags)

    # -- lifecycle -----------------------------------------------------
    def end(self, trace_id: str, status: str = "complete",
            error: Optional[str] = None, **tags) -> None:
        """Finish the eval's trace and run the tail-based retention
        decision."""
        if not trace_enabled():
            return
        with self._lock:
            tr = self._active.pop(trace_id, None)
            if tr is None:
                return
            tr.status = status
            if error:
                tr.error = error
            for k, v in tags.items():
                tr.tags[k] = v
            tr.ended_at = time.time()
            self._finish_locked(tr)

    def _finish_locked(self, tr: _Trace) -> None:
        keep = (tr.degraded_reason is not None
                or tr.error is not None
                or tr.status in ("nacked", "failed")
                or tr.dur_ms() >= _slow_ms())
        if not keep:
            keep = _keep_fraction(tr.trace_id) < _sample_rate()
        if not keep:
            self._dropped += 1
            self._count("nomad.trace.dropped")
            return
        old = self._retained.pop(tr.trace_id, None)
        if old is not None:
            self._retained_bytes -= old.nbytes
        self._retained[tr.trace_id] = tr
        self._retained_bytes += tr.nbytes
        self._count("nomad.trace.retained")
        max_n, max_b = _max_traces(), _max_bytes()
        while self._retained and (len(self._retained) > max_n
                                  or self._retained_bytes > max_b):
            _, ev = self._retained.popitem(last=False)
            self._retained_bytes -= ev.nbytes
            self._dropped += 1

    @staticmethod
    def _count(name: str) -> None:
        # lazy + guarded: the tracer must work (and its lock must stay
        # leaf-like) even if telemetry is mid-teardown
        try:
            from .telemetry import metrics
            metrics.incr(name)
        except Exception:  # noqa: BLE001 -- accounting only
            pass

    # -- read side -----------------------------------------------------
    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            tr = self._retained.get(trace_id) or self._active.get(trace_id)
            return tr.to_dict() if tr is not None else None

    def list_traces(self, degraded: bool = False, slowest: int = 0,
                    limit: int = 50) -> List[dict]:
        with self._lock:
            traces = list(self._retained.values())
        if degraded:
            traces = [t for t in traces
                      if t.degraded_reason is not None
                      or t.error is not None]
        if slowest > 0:
            traces.sort(key=lambda t: -t.dur_ms())
            traces = traces[:slowest]
        else:
            traces = traces[::-1]          # most recent first
            if limit > 0:
                traces = traces[:limit]
        return [t.summary() for t in traces]

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": trace_enabled(),
                "active": len(self._active),
                "retained": len(self._retained),
                "retained_bytes": self._retained_bytes,
                "dropped": self._dropped,
                "cap_traces": _max_traces(),
                "cap_bytes": _max_bytes(),
                "sample": _sample_rate(),
                "slow_ms": _slow_ms(),
            }

    def chrome_trace(self, trace_ids: Optional[Sequence[str]] = None
                     ) -> dict:
        """Retained traces as a chrome://tracing / Perfetto JSON object
        (trace-event format: complete 'X' events, ts/dur in us, one tid
        lane per eval)."""
        with self._lock:
            traces = ([t for tid in trace_ids
                       for t in (self._retained.get(tid),)
                       if t is not None]
                      if trace_ids is not None
                      else list(self._retained.values()))
            traces = [t.to_dict() for t in traces]
        events: List[dict] = []
        for tid_num, tr in enumerate(traces, start=1):
            name = tr["eval_id"]
            events.append({"ph": "M", "pid": 1, "tid": tid_num,
                           "name": "thread_name",
                           "args": {"name": (
                               f"eval {name}"
                               + (" [degraded:"
                                  f"{tr['degraded_reason']}]"
                                  if tr["degraded_reason"] else ""))}})
            for s in tr["spans"]:
                events.append({
                    "ph": "X", "pid": 1, "tid": tid_num,
                    "name": s["name"],
                    "cat": "eval",
                    "ts": s["t0"] * 1e6,
                    "dur": max(s["dur_ms"], 0.001) * 1e3,
                    "args": dict(s.get("tags") or {},
                                 thread=s.get("thread", "")),
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def _reset_for_tests(self) -> None:
        with self._lock:
            self._active.clear()
            self._retained.clear()
            self._retained_bytes = 0
            self._dropped = 0
        self._tls = threading.local()


# The process-global recorder, like telemetry.metrics.
tracer = Tracer()
